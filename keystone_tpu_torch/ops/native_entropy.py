"""ctypes binding for the native entropy-decode hot loop (counterpart of
keystone_tpu/ops/native_entropy.py).

:func:`~.jpeg_device.entropy_decode` keeps header parsing, Huffman LUT
compilation and restart-segment splitting in Python and hands only the
O(compressed-bytes) symbol loop to ``csrc/entropy.cpp``, the port's own copy
of the JAX package's C source.  The library is built with the host compiler
(``g++ -O2 -shared -fPIC``) into the git-ignored ``build/kernels/`` at first
use, keyed by a hash of the source (:mod:`keystone_tpu_torch._build`).

When it cannot be built or loaded, :func:`available` is False, the
degradation is counted once per process in ``core.resilience.counters``
(``native_entropy_unavailable``) and the auto backend runs the Python pass:
both loops are the same algorithm, so the coefficients are bit-identical.
ctypes releases the GIL for each ``decode_scan`` call, so the ingest thread
pool runs the entropy pass on several cores.  This module imports no torch.
"""

from __future__ import annotations

import ctypes
import logging
import os
import threading

import numpy as np

from .. import _build
from ..core.resilience import counters

_logger = logging.getLogger(__name__)

#: ``0`` makes the auto backend run the pure-Python pass (host code, not a
#: kernel path: both passes give the same coefficients).
NATIVE_ENTROPY_ENV = "KEYSTONE_NATIVE_ENTROPY"

#: C return code -> the EXACT JpegEntropyCorrupt message the Python loop
#: raises, in the order of the KST_E* enum in csrc/entropy.cpp.  Formatted
#: with err_info[0] (mcu), err_info[1] (DC category) and total_mcus.
_ERR_MESSAGES = {
    1: "invalid Huffman code or truncated scan (mcu {e0}/{total})",
    2: "ZRL overflows the block",
    3: "AC run overflows the block",
    4: "DC category {e1} out of range",
    5: "truncated scan mid-coefficient",
    6: "DC predictor out of int16 range",
    7: "decoded {e0} of {total} MCUs (truncated scan)",
}

_u8pp = ctypes.POINTER(ctypes.c_char_p)
_SIGNATURES = {
    "kst_entropy_decode": (
        ctypes.c_int,
        [
            _u8pp,                                           # segs
            ctypes.POINTER(ctypes.c_longlong),               # seg_lens
            ctypes.c_int,                                    # nseg
            ctypes.POINTER(ctypes.POINTER(ctypes.c_short)),  # planes
            ctypes.POINTER(ctypes.c_int),                    # row_width
            ctypes.POINTER(ctypes.c_int),                    # mcu_blocks
            ctypes.c_int,                                    # n_mcu_blocks
            _u8pp,                                           # lut_len
            _u8pp,                                           # lut_sym
            ctypes.c_char_p,                                 # zigzag
            ctypes.c_int,                                    # ncomp
            ctypes.c_longlong,                               # mcus_x
            ctypes.c_longlong,                               # total_mcus
            ctypes.c_longlong,                               # interval
            ctypes.POINTER(ctypes.c_longlong),               # err_info
        ],
    )
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def _load() -> ctypes.CDLL | None:
    """Build (first use only) and load the library; None when that fails
    (counted once)."""
    global _lib, _tried
    with _lock:
        if not _tried:
            _tried = True
            try:
                _lib = _build.load("entropy", _SIGNATURES)
            except (OSError, RuntimeError) as e:
                counters.record(
                    "native_entropy_unavailable",
                    f"{e}: entropy decode degraded to the pure-Python pass",
                )
                _logger.warning(
                    "native entropy decoder unavailable (%s); using the "
                    "pure-Python pass: coefficients stay bit-equal, "
                    "throughput drops", e,
                )
        return _lib


def enabled() -> bool:
    """The host-code gate, re-read on every call:
    ``KEYSTONE_NATIVE_ENTROPY=0`` makes the auto backend run the Python
    pass without touching the cached build state."""
    return os.environ.get(NATIVE_ENTROPY_ENV, "").strip() != "0"


def available() -> bool:
    """True when the native loop is enabled and built/loadable.  Triggers
    the build, so call it from setup code (not per image)."""
    return enabled() and _load() is not None


def reset() -> None:
    """Forget the cached build/load outcome so the next call re-evaluates
    it (for tests that simulate a missing library)."""
    global _lib, _tried
    with _lock:
        _tried = False
        _lib = None


def _zigzag_bytes() -> bytes:
    from .jpeg_device import ZIGZAG

    return ZIGZAG.astype(np.uint8).tobytes()


def decode_scan(
    segments, planes, mcu_blocks, ncomp, mcus_x, total_mcus, interval
) -> bool:
    """Native drop-in for ``jpeg_device._decode_scan``: identical arguments,
    identical plane writes, identical typed errors.

    Returns False (planes untouched) when the library is unavailable so the
    caller runs the Python loop; True after a successful native decode.  A
    damaged scan raises :class:`~.jpeg_device.JpegEntropyCorrupt` with the
    message the Python loop gives for the same stream."""
    lib = _load()
    if lib is None:
        return False

    nseg = len(segments)
    seg_arr = (ctypes.c_char_p * nseg)(*segments)
    len_arr = (ctypes.c_longlong * nseg)(*(len(s) for s in segments))
    plane_ptrs = (ctypes.POINTER(ctypes.c_short) * len(planes))(
        *(p.ctypes.data_as(ctypes.POINTER(ctypes.c_short)) for p in planes)
    )
    widths = (ctypes.c_int * len(planes))(*(p.shape[1] for p in planes))

    # Dedup the LUTs (64 KiB each, shared across blocks and components) and
    # flatten mcu_blocks to the 7-int rows the C loop indexes.
    lut_index: dict[int, int] = {}
    lut_len: list[bytes] = []
    lut_sym: list[bytes] = []

    def _lut(lut) -> int:
        idx = lut_index.get(id(lut))
        if idx is None:
            idx = lut_index[id(lut)] = len(lut_len)
            lut_len.append(lut.length_b)
            lut_sym.append(lut.symbol_b)
        return idx

    flat = []
    for ci, v, h, by, bx, dc_lut, ac_lut in mcu_blocks:
        flat.extend((ci, v, h, by, bx, _lut(dc_lut), _lut(ac_lut)))
    mb_arr = (ctypes.c_int * len(flat))(*flat)
    len_ptrs = (ctypes.c_char_p * len(lut_len))(*lut_len)
    sym_ptrs = (ctypes.c_char_p * len(lut_sym))(*lut_sym)
    err = (ctypes.c_longlong * 2)(0, 0)

    rc = lib.kst_entropy_decode(
        seg_arr, len_arr, nseg, plane_ptrs, widths, mb_arr, len(mcu_blocks),
        len_ptrs, sym_ptrs, _zigzag_bytes(), ncomp, mcus_x, total_mcus,
        interval, err,
    )
    if rc == 0:
        return True
    from .jpeg_device import JpegEntropyCorrupt

    msg = _ERR_MESSAGES.get(rc, "native entropy decode error {e0}")
    raise JpegEntropyCorrupt(msg.format(e0=int(err[0]), e1=int(err[1]), total=total_mcus))
