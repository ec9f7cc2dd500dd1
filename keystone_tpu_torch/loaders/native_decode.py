"""ctypes binding for the host JPEG decoder (counterpart of
keystone_tpu/loaders/native_decode.py).

``csrc/ingest.cpp`` is the port's own copy of the JAX package's libjpeg
decoder.  It is built with the host compiler and linked against libjpeg
(``g++ -O2 -shared -fPIC ... -ljpeg``) into the git-ignored
``build/kernels/`` at first use (:mod:`keystone_tpu_torch._build`).  ctypes
releases the GIL for each decode call, so the thread-pool loaders decode on
several host cores with no Python image library on the hot path.

This is the host decoder, not a kernel path: ``KEYSTONE_NATIVE_DECODE=0``
turns it off, and a library that cannot be built or loaded (a host without
libjpeg) is logged once and makes :func:`available` answer False; the
loaders then decode with PIL where it is installed.  This module imports no
torch.
"""

from __future__ import annotations

import ctypes
import logging
import os
import threading

import numpy as np

from .. import _build

_logger = logging.getLogger(__name__)

#: ``0`` turns the native decoder off (host code, not a kernel path).
NATIVE_DECODE_ENV = "KEYSTONE_NATIVE_DECODE"

_SIGNATURES = {
    "kst_decode_jpeg": (
        ctypes.c_int,
        [
            ctypes.c_char_p,
            ctypes.c_long,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ],
    ),
    "kst_free": (None, [ctypes.POINTER(ctypes.c_float)]),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def _load() -> ctypes.CDLL | None:
    """Build (first use only) and load the decoder; None when it is turned
    off or cannot be built.  Call it (through :func:`available`) before a
    decode pool starts: the one-time build runs under the module lock, and
    a first call from inside the pool would stall every worker behind it."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get(NATIVE_DECODE_ENV, "").strip() == "0":
            return None
        try:
            _lib = _build.load("ingest", _SIGNATURES)
        except (OSError, RuntimeError) as e:
            _logger.warning("native JPEG decoder unavailable (%s); falling back to PIL", e)
        return _lib


def available() -> bool:
    return _load() is not None


def reset() -> None:
    """Forget the cached build/load outcome, so the next decode re-reads
    ``KEYSTONE_NATIVE_DECODE`` and the library state (for tests that toggle
    the variable)."""
    global _lib, _tried
    with _lock:
        _tried = False
        _lib = None


def decode_jpeg_native(data: bytes) -> np.ndarray | None:
    """JPEG bytes -> f32[H, W, 3] BGR in [0, 255], or None when the stream
    is corrupt, the image is under 36 px on a side or has another channel
    count than 1 or 3, or the native decoder is unavailable."""
    lib = _load()
    if lib is None:
        return None
    out = ctypes.POINTER(ctypes.c_float)()
    h = ctypes.c_int()
    w = ctypes.c_int()
    rc = lib.kst_decode_jpeg(data, len(data), ctypes.byref(out), ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        return None
    try:
        arr = np.ctypeslib.as_array(out, shape=(h.value, w.value, 3)).copy()
    finally:
        lib.kst_free(out)
    return arr
