"""Device-resident JPEG decode (counterpart of keystone_tpu/ops/jpeg_device.py).

Baseline JPEG is split at the entropy boundary:

* **host entropy pass** (:func:`entropy_decode`, numpy + a table-driven bit
  reader, with the scan loop in native code when ``csrc/entropy.cpp``
  builds): parse markers, Huffman-decode the scan into per-component
  quantised DCT coefficient blocks (int16, natural order) and emit a
  :class:`CoeffImage`: coefficients, a geometry and the image's quant
  tables.  This half is a copy of the JAX package's host code (numpy
  only); error messages and ``reason`` slugs are the same word for word.
* **device batch pass** (:func:`decode_batch`): the int16 coefficients go to
  the card, where each batch is dequantised, inverse-DCT'd, fancy-upsampled
  (libjpeg's triangular filter), converted YCbCr -> BGR, rounded
  half-to-even and clamped: pixels are born on the card in the BGR f32
  layout of :func:`~..loaders.image_loaders.decode_image`.  On a CUDA
  tensor all of it is two launches of the hand-written kernel
  ``csrc/idct.cu`` (:func:`decode_pixels`); on a CPU tensor it is the plain
  composition :func:`decode_pixels_reference`.  :func:`fused_apply` runs a
  featurizer straight on the pixels.

Scope is the baseline subset (sequential DCT, Huffman, 8-bit, grayscale or
YCbCr with 4:4:4 / 4:2:2 / 4:2:0 sampling, restart markers): everything else
raises a typed :class:`JpegDecodeUnsupported` with a ``reason``, which
``core.ingest`` routes to the host decoder as a counted
``device_decode_fallback_<reason>``.  A damaged scan raises
:class:`JpegEntropyCorrupt`, a typed counted skip upstream.

Parity contract: within :data:`GOLDEN_MAX_ABS` / :data:`GOLDEN_MEAN_ABS` of
the host (libjpeg/PIL) decoder, which rounds its fixed-point IDCT otherwise.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import logging

import numpy as np
import torch

from .. import _build
from . import native_entropy

_logger = logging.getLogger(__name__)

#: Golden-parity tolerance vs the host (libjpeg/PIL) decoder, in 8-bit
#: sample levels.  Budget: libjpeg's fixed-point ``jpeg_idct_islow`` is
#: IEEE-1180-accurate (~±1) on conforming blocks, fancy upsampling and the
#: fixed-point color conversion each round within ±1 — but heavily
#: quantized noise blocks whose IDCT overshoots [0, 255] sit outside the
#: 1180 test range, where the fixed-point path drifts a few more levels
#: from the exact float IDCT.  The MEAN bound is the tight one; the max
#: bound budgets the clamp-corner outliers.
GOLDEN_MAX_ABS = 8.0
GOLDEN_MEAN_ABS = 1.0

#: Kernel launches made by :func:`idct_blocks` (never by the plain version).
launches = 0
#: Kernel launches made by :func:`decode_pixels` (two per decoded batch;
#: never by the plain version).
decode_launches = 0


def _zigzag_order() -> np.ndarray:
    """zigzag scan position -> natural (row-major) position within the
    8x8 (built by walking the pattern)."""
    order = np.empty(64, np.int32)
    row = col = 0
    for k in range(64):
        order[k] = row * 8 + col
        if (row + col) % 2 == 0:  # moving up-right
            if col == 7:
                row += 1
            elif row == 0:
                col += 1
            else:
                row -= 1
                col += 1
        else:  # moving down-left
            if row == 7:
                col += 1
            elif col == 0:
                row += 1
            else:
                row += 1
                col -= 1
    return order


ZIGZAG = _zigzag_order()


class JpegDecodeUnsupported(ValueError):
    """The stream is a JPEG the device path does not claim (progressive,
    arithmetic-coded, CMYK, exotic subsampling, 12-bit, multi-scan...).
    Carries ``reason`` — a short slug the ingest fallback counter is keyed
    by (``device_decode_fallback_<reason>``)."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(f"{reason}: {detail}" if detail else reason)
        self.reason = reason


class JpegEntropyCorrupt(ValueError):
    """The entropy-coded scan is damaged (truncated data, invalid Huffman
    code, a marker where MCUs should be, coefficient overrun).  The caller
    must skip-and-count — decoding further would fabricate pixels."""


@dataclasses.dataclass(frozen=True)
class JpegGeometry:
    """Everything the device stage needs that is shape-static: images with
    equal geometry batch together (quant tables ride as per-image data, so
    quality may vary within a batch)."""

    height: int
    width: int
    #: per-component (h, v) sampling factors, e.g. ((2, 2), (1, 1), (1, 1))
    sampling: tuple
    #: per-component padded block-grid shape (blocks_y, blocks_x)
    block_shape: tuple

    @property
    def n_components(self) -> int:
        return len(self.sampling)

    def coeff_shapes(self) -> tuple:
        """Per-component coefficient array shapes [by, bx, 8, 8]."""
        return tuple((by, bx, 8, 8) for by, bx in self.block_shape)

    def coeff_bytes(self) -> int:
        """int16 coefficient payload bytes for ONE image (what goes host ->
        card per image instead of its f32 pixels)."""
        return sum(by * bx * 64 * 2 for by, bx in self.block_shape)


@dataclasses.dataclass
class CoeffImage:
    """One entropy-decoded image: quantized coefficients + geometry."""

    geom: JpegGeometry
    #: per-component [by, bx, 8, 8] int16, natural (row-major) order
    coeffs: tuple
    #: [ncomp, 8, 8] float32 dequant tables (natural order)
    qt: np.ndarray


# -- host entropy pass ---------------------------------------------------------


class _HuffLUT:
    """Canonical Huffman table compiled to a 16-bit-peek lookup: one index
    decodes (symbol, code length), built once per table.  Stored as
    ``bytes``: the scan loop indexes them per symbol, and ``bytes[i]`` is a
    plain int at a fraction of a numpy scalar's cost."""

    __slots__ = ("length_b", "symbol_b")

    def __init__(self, counts: np.ndarray, symbols: np.ndarray):
        length = np.zeros(1 << 16, np.uint8)
        symbol = np.zeros(1 << 16, np.uint8)
        code = 0
        k = 0
        for bits in range(1, 17):
            n = int(counts[bits - 1])
            for _ in range(n):
                if code >= (1 << bits):
                    raise JpegEntropyCorrupt(
                        f"overfull Huffman table at code length {bits}"
                    )
                lo = code << (16 - bits)
                hi = lo + (1 << (16 - bits))
                length[lo:hi] = bits
                symbol[lo:hi] = symbols[k]
                code += 1
                k += 1
            code <<= 1
        self.length_b = length.tobytes()
        self.symbol_b = symbol.tobytes()


@functools.lru_cache(maxsize=64)
def _huff_lut(counts: bytes, symbols: bytes) -> _HuffLUT:
    """LUT compilation cached by table content: most encoders emit the
    Annex-K standard tables, so a tar of thousands of JPEGs compiles four
    LUTs once instead of four per image."""
    return _HuffLUT(
        np.frombuffer(counts, np.uint8), np.frombuffer(symbols, np.uint8)
    )


def _decode_scan(
    segments, planes, mcu_blocks, ncomp, mcus_x, total_mcus, interval
):
    """The hot loop: Huffman-decode every MCU of the (already unstuffed,
    restart-split) scan into the per-component coefficient planes.

    ONE function with the bit reader inlined as plain locals
    (acc/accbits/pos) and the Huffman LUTs indexed as ``bytes``: attribute
    access per symbol costs more than the decode itself.  Running out of
    bits or hitting an invalid code raises :class:`JpegEntropyCorrupt`
    (libjpeg pads with 1s and warns; this path's contract is
    typed-or-correct, so a truncated scan is an error, not a grey image)."""
    zz = ZIGZAG.tolist()
    flat = [p.reshape(-1, 64) for p in planes]
    row_width = [p.shape[1] for p in planes]
    from_bytes = int.from_bytes
    mcu = 0
    for seg_bytes in segments:
        acc = 0
        accbits = 0
        pos = 0
        nbytes = len(seg_bytes)
        preds = [0] * ncomp
        seg_end = min(mcu + interval, total_mcus)
        while mcu < seg_end:
            my, mx = divmod(mcu, mcus_x)
            for ci, v, h, by, bx, dc_lut, ac_lut in mcu_blocks:
                row = flat[ci][
                    (my * v + by) * row_width[ci] + mx * h + bx
                ]
                pred = preds[ci]
                lenb, symb = dc_lut.length_b, dc_lut.symbol_b
                ac = False
                k = 0
                while True:
                    # -- decode one Huffman symbol ------------------------
                    if accbits < 16 and pos < nbytes:
                        take = seg_bytes[pos : pos + 6]
                        acc = (acc << (8 * len(take))) | from_bytes(
                            take, "big"
                        )
                        accbits += 8 * len(take)
                        pos += len(take)
                    peek = (
                        (acc << (16 - accbits))
                        if accbits < 16
                        else (acc >> (accbits - 16))
                    ) & 0xFFFF
                    nb = lenb[peek]
                    if nb == 0 or nb > accbits:
                        raise JpegEntropyCorrupt(
                            "invalid Huffman code or truncated scan "
                            f"(mcu {mcu}/{total_mcus})"
                        )
                    accbits -= nb
                    acc &= (1 << accbits) - 1
                    sym = symb[peek]
                    # -- interpret it ------------------------------------
                    if ac:
                        run, size = sym >> 4, sym & 0xF
                        if size == 0:
                            if run == 15:
                                k += 16
                                if k > 63:
                                    raise JpegEntropyCorrupt(
                                        "ZRL overflows the block"
                                    )
                                continue
                            break  # EOB
                        k += run + 1
                        if k > 63:
                            raise JpegEntropyCorrupt(
                                "AC run overflows the block"
                            )
                    else:
                        size = sym
                        if size > 15:
                            raise JpegEntropyCorrupt(
                                f"DC category {size} out of range"
                            )
                    # -- receive the value bits --------------------------
                    val = 0
                    if size:
                        if accbits < size:
                            take = seg_bytes[pos : pos + 6]
                            acc = (acc << (8 * len(take))) | from_bytes(
                                take, "big"
                            )
                            accbits += 8 * len(take)
                            pos += len(take)
                            if accbits < size:
                                raise JpegEntropyCorrupt(
                                    "truncated scan mid-coefficient"
                                )
                        accbits -= size
                        val = (acc >> accbits) & ((1 << size) - 1)
                        acc &= (1 << accbits) - 1
                        if val < (1 << (size - 1)):  # EXTEND
                            val = val - (1 << size) + 1
                    if ac:
                        row[zz[k]] = val
                        if k == 63:
                            break
                    else:
                        pred += val
                        if not -32768 <= pred <= 32767:
                            # only reachable on a damaged stream: a valid
                            # baseline DC predictor is 11-bit
                            raise JpegEntropyCorrupt(
                                "DC predictor out of int16 range"
                            )
                        row[0] = pred
                        ac = True
                        lenb, symb = ac_lut.length_b, ac_lut.symbol_b
                preds[ci] = pred
            mcu += 1
    if mcu != total_mcus:
        raise JpegEntropyCorrupt(
            f"decoded {mcu} of {total_mcus} MCUs (truncated scan)"
        )


def _run_scan(
    segments, planes, mcu_blocks, ncomp, mcus_x, total_mcus, interval,
    backend,
):
    """Backend dispatch for the scan hot loop; returns the backend that
    ran (``"native"`` / ``"python"``).

    ``backend=None`` prefers the native loop when it is enabled and builds,
    and otherwise runs the pure-Python pass (bit-equal by contract).  An
    unexpected native failure (not a typed corrupt-stream error) re-decodes
    this one image with the Python pass, counted ``native_entropy_fallback``
    in :data:`native_entropy.counters`.  ``"native"`` / ``"python"`` pin a
    backend; a pinned native backend raises rather than degrade."""
    if backend == "python":
        _decode_scan(
            segments, planes, mcu_blocks, ncomp, mcus_x, total_mcus, interval
        )
        return "python"
    if backend == "native":
        if not native_entropy.decode_scan(
            segments, planes, mcu_blocks, ncomp, mcus_x, total_mcus, interval
        ):
            raise RuntimeError(
                "entropy backend pinned to 'native' but the native library "
                "is unavailable (check g++)"
            )
        return "native"
    if backend is not None:
        raise ValueError(f"unknown entropy backend {backend!r}")
    if native_entropy.enabled():
        try:
            if native_entropy.decode_scan(
                segments, planes, mcu_blocks, ncomp, mcus_x, total_mcus,
                interval,
            ):
                return "native"
        except JpegEntropyCorrupt:
            raise  # typed classification, identical to the Python pass
        except Exception as exc:  # noqa: BLE001 — degrade, counted
            native_entropy.counters["native_entropy_fallback"] += 1
            _logger.warning(
                "native entropy decode failed (%s: %s); this image is "
                "decoded by the pure-Python pass", type(exc).__name__, exc,
            )
            # the native call may have written part of the image
            for p in planes:
                p[...] = 0
    _decode_scan(
        segments, planes, mcu_blocks, ncomp, mcus_x, total_mcus, interval
    )
    return "python"


def entropy_backend() -> str:
    """The backend the auto dispatch would pick right now (``"native"`` /
    ``"python"``).  Triggers the native build, so call it from setup code,
    not per image."""
    return "native" if native_entropy.available() else "python"


def _u16(data: bytes, i: int) -> int:
    return (data[i] << 8) | data[i + 1]


@dataclasses.dataclass
class _Frame:
    height: int = 0
    width: int = 0
    comps: list = dataclasses.field(default_factory=list)  # (id, h, v, tq)
    restart_interval: int = 0
    qt: dict = dataclasses.field(default_factory=dict)  # tq -> [64] u16 zigzag
    huff_dc: dict = dataclasses.field(default_factory=dict)
    huff_ac: dict = dataclasses.field(default_factory=dict)
    scan_comps: list = dataclasses.field(default_factory=list)  # (ci, td, ta)
    scan_at: int = 0  # offset of first entropy-coded byte
    adobe_transform: int | None = None  # APP14 color transform, if present


_SUPPORTED_LUMA = {(1, 1), (2, 1), (2, 2)}


def _parse_headers(data: bytes) -> _Frame:
    if len(data) < 4 or data[0] != 0xFF or data[1] != 0xD8:
        raise JpegDecodeUnsupported("not_jpeg", "missing SOI marker")
    f = _Frame()
    i = 2
    n = len(data)
    while True:
        # seek the next marker (fill bytes 0xFF may repeat)
        while i < n and data[i] != 0xFF:
            i += 1
        while i < n and data[i] == 0xFF:
            i += 1
        if i >= n:
            raise JpegEntropyCorrupt("ran out of data before SOS")
        marker = data[i]
        i += 1
        if marker in (0x01,) or 0xD0 <= marker <= 0xD8:
            continue  # standalone markers
        if marker == 0xD9:
            raise JpegEntropyCorrupt("EOI before any scan data")
        if i + 2 > n:
            raise JpegEntropyCorrupt("truncated marker segment header")
        seg_len = _u16(data, i)
        if seg_len < 2 or i + seg_len > n:
            raise JpegEntropyCorrupt(f"truncated segment FF{marker:02X}")
        seg = data[i + 2 : i + seg_len]
        i += seg_len
        if marker == 0xC2:
            raise JpegDecodeUnsupported("progressive")
        if marker in (0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF):
            raise JpegDecodeUnsupported("arithmetic")
        if marker in (0xC3, 0xC5, 0xC6, 0xC7):
            raise JpegDecodeUnsupported(
                "sof_unsupported", f"SOF marker FF{marker:02X}"
            )
        if marker in (0xC0, 0xC1):  # baseline / extended sequential Huffman
            if seg[0] != 8:
                raise JpegDecodeUnsupported(
                    "precision", f"{seg[0]}-bit samples"
                )
            f.height = _u16(seg, 1)
            f.width = _u16(seg, 3)
            ncomp = seg[5]
            if ncomp == 4:
                raise JpegDecodeUnsupported("cmyk", "4-component frame")
            if ncomp not in (1, 3):
                raise JpegDecodeUnsupported(
                    "components", f"{ncomp}-component frame"
                )
            for c in range(ncomp):
                cid, hv, tq = seg[6 + 3 * c : 9 + 3 * c]
                f.comps.append((cid, hv >> 4, hv & 0xF, tq))
            if ncomp == 3 and tuple(c[0] for c in f.comps) == (
                0x52, 0x47, 0x42,
            ):
                # component ids spell "RGB": channels are stored RGB, and
                # the YCbCr matrix below would hue-shift them silently
                raise JpegDecodeUnsupported(
                    "rgb_colorspace", "RGB component ids"
                )
            if ncomp == 3:
                (_, h0, v0, _), (_, h1, v1, _), (_, h2, v2, _) = f.comps
                if (
                    (h0, v0) not in _SUPPORTED_LUMA
                    or (h1, v1) != (1, 1)
                    or (h2, v2) != (1, 1)
                ):
                    raise JpegDecodeUnsupported(
                        "subsampling",
                        f"Y={h0}x{v0} Cb={h1}x{v1} Cr={h2}x{v2}",
                    )
            continue
        if marker == 0xDB:  # DQT — possibly several tables per segment
            j = 0
            while j < len(seg):
                pq, tq = seg[j] >> 4, seg[j] & 0xF
                j += 1
                if pq == 0:
                    f.qt[tq] = np.frombuffer(
                        seg, np.uint8, 64, j
                    ).astype(np.uint16)
                    j += 64
                else:
                    f.qt[tq] = np.frombuffer(
                        seg[j : j + 128], ">u2", 64
                    ).astype(np.uint16)
                    j += 128
            continue
        if marker == 0xC4:  # DHT
            j = 0
            while j < len(seg):
                tc, th = seg[j] >> 4, seg[j] & 0xF
                counts = np.frombuffer(seg, np.uint8, 16, j + 1)
                total = int(counts.sum())
                table = _huff_lut(
                    bytes(counts), seg[j + 17 : j + 17 + total]
                )
                (f.huff_dc if tc == 0 else f.huff_ac)[th] = table
                j += 17 + total
            continue
        if marker == 0xDD:  # DRI
            f.restart_interval = _u16(seg, 0)
            continue
        if marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            f.adobe_transform = seg[11]
            continue
        if marker == 0xDA:  # SOS
            ns = seg[0]
            if not f.comps:
                raise JpegEntropyCorrupt("SOS before SOF")
            if len(f.comps) == 3 and f.adobe_transform == 0:
                # Adobe APP14 transform=0: three components stored RGB —
                # the YCbCr conversion would silently hue-shift them
                raise JpegDecodeUnsupported(
                    "rgb_colorspace", "Adobe APP14 transform=0"
                )
            if ns != len(f.comps):
                raise JpegDecodeUnsupported(
                    "multi_scan", f"{ns} of {len(f.comps)} components in scan"
                )
            for s in range(ns):
                cs, tdta = seg[1 + 2 * s : 3 + 2 * s]
                ci = next(
                    (k for k, c in enumerate(f.comps) if c[0] == cs), None
                )
                if ci is None:
                    raise JpegEntropyCorrupt(
                        f"scan names unknown component {cs}"
                    )
                f.scan_comps.append((ci, tdta >> 4, tdta & 0xF))
            ss, se = seg[1 + 2 * ns], seg[2 + 2 * ns]
            if (ss, se) != (0, 63):
                raise JpegDecodeUnsupported(
                    "spectral_selection", f"Ss={ss} Se={se}"
                )
            f.scan_at = i
            return f
        # APPn / COM / anything else: skipped


def _split_scan(data: bytes, start: int) -> list[bytes]:
    """Slice the entropy-coded data into UNSTUFFED restart segments.
    ``0xFF00`` is byte stuffing (kept as a data ``0xFF``), ``0xFFD0-D7``
    are restart markers (segment boundaries), any other marker ends the
    scan."""
    arr = np.frombuffer(data, np.uint8, len(data) - start, start)
    ff = np.flatnonzero(arr[:-1] == 0xFF)
    nxt = arr[ff + 1]
    raw = arr.tobytes()
    seg_start = 0
    end = len(raw)
    cut_points: list[int] = []
    for pos, code in zip(ff.tolist(), nxt.tolist()):
        if pos < seg_start:
            continue  # inside an already-consumed marker pair
        if code == 0x00:
            continue  # stuffing, handled by the replace below
        if code == 0xFF:
            continue  # fill byte; the NEXT 0xFF position classifies it
        if 0xD0 <= code <= 0xD7:
            cut_points.append(pos)
            seg_start = pos + 2
            continue
        end = pos  # real marker: scan ends here
        break
    out = []
    prev = 0
    for cut in cut_points:
        if cut >= end:
            break
        out.append(raw[prev:cut].replace(b"\xff\x00", b"\xff"))
        prev = cut + 2
    out.append(raw[prev:end].replace(b"\xff\x00", b"\xff"))
    return out


def entropy_decode(data: bytes, *, backend: str | None = None) -> CoeffImage:
    """Baseline-JPEG bytes -> :class:`CoeffImage` (host entropy pass only).

    Raises :class:`JpegDecodeUnsupported` (typed fallback routing) for
    streams outside the claimed subset and :class:`JpegEntropyCorrupt`
    (typed counted skip) for damaged scans.

    ``backend`` pins the scan hot loop: ``"native"`` (``csrc/entropy.cpp``,
    raises if it cannot be built), ``"python"`` (the portable pass), or
    ``None`` — native when available, Python otherwise, bit-identical
    output either way (see :func:`_run_scan`)."""
    f = _parse_headers(data)
    ncomp = len(f.comps)
    hmax = max(c[1] for c in f.comps)
    vmax = max(c[2] for c in f.comps)
    mcus_x = -(-f.width // (8 * hmax))
    mcus_y = -(-f.height // (8 * vmax))
    if f.height == 0 or f.width == 0:
        raise JpegEntropyCorrupt("zero-sized frame")

    # per-component coefficient planes, MCU-padded, zigzag written flat
    planes = []
    qts = np.zeros((ncomp, 8, 8), np.float32)
    for k, (_cid, h, v, tq) in enumerate(f.comps):
        planes.append(np.zeros((mcus_y * v, mcus_x * h, 64), np.int16))
        if tq not in f.qt:
            raise JpegEntropyCorrupt(f"missing quant table {tq}")
        nat = np.zeros(64, np.float32)
        nat[ZIGZAG] = f.qt[tq].astype(np.float32)
        qts[k] = nat.reshape(8, 8)

    for ci, td, ta in f.scan_comps:
        if td not in f.huff_dc or ta not in f.huff_ac:
            raise JpegEntropyCorrupt(
                f"scan references missing Huffman table dc={td} ac={ta}"
            )

    segments = _split_scan(data, f.scan_at)
    total_mcus = mcus_x * mcus_y
    interval = f.restart_interval or total_mcus
    expected_segments = -(-total_mcus // interval)
    if len(segments) < expected_segments:
        raise JpegEntropyCorrupt(
            f"scan holds {len(segments)} restart segment(s), geometry "
            f"needs {expected_segments}"
        )

    # per-MCU (component, block-row, block-col, dc_lut, ac_lut) unrolled
    # once so the hot loop below carries no per-block geometry arithmetic
    mcu_blocks = []
    for ci, td, ta in f.scan_comps:
        _cid, h, v, _tq = f.comps[ci]
        for by in range(v):
            for bx in range(h):
                mcu_blocks.append(
                    (ci, v, h, by, bx, f.huff_dc[td], f.huff_ac[ta])
                )
    _run_scan(
        segments[:expected_segments], planes, mcu_blocks, ncomp,
        mcus_x, total_mcus, interval, backend,
    )

    geom = JpegGeometry(
        height=f.height,
        width=f.width,
        sampling=tuple((h, v) for _cid, h, v, _tq in f.comps),
        block_shape=tuple(p.shape[:2] for p in planes),
    )
    coeffs = tuple(
        p.reshape(p.shape[0], p.shape[1], 8, 8) for p in planes
    )
    return CoeffImage(geom=geom, coeffs=coeffs, qt=qts)


def stack_coeff_images(images: list) -> tuple:
    """Stack same-geometry :class:`CoeffImage`s into the batched arrays
    :func:`decode_batch` consumes: ``(coeffs_tuple, qt)``."""
    geom = images[0].geom
    coeffs = tuple(
        np.stack([img.coeffs[c] for img in images])
        for c in range(geom.n_components)
    )
    qt = np.stack([img.qt for img in images])
    return coeffs, qt


# -- device batch pass ---------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _idct_basis() -> np.ndarray:
    """Orthonormal 8-point DCT-II basis A (A @ A.T = I): spatial samples
    x = A.T @ X @ A for coefficient block X."""
    k = np.arange(8)[:, None].astype(np.float64)
    n = np.arange(8)[None, :].astype(np.float64)
    a = np.cos((2 * n + 1) * k * np.pi / 16.0) * 0.5
    a[0] *= 1.0 / np.sqrt(2.0)
    return a.astype(np.float32)


_basis_cache: dict = {}


def _basis(device, dtype):
    """``_idct_basis()`` as a tensor on ``device`` in ``dtype`` (cached)."""
    key = (str(device), dtype)
    a = _basis_cache.get(key)
    if a is None:
        a = _basis_cache[key] = torch.from_numpy(_idct_basis()).to(device, dtype)
    return a


def idct_blocks_reference(blocks):
    """Plain PyTorch version of the kernel (counterpart of
    ``idct_blocks_jnp``): ``[..., 8, 8]`` dequantised coefficients -> spatial
    samples ``Aᵀ X A`` (no level shift), in the input's float dtype.  On the
    card it stays full f32 because ``utils.platform`` keeps TF32 off."""
    a = _basis(blocks.device, blocks.dtype)
    return torch.einsum("ij,...jk,kl->...il", a.T, blocks, a)


_SIGNATURES = {
    "idct_launch": (
        ctypes.c_int,
        [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # x, a, out
            ctypes.c_longlong, ctypes.c_void_p,  # n blocks, stream
        ],
    ),
    "decode_planes_launch": (
        ctypes.c_int,
        [
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),  # coeffs, planes
            ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_longlong,  # dims, ncomp, batch
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # qt, basis, stream
        ],
    ),
    "decode_pixels_launch": (
        ctypes.c_int,
        [
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),  # planes, dims
            ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,  # ncomp batch H W
            ctypes.c_void_p, ctypes.c_void_p,  # out, stream
        ],
    ),
}


def idct_blocks(blocks):
    """``[..., 8, 8]`` f32 blocks -> their inverse DCT.  On a CUDA tensor it
    launches the hand-written kernel ``csrc/idct.cu`` (or raises); on a CPU
    tensor it runs :func:`idct_blocks_reference`."""
    if blocks.device.type == "cpu":
        return idct_blocks_reference(blocks)
    if blocks.device.type != "cuda":
        raise ValueError(f"idct_blocks: unsupported device {blocks.device}")
    if blocks.dim() < 2 or tuple(blocks.shape[-2:]) != (8, 8):
        raise ValueError(f"idct_blocks: expected [..., 8, 8], got {tuple(blocks.shape)}")
    if blocks.dtype != torch.float32:
        raise TypeError(f"idct_blocks: blocks must be float32, got {blocks.dtype}")
    if not blocks.is_contiguous():
        raise ValueError("idct_blocks: blocks must be contiguous")
    out = torch.empty_like(blocks)
    n = blocks.numel() // 64
    if n == 0:
        return out
    lib = _build.load("idct", _SIGNATURES)
    rc = lib.idct_launch(
        blocks.data_ptr(), _basis(blocks.device, torch.float32).data_ptr(),
        out.data_ptr(), n, torch.cuda.current_stream(blocks.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"idct kernel launch failed: cudaError {rc}")
    global launches
    launches += 1
    return out


def _upsample2_h(plane):
    """libjpeg ``h2v1`` fancy (triangular) upsample along the last axis:
    out[2i] = (3*s[i] + s[i-1]) / 4, out[2i+1] = (3*s[i] + s[i+1]) / 4,
    edges replicated."""
    left = torch.cat([plane[..., :1], plane[..., :-1]], dim=-1)
    right = torch.cat([plane[..., 1:], plane[..., -1:]], dim=-1)
    even = (3.0 * plane + left) * 0.25
    odd = (3.0 * plane + right) * 0.25
    out = torch.stack([even, odd], dim=-1)
    return out.reshape(*plane.shape[:-1], plane.shape[-1] * 2)


def _upsample2_v(plane):
    return _upsample2_h(plane.transpose(-1, -2)).transpose(-1, -2)


def _blocks_to_plane(x):
    """[B, by, bx, 8, 8] -> [B, by*8, bx*8]."""
    b, by, bx = x.shape[:3]
    return x.permute(0, 1, 3, 2, 4).reshape(b, by * 8, bx * 8)


@dataclasses.dataclass(frozen=True)
class PlaneSpec:
    """One component's plane in the decode: its true sample grid
    ``height x width`` (the MCU-padded block grid cropped), and whether it is
    upsampled 2x along x (``up_h``) and along y (``up_v``) to the image."""

    height: int
    width: int
    up_h: bool
    up_v: bool


@functools.lru_cache(maxsize=64)
def plane_layout(geom: JpegGeometry) -> tuple:
    """The :class:`PlaneSpec` of each component of ``geom``: the crop comes
    BEFORE upsampling, so the MCU pad region (encoder filler) never bleeds
    into real pixels through the triangular filter."""
    hmax = max(h for h, _v in geom.sampling)
    vmax = max(v for _h, v in geom.sampling)
    return tuple(
        PlaneSpec(
            height=-(-geom.height * cv // vmax),
            width=-(-geom.width * ch // hmax),
            up_h=ch < hmax,
            up_v=cv < vmax,
        )
        for ch, cv in geom.sampling
    )


def decode_pixels_reference(geom: JpegGeometry, coeffs, qt):
    """Plain PyTorch composition of the decode: coefficient tensors (+
    per-image quant tables), all on one device -> [B, H, W, 3] BGR f32
    pixel batch, integral values in [0, 255].  Its IDCT is
    :func:`idct_blocks` (the kernel on a CUDA tensor), so on the card it is
    the decode that :func:`decode_pixels` reproduces bit for bit."""
    h_img, w_img = geom.height, geom.width
    planes = []
    for c, spec in enumerate(plane_layout(geom)):
        x = coeffs[c].to(torch.float32) * qt[:, c][:, None, None]
        x = idct_blocks(x) + 128.0
        plane = _blocks_to_plane(x)[:, : spec.height, : spec.width]
        if spec.up_h:
            plane = _upsample2_h(plane)
        if spec.up_v:
            plane = _upsample2_v(plane)
        planes.append(plane[:, :h_img, :w_img])
    y = planes[0]
    if geom.n_components == 1:
        rgb = (y, y, y)
    else:
        cb = planes[1] - 128.0
        cr = planes[2] - 128.0
        rgb = (
            y + 1.40200 * cr,
            y - 0.344136 * cb - 0.714136 * cr,
            y + 1.77200 * cb,
        )
    # BGR channel order, round half-to-even, then clamp (decode_image's
    # contract: integral f32 in [0, 255])
    bgr = torch.stack([rgb[2], rgb[1], rgb[0]], dim=-1)
    return torch.clamp(torch.round(bgr), 0.0, 255.0)


def _check_decode_inputs(geom: JpegGeometry, coeffs, qt, layout) -> int:
    """Raise unless ``coeffs``/``qt`` are what the kernel takes for
    ``geom``; returns the batch size."""
    if geom.n_components not in (1, 3) or len(coeffs) != geom.n_components:
        raise ValueError(
            f"decode_pixels: {len(coeffs)} coefficient tensors for "
            f"{geom.n_components} components (1 or 3 are decoded)"
        )
    dev = coeffs[0].device
    b = coeffs[0].shape[0] if coeffs[0].dim() else 0
    hmax = max(h for h, _v in geom.sampling)
    vmax = max(v for _h, v in geom.sampling)
    for c, (t, (by, bx), spec, (ch, cv)) in enumerate(
        zip(coeffs, geom.block_shape, layout, geom.sampling)
    ):
        if t.device != dev:
            raise ValueError(f"decode_pixels: component {c} is on {t.device}, not {dev}")
        if t.dtype != torch.int16:
            raise TypeError(f"decode_pixels: coefficients must be int16, got {t.dtype}")
        if tuple(t.shape) != (b, by, bx, 8, 8):
            raise ValueError(
                f"decode_pixels: component {c} has shape {tuple(t.shape)}, "
                f"expected {(b, by, bx, 8, 8)}"
            )
        if not t.is_contiguous():
            raise ValueError(f"decode_pixels: component {c} must be contiguous")
        if hmax not in (ch, 2 * ch) or vmax not in (cv, 2 * cv):
            raise ValueError(f"decode_pixels: sampling {geom.sampling} is not 1x or 2x")
        if spec.height > 8 * by or spec.width > 8 * bx:
            raise ValueError(f"decode_pixels: plane {spec} exceeds its {by}x{bx} blocks")
    if qt.device != dev:
        raise ValueError(f"decode_pixels: quant tables are on {qt.device}, not {dev}")
    if qt.dtype != torch.float32:
        raise TypeError(f"decode_pixels: quant tables must be float32, got {qt.dtype}")
    if tuple(qt.shape) != (b, geom.n_components, 8, 8) or not qt.is_contiguous():
        raise ValueError(
            f"decode_pixels: quant tables must be contiguous "
            f"{(b, geom.n_components, 8, 8)}, got {tuple(qt.shape)}"
        )
    return b


def decode_pixels(geom: JpegGeometry, coeffs, qt):
    """Coefficient tensors ([B, by, bx, 8, 8] int16 per component) + [B,
    ncomp, 8, 8] f32 quant tables, all on one device -> [B, H, W, 3] BGR f32
    pixels, integral in [0, 255].  On CUDA tensors two launches of
    ``csrc/idct.cu`` (all components' planes, then the pixels), bit-equal to
    :func:`decode_pixels_reference` on the card; anything the kernel does not
    take raises.  On CPU tensors it runs :func:`decode_pixels_reference`."""
    dev = coeffs[0].device
    if dev.type == "cpu":
        return decode_pixels_reference(geom, coeffs, qt)
    if dev.type != "cuda":
        raise ValueError(f"decode_pixels: unsupported device {dev}")
    layout = plane_layout(geom)
    b = _check_decode_inputs(geom, coeffs, qt, layout)
    out = torch.empty((b, geom.height, geom.width, 3), dtype=torch.float32, device=dev)
    if b == 0:
        return out
    sizes = [b * spec.height * spec.width for spec in layout]
    buf = torch.empty(sum(sizes), dtype=torch.float32, device=dev)  # the planes
    plane_ptrs = [buf.data_ptr() + 4 * sum(sizes[:c]) for c in range(len(sizes))]
    ncomp = geom.n_components
    pointers = ctypes.c_void_p * ncomp
    dims = ctypes.c_int * (4 * ncomp)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _build.load("idct", _SIGNATURES)
    global decode_launches
    rc = lib.decode_planes_launch(
        pointers(*(t.data_ptr() for t in coeffs)),
        pointers(*plane_ptrs),
        dims(*(d for (by, bx), spec in zip(geom.block_shape, layout)
               for d in (by, bx, spec.height, spec.width))),
        ncomp, b, qt.data_ptr(), _basis(dev, torch.float32).data_ptr(), stream,
    )
    if rc != 0:
        raise RuntimeError(f"decode_planes kernel launch failed: cudaError {rc}")
    decode_launches += 1
    rc = lib.decode_pixels_launch(
        pointers(*plane_ptrs),
        dims(*(int(d) for spec in layout
               for d in (spec.height, spec.width, spec.up_h, spec.up_v))),
        ncomp, b, geom.height, geom.width, out.data_ptr(), stream,
    )
    if rc != 0:
        raise RuntimeError(f"decode_pixels kernel launch failed: cudaError {rc}")
    decode_launches += 1
    return out


def _on_device(a, device, dtype=None):
    """A numpy array or tensor as a tensor on ``device`` (no copy when it is
    already there); ``dtype`` casts after the copy."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
    t = t.to(device, non_blocking=True)
    return t if dtype is None else t.to(dtype)


def decode_batch(geom: JpegGeometry, coeffs, qt, device=None):
    """Batched decode: per-component coefficient arrays ([B, by, bx, 8, 8],
    int16, numpy or tensors) + [B, ncomp, 8, 8] quant tables -> [B, H, W, 3]
    BGR f32 pixels on ``device`` (default: the coefficients' device when
    they are tensors, else ``"cuda"``).  The coefficients cross to the card
    as int16 and are cast to f32 there."""
    if device is None:
        device = coeffs[0].device if isinstance(coeffs[0], torch.Tensor) else "cuda"
    device = torch.device(device)
    coeffs = tuple(_on_device(c, device) for c in coeffs)
    qt = _on_device(qt, device, torch.float32)
    return decode_pixels(geom, coeffs, qt)


def fused_apply(transform, geom: JpegGeometry, coeffs, qt, device=None):
    """``transform(decode_batch(geom, coeffs, qt, device))``: coefficient
    batches straight to features, the pixels born on the card.

    Unlike the JAX package's, there is no program cache (PyTorch runs
    eagerly, so there is nothing to compile) and no HBM admission of the
    decode+featurize: ``core/memory`` is not ported yet (ROADMAP Queue 1
    item 12)."""
    return transform(decode_batch(geom, coeffs, qt, device))
