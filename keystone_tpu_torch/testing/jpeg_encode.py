"""Baseline JPEG encoder in numpy (test scaffolding; no entry point imports it).

It exists so that a machine without an image library can still make real
JPEG files for the device-decode path, and so that a test knows the exact
quantised coefficients a decoder must recover.  :func:`encode_jpeg` does
what a baseline libjpeg encoder does:

* BGR -> RGB -> JFIF YCbCr (8-bit samples), or one grayscale component;
* chroma at 4:2:0 (2x2 box average), 4:2:2 (2x1) or 4:4:4, after padding the
  image to whole MCUs by edge replication;
* level shift, the forward DCT with the same orthonormal basis the decoder
  inverts (``X = A x Aᵀ``), and ``round(X / Q)``;
* libjpeg's quality scaling of the Annex K.1 quant tables and the Annex K.3
  Huffman tables (byte for byte the DQT and DHT segments PIL writes);
* an optional restart interval, byte stuffing and 1-bit padding.

The Huffman stage is vectorised over blocks: symbols from ``np.nonzero`` of
the zig-zagged blocks, ZRL runs by ``np.repeat``, bit positions by
cumulative offsets, and ``np.packbits``.
"""

from __future__ import annotations

import numpy as np

from ..ops.jpeg_device import ZIGZAG, _idct_basis

# Annex K.1 quant tables at libjpeg quality 50 (scale 100), zig-zag order:
# luminance, then chrominance.
_BASE_QT = (
    bytes.fromhex(
        "100b0c0e0c0a100e0d0e1211101318281a181616183123251d283a333d3c39"
        "33383740485c4e404457453738506d51575f626768673e4d71797064785c656763"
    ),
    bytes.fromhex("1112121815182f1a1a2f6342384263" + "63" * 49),
)

# Annex K.3 Huffman tables: 16 code-length counts, then the symbols.
_AC_LUMA_SYMBOLS = (
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f024"
    "33627282090a161718191a25262728292a3435363738393a434445464748494a53"
    "5455565758595a636465666768696a737475767778797a838485868788898a9293"
    "9495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9"
    "cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"
)
_AC_CHROMA_SYMBOLS = (
    "000102031104052131061241510761711322328108144291a1b1c109233352f015"
    "6272d10a162434e125f11718191a262728292a35363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a82838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7"
    "c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"
)
#: (class, table id) -> DHT payload (counts + symbols); class 0 DC, 1 AC.
_DHT = {
    (0, 0): bytes.fromhex("00010501010101010100000000000000" "000102030405060708090a0b"),
    (1, 0): bytes.fromhex("0002010303020403050504040000017d" + _AC_LUMA_SYMBOLS),
    (0, 1): bytes.fromhex("00030101010101010101010000000000" "000102030405060708090a0b"),
    (1, 1): bytes.fromhex("00020102040403040705040400010277" + _AC_CHROMA_SYMBOLS),
}

SUBSAMPLING = {"4:4:4": (1, 1), "4:2:2": (2, 1), "4:2:0": (2, 2)}


def quant_tables(quality: int) -> list[np.ndarray]:
    """libjpeg's ``jpeg_set_quality(quality, force_baseline=TRUE)``: the two
    Annex K.1 tables scaled, as [64] uint8 in zig-zag order."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    out = []
    for base in _BASE_QT:
        q = (np.frombuffer(base, np.uint8).astype(np.int64) * scale + 50) // 100
        out.append(np.clip(q, 1, 255).astype(np.uint8))
    return out


def _huff_codes(payload: bytes) -> tuple[np.ndarray, np.ndarray]:
    """Canonical code and code length per symbol (256 entries each)."""
    counts, symbols = payload[:16], payload[16:]
    code_of = np.zeros(256, np.int64)
    len_of = np.zeros(256, np.int64)
    code = k = 0
    for bits in range(1, 17):
        for _ in range(counts[bits - 1]):
            code_of[symbols[k]] = code
            len_of[symbols[k]] = bits
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


_CODES = {key: _huff_codes(payload) for key, payload in _DHT.items()}


def _bit_length(x: np.ndarray) -> np.ndarray:
    """Bits of |x| (the JPEG magnitude category); 0 for 0."""
    return np.frexp(np.abs(x).astype(np.float64))[1].astype(np.int64)


def _excl_cumsum(x: np.ndarray) -> np.ndarray:
    out = np.zeros(len(x), np.int64)
    np.cumsum(x[:-1], out=out[1:])
    return out


def _encode_segment(blocks: np.ndarray, comps: np.ndarray) -> bytes:
    """Entropy-code one restart segment: ``blocks`` [n, 64] zig-zagged
    quantised coefficients in scan order, ``comps`` [n] the component of
    each block (component 0 uses Huffman tables 0, the others tables 1).
    Returns the stuffed, 1-padded bytes."""
    n = len(blocks)
    tables = np.minimum(comps, 1)
    dc = blocks[:, 0].astype(np.int64)
    diff = np.empty(n, np.int64)
    for c in np.unique(comps):  # DC prediction per component
        sel = np.flatnonzero(comps == c)
        diff[sel] = np.diff(dc[sel], prepend=0)
    dc_size = _bit_length(diff)
    if dc_size.max(initial=0) > 11:
        raise ValueError("DC difference out of the baseline range")
    dc_code = np.empty(n, np.int64)
    dc_len = np.empty(n, np.int64)
    for t in np.unique(tables):
        sel = tables == t
        code_of, len_of = _CODES[(0, int(t))]
        dc_code[sel] = code_of[dc_size[sel]]
        dc_len[sel] = len_of[dc_size[sel]]
    dc_extra = np.where(diff >= 0, diff, diff + (1 << dc_size) - 1)

    # AC symbols: one per nonzero coefficient, preceded by its ZRLs.
    nzb, nzp = np.nonzero(blocks[:, 1:])
    pos = nzp + 1
    first = np.ones(len(nzb), bool)
    first[1:] = nzb[1:] != nzb[:-1]
    prev = np.where(first, 0, np.concatenate([[0], pos[:-1]]))
    run = pos - prev - 1
    zrl, rem = run >> 4, run & 15
    val = blocks[:, 1:][nzb, nzp].astype(np.int64)
    size = _bit_length(val)
    if size.max(initial=0) > 10:
        raise ValueError("AC coefficient out of the baseline range")
    sym = (rem << 4) | size
    ac_tab = tables[nzb]
    ac_code = np.empty(len(nzb), np.int64)
    ac_len = np.empty(len(nzb), np.int64)
    zrl_code = np.empty(len(nzb), np.int64)
    zrl_len = np.empty(len(nzb), np.int64)
    for t in np.unique(tables):
        sel = ac_tab == t
        code_of, len_of = _CODES[(1, int(t))]
        ac_code[sel], ac_len[sel] = code_of[sym[sel]], len_of[sym[sel]]
        zrl_code[sel], zrl_len[sel] = code_of[0xF0], len_of[0xF0]
    ac_extra = np.where(val >= 0, val, val + (1 << size) - 1)

    # EOB unless the block's last nonzero sits at position 63.
    last = np.zeros(n, np.int64)
    last[nzb] = pos  # nonzeros are in order, so the last write wins
    eob = last < 63
    eob_code = np.empty(n, np.int64)
    eob_len = np.empty(n, np.int64)
    for t in np.unique(tables):
        sel = tables == t
        code_of, len_of = _CODES[(1, int(t))]
        eob_code[sel], eob_len[sel] = code_of[0x00], len_of[0x00]

    # Event slots: per block DC, then (ZRL*, AC) per nonzero, then EOB.
    per_nz = zrl + 1
    count = 1 + np.bincount(nzb, weights=per_nz, minlength=n).astype(np.int64) + eob
    block_start = _excl_cumsum(count)
    nz_cum = _excl_cumsum(per_nz)
    first_cum = nz_cum[first]  # cumulative count at each block's first nonzero
    block_of_first = np.cumsum(first) - 1
    nz_start = block_start[nzb] + 1 + nz_cum - first_cum[block_of_first]
    total = int(count.sum())
    codes = np.empty(total, np.int64)
    lens = np.empty(total, np.int64)
    codes[block_start] = (dc_code << dc_size) | dc_extra
    lens[block_start] = dc_len + dc_size
    n_zrl = int(zrl.sum())
    if n_zrl:
        zrl_at = np.repeat(nz_start, zrl) + (np.arange(n_zrl) - np.repeat(_excl_cumsum(zrl), zrl))
        codes[zrl_at] = np.repeat(zrl_code, zrl)
        lens[zrl_at] = np.repeat(zrl_len, zrl)
    ac_at = nz_start + zrl
    codes[ac_at] = (ac_code << size) | ac_extra
    lens[ac_at] = ac_len + size
    eob_at = (block_start + count - 1)[eob]
    codes[eob_at] = eob_code[eob]
    lens[eob_at] = eob_len[eob]

    # Bits, MSB first: each event (at most 27 bits) is placed in the 40-bit
    # window that starts at its first byte, and the five bytes of every
    # window are summed into the output (the events' bits are disjoint, so
    # the sum is their OR).  Then 1-bit padding to a whole byte.
    starts = _excl_cumsum(lens)
    nbits = int(lens.sum())
    nbytes = -(-nbits // 8)
    window = codes << (40 - (starts & 7) - lens)
    first_byte = starts >> 3
    out = np.zeros(nbytes + 5)
    for j in range(5):
        out += np.bincount(first_byte + j, weights=(window >> (32 - 8 * j)) & 0xFF,
                           minlength=nbytes + 5)
    out = out[:nbytes].astype(np.uint8)
    if nbits % 8:
        out[-1] |= (1 << (8 - nbits % 8)) - 1
    return out.tobytes().replace(b"\xff", b"\xff\x00")


def _segment(marker: int, payload: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") + payload


def encode_jpeg(
    image: np.ndarray, quality: int = 90, subsampling: str = "4:2:0",
    restart_interval: int = 0,
) -> tuple[bytes, tuple[np.ndarray, ...]]:
    """Encode ``image`` (BGR ``[H, W, 3]`` or grayscale ``[H, W]``, values in
    [0, 255]) as a baseline JPEG.  Returns the file's bytes and the
    quantised coefficients per component, ``[by, bx, 8, 8]`` int16 in
    natural order over the MCU-padded block grid: what a decoder's entropy
    pass must recover exactly.  ``restart_interval`` is in MCUs (0: none)."""
    img = np.asarray(image, np.float64)
    height, width = img.shape[:2]
    if img.ndim == 2:
        samples = [img]
        sampling = [(1, 1)]
    else:
        b, g, r = img[..., 0], img[..., 1], img[..., 2]
        samples = [
            0.299 * r + 0.587 * g + 0.114 * b,
            -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0,
            0.5 * r - 0.418688 * g - 0.081312 * b + 128.0,
        ]
        sampling = [SUBSAMPLING[subsampling], (1, 1), (1, 1)]
    samples = [np.clip(np.floor(s + 0.5), 0, 255) for s in samples]
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    mcus_x = -(-width // (8 * hmax))
    mcus_y = -(-height // (8 * vmax))
    pad_h, pad_w = mcus_y * 8 * vmax, mcus_x * 8 * hmax
    qts = quant_tables(quality)
    a = _idct_basis().astype(np.float64)
    coeffs, zz_blocks, order, comp_of = [], [], [], []
    offset = 0
    for c, (plane, (h, v)) in enumerate(zip(samples, sampling)):
        plane = np.pad(plane, ((0, pad_h - height), (0, pad_w - width)), mode="edge")
        fy, fx = vmax // v, hmax // h
        if fy > 1 or fx > 1:  # box-average down to the component's grid
            plane = plane.reshape(pad_h // fy, fy, pad_w // fx, fx).mean(axis=(1, 3))
            plane = np.floor(plane + 0.5)
        by, bx = mcus_y * v, mcus_x * h
        blocks = (plane - 128.0).reshape(by, 8, bx, 8).transpose(0, 2, 1, 3)
        # X = A x A^T as two (blocks*8, 8) @ (8, 8) products
        cols = (blocks.transpose(0, 1, 3, 2).reshape(-1, 8) @ a.T).reshape(by, bx, 8, 8)
        dct = (cols.transpose(0, 1, 3, 2).reshape(-1, 8) @ a.T).reshape(by, bx, 8, 8)
        q_nat = np.zeros(64)
        q_nat[ZIGZAG] = qts[min(c, 1)]
        q = np.round(dct / q_nat.reshape(8, 8)).astype(np.int16)
        coeffs.append(q)
        zz_blocks.append(q.reshape(by * bx, 64)[:, ZIGZAG])
        # scan order: per MCU, this component's v x h blocks, row-major
        rows = np.arange(mcus_y)[:, None, None, None] * v + np.arange(v)[None, None, :, None]
        cols = np.arange(mcus_x)[None, :, None, None] * h + np.arange(h)[None, None, None, :]
        order.append((offset + rows * bx + cols).reshape(mcus_y * mcus_x, v * h))
        comp_of.append(np.full(by * bx, c))
        offset += by * bx
    all_blocks = np.concatenate(zz_blocks)
    all_comps = np.concatenate(comp_of)
    scan = np.concatenate(order, axis=1)  # [mcus, blocks per MCU]
    total_mcus = mcus_y * mcus_x
    interval = restart_interval or total_mcus
    data = []
    for k, start in enumerate(range(0, total_mcus, interval)):
        if k:
            data.append(bytes([0xFF, 0xD0 + (k - 1) % 8]))
        idx = scan[start : start + interval].reshape(-1)
        data.append(_encode_segment(all_blocks[idx], all_comps[idx]))

    ncomp = len(samples)
    ids = range(1, ncomp + 1)
    out = [b"\xff\xd8", _segment(0xE0, bytes.fromhex("4a46494600010100000100010000"))]
    for t in range(min(ncomp, 2)):
        out.append(_segment(0xDB, bytes([t]) + qts[t].tobytes()))
    sof = bytes([8]) + height.to_bytes(2, "big") + width.to_bytes(2, "big") + bytes([ncomp])
    for cid, (h, v), c in zip(ids, sampling, range(ncomp)):
        sof += bytes([cid, (h << 4) | v, min(c, 1)])
    out.append(_segment(0xC0, sof))
    for t in range(min(ncomp, 2)):
        for cls in (0, 1):
            out.append(_segment(0xC4, bytes([(cls << 4) | t]) + _DHT[(cls, t)]))
    if restart_interval:
        out.append(_segment(0xDD, restart_interval.to_bytes(2, "big")))
    sos = bytes([ncomp])
    for cid, c in zip(ids, range(ncomp)):
        sos += bytes([cid, (min(c, 1) << 4) | min(c, 1)])
    out.append(_segment(0xDA, sos + bytes([0, 63, 0])))
    out.extend(data)
    out.append(b"\xff\xd9")
    return b"".join(out), tuple(coeffs)
