"""Histogram of Oriented Gradients, Felzenszwalb/voc-dpm variant
(counterpart of keystone_tpu/ops/hog.py; reference
src/main/scala/nodes/images/HogExtractor.scala:33-296, itself a port of
voc-dpm features.cc).

31-dim cell features: 18 contrast-sensitive + 9 contrast-insensitive
orientation channels (block-normalized by 4 neighbourhoods, clamped at
0.2), 4 texture-energy features, 1 truncation feature (always 0).

Plain PyTorch on the input's device.  The JAX node builds the histogram
with four scatter-adds; on CUDA a scatter-add of floats is atomic, so two
runs could differ in the last bits.  Here the histogram takes no atomics:
each pixel's magnitude goes into its orientation's plane (one write per
pixel), and the bilinear split over its two neighbouring cells along y,
then along x, is a sum of strided slices in a fixed order, since the cell
weights depend only on the pixel's position within its cell.  So every
image gets the same bits on every run and at every batch size, and with
the square roots correctly rounded (``utils/stats.sqrt_rn``) the same bits
on the card as on the CPU.  The sum runs in another order than the JAX
scatter, so parity with the JAX node is by tolerance.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.pipeline import Transformer, node
from ..utils.stats import sqrt_rn

EPSILON = 0.0001
UU = np.array(
    [1.0, 0.9397, 0.7660, 0.5, 0.1736, -0.1736, -0.5, -0.7660, -0.9397]
)
VV = np.array(
    [0.0, 0.3420, 0.6428, 0.8660, 0.9848, 0.9848, 0.8660, 0.6428, 0.3420]
)


def _cell_grid(bin_size: int, cells: int, interior: int) -> tuple[int, int, np.ndarray]:
    """The padding that lays the interior pixels ``1 .. interior`` of one
    axis out as ``cells + 1`` blocks of ``bin_size`` pixels, block ``j``
    holding the pixels whose lower cell is ``j − 1``, and each pixel's
    weight on its upper cell by its place in the block (the reference's
    ``xp − floor(xp)`` with ``xp = (p + 0.5)/bin_size − 0.5``)."""
    first = bin_size // 2 - bin_size  # the first pixel of block 0 (lower cell −1)
    pos = (first + np.arange(bin_size) + 0.5) / bin_size - 0.5
    upper = pos - np.floor(pos)
    lo = 1 - first
    return lo, (cells + 1) * bin_size - lo - interior, upper


def _to_cells(v: torch.Tensor, dim: int, upper: np.ndarray) -> torch.Tensor:
    """Bilinear sums along ``dim``, laid out by :func:`_cell_grid`: cell
    ``c`` takes ``1 − upper`` of each pixel of block ``c + 1`` and
    ``upper`` of each pixel of block ``c``, added in a fixed order."""
    blocks = v.unflatten(dim, (-1, len(upper)))
    cells = blocks.shape[dim] - 1
    own, below = blocks.narrow(dim, 1, cells), blocks.narrow(dim, 0, cells)
    out = own.select(dim + 1, 0) * float(1.0 - upper[0])
    out += below.select(dim + 1, 0) * float(upper[0])
    for r in range(1, len(upper)):
        out += own.select(dim + 1, r) * float(1.0 - upper[r])
        out += below.select(dim + 1, r) * float(upper[r])
    return out


@node(meta_fields=("bin_size",))
class HogExtractor(Transformer):
    """Batched HOG: ``[N, H, W, C]`` -> ``[N, cells, 32]`` f32 on the input's
    device, where cells = max(numXCells−2, 0)·max(numYCells−2, 0), rows
    x-major, and the 32nd column is the truncation feature (reference
    computeFeaturesFromHist :196-296)."""

    def __init__(self, bin_size: int):
        self.bin_size = bin_size

    def __call__(self, batch):
        x = batch.to(torch.float32)
        n, h, w, c = x.shape
        bs = self.bin_size
        # reference x = column axis, y = row axis; the reference's
        # math.round rounds half away from zero (Python's round() would
        # round 0.5 to even and change the cell grid).
        nx = int(np.floor(w / bs + 0.5))
        ny = int(np.floor(h / bs + 0.5))
        nxf, nyf = max(nx - 2, 0), max(ny - 2, 0)
        if nxf == 0 or nyf == 0:
            return x.new_zeros((n, 0, 32))
        dev = x.device

        # Interior visible pixels [1, vis − 1).  Where a dimension rounds up
        # the visible region exceeds the image: gradient reads clamp to the
        # image interior (features.cc: min(x, dims − 2)), bins use the
        # unclamped coordinate.
        px = np.arange(1, nx * bs - 1)
        py = np.arange(1, ny * bs - 1)
        rows = torch.from_numpy(np.minimum(py, h - 2) - 1).to(dev)
        cols = torch.from_numpy(np.minimum(px, w - 2) - 1).to(dev)
        dxi = (x[:, :, 2:] - x[:, :, :-2])[:, 1:-1]  # [N, h−2, w−2, C]
        dyi = (x[:, 2:] - x[:, :-2])[:, :, 1:-1]
        dx_all = dxi.index_select(1, rows).index_select(2, cols)  # [N, py, px, C]
        dy_all = dyi.index_select(1, rows).index_select(2, cols)
        mag2 = dx_all * dx_all + dy_all * dy_all
        # the channel loop runs 2, 1, 0 with a strict '>': ties keep the
        # highest channel; argmax (the first maximum) on the reversed axis
        best_c = (c - 1) - torch.argmax(mag2.flip(-1), dim=-1, keepdim=True)
        dx = torch.gather(dx_all, -1, best_c)[..., 0]
        dy = torch.gather(dy_all, -1, best_c)[..., 0]
        mag = sqrt_rn(torch.gather(mag2, -1, best_c)[..., 0])

        # orientation snap (:118-133): candidates interleaved (+d0, −d0, +d1, ..)
        uu = torch.tensor(UU, dtype=torch.float32, device=dev)
        vv = torch.tensor(VV, dtype=torch.float32, device=dev)
        dots = dy[..., None] * uu + dx[..., None] * vv  # [N, py, px, 9]
        cand = torch.stack([dots, -dots], dim=-1).reshape(*dots.shape[:-1], 18)
        best_i = torch.argmax(cand, dim=-1)
        orient = torch.where(best_i % 2 == 0, best_i // 2, best_i // 2 + 9)
        # the initial best dot is 0.0: all-zero gradients give orientation 0
        orient = torch.where(cand.amax(dim=-1) > 0.0, orient, 0)

        # the histogram (:136-160): each magnitude in its orientation's plane
        # on the cells' block grid, then the bilinear sums along y (whole
        # rows) and then along x, on the bin_size-fold smaller result
        lo_x, hi_x, up_x = _cell_grid(bs, nx, len(px))
        lo_y, hi_y, up_y = _cell_grid(bs, ny, len(py))
        planes = torch.zeros((n, 18, len(py) + lo_y + hi_y, len(px) + lo_x + hi_x),
                             dtype=torch.float32, device=dev)
        planes.scatter_(1, F.pad(orient, (lo_x, hi_x, lo_y, hi_y))[:, None],
                        F.pad(mag, (lo_x, hi_x, lo_y, hi_y))[:, None])
        hist = _to_cells(_to_cells(planes, 2, up_y), 3, up_x)  # [N, 18, ny, nx]
        del planes

        # block energies (:167-193): opposite orientations combined
        opp = hist[:, :9] + hist[:, 9:]
        norm = opp[:, 0] * opp[:, 0]
        for o in range(1, 9):
            norm = norm + opp[:, o] * opp[:, o]  # [N, ny, nx]

        def block_norm(y0, x0):
            # 1/sqrt of the 2x2 neighbourhood energy starting at (y0, x0)
            s = (
                norm[:, y0 : y0 + nyf, x0 : x0 + nxf]
                + norm[:, y0 : y0 + nyf, x0 + 1 : x0 + 1 + nxf]
                + norm[:, y0 + 1 : y0 + 1 + nyf, x0 : x0 + nxf]
                + norm[:, y0 + 1 : y0 + 1 + nyf, x0 + 1 : x0 + 1 + nxf]
            )
            return 1.0 / sqrt_rn(s + EPSILON)

        nks = (block_norm(1, 1), block_norm(1, 0), block_norm(0, 1), block_norm(0, 0))
        center = hist[:, :, 1 : 1 + nyf, 1 : 1 + nxf]  # [N, 18, nyf, nxf]
        feats = []
        tsum = [torch.zeros_like(nks[0]) for _ in range(4)]
        for o in range(18):
            hs = [torch.clamp_max(center[:, o] * nk, 0.2) for nk in nks]
            for i in range(4):
                tsum[i] = tsum[i] + hs[i]
            feats.append(0.5 * (hs[0] + hs[1] + hs[2] + hs[3]))
        for o in range(9):
            s = center[:, o] + center[:, o + 9]
            hs = [torch.clamp_max(s * nk, 0.2) for nk in nks]
            feats.append(0.5 * (hs[0] + hs[1] + hs[2] + hs[3]))
        for i in range(4):
            feats.append(0.2357 * tsum[i])
        feats.append(torch.zeros_like(nks[0]))  # truncation feature
        stacked = torch.stack(feats, dim=-1)  # [N, nyf, nxf, 32]
        # row index = y + x·numYCellsWithFeatures (:210): x-major rows
        return stacked.transpose(1, 2).reshape(n, nxf * nyf, 32)
