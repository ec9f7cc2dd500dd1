"""Local Color Statistics (counterpart of keystone_tpu/ops/lcs.py).

Per channel: box-filter means and standard deviations (``E[x²] − E[x]²``)
over ``sub_patch_size`` windows, sampled at a 4×4 neighbourhood around
each keypoint of a regular grid: 96-dim descriptors for BGR images
(4·4·3·2).

The box filter is the reference's zero-padded "same" true convolution,
separable, as a sum of shifted slices in f32 (the JAX package runs two
XLA convolutions): batch-invariant bits, where a cuDNN convolution may
pick another algorithm, and another summation order, for another batch
size.  The card and the CPU agree within rtol 1e-5, atol 255e-6, not bit
for bit (the card contracts multiply-adds).  The neighbourhood sampling
is one index gather.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.pipeline import Transformer, node
from ..utils.stats import sqrt_rn


def _conv1d_zero(x: torch.Tensor, taps: np.ndarray, dim: int) -> torch.Tensor:
    """Zero-padded "same" true convolution of ``x`` along ``dim`` with the
    1-D filter ``taps``: padding of ``len − 1`` split floor/ceil, then the
    sum over the reversed taps in tap order, one multiply and one add per
    tap."""
    k = np.asarray(taps, np.float32)[::-1]
    lo = (len(k) - 1) // 2
    size = x.shape[dim]
    pad = [0, 0] * (x.ndim - 1 - dim) + [lo, len(k) - 1 - lo]
    xp = F.pad(x, pad)
    out = xp.narrow(dim, 0, size) * float(k[0])
    for i in range(1, len(k)):
        out += xp.narrow(dim, i, size) * float(k[i])
    return out


def _same_conv2d_zero(batch: torch.Tensor, xfilt, yfilt) -> torch.Tensor:
    """The reference conv2D on ``[N, H, W, C]`` f32: zero padding of
    ``len − 1`` split floor/ceil (low/high), a true convolution (filters
    reversed), output the input's size; ``yfilt`` runs along H, then
    ``xfilt`` along W.

    Each output element is the same sequence of f32 multiplies and adds
    whatever the batch, so a served image gets the bits of the offline
    batch: the standard deviation's ``E[x²] − E[x]²`` cancellation and the
    signed square root of the Fisher vector downstream would turn a one-ulp
    difference here into a visible one in the scores."""
    return _conv1d_zero(_conv1d_zero(batch.to(torch.float32), yfilt, 1), xfilt, 2)


@node(meta_fields=("stride", "stride_start", "sub_patch_size"))
class LCSExtractor(Transformer):
    """Batched LCS: ``[N, H, W, C]`` -> ``[N, 2·16·C, num_keypoints]``
    (descriptors as columns, the SIFT/BatchPCA convention).

    Keypoints: ``stride_start until dim − stride_start by stride`` in x and
    y, columns ordered x-major; descriptor entries ordered channel-major,
    then (nx, ny) neighbourhood, interleaving (mean, std)."""

    def __init__(self, stride: int, stride_start: int, sub_patch_size: int):
        self.stride = stride
        self.stride_start = stride_start
        self.sub_patch_size = sub_patch_size

    def _keypoints(self, dim: int) -> np.ndarray:
        return np.arange(self.stride_start, dim - self.stride_start, self.stride)

    def _neighborhood(self) -> np.ndarray:
        s = self.sub_patch_size
        nbr = np.arange(-2 * s + s // 2 - 1, s + s // 2 - 1 + 1, s)
        # A negative coordinate would wrap to the far edge in a gather (the
        # reference throws): fail loudly instead.
        if self.stride_start + nbr.min() < 0:
            raise ValueError(
                f"stride_start={self.stride_start} too small for "
                f"sub_patch_size={s}: sample offset {nbr.min()} would index "
                "before the image edge"
            )
        return nbr

    def num_keypoints(self, h: int, w: int) -> int:
        return len(self._keypoints(w)) * len(self._keypoints(h))

    def __call__(self, batch):
        n, h, w, c = batch.shape
        s = self.sub_patch_size
        box = np.full(s, 1.0 / s, np.float32)
        x = batch.to(torch.float32)
        means = _same_conv2d_zero(x, box, box)
        sq = _same_conv2d_zero(x * x, box, box)
        # Correctly rounded on every device, so the card matches the CPU.
        stds = sqrt_rn(torch.clamp_min(sq - means * means, 0.0))

        xs, ys, nbr = self._keypoints(w), self._keypoints(h), self._neighborhood()
        sx = torch.from_numpy((xs[:, None] + nbr[None, :]).ravel()).to(batch.device)
        sy = torch.from_numpy((ys[:, None] + nbr[None, :]).ravel()).to(batch.device)
        stats = torch.stack([means, stds], dim=-1)  # [N, H, W, C, 2]
        g = stats[:, sy[:, None], sx[None, :]]  # [N, Ky*4, Kx*4, C, 2]
        g = g.reshape(n, len(ys), nbr.size, len(xs), nbr.size, c, 2)
        # (n, y, ny, x, nx, c, 2) -> (n, x, y, c, nx, ny, 2): nx outer, ny
        # inner, (mean, std) interleaved.
        g = g.permute(0, 3, 1, 5, 4, 2, 6)
        desc = g.reshape(n, len(xs) * len(ys), c * nbr.size * nbr.size * 2)
        return desc.transpose(1, 2).contiguous()  # [N, descDim, K]
