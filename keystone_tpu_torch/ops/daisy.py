"""DAISY dense descriptors (counterpart of keystone_tpu/ops/daisy.py;
reference src/main/scala/nodes/images/DaisyExtractor.scala:28-201; Tola,
Lepetit, Fua — PAMI 2010).

Oriented gradient maps from separable [1,0,-1]x[1,2,1] convolutions, a
cascade of Gaussian blur layers, ring sampling of histograms, and a
per-histogram L2 normalization with a zero threshold.  Plain PyTorch on
the input's device: the convolutions are LCS's shifted-slice sums in tap
order (``ops/lcs._same_conv2d_zero``), the norms add the orientations in
a fixed order with a correctly rounded square root (``utils/stats.sqrt_rn``),
and the ring sampling is one index gather per ring point, so each image
gets the same bits at every batch size, on the card as on the CPU.

Output per image: ``[num_keypoints, daisyH·(daisyT·daisyQ + 1)]`` — DAISY
descriptors are rows (the reference's DenseMatrix layout), unlike the
SIFT/LCS column convention.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.pipeline import Transformer, node
from ..utils.stats import sqrt_rn
from .lcs import _same_conv2d_zero

FEATURE_THRESHOLD = 1e-8  # zero histograms below this norm
CONV_THRESHOLD = 1e-6  # where to truncate the Gaussian blurs


@node(
    meta_fields=("daisy_t", "daisy_q", "daisy_r", "daisy_h", "pixel_border", "stride", "patch_size"),
)
class DaisyExtractor(Transformer):
    """Batched DAISY: ``[N, H, W, 1]`` (or ``[N, H, W]``) -> ``[N, K,
    feature_size]`` f32 on the input's device; keypoints ``x·numY + y``,
    columns ``daisyH + angle·Q·H + level·H`` after the centre histogram."""

    def __init__(
        self,
        daisy_t: int = 8,
        daisy_q: int = 3,
        daisy_r: int = 7,
        daisy_h: int = 8,
        pixel_border: int = 16,
        stride: int = 4,
        patch_size: int = 24,
    ):
        self.daisy_t = daisy_t
        self.daisy_q = daisy_q
        self.daisy_r = daisy_r
        self.daisy_h = daisy_h
        self.pixel_border = pixel_border
        self.stride = stride
        self.patch_size = patch_size

    @property
    def feature_size(self) -> int:
        return self.daisy_h * (self.daisy_t * self.daisy_q + 1)

    def _gaussians(self):
        """Blur kernels g[q] from the sigma-difference cascade (:50-64),
        computed in f64 and rounded to f32."""
        q_range = np.arange(self.daisy_q + 1)
        sigma_sq = (self.daisy_r * q_range / (2.0 * self.daisy_q)) ** 2
        diff = sigma_sq[1:] - sigma_sq[:-1]
        kernels = []
        for t in diff:
            rad = int(
                math.ceil(
                    math.sqrt(-2 * t * math.log(CONV_THRESHOLD) - t * math.log(2 * math.pi * t))
                )
            )
            n = np.arange(-rad, rad + 1, dtype=np.float64)
            k = np.exp(-(n**2) / (2.0 * t)) / math.sqrt(2 * math.pi * t)
            kernels.append(k.astype(np.float32))
        return kernels

    def _keypoints(self, dim: int) -> np.ndarray:
        return np.arange(self.pixel_border, dim - self.pixel_border, self.stride)

    def __call__(self, batch):
        x = batch.to(torch.float32)
        if x.ndim == 3:
            x = x[..., None]
        x = x[..., :1]
        n, h, w, _ = x.shape
        nh = self.daisy_h
        f1 = np.array([1.0, 0.0, -1.0], np.float32)
        f2 = np.array([1.0, 2.0, 1.0], np.float32)
        # gradients (:111-113): conv2D(in, filter1, filter2) = d/dx smoothed
        ix = _same_conv2d_zero(x, f1, f2)[..., 0]
        iy = _same_conv2d_zero(x, f2, f1)[..., 0]

        # orientation maps max(cos(a)·ix + sin(a)·iy, 0), then the blur
        # cascade (:116-137); layers[q] is [N, daisyH, H, W]
        angles = 2.0 * np.pi * np.arange(nh) / nh
        current = torch.stack(
            [torch.clamp_min(math.cos(a) * ix + math.sin(a) * iy, 0.0) for a in angles], dim=1
        )
        del ix, iy
        layers = []
        for g in self._gaussians():
            flat = current.reshape(n * nh, h, w, 1)
            current = _same_conv2d_zero(flat, g, g).reshape(n, nh, h, w)
            layers.append(current)

        xs, ys = self._keypoints(w), self._keypoints(h)
        # keypoint grid flattened as x·numY + y (:151-199)
        kp_x = np.repeat(xs, len(ys))
        kp_y = np.tile(ys, len(xs))

        def sample(layer, sy, sx):
            # [N, daisyH, K] histograms, L2-normalized over daisyH; zero
            # where the norm is at or below the threshold (:193-200)
            hists = layer[:, :, torch.from_numpy(sy).to(x.device),
                          torch.from_numpy(sx).to(x.device)]
            s = hists[:, 0] * hists[:, 0]
            for i in range(1, nh):
                s = s + hists[:, i] * hists[:, i]
            norm = sqrt_rn(s)[:, None]
            return torch.where(norm > FEATURE_THRESHOLD, hists / norm, 0.0)

        # the centre histogram from layer 0 at the keypoint (:96-103), then
        # the rings (:73-94, :165-186) in column order: angle-major, level
        # within it
        blocks = [sample(layers[0], kp_y, kp_x)]
        for angle_count in range(self.daisy_t):
            cur_theta = 2.0 * math.pi * (angle_count - 1) / self.daisy_t
            for level in range(self.daisy_q):
                cur_rad = self.daisy_r * (1.0 + level) / self.daisy_q
                # Python's round (half to even), as in the JAX node
                off_x = int(round(cur_rad * math.sin(cur_theta)))
                off_y = int(round(cur_rad * math.cos(cur_theta)))
                sx = np.clip(kp_x + off_x, 0, w - 1)
                sy = np.clip(kp_y + off_y, 0, h - 1)
                blocks.append(sample(layers[level], sy, sx))
        return torch.cat(blocks, dim=1).transpose(1, 2).contiguous()  # [N, K, featSize]
