"""Multi-scale dense SIFT (counterpart of keystone_tpu/ops/sift.py).

Per scale ``s``: bin size ``b = bin + 2s``, sampling step
``step + s*scaleStep``, Gaussian smoothing with sigma ``b / 6``, frame
origins from ``(1 + 2S) - 3s``, gradient magnitudes split bilinearly
between the two adjacent of 8 orientation bins, spatial binning as a
triangular convolution sampled at the 4x4 bin centres, then L2 normalise,
clamp at 0.2, renormalise, zero the descriptors whose first norm is below
the contrast threshold, and quantise ``min(floor(512 v), 255)``.

The binning is two banded matrix products (``s_y @ planes @ s_x^T``), which
run as ``torch.matmul`` in f32 on values stored in ``compute_dtype``: the
same arithmetic as the JAX package's f32-accumulating einsums, on the CPU
and on the card alike.  Angle math and the normalise / clamp / quantise
tail always run in f32.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..core.pipeline import Transformer, node
from ..utils.platform import device_constant
from ..utils.stats import sqrt_rn

MAGNIF = 6.0
CONTRAST_THRESHOLD = 0.005
NUM_BIN_T = 8
NUM_BIN_XY = 4
DESC_DIM = NUM_BIN_T * NUM_BIN_XY * NUM_BIN_XY  # 128


def _gaussian_kernel(sigma: float) -> np.ndarray:
    radius = max(1, int(math.ceil(4.0 * sigma)))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _triangular_kernel(bin_size: int) -> np.ndarray:
    # Triangle of half-width bin_size, peak 1 (its scale cancels in the L2
    # normalisation).
    t = np.concatenate(
        [np.arange(1, bin_size + 1), np.arange(bin_size - 1, 0, -1)]
    ).astype(np.float32)
    return t / bin_size


def _binned_sampling_matrix(
    length: int, positions: np.ndarray, kernel: np.ndarray
) -> np.ndarray:
    """[P, length] matrix S with S @ x == (edge-padded convolution of x with
    ``kernel``) evaluated at ``positions``: "convolve, then sample at the
    bin centres" as one banded matrix product."""
    klen = len(kernel)
    r = (klen - 1) // 2
    s = np.zeros((len(positions), length), np.float32)
    for i, p in enumerate(positions):
        for t, kv in enumerate(kernel):
            h = min(max(p + t - r, 0), length - 1)  # edge padding
            s[i, h] += kv
    return s


def _sampling_matrix(length, positions, kernel, dtype, device) -> torch.Tensor:
    """:func:`_binned_sampling_matrix` in ``dtype`` on ``device``."""
    key = ("sift.sampling", length, positions.tobytes(), kernel.tobytes(), str(dtype))
    return device_constant(
        key,
        lambda: torch.from_numpy(_binned_sampling_matrix(length, positions, kernel)).to(dtype),
        device,
    )


def _conv1d_axis(batch: torch.Tensor, kernel: np.ndarray, axis: int) -> torch.Tensor:
    """Convolve [N, H, W] along ``axis`` (1 = rows/y, 2 = columns/x) with
    edge padding.  The kernel is rounded to the batch's dtype, the
    convolution sums in f32 and the result is stored in the batch's dtype."""
    klen = len(kernel)
    r = (klen - 1) // 2
    pad = (0, 0, r, klen - 1 - r) if axis == 1 else (r, klen - 1 - r, 0, 0)
    x = F.pad(batch[:, None].to(torch.float32), pad, mode="replicate")

    def weight():
        k = torch.as_tensor(kernel).to(batch.dtype).to(torch.float32).flip(0)
        return k.reshape(1, 1, klen, 1) if axis == 1 else k.reshape(1, 1, 1, klen)

    key = ("sift.conv1d", kernel.tobytes(), str(batch.dtype), axis)
    return F.conv2d(x, device_constant(key, weight, x.device))[:, 0].to(batch.dtype)


def _smooth(batch: torch.Tensor, sigma: float) -> torch.Tensor:
    k = _gaussian_kernel(sigma)
    return _conv1d_axis(_conv1d_axis(batch, k, 1), k, 2)


def _gradients(batch: torch.Tensor):
    """Derivatives of [N, H, W]: central differences inside, one-sided at
    the edges."""
    gy = torch.empty_like(batch)
    gy[:, 1:-1] = (batch[:, 2:] - batch[:, :-2]) * 0.5
    gy[:, 0] = batch[:, 1] - batch[:, 0]
    gy[:, -1] = batch[:, -1] - batch[:, -2]
    gx = torch.empty_like(batch)
    gx[:, :, 1:-1] = (batch[:, :, 2:] - batch[:, :, :-2]) * 0.5
    gx[:, :, 0] = batch[:, :, 1] - batch[:, :, 0]
    gx[:, :, -1] = batch[:, :, -1] - batch[:, :, -2]
    return gy, gx


def _orientation_planes(gy: torch.Tensor, gx: torch.Tensor) -> torch.Tensor:
    """[N, H, W] -> [N, 8, H, W] f32: the gradient magnitude split with a
    tent weight between the two adjacent orientation bins."""
    gy = gy.to(torch.float32)
    gx = gx.to(torch.float32)
    mag = sqrt_rn(gx * gx + gy * gy)
    a = torch.atan2(gy, gx) * (NUM_BIN_T / (2.0 * math.pi))  # bin units
    t = torch.arange(NUM_BIN_T, dtype=a.dtype, device=a.device)[:, None, None]
    d = torch.abs(
        torch.remainder(a[:, None] - t + NUM_BIN_T / 2, NUM_BIN_T) - NUM_BIN_T / 2
    )
    return mag[:, None] * torch.clamp_min(1.0 - d, 0.0)


def _scale_geometry(h: int, w: int, step: int, bin_size: int, num_scales: int, scale: int):
    """Frame-origin grids of one scale: origins from ``off`` while
    ``origin + 3b <= dim - 1``."""
    off = (1 + 2 * num_scales) - 3 * scale
    if off < 0:
        raise ValueError(
            f"scale={scale} with num_scales={num_scales} yields negative "
            f"grid origin {off}; use scales <= {(1 + 2 * num_scales) // 3}"
        )
    span = NUM_BIN_XY - 1  # bin centres at origin + {0,1,2,3}*b
    xs = np.arange(off, w - 1 - span * bin_size + 1, step)
    ys = np.arange(off, h - 1 - span * bin_size + 1, step)
    return ys, xs


def _f32_matmul(a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``a @ b`` summed in f32, stored in ``dtype``."""
    return torch.matmul(a.to(torch.float32), b.to(torch.float32)).to(dtype)


@node(meta_fields=("step_size", "bin_size", "scales", "scale_step", "compute_dtype"))
class SIFTExtractor(Transformer):
    """Batched dense SIFT: ``[N, H, W]`` (or ``[N, H, W, 1]``) grayscale in
    [0, 1] -> ``[N, 128, num_desc]`` quantised descriptors as f32.

    ``compute_dtype`` is the storage type of the large per-scale
    intermediates (the smoothed image, the [N, 8, H, W] orientation planes
    and the two banded-product results); the workloads pass bf16."""

    def __init__(
        self,
        step_size: int = 3,
        bin_size: int = 4,
        scales: int = 4,
        scale_step: int = 1,
        compute_dtype: torch.dtype = torch.float32,
    ):
        self.step_size = step_size
        self.bin_size = bin_size
        self.scales = scales
        self.scale_step = scale_step
        self.compute_dtype = compute_dtype

    def num_descriptors(self, h: int, w: int) -> int:
        total = 0
        for s in range(self.scales):
            b = self.bin_size + 2 * s
            step = self.step_size + s * self.scale_step
            ys, xs = _scale_geometry(h, w, step, b, self.scales, s)
            total += len(ys) * len(xs)
        return total

    def __call__(self, batch):
        if batch.ndim == 4:
            batch = batch[..., 0]
        n, h, w = batch.shape
        cdt = self.compute_dtype
        batch = batch.to(cdt)
        per_scale = []
        for s in range(self.scales):
            b = self.bin_size + 2 * s
            step = self.step_size + s * self.scale_step
            ys, xs = _scale_geometry(h, w, step, b, self.scales, s)
            if len(ys) == 0 or len(xs) == 0:
                continue
            gy, gx = _gradients(_smooth(batch, b / MAGNIF))
            planes = _orientation_planes(gy, gx).to(cdt)  # [N, 8, H, W]
            tri = _triangular_kernel(b)
            bin_off = np.arange(NUM_BIN_XY) * b
            yy = (ys[:, None] + bin_off[None, :]).ravel()  # [Fy*4]
            xx = (xs[:, None] + bin_off[None, :]).ravel()  # [Fx*4]
            s_y = _sampling_matrix(h, yy, tri, cdt, batch.device)
            s_x = _sampling_matrix(w, xx, tri, cdt, batch.device)
            part = _f32_matmul(s_y, planes, cdt)  # [N, 8, Fy*4, W]
            del planes
            sampled = _f32_matmul(part, s_x.T, cdt)  # [N, 8, Fy*4, Fx*4]
            del part
            fy, fx = len(ys), len(xs)
            sampled = sampled.reshape(n, NUM_BIN_T, fy, NUM_BIN_XY, fx, NUM_BIN_XY)
            # Descriptor dims ordered [by, bx, t]; frames y-major.
            per_scale.append(sampled.permute(0, 2, 4, 3, 5, 1).reshape(n, fy * fx, DESC_DIM))

        descs = torch.cat(per_scale, dim=1).to(torch.float32)  # [N, D, 128]
        del per_scale
        norms = torch.linalg.vector_norm(descs, dim=-1, keepdim=True)
        descs /= torch.clamp_min(norms, 1e-12)
        descs.clamp_(max=0.2)
        descs /= torch.clamp_min(torch.linalg.vector_norm(descs, dim=-1, keepdim=True), 1e-12)
        # Contrast threshold on the first (pre-normalisation) norm.
        descs.mul_((norms > CONTRAST_THRESHOLD).to(descs.dtype))
        descs.mul_(512.0).floor_().clamp_(max=255.0)
        return descs.transpose(1, 2).contiguous()  # [N, 128, D]
