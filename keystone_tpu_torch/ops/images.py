"""Image operator nodes (counterpart of keystone_tpu/ops/images.py).

A batch of images is a ``float32[N, H, W, C]`` tensor at every public API,
as in the JAX package.  Inside the convolutions the same memory is viewed as
``[N, C, H, W]`` in ``torch.channels_last`` format, so cuDNN reads and writes
NHWC memory directly and no permute copy is made on either side.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F

from ..core.pipeline import FunctionNode, Transformer
from ..utils.platform import resolve_device


class ImageVectorizer(Transformer):
    """Flatten [N,H,W,C] -> [N, H*W*C] (row-major, channel fastest)."""

    def __call__(self, batch):
        return batch.reshape(batch.shape[0], -1)


class SymmetricRectifier(Transformer):
    """Two-sided ReLU; channels double: ``[max(v, x-a), max(v, -x-a)]``."""

    def __init__(self, max_val: float = 0.0, alpha: float = 0.0):
        self.max_val = max_val
        self.alpha = alpha

    def __call__(self, batch):
        pos = torch.clamp_min(batch - self.alpha, self.max_val)
        neg = torch.clamp_min(-batch - self.alpha, self.max_val)
        return torch.cat([pos, neg], dim=-1)


class Windower(FunctionNode):
    """All strided square patches of each image: [N,H,W,C] ->
    [N * nWin, ws, ws, C], x (column) outer and y (row) inner."""

    def __init__(self, stride: int, window_size: int):
        self.stride = stride
        self.window_size = window_size

    def __call__(self, batch):
        n, _, _, c = batch.shape
        ws, st = self.window_size, self.stride
        # [N, ny, nx, C, ws(y), ws(x)] -> [N, nx, ny, ws(y), ws(x), C]
        wins = batch.unfold(1, ws, st).unfold(2, ws, st)
        wins = wins.permute(0, 2, 1, 4, 5, 3)
        return wins.reshape(-1, ws, ws, c)


class Pooler(Transformer):
    """Strided pooling over square regions.

    Windows start at ``p * stride`` and span ``ps`` pixels (even ``ps``) or
    ``2 * (ps // 2)`` (odd ``ps``), truncated at the high edge, where the
    truncated part counts as zeros.  ``'mean'`` divides by ``ps**2`` and
    ``'max'`` sees those zeros, like the reference's zero-filled pool buffer.
    """

    def __init__(
        self,
        stride: int,
        pool_size: int,
        pixel_function: Callable | None = None,
        pool_function: str = "sum",
    ):
        if pool_function not in ("sum", "mean", "max"):
            raise ValueError("pool_function must be 'sum', 'mean' or 'max'")
        self.stride = stride
        self.pool_size = pool_size
        self.pixel_function = pixel_function
        self.pool_function = pool_function

    def _num_pools(self, dim: int) -> int:
        return math.ceil((dim - self.pool_size // 2) / self.stride)

    def __call__(self, batch):
        _, h, w, _ = batch.shape
        ps, st = self.pool_size, self.stride
        half = ps // 2
        np_x = self._num_pools(w)
        np_y = self._num_pools(h)
        x = batch if self.pixel_function is None else self.pixel_function(batch)
        span = 2 * half if ps % 2 == 1 else ps
        pad_h = max(0, (np_y - 1) * st + span - h)
        pad_w = max(0, (np_x - 1) * st + span - w)
        x = F.pad(x.permute(0, 3, 1, 2), (0, pad_w, 0, pad_h))
        if self.pool_function == "max":
            pooled = F.max_pool2d(x, span, st)
        else:
            pooled = F.avg_pool2d(x, span, st, divisor_override=1)
        pooled = pooled[:, :, :np_y, :np_x].permute(0, 2, 3, 1)
        if self.pool_function == "mean":
            pooled = pooled / float(ps * ps)
        elif self.pool_function == "max" and span < ps:
            # Odd ps: the reference's ps^2 pool buffer is never fully
            # overwritten, so its max always sees zeros.
            pooled = torch.clamp_min(pooled, 0.0)
        return pooled


def convolver_epilogue(conv_fp, mu, sigma, fsum, filter_means_dot):
    """The Convolver's per-element epilogue on its raw terms:
    ``((conv_fp - mu*fsum) / sigma) - filter_means_dot``, each step one
    rounded f32 op in this order.  ``mu``/``sigma`` are [N, oh, ow] (both
    None without patch normalisation); ``fsum`` and ``filter_means_dot`` are
    [F] (the latter None without whitener means)."""
    out = conv_fp
    if mu is not None:
        out = (out - mu[..., None] * fsum) / sigma[..., None]
    if filter_means_dot is not None:
        out = out - filter_means_dot
    return out


class Convolver(Transformer):
    """Convolve a filter bank over images with optional per-patch
    normalization.

    For a patch ``p`` of ``d = ws*ws*C`` elements, the normalized patch is
    ``(p - mu)/sigma - m`` with ``mu = sum(p)/d`` and
    ``sigma = sqrt((sum(p^2) - d*mu^2)/(d-1) + var_constant)``, so for a
    filter ``f``:  ``f.p' = (f.p - mu*sum(f)) / sigma - f.m``.  ``f.p`` is one
    convolution with the bank; ``sum(p)`` and ``sum(p^2)`` are box filters
    over the image and its square.

    ``filters``: [F, ws, ws, C] (HWC patch layout) or [F, ws*ws*C] flat.
    ``__call__`` maps [N, H, W, C] to [N, oh, ow, F], contiguous in NHWC: it
    is :func:`convolver_epilogue` applied to :meth:`terms`.
    """

    def __init__(
        self,
        filters,
        whitener_means=None,
        normalize_patches: bool = True,
        var_constant: float = 10.0,
        img_channels: int | None = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        filters = torch.as_tensor(filters, dtype=torch.float32, device=self.device)
        if filters.ndim == 2:
            if img_channels is None:
                raise ValueError("img_channels required for flat filters")
            ws = int(math.isqrt(filters.shape[1] // img_channels))
            filters = filters.reshape(filters.shape[0], ws, ws, img_channels)
        self.filters = filters
        self.normalize_patches = normalize_patches
        self.var_constant = var_constant
        self.whitener_means = (
            None
            if whitener_means is None
            else torch.as_tensor(
                whitener_means, dtype=torch.float32, device=self.device
            )
        )
        if self.whitener_means is not None:
            flat = filters.reshape(filters.shape[0], -1)
            self.filter_means_dot = flat @ self.whitener_means
        else:
            self.filter_means_dot = None
        # [F, C, ws, ws] weights over channels_last memory (= the HWC filters).
        cl = torch.channels_last
        self._weight = filters.permute(0, 3, 1, 2).contiguous(memory_format=cl)
        _, ws, _, c = filters.shape
        self._ones = torch.ones(
            (1, c, ws, ws), dtype=torch.float32, device=self.device
        ).contiguous(memory_format=cl)
        #: [F] sum of each filter's weights (the epilogue's ``fsum``).
        self.fsum = filters.sum(dim=(1, 2, 3))

    @property
    def conv_size(self) -> int:
        return self.filters.shape[1]

    def _images(self, batch):
        """[N, H, W, C] images as the [N, C, H, W] channels_last view."""
        c = self.filters.shape[3]
        batch = torch.as_tensor(batch, dtype=torch.float32, device=self.device)
        if batch.shape[-1] != c:
            raise ValueError(
                f"image channels {batch.shape[-1]} != filter channels {c}"
            )
        return batch.contiguous().permute(0, 3, 1, 2)

    def patch_stats(self, x):
        """Per-pixel patch mean and deviation ``(mu, sigma)``, each
        [N, oh, ow], of the channels_last view ``x`` (:meth:`_images`)."""
        _, ws, _, c = self.filters.shape
        d = ws * ws * c
        psum = F.conv2d(x, self._ones)[:, 0]
        psumsq = F.conv2d(x * x, self._ones)[:, 0]
        mu = psum / d
        var = (psumsq - d * mu * mu) / (d - 1.0)
        return mu, torch.sqrt(var + self.var_constant)

    def terms(self, batch):
        """The raw terms of the epilogue: ``(conv_fp, mu, sigma)``, with
        ``conv_fp`` [N, oh, ow, F] contiguous (cuDNN's channels_last output)
        and ``mu``/``sigma`` [N, oh, ow], or None without patch
        normalisation."""
        x = self._images(batch)
        conv_fp = F.conv2d(x, self._weight).permute(0, 2, 3, 1)
        if not self.normalize_patches:
            return conv_fp, None, None
        return (conv_fp, *self.patch_stats(x))

    def __call__(self, batch):
        return convolver_epilogue(
            *self.terms(batch), self.fsum, self.filter_means_dot
        )


class PixelScaler(Transformer):
    """Rescale [0..255] -> [0..1]."""

    def __call__(self, batch):
        return batch / 255.0


class GrayScaler(Transformer):
    """NTSC grayscale.  3-channel input is BGR:
    ``0.2989*R + 0.5870*G + 0.1140*B``; any other channel count takes the
    root of the mean of squares.  Output keeps a trailing singleton channel.

    The weighted sum is elementwise, not a contraction: a matrix-vector
    product's kernel (and so its rounding) can change with the batch size,
    and one ulp here can flip a bf16 rounding in SIFT downstream."""

    def __call__(self, batch):
        if batch.shape[-1] == 3:
            out = batch[..., 0] * 0.1140 + batch[..., 1] * 0.5870 + batch[..., 2] * 0.2989
        else:
            out = torch.sqrt(torch.mean(batch * batch, dim=-1))
        return out[..., None]


class ImageExtractor(Transformer):
    """Labelled image batch -> its images."""

    def __call__(self, labeled):
        return labeled.images


class LabelExtractor(Transformer):
    """Labelled image batch -> its labels."""

    def __call__(self, labeled):
        return labeled.labels


MultiLabelExtractor = LabelExtractor
MultiLabeledImageExtractor = ImageExtractor
