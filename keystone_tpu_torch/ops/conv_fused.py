"""Fused conv -> rectify -> pool featurizer with compact activations
(counterpart of keystone_tpu/ops/conv_fused.py).

The normalized conv activations are rounded to ``activation_dtype`` (bf16 by
default, f32 exact) and both pooled signs come from one pass of the fused
rect+pool kernel (:func:`.rect_pool.conv_rect_pool`), which computes each
activation from the Convolver's raw terms: neither the activations nor the
[oh, ow, 2F] rectified tensor is ever written.  The convolutions themselves
are cuDNN's, in full f32.
"""

from __future__ import annotations

import torch

from ..core.pipeline import Transformer, node
from .images import Convolver
from .rect_pool import conv_rect_pool, conv_rect_pool_cost, num_pools


@node(
    data_fields=("conv",),
    meta_fields=("alpha", "max_val", "pool_stride", "pool_size", "activation_dtype"),
)
class FusedConvFeaturizer(Transformer):
    """Convolver -> SymmetricRectifier -> Pooler('sum') -> ImageVectorizer.

    Construction mirrors :class:`~.images.Convolver` plus the rectifier and
    pooler parameters; ``__call__`` maps [N, H, W, C] images to the
    [N, npy*npx*2F] features of the unfused chain, element order identical.
    """

    def __init__(
        self,
        filters,
        whitener_means=None,
        *,
        pool_stride: int,
        pool_size: int,
        alpha: float = 0.0,
        max_val: float = 0.0,
        normalize_patches: bool = True,
        var_constant: float = 10.0,
        img_channels: int | None = None,
        activation_dtype: torch.dtype = torch.bfloat16,
        device="cuda",
    ):
        self.conv = Convolver(
            filters,
            whitener_means=whitener_means,
            normalize_patches=normalize_patches,
            var_constant=var_constant,
            img_channels=img_channels,
            device=device,
        )
        self.alpha = alpha
        self.max_val = max_val
        self.pool_stride = pool_stride
        self.pool_size = pool_size
        self.activation_dtype = activation_dtype

    @property
    def device(self) -> torch.device:
        return self.conv.device

    def launch_cost(self, shape) -> tuple[float, float]:
        """(flops, bytes) of the fused kernel's launch on [N, H, W, C]
        images of ``shape`` (``rect_pool.conv_rect_pool_cost``)."""
        n, h, w, _ = shape
        f, ws = self.conv.filters.shape[0], self.conv.conv_size
        oh, ow = h - ws + 1, w - ws + 1
        npools = (num_pools(oh, self.pool_stride, self.pool_size)
                  * num_pools(ow, self.pool_stride, self.pool_size))
        return conv_rect_pool_cost(
            n, oh, ow, f, n * npools * 2 * f,
            normalize=self.conv.normalize_patches,
            means=self.conv.filter_means_dot is not None,
        )

    def __call__(self, batch):
        conv = self.conv
        return conv_rect_pool(
            *conv.terms(batch), conv.fsum, conv.filter_means_dot,
            pool_stride=self.pool_stride, pool_size=self.pool_size,
            alpha=self.alpha, max_val=self.max_val,
            activation_dtype=self.activation_dtype,
        )
