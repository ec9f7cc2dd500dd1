"""Fused symmetric-rectify + sum-pool (counterpart of
keystone_tpu/ops/rect_pool_pallas.py::rect_pool_pallas).

:func:`rect_pool` maps ``z [N, oh, ow, F]`` (bf16 or f32, NHWC) to
``[N, npools*2F]`` f32 features in the unfused element order: position-major,
then the pos block ``max(max_val, z - alpha)``, then the neg block
``max(max_val, -z - alpha)``, each summed over its Pooler window.

:func:`conv_rect_pool` takes the Convolver's raw terms instead of ``z`` and
computes each activation in the kernel (the Convolver's epilogue, then the
rounding to ``activation_dtype``), so neither the f32 activations nor their
bf16 copy is ever written: it is what ``FusedConvFeaturizer`` runs.

On a CUDA tensor each launches its entry of the hand-written kernel
``csrc/rect_pool.cu`` (or raises); on a CPU tensor each runs its plain
PyTorch version (:func:`rect_pool_reference`,
:func:`conv_rect_pool_reference`), which the tests and ``chip_smoke.py``
hold the kernel against.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import _build
from .images import convolver_epilogue

#: Kernel launches made by :func:`rect_pool` (never by the plain version).
launches = 0
#: Kernel launches made by :func:`conv_rect_pool` (never by the plain version).
fused_launches = 0

_SIGNATURES = {
    "rect_pool_launch": (
        ctypes.c_int,
        [
            ctypes.c_void_p, ctypes.c_void_p,  # z, out
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # n oh ow f
            ctypes.c_int, ctypes.c_int,  # stride, pool_size
            ctypes.c_float, ctypes.c_float,  # alpha, max_val
            ctypes.c_int, ctypes.c_void_p,  # dtype, stream
        ],
    ),
    "conv_rect_pool_launch": (
        ctypes.c_int,
        [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # conv, mu, sigma
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # fsum, fmd, out
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # n oh ow f
            ctypes.c_int, ctypes.c_int,  # stride, pool_size
            ctypes.c_float, ctypes.c_float,  # alpha, max_val
            ctypes.c_int, ctypes.c_void_p,  # round_bf16, stream
        ],
    ),
}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def num_pools(dim: int, stride: int, pool_size: int) -> int:
    return math.ceil((dim - pool_size // 2) / stride)


def windows(dim: int, stride: int, pool_size: int) -> list[tuple[int, int]]:
    """(start, length) per pool position along one axis (truncated high edge)."""
    half = pool_size // 2
    span = 2 * half if pool_size % 2 == 1 else pool_size
    return [
        (p * stride, min(p * stride + span, dim) - p * stride)
        for p in range(num_pools(dim, stride, pool_size))
    ]


def rect_pool_reference(
    z: torch.Tensor,
    *,
    pool_stride: int,
    pool_size: int,
    alpha: float = 0.0,
    max_val: float = 0.0,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel (f32 accumulation)."""
    _, oh, ow, _ = z.shape
    zf = z.to(torch.float32)
    pos = torch.clamp_min(zf - alpha, max_val)
    neg = torch.clamp_min(-zf - alpha, max_val)
    outs = []
    for y0, ylen in windows(oh, pool_stride, pool_size):
        for x0, xlen in windows(ow, pool_stride, pool_size):
            for t in (pos, neg):
                outs.append(t[:, y0 : y0 + ylen, x0 : x0 + xlen].sum(dim=(1, 2)))
    return torch.cat(outs, dim=1)


def _pooled_shape(n, oh, ow, f, pool_stride, pool_size, name):
    npools = num_pools(oh, pool_stride, pool_size) * num_pools(
        ow, pool_stride, pool_size
    )
    if n == 0 or f == 0 or npools <= 0:
        raise ValueError(f"{name}: empty problem [{n}, {oh}, {ow}, {f}], npools={npools}")
    return (n, npools * 2 * f)


def rect_pool(
    z: torch.Tensor,
    *,
    pool_stride: int,
    pool_size: int,
    alpha: float = 0.0,
    max_val: float = 0.0,
) -> torch.Tensor:
    """[N, oh, ow, F] activations -> [N, npools*2F] pooled features."""
    if z.device.type == "cpu":
        return rect_pool_reference(
            z, pool_stride=pool_stride, pool_size=pool_size, alpha=alpha,
            max_val=max_val,
        )
    if z.device.type != "cuda":
        raise ValueError(f"rect_pool: unsupported device {z.device}")
    if z.dim() != 4:
        raise ValueError(f"rect_pool: expected [N, oh, ow, F], got {tuple(z.shape)}")
    if z.dtype not in _DTYPE_CODES:
        raise TypeError(f"rect_pool: dtype {z.dtype} not in (float32, bfloat16)")
    if not z.is_contiguous():
        raise ValueError("rect_pool: z must be contiguous NHWC memory")
    n, oh, ow, f = z.shape
    shape = _pooled_shape(n, oh, ow, f, pool_stride, pool_size, "rect_pool")
    out = torch.empty(shape, dtype=torch.float32, device=z.device)
    lib = _build.load("rect_pool", _SIGNATURES)
    stream = torch.cuda.current_stream(z.device).cuda_stream
    rc = lib.rect_pool_launch(
        z.data_ptr(), out.data_ptr(), n, oh, ow, f, pool_stride, pool_size,
        alpha, max_val, _DTYPE_CODES[z.dtype], stream,
    )
    if rc != 0:
        raise RuntimeError(f"rect_pool kernel launch failed: cudaError {rc}")
    global launches
    launches += 1
    return out


def conv_rect_pool_reference(
    conv_fp: torch.Tensor,
    mu: torch.Tensor | None,
    sigma: torch.Tensor | None,
    fsum: torch.Tensor,
    filter_means_dot: torch.Tensor | None,
    *,
    pool_stride: int,
    pool_size: int,
    alpha: float = 0.0,
    max_val: float = 0.0,
    activation_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Plain PyTorch version of the fused entry: the Convolver's epilogue,
    the cast to ``activation_dtype``, then :func:`rect_pool_reference`."""
    z = convolver_epilogue(conv_fp, mu, sigma, fsum, filter_means_dot)
    return rect_pool_reference(
        z.to(activation_dtype), pool_stride=pool_stride, pool_size=pool_size,
        alpha=alpha, max_val=max_val,
    )


def _check_term(name, t, shape, device):
    if t.device != device:
        raise ValueError(f"conv_rect_pool: {name} is on {t.device}, conv_fp on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"conv_rect_pool: {name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"conv_rect_pool: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"conv_rect_pool: {name} must be contiguous")


def conv_rect_pool(
    conv_fp: torch.Tensor,
    mu: torch.Tensor | None,
    sigma: torch.Tensor | None,
    fsum: torch.Tensor,
    filter_means_dot: torch.Tensor | None,
    *,
    pool_stride: int,
    pool_size: int,
    alpha: float = 0.0,
    max_val: float = 0.0,
    activation_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """The Convolver's terms (``conv_fp`` [N, oh, ow, F] f32, ``mu`` and
    ``sigma`` [N, oh, ow] or both None, ``fsum`` and ``filter_means_dot`` [F]
    or the latter None) -> [N, npools*2F] pooled features of the activations
    rounded to ``activation_dtype``.  Nothing is copied: a term that is not
    contiguous f32 of its shape on ``conv_fp``'s device raises."""
    kw = dict(pool_stride=pool_stride, pool_size=pool_size, alpha=alpha, max_val=max_val)
    if conv_fp.device.type == "cpu":
        return conv_rect_pool_reference(
            conv_fp, mu, sigma, fsum, filter_means_dot,
            activation_dtype=activation_dtype, **kw,
        )
    if conv_fp.device.type != "cuda":
        raise ValueError(f"conv_rect_pool: unsupported device {conv_fp.device}")
    if conv_fp.dim() != 4:
        raise ValueError(f"conv_rect_pool: expected conv_fp [N, oh, ow, F], got {tuple(conv_fp.shape)}")
    if activation_dtype not in _DTYPE_CODES:
        raise TypeError(f"conv_rect_pool: activation dtype {activation_dtype} not in (float32, bfloat16)")
    if (mu is None) != (sigma is None):
        raise ValueError("conv_rect_pool: mu and sigma come together")
    n, oh, ow, f = conv_fp.shape
    dev = conv_fp.device
    _check_term("conv_fp", conv_fp, conv_fp.shape, dev)
    if mu is not None:
        _check_term("mu", mu, (n, oh, ow), dev)
        _check_term("sigma", sigma, (n, oh, ow), dev)
        _check_term("fsum", fsum, (f,), dev)
    if filter_means_dot is not None:
        _check_term("filter_means_dot", filter_means_dot, (f,), dev)
    shape = _pooled_shape(n, oh, ow, f, pool_stride, pool_size, "conv_rect_pool")
    out = torch.empty(shape, dtype=torch.float32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _build.load("rect_pool", _SIGNATURES)
    rc = lib.conv_rect_pool_launch(
        conv_fp.data_ptr(), ptr(mu), ptr(sigma), ptr(fsum if mu is not None else None),
        ptr(filter_means_dot), out.data_ptr(), n, oh, ow, f, pool_stride, pool_size,
        alpha, max_val, int(activation_dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"conv_rect_pool kernel launch failed: cudaError {rc}")
    global fused_launches
    fused_launches += 1
    return out
