"""Numeric helpers (counterpart of keystone_tpu/utils/stats.py)."""

from __future__ import annotations

import numpy as np
import torch


def about_eq(a, b, thresh: float = 1e-8) -> bool:
    """Tolerance comparison for scalars, vectors and matrices: elementwise
    ``|a - b| < thresh``; a shape mismatch raises."""
    a = np.asarray(a)
    b = np.asarray(b)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    return bool(np.all(np.abs(a - b) < thresh))


def classification_error(predicted, actual, k: int = 1) -> float:
    """Fraction of examples whose true label is NOT in the top-k prediction.
    ``predicted`` is [N, k] label indices (or [N] for k=1); ``actual`` [N]."""
    predicted = np.asarray(predicted)
    actual = np.asarray(actual)
    if predicted.ndim == 1:
        predicted = predicted[:, None]
    hits = (predicted[:, :k] == actual[:, None]).any(axis=1)
    return float(1.0 - hits.mean())


def get_err_percent(predicted, actual, k: int = 1) -> float:
    """:func:`classification_error` in percent."""
    return 100.0 * classification_error(predicted, actual, k)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The square root rounded once, to nearest, on every device.

    PyTorch's f32 ``torch.sqrt`` on the CPU is not correctly rounded (its
    vectorised kernels are one ulp off on a sixth of random inputs, under
    AVX2 and AVX512 alike), while XLA's CPU root and CUDA's ``sqrtf`` are.
    On the CPU the f64 root rounded to f32 is the correctly rounded one
    (53 ≥ 2·24 + 2 bits); on a CUDA tensor ``torch.sqrt`` already is.
    Narrower floats take the correctly rounded f32 root, then their own
    rounding, as XLA computes them; f64 is rooted as it is."""
    if x.dtype == torch.float64 or (x.is_cuda and x.dtype == torch.float32):
        return torch.sqrt(x)
    return torch.sqrt(x.double()).float().to(x.dtype)


#: Bytes of the ``[rows, K, m]`` products one :func:`matmul_rows` step holds.
_ROW_PRODUCT_BYTES = 1 << 30


def _sum_halving(p: torch.Tensor) -> torch.Tensor:
    """``p`` [n, K, m] with K a power of two, summed over K by halving in a
    fixed order: [n, m], each element's bits independent of ``n``."""
    while p.shape[1] > 1:
        h = p.shape[1] // 2
        p = p[:, :h] + p[:, h:]
    return p[:, 0]


def sum_rows(x: torch.Tensor) -> torch.Tensor:
    """``x.sum(-1)`` added pairwise in a fixed order, so each row's bits
    depend on neither the number of rows nor the device: a library
    reduction splits a long row across blocks or threads when there are
    few rows, and so sums it in another order."""
    lead, k = x.shape[:-1], x.shape[-1]
    if k == 0:
        return x.new_zeros(lead)
    flat = x.reshape(-1, k)
    width = 1 << max(0, (k - 1).bit_length())
    if width != k:
        flat = torch.nn.functional.pad(flat, (0, width - k))
    return _sum_halving(flat[:, :, None])[:, 0].reshape(lead)


def matmul_rows(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for ``x`` [n, K] and ``w`` [K, m], each output row's bits
    independent of ``n`` and of the row's position.

    A BLAS product picks its kernel, and so its summation order, by the
    row count: MKL's rows of ``[6, 256] @ [256, 20]`` differ from the same
    rows multiplied alone, and cuBLAS splits K by the row count. Here every
    row is summed the same way: the ``K`` products are formed elementwise
    and added pairwise, halving a zero-padded power-of-two ``K`` in a fixed
    order, in chunks of rows that bound the memory. Rows never mix, so the
    chunking does not move a bit."""
    n, k = x.shape
    m = w.shape[1]
    if n == 0 or k == 0:
        return x.new_zeros((n, m))
    width = 1 << (k - 1).bit_length()
    if width != k:
        x = torch.nn.functional.pad(x, (0, width - k))
        w = torch.nn.functional.pad(w, (0, 0, 0, width - k))
    step = max(1, _ROW_PRODUCT_BYTES // max(1, width * m * x.element_size()))
    outs = [_sum_halving(x[lo:lo + step, :, None] * w[None]) for lo in range(0, n, step)]
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def normalize_rows(mat: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    """Per row ``(x - mean) / sqrt(var + alpha)``, sample (n-1) variance."""
    mean = mat.mean(dim=1, keepdim=True)
    var = mat.var(dim=1, keepdim=True, correction=1)
    return (mat - mean) / sqrt_rn(var + alpha)

