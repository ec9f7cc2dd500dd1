"""Numeric helpers (counterpart of keystone_tpu/utils/stats.py)."""

from __future__ import annotations

import numpy as np
import torch


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
    """The f32 square root rounded once, to nearest, on every device.
    PyTorch's f32 ``torch.sqrt`` is not correctly rounded everywhere (its
    AVX512 CPU kernels are one ulp off on a small share of inputs), so the
    card and the CPU can disagree; the f64 root rounded to f32 is the
    correctly rounded one (53 ≥ 2·24 + 2 bits) on both."""
    return torch.sqrt(x.double()).float()


def normalize_rows(mat: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    """Per row ``(x - mean) / sqrt(var + alpha)``, sample (n-1) variance."""
    mean = mat.mean(dim=1, keepdim=True)
    var = mat.var(dim=1, keepdim=True, correction=1)
    return (mat - mean) / torch.sqrt(var + alpha)

