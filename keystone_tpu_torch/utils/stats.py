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


def normalize_rows(mat: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    """Per row ``(x - mean) / sqrt(var + alpha)``, sample (n-1) variance."""
    mean = mat.mean(dim=1, keepdim=True)
    var = mat.var(dim=1, keepdim=True, correction=1)
    return (mat - mean) / torch.sqrt(var + alpha)


def check_finite(name: str, *tensors: torch.Tensor) -> None:
    """Raise ``FloatingPointError`` if any of ``tensors`` holds a NaN or an
    Inf: a diverged fit must not look like a model."""
    if not all(bool(torch.isfinite(t).all()) for t in tensors):
        raise FloatingPointError(f"{name} has non-finite values")
