"""Linear models and the least-squares estimator (counterpart of
keystone_tpu/solvers/linear.py, single device)."""

from __future__ import annotations

import torch

from ..core.pipeline import LabelEstimator, Transformer, node
from ..ops.stats import StandardScaler, StandardScalerModel
from .normal_equations import solve_least_squares


@node(data_fields=("x", "b", "feature_scaler"))
class LinearMapper(Transformer):
    """``out = scale(in) @ x + b``; ``x`` is [d, k]."""

    def __init__(self, x, b=None, feature_scaler: StandardScalerModel | None = None):
        self.x = x
        self.b = b
        self.feature_scaler = feature_scaler

    def __call__(self, batch):
        if self.feature_scaler is not None:
            batch = self.feature_scaler(batch)
        out = batch @ self.x
        if self.b is not None:
            out = out + self.b
        return out


def _mask_pad_rows(x: torch.Tensor, nvalid: int | None) -> torch.Tensor:
    """Zero the rows at index >= ``nvalid``."""
    if nvalid is None or x.shape[0] == nvalid:
        return x
    mask = (torch.arange(x.shape[0], device=x.device) < nvalid).to(x.dtype)
    return x * mask.reshape((-1,) + (1,) * (x.ndim - 1))


class LinearMapEstimator(LabelEstimator):
    """OLS / ridge by the normal equations: mean-center features and labels
    (mean-only scalers), solve, intercept = label mean."""

    def __init__(self, lam: float | None = None):
        self.lam = lam

    def fit(self, features, labels, nvalid: int | None = None) -> LinearMapper:
        """``nvalid``: true row count when the inputs carry zero pad rows;
        centering turns pad rows into ``-mean``, so they are masked back to
        zero before the gram."""
        feature_scaler = StandardScaler(normalize_std_dev=False).fit(features, nvalid=nvalid)
        label_scaler = StandardScaler(normalize_std_dev=False).fit(labels, nvalid=nvalid)
        a = _mask_pad_rows(feature_scaler(features), nvalid)
        b = _mask_pad_rows(label_scaler(labels), nvalid)
        x = solve_least_squares(a, b, float(self.lam or 0.0))
        return LinearMapper(x, label_scaler.mean, feature_scaler)


@node(data_fields=("weights", "intercept"))
class LeastSquaresModel(Transformer):
    """Bare ``X @ W + b`` head."""

    def __init__(self, weights, intercept=None):
        self.weights = weights
        self.intercept = intercept

    def __call__(self, batch):
        out = batch @ self.weights
        if self.intercept is not None:
            out = out + self.intercept
        return out
