"""Linear models and the least-squares estimator (counterpart of
keystone_tpu/solvers/linear.py)."""

from __future__ import annotations

from ..core.pipeline import LabelEstimator, Transformer, node
from ..ops.stats import StandardScaler, StandardScalerModel
from ..parallel.mesh import current_mesh, map_rows, mask_pad_rows, pad_shard_inputs
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


class LinearMapEstimator(LabelEstimator):
    """OLS / ridge by the normal equations: mean-center features and labels
    (mean-only scalers), solve, intercept = label mean."""

    def __init__(self, lam: float | None = None, mesh=None):
        self.lam = lam
        self.mesh = mesh

    def fit(self, features, labels, nvalid: int | None = None) -> LinearMapper:
        """``nvalid``: true row count when the inputs carry zero pad rows;
        centering turns pad rows into ``-mean``, so they are masked back to
        zero before the gram.

        With a mesh (given, or ambient through ``parallel.mesh.use_mesh``)
        the inputs are row-sharded, the scalers' moments and the grams
        reduce over the data axis in data order, and the solve splits the
        class columns over the model axis; the fitted mapper lives on slot
        (0, 0)'s device."""
        mesh = self.mesh if self.mesh is not None else current_mesh()
        if mesh is not None:
            (features, labels), nvalid = pad_shard_inputs(mesh, nvalid, features, labels)
        feature_scaler = StandardScaler(normalize_std_dev=False).fit(features, nvalid=nvalid)
        label_scaler = StandardScaler(normalize_std_dev=False).fit(labels, nvalid=nvalid)
        a = mask_pad_rows(map_rows(feature_scaler, features), nvalid)
        b = mask_pad_rows(map_rows(label_scaler, labels), nvalid)
        x = solve_least_squares(a, b, float(self.lam or 0.0), mesh=mesh)
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
