"""ZCA whitening (counterpart of keystone_tpu/solvers/whitening.py).

``V diag((s^2/(n-1) + 0.1)^-0.5) V^T`` from the SVD of the centered sample
matrix, in f32.  The 0.1 shrinkage is hard-coded as in the reference; ``eps``
is kept for API parity and unused.  A sample matrix with a NaN or an Inf is
refused with a counted ``FloatingPointError`` (``nonfinite_model``), the
typed error the JAX package raises once its SVD's NaNs reach the fitted
model; ``torch.linalg.svd`` would raise an untyped ``LinAlgError`` instead.
"""

from __future__ import annotations

import torch

from ..core.pipeline import Estimator, Transformer, node
from ..core.resilience import assert_all_finite


@node(data_fields=("whitener", "means"))
class ZCAWhitener(Transformer):
    """Apply ``(x - means) @ whitener``."""

    def __init__(self, whitener, means):
        self.whitener = whitener
        self.means = means

    def __call__(self, batch):
        return (batch - self.means) @ self.whitener


class ZCAWhitenerEstimator(Estimator):
    def __init__(self, eps: float = 1e-12):
        self.eps = eps

    def fit(self, data) -> ZCAWhitener:
        return self.fit_single(data)

    def fit_single(self, mat: torch.Tensor) -> ZCAWhitener:
        means = mat.mean(dim=0)
        centered = assert_all_finite((mat - means).to(torch.float32),
                                     "ZCA whitener sample matrix")
        n, d = centered.shape
        # Full V^T when n < d: the null-space directions (s = 0) still get
        # the 0.1 shrinkage, i.e. a 0.1^-0.5 gain.
        _, s, vt = torch.linalg.svd(centered, full_matrices=n < d)
        s2 = torch.zeros(d, dtype=s.dtype, device=s.device)
        s2[: s.shape[0]] = (s * s) / (n - 1.0)
        scale = (s2 + 0.1) ** -0.5
        whitener = (vt.T * scale) @ vt
        return ZCAWhitener(whitener.to(mat.dtype), means)
