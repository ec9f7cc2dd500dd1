"""Gaussian mixture model with diagonal covariances, fit by EM (counterpart
of keystone_tpu/solvers/gmm.py).

``means`` and ``variances`` are [d, k] (one column per component),
``weights`` [k].  The E-step is chunked over samples so the [n, k]
posteriors never exceed one chunk.  The EM loop is a Python loop with the
JAX package's convergence test, ``|llh - prev| >= tol * max(1, |llh|)``,
starting from the sentinels llh = +inf, prev = -inf.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.pipeline import Estimator, Transformer, node
from ..utils.platform import resolve_device


@node(data_fields=("means", "variances", "weights"))
class GaussianMixtureModel(Transformer):
    """Diagonal-covariance GMM; ``__call__`` returns the posteriors."""

    def __init__(self, means, variances, weights):
        if means.shape != variances.shape:
            raise ValueError("GMM means and variances must be the same size.")
        if weights.shape[0] != means.shape[1]:
            raise ValueError("Every GMM center must have a weight.")
        self.means = means
        self.variances = variances
        self.weights = weights

    @property
    def k(self) -> int:
        return self.means.shape[1]

    @property
    def dim(self) -> int:
        return self.means.shape[0]

    def log_responsibilities(self, x):
        """[n, d] -> [n, k] log posteriors under the mixture (unnormalised)."""
        return _log_resp(x, self.means, self.variances, self.weights)

    def __call__(self, batch):
        return torch.softmax(self.log_responsibilities(batch), dim=-1)

    @staticmethod
    def load(mean_file: str, vars_file: str, weights_file: str, device="cuda") -> "GaussianMixtureModel":
        """Read the model from three CSV files (means and variances [d, k],
        weights one row)."""
        dev = resolve_device(device)

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        means = np.loadtxt(mean_file, delimiter=",", ndmin=2)
        variances = np.loadtxt(vars_file, delimiter=",", ndmin=2)
        weights = np.loadtxt(weights_file, delimiter=",").ravel()
        return GaussianMixtureModel(t(means), t(variances), t(weights))


def _log_resp(x, means, variances, weights):
    # log N(x; mu_k, diag sigma2_k) + log pi_k, one product per moment.
    inv_var = 1.0 / variances  # [d, k]
    quad = (x * x) @ inv_var - 2.0 * (x @ (means * inv_var)) + torch.sum(
        means * means * inv_var, dim=0
    )
    log_det = torch.sum(torch.log(variances), dim=0)
    log_pdf = -0.5 * (quad + log_det + x.shape[1] * math.log(2.0 * math.pi))
    return log_pdf + torch.log(weights)


def _e_stats(x, means, variances, weights):
    """Sufficient statistics (s0, s1, s2, sum of log-norms) of one chunk."""
    logr = _log_resp(x, means, variances, weights)
    log_norm = torch.logsumexp(logr, dim=1, keepdim=True)
    q = torch.exp(logr - log_norm)  # [n, k]
    return q.sum(dim=0), x.T @ q, (x * x).T @ q, log_norm.sum()


def _em_step(x, means, variances, weights, var_floor, chunk: int):
    """One EM iteration; returns (means, variances, weights, mean llh)."""
    n = x.shape[0]
    s0 = s1 = s2 = llh_sum = 0.0
    for i in range(0, n, chunk):
        c0, c1, c2, cl = _e_stats(x[i : i + chunk], means, variances, weights)
        s0, s1, s2, llh_sum = s0 + c0, s1 + c1, s2 + c2, llh_sum + cl
    # Floor the responsibility mass: an empty component would give 0/0.
    s0_safe = torch.clamp_min(s0, 1e-10)
    new_means = s1 / s0_safe
    new_vars = torch.maximum(s2 / s0_safe - new_means * new_means, var_floor)
    return new_means, new_vars, s0 / n, llh_sum / n


class GaussianMixtureModelEstimator(Estimator):
    """Fit a ``k``-component GMM by EM.  The initial means are ``k`` distinct
    samples drawn by ``np.random.default_rng(seed)``, as in the JAX package,
    so both start from the same means on the same samples."""

    def __init__(
        self,
        k: int,
        max_iter: int = 100,
        tol: float = 1e-4,
        seed: int = 42,
        var_floor_factor: float = 1e-3,
        chunk: int = 1 << 18,
    ):
        self.k = k
        self.max_iter = max_iter
        self.tol = tol
        self.seed = seed
        self.var_floor_factor = var_floor_factor
        self.chunk = chunk
        self.last_iterations = 0

    def fit(self, samples) -> GaussianMixtureModel:
        x = samples.to(torch.float32)
        n, d = x.shape
        if n < self.k:
            raise ValueError(f"need at least k={self.k} samples, got {n}")
        idx = np.random.default_rng(self.seed).choice(n, self.k, replace=False)
        means = x[torch.as_tensor(idx, device=x.device)].T.contiguous()  # [d, k]
        global_var = torch.var(x, dim=0, unbiased=False)[:, None]  # [d, 1]
        variances = global_var.expand(d, self.k).contiguous()
        weights = torch.full((self.k,), 1.0 / self.k, dtype=x.dtype, device=x.device)
        var_floor = self.var_floor_factor * global_var.mean()

        # The test runs in f32, as the JAX package's device-side loop does;
        # with tol = 0 the first test is inf >= 0 * inf = NaN, which is false
        # there too, so no iteration runs.
        tol = np.float32(self.tol)
        iters, llh, prev = 0, np.float32(np.inf), np.float32(-np.inf)
        with np.errstate(invalid="ignore"):
            while iters < self.max_iter and abs(llh - prev) >= tol * max(
                np.float32(1.0), abs(llh)
            ):
                means, variances, weights, step_llh = _em_step(
                    x, means, variances, weights, var_floor, self.chunk
                )
                prev, llh = llh, np.float32(step_llh.item())
                iters += 1
        self.last_iterations = iters
        return GaussianMixtureModel(means, variances, weights)
