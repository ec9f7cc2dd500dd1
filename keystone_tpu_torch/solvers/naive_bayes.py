"""Multinomial naive Bayes (counterpart of keystone_tpu/solvers/naive_bayes.py,
single device; MLlib's semantics):

    pi[c]       = log(n_c + λ) − log(n + C·λ)
    theta[c, d] = log(count_{c,d} + λ) − log(Σ_d count_{c,d} + D·λ)
    score(x)    = pi + theta @ x

The fit aggregates per-class feature sums on the host in f64, in the JAX
package's order; ``pi`` and ``theta`` go to the device as f32.  Scoring runs
on the device: dense inputs as one product, CSR inputs as one gather of
``theta``'s columns times the values, then ``torch.segment_reduce`` over each
document's run of nonzeros.  Its kernel (CPU, and CUDA for rows wider than
one element) adds a segment's terms one after another in stored order, from
0, with no atomics.  So a document's score is the same bits whatever batch
it comes in, and the same bits on the card and on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.pipeline import LabelEstimator, Transformer
from ..ops.sparse import CSRFeatures
from ..utils.platform import resolve_device


class NaiveBayesModel(Transformer):
    """Log-posterior scores ``pi + theta @ x``: ``pi`` [C], ``theta`` [C, D]."""

    def __init__(self, pi, theta):
        self.pi = pi
        self.theta = theta
        self._columns = theta.T.contiguous()  # [D, C]: one row per feature

    def __call__(self, batch):
        if isinstance(batch, CSRFeatures):
            return self._apply_csr(batch)
        return batch @ self.theta.T + self.pi

    def _apply_csr(self, csr: CSRFeatures) -> torch.Tensor:
        dev = self.theta.device
        if len(csr) == 0:
            return torch.empty((0, self.theta.shape[0]), dtype=self.theta.dtype, device=dev)
        cols = torch.from_numpy(csr.indices.astype(np.int64)).to(dev)
        vals = torch.from_numpy(csr.values.astype(np.float32)).to(dev)
        lengths = torch.from_numpy(np.diff(csr.indptr.astype(np.int64))).to(dev)
        terms = self._columns[cols]
        terms.mul_(vals[:, None])
        return torch.segment_reduce(terms, "sum", lengths=lengths) + self.pi


class NaiveBayesEstimator(LabelEstimator):
    """Fit multinomial naive Bayes with additive smoothing ``lam``."""

    def __init__(self, num_classes: int, lam: float = 1.0, device="cuda"):
        self.num_classes = num_classes
        self.lam = lam
        self.device = resolve_device(device)

    def fit(self, features, labels) -> NaiveBayesModel:
        labels = np.asarray(labels)
        n = labels.shape[0]
        c = self.num_classes
        n_c = np.bincount(labels, minlength=c).astype(np.float64)

        if isinstance(features, CSRFeatures):
            d = features.num_features
            row_ids = np.repeat(np.arange(len(features)), np.diff(features.indptr))
            # One sequential f64 pass in nonzero order, as np.add.at sums.
            flat = labels[row_ids].astype(np.int64) * d + features.indices
            counts = np.bincount(
                flat, weights=features.values.astype(np.float64), minlength=c * d
            ).reshape(c, d)
        else:
            dense = np.asarray(features, np.float64)
            d = dense.shape[1]
            counts = np.zeros((c, d), np.float64)
            np.add.at(counts, labels, dense)

        lam = self.lam
        pi = np.log(n_c + lam) - np.log(n + c * lam)
        theta = np.log(counts + lam) - np.log(counts.sum(axis=1, keepdims=True) + d * lam)
        return NaiveBayesModel(
            torch.from_numpy(pi.astype(np.float32)).to(self.device),
            torch.from_numpy(theta.astype(np.float32)).to(self.device),
        )
