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

Under a mesh with more than one data slot (``parallel.mesh.use_mesh``) CSR
scoring is data-parallel: each data slot takes one contiguous group of
documents and scores its own nonzeros against ``theta`` replicated on the
slot, with no reduction across slots; the groups' scores are concatenated
in data order on slot (0, 0)'s device.  Each document's terms are summed as
on one device, so the scores are the same bits.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.pipeline import LabelEstimator, Transformer, node
from ..ops.sparse import CSRFeatures
from ..parallel.mesh import DATA_AXIS, current_mesh, on_slot, require_local
from ..utils.platform import device_scope, resolve_device


@node(data_fields=("pi", "theta"))
class NaiveBayesModel(Transformer):
    """Log-posterior scores ``pi + theta @ x``: ``pi`` [C], ``theta`` [C, D]."""

    def __init__(self, pi, theta):
        self.pi = pi
        self.theta = theta
        self._restore()

    def _restore(self) -> None:
        """The state derived from ``theta`` (a checkpoint load sets the
        fields without ``__init__`` and calls this)."""
        self._columns = self.theta.T.contiguous()  # [D, C]: one row per feature

    def __call__(self, batch):
        if isinstance(batch, CSRFeatures):
            mesh = current_mesh()
            if mesh is not None and mesh.shape[DATA_AXIS] > 1:
                require_local(mesh, "NaiveBayesModel scoring")
                return self._apply_csr_mesh(batch, mesh)
            return self._apply_csr(batch)
        return batch @ self.theta.T + self.pi

    def _apply_csr(self, csr: CSRFeatures) -> torch.Tensor:
        return _csr_scores(csr.indptr, csr.indices, csr.values, self._columns, self.pi)

    def _apply_csr_mesh(self, csr: CSRFeatures, mesh) -> torch.Tensor:
        """Data slot ``j`` scores documents ``[j·r, (j+1)·r)``, ``r =
        ceil(n / data)``, on its device and inside its scope; the scores
        come back in data order on slot (0, 0)'s device."""
        k, n = mesh.shape[DATA_AXIS], len(csr)
        rows_per = -(-n // k)
        head = mesh.devices[0, 0]
        indptr = csr.indptr.astype(np.int64)
        replicas: dict = {}
        parts = []
        for j in range(k):
            r0, r1 = min(j * rows_per, n), min((j + 1) * rows_per, n)
            if r0 == r1 and parts:
                continue
            dev = mesh.devices[j, 0]
            if dev not in replicas:
                replicas[dev] = (on_slot(self._columns, dev), on_slot(self.pi, dev))
            lo, hi = int(indptr[r0]), int(indptr[r1])
            with device_scope(dev):
                scores = _csr_scores(indptr[r0 : r1 + 1] - lo, csr.indices[lo:hi],
                                     csr.values[lo:hi], *replicas[dev])
            parts.append(on_slot(scores, head))
        return torch.cat(parts)


def _csr_scores(indptr, indices, values, columns, pi) -> torch.Tensor:
    """``pi + theta @ x`` of CSR rows: one gather of ``theta``'s columns
    (``columns`` ``[D, C]``) times the values, then ``segment_reduce`` over
    each row's run of nonzeros, on ``columns``' device."""
    dev = columns.device
    n = len(indptr) - 1
    if n == 0:
        return torch.empty((0, columns.shape[1]), dtype=columns.dtype, device=dev)
    cols = torch.from_numpy(np.asarray(indices).astype(np.int64)).to(dev)
    vals = torch.from_numpy(np.asarray(values).astype(np.float32)).to(dev)
    lengths = torch.from_numpy(np.diff(np.asarray(indptr).astype(np.int64))).to(dev)
    terms = columns[cols]
    terms.mul_(vals[:, None])
    return torch.segment_reduce(terms, "sum", lengths=lengths) + pi


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
