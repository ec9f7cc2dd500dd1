"""Sparse feature vectorization (counterpart of keystone_tpu/ops/sparse.py).

A batch of sparse vectors is a host CSR triple (values, column indices, row
pointers) of numpy arrays; ``solvers/naive_bayes.py`` moves it to the device
to score it.  The feature space is fitted on the host, in the JAX package's
order, ties included, so feature indices agree between the two packages.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass

import numpy as np

from ..core.pipeline import Estimator, Transformer


@dataclass
class CSRFeatures:
    """Batch of sparse feature vectors in CSR form."""

    values: np.ndarray  # [nnz] f32
    indices: np.ndarray  # [nnz] int32 column ids
    indptr: np.ndarray  # [N+1] int64 row boundaries
    num_features: int

    def __len__(self):
        return len(self.indptr) - 1

    @property
    def shape(self):
        return (len(self), self.num_features)

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, np.float32)
        for i in range(len(self)):
            s, e = self.indptr[i], self.indptr[i + 1]
            out[i, self.indices[s:e]] += self.values[s:e]
        return out


class SparseFeatureVectorizer(Transformer):
    """Map (term, value) pairs into CSR rows of a fitted feature space;
    terms outside it are dropped."""

    def __init__(self, feature_space: dict):
        self.feature_space = feature_space

    def __call__(self, batch) -> CSRFeatures:
        fs = self.feature_space
        values, indices, indptr = [], [], [0]
        for terms in batch:
            for t, v in terms:
                j = fs.get(t)
                if j is not None:
                    indices.append(j)
                    values.append(v)
            indptr.append(len(indices))
        return CSRFeatures(
            np.asarray(values, np.float32),
            np.asarray(indices, np.int32),
            np.asarray(indptr, np.int64),
            len(fs),
        )


class CommonSparseFeatures(Estimator):
    """Keep the ``num_features`` features present in the most documents;
    ties keep first-seen order (a stable sort on the count)."""

    def __init__(self, num_features: int):
        self.num_features = num_features

    def fit(self, data) -> SparseFeatureVectorizer:
        freq: dict = defaultdict(int)
        for terms in data:
            for t, _v in terms:
                freq[t] += 1
        top = sorted(freq.items(), key=lambda kv: -kv[1])[: self.num_features]
        return SparseFeatureVectorizer({t: i for i, (t, _) in enumerate(top)})


class AllSparseFeatures(Estimator):
    """Keep every observed feature, in first-seen order."""

    def fit(self, data) -> SparseFeatureVectorizer:
        space: dict = {}
        for terms in data:
            for t, _v in terms:
                if t not in space:
                    space[t] = len(space)
        return SparseFeatureVectorizer(space)
