"""PCA (counterpart of keystone_tpu/solvers/pca.py; LinearDiscriminantAnalysis
is not ported yet).

``compute_pca`` mean-centres a sample matrix, takes its f32 SVD, applies the
MATLAB sign convention (the largest-magnitude element of each component is
positive) and keeps the first ``dims`` components.
"""

from __future__ import annotations

import torch

from ..core.pipeline import Estimator, Transformer


class PCATransformer(Transformer):
    """Project row vectors: ``batch @ pca_mat``."""

    def __init__(self, pca_mat: torch.Tensor):
        self.pca_mat = pca_mat

    def __call__(self, batch):
        return batch @ self.pca_mat


class BatchPCATransformer(Transformer):
    """Project descriptor matrices whose descriptors are columns:
    ``[N, d, cols] -> [N, dims, cols]`` (``einsum("dk,ndc->nkc")``)."""

    def __init__(self, pca_mat: torch.Tensor):
        self.pca_mat = pca_mat

    def __call__(self, batch):
        return torch.matmul(self.pca_mat.T, batch)


def compute_pca(data_mat: torch.Tensor, dims: int) -> torch.Tensor:
    """[n, d] samples -> [d, dims] projection (columns are components, by
    descending singular value)."""
    data = data_mat.to(torch.float32)
    data = data - data.mean(dim=0)
    n, d = data.shape
    _, _, vh = torch.linalg.svd(data, full_matrices=n < d)
    pca = vh.T
    signs = torch.where(
        pca.max(dim=0).values == pca.abs().max(dim=0).values, 1.0, -1.0
    ).to(pca.dtype)
    return (pca * signs)[:, :dims]


class PCAEstimator(Estimator):
    """Fit PCA from a sample matrix."""

    def __init__(self, dims: int):
        self.dims = dims

    def fit(self, samples) -> PCATransformer:
        return PCATransformer(compute_pca(samples, self.dims))
