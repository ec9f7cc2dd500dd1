"""PCA and multi-class LDA (counterpart of keystone_tpu/solvers/pca.py).

``compute_pca`` mean-centres a sample matrix, takes its f32 SVD (through
the QR factor of a tall sample), applies the MATLAB sign convention (the
largest-magnitude element of each component is positive) and keeps the
first ``dims`` components.

``LinearDiscriminantAnalysis`` solves ``eig(inv(S_W) S_B)`` as the symmetric
problem ``eigh(L⁻¹ S_B L⁻ᵀ)`` with ``S_W = L Lᵀ``, as the JAX package does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.pipeline import Estimator, LabelEstimator, Transformer, node
from ..utils.stats import matmul_rows, sqrt_rn
from .linear import LinearMapper


@node(data_fields=("pca_mat",))
class PCATransformer(Transformer):
    """Project row vectors: ``batch @ pca_mat``, each row's bits
    independent of the row count (``utils.stats.matmul_rows``)."""

    def __init__(self, pca_mat: torch.Tensor):
        self.pca_mat = pca_mat

    def __call__(self, batch):
        lead = batch.shape[:-1]
        out = matmul_rows(batch.reshape(-1, batch.shape[-1]), self.pca_mat)
        return out.reshape(*lead, out.shape[-1])


@node(data_fields=("pca_mat",))
class BatchPCATransformer(Transformer):
    """Project descriptor matrices whose descriptors are columns:
    ``[N, d, cols] -> [N, dims, cols]`` (``einsum("dk,ndc->nkc")``).

    One product of the same shape per matrix: a batched or folded product
    may pick its kernel by ``N``, and a served row must not round with the
    batch it rides in."""

    def __init__(self, pca_mat: torch.Tensor):
        self.pca_mat = pca_mat

    def __call__(self, batch):
        if batch.dim() == 2:
            return self.pca_mat.T @ batch
        proj = self.pca_mat.T
        out = batch.new_empty((batch.shape[0], proj.shape[0], batch.shape[-1]))
        for i in range(batch.shape[0]):
            torch.matmul(proj, batch[i], out=out[i])
        return out


def compute_pca(data_mat: torch.Tensor, dims: int) -> torch.Tensor:
    """[n, d] samples -> [d, dims] projection (columns are components, by
    descending singular value)."""
    data = data_mat.to(torch.float32)
    data = data - data.mean(dim=0)
    n, d = data.shape
    if n > d:
        # A tall sample (1e7 x 128 at ImageNet's setting) goes through its
        # QR factor first, as LAPACK's gesvd does for m >> n: R has the
        # sample's right singular vectors, and cuSOLVER's SVD refuses a
        # sample that tall outright.
        data = torch.linalg.qr(data, mode="r").R
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


class LinearDiscriminantAnalysis(LabelEstimator):
    """Multi-class LDA -> ``LinearMapper`` of the ``num_dimensions`` most
    discriminative unit directions.

    ``S_W = Σ_c Σ_{x∈c} (x−μ_c)(x−μ_c)ᵀ`` (from class-centred rows, no
    ``S_total − S_B`` cancellation), ``S_B = Σ_c n_c (μ_c−μ)(μ_c−μ)ᵀ``.
    The eigenvalues are those of ``eig(inv(S_W) S_B)``; the directions
    ``W = L⁻ᵀ Y`` are normalised to unit length (their signs are arbitrary).
    Runs in f64 on f64 data, else in f32."""

    def __init__(self, num_dimensions: int):
        self.num_dimensions = num_dimensions

    def fit(self, data, labels) -> LinearMapper:
        data = torch.as_tensor(data)
        dtype = torch.float64 if data.dtype == torch.float64 else torch.float32
        data = data.to(dtype)
        labels_np = np.asarray(torch.as_tensor(labels).cpu())
        classes, class_of_row = np.unique(labels_np, return_inverse=True)
        dev = data.device
        rows = torch.from_numpy(class_of_row.ravel()).to(dev)
        counts = torch.bincount(rows, minlength=len(classes)).to(dtype)
        sums = torch.zeros((len(classes), data.shape[1]), dtype=dtype, device=dev)
        class_means = sums.index_add_(0, rows, data) / counts[:, None]
        centered = data - class_means[rows]
        sw = centered.T @ centered
        dm = (class_means - data.mean(dim=0)) * sqrt_rn(counts)[:, None]
        sb = dm.T @ dm

        chol, info = torch.linalg.cholesky_ex(sw)
        if int(info) != 0:
            raise ValueError(
                "S_W is singular (need n_samples - n_classes >= n_features); "
                "LDA projection would be NaN"
            )
        linv_sb = torch.linalg.solve_triangular(chol, sb, upper=False)
        m = torch.linalg.solve_triangular(chol, linv_sb.T, upper=False).T
        m = 0.5 * (m + m.T)
        eigvals, y = torch.linalg.eigh(m)
        order = torch.argsort(-eigvals.abs())[: self.num_dimensions]
        w = torch.linalg.solve_triangular(chol.T, y[:, order], upper=True)
        return LinearMapper(w / torch.linalg.vector_norm(w, dim=0, keepdim=True))
