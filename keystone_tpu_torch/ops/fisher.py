"""Fisher vector encoding (counterpart of keystone_tpu/ops/fisher.py).

Improved FV, mean and variance gradients only (length ``2·d·K``):

    G_mu_k  = (1/(N sqrt(pi_k)))  sum_n q_nk (x_n - mu_k)/sigma_k
    G_sig_k = (1/(N sqrt(2 pi_k))) sum_n q_nk [((x_n - mu_k)/sigma_k)^2 - 1]

with no power or L2 normalisation inside the encoder.  The output is
``[d, 2K]`` per image: columns 0..K-1 the mean gradients, K..2K-1 the
variance gradients.

``FisherVector`` gets the sufficient statistics of an unmasked batch from
:func:`fv_stats`, which launches the CUDA kernel on a CUDA tensor and runs
its plain version on a CPU tensor.
"""

from __future__ import annotations

import torch

from ..core.pipeline import Transformer
from ..solvers.gmm import GaussianMixtureModel, _log_resp
from .fv_stats import fv_stats


def _fv_from_stats(s0, s1, s2, means, variances, weights, n_valid):
    """Mean/variance gradients from sufficient statistics.
    Batched: s0 [..., k], s1/s2 [..., d, k], n_valid [...]."""
    sigma = torch.sqrt(variances)
    n_safe = torch.clamp_min(n_valid, 1.0)[..., None, None]
    s0e = s0[..., None, :]
    g_mean = (s1 - means * s0e) / (sigma * torch.sqrt(weights) * n_safe)
    g_var = (s2 - 2.0 * means * s1 + (means * means - variances) * s0e) / (
        variances * torch.sqrt(2.0 * weights) * n_safe
    )
    return torch.cat([g_mean, g_var], dim=-1)  # [..., d, 2K]


def fisher_vector(descriptors, means, variances, weights, mask=None):
    """FV of one descriptor matrix ``[cols, d]`` (descriptors as rows).

    ``mask``: optional [cols] 0/1 validity; masked descriptors contribute
    nothing and N counts only the valid ones."""
    x = descriptors
    q = torch.softmax(_log_resp(x, means, variances, weights), dim=-1)  # [n, k]
    if mask is not None:
        q = q * mask[:, None]
        n_valid = mask.sum()
    else:
        n_valid = torch.tensor(float(x.shape[0]), dtype=x.dtype, device=x.device)
    return _fv_from_stats(q.sum(dim=0), x.T @ q, (x * x).T @ q, means, variances, weights, n_valid)


class FisherVector(Transformer):
    """Batched FV node: ``[N, d, cols]`` descriptor matrices (descriptors as
    columns) -> ``[N, d, 2K]``."""

    def __init__(self, gmm: GaussianMixtureModel):
        self.gmm = gmm

    @property
    def num_dims(self) -> int:
        return self.gmm.dim

    @property
    def num_centroids(self) -> int:
        return self.gmm.k

    @property
    def num_features(self) -> int:
        return self.num_dims * self.num_centroids * 2

    def __call__(self, batch, mask=None):
        """``mask``: optional [N, cols] validity for ragged descriptor counts.
        As in the JAX package, a masked call takes the plain path per image
        (:func:`fisher_vector`) on any device and never reaches the kernel,
        whose raggedness is a prefix count, not an arbitrary mask."""
        gmm = self.gmm
        if mask is not None:
            return torch.stack([
                fisher_vector(mat.T, gmm.means, gmm.variances, gmm.weights, m)
                for mat, m in zip(batch, mask)
            ])
        s0, s1, s2 = fv_stats(batch, None, gmm.means, gmm.variances, gmm.weights)
        n_valid = torch.full(
            (batch.shape[0],), float(batch.shape[2]), dtype=torch.float32, device=batch.device
        )
        return _fv_from_stats(s0, s1, s2, gmm.means, gmm.variances, gmm.weights, n_valid)
