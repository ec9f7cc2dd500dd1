"""Shared machinery of the Fisher-vector workloads (counterpart of
keystone_tpu/workloads/fv_common.py, eager single-device subset).

Images of one shape are stacked into a bucket and featurized together; the
fixed-width feature rows are scattered back to the original image order.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.pipeline import Pipeline
from ..ops.fisher import FisherVector
from ..ops.images import GrayScaler, PixelScaler
from ..ops.stats import NormalizeRows, SignedHellingerMapper
from ..ops.util import MatrixVectorizer
from ..solvers.gmm import GaussianMixtureModel


def bucket_by_shape(images: list) -> dict:
    """Group per-image arrays by (H, W): shape -> (orig_indices, [n,H,W,C])."""
    groups: dict = {}
    for i, img in enumerate(images):
        groups.setdefault(img.shape[:2], []).append(i)
    return {
        shape: (np.asarray(idx), np.stack([images[i] for i in idx]))
        for shape, idx in groups.items()
    }


def grayscale(batch: torch.Tensor) -> torch.Tensor:
    """PixelScaler then GrayScaler -> [n, H, W] in [0, 1]."""
    return GrayScaler()(PixelScaler()(batch))[..., 0]


def sample_columns(desc_buckets: dict, num_samples: int, seed: int = 42) -> torch.Tensor:
    """Uniform sample of descriptor columns over per-bucket [n, d, cols]
    arrays -> [d, <= num_samples].  Each bucket gives its proportional quota,
    drawn by ``np.random.default_rng(seed)`` as in the JAX package, so the
    same descriptors give the same columns."""
    rng = np.random.default_rng(seed)
    totals = {
        shape: len(idx) * descs.shape[2] for shape, (idx, descs) in desc_buckets.items()
    }
    grand_total = sum(totals.values())
    picks = []
    for shape, (idx_arr, descs) in desc_buckets.items():
        c = descs.shape[2]
        total = totals[shape]
        if grand_total <= num_samples:
            idx = np.arange(total)
        else:
            quota = min(total, max(1, int(num_samples * total / grand_total)))
            idx = np.sort(rng.choice(total, quota, replace=False))
        im, col = np.divmod(idx, c)
        im = torch.from_numpy(im).to(descs.device)
        col = torch.from_numpy(col).to(descs.device)
        picks.append(descs[im, :, col].T)  # [d, quota]
    return torch.cat(picks, dim=1)


def fisher_feature_pipeline(gmm: GaussianMixtureModel) -> Pipeline:
    """FisherVector -> vectorize (column-major) -> L2 norm -> signed sqrt ->
    L2 norm: [n, d, cols] descriptors -> [n, 2·d·K] features."""
    return Pipeline([
        FisherVector(gmm), MatrixVectorizer(), NormalizeRows(),
        SignedHellingerMapper(), NormalizeRows(),
    ])


def scatter_features(buckets: dict, transform, n_total: int, feature_dim: int) -> torch.Tensor:
    """Apply ``transform`` ([n, d, cols] -> [n, D]) per bucket and scatter
    the rows back to the original image order."""
    out = None
    for _shape, (idx, descs) in buckets.items():
        feats = transform(descs)
        if out is None:
            out = torch.zeros((n_total, feature_dim), dtype=feats.dtype, device=feats.device)
        out[torch.from_numpy(np.asarray(idx)).to(feats.device)] = feats[: len(idx)]
    return out
