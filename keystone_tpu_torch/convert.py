"""Carry a fitted RandomPatchCifar or VOCSIFTFisher result into the port,
as numpy arrays.

:func:`from_arrays` (RandomPatchCifar) and :func:`voc_from_arrays`
(VOCSIFTFisher) rebuild the port's fitted nodes and servable pipeline on a
chosen device from plain arrays, whichever implementation fitted them (the
JAX package or the port itself); :func:`to_arrays` and
:func:`voc_to_arrays` are their inverses for a servable the port fitted.
The tests push one fitted state through both packages this way.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .core.pipeline import Pipeline
from .ops.conv_fused import FusedConvFeaturizer
from .ops.fisher import FisherVector
from .ops.sift import SIFTExtractor
from .ops.stats import StandardScalerModel
from .ops.util import MaxClassifier
from .solvers.block import BlockLinearMapper
from .solvers.gmm import GaussianMixtureModel
from .solvers.pca import BatchPCATransformer
from .solvers.whitening import ZCAWhitener
from .utils.platform import resolve_device
from .workloads.voc_sift_fisher import SIFTFisherConfig, servable_pipeline


@dataclass
class FittedCifar:
    featurizer: FusedConvFeaturizer
    scaler: StandardScalerModel
    model: BlockLinearMapper
    servable: Pipeline
    whitener: ZCAWhitener | None = None


def from_arrays(
    *,
    filters,
    whitener_means,
    scaler_mean,
    scaler_std,
    xs,
    b,
    block_means,
    whitener=None,
    pool_stride: int = 13,
    pool_size: int = 14,
    alpha: float = 0.25,
    block_size: int = 4096,
    activation_dtype: torch.dtype = torch.bfloat16,
    device="cuda",
) -> FittedCifar:
    """Build the fitted chain from arrays.

    filters [F, ws, ws, C]; whitener_means [ws*ws*C]; scaler_mean/std [d];
    xs: list of [d_i, k] model blocks; b [k] intercept; block_means: list of
    [d_i] per-block feature means; whitener [ws*ws*C, ws*ws*C], optional —
    it is folded into the filters at fit time, so the servable needs only its
    means, and it comes back as a :class:`ZCAWhitener` for patch-level use.
    """
    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.array(a, np.float32), device=dev)

    filters = t(filters)
    featurizer = FusedConvFeaturizer(
        filters,
        whitener_means=t(whitener_means),
        pool_stride=pool_stride,
        pool_size=pool_size,
        alpha=alpha,
        normalize_patches=True,
        img_channels=filters.shape[-1],
        activation_dtype=activation_dtype,
        device=dev,
    )
    scaler = StandardScalerModel(t(scaler_mean), t(scaler_std))
    model = BlockLinearMapper(
        [t(x) for x in xs],
        block_size,
        t(b),
        [StandardScalerModel(t(m)) for m in block_means],
    )
    servable = Pipeline([featurizer, scaler, model, MaxClassifier()])
    zca = None if whitener is None else ZCAWhitener(t(whitener), t(whitener_means))
    return FittedCifar(featurizer, scaler, model, servable, zca)


def to_arrays(servable: Pipeline) -> dict:
    """The keyword arguments of :func:`from_arrays` for a servable
    ``[FusedConvFeaturizer, StandardScalerModel, BlockLinearMapper, ...]``."""
    featurizer, scaler, model = servable.nodes[:3]

    def a(x):
        return x.detach().cpu().numpy()

    conv = featurizer.conv
    return dict(
        filters=a(conv.filters),
        whitener_means=a(conv.whitener_means),
        scaler_mean=a(scaler.mean),
        scaler_std=a(scaler.std),
        xs=[a(x) for x in model.xs],
        b=a(model.b),
        block_means=[a(s.mean) for s in model.feature_scalers],
        pool_stride=featurizer.pool_stride,
        pool_size=featurizer.pool_size,
        alpha=featurizer.alpha,
        block_size=model.block_size,
        activation_dtype=featurizer.activation_dtype,
    )


@dataclass
class FittedVOC:
    pca: BatchPCATransformer
    gmm: GaussianMixtureModel
    model: BlockLinearMapper
    servable: Pipeline


def voc_from_arrays(
    pca_mat,
    gmm_means,
    gmm_variances,
    gmm_weights,
    model_xs,
    model_b,
    model_block_means,
    *,
    sift_step_size: int = 3,
    scale_step: int = 0,
    block_size: int = 4096,
    device="cuda",
) -> FittedVOC:
    """Build the fitted VOCSIFTFisher chain from arrays.

    pca_mat [128, dims]; gmm_means/gmm_variances [dims, k]; gmm_weights [k];
    model_xs: list of [d_i, 20] blocks; model_b [20]; model_block_means:
    list of [d_i] per-block feature means."""
    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.array(a, np.float32), device=dev)

    pca = BatchPCATransformer(t(pca_mat))
    gmm = GaussianMixtureModel(t(gmm_means), t(gmm_variances), t(gmm_weights))
    model = BlockLinearMapper(
        [t(x) for x in model_xs], block_size, t(model_b),
        [StandardScalerModel(t(m)) for m in model_block_means],
    )
    conf = SIFTFisherConfig(sift_step_size=sift_step_size, scale_step=scale_step, device=device)
    servable = servable_pipeline(conf, {"pca": pca, "gmm": gmm, "model": model})
    return FittedVOC(pca, gmm, model, servable)


def voc_to_arrays(servable: Pipeline) -> dict:
    """The keyword arguments of :func:`voc_from_arrays` for a VOCSIFTFisher
    servable (``workloads.voc_sift_fisher.servable_pipeline``)."""

    def node(kind):
        return next(n for n in servable.nodes if isinstance(n, kind))

    def a(x):
        return x.detach().cpu().numpy()

    sift, pca, model = node(SIFTExtractor), node(BatchPCATransformer), node(BlockLinearMapper)
    gmm = node(FisherVector).gmm
    return dict(
        pca_mat=a(pca.pca_mat),
        gmm_means=a(gmm.means),
        gmm_variances=a(gmm.variances),
        gmm_weights=a(gmm.weights),
        model_xs=[a(x) for x in model.xs],
        model_b=a(model.b),
        model_block_means=[a(s.mean) for s in model.feature_scalers],
        sift_step_size=sift.step_size,
        scale_step=sift.scale_step,
        block_size=model.block_size,
    )
