"""Carry a fitted pipeline into the port, as numpy arrays.

:func:`from_arrays` (RandomPatchCifar), :func:`voc_from_arrays`
(VOCSIFTFisher), :func:`mnist_from_arrays` (MnistRandomFFT),
:func:`timit_from_arrays` (TimitPipeline), :func:`random_cifar_from_arrays`
(RandomCifar), :func:`newsgroups_from_arrays` (NewsgroupsPipeline) and
:func:`imagenet_from_arrays` (ImageNetSiftLcsFV)
rebuild the port's fitted nodes and servable pipeline on a chosen device
from plain arrays, whichever implementation fitted them (the JAX package or
the port itself); :func:`to_arrays`, :func:`voc_to_arrays`,
:func:`mnist_to_arrays`, :func:`timit_to_arrays` and
:func:`imagenet_to_arrays` are inverses for a
servable the port fitted.  The tests push one fitted state through both
packages this way.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .core.pipeline import Pipeline
from .ops.conv_fused import FusedConvFeaturizer
from .ops.fisher import FisherVector
from .ops.sparse import SparseFeatureVectorizer
from .ops.sift import SIFTExtractor
from .ops.stats import CosineRandomFeatures, StandardScalerModel
from .ops.util import MaxClassifier, ZipVectors
from .solvers.block import BlockLinearMapper
from .solvers.gmm import GaussianMixtureModel
from .solvers.linear import LinearMapper
from .solvers.naive_bayes import NaiveBayesModel
from .solvers.pca import BatchPCATransformer
from .solvers.whitening import ZCAWhitener
from .utils.platform import resolve_device
from .workloads import mnist_random_fft as mnist
from .workloads import imagenet_sift_lcs_fv as imagenet
from .workloads import newsgroups, random_cifar, timit
from .workloads.voc_sift_fisher import SIFTFisherConfig, servable_pipeline



def _tensor_fn(device):
    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.array(a, np.float32), device=dev)

    return dev, t


def _arrays(x):
    return x.detach().cpu().numpy()


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
    dev, t = _tensor_fn(device)

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

    conv = featurizer.conv
    return dict(
        filters=_arrays(conv.filters),
        whitener_means=_arrays(conv.whitener_means),
        scaler_mean=_arrays(scaler.mean),
        scaler_std=_arrays(scaler.std),
        xs=[_arrays(x) for x in model.xs],
        b=_arrays(model.b),
        block_means=[_arrays(s.mean) for s in model.feature_scalers],
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
    dev, t = _tensor_fn(device)

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

    sift, pca, model = node(SIFTExtractor), node(BatchPCATransformer), node(BlockLinearMapper)
    gmm = node(FisherVector).gmm
    return dict(
        pca_mat=_arrays(pca.pca_mat),
        gmm_means=_arrays(gmm.means),
        gmm_variances=_arrays(gmm.variances),
        gmm_weights=_arrays(gmm.weights),
        model_xs=[_arrays(x) for x in model.xs],
        model_b=_arrays(model.b),
        model_block_means=[_arrays(s.mean) for s in model.feature_scalers],
        sift_step_size=sift.step_size,
        scale_step=sift.scale_step,
        block_size=model.block_size,
    )


@dataclass
class FittedMnist:
    model: BlockLinearMapper
    servable: Pipeline


def mnist_from_arrays(
    *, signs, xs, b, block_means, block_size: int = 2048, device="cuda"
) -> FittedMnist:
    """Build the fitted MnistRandomFFT chain from arrays.

    signs: per FFT group, per chain, the [d] ±1 vector of its
    RandomSignNode; xs: list of [group width, k] model blocks; b [k]
    intercept; block_means: list of per-block feature means."""
    dev, t = _tensor_fn(device)

    groups = [[mnist.fft_chain(t(s)) for s in group] for group in signs]
    model = BlockLinearMapper(
        [t(x) for x in xs], block_size, t(b), [StandardScalerModel(t(m)) for m in block_means]
    )
    return FittedMnist(model, mnist.servable_pipeline(groups, model))


def mnist_to_arrays(servable: Pipeline) -> dict:
    """The keyword arguments of :func:`mnist_from_arrays` for a
    MnistRandomFFT servable (``workloads.mnist_random_fft.servable_pipeline``)."""
    featurizer, model = servable.nodes[:2]

    return dict(
        signs=[[_arrays(chain.nodes[0].signs) for chain in group]
               for group in featurizer.groups],
        xs=[_arrays(x) for x in model.xs],
        b=_arrays(model.b),
        block_means=[_arrays(s.mean) for s in model.feature_scalers],
        block_size=model.block_size,
    )


@dataclass
class FittedTimit:
    featurizers: list
    model: BlockLinearMapper
    servable: Pipeline


def timit_from_arrays(
    *, W, b, scaler_means, scaler_stds, xs, block_means, intercept,
    block_size: int = 4096, device="cuda",
) -> FittedTimit:
    """Build the fitted TimitPipeline chain from arrays.

    W, b: per block, the [D, 440] weights and [D] offsets of its
    CosineRandomFeatures; scaler_means, scaler_stds: per block, its
    StandardScaler's [D] mean and std; xs: the [D, k] model blocks;
    block_means: the model's per-block feature means; intercept [k]."""
    _, t = _tensor_fn(device)
    featurizers = [
        Pipeline([CosineRandomFeatures(t(w), t(off)), StandardScalerModel(t(m), t(s))])
        for w, off, m, s in zip(W, b, scaler_means, scaler_stds)
    ]
    model = BlockLinearMapper(
        [t(x) for x in xs], block_size, t(intercept),
        [StandardScalerModel(t(m)) for m in block_means],
    )
    return FittedTimit(featurizers, model, timit.servable_pipeline(featurizers, model))


def timit_to_arrays(servable: Pipeline) -> dict:
    """The keyword arguments of :func:`timit_from_arrays` for a TimitPipeline
    servable (``workloads.timit.servable_pipeline``)."""
    featurizer, model = servable.nodes[:2]
    chains = [group[0] for group in featurizer.groups]
    return dict(
        W=[_arrays(c.nodes[0].W) for c in chains],
        b=[_arrays(c.nodes[0].b) for c in chains],
        scaler_means=[_arrays(c.nodes[1].mean) for c in chains],
        scaler_stds=[_arrays(c.nodes[1].std) for c in chains],
        xs=[_arrays(x) for x in model.xs],
        block_means=[_arrays(s.mean) for s in model.feature_scalers],
        intercept=_arrays(model.b),
        block_size=model.block_size,
    )


@dataclass
class FittedRandomCifar:
    featurizer: FusedConvFeaturizer
    scaler: StandardScalerModel
    model: LinearMapper
    servable: Pipeline


def random_cifar_from_arrays(
    *, filters, scaler_mean, scaler_std, x, b, feature_mean,
    pool_stride: int = 13, pool_size: int = 14, alpha: float = 0.25,
    num_channels: int = 3, device="cuda",
) -> FittedRandomCifar:
    """Build the fitted RandomCifar chain from arrays.

    filters [F, ps*ps*C]; scaler_mean/std [d]; the linear model's x [d, k],
    intercept b [k] and its mean-only feature scaler's feature_mean [d]."""
    dev, t = _tensor_fn(device)
    featurizer = random_cifar.build_featurizer(
        t(filters), random_cifar.RandomCifarWorkloadConfig(
            pool_stride=pool_stride, pool_size=pool_size, alpha=alpha, num_channels=num_channels),
        dev,
    )
    scaler = StandardScalerModel(t(scaler_mean), t(scaler_std))
    model = LinearMapper(t(x), t(b), StandardScalerModel(t(feature_mean)))
    return FittedRandomCifar(
        featurizer, scaler, model, Pipeline([featurizer, scaler, model, MaxClassifier()])
    )


@dataclass
class FittedNewsgroups:
    vectorizer: SparseFeatureVectorizer
    model: NaiveBayesModel
    servable: Pipeline


def newsgroups_from_arrays(
    *, vocabulary, pi, theta, n_grams: int = 2, device="cuda"
) -> FittedNewsgroups:
    """Build the fitted NewsgroupsPipeline chain from its feature space
    (``vocabulary``: the n-gram tuples in feature-index order) and the
    naive-Bayes ``pi`` [C] and ``theta`` [C, D]."""
    _, t = _tensor_fn(device)
    vectorizer = SparseFeatureVectorizer({term: i for i, term in enumerate(vocabulary)})
    model = NaiveBayesModel(t(pi), t(theta))
    servable = Pipeline([newsgroups.text_pipeline(n_grams), vectorizer, model, MaxClassifier()])
    return FittedNewsgroups(vectorizer, model, servable)


@dataclass
class FittedImageNet:
    """Both branches' PCA and GMM and the weighted block model, with the
    configuration whose descriptor settings fit them."""

    bundle: dict  #: {sift_pca, sift_gmm, lcs_pca, lcs_gmm, model}, as ``run`` returns it
    conf: imagenet.ImageNetSiftLcsFVConfig

    def scores(self, images: list) -> torch.Tensor:
        """Per-class scores of new images: both branches' features
        (``branch_test_features``), concatenated, through the model."""
        feats = [
            imagenet.branch_test_features(
                self.conf, images, b, self.bundle[f"{b}_pca"], self.bundle[f"{b}_gmm"]
            )
            for b in imagenet.BRANCHES
        ]
        return self.bundle["model"](ZipVectors.apply(feats))


def imagenet_from_arrays(
    *, sift_pca_mat, sift_gmm_means, sift_gmm_variances, sift_gmm_weights,
    lcs_pca_mat, lcs_gmm_means, lcs_gmm_variances, lcs_gmm_weights, model_xs, model_b,
    block_size: int = 4096, sift_scale_step: int = 1, lcs_stride: int = 4,
    lcs_border: int = 16, lcs_patch: int = 6, device="cuda",
) -> FittedImageNet:
    """Build the fitted ImageNetSiftLcsFV state from arrays.

    *_pca_mat [128 or 96, dims]; *_gmm_means/variances [dims, k];
    *_gmm_weights [k]; model_xs: list of [d_i, C] blocks (SIFT's features
    first); model_b [C]."""
    _, t = _tensor_fn(device)
    bundle = {}
    for b, pca_mat, means, variances, weights in (
        ("sift", sift_pca_mat, sift_gmm_means, sift_gmm_variances, sift_gmm_weights),
        ("lcs", lcs_pca_mat, lcs_gmm_means, lcs_gmm_variances, lcs_gmm_weights),
    ):
        bundle[f"{b}_pca"] = BatchPCATransformer(t(pca_mat))
        bundle[f"{b}_gmm"] = GaussianMixtureModel(t(means), t(variances), t(weights))
    bundle["model"] = BlockLinearMapper([t(x) for x in model_xs], block_size, t(model_b))
    means = np.asarray(sift_gmm_means)
    conf = imagenet.ImageNetSiftLcsFVConfig(
        desc_dim=means.shape[0], vocab_size=means.shape[1], sift_scale_step=sift_scale_step,
        lcs_stride=lcs_stride, lcs_border=lcs_border, lcs_patch=lcs_patch, device=device,
    )
    return FittedImageNet(bundle, conf)


def imagenet_to_arrays(bundle: dict, conf) -> dict:
    """The keyword arguments of :func:`imagenet_from_arrays` for a fitted
    bundle (``run(...)["bundle"]``) and the configuration that fitted it."""
    out = {}
    for b in imagenet.BRANCHES:
        gmm = bundle[f"{b}_gmm"]
        out.update({
            f"{b}_pca_mat": _arrays(bundle[f"{b}_pca"].pca_mat),
            f"{b}_gmm_means": _arrays(gmm.means),
            f"{b}_gmm_variances": _arrays(gmm.variances),
            f"{b}_gmm_weights": _arrays(gmm.weights),
        })
    model = bundle["model"]
    return dict(
        out, model_xs=[_arrays(x) for x in model.xs], model_b=_arrays(model.b),
        block_size=model.block_size, sift_scale_step=conf.sift_scale_step,
        lcs_stride=conf.lcs_stride, lcs_border=conf.lcs_border, lcs_patch=conf.lcs_patch,
    )
