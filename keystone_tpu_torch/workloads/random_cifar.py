"""RandomCifar on PyTorch/CUDA (counterpart of
keystone_tpu/workloads/random_cifar.py, single device): random (unwhitened)
convolutional filters and one linear solve.

Flow: CIFAR load -> i.i.d. normal filter bank -> ``FusedConvFeaturizer``
(the Convolver with patch normalisation, then symmetric rectify, sum-pool
and vectorize in the unfused chain's element order, with f32 activations:
K1's ``conv_rect_pool`` entry on the card, its plain version on the CPU) ->
StandardScaler -> LinearMapEstimator(lambda) -> MaxClassifier ->
MulticlassClassifierEvaluator.  The fitted chain
``[featurizer, scaler, model, MaxClassifier]`` is the servable pipeline.
``--mesh`` shards both splits' rows over the mesh's data axis (each slot
featurizes its rows, one K1 launch per slot and chunk) and solves over it
(``LinearMapEstimator(mesh=)``), as RandomPatchCifar does.

Run: ``python -m keystone_tpu_torch.workloads.random_cifar
--trainLocation train.bin --testLocation test.bin [--device cpu]``.
"""

from __future__ import annotations

import argparse
import logging
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..core.logging import configure_logging
from ..core.pipeline import Pipeline
from ..core.resilience import assert_all_finite
from ..evaluation.multiclass import MulticlassClassifierEvaluator
from ..loaders.cifar import LabeledImageBatch, cifar_loader
from ..ops.conv_fused import FusedConvFeaturizer
from ..ops.stats import StandardScaler
from ..ops.util import ClassLabelIndicatorsFromIntLabels, MaxClassifier
from ..parallel.mesh import add_mesh_flag, map_rows, parse_mesh, unshard
from ..solvers.linear import LinearMapEstimator
from ..utils.platform import resolve_device, synchronize
from .cifar_random_patch import featurize_chunked

# Named: under ``python -m`` __name__ is __main__, outside the package's log handler.
_log = logging.getLogger("keystone_tpu_torch.workloads.random_cifar")


@dataclass
class RandomCifarWorkloadConfig:
    train_location: str = ""
    test_location: str = ""
    num_filters: int = 100
    patch_size: int = 6
    pool_size: int = 14
    pool_stride: int = 13
    alpha: float = 0.25
    lam: float | None = None
    sample_frac: float | None = None
    seed: int = 42
    num_classes: int = 10
    num_channels: int = 3
    featurize_chunk: int = 2048
    device: str = "cuda"


def draw_filters(conf: RandomCifarWorkloadConfig) -> torch.Tensor:
    """The [F, ps*ps*C] i.i.d. standard normal filter bank, drawn from a CPU
    generator seeded with ``conf.seed``.  It does not reproduce the JAX
    package's ``jax.random.normal`` draw."""
    gen = torch.Generator().manual_seed(conf.seed)
    shape = (conf.num_filters, conf.patch_size * conf.patch_size * conf.num_channels)
    return torch.randn(shape, generator=gen)


def build_featurizer(filters, conf: RandomCifarWorkloadConfig, device) -> FusedConvFeaturizer:
    """The featurizer on ``filters`` [F, ps*ps*C]: no whitener, patch
    normalisation, f32 activations."""
    return FusedConvFeaturizer(
        filters, None, pool_stride=conf.pool_stride, pool_size=conf.pool_size,
        alpha=conf.alpha, normalize_patches=True, img_channels=conf.num_channels,
        activation_dtype=torch.float32, device=device,
    )


def run(
    conf: RandomCifarWorkloadConfig,
    train: LabeledImageBatch,
    test: LabeledImageBatch,
    filters=None,
    mesh=None,
) -> dict:
    """Fit on ``train``, score ``train`` and ``test``.

    ``filters``: the [F, ps*ps*C] bank to use in place of drawing it (the
    tests carry the JAX package's draw across).  With ``mesh`` the
    featurize and the solve are row-sharded over its data axis.  The
    results carry the test predictions and the fitted servable pipeline
    under ``"servable"``."""
    configure_logging()
    dev = resolve_device(conf.device)
    t0 = time.perf_counter()
    if conf.sample_frac is not None:
        rng = np.random.default_rng(conf.seed)
        keep = rng.random(len(train)) < conf.sample_frac
        train = LabeledImageBatch(train.images[keep], train.labels[keep])
    if filters is None:
        filters = draw_filters(conf)
    featurizer = build_featurizer(filters, conf, dev)
    # One warm chunk first, so the throughput below is steady state.
    featurize_chunked(featurizer, train.images[:1], conf.featurize_chunk, dev, mesh=mesh)
    synchronize(dev)

    t_feat = time.perf_counter()
    train_conv = featurize_chunked(featurizer, train.images, conf.featurize_chunk, dev,
                                   mesh=mesh)
    synchronize(dev)
    feat_secs = time.perf_counter() - t_feat

    scaler = StandardScaler().fit(train_conv)
    train_features = map_rows(scaler, train_conv)
    labels = ClassLabelIndicatorsFromIntLabels(conf.num_classes)(
        torch.from_numpy(train.labels).to(dev)
    )
    t_solve = time.perf_counter()
    model = LinearMapEstimator(lam=conf.lam, mesh=mesh).fit(train_features, labels)
    assert_all_finite(model, "random-cifar model")
    solve_secs = time.perf_counter() - t_solve

    def predict(features):
        return MaxClassifier()(unshard(map_rows(model, features)))

    train_eval = MulticlassClassifierEvaluator(
        predict(train_features), torch.from_numpy(train.labels).to(dev), conf.num_classes
    )
    test_conv = featurize_chunked(featurizer, test.images, conf.featurize_chunk, dev, mesh=mesh)
    test_pred = predict(map_rows(scaler, test_conv))
    test_eval = MulticlassClassifierEvaluator(
        test_pred, torch.from_numpy(test.labels).to(dev), conf.num_classes
    )

    results = {
        "train_error": 100.0 * train_eval.total_error,
        "test_error": 100.0 * test_eval.total_error,
        "test_predictions": test_pred.cpu().numpy(),
        "seconds": time.perf_counter() - t0,
        "featurize_seconds": feat_secs,
        "featurize_images_per_sec": len(train) / feat_secs,
        "solve_seconds": solve_secs,
        "servable": Pipeline([featurizer, scaler, model, MaxClassifier()]),
    }
    _log.info("Training error is: %s", train_eval.total_error)
    _log.info("Test error is: %s", test_eval.total_error)
    return results


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("RandomCifar")
    p.add_argument("--trainLocation", required=True, help="CIFAR binary")
    p.add_argument("--testLocation", required=True, help="CIFAR binary")
    p.add_argument("--numFilters", type=int, default=100)
    p.add_argument("--patchSize", type=int, default=6)
    p.add_argument("--poolSize", type=int, default=14)
    p.add_argument("--poolStride", type=int, default=13)
    p.add_argument("--alpha", type=float, default=0.25)
    p.add_argument("--lambda", dest="lam", type=float, default=None)
    p.add_argument("--sampleFrac", type=float, default=None)
    p.add_argument(
        "--device", default="cuda", help="'cuda' (default; raises without a card) or 'cpu'"
    )
    add_mesh_flag(p)
    a = p.parse_args(argv)
    configure_logging()
    conf = RandomCifarWorkloadConfig(
        train_location=a.trainLocation,
        test_location=a.testLocation,
        num_filters=a.numFilters,
        patch_size=a.patchSize,
        pool_size=a.poolSize,
        pool_stride=a.poolStride,
        alpha=a.alpha,
        lam=a.lam,
        sample_frac=a.sampleFrac,
        device=a.device,
    )
    resolve_device(conf.device)
    mesh = parse_mesh(a.mesh, a.device)
    train = cifar_loader(conf.train_location)
    test = cifar_loader(conf.test_location)
    return run(conf, train, test, mesh=mesh)


if __name__ == "__main__":
    main()
