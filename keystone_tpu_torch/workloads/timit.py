"""TimitPipeline on PyTorch/CUDA (counterpart of
keystone_tpu/workloads/timit.py, eager single-device path).

Flow: TIMIT CSV load (440-dim frames, sparse 1-indexed "row label" files)
-> ``numCosines`` blocks, each ``CosineRandomFeatures(440 -> 4096)`` (Gaussian
or Cauchy W) then a ``StandardScaler`` fitted on that block ->
BlockLeastSquares(4096, numEpochs, lambda) over the list of blocks (block
coordinate descent, ``numEpochs`` sweeps) -> streaming evaluation on the
test blocks after every block, as the reference does (the last call sees
the full model) -> MaxClassifier -> MulticlassClassifierEvaluator.  The
fitted chain ``GroupConcatFeaturizer(blocks) >> model >> MaxClassifier`` is
the servable pipeline.  ``--mesh`` row-shards both splits over the mesh's
data axis: each slot computes its rows' cosines (the pad rows masked back
to zero, since ``cos(0·W + b)`` is not), the scalers' moments and the
multi-epoch block solve reduce over the data axis.

Run: ``python -m keystone_tpu_torch.workloads.timit --trainDataLocation
train.csv --trainLabelsLocation train.labels --testDataLocation test.csv
--testLabelsLocation test.labels [--device cpu]``.
"""

from __future__ import annotations

import argparse
import logging
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..core.logging import configure_logging
from ..core.memory import log_fit_report
from ..core.pipeline import Pipeline
from ..core.resilience import assert_all_finite
from ..evaluation.multiclass import MulticlassClassifierEvaluator
from ..loaders.timit import (
    TIMIT_DIMENSION,
    TIMIT_NUM_CLASSES,
    TimitFeaturesData,
    timit_features_loader,
)
from ..ops.stats import CosineRandomFeatures, StandardScaler
from ..ops.util import ClassLabelIndicatorsFromIntLabels, GroupConcatFeaturizer, MaxClassifier
from ..parallel.mesh import add_mesh_flag, map_rows, padded_shard_rows, parse_mesh
from ..solvers.block import BlockLeastSquaresEstimator, BlockLinearMapper
from ..utils.platform import resolve_device, synchronize

# Named: under ``python -m`` __name__ is __main__, outside the package's log handler.
_log = logging.getLogger("keystone_tpu_torch.workloads.timit")


@dataclass
class TimitConfig:
    train_data_location: str = ""
    train_labels_location: str = ""
    test_data_location: str = ""
    test_labels_location: str = ""
    num_cosines: int = 50
    gamma: float = 0.05555
    rf_type: str = "gaussian"  # or "cauchy"
    lam: float = 0.0
    num_epochs: int = 5
    num_cosine_features: int = 4096
    seed: int = 123
    num_classes: int = TIMIT_NUM_CLASSES
    dimension: int = TIMIT_DIMENSION
    device: str = "cuda"


def draw_random_features(conf: TimitConfig, device) -> list[CosineRandomFeatures]:
    """``numCosines`` random-feature maps on ``device``, drawn in turn from
    one CPU generator seeded with ``conf.seed``."""
    gen = torch.Generator().manual_seed(conf.seed)
    return [
        CosineRandomFeatures.create(
            conf.dimension, conf.num_cosine_features, conf.gamma, gen,
            w_dist=conf.rf_type, device=device,
        )
        for _ in range(conf.num_cosines)
    ]


def build_batch_featurizers(random_features, train_data) -> tuple[list[Pipeline], list]:
    """The ``[CosineRandomFeatures -> StandardScaler]`` chains, each scaler
    fitted on its own block of ``train_data`` (a tensor, or row-sharded),
    and the training blocks they produce (each block's cosines are computed
    once)."""
    featurizers, blocks = [], []
    for rf in random_features:
        feats = map_rows(rf, train_data)
        scaler = StandardScaler().fit(feats)
        featurizers.append(Pipeline([rf, scaler]))
        blocks.append(map_rows(scaler, feats))
        del feats
    return featurizers, blocks


def servable_pipeline(featurizers, model: BlockLinearMapper) -> Pipeline:
    """Each block's chain on the batch, concatenated, then the model, which
    cuts the concatenation back into the fitted blocks, then the argmax."""
    return Pipeline([GroupConcatFeaturizer([[f] for f in featurizers]), model, MaxClassifier()])


def run(conf: TimitConfig, data: TimitFeaturesData, random_features=None, mesh=None) -> dict:
    """Fit on ``data.train``, evaluate on ``data.test`` block by block.
    With ``mesh`` both splits are row-sharded over its data axis and the
    block solve runs its mesh ladder.

    ``random_features``: the ``numCosines`` random-feature maps to use in
    place of drawing them (the tests carry the JAX package's draws across).
    The results carry the last evaluation's ``test_scores`` and the fitted
    servable pipeline under ``"servable"``.  The stage clocks each end in a
    synchronize; ``eval_seconds`` includes featurizing the test split."""
    configure_logging()
    dev = resolve_device(conf.device)
    t0 = time.perf_counter()
    if random_features is None:
        random_features = draw_random_features(conf, dev)
    train_data = torch.from_numpy(np.ascontiguousarray(data.train.data, np.float32)).to(dev)
    labels = ClassLabelIndicatorsFromIntLabels(conf.num_classes)(
        torch.from_numpy(np.asarray(data.train.labels)).to(dev)
    )
    test_labels = torch.from_numpy(np.asarray(data.test.labels)).to(dev)
    if mesh is not None:
        train_data, _ = padded_shard_rows(train_data, mesh)
    # One block's product first, so the clock below reads steady state.
    map_rows(random_features[0], train_data)
    synchronize(dev)

    t_feat = time.perf_counter()
    featurizers, training_batches = build_batch_featurizers(random_features, train_data)
    synchronize(dev)
    feat_secs = time.perf_counter() - t_feat

    t_solve = time.perf_counter()
    solver = BlockLeastSquaresEstimator(conf.num_cosine_features, conf.num_epochs, conf.lam,
                                        mesh=mesh)
    model = solver.fit(training_batches, labels)
    log_fit_report(solver, _log, "timit cosine solve")
    assert_all_finite(model, "timit model")
    solve_secs = time.perf_counter() - t_solve
    del training_batches, train_data

    results: dict = {}

    def evaluator(pred):
        predicted = MaxClassifier()(pred)
        metrics = MulticlassClassifierEvaluator(predicted, test_labels, conf.num_classes)
        results["test_error"] = 100.0 * metrics.total_error
        results["test_scores"] = pred

    t_eval = time.perf_counter()
    test_data = torch.from_numpy(np.ascontiguousarray(data.test.data, np.float32)).to(dev)
    if mesh is not None:
        test_data, _ = padded_shard_rows(test_data, mesh)
    model.apply_and_evaluate([map_rows(f, test_data) for f in featurizers], evaluator)
    synchronize(dev)
    eval_secs = time.perf_counter() - t_eval
    _log.info("TEST Error is %s%%", results["test_error"])

    results["test_scores"] = results["test_scores"].cpu().numpy()
    results["seconds"] = time.perf_counter() - t0
    results.update(
        featurize_seconds=feat_secs,
        solve_seconds=solve_secs,
        eval_seconds=eval_secs,
        servable=servable_pipeline(featurizers, model),
        fit_report=solver.last_fit_report.record(),
    )
    _log.info("Pipeline took %.3f s", results["seconds"])
    return results


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("Timit")
    p.add_argument("--trainDataLocation", required=True)
    p.add_argument("--trainLabelsLocation", required=True)
    p.add_argument("--testDataLocation", required=True)
    p.add_argument("--testLabelsLocation", required=True)
    p.add_argument("--numCosines", type=int, default=50)
    p.add_argument("--numEpochs", type=int, default=5)
    p.add_argument("--gamma", type=float, default=0.05555)
    p.add_argument("--lambda", dest="lam", type=float, default=0.0)
    p.add_argument("--rfType", choices=["gaussian", "cauchy"], default="gaussian")
    p.add_argument(
        "--device", default="cuda", help="'cuda' (default; raises without a card) or 'cpu'"
    )
    add_mesh_flag(p)
    a = p.parse_args(argv)
    configure_logging()
    conf = TimitConfig(
        train_data_location=a.trainDataLocation,
        train_labels_location=a.trainLabelsLocation,
        test_data_location=a.testDataLocation,
        test_labels_location=a.testLabelsLocation,
        num_cosines=a.numCosines,
        gamma=a.gamma,
        rf_type=a.rfType,
        lam=a.lam,
        num_epochs=a.numEpochs,
        device=a.device,
    )
    resolve_device(conf.device)
    mesh = parse_mesh(a.mesh, a.device)
    t_load = time.perf_counter()
    data = timit_features_loader(
        conf.train_data_location,
        conf.train_labels_location,
        conf.test_data_location,
        conf.test_labels_location,
    )
    load_secs = time.perf_counter() - t_load
    # The frame width comes from the data (440 for TIMIT), as in the MNIST
    # workload, so any width runs.
    conf.dimension = data.train.data.shape[1]
    results = run(conf, data, mesh=mesh)
    results["load_seconds"] = load_secs
    return results


if __name__ == "__main__":
    main()
