"""MnistRandomFFT on PyTorch/CUDA (counterpart of
keystone_tpu/workloads/mnist_random_fft.py, eager single-device path).

Flow: CSV load (labels 1-indexed in column 0) -> per FFT group,
blockSize/512 chains of RandomSignNode -> PaddedFFT -> LinearRectifier(0)
(cuFFT on the card) -> ZipVectors within the group ->
BlockLeastSquares(blockSize, 1 pass, lambda) on the list of group batches
-> streaming evaluation after every block on the train split, then on the
test split (the last call sees the full model) -> MaxClassifier ->
MulticlassClassifierEvaluator.  The fitted chain
``GroupConcatFeaturizer(groups) >> model >> MaxClassifier`` is the
servable pipeline.  ``--solveCheckpoint path`` writes the block solve's
state after every completed block and ``--resumeFrom path`` resumes an
interrupted fit from it (``BlockLeastSquaresEstimator.fit(checkpoint=,
resume_from=)``).  ``--pipelineFile stem`` saves it (``core.checkpoint``,
with the test predictions' output sketch as its numerics baseline); when
the checkpoint exists, the run restores it instead, loads no training
data, fits nothing and scores the test split.  ``--serve`` /
``--serveBench`` (with ``--pipelineFile``) then load the chain into the
serving tier (``workloads.serve_common``) and answer test rows through it.
``--mesh`` row-shards both splits over the mesh's data axis (the features
are row-wise, and zero pad rows stay zero through them) and solves over the
mesh (``BlockLeastSquaresEstimator(mesh=)``); beside it ``--autoCache``
charges the row-sharded feature batches per data slot against the slot
budget, and ``--pipelineFile`` saves the servable chain, which a later run
restores and scores on one device.

Run: ``python -m keystone_tpu_torch.workloads.mnist_random_fft
--trainLocation train.csv --testLocation test.csv [--device cpu]``.
"""

from __future__ import annotations

import argparse
import logging
import math
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..core import optimize, trace
from ..core.checkpoint import checkpoint_exists, load_pipeline, save_pipeline
from ..core.logging import configure_logging, stage_timer
from ..core.memory import log_fit_report
from ..core.numerics import OutputSketch
from ..core.pipeline import Pipeline, Transformer
from ..core.resilience import assert_all_finite
from ..evaluation.multiclass import MulticlassClassifierEvaluator
from ..loaders.csv_loader import LabeledData, csv_data_loader
from ..ops.stats import LinearRectifier, PaddedFFT, RandomSignNode
from ..ops.util import (
    ClassLabelIndicatorsFromIntLabels,
    GroupConcatFeaturizer,
    MaxClassifier,
    ZipVectors,
)
from ..parallel.mesh import add_mesh_flag, map_rows, padded_shard_rows, parse_mesh
from ..solvers.block import BlockLeastSquaresEstimator, BlockLinearMapper
from ..utils.platform import resolve_device, synchronize
from . import serve_common

# Named: under ``python -m`` __name__ is __main__, outside the package's log handler.
_log = logging.getLogger("keystone_tpu_torch.workloads.mnist_random_fft")


@dataclass
class MnistRandomFFTConfig:
    train_location: str = ""
    test_location: str = ""
    num_ffts: int = 200
    block_size: int = 2048
    lam: float | None = None
    seed: int = 0
    mnist_image_size: int = 784
    num_classes: int = 10
    device: str = "cuda"
    #: Checkpoint stem of the fitted servable chain: saved after a fit,
    #: restored (no fit) when it exists.
    pipeline_file: str | None = None
    #: Resumable block solve, forwarded to
    #: ``BlockLeastSquaresEstimator.fit(checkpoint=, resume_from=)``: a path
    #: (the state written after every completed block) or a callback, and a
    #: path or state to resume an interrupted fit from.
    solve_checkpoint: object = None
    solve_resume: object = None
    #: Serving modes (core.serve via serve_common): both need
    #: ``pipeline_file`` and draw requests from the test split.
    serve: bool = False
    serve_bench: bool = False
    serve_clients: int = 4
    serve_requests: int = 256
    #: ``--serveMesh DxM``: serve on a mesh of the device kind's devices —
    #: the checkpoint reshards onto it and every bucket runs on its slots.
    serve_mesh: str | None = None
    #: Cost-based auto-Cacher (core.optimize): whether the featurized
    #: training batches stay resident from the solve to the train-split
    #: eval, decided from the measured featurize seconds and their bytes
    #: through the card's admission gate; denied, they are freed after the
    #: solve and rebuilt at eval (the same bits).  The decision table is
    #: ``results["cache_plan"]``.
    auto_cache: bool = False
    #: Placement search (core.autoshard): force the cost-model-ranked
    #: candidate search for the block solve (on by default via
    #: ``KEYSTONE_AUTOSHARD``); the searched table lands in
    #: ``results["placement"]`` whenever a search ran.
    auto_shard: bool = False
    #: Placement override handed to the solve's ``fit(plan=...)`` ahead of
    #: ``auto_shard``: False the hand ladder, True the search, a
    #: ``PlacementPlan`` or a list of candidate names replays that ranking
    #: (a spec candidate's name forces its layout to the head).
    solve_plan: object = None


def fft_chain(signs) -> Pipeline:
    """One random-FFT feature chain with the given ±1 signs."""
    return Pipeline([RandomSignNode(signs), PaddedFFT(), LinearRectifier(0.0)])


def build_featurizer_batches(conf: MnistRandomFFTConfig, device) -> list[list[Pipeline]]:
    """The FFT groups: ceil(numFFTs / (blockSize/512)) groups of
    blockSize/512 chains on ``device``, signs drawn from one generator
    seeded with ``conf.seed``."""
    dev = resolve_device(device)
    ffts_per_batch = conf.block_size // 512
    num_fft_batches = math.ceil(conf.num_ffts / ffts_per_batch)
    gen = torch.Generator().manual_seed(conf.seed)
    return [
        [
            fft_chain(RandomSignNode.create(conf.mnist_image_size, gen, dev).signs)
            for _ in range(ffts_per_batch)
        ]
        for _ in range(num_fft_batches)
    ]


class _Group(Transformer):
    """One FFT group: its chains on the batch, zipped."""

    def __init__(self, chains):
        self.chains = chains

    def __call__(self, data):
        return ZipVectors.apply([chain(data) for chain in self.chains])


def featurize_groups(groups, data) -> list:
    """One [n, group width] feature batch per group; on row-sharded data,
    row-sharded batches (slot by slot)."""
    return [map_rows(_Group(chains), data) for chains in groups]


def servable_pipeline(groups, model: BlockLinearMapper) -> Pipeline:
    return Pipeline([GroupConcatFeaturizer(groups), model, MaxClassifier()])


def run(conf: MnistRandomFFTConfig, train: LabeledData, test: LabeledData, mesh=None,
        groups=None) -> dict:
    """Fit on ``train``, evaluate on ``train`` and ``test`` block by block.
    With ``mesh`` both splits are row-sharded over its data axis and the
    block solve runs its mesh ladder.  ``groups``: the FFT groups to use in
    place of drawing them (the tests carry the JAX package's signs across).
    The results carry the fitted servable pipeline under ``"servable"``.
    Each stage is a ``stage_timer`` span that ends after a synchronize."""
    configure_logging()
    dev = resolve_device(conf.device)
    t0 = time.perf_counter()
    if conf.pipeline_file is not None and checkpoint_exists(conf.pipeline_file):
        return _run_restored(conf, test, t0)
    if groups is None:
        groups = build_featurizer_batches(conf, dev)
    train_labels = torch.from_numpy(np.asarray(train.labels)).to(dev)
    test_labels = torch.from_numpy(np.asarray(test.labels)).to(dev)
    labels = ClassLabelIndicatorsFromIntLabels(conf.num_classes)(train_labels)
    train_data = torch.from_numpy(np.ascontiguousarray(train.data, np.float32)).to(dev)
    test_data = torch.from_numpy(np.ascontiguousarray(test.data, np.float32)).to(dev)
    if mesh is not None:
        train_data, _ = padded_shard_rows(train_data, mesh)
        test_data, _ = padded_shard_rows(test_data, mesh)
    # One group on the whole split first, so the clock below reads steady
    # state: cuFFT plans its transform for each batch size on first use.
    featurize_groups(groups[:1], train_data)
    synchronize(dev)

    t_feat = time.perf_counter()
    with stage_timer("featurize"):
        training_batches = featurize_groups(groups, train_data)
        synchronize(dev)
    feat_secs = time.perf_counter() - t_feat

    cache_plan = None
    keep_features = True
    if conf.auto_cache:
        # The featurized training batches are consumed twice: the block
        # solve, then the train-split eval.
        cache_plan = optimize.plan_caches(
            [optimize.CacheCandidate(
                index=0, name="fft_features", seconds=feat_secs,
                output_bytes=sum(int(b.nbytes) for b in training_batches), reuse=2,
            )],
            dataset_rows=len(train.labels),
            mesh=mesh,
        )
        keep_features = cache_plan.decisions[0].cached
        _log.info("%s", cache_plan.summary())

    t_solve = time.perf_counter()
    with stage_timer("solve"):
        solver = BlockLeastSquaresEstimator(conf.block_size, 1, conf.lam or 0.0, mesh=mesh)
        model = solver.fit(
            training_batches, labels, checkpoint=conf.solve_checkpoint,
            resume_from=conf.solve_resume,
            plan=(conf.solve_plan if conf.solve_plan is not None
                  else True if conf.auto_shard else None),
        )
        log_fit_report(solver, _log, "mnist random-fft solve")
        assert_all_finite(model, "mnist random-fft model")
    solve_secs = time.perf_counter() - t_solve
    if not keep_features:
        # Residency priced above a recompute: free the batches through the
        # solve-to-eval gap and rebuild them at eval.
        training_batches = None

    results: dict = {}
    if cache_plan is not None:
        results["cache_plan"] = cache_plan.record()
    if solver.last_fit_report.placement is not None:
        # The searched placement table: candidates, deny/score rationale,
        # the chosen plan's predicted-vs-measured cost.
        results["placement"] = solver.last_fit_report.placement

    def train_eval(pred):
        metrics = MulticlassClassifierEvaluator(
            MaxClassifier()(pred), train_labels, conf.num_classes
        )
        results["train_error"] = 100.0 * metrics.total_error

    def test_eval(pred):
        predicted = MaxClassifier()(pred)
        metrics = MulticlassClassifierEvaluator(predicted, test_labels, conf.num_classes)
        results["test_error"] = 100.0 * metrics.total_error
        results["test_predictions"] = predicted

    # Streaming evaluation after each block; the last call sees the full model.
    t_eval = time.perf_counter()
    with stage_timer("eval"):
        if training_batches is None:
            training_batches = featurize_groups(groups, train_data)
        model.apply_and_evaluate(training_batches, train_eval)
        _log.info("Train Error is %s%%", results["train_error"])
        del training_batches
        test_batches = featurize_groups(groups, test_data)
        model.apply_and_evaluate(test_batches, test_eval)
        _log.info("TEST Error is %s%%", results["test_error"])
        synchronize(dev)
    eval_secs = time.perf_counter() - t_eval

    results["test_predictions"] = results["test_predictions"].cpu().numpy()
    results["seconds"] = time.perf_counter() - t0
    results.update(
        featurize_seconds=feat_secs,
        featurize_examples_per_sec=len(train.labels) / feat_secs,
        solve_seconds=solve_secs,
        eval_seconds=eval_secs,
        servable=servable_pipeline(groups, model),
        fit_report=solver.last_fit_report.record(),
    )
    if conf.pipeline_file is not None:
        save_pipeline(
            conf.pipeline_file, results["servable"],
            numerics_baseline=OutputSketch.for_outputs(results["test_predictions"]).record(),
        )
        _log.info("saved fitted servable pipeline to %s", conf.pipeline_file)
    _log.info("Pipeline took %.3f s", results["seconds"])
    _maybe_serve(conf, test, results)
    return results


def _run_restored(conf: MnistRandomFFTConfig, test: LabeledData, t0: float) -> dict:
    """Score the test split with the restored servable chain: no
    featurize of the training split and no solve."""
    _log.info("restoring fitted servable pipeline from %s", conf.pipeline_file)
    dev = resolve_device(conf.device)
    servable = load_pipeline(conf.pipeline_file, device=dev)
    with stage_timer("eval"):
        test_data = torch.from_numpy(np.ascontiguousarray(test.data, np.float32)).to(dev)
        predicted = servable(test_data)
        test_labels = torch.from_numpy(np.asarray(test.labels)).to(dev)
        metrics = MulticlassClassifierEvaluator(predicted, test_labels, conf.num_classes)
        synchronize(dev)
    results = {
        "restored": True,
        "test_error": 100.0 * metrics.total_error,
        "test_predictions": predicted.cpu().numpy(),
        "servable": servable,
    }
    _log.info("TEST Error is %s%% (restored pipeline)", results["test_error"])
    _maybe_serve(conf, test, results)
    results["seconds"] = time.perf_counter() - t0
    return results


def _maybe_serve(conf: MnistRandomFFTConfig, test: LabeledData, results: dict) -> None:
    """``--serve`` / ``--serveBench``: the saved servable chain behind the
    serving tier, answering rows of the test split."""
    if not (conf.serve or conf.serve_bench):
        return
    serve_common.require_pipeline_file(conf.pipeline_file)
    requests = np.asarray(test.data[: conf.serve_requests], np.float32)
    results["serving"] = serve_common.serve_fitted(
        conf.pipeline_file,
        np.empty((requests.shape[1],), np.float32),
        requests,
        label="mnist_random_fft",
        bench=conf.serve_bench,
        clients=conf.serve_clients,
        device=conf.device,
        mesh=serve_common.resolve_serve_mesh(conf.serve_mesh, conf.device),
    )


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("MnistRandomFFT")
    p.add_argument("--trainLocation", required=True, help="CSV, 1-indexed label in column 0")
    p.add_argument("--testLocation", required=True, help="CSV, 1-indexed label in column 0")
    p.add_argument("--numFFTs", type=int, default=200)
    p.add_argument("--blockSize", type=int, default=2048)
    p.add_argument("--lambda", dest="lam", type=float, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--pipelineFile", default=None,
        help="checkpoint stem of the fitted servable chain (FFT groups + model + "
        "classifier): saved after a fit, restored without a fit when it exists",
    )
    p.add_argument(
        "--solveCheckpoint", default=None,
        help="path of the resumable block-solve state, written atomically after every "
        "completed block (the stepwise tier)",
    )
    p.add_argument(
        "--resumeFrom", default=None,
        help="block-solve state to resume an interrupted fit from",
    )
    p.add_argument(
        "--autoCache", action="store_true",
        help="cost-based auto-Cacher (core.optimize): keep the featurized training batches "
        "from the solve to the eval, or rebuild them, decided from the measured featurize "
        "time and their bytes through the card's admission gate (env KEYSTONE_AUTOCACHE=1)",
    )
    p.add_argument(
        "--autoShard", action="store_true",
        help="placement search (core.autoshard): force the cost-model "
        "ranked mesh/strategy candidate search for the block solve and "
        "record the searched plan in results['placement'] (on by "
        "default; KEYSTONE_AUTOSHARD=0 disables it except here)",
    )
    p.add_argument(
        "--trace", default=None, metavar="PATH",
        help="write a Chrome-trace JSON (.jsonl for the JSONL event log) of the run",
    )
    p.add_argument(
        "--device", default="cuda", help="'cuda' (default; raises without a card) or 'cpu'"
    )
    add_mesh_flag(p)
    serve_common.add_serve_args(p)
    a = p.parse_args(argv)
    serve_common.check_serve_args(a)
    if a.blockSize <= 0 or a.blockSize % 512 != 0:
        p.error("--blockSize must be a positive multiple of 512")
    if a.trace:
        trace.enable(a.trace)
    configure_logging()
    conf = MnistRandomFFTConfig(
        train_location=a.trainLocation,
        test_location=a.testLocation,
        num_ffts=a.numFFTs,
        block_size=a.blockSize,
        lam=a.lam,
        seed=a.seed,
        device=a.device,
        pipeline_file=a.pipelineFile,
        solve_checkpoint=a.solveCheckpoint,
        solve_resume=a.resumeFrom,
        serve=a.serve,
        serve_bench=a.serveBench,
        serve_clients=a.serveClients,
        serve_requests=a.serveRequests,
        serve_mesh=a.serveMesh,
        auto_cache=a.autoCache or optimize.auto_cache_env(),
        auto_shard=a.autoShard,
    )
    resolve_device(conf.device)
    mesh = parse_mesh(a.mesh, a.device)
    restoring = a.pipelineFile is not None and checkpoint_exists(a.pipelineFile)
    try:
        t_load = time.perf_counter()
        with stage_timer("load"):
            test = LabeledData.from_rows(csv_data_loader(conf.test_location), one_indexed=True)
            # A restored run never reads the training split.
            train = None if restoring else LabeledData.from_rows(
                csv_data_loader(conf.train_location), one_indexed=True
            )
        load_secs = time.perf_counter() - t_load
        # The reference fixes 784 pixels; the width comes from the data
        # here, as in the JAX package, so any pixel count runs.
        conf.mnist_image_size = test.data.shape[1]
        results = run(conf, train, test, mesh=mesh)
        results["load_seconds"] = load_secs
        return results
    finally:
        if a.trace:
            trace.flush()


if __name__ == "__main__":
    main()
