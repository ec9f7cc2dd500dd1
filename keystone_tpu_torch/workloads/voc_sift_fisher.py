"""VOCSIFTFisher on PyTorch/CUDA (counterpart of
keystone_tpu/workloads/voc_sift_fisher.py, eager single-device path).

Flow: VOC load -> grayscale -> dense SIFT (bf16 intermediates) -> [PCA fit
or load] -> BatchPCA -> [GMM fit or load] -> FisherVector (the sufficient
statistics through the fv_stats CUDA kernel) -> vectorize / normalise /
signed sqrt / normalise -> BlockLeastSquares(4096, 1, lambda) -> per-class
scores -> 11-point MAP.  The fitted chain ``grayscale -> SIFT -> PCA ->
Fisher features -> model`` is the servable pipeline.

Run: ``python -m keystone_tpu_torch.workloads.voc_sift_fisher
--trainLocation train.tar --testLocation test.tar --labelPath labels.csv
[--streamIngest [--deviceDecode] [--decodeBackend process] [--snapshotDir DIR]
[--streamBatchSize 64]] [--mesh 8] [--device cpu]``.

``--mesh`` (``run(mesh=)``): each shape bucket's images are row-sharded
over the mesh's data slots, with the placement chosen by the placement
search (``fv_common.searched_bucket_featurize``, its record in
``results["placement"]``); SIFT, the PCA projection and the Fisher
features (K2) run slot by slot, and the block solve runs its mesh ladder.
A streamed split keeps its unsharded descriptor pass (``--autoTune``
tunes it as without a mesh).  Beside ``--mesh``, ``--autoCache`` charges
the projected descriptors per data slot against the slot budget,
``--pipelineFile`` saves the fitted bundle (replicated: the solve unshards
its model) and a later run restores it and featurizes the test split on
the mesh; ``--solveCheckpoint`` raises under a mesh as the block solve
does.

``--streamIngest`` streams each tar through ``core.ingest`` (decode of the
next chunks overlaps SIFT of this one); with ``--deviceDecode`` the host
runs only the JPEG entropy pass and the pixels are decoded on the card
(``ops.jpeg_device``, the IDCT through the idct CUDA kernel).
``--decodeBackend process`` decodes on spawned worker processes;
``--snapshotDir`` keeps the decoded chunks (``KEYSTONE_SNAPSHOT_MODE=device``:
device-format shards) so a repeat run streams them from disk.  The
snapshot key folds in the label file's identity.

``--solveCheckpoint path`` makes the block solve resumable: its state is
written after every completed block, a run that finds the state resumes
from it, and a completed fit removes it.

``--pipelineFile stem`` saves the fitted ``{pca, gmm, model}`` bundle
(``core.checkpoint``, with the test scores' output sketch as its numerics
baseline); when the checkpoint exists, the run restores it instead, loads
(or streams) no training data, fits nothing and scores the test split.
``--serve`` / ``--serveBench`` (with ``--pipelineFile``, without
``--streamIngest``) then load the bundle into the serving tier
(``workloads.serve_common``, the chain of :func:`servable_pipeline`) and
answer the images of the eager test split's most populous shape through
it (one engine serves one request shape).
"""

from __future__ import annotations

import argparse
import logging
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..core import optimize, trace
from ..core import snapshot as ksnap
from ..core.checkpoint import checkpoint_exists, load_pipeline, save_pipeline
from ..core.logging import configure_logging, stage_timer
from ..core.memory import log_fit_report
from ..core.numerics import OutputSketch
from ..core.pipeline import FunctionTransformer, Pipeline
from ..core.resilience import assert_all_finite
from ..evaluation.map import MeanAveragePrecisionEvaluator
from ..loaders.image_loaders import (
    VOC_NUM_CLASSES,
    MultiLabeledImages,
    voc_labels_map,
    voc_loader,
)
from ..ops.sift import SIFTExtractor
from ..ops.util import ClassLabelIndicatorsFromIntArrayLabels
from ..parallel.mesh import add_mesh_flag, parse_mesh
from ..solvers.block import BlockLeastSquaresEstimator, bcd_checkpoint_path
from ..solvers.gmm import GaussianMixtureModel, GaussianMixtureModelEstimator
from ..solvers.pca import BatchPCATransformer, compute_pca
from ..utils.platform import resolve_device, synchronize
from . import serve_common
from .fv_common import (
    StreamSource,
    bucket_by_shape,
    chunked,
    fisher_feature_pipeline,
    collect_autotune,
    grayscale,
    per_bucket,
    plan_pca_materialization,
    sample_columns,
    scatter_features,
    searched_bucket_featurize,
    stream_descriptor_buckets,
)

# Named: under ``python -m`` __name__ is __main__, outside the package's log handler.
_log = logging.getLogger("keystone_tpu_torch.workloads.voc_sift_fisher")

#: Images per SIFT call.  It bounds the [n, 8, Fy*4, W] intermediates (about
#: 7.5 MB per 500x375 image in f32); the descriptors do not depend on it.
SIFT_CHUNK = 32


def voc_stream_source(
    data_path: str, labels_path: str, name_prefix: str = "VOCdevkit/VOC2007/JPEGImages/",
    batch_size: int = 64, device_decode: bool = False, decode_backend: str | None = None,
    snapshot_dir: str | None = None, autotune: bool = False,
) -> StreamSource:
    """Streaming stand-in for :func:`voc_loader`: the members under
    ``name_prefix`` that the labels CSV names, labelled with their class
    lists, decoded while the device runs SIFT.  The snapshot key's extra is
    the JAX package's: the prefix and the label file's identity."""
    lm = voc_labels_map(labels_path)
    return StreamSource(
        data_path, keep=lambda name: name.startswith(name_prefix) and name in lm,
        label=lm.__getitem__, batch_size=batch_size, device_decode=device_decode,
        decode_backend=decode_backend, snapshot_dir=snapshot_dir,
        snapshot_extra=f"voc:{name_prefix}:{ksnap.file_identity(labels_path)}",
        autotune=autotune,
    )


@dataclass
class SIFTFisherConfig:
    train_location: str = ""
    test_location: str = ""
    label_path: str = ""
    lam: float = 0.5
    desc_dim: int = 80
    vocab_size: int = 256
    scale_step: int = 0
    pca_file: str | None = None
    gmm_mean_file: str | None = None
    gmm_var_file: str | None = None
    gmm_wts_file: str | None = None
    num_pca_samples: int = int(1e6)
    num_gmm_samples: int = int(1e6)
    sift_step_size: int = 3
    seed: int = 42
    device: str = "cuda"
    #: Checkpoint stem of the fitted {pca, gmm, model} bundle: saved after a
    #: fit, restored (no fit) when it exists.
    pipeline_file: str | None = None
    #: Resumable block solve: the state is written here after every
    #: completed block, an existing state is resumed, and the state is
    #: removed once the fit completes.
    solve_checkpoint: str | None = None
    #: Serving modes (core.serve via serve_common): both need
    #: ``pipeline_file`` and the eager test split.
    serve: bool = False
    serve_bench: bool = False
    serve_clients: int = 4
    serve_requests: int = 64
    #: ``--serveMesh DxM``: serve on a mesh of the device kind's devices —
    #: the checkpoint reshards onto it and every bucket runs on its slots.
    serve_mesh: str | None = None
    #: Cost-based auto-Cacher (core.optimize): whether the PCA-projected
    #: training descriptors stay whole between GMM sampling and the Fisher
    #: features, decided from a timed probe through the card's admission
    #: gate.  The decision table is ``results["cache_plan"]``.
    auto_cache: bool = False
    #: Placement search (core.autoshard): force the cost-model-ranked
    #: candidate search for the block solve (on by default via
    #: ``KEYSTONE_AUTOSHARD``); the searched table lands in
    #: ``results["placement"]`` whenever a search ran.
    auto_shard: bool = False


def make_sift(conf: SIFTFisherConfig) -> SIFTExtractor:
    """The workload's SIFT node: bf16 intermediates, as in the JAX package."""
    return SIFTExtractor(
        step_size=conf.sift_step_size, scale_step=conf.scale_step,
        compute_dtype=torch.bfloat16,
    )


def extract_sift_buckets(conf: SIFTFisherConfig, images, mesh=None,
                         placement_out: dict | None = None) -> dict:
    """Per shape bucket: grayscale + dense SIFT -> (indices, [n, 128, cols])
    on the configured device, in chunks of ``SIFT_CHUNK`` images.
    ``images`` is a list of arrays, or a :class:`StreamSource` whose tar
    is streamed (and, with ``device_decode``, decoded on the device); a
    stream keeps its unsharded pass.  With ``mesh`` the buckets are
    row-sharded with the searched placement
    (``fv_common.searched_bucket_featurize``), whose record
    ``placement_out["featurize"]`` receives."""
    dev = resolve_device(conf.device)
    sift = make_sift(conf)

    def describe(pixels: torch.Tensor) -> torch.Tensor:
        return sift(grayscale(pixels))

    if isinstance(images, StreamSource):
        # A stream chunk may hold more images than SIFT_CHUNK.
        return images.run_pass(dev, lambda st: stream_descriptor_buckets(
            st, lambda pixels: chunked(describe, pixels, SIFT_CHUNK)))
    out, placement = searched_bucket_featurize(
        "voc_sift_featurize", images, describe, dev, SIFT_CHUNK, mesh)
    if placement_out is not None and placement is not None:
        placement_out["featurize"] = placement
    return out


def fit_bundle(conf: SIFTFisherConfig, train: MultiLabeledImages,
               mesh=None) -> tuple[dict, dict]:
    """Fit PCA, the GMM and the linear model on ``train`` (over ``mesh``,
    if given: the sharded featurize and the block solve's mesh ladder).
    Returns the ``{pca, gmm, model}`` bundle and the stage seconds (each
    stage, ``sift``, ``pca``, ``gmm``, ``fisher_features``, ``solve``, a
    ``stage_timer`` span that ends after a synchronize).  With ``conf.auto_cache`` the
    seconds carry the ``cache_plan`` record; a denied materialization
    keeps the raw descriptors and projects one bucket at a time for each
    consumer, with the same bits.  Under a mesh the seconds' ``placement``
    holds the solve's record under ``"solver"`` beside the featurize's."""
    dev = resolve_device(conf.device)
    feat_dim = 2 * conf.desc_dim * conf.vocab_size

    def lap(start: float) -> float:
        synchronize(dev)
        return time.perf_counter() - start

    t = time.perf_counter()
    feat_placements: dict = {}
    with stage_timer("sift"):
        train_desc = extract_sift_buckets(conf, train.images, mesh, feat_placements)
        sift_secs = lap(t)
    train_labels = ClassLabelIndicatorsFromIntArrayLabels(VOC_NUM_CLASSES)(train.labels).to(dev)

    t = time.perf_counter()
    with stage_timer("pca"):
        if conf.pca_file is not None:
            pca_mat = np.loadtxt(conf.pca_file, delimiter=",", ndmin=2).T
            pca_mat = torch.as_tensor(np.asarray(pca_mat, np.float32), device=dev)
        else:
            samples = sample_columns(train_desc, conf.num_pca_samples, conf.seed)
            pca_mat = compute_pca(samples.T, conf.desc_dim)
            del samples
        batch_pca = BatchPCATransformer(pca_mat)
        materialize, cache_plan = True, None
        if conf.auto_cache:
            # GMM sampling (when a GMM is fitted) and the Fisher features.
            reuse = (0 if conf.gmm_mean_file is not None else 1) + 1
            cache_plan, materialize = plan_pca_materialization(
                train_desc, batch_pca, reuse, label="voc_pca_descriptors", mesh=mesh)
            _log.info("%s", cache_plan.summary())
        t_proj = time.perf_counter()
        if materialize:
            pca_desc = {shape: (idx, per_bucket(batch_pca, descs))
                        for shape, (idx, descs) in train_desc.items()}
            del train_desc
        project_secs = lap(t_proj)
        pca_secs = lap(t)

    t = time.perf_counter()
    with stage_timer("gmm"):
        if conf.gmm_mean_file is not None:
            gmm = GaussianMixtureModel.load(
                conf.gmm_mean_file, conf.gmm_var_file, conf.gmm_wts_file, device=dev
            )
        else:
            if materialize:
                gmm_samples = sample_columns(pca_desc, conf.num_gmm_samples, conf.seed + 1)
            else:
                gmm_samples = sample_columns(train_desc, conf.num_gmm_samples, conf.seed + 1,
                                             project=batch_pca)
            gmm = GaussianMixtureModelEstimator(conf.vocab_size).fit(gmm_samples.T)
            del gmm_samples
        assert_all_finite(gmm, "VOC GMM fit")
        gmm_secs = lap(t)

    t = time.perf_counter()
    with stage_timer("fisher_features"):
        fisher = fisher_feature_pipeline(gmm)
        if materialize:
            train_features = scatter_features(pca_desc, fisher, len(train), feat_dim)
            del pca_desc  # the training descriptors are no longer needed
        else:
            t_proj = time.perf_counter()
            train_features = scatter_features(
                train_desc, Pipeline([batch_pca, fisher]), len(train), feat_dim)
            project_secs += lap(t_proj)
            del train_desc
        fisher_secs = lap(t)

    # With a solve checkpoint the block fit writes its state after every
    # block and resumes from an existing one (a preempted run).
    solve_kwargs, state_path = {}, None
    if conf.solve_checkpoint is not None:
        solve_kwargs["checkpoint"] = conf.solve_checkpoint
        state_path = bcd_checkpoint_path(conf.solve_checkpoint)
        if os.path.exists(state_path):
            solve_kwargs["resume_from"] = conf.solve_checkpoint
    t = time.perf_counter()
    with stage_timer("solve"):
        solver = BlockLeastSquaresEstimator(4096, 1, conf.lam, mesh=mesh)
        model = solver.fit(
            train_features, train_labels, num_features=feat_dim,
            plan=True if conf.auto_shard else None,
            **solve_kwargs,
        )
        log_fit_report(solver, _log, "VOC SIFT-Fisher solve")
        assert_all_finite(model, "VOC block least-squares fit")
        solve_secs = lap(t)
    if state_path is not None and os.path.exists(state_path):
        # The state is for resuming, not a model cache: left behind, a later
        # run on other features would try to resume into it.
        os.unlink(state_path)
    secs = {
        "sift_seconds": sift_secs,
        "pca_seconds": pca_secs,
        "gmm_seconds": gmm_secs,
        "fisher_seconds": fisher_secs,
        "solve_seconds": solve_secs,
        # SIFT -> PCA projection -> Fisher features of the training split.
        "featurize_images_per_sec": len(train) / (sift_secs + project_secs + fisher_secs),
        "fit_report": solver.last_fit_report.record(),
    }
    if cache_plan is not None:
        secs["cache_plan"] = cache_plan.record()
    solver_placement = solver.last_fit_report.placement
    if feat_placements:
        # One home for every searched placement of the run.
        secs["placement"] = {"solver": solver_placement, **feat_placements}
    elif solver_placement is not None:
        # The searched placement table of the block solve.
        secs["placement"] = solver_placement
    return {"pca": batch_pca, "gmm": gmm, "model": model}, secs


def run(conf: SIFTFisherConfig, train: MultiLabeledImages, test: MultiLabeledImages,
        mesh=None) -> dict:
    """Fit on ``train`` (or, with an existing ``conf.pipeline_file``,
    restore the fitted bundle and never read ``train``), then score
    ``test``; with ``mesh`` the featurize of both splits is row-sharded and
    the solve runs its mesh ladder.  The results carry the fitted ``{pca,
    gmm, model}`` under ``"bundle"`` and the test scores under
    ``"test_scores"``; the test split's featurize and scoring are the
    ``eval`` stage."""
    configure_logging()
    dev = resolve_device(conf.device)
    t0 = time.perf_counter()
    restored = conf.pipeline_file is not None and checkpoint_exists(conf.pipeline_file)
    if restored:
        _log.info("restoring fitted pipeline from %s", conf.pipeline_file)
        bundle, fit_secs = load_pipeline(conf.pipeline_file, device=dev), {}
    else:
        bundle, fit_secs = fit_bundle(conf, train, mesh)
    batch_pca, gmm, model = bundle["pca"], bundle["gmm"], bundle["model"]
    fisher = fisher_feature_pipeline(gmm)
    feat_dim = 2 * gmm.dim * gmm.k  # the bundle's own width, whatever the flags say

    t = time.perf_counter()
    with stage_timer("eval"):
        test_desc = extract_sift_buckets(conf, test.images, mesh)
        test_features = scatter_features(
            test_desc, Pipeline([batch_pca, fisher]), len(test), feat_dim
        )
        del test_desc
        scores = model(test_features).cpu().numpy()
        synchronize(dev)
        eval_secs = time.perf_counter() - t

    aps = MeanAveragePrecisionEvaluator(test.labels, scores, VOC_NUM_CLASSES)
    ingest_stats = {
        split: src.stream_stats[-1].record()
        for split, src in (("train", train), ("test", test))
        if isinstance(src, StreamSource) and src.stream_stats
    }
    results = {
        "aps": aps,
        "map": float(np.mean(aps)),
        "seconds": time.perf_counter() - t0,
        **fit_secs,
        "eval_seconds": eval_secs,
        "test_scores": scores,
        "test_filenames": list(test.filenames),
        "bundle": bundle,
    }
    if restored:
        results["restored"] = True
    elif conf.pipeline_file is not None:
        # The test scores' distribution rides the manifest as the reference
        # a serving tier's drift monitor judges answers against.
        save_pipeline(
            conf.pipeline_file, bundle,
            numerics_baseline=OutputSketch.for_outputs(scores).record(),
        )
        _log.info("saved fitted pipeline to %s", conf.pipeline_file)
    if ingest_stats:
        results["ingest"] = ingest_stats
    autotune = collect_autotune(train, test)
    if autotune:
        results["autotune"] = autotune
        _log.info("ingest autotune: %s", autotune)
    _maybe_serve(conf, test, results)
    _log.info("TEST APs are: %s", ",".join(str(a) for a in aps))
    _log.info("TEST MAP is: %s", results["map"])
    _log.info("Pipeline took %.3f s", results["seconds"])
    return results


def servable_pipeline(conf: SIFTFisherConfig, bundle: dict) -> Pipeline:
    """The fitted apply chain: grayscale -> dense SIFT -> BatchPCA -> Fisher
    features -> per-class scores, over [n, H, W, 3] BGR images on the
    bundle's device."""
    return Pipeline([
        FunctionTransformer(grayscale, name="grayscale"),
        make_sift(conf),
        bundle["pca"],
        fisher_feature_pipeline(bundle["gmm"]),
        bundle["model"],
    ])


def _maybe_serve(conf: SIFTFisherConfig, test, results: dict) -> None:
    """``--serve`` / ``--serveBench``: the saved bundle behind the serving
    tier, answering images of the eager test split's most populous shape
    bucket."""
    if not (conf.serve or conf.serve_bench):
        return
    serve_common.require_pipeline_file(conf.pipeline_file)
    images = getattr(test, "images", None)
    if isinstance(images, StreamSource) or not hasattr(images, "__len__"):
        raise ValueError(
            "serving draws requests from the EAGER test split — run "
            "--serve/--serveBench without --streamIngest"
        )
    buckets = bucket_by_shape(images)
    _shape, (_idx, batch) = max(buckets.items(), key=lambda kv: len(kv[1][0]))
    requests = np.asarray(batch, np.float32)[: conf.serve_requests]
    record = serve_common.serve_fitted(
        conf.pipeline_file,
        np.empty(requests.shape[1:], np.float32),
        requests,
        label="voc_sift_fisher",
        wrap=lambda bundle: servable_pipeline(conf, bundle),
        bench=conf.serve_bench,
        clients=conf.serve_clients,
        device=conf.device,
        mesh=serve_common.resolve_serve_mesh(conf.serve_mesh, conf.device),
    )
    record["request_shape"] = list(requests.shape[1:])
    record["shape_buckets_total"] = len(buckets)
    results["serving"] = record


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("VOCSIFTFisher")
    p.add_argument("--trainLocation", required=True)
    p.add_argument("--testLocation", required=True)
    p.add_argument("--labelPath", required=True)
    p.add_argument("--lambda", dest="lam", type=float, default=0.5)
    p.add_argument("--descDim", type=int, default=80)
    p.add_argument("--vocabSize", type=int, default=256)
    p.add_argument("--scaleStep", type=int, default=0)
    p.add_argument("--pcaFile", default=None)
    p.add_argument("--gmmMeanFile", default=None)
    p.add_argument("--gmmVarFile", default=None)
    p.add_argument("--gmmWtsFile", default=None)
    p.add_argument("--numPcaSamples", type=int, default=int(1e6))
    p.add_argument("--numGmmSamples", type=int, default=int(1e6))
    p.add_argument(
        "--streamIngest", action="store_true",
        help="stream each tar through core.ingest: decode WHILE the device runs SIFT",
    )
    p.add_argument(
        "--streamBatchSize", type=int, default=64,
        help="images per streamed chunk (--streamIngest only)",
    )
    p.add_argument(
        "--deviceDecode", action="store_true",
        help="with --streamIngest: host entropy pass only, pixels decoded on the device",
    )
    p.add_argument(
        "--decodeBackend", default=None, choices=("thread", "process"),
        help="with --streamIngest: host decode on the thread pool or on spawned worker "
        "processes (KEYSTONE_DECODE_BACKEND)",
    )
    p.add_argument(
        "--snapshotDir", default=None,
        help="with --streamIngest: snapshot root; the first pass writes the decoded chunks "
        "(device-format shards under KEYSTONE_SNAPSHOT_MODE=device), a repeat run reads "
        "them (KEYSTONE_SNAPSHOT_DIR)",
    )
    p.add_argument(
        "--autoCache", action="store_true",
        help="cost-based auto-Cacher (core.optimize): keep the PCA-projected training "
        "descriptors whole, or re-project per consumer, decided from a timed probe through "
        "the card's admission gate (env KEYSTONE_AUTOCACHE=1)",
    )
    p.add_argument(
        "--autoTune", action="store_true",
        help="with --streamIngest: the closed-loop ingest autotuner retunes decode width, "
        "decode-ahead, ring depth and the decode backend from the stall counters",
    )
    p.add_argument(
        "--autoShard", action="store_true",
        help="placement search (core.autoshard): force the cost-model "
        "ranked mesh/strategy candidate search for the block solve and "
        "record the searched plan in results['placement'] (on by "
        "default; KEYSTONE_AUTOSHARD=0 disables it except here)",
    )
    p.add_argument(
        "--pipelineFile", default=None,
        help="checkpoint stem of the fitted {pca, gmm, model} bundle: saved after "
        "a fit, restored without a fit when it exists",
    )
    p.add_argument(
        "--solveCheckpoint", default=None,
        help="resumable block-solve state: written after every completed block, "
        "resumed when it exists, removed once the fit completes",
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
    for flag in ("deviceDecode", "decodeBackend", "snapshotDir", "autoTune"):
        if getattr(a, flag) and not a.streamIngest:
            p.error(f"--{flag} needs --streamIngest")
    if a.trace:
        trace.enable(a.trace)
    configure_logging()
    conf = SIFTFisherConfig(
        train_location=a.trainLocation,
        test_location=a.testLocation,
        label_path=a.labelPath,
        lam=a.lam,
        desc_dim=a.descDim,
        vocab_size=a.vocabSize,
        scale_step=a.scaleStep,
        pca_file=a.pcaFile,
        gmm_mean_file=a.gmmMeanFile,
        gmm_var_file=a.gmmVarFile,
        gmm_wts_file=a.gmmWtsFile,
        num_pca_samples=a.numPcaSamples,
        num_gmm_samples=a.numGmmSamples,
        device=a.device,
        pipeline_file=a.pipelineFile,
        solve_checkpoint=a.solveCheckpoint,
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

    def load(path: str):
        if a.streamIngest:
            return voc_stream_source(path, conf.label_path, batch_size=a.streamBatchSize,
                                     device_decode=a.deviceDecode,
                                     decode_backend=a.decodeBackend,
                                     snapshot_dir=a.snapshotDir, autotune=a.autoTune)
        return voc_loader(path, conf.label_path)

    try:
        # A restored run never reads (or streams) the training split.
        train = MultiLabeledImages([], [], []) if restoring else load(conf.train_location)
        return run(conf, train, load(conf.test_location), mesh=mesh)
    finally:
        if a.trace:
            trace.flush()


if __name__ == "__main__":
    main()
