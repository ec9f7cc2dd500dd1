"""RandomPatchCifar on PyTorch/CUDA (counterpart of
keystone_tpu/workloads/cifar_random_patch.py, eager single-device path).

Flow: CIFAR load -> random patch extraction (Windower -> ImageVectorizer ->
Sampler) -> normalize_rows -> ZCA whitener fit -> whitened, renormalised
random filters -> FusedConvFeaturizer (patch-normalised conv -> symmetric
rectify -> sum-pool, the pool through the rect+pool CUDA kernel) ->
StandardScaler -> BlockLeastSquares(4096, 1, lambda) -> MaxClassifier ->
MulticlassClassifierEvaluator.  The fitted chain
``[featurizer, scaler, model, MaxClassifier]`` is the servable pipeline.

The splits load from CIFAR binaries or from JPEG tars of
``"<label>/img.jpg"`` members (images of at least ``MIN_DIM`` = 36 px a
side, so CIFAR-style tars hold 48 px images).  ``--streamTestTar`` scores
the test split straight from a tar through ``core.ingest`` (decode of the
next chunk overlaps the featurize of this one); with ``--deviceDecode`` the
host runs only the entropy pass and the pixels are born on the card
(``decode_pixels``, the K3 kernel) before the fused featurizer (K1).
``--streamTrainTar`` decodes the train split through the same stream, bit
for bit the eager tar loader's images.  ``--decodeBackend process`` decodes
on spawned worker processes.  ``--snapshotDir`` keeps what a stream made on
disk (``core.snapshot``): decoded chunks, device-format shards under
``KEYSTONE_SNAPSHOT_MODE=device``, or for the test split under
``featurized`` the conv features, keyed by the fitted featurizer's digest,
so a repeat run neither decodes nor featurizes the test tar.
``--trace out.json`` writes the run's stage and ingest spans as a Chrome
trace.  ``--pipelineFile stem`` saves the fitted servable chain
(``core.checkpoint``, with the test predictions' output sketch as its
numerics baseline); when the checkpoint exists, the run restores it
instead, loads no training data, fits nothing and scores the eager test
split in featurize chunks.  ``--serve`` / ``--serveBench`` (with
``--pipelineFile``) then load the chain into the serving tier
(``workloads.serve_common``: per-bucket CUDA graphs on the card) and answer
requests drawn from the eager test split.

``--mesh 8`` / ``--mesh 4x2`` (``parallel.mesh.parse_mesh``: distinct
devices of the ``--device`` kind) shards the rows of both splits over the
mesh's data axis: every slot featurizes its own rows in chunks of
``featurize_chunk / data`` (one K1 launch per slot and chunk), the scaler's
moments and the block solve reduce over the data axis, and the solve runs
the block solver's mesh ladder.  Filter learning stays on ``--device``, as
the reference's driver-local ZCA fit.  Beside ``--mesh``, ``--autoCache``
profiles the row-sharded featurize and charges its cache per data slot
(the ``Pipeline`` runs the scaler on the cached rows slot by slot),
``--pipelineFile`` saves the servable chain (replicated: the solve
unshards its model), which a later run restores and scores on one device,
and ``--autoTune`` tunes the streamed test split, which keeps its
unsharded pass.

Run: ``python -m keystone_tpu_torch.workloads.cifar_random_patch
--trainLocation train.bin --testLocation test.bin [--device cpu]``.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..core import snapshot as ksnap
from ..core import optimize, trace
from ..core.checkpoint import checkpoint_exists, load_pipeline, save_pipeline
from ..core.ingest import StreamConfig, stream_batches
from ..core.logging import configure_logging, stage_timer
from ..core.memory import log_fit_report
from ..core.numerics import OutputSketch
from ..core.pipeline import FunctionTransformer, Pipeline, Transformer
from ..core.resilience import assert_all_finite, counters
from ..evaluation.multiclass import MulticlassClassifierEvaluator
from ..loaders.cifar import LabeledImageBatch, cifar_loader
from ..loaders.image_loaders import _iter_tar_images
from ..ops.conv_fused import FusedConvFeaturizer
from ..ops.images import ImageVectorizer, Windower
from ..ops.stats import Sampler, StandardScaler
from ..ops.util import ClassLabelIndicatorsFromIntLabels, MaxClassifier
from ..parallel.mesh import (
    DATA_AXIS,
    add_mesh_flag,
    map_rows,
    padded_shard_rows,
    parse_mesh,
    unshard,
)
from ..solvers.block import BlockLeastSquaresEstimator
from ..solvers.whitening import ZCAWhitener, ZCAWhitenerEstimator
from ..utils.platform import resolve_device, synchronize
from ..utils.stats import normalize_rows
from . import serve_common
from .fv_common import stream_config_from_flags, stream_features_snapshot

# Named: under ``python -m`` __name__ is __main__, outside the package's log handler.
_log = logging.getLogger("keystone_tpu_torch.workloads.cifar_random_patch")


@dataclass
class RandomCifarConfig:
    train_location: str = ""
    test_location: str = ""
    num_filters: int = 100
    patch_size: int = 6
    patch_steps: int = 1
    pool_size: int = 14
    pool_stride: int = 13
    alpha: float = 0.25
    lam: float | None = None
    sample_frac: float | None = None
    seed: int = 42
    num_classes: int = 10
    image_size: int = 32
    num_channels: int = 3
    whitener_size: int = 100000
    featurize_chunk: int = 2048
    device: str = "cuda"
    #: Resumable block solve, forwarded to
    #: ``BlockLeastSquaresEstimator.fit(checkpoint=, resume_from=)``: a path
    #: or callback for the per-block state, and a path or state to resume
    #: from (no CLI flag, as in the JAX package).
    solve_checkpoint: object = None
    solve_resume: object = None
    #: Score the test split from this JPEG tar through ``core.ingest``
    #: (labels from the member names, "<label>/x.jpg") instead of the
    #: eagerly loaded ``test`` batch.
    stream_test_tar: str | None = None
    #: With ``stream_test_tar``: the host runs the entropy pass only and
    #: the pixels are decoded on the device, straight into the featurizer.
    device_decode: bool = False
    #: Host decode backend of the streams ("thread" / "process"); None
    #: defers to ``KEYSTONE_DECODE_BACKEND``.
    decode_backend: str | None = None
    #: Snapshot root of the streams (``core.snapshot``); None defers to
    #: ``KEYSTONE_SNAPSHOT_DIR``.
    snapshot_dir: str | None = None
    #: Checkpoint stem of the fitted servable chain: saved after a fit,
    #: restored (no fit) when it exists.
    pipeline_file: str | None = None
    #: Serving modes (core.serve via serve_common); both need
    #: ``pipeline_file`` and draw requests from the eager test split.
    serve: bool = False
    serve_bench: bool = False
    serve_clients: int = 4
    serve_requests: int = 256
    #: ``--serveMesh DxM``: serve on a mesh of the device kind's devices —
    #: the checkpoint reshards onto it and every bucket runs on its slots.
    serve_mesh: str | None = None
    #: Cost-based auto-Cacher (core.optimize) on the conv featurizer of the
    #: ``featurize then StandardScaler`` chain: fitting pushes the images
    #: through it once and applying the fitted chain again, so a memoizing
    #: Cacher is inserted when the measured recompute beats the cost of
    #: holding the features.  The decision table is ``results["cache_plan"]``.
    auto_cache: bool = False
    #: The closed-loop ingest autotuner on the ``stream_test_tar`` stream;
    #: its record is ``results["autotune"]``.
    auto_tune: bool = False
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


def learn_filters(
    conf: RandomCifarConfig, train_images: np.ndarray
) -> tuple[torch.Tensor, ZCAWhitener]:
    """Patch sampling + ZCA + filter construction.

    Returns (filters [F, ps*ps*C], whitener)."""
    dev = resolve_device(conf.device)
    n, h, w, _ = train_images.shape
    ppi = ((h - conf.patch_size) // conf.patch_steps + 1) * (
        (w - conf.patch_size) // conf.patch_steps + 1
    )
    # Oversample 4x the requested patch count from a random image subset.
    need_imgs = min(n, max(1, -(-4 * conf.whitener_size // ppi)))
    rng = np.random.default_rng(conf.seed)
    img_idx = rng.permutation(n)[:need_imgs]
    subset = torch.from_numpy(np.ascontiguousarray(train_images[img_idx])).to(dev)

    patches = Windower(conf.patch_steps, conf.patch_size)(subset)
    patch_vecs = ImageVectorizer()(patches)
    sampled = Sampler(conf.whitener_size, conf.seed)(patch_vecs)

    base_filter_mat = normalize_rows(sampled, 10.0)
    whitener = ZCAWhitenerEstimator().fit_single(base_filter_mat)

    sample_filters = Sampler(conf.num_filters, conf.seed + 1)(base_filter_mat)
    unnorm = whitener(sample_filters)
    two_norms = torch.linalg.norm(unnorm, dim=1, keepdim=True)
    filters = (unnorm / (two_norms + 1e-10)) @ whitener.whitener.T
    return filters, whitener


def build_conv_pipeline(
    conf: RandomCifarConfig, filters, whitener: ZCAWhitener
) -> Pipeline:
    """Convolver -> SymmetricRectifier -> Pooler -> ImageVectorizer, as the
    fused compact-activation featurizer."""
    return Pipeline(
        [
            FusedConvFeaturizer(
                filters,
                whitener_means=whitener.means,
                pool_stride=conf.pool_stride,
                pool_size=conf.pool_size,
                alpha=conf.alpha,
                normalize_patches=True,
                img_channels=conf.num_channels,
                device=conf.device,
            )
        ]
    )


def _chunks(images, chunk: int, device: torch.device):
    """Yield (device block padded to ``chunk`` rows, true row count) from a
    host array or a tensor of images."""
    for i in range(0, images.shape[0], chunk):
        block = images[i : i + chunk]
        rows = block.shape[0]
        if not isinstance(block, torch.Tensor):
            block = torch.from_numpy(np.ascontiguousarray(block, np.float32))
        if rows < chunk:
            block = torch.nn.functional.pad(block, (0, 0, 0, 0, 0, 0, 0, chunk - rows))
        yield block.to(device), rows


class ChunkedFeaturizer(Transformer):
    """``fn`` over fixed-size chunks of its rows (the tail padded), so the
    conv activations never exceed one chunk's footprint on the device."""

    def __init__(self, fn, chunk: int, device):
        self.fn, self.chunk, self.device = fn, chunk, torch.device(device)

    def __call__(self, images):
        return torch.cat([self.fn(b)[:rows] for b, rows in _chunks(images, self.chunk, self.device)])


def featurize_chunked(fn, images: np.ndarray, chunk: int, device, mesh=None):
    """Run ``fn`` over fixed-size chunks (the tail padded) so the conv
    activations never exceed one chunk's footprint on the device.

    With ``mesh``: the images are row-sharded over the data axis and every
    slot runs ``fn`` over its own rows in chunks of ``chunk / data`` rows
    (rounded up), so one chunk of the unsharded pass is one chunk on each
    slot.  Returns the features as ``ShardedRows``, pad rows zero."""
    if mesh is None:
        return ChunkedFeaturizer(fn, chunk, device)(images)
    rows, _ = padded_shard_rows(np.asarray(images, np.float32), mesh)
    per_slot = -(-chunk // mesh.shape[DATA_AXIS])
    return map_rows(ChunkedFeaturizer(fn, per_slot, device), rows)


def cifar_tar_label(name: str) -> int:
    """Class id from a tar member's leading directory ("<label>/img.jpg")."""
    return int(name.split("/", 1)[0])


def _empty_batch() -> LabeledImageBatch:
    return LabeledImageBatch(np.zeros((0, 1, 1, 3), np.float32), np.zeros(0, np.int32))


def cifar_tar_loader(path: str) -> LabeledImageBatch:
    """Eager CIFAR-from-JPEG-tar loader ("<label>/img.jpg" members, images
    of at least ``MIN_DIM`` px): threaded host decode in member order,
    labels parsed from the member names; undecodable members are counted
    ``corrupt_image`` and skipped."""
    pairs = list(_iter_tar_images(path))
    if not pairs:
        return _empty_batch()
    return LabeledImageBatch(
        np.stack([img for _, img in pairs]),
        np.asarray([cifar_tar_label(n) for n, _ in pairs], np.int32),
    )


def cifar_tar_stream_loader(
    path: str, *, batch: int = 256, config: StreamConfig | None = None
) -> LabeledImageBatch:
    """Streamed counterpart of :func:`cifar_tar_loader`: the images decode
    through ``core.ingest`` (overlapped decode pool, corrupt members
    skipped and counted) and scatter back to stream-ordinal (tar member)
    order, so the result equals the eager loader's bit for bit.  Filter
    learning needs host-resident pixels, so ``decode_mode="device"`` is
    pinned to host decode and counted ``device_decode_unsupported``."""
    if config is not None and config.decode_mode == "device":
        counters.record(
            "device_decode_unsupported",
            f"{path}: cifar_tar_stream_loader needs host-resident pixels "
            "— decode_mode='device' ignored for the train stream",
        )
        config = dataclasses.replace(config, decode_mode="host")
    parts: list = []
    name_pairs: list = []
    n = 0
    with stream_batches(path, batch, config=config, device="cpu") as st:
        for b in st:
            parts.append((b.indices, b.host))
            name_pairs.extend(zip(b.indices.tolist(), b.names))
            n += len(b)
    if not parts:
        return _empty_batch()
    images = np.zeros((n,) + parts[0][1].shape[1:], np.float32)
    for idx, imgs in parts:
        images[idx] = imgs
    names = [None] * n
    for i, name in name_pairs:
        names[i] = name
    return LabeledImageBatch(images, np.asarray([cifar_tar_label(nm) for nm in names], np.int32))


def _pad_to_chunk(batch, chunk: int) -> torch.Tensor:
    """One streamed batch as a ``chunk``-row pixel block on the stream's
    device, zero rows after the batch's own, as :func:`featurize_chunked`
    pads its tail.  The batch reaches the device first (the stream's copy,
    or for a coefficient chunk its decode there) and is padded there: the
    copy carries only the batch's rows, and the decode kernel only ever
    sees JPEG rows."""
    rows = len(batch)
    pad = chunk - rows
    if pad < 0:
        raise ValueError(
            f"streamed batch of {rows} rows exceeds the featurize chunk {chunk} "
            "— stream with batch_size == featurize_chunk"
        )
    pixels = batch.dev()
    return torch.nn.functional.pad(pixels, (0, 0, 0, 0, 0, 0, 0, pad)) if pad else pixels


def featurize_stream(fn, stream, chunk: int) -> tuple[torch.Tensor, list]:
    """Streaming counterpart of :func:`featurize_chunked`: ``fn`` on each
    ``core.ingest`` chunk padded to ``chunk`` rows, while the producer
    decodes the next ones.  Returns the feature rows on the stream's
    device, scattered back to stream-ordinal order, and the member names
    in that order."""
    parts: list = []
    name_pairs: list = []
    n = 0
    for batch in stream:
        parts.append((batch.indices, fn(_pad_to_chunk(batch, chunk))[: len(batch)]))
        name_pairs.extend(zip(batch.indices.tolist(), batch.names))
        n += len(batch)
    if not parts:
        raise ValueError("the streamed tar holds no decodable image")
    first = parts[0][1]
    out = torch.empty((n, *first.shape[1:]), dtype=first.dtype, device=first.device)
    for idx, feats in parts:
        out[torch.from_numpy(idx).to(out.device)] = feats
    names = [None] * n
    for i, name in name_pairs:
        names[i] = name
    return out, names


def _stream_test_features(conf: RandomCifarConfig, conv_pipe, dev) -> tuple:
    """The streamed test split's conv features on ``dev``, its member names,
    the stream's stats and its autotuner (None without ``conf.auto_tune``).  With a snapshot root and
    ``KEYSTONE_SNAPSHOT_MODE=featurized`` the features come from (or are
    teed into) a featurized snapshot keyed by the fitted featurizer's
    digest and the decode mode, which changes the pixels the features were
    computed from."""
    cfg = stream_config_from_flags(
        decode_backend=conf.decode_backend, snapshot_dir=conf.snapshot_dir,
        device_decode=conf.device_decode, supports_featurized=True,
        autotune=conf.auto_tune,
    )
    chunk = conf.featurize_chunk
    tar = conf.stream_test_tar
    streams: list = []

    def make_stream():
        streams.append(stream_batches(tar, chunk, config=cfg, device=dev))
        return streams[-1]

    if not (cfg.snapshot_dir and cfg.snapshot_mode == "featurized"):
        with make_stream() as st:
            feats, names = featurize_stream(conv_pipe, st, chunk)
        return feats, names, st.stats, st.tuner
    key = ksnap.snapshot_key(
        tar, batch_size=chunk, mode="featurized",
        featurizer=ksnap.featurizer_digest(conv_pipe), extra=f"decode_mode={cfg.decode_mode}",
    )
    feats, names, stats = stream_features_snapshot(
        make_stream, lambda b: conv_pipe(_pad_to_chunk(b, chunk))[: len(b)].cpu().numpy(),
        root=cfg.snapshot_dir, key=key, tar_path=tar,
    )
    # A snapshot that served the features streamed nothing: no tuner.
    tuner = streams[-1].tuner if streams else None
    return torch.from_numpy(feats).to(dev), names, stats, tuner


def apply_servable_chunked(servable, images: np.ndarray, chunk: int) -> np.ndarray:
    """Apply the servable chain in fixed-size chunks (the tail padded);
    returns the predicted labels."""
    dev = servable.nodes[0].device
    outs = [servable(b)[:rows].cpu() for b, rows in _chunks(images, chunk, dev)]
    return torch.cat(outs).numpy()


def run(
    conf: RandomCifarConfig, train: LabeledImageBatch, test: LabeledImageBatch, mesh=None
) -> dict:
    """Fit on ``train``, score ``train`` and ``test`` (or, with
    ``conf.stream_test_tar``, the streamed tar).  The results carry the
    fitted servable pipeline under ``"servable"``.  Each stage is a
    ``stage_timer`` span that ends after a synchronize, so a trace charges
    the device work to the stage that queued it.

    With ``mesh``, the featurize chunks are row-sharded over the data axis
    (:func:`featurize_chunked`) and the block solver runs its mesh ladder;
    the fitted model lives on ``conf.device``."""
    configure_logging()
    dev = resolve_device(conf.device)
    t0 = time.perf_counter()
    if conf.pipeline_file is not None and checkpoint_exists(conf.pipeline_file):
        return _run_restored(conf, test, t0)
    if conf.sample_frac is not None:
        rng = np.random.default_rng(conf.seed)
        keep = rng.random(len(train)) < conf.sample_frac
        train = LabeledImageBatch(train.images[keep], train.labels[keep])

    with stage_timer("learn_filters"):
        filters, whitener = learn_filters(conf, train.images)
        synchronize(dev)
    learn_secs = time.perf_counter() - t0
    conv_pipe = build_conv_pipeline(conf, filters, whitener)
    # One warm chunk first, so the throughput below is steady state (cuDNN
    # heuristics, kernel load), of the shape and sharding the pass uses.
    featurize_chunked(conv_pipe, train.images[:1], conf.featurize_chunk, dev, mesh=mesh)
    synchronize(dev)

    cache_plan = None
    if conf.auto_cache:
        # The KeystoneML optimizer pass over ``featurize then_estimator
        # StandardScaler``: the fit and the fitted application each push
        # the images through the featurizer (reuse 2, measured on a
        # sample), and a memoizing Cacher replays the fit's features when
        # the recompute beats holding them (charged per data slot under a
        # mesh, where the features are row-sharded and the Pipeline runs
        # the scaler on them slot by slot).  The memo is keyed on the
        # identity of the pipeline's input, so the fit and the fitted
        # chain get the very same host array.
        images = train.images
        feat_node = FunctionTransformer(
            lambda imgs: featurize_chunked(conv_pipe, imgs, conf.featurize_chunk, dev,
                                           mesh=mesh),
            name="conv_featurize",
        )
        chain, cache_plan = optimize.auto_cache_chain(
            feat_node.then_estimator(StandardScaler()),
            images[: min(len(images), conf.featurize_chunk)],
            dataset_rows=len(images),
            mesh=mesh,
        )
        t_feat = time.perf_counter()
        with stage_timer("featurize"):
            fitted_feats = chain.fit(images)
            train_features = fitted_feats(images)
            synchronize(dev)
        # Covers the featurize, the scaler's fit and its application: one
        # chain here, where the plain path times the featurize alone.
        feat_secs = time.perf_counter() - t_feat
        scaler = fitted_feats.nodes[-1]
        # The memo kept the features alive for the replay: free them
        # before the solve claims the card's memory.
        optimize.release_caches(fitted_feats)
    else:
        t_feat = time.perf_counter()
        with stage_timer("featurize"):
            train_conv = featurize_chunked(conv_pipe, train.images, conf.featurize_chunk, dev,
                                           mesh=mesh)
            synchronize(dev)
        feat_secs = time.perf_counter() - t_feat

        scaler = StandardScaler().fit(train_conv)
        train_features = map_rows(scaler, train_conv)

    labels = ClassLabelIndicatorsFromIntLabels(conf.num_classes)(
        torch.from_numpy(train.labels).to(dev)
    )
    t_solve = time.perf_counter()
    with stage_timer("solve"):
        solver = BlockLeastSquaresEstimator(4096, 1, conf.lam or 0.0, mesh=mesh)
        model = solver.fit(
            train_features, labels, checkpoint=conf.solve_checkpoint,
            resume_from=conf.solve_resume,
            plan=(conf.solve_plan if conf.solve_plan is not None
                  else True if conf.auto_shard else None),
        )
        log_fit_report(solver, _log, "cifar random-patch solve")
        # Typed failure (FloatingPointError) instead of NaN predictions.
        assert_all_finite(model, "cifar random-patch model")
        synchronize(dev)
    solve_secs = time.perf_counter() - t_solve

    def predict(features):
        return MaxClassifier()(unshard(map_rows(model, features)))

    ingest_stats = names = tuner = None
    with stage_timer("eval"):
        train_pred = predict(train_features)
        train_eval = MulticlassClassifierEvaluator(
            train_pred, torch.from_numpy(train.labels).to(dev), conf.num_classes
        )
        if conf.stream_test_tar is not None:
            test_conv, names, stats, tuner = _stream_test_features(conf, conv_pipe, dev)
            ingest_stats = stats.record()
            test_labels = np.asarray([cifar_tar_label(n) for n in names], np.int32)
        else:
            test_labels = test.labels
            test_conv = featurize_chunked(conv_pipe, test.images, conf.featurize_chunk, dev,
                                          mesh=mesh)
        test_pred = predict(map_rows(scaler, test_conv))
        test_eval = MulticlassClassifierEvaluator(
            test_pred, torch.from_numpy(test_labels).to(dev), conf.num_classes
        )
        synchronize(dev)

    secs = time.perf_counter() - t0
    results = {
        "train_error": 100.0 * train_eval.total_error,
        "test_error": 100.0 * test_eval.total_error,
        "test_predictions": test_pred.cpu().numpy(),
        "seconds": secs,
        "featurize_seconds": feat_secs,
        "featurize_images_per_sec": len(train) / feat_secs,
        "learn_seconds": learn_secs,
        "solve_seconds": solve_secs,
        "servable": Pipeline([*conv_pipe.nodes, scaler, model, MaxClassifier()]),
        "fit_report": solver.last_fit_report.record(),
    }
    if ingest_stats is not None:
        results["ingest"] = ingest_stats
        results["test_labels"] = test_labels
        results["test_filenames"] = names
    if cache_plan is not None:
        results["cache_plan"] = cache_plan.record()
    if solver.last_fit_report.placement is not None:
        # The searched placement table: candidates, deny/score rationale,
        # the chosen plan's predicted-vs-measured cost.
        results["placement"] = solver.last_fit_report.placement
    if tuner is not None:
        results["autotune"] = tuner.record()
        _log.info("ingest autotune: %d retune(s), final config %s",
                  results["autotune"]["retunes"], results["autotune"]["final_config"])
    if conf.pipeline_file is not None:
        # The predicted-class distribution rides the manifest as the
        # reference a serving tier's drift monitor judges answers against.
        save_pipeline(
            conf.pipeline_file, results["servable"],
            numerics_baseline=OutputSketch.for_outputs(results["test_predictions"]).record(),
        )
        _log.info("saved fitted servable pipeline to %s", conf.pipeline_file)
    _log.info("Training error is: %s", train_eval.total_error)
    _log.info("Test error is: %s", test_eval.total_error)
    _log.info("Pipeline took %.3f s", secs)
    _maybe_serve(conf, test, results)
    return results


def _run_restored(conf: RandomCifarConfig, test: LabeledImageBatch, t0: float) -> dict:
    """Score the eager test split with the restored servable chain, in
    featurize chunks: no filter learning, featurize of the training split
    or solve."""
    _log.info("restoring fitted servable pipeline from %s", conf.pipeline_file)
    if len(test.labels) == 0:
        raise ValueError(
            "a restored run scores the eager test split — provide "
            "--testLocation (a streamed test tar has no resident images)"
        )
    servable = load_pipeline(conf.pipeline_file, device=conf.device)
    with stage_timer("eval"):
        test_pred = apply_servable_chunked(servable, test.images, conf.featurize_chunk)
    test_eval = MulticlassClassifierEvaluator(
        torch.from_numpy(test_pred), torch.from_numpy(test.labels), conf.num_classes
    )
    results = {
        "restored": True,
        "test_error": 100.0 * test_eval.total_error,
        "test_predictions": test_pred,
        "servable": servable,
    }
    _log.info("Test error is: %s (restored pipeline)", test_eval.total_error)
    _maybe_serve(conf, test, results)
    results["seconds"] = time.perf_counter() - t0
    return results


def _maybe_serve(conf: RandomCifarConfig, test: LabeledImageBatch, results: dict) -> None:
    """``--serve`` / ``--serveBench``: the saved servable chain behind the
    serving tier, answering requests drawn from the eager test split."""
    if not (conf.serve or conf.serve_bench):
        return
    serve_common.require_pipeline_file(conf.pipeline_file)
    if len(test.labels) == 0:
        raise ValueError(
            "serving draws its requests from the EAGER test split — "
            "provide --testLocation"
        )
    requests = np.asarray(test.images[: conf.serve_requests], np.float32)
    results["serving"] = serve_common.serve_fitted(
        conf.pipeline_file,
        np.empty(requests.shape[1:], np.float32),
        requests,
        label="random_patch_cifar",
        bench=conf.serve_bench,
        clients=conf.serve_clients,
        device=conf.device,
        mesh=serve_common.resolve_serve_mesh(conf.serve_mesh, conf.device),
    )


def _load_split(location: str) -> LabeledImageBatch:
    """A JPEG tar ("<label>/img.jpg" members) through the threaded tar
    decoder; anything else is the CIFAR binary format."""
    if location.endswith((".tar", ".tar.gz", ".tgz")):
        return cifar_tar_loader(location)
    return cifar_loader(location)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("RandomPatchCifar")
    p.add_argument(
        "--trainLocation", default=None,
        help="CIFAR binary (or JPEG tar); optional when --streamTrainTar supplies the train split",
    )
    p.add_argument(
        "--testLocation", default=None,
        help="CIFAR binary (or JPEG tar); optional when --streamTestTar supplies the test split",
    )
    p.add_argument("--numFilters", type=int, default=100)
    p.add_argument("--patchSize", type=int, default=6)
    p.add_argument("--patchSteps", type=int, default=1)
    p.add_argument("--poolSize", type=int, default=14)
    p.add_argument("--poolStride", type=int, default=13)
    p.add_argument("--alpha", type=float, default=0.25)
    p.add_argument("--lambda", dest="lam", type=float, default=None)
    p.add_argument("--sampleFrac", type=float, default=None)
    p.add_argument("--whitenerSize", type=int, default=100000)
    p.add_argument(
        "--streamTestTar", default=None,
        help="score the test split from this JPEG tar ('<label>/name.jpg' members) "
        "through core.ingest, decode overlapping the featurize",
    )
    p.add_argument(
        "--streamTrainTar", default=None,
        help="decode the train split from this JPEG tar ('<label>/name.jpg' members) "
        "through core.ingest, bit-identical to the eager loader (replaces --trainLocation)",
    )
    p.add_argument(
        "--deviceDecode", action="store_true",
        help="with --streamTestTar: host entropy pass only, pixels decoded on the device",
    )
    p.add_argument(
        "--decodeBackend", default=None, choices=("thread", "process"),
        help="host decode of the streamed tars on the thread pool or on spawned worker "
        "processes (KEYSTONE_DECODE_BACKEND)",
    )
    p.add_argument(
        "--snapshotDir", default=None,
        help="snapshot root of the streamed tars: the first pass writes decoded chunks "
        "(KEYSTONE_SNAPSHOT_MODE=device: device-format shards; featurized: the test "
        "split's conv features), a repeat run reads them (KEYSTONE_SNAPSHOT_DIR)",
    )
    p.add_argument(
        "--autoCache", action="store_true",
        help="cost-based auto-Cacher (core.optimize): profile the conv featurizer on a "
        "sample and cache its training features when the recompute beats holding them "
        "(env KEYSTONE_AUTOCACHE=1)",
    )
    p.add_argument(
        "--autoTune", action="store_true",
        help="with --streamTestTar: the closed-loop ingest autotuner retunes decode width, "
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
        help="checkpoint stem of the fitted servable chain (featurizer + scaler + "
        "model + classifier): saved after a fit, restored without a fit when it exists",
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
    if a.trainLocation is None and a.streamTrainTar is None:
        p.error("one of --trainLocation / --streamTrainTar is required")
    if a.testLocation is None and a.streamTestTar is None:
        p.error("one of --testLocation / --streamTestTar is required")
    if a.deviceDecode and a.streamTestTar is None:
        p.error("--deviceDecode needs --streamTestTar")
    if a.autoTune and a.streamTestTar is None:
        p.error("--autoTune needs --streamTestTar")
    if (a.decodeBackend or a.snapshotDir) and not (a.streamTestTar or a.streamTrainTar):
        p.error("--decodeBackend and --snapshotDir need --streamTestTar or --streamTrainTar")
    if a.trace:
        trace.enable(a.trace)
    configure_logging()
    conf = RandomCifarConfig(
        train_location=a.trainLocation or a.streamTrainTar,
        test_location=a.testLocation,
        num_filters=a.numFilters,
        patch_size=a.patchSize,
        patch_steps=a.patchSteps,
        pool_size=a.poolSize,
        pool_stride=a.poolStride,
        alpha=a.alpha,
        lam=a.lam,
        sample_frac=a.sampleFrac,
        whitener_size=a.whitenerSize,
        device=a.device,
        stream_test_tar=a.streamTestTar,
        device_decode=a.deviceDecode,
        decode_backend=a.decodeBackend,
        snapshot_dir=a.snapshotDir,
        pipeline_file=a.pipelineFile,
        serve=a.serve,
        serve_bench=a.serveBench,
        serve_clients=a.serveClients,
        serve_requests=a.serveRequests,
        serve_mesh=a.serveMesh,
        auto_cache=a.autoCache or optimize.auto_cache_env(),
        auto_tune=a.autoTune,
        auto_shard=a.autoShard,
    )
    resolve_device(conf.device)
    mesh = parse_mesh(a.mesh, a.device)
    restoring = a.pipelineFile is not None and checkpoint_exists(a.pipelineFile)
    try:
        with stage_timer("load"):
            if restoring:
                # A restored run never reads the training split.
                train = _empty_batch()
            elif a.streamTrainTar is not None:
                train = cifar_tar_stream_loader(
                    a.streamTrainTar, batch=conf.featurize_chunk,
                    config=stream_config_from_flags(
                        decode_backend=conf.decode_backend, snapshot_dir=conf.snapshot_dir,
                    ),
                )
            else:
                train = _load_split(conf.train_location)
            if a.streamTestTar is not None:
                # run() never reads the eager test split when it streams one.
                test = LabeledImageBatch(
                    np.zeros((0,) + train.images.shape[1:], np.float32), np.zeros(0, np.int32)
                )
            else:
                test = _load_split(a.testLocation)
        return run(conf, train, test, mesh=mesh)
    finally:
        if a.trace:
            trace.flush()


if __name__ == "__main__":
    main()
