"""ImageNetSiftLcsFV on PyTorch/CUDA (counterpart of
keystone_tpu/workloads/imagenet_sift_lcs_fv.py, eager single-device path).

Per branch (SIFT / LCS): descriptors -> [PCA fit or load] -> BatchPCA ->
[GMM fit or load] -> FisherVector (the sufficient statistics through the
fv_stats CUDA kernel) -> vectorize / normalise / signed sqrt / normalise.
SIFT is dense SIFT with bf16 intermediates on the grayscale image, then a
signed square root; LCS runs on the raw BGR pixels.  The branches are
concatenated (ZipVectors) and solved with
BlockWeightedLeastSquares(4096, 1, lambda, w); evaluation is top-5 error.

Run: ``python -m keystone_tpu_torch.workloads.imagenet_sift_lcs_fv
--trainLocation train/ --testLocation test/ --labelPath labels.txt
[--streamIngest [--deviceDecode] [--decodeBackend process] [--snapshotDir DIR]
[--streamBatchSize 32]] [--device cpu]``,
where each location is a tar or a directory of tars holding synset
directories, and the labels file maps ``synset class-id`` per line.

Residency: each branch frees its raw training descriptors bucket by bucket
as it projects them, and the test split is featurized chunk by chunk
(``SIFT_CHUNK`` images) rather than in whole buckets; neither changes a
feature.  ``--streamIngest`` streams each tar set through ``core.ingest``
once per branch and per split; with ``--deviceDecode`` the host runs only
the JPEG entropy pass and the pixels are decoded on the card.
``--decodeBackend process`` decodes on spawned worker processes, and with
``--snapshotDir`` the first pass over a split writes its decoded chunks, so
the second branch's pass (and a repeat run) streams them from disk;
``--autoTune`` retunes each stream's decode from its stall counters.
``--autoCache`` lets the auto-Cacher (``core.optimize``) decide per branch
whether the projected training descriptors stay whole between GMM
sampling and the Fisher features or are re-projected for each consumer.
``--pipelineFile`` saves the fitted ``{sift_pca, sift_gmm, lcs_pca,
lcs_gmm, model}`` bundle in the JAX package's checkpoint format, and a run
that finds it restores it and reads no training data.

``--mesh`` (``run(mesh=)``): in both branches and both splits each shape
bucket's images are row-sharded over the mesh's data slots, with the
placement chosen by the placement search
(``fv_common.searched_bucket_featurize``; the training passes' records in
``results["placement"]``); descriptors, the PCA projection and the Fisher
features (K2) run slot by slot, and the class-weighted solve runs its mesh
ladder.  A streamed split keeps its unsharded passes (``--autoTune`` tunes
them as without a mesh).  Beside ``--mesh``, ``--autoCache`` charges each
branch's projected descriptors per data slot against the slot budget, and
``--pipelineFile`` saves the fitted bundle, which a later run restores and
applies on the mesh.
"""

from __future__ import annotations

import argparse
import logging
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..core import optimize, trace
from ..core import snapshot as ksnap
from ..core.checkpoint import checkpoint_exists, load_pipeline, save_pipeline
from ..core.logging import configure_logging, stage_timer
from ..core.memory import log_fit_report
from ..core.pipeline import Pipeline
from ..core.resilience import assert_all_finite
from ..loaders.image_loaders import LabeledImages, imagenet_labels_map, imagenet_loader
from ..ops.lcs import LCSExtractor
from ..ops.sift import SIFTExtractor
from ..ops.stats import SignedHellingerMapper
from ..ops.util import ClassLabelIndicatorsFromIntLabels, TopKClassifier, ZipVectors
from ..parallel.mesh import add_mesh_flag, parse_mesh
from ..solvers.gmm import GaussianMixtureModel, GaussianMixtureModelEstimator
from ..solvers.pca import BatchPCATransformer, compute_pca
from ..solvers.weighted import BlockWeightedLeastSquaresEstimator
from ..utils.platform import resolve_device, synchronize
from ..utils.stats import get_err_percent
from .fv_common import (
    StreamSource,
    chunked,
    collect_autotune,
    fisher_feature_pipeline,
    grayscale,
    per_bucket,
    plan_pca_materialization,
    sample_columns,
    scatter_features,
    scatter_features_streaming,
    searched_bucket_featurize,
    stream_descriptor_buckets,
)

# Named: under ``python -m`` __name__ is __main__, outside the package's log handler.
_log = logging.getLogger("keystone_tpu_torch.workloads.imagenet_sift_lcs_fv")

#: Hard cap on the GMM EM training set, whatever ``num_gmm_samples`` is.
GMM_FIT_CAP = 1_000_000

#: Images per descriptor call, in both branches.  It bounds SIFT's
#: [n, 8, Fy*4, W] intermediates; no descriptor depends on it.
SIFT_CHUNK = 32

BRANCHES = ("sift", "lcs")


def imagenet_stream_source(
    data_path: str, labels_path: str, batch_size: int = 32, device_decode: bool = False,
    decode_backend: str | None = None, snapshot_dir: str | None = None,
    autotune: bool = False,
) -> StreamSource:
    """Streaming stand-in for :func:`imagenet_loader`: the members whose
    synset directory the labels file names, labelled with its id, decoded
    while the device featurizes.  The snapshot key's extra is the JAX
    package's: the label file's identity."""
    lm = imagenet_labels_map(labels_path)

    def synset(name: str) -> str:
        return name.split("/")[0]

    return StreamSource(
        data_path, keep=lambda name: synset(name) in lm, label=lambda name: lm[synset(name)],
        batch_size=batch_size, device_decode=device_decode, decode_backend=decode_backend,
        snapshot_dir=snapshot_dir,
        snapshot_extra=f"imagenet:{ksnap.file_identity(labels_path)}",
        autotune=autotune,
    )


@dataclass
class ImageNetSiftLcsFVConfig:
    train_location: str = ""
    test_location: str = ""
    label_path: str = ""
    lam: float = 6e-5
    mixture_weight: float = 0.25
    desc_dim: int = 64
    vocab_size: int = 16
    sift_scale_step: int = 1
    lcs_stride: int = 4
    lcs_border: int = 16
    lcs_patch: int = 6
    sift_pca_file: str | None = None
    sift_gmm_mean_file: str | None = None
    sift_gmm_var_file: str | None = None
    sift_gmm_wts_file: str | None = None
    lcs_pca_file: str | None = None
    lcs_gmm_mean_file: str | None = None
    lcs_gmm_var_file: str | None = None
    lcs_gmm_wts_file: str | None = None
    num_pca_samples: int = int(1e7)
    num_gmm_samples: int = int(1e7)
    num_classes: int = 1000
    seed: int = 42
    device: str = "cuda"
    #: Checkpoint stem of the fitted bundle: saved after a fit, restored
    #: (no fit, no training data read) when it exists.
    pipeline_file: str | None = None
    #: Cost-based auto-Cacher (core.optimize) on each branch's projected
    #: training descriptors; the decision tables are
    #: ``results["cache_plan"]``.
    auto_cache: bool = False
    #: Placement search (core.autoshard): force the cost-model-ranked
    #: candidate search for the weighted block solve (on by default via
    #: ``KEYSTONE_AUTOSHARD``); the searched table lands in
    #: ``results["placement"]`` whenever a search ran.
    auto_shard: bool = False

    def branch_files(self, branch: str) -> tuple:
        """(pca_file, (mean, var, wts) files) of ``branch``."""
        return (
            getattr(self, f"{branch}_pca_file"),
            tuple(getattr(self, f"{branch}_gmm_{k}_file") for k in ("mean", "var", "wts")),
        )

    def branch_seed(self, branch: str) -> int:
        return self.seed if branch == "sift" else self.seed + 100


def make_describe(conf: ImageNetSiftLcsFVConfig, branch: str):
    """``[b, H, W, 3]`` BGR pixels on the device -> ``[b, d, cols]``
    descriptors of ``branch``: SIFT (bf16 intermediates, as in the JAX
    package's workload) then the signed square root on the grayscale
    image, or LCS on the raw pixels."""
    if branch == "sift":
        sift = SIFTExtractor(scale_step=conf.sift_scale_step, compute_dtype=torch.bfloat16)
        hell = SignedHellingerMapper()
        return lambda pixels: hell(sift(grayscale(pixels)))
    if branch == "lcs":
        return LCSExtractor(conf.lcs_stride, conf.lcs_border, conf.lcs_patch)
    raise ValueError(f"unknown branch {branch!r} (one of {BRANCHES})")


def descriptor_buckets(conf: ImageNetSiftLcsFVConfig, images, branch: str, mesh=None,
                       placement_out: dict | None = None) -> dict:
    """Per shape bucket: (indices, ``[n, d, cols]`` descriptors) of
    ``branch`` on the configured device, in chunks of ``SIFT_CHUNK``
    images.  ``images`` is a list of arrays or a :class:`StreamSource` (a
    stream keeps its unsharded pass).  With ``mesh`` the buckets are
    row-sharded with the searched placement, whose record
    ``placement_out[f"featurize_{branch}"]`` receives."""
    dev = resolve_device(conf.device)
    describe = make_describe(conf, branch)
    if isinstance(images, StreamSource):
        return images.run_pass(dev, lambda st: stream_descriptor_buckets(
            st, lambda pixels: chunked(describe, pixels, SIFT_CHUNK)))
    out, placement = searched_bucket_featurize(
        f"imagenet_{branch}_featurize", images, describe, dev, SIFT_CHUNK, mesh)
    if placement_out is not None and placement is not None:
        placement_out[f"featurize_{branch}"] = placement
    return out


def _fit_branch(conf: ImageNetSiftLcsFVConfig, desc_buckets: dict, branch: str, lap,
                mesh=None) -> tuple:
    """Fit (or load) the branch's PCA and GMM from the training descriptors
    and project them.  ``desc_buckets`` is consumed: each raw bucket is
    dropped as soon as its projection exists, so the raw set and the
    projected set never both stay whole.  With ``conf.auto_cache`` the
    auto-Cacher decides that materialization; denied, the raw buckets stay
    and each consumer projects one bucket at a time (the same bits), and
    the projected buckets come back as None; under ``mesh`` it charges the
    projection per data slot.  Returns (batch_pca, gmm,
    projected buckets or None, seconds by stage, the cache plan or None)."""
    dev = resolve_device(conf.device)
    pca_file, (mean_f, var_f, wts_f) = conf.branch_files(branch)
    seed = conf.branch_seed(branch)
    secs = {}
    t = time.perf_counter()
    if pca_file is not None:
        pca_mat = np.loadtxt(pca_file, delimiter=",", ndmin=2).T
        pca_mat = torch.as_tensor(np.asarray(pca_mat, np.float32), device=dev)
    else:
        samples = sample_columns(desc_buckets, conf.num_pca_samples, seed)
        pca_mat = compute_pca(samples.T, conf.desc_dim)
        del samples
    batch_pca = BatchPCATransformer(pca_mat)
    secs["pca_fit"] = lap(t)

    materialize, plan = True, None
    if conf.auto_cache:
        # GMM sampling (when a GMM is fitted) and the Fisher features.
        reuse = (0 if mean_f is not None else 1) + 1
        plan, materialize = plan_pca_materialization(
            desc_buckets, batch_pca, reuse, label=f"{branch}_pca_descriptors", mesh=mesh)
        _log.info("%s branch %s", branch, plan.summary())

    t = time.perf_counter()
    pca_desc = None
    if materialize:
        pca_desc = {}
        for shape in list(desc_buckets):
            idx, descs = desc_buckets.pop(shape)
            pca_desc[shape] = (idx, per_bucket(batch_pca, descs))
            del descs
    secs["project"] = lap(t)

    t = time.perf_counter()
    if mean_f is not None:
        gmm = GaussianMixtureModel.load(mean_f, var_f, wts_f, device=dev)
    else:
        if pca_desc is not None:
            gmm_samples = sample_columns(pca_desc, conf.num_gmm_samples, seed + 1)
        else:
            gmm_samples = sample_columns(desc_buckets, conf.num_gmm_samples, seed + 1,
                                         project=batch_pca)
        if gmm_samples.shape[1] > GMM_FIT_CAP:
            gmm_samples = gmm_samples[:, :GMM_FIT_CAP].clone()
        gmm = GaussianMixtureModelEstimator(conf.vocab_size).fit(gmm_samples.T)
        del gmm_samples
    assert_all_finite(gmm, f"{branch} branch GMM fit")
    secs["gmm"] = lap(t)
    return batch_pca, gmm, pca_desc, secs, plan


def branch_test_features(
    conf: ImageNetSiftLcsFVConfig, images, branch: str, batch_pca, gmm, mesh=None
) -> torch.Tensor:
    """A fitted branch applied to new images, ``SIFT_CHUNK`` images (or
    one stream chunk) at a time: ``[n, 2·desc_dim·vocab_size]`` features on
    the configured device, in the images' order.  With ``mesh`` each bucket
    is row-sharded with the searched placement, each slot featurizing its
    own rows."""
    dev = resolve_device(conf.device)
    describe = make_describe(conf, branch)
    fisher = fisher_feature_pipeline(gmm)
    feat_dim = 2 * conf.desc_dim * conf.vocab_size

    def featurize(pixels):
        return fisher(batch_pca(chunked(describe, pixels, SIFT_CHUNK)))

    if isinstance(images, StreamSource):
        feats = images.run_pass(dev, lambda st: scatter_features_streaming(st, featurize, feat_dim))
        return torch.from_numpy(feats).to(dev)
    buckets, _placement = searched_bucket_featurize(
        f"imagenet_{branch}_featurize", images, featurize, dev, SIFT_CHUNK, mesh)
    return scatter_features(buckets, lambda feats: feats, len(images), feat_dim)


def branch_features(conf: ImageNetSiftLcsFVConfig, train_images, test_images, branch: str,
                    mesh=None, placement_out: dict | None = None):
    """Fit ``branch`` on the training images and featurize both splits
    (over ``mesh``, if given; the training featurize's placement record in
    ``placement_out``).  Returns (train features, test features, batch_pca,
    gmm, seconds by stage, cache plan or None); the raw training
    descriptors are gone when it returns."""
    dev = resolve_device(conf.device)

    def lap(start: float) -> float:
        synchronize(dev)
        return time.perf_counter() - start

    t = time.perf_counter()
    train_desc = descriptor_buckets(conf, train_images, branch, mesh, placement_out)
    describe_secs = lap(t)
    batch_pca, gmm, pca_desc, secs, plan = _fit_branch(conf, train_desc, branch, lap, mesh)
    secs["describe"] = describe_secs
    t = time.perf_counter()
    feat_dim = 2 * conf.desc_dim * conf.vocab_size
    fisher = fisher_feature_pipeline(gmm)
    if pca_desc is not None:
        train_feats = scatter_features(pca_desc, fisher, len(train_images), feat_dim)
    else:
        train_feats = scatter_features(
            train_desc, Pipeline([batch_pca, fisher]), len(train_images), feat_dim)
    del pca_desc, train_desc
    secs["fisher"] = lap(t)
    t = time.perf_counter()
    test_feats = branch_test_features(conf, test_images, branch, batch_pca, gmm, mesh)
    secs["test"] = lap(t)
    return train_feats, test_feats, batch_pca, gmm, secs, plan


def run(conf: ImageNetSiftLcsFVConfig, train: LabeledImages, test: LabeledImages,
        mesh=None) -> dict:
    """Fit on ``train`` (or, with an existing ``conf.pipeline_file``,
    restore the fitted bundle and never read ``train``), score ``test``;
    with ``mesh`` every featurize is row-sharded and the solve runs its
    mesh ladder.
    The results carry the top-5 and top-1 errors, the stage seconds, the
    test scores and the fitted ``{sift_pca, sift_gmm, lcs_pca, lcs_gmm,
    model}`` under ``"bundle"``.  Each stage (``sift_branch``,
    ``lcs_branch``, ``solve``, ``eval``) is a ``stage_timer`` span that
    ends after a synchronize."""
    configure_logging()
    dev = resolve_device(conf.device)
    t0 = time.perf_counter()

    def lap(start: float) -> float:
        synchronize(dev)
        return time.perf_counter() - start

    restored = conf.pipeline_file is not None and checkpoint_exists(conf.pipeline_file)
    feats, fitted, stage, branch_secs, plans, feat_placements = {}, {}, {}, {}, {}, {}
    if restored:
        _log.info("restoring fitted pipeline from %s", conf.pipeline_file)
        fitted = load_pipeline(conf.pipeline_file, device=dev)
    for branch in BRANCHES:
        t = time.perf_counter()
        with stage_timer(f"{branch}_branch"):
            if restored:
                feats[branch] = (None, branch_test_features(
                    conf, test.images, branch, fitted[f"{branch}_pca"],
                    fitted[f"{branch}_gmm"], mesh))
            else:
                train_f, test_f, batch_pca, gmm, stage[branch], plan = branch_features(
                    conf, train.images, test.images, branch, mesh, feat_placements
                )
                feats[branch] = (train_f, test_f)
                fitted[f"{branch}_pca"], fitted[f"{branch}_gmm"] = batch_pca, gmm
                if plan is not None:
                    plans[branch] = plan.record()
            branch_secs[branch] = lap(t)

    test_features = ZipVectors.apply([feats[b][1] for b in BRANCHES])
    solve_secs = placement = None
    if restored:
        model = fitted["model"]
        del feats
    else:
        train_features = ZipVectors.apply([feats[b][0] for b in BRANCHES])
        del feats
        labels = ClassLabelIndicatorsFromIntLabels(conf.num_classes)(train.labels).to(dev)

        t = time.perf_counter()
        with stage_timer("solve"):
            solver = BlockWeightedLeastSquaresEstimator(4096, 1, conf.lam, conf.mixture_weight,
                                                        mesh=mesh)
            model = solver.fit(
                train_features, labels, num_features=2 * 2 * conf.desc_dim * conf.vocab_size,
                plan=True if conf.auto_shard else None,
            )
            placement = solver.last_fit_report.placement
            fit_report = solver.last_fit_report.record()
            log_fit_report(solver, _log, "ImageNet weighted block solve")
            assert_all_finite(model, "ImageNet weighted block solve")
            solve_secs = lap(t)
        del train_features
        if conf.pipeline_file is not None:
            save_pipeline(conf.pipeline_file, {**fitted, "model": model})
            _log.info("saved fitted pipeline to %s", conf.pipeline_file)

    t = time.perf_counter()
    with stage_timer("eval"):
        scores = model(test_features)
        k = min(5, conf.num_classes)
        topk = TopKClassifier(k)(scores).cpu().numpy()
        scores = scores.cpu().numpy()
        eval_secs = lap(t)
    test_labels = np.asarray(test.labels)

    results = {
        "top5_err_percent": get_err_percent(topk, test_labels, k),
        "top1_err_percent": get_err_percent(topk, test_labels, 1),
        "seconds": time.perf_counter() - t0,
        "sift_branch_seconds": branch_secs["sift"],
        "lcs_branch_seconds": branch_secs["lcs"],
        "eval_seconds": eval_secs,
        "test_scores": scores,
        "test_labels": test_labels,
        "test_filenames": list(test.filenames),
        "bundle": {**fitted, "model": model},
    }
    if restored:
        results["restored"] = True
    else:
        featurize = sum(stage[b][s] for b in BRANCHES for s in ("describe", "project", "fisher"))
        results.update({
            "solve_seconds": solve_secs,
            "fit_report": fit_report,
            "branch_stage_seconds": stage,
            # Descriptors -> PCA projection -> Fisher features of the
            # training split, both branches.
            "featurize_images_per_sec": len(train) / featurize,
        })
    if plans:
        results["cache_plan"] = plans
    if feat_placements:
        # One home for every searched placement of the run.
        results["placement"] = {"solver": placement, **feat_placements}
    elif placement is not None:
        # The searched placement table of the weighted block solve.
        results["placement"] = placement
    ingest = {
        split: [s.record() for s in src.stream_stats]
        for split, src in (("train", train), ("test", test))
        if isinstance(src, StreamSource)
    }
    if ingest:
        results["ingest"] = ingest
    autotune = collect_autotune(train, test)
    if autotune:
        results["autotune"] = autotune
        _log.info("ingest autotune: %s", autotune)
    _log.info("TEST Top-%d error is: %s %%", k, results["top5_err_percent"])
    _log.info("TEST Top-1 error is: %s %%", results["top1_err_percent"])
    _log.info("Pipeline took %.3f s", results["seconds"])
    return results


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("ImageNetSiftLcsFV")
    p.add_argument("--trainLocation", required=True)
    p.add_argument("--testLocation", required=True)
    p.add_argument("--labelPath", required=True)
    p.add_argument("--lambda", dest="lam", type=float, default=6e-5)
    p.add_argument("--mixtureWeight", type=float, default=0.25)
    p.add_argument("--descDim", type=int, default=64)
    p.add_argument("--vocabSize", type=int, default=16)
    p.add_argument("--siftScaleStep", type=int, default=1)
    p.add_argument("--lcsStride", type=int, default=4)
    p.add_argument("--lcsBorder", type=int, default=16)
    p.add_argument("--lcsPatch", type=int, default=6)
    p.add_argument("--numPcaSamples", type=int, default=int(1e7))
    p.add_argument("--numGmmSamples", type=int, default=int(1e7))
    p.add_argument("--numClasses", type=int, default=1000)
    for flag in ("siftPcaFile", "siftGmmMeanFile", "siftGmmVarFile", "siftGmmWtsFile",
                 "lcsPcaFile", "lcsGmmMeanFile", "lcsGmmVarFile", "lcsGmmWtsFile"):
        p.add_argument(f"--{flag}", default=None)
    p.add_argument(
        "--streamIngest", action="store_true",
        help="stream each tar set through core.ingest: decode WHILE the device featurizes",
    )
    p.add_argument(
        "--streamBatchSize", type=int, default=32,
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
        "(device-format shards under KEYSTONE_SNAPSHOT_MODE=device), a repeat pass or run "
        "reads them (KEYSTONE_SNAPSHOT_DIR)",
    )
    p.add_argument(
        "--autoTune", action="store_true",
        help="with --streamIngest: the closed-loop ingest autotuner retunes decode width, "
        "decode-ahead, ring depth and the decode backend from the stall counters",
    )
    p.add_argument(
        "--autoCache", action="store_true",
        help="cost-based auto-Cacher (core.optimize): per branch, keep the projected "
        "training descriptors whole or re-project per consumer, decided from a timed probe "
        "through the card's admission gate (env KEYSTONE_AUTOCACHE=1)",
    )
    p.add_argument(
        "--autoShard", action="store_true",
        help="placement search (core.autoshard): force the cost-model "
        "ranked mesh/strategy candidate search for the weighted block "
        "solve and record the searched plan in results['placement'] (on "
        "by default; KEYSTONE_AUTOSHARD=0 disables it except here)",
    )
    p.add_argument(
        "--pipelineFile", default=None,
        help="checkpoint stem of the fitted {sift_pca, sift_gmm, lcs_pca, lcs_gmm, model} "
        "bundle: saved after a fit, restored without a fit (or a read of the training "
        "data) when it exists",
    )
    p.add_argument(
        "--trace", default=None, metavar="PATH",
        help="write a Chrome-trace JSON (.jsonl for the JSONL event log) of the run",
    )
    p.add_argument(
        "--device", default="cuda", help="'cuda' (default; raises without a card) or 'cpu'"
    )
    add_mesh_flag(p)
    a = p.parse_args(argv)
    for flag in ("deviceDecode", "decodeBackend", "snapshotDir", "autoTune"):
        if getattr(a, flag) and not a.streamIngest:
            p.error(f"--{flag} needs --streamIngest")
    if a.trace:
        trace.enable(a.trace)
    configure_logging()
    conf = ImageNetSiftLcsFVConfig(
        train_location=a.trainLocation,
        test_location=a.testLocation,
        label_path=a.labelPath,
        lam=a.lam,
        mixture_weight=a.mixtureWeight,
        desc_dim=a.descDim,
        vocab_size=a.vocabSize,
        sift_scale_step=a.siftScaleStep,
        lcs_stride=a.lcsStride,
        lcs_border=a.lcsBorder,
        lcs_patch=a.lcsPatch,
        sift_pca_file=a.siftPcaFile,
        sift_gmm_mean_file=a.siftGmmMeanFile,
        sift_gmm_var_file=a.siftGmmVarFile,
        sift_gmm_wts_file=a.siftGmmWtsFile,
        lcs_pca_file=a.lcsPcaFile,
        lcs_gmm_mean_file=a.lcsGmmMeanFile,
        lcs_gmm_var_file=a.lcsGmmVarFile,
        lcs_gmm_wts_file=a.lcsGmmWtsFile,
        num_pca_samples=a.numPcaSamples,
        num_gmm_samples=a.numGmmSamples,
        num_classes=a.numClasses,
        device=a.device,
        pipeline_file=a.pipelineFile,
        auto_cache=a.autoCache or optimize.auto_cache_env(),
        auto_shard=a.autoShard,
    )
    resolve_device(conf.device)
    mesh = parse_mesh(a.mesh, a.device)
    restoring = conf.pipeline_file is not None and checkpoint_exists(conf.pipeline_file)

    def load(path: str):
        if a.streamIngest:
            return imagenet_stream_source(path, conf.label_path, batch_size=a.streamBatchSize,
                                          device_decode=a.deviceDecode,
                                          decode_backend=a.decodeBackend,
                                          snapshot_dir=a.snapshotDir, autotune=a.autoTune)
        return imagenet_loader(path, conf.label_path)

    try:
        # A restored run never reads (or streams) the training split.
        train = (LabeledImages([], np.zeros(0, np.int32), []) if restoring
                 else load(conf.train_location))
        return run(conf, train, load(conf.test_location), mesh=mesh)
    finally:
        if a.trace:
            trace.flush()


if __name__ == "__main__":
    main()
