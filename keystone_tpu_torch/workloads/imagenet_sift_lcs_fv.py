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
[--streamIngest [--deviceDecode] [--streamBatchSize 32]] [--device cpu]``,
where each location is a tar or a directory of tars holding synset
directories, and the labels file maps ``synset class-id`` per line.

Residency: each branch frees its raw training descriptors bucket by bucket
as it projects them, and the test split is featurized chunk by chunk
(``SIFT_CHUNK`` images) rather than in whole buckets; neither changes a
feature.  ``--streamIngest`` streams each tar set through ``core.ingest``
once per branch and per split; with ``--deviceDecode`` the host runs only
the JPEG entropy pass and the pixels are decoded on the card.
"""

from __future__ import annotations

import argparse
import logging
import time
from dataclasses import asdict, dataclass

import numpy as np
import torch

from ..loaders.image_loaders import LabeledImages, imagenet_labels_map, imagenet_loader
from ..ops.lcs import LCSExtractor
from ..ops.sift import SIFTExtractor
from ..ops.stats import SignedHellingerMapper
from ..ops.util import ClassLabelIndicatorsFromIntLabels, TopKClassifier, ZipVectors
from ..solvers.gmm import GaussianMixtureModel, GaussianMixtureModelEstimator
from ..solvers.pca import BatchPCATransformer, compute_pca
from ..solvers.weighted import BlockWeightedLeastSquaresEstimator
from ..utils.platform import resolve_device, synchronize
from ..utils.stats import check_finite, get_err_percent
from .fv_common import (
    StreamSource,
    chunked,
    describe_buckets,
    fisher_feature_pipeline,
    grayscale,
    sample_columns,
    scatter_features,
    scatter_features_streaming,
    stream_descriptor_buckets,
)

_log = logging.getLogger(__name__)

#: Hard cap on the GMM EM training set, whatever ``num_gmm_samples`` is.
GMM_FIT_CAP = 1_000_000

#: Images per descriptor call, in both branches.  It bounds SIFT's
#: [n, 8, Fy*4, W] intermediates; no descriptor depends on it.
SIFT_CHUNK = 32

BRANCHES = ("sift", "lcs")


def imagenet_stream_source(
    data_path: str, labels_path: str, batch_size: int = 32, device_decode: bool = False
) -> StreamSource:
    """Streaming stand-in for :func:`imagenet_loader`: the members whose
    synset directory the labels file names, labelled with its id, decoded
    while the device featurizes."""
    lm = imagenet_labels_map(labels_path)

    def synset(name: str) -> str:
        return name.split("/")[0]

    return StreamSource(
        data_path, keep=lambda name: synset(name) in lm, label=lambda name: lm[synset(name)],
        batch_size=batch_size, device_decode=device_decode,
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


def descriptor_buckets(conf: ImageNetSiftLcsFVConfig, images, branch: str) -> dict:
    """Per shape bucket: (indices, ``[n, d, cols]`` descriptors) of
    ``branch`` on the configured device, in chunks of ``SIFT_CHUNK``
    images.  ``images`` is a list of arrays or a :class:`StreamSource`."""
    dev = resolve_device(conf.device)
    describe = make_describe(conf, branch)
    if isinstance(images, StreamSource):
        return images.run_pass(dev, lambda st: stream_descriptor_buckets(
            st, lambda pixels: chunked(describe, pixels, SIFT_CHUNK)))
    return describe_buckets(images, describe, dev, SIFT_CHUNK)


def _fit_branch(conf: ImageNetSiftLcsFVConfig, desc_buckets: dict, branch: str, lap) -> tuple:
    """Fit (or load) the branch's PCA and GMM from the training descriptors
    and project them.  ``desc_buckets`` is consumed: each raw bucket is
    dropped as soon as its projection exists, so the raw set and the
    projected set never both stay whole.  Returns (batch_pca, gmm,
    projected buckets, seconds by stage)."""
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

    t = time.perf_counter()
    pca_desc = {}
    for shape in list(desc_buckets):
        idx, descs = desc_buckets.pop(shape)
        pca_desc[shape] = (idx, batch_pca(descs))
        del descs
    secs["project"] = lap(t)

    t = time.perf_counter()
    if mean_f is not None:
        gmm = GaussianMixtureModel.load(mean_f, var_f, wts_f, device=dev)
    else:
        gmm_samples = sample_columns(pca_desc, conf.num_gmm_samples, seed + 1)
        if gmm_samples.shape[1] > GMM_FIT_CAP:
            gmm_samples = gmm_samples[:, :GMM_FIT_CAP].clone()
        gmm = GaussianMixtureModelEstimator(conf.vocab_size).fit(gmm_samples.T)
        del gmm_samples
    check_finite(f"{branch} branch GMM fit", gmm.means, gmm.variances, gmm.weights)
    secs["gmm"] = lap(t)
    return batch_pca, gmm, pca_desc, secs


def branch_test_features(
    conf: ImageNetSiftLcsFVConfig, images, branch: str, batch_pca, gmm
) -> torch.Tensor:
    """A fitted branch applied to new images, ``SIFT_CHUNK`` images (or
    one stream chunk) at a time: ``[n, 2·desc_dim·vocab_size]`` features on
    the configured device, in the images' order."""
    dev = resolve_device(conf.device)
    describe = make_describe(conf, branch)
    fisher = fisher_feature_pipeline(gmm)
    feat_dim = 2 * conf.desc_dim * conf.vocab_size

    def featurize(pixels):
        return fisher(batch_pca(chunked(describe, pixels, SIFT_CHUNK)))

    if isinstance(images, StreamSource):
        feats = images.run_pass(dev, lambda st: scatter_features_streaming(st, featurize, feat_dim))
        return torch.from_numpy(feats).to(dev)
    buckets = describe_buckets(images, featurize, dev, SIFT_CHUNK)
    return scatter_features(buckets, lambda feats: feats, len(images), feat_dim)


def branch_features(conf: ImageNetSiftLcsFVConfig, train_images, test_images, branch: str):
    """Fit ``branch`` on the training images and featurize both splits.
    Returns (train features, test features, batch_pca, gmm, seconds by
    stage); the raw training descriptors are gone when it returns."""
    dev = resolve_device(conf.device)

    def lap(start: float) -> float:
        synchronize(dev)
        return time.perf_counter() - start

    t = time.perf_counter()
    train_desc = descriptor_buckets(conf, train_images, branch)
    describe_secs = lap(t)
    batch_pca, gmm, pca_desc, secs = _fit_branch(conf, train_desc, branch, lap)
    secs["describe"] = describe_secs
    t = time.perf_counter()
    feat_dim = 2 * conf.desc_dim * conf.vocab_size
    train_feats = scatter_features(
        pca_desc, fisher_feature_pipeline(gmm), len(train_images), feat_dim
    )
    del pca_desc
    secs["fisher"] = lap(t)
    t = time.perf_counter()
    test_feats = branch_test_features(conf, test_images, branch, batch_pca, gmm)
    secs["test"] = lap(t)
    return train_feats, test_feats, batch_pca, gmm, secs


def run(conf: ImageNetSiftLcsFVConfig, train: LabeledImages, test: LabeledImages) -> dict:
    """Fit on ``train``, score ``test``.  The results carry the top-5 and
    top-1 errors, the stage seconds, the test scores and the fitted
    ``{sift_pca, sift_gmm, lcs_pca, lcs_gmm, model}`` under ``"bundle"``."""
    dev = resolve_device(conf.device)
    t0 = time.perf_counter()

    def lap(start: float) -> float:
        synchronize(dev)
        return time.perf_counter() - start

    feats, fitted, stage, branch_secs = {}, {}, {}, {}
    for branch in BRANCHES:
        t = time.perf_counter()
        train_f, test_f, batch_pca, gmm, stage[branch] = branch_features(
            conf, train.images, test.images, branch
        )
        feats[branch] = (train_f, test_f)
        fitted[f"{branch}_pca"], fitted[f"{branch}_gmm"] = batch_pca, gmm
        branch_secs[branch] = lap(t)

    train_features = ZipVectors.apply([feats[b][0] for b in BRANCHES])
    test_features = ZipVectors.apply([feats[b][1] for b in BRANCHES])
    del feats
    labels = ClassLabelIndicatorsFromIntLabels(conf.num_classes)(train.labels).to(dev)

    t = time.perf_counter()
    model = BlockWeightedLeastSquaresEstimator(4096, 1, conf.lam, conf.mixture_weight).fit(
        train_features, labels, num_features=2 * 2 * conf.desc_dim * conf.vocab_size
    )
    check_finite("ImageNet weighted block solve", *model.xs, model.b)
    solve_secs = lap(t)

    t = time.perf_counter()
    scores = model(test_features)
    k = min(5, conf.num_classes)
    topk = TopKClassifier(k)(scores).cpu().numpy()
    scores = scores.cpu().numpy()
    eval_secs = lap(t)
    test_labels = np.asarray(test.labels)

    featurize = sum(stage[b][s] for b in BRANCHES for s in ("describe", "project", "fisher"))
    results = {
        "top5_err_percent": get_err_percent(topk, test_labels, k),
        "top1_err_percent": get_err_percent(topk, test_labels, 1),
        "seconds": time.perf_counter() - t0,
        "sift_branch_seconds": branch_secs["sift"],
        "lcs_branch_seconds": branch_secs["lcs"],
        "solve_seconds": solve_secs,
        "eval_seconds": eval_secs,
        "branch_stage_seconds": stage,
        # Descriptors -> PCA projection -> Fisher features of the training
        # split, both branches.
        "featurize_images_per_sec": len(train) / featurize,
        "test_scores": scores,
        "test_labels": test_labels,
        "test_filenames": list(test.filenames),
        "bundle": {**fitted, "model": model},
    }
    ingest = {
        split: [asdict(s) for s in src.stream_stats]
        for split, src in (("train", train), ("test", test))
        if isinstance(src, StreamSource)
    }
    if ingest:
        results["ingest"] = ingest
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
        "--device", default="cuda", help="'cuda' (default; raises without a card) or 'cpu'"
    )
    a = p.parse_args(argv)
    if a.deviceDecode and not a.streamIngest:
        p.error("--deviceDecode needs --streamIngest")
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")
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
    )
    resolve_device(conf.device)
    if a.streamIngest:
        train, test = (
            imagenet_stream_source(path, conf.label_path, batch_size=a.streamBatchSize,
                                   device_decode=a.deviceDecode)
            for path in (conf.train_location, conf.test_location)
        )
    else:
        train = imagenet_loader(conf.train_location, conf.label_path)
        test = imagenet_loader(conf.test_location, conf.label_path)
    return run(conf, train, test)


if __name__ == "__main__":
    main()
