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
[--streamIngest [--deviceDecode] [--streamBatchSize 64]] [--device cpu]``.

``--streamIngest`` streams each tar through ``core.ingest`` (decode of the
next chunks overlaps SIFT of this one); with ``--deviceDecode`` the host
runs only the JPEG entropy pass and the pixels are decoded on the card
(``ops.jpeg_device``, the IDCT through the idct CUDA kernel).
"""

from __future__ import annotations

import argparse
import logging
import time
from dataclasses import asdict, dataclass

import numpy as np
import torch

from ..core.pipeline import FunctionTransformer, Pipeline
from ..evaluation.map import MeanAveragePrecisionEvaluator
from ..loaders.image_loaders import (
    VOC_NUM_CLASSES,
    MultiLabeledImages,
    voc_labels_map,
    voc_loader,
)
from ..ops.sift import SIFTExtractor
from ..ops.util import ClassLabelIndicatorsFromIntArrayLabels
from ..solvers.block import BlockLeastSquaresEstimator
from ..solvers.gmm import GaussianMixtureModel, GaussianMixtureModelEstimator
from ..solvers.pca import BatchPCATransformer, compute_pca
from ..utils.platform import resolve_device, synchronize
from ..utils.stats import check_finite
from .fv_common import (
    StreamSource,
    chunked,
    describe_buckets,
    fisher_feature_pipeline,
    grayscale,
    sample_columns,
    scatter_features,
    stream_descriptor_buckets,
)

_log = logging.getLogger(__name__)

#: Images per SIFT call.  It bounds the [n, 8, Fy*4, W] intermediates (about
#: 7.5 MB per 500x375 image in f32); the descriptors do not depend on it.
SIFT_CHUNK = 32


def voc_stream_source(
    data_path: str, labels_path: str, name_prefix: str = "VOCdevkit/VOC2007/JPEGImages/",
    batch_size: int = 64, device_decode: bool = False,
) -> StreamSource:
    """Streaming stand-in for :func:`voc_loader`: the members under
    ``name_prefix`` that the labels CSV names, labelled with their class
    lists, decoded while the device runs SIFT."""
    lm = voc_labels_map(labels_path)
    return StreamSource(
        data_path, keep=lambda name: name.startswith(name_prefix) and name in lm,
        label=lm.__getitem__, batch_size=batch_size, device_decode=device_decode,
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


def make_sift(conf: SIFTFisherConfig) -> SIFTExtractor:
    """The workload's SIFT node: bf16 intermediates, as in the JAX package."""
    return SIFTExtractor(
        step_size=conf.sift_step_size, scale_step=conf.scale_step,
        compute_dtype=torch.bfloat16,
    )


def extract_sift_buckets(conf: SIFTFisherConfig, images) -> dict:
    """Per shape bucket: grayscale + dense SIFT -> (indices, [n, 128, cols])
    on the configured device, in chunks of ``SIFT_CHUNK`` images.
    ``images`` is a list of arrays, or a :class:`StreamSource` whose tar
    is streamed (and, with ``device_decode``, decoded on the device)."""
    dev = resolve_device(conf.device)
    sift = make_sift(conf)

    def describe(pixels: torch.Tensor) -> torch.Tensor:
        return sift(grayscale(pixels))

    if isinstance(images, StreamSource):
        # A stream chunk may hold more images than SIFT_CHUNK.
        return images.run_pass(dev, lambda st: stream_descriptor_buckets(
            st, lambda pixels: chunked(describe, pixels, SIFT_CHUNK)))
    return describe_buckets(images, describe, dev, SIFT_CHUNK)


def run(conf: SIFTFisherConfig, train: MultiLabeledImages, test: MultiLabeledImages) -> dict:
    """Fit on ``train``, score ``test``.  The results carry the fitted
    ``{pca, gmm, model}`` under ``"bundle"`` and the test scores under
    ``"test_scores"``."""
    dev = resolve_device(conf.device)
    feat_dim = 2 * conf.desc_dim * conf.vocab_size
    t0 = time.perf_counter()

    def lap(start: float) -> float:
        synchronize(dev)
        return time.perf_counter() - start

    t = time.perf_counter()
    train_desc = extract_sift_buckets(conf, train.images)
    sift_secs = lap(t)
    train_labels = ClassLabelIndicatorsFromIntArrayLabels(VOC_NUM_CLASSES)(train.labels).to(dev)

    t = time.perf_counter()
    if conf.pca_file is not None:
        pca_mat = np.loadtxt(conf.pca_file, delimiter=",", ndmin=2).T
        pca_mat = torch.as_tensor(np.asarray(pca_mat, np.float32), device=dev)
    else:
        samples = sample_columns(train_desc, conf.num_pca_samples, conf.seed)
        pca_mat = compute_pca(samples.T, conf.desc_dim)
        del samples
    batch_pca = BatchPCATransformer(pca_mat)
    t_proj = time.perf_counter()
    pca_desc = {shape: (idx, batch_pca(descs)) for shape, (idx, descs) in train_desc.items()}
    project_secs = lap(t_proj)
    pca_secs = lap(t)
    del train_desc

    t = time.perf_counter()
    if conf.gmm_mean_file is not None:
        gmm = GaussianMixtureModel.load(
            conf.gmm_mean_file, conf.gmm_var_file, conf.gmm_wts_file, device=dev
        )
    else:
        gmm_samples = sample_columns(pca_desc, conf.num_gmm_samples, conf.seed + 1)
        gmm = GaussianMixtureModelEstimator(conf.vocab_size).fit(gmm_samples.T)
        del gmm_samples
    check_finite("VOC GMM fit", gmm.means, gmm.variances, gmm.weights)
    gmm_secs = lap(t)

    t = time.perf_counter()
    fisher = fisher_feature_pipeline(gmm)
    train_features = scatter_features(pca_desc, fisher, len(train), feat_dim)
    fisher_secs = lap(t)
    del pca_desc  # the training descriptors are no longer needed

    t = time.perf_counter()
    model = BlockLeastSquaresEstimator(4096, 1, conf.lam).fit(
        train_features, train_labels, num_features=feat_dim
    )
    check_finite("VOC block least-squares fit", *model.xs, model.b)
    solve_secs = lap(t)

    t = time.perf_counter()
    test_desc = extract_sift_buckets(conf, test.images)
    test_features = scatter_features(
        test_desc, lambda d: fisher(batch_pca(d)), len(test), feat_dim
    )
    del test_desc
    scores = model(test_features).cpu().numpy()
    eval_secs = lap(t)

    aps = MeanAveragePrecisionEvaluator(test.labels, scores, VOC_NUM_CLASSES)
    ingest_stats = {
        split: asdict(src.stream_stats[-1])
        for split, src in (("train", train), ("test", test))
        if isinstance(src, StreamSource)
    }
    results = {
        "aps": aps,
        "map": float(np.mean(aps)),
        "seconds": time.perf_counter() - t0,
        "sift_seconds": sift_secs,
        "pca_seconds": pca_secs,
        "gmm_seconds": gmm_secs,
        "fisher_seconds": fisher_secs,
        "solve_seconds": solve_secs,
        "eval_seconds": eval_secs,
        # SIFT -> PCA projection -> Fisher features of the training split.
        "featurize_images_per_sec": len(train) / (sift_secs + project_secs + fisher_secs),
        "test_scores": scores,
        "test_filenames": list(test.filenames),
        "bundle": {"pca": batch_pca, "gmm": gmm, "model": model},
    }
    if ingest_stats:
        results["ingest"] = ingest_stats
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
        "--device", default="cuda", help="'cuda' (default; raises without a card) or 'cpu'"
    )
    a = p.parse_args(argv)
    if a.deviceDecode and not a.streamIngest:
        p.error("--deviceDecode needs --streamIngest")
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")
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
    )
    resolve_device(conf.device)
    if a.streamIngest:
        train, test = (
            voc_stream_source(path, conf.label_path, batch_size=a.streamBatchSize,
                              device_decode=a.deviceDecode)
            for path in (conf.train_location, conf.test_location)
        )
    else:
        train = voc_loader(conf.train_location, conf.label_path)
        test = voc_loader(conf.test_location, conf.label_path)
    return run(conf, train, test)


if __name__ == "__main__":
    main()
