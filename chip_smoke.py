#!/usr/bin/env python3
"""Smoke run of keystone_tpu_torch on one CUDA card (the port's quickest
proof that it still builds, is right and runs end to end on the GPU).

Run from the repository root: ``python3 chip_smoke.py``.  Phases, each of
which raises (and so exits non-zero) on failure:

1. card and build: the card's name and power limit, the CUDA version, and
   the build of every kernel under ``keystone_tpu_torch/csrc`` (``nvcc``)
   and of the native entropy loop (``g++``), all started together;
2. every kernel entry against its plain PyTorch version on the card, at
   the main path's shape and at the odd shapes, timed with CUDA events:
   rect+pool on activations and fused with the Convolver's epilogue (the
   fused entry with every flag on and off, and also at served batches of 1
   and 64 images), the Fisher statistics (also at served batches of 1 and
   16 images, each as a share of its bound, and at ImageNetSiftLcsFV's
   shapes, d 64 and k 16 over the SIFT and LCS descriptors of a 375x500
   image, timed with the plain version at 1, 32 and 1,000 images), the
   IDCT (also beside one ``torch.einsum`` call, its library yardstick) and
   the whole pixel decode (``torch.equal`` to the PyTorch composition with
   the IDCT kernel in it, for 4:2:0, 4:2:2, 4:4:4 and grayscale at odd
   sizes);
3. the RandomPatchCifar main path at full width (100 filters of 6x6x3,
   pool 14 / stride 13) on seeded synthetic CIFAR-shaped data, 50,000 train
   and 10,000 test images, through
   ``keystone_tpu_torch.workloads.cifar_random_patch.main`` (the fused
   rect+pool entry must carry it, the unfused one must not run), then one
   2048-image chunk's stage times: host preparation, the pageable host ->
   card copy, the cuDNN convolution, the mu/sigma terms, the fused kernel,
   and the unfused chain (epilogue, bf16 cast, rect+pool) as its yardstick;
4. the fitted servable chain applied in batches of 1, 4, 16 and 64, which
   must reproduce the offline test predictions (counted with phase 3 as the
   main path's launches);
5. card against CPU inside the port: one fitted state featurized and solved
   on both devices;
6. the VOCSIFTFisher main path at full width (dense SIFT step 3, 4 scales;
   PCA to 80; a 256-component GMM; 40,960-wide Fisher vectors; 20 classes)
   on seeded synthetic VOC-shaped images, 512 train and 512 test at
   500x375 and 375x500, through
   ``keystone_tpu_torch.workloads.voc_sift_fisher.run``, then its servable
   chain in batches of 1, 4 and 16, which must reproduce the offline test
   scores (counted with the run as the path's launches);
7. card against CPU inside the port: one fitted VOC state, four images
   through SIFT, and from identical descriptors through PCA -> Fisher
   statistics -> features, on both devices;
8. VOCSIFTFisher from JPEG tars with device decode: phase 6's images are
   encoded as baseline JPEGs (q90, 4:2:0) by the numpy encoder of
   ``keystone_tpu_torch.testing.jpeg_encode`` (this machine may have no
   image library) into train/test tars, then run through
   ``voc_sift_fisher.main([... "--streamIngest", "--deviceDecode"])``: the
   native entropy pass on the host, the whole pixel decode on the card in
   two launches of the decode kernel.  Checks: the native backend ran with
   no fallback or skip; one chunk's entropy decode equals the encoder's
   coefficients exactly; its card decode equals the unfused PyTorch
   composition on the card bit for bit and is within 1 level of the CPU
   decode with >= 99.9 % of pixels equal; MAP >= 0.5 and within 0.05 of
   phase 6; the kernels' launch counts (the fused decode ran, the IDCT
   entry did not); ``fused_apply`` of the servable chain at batches 1, 4
   and 16 reproduces the offline test scores; and the decode's time at
   batches 1 and 64 beside the unfused composition's and its bound;
9. MnistRandomFFT at BASELINE config 1 (``--numFFTs 4 --blockSize 2048``,
   no ``--lambda``) on seeded synthetic MNIST-shaped data, 60,000 train and
   10,000 test rows of 784 integer pixels in [0, 255] (class stroke maps,
   each pixel inked at random), written as CSVs with the 1-indexed label in
   column 0 and run through
   ``keystone_tpu_torch.workloads.mnist_random_fft.main``: cuFFT features,
   the block solve, streaming evaluation.  Checks: a finite model, train and
   test error below 10 % (chance 90 %); prints the CSV write and load
   seconds, the stage seconds and the peak device memory;
10. the reference's default width, ``--numFFTs 200 --blockSize 2048`` (50
   blocks, 102,400 features), through ``mnist_random_fft.run`` on the same
   rows in memory: the same checks and prints, the peak against its
   estimate and below 80 GB;
11. phase 9's servable chain applied in batches of 1, 4, 16 and 64, which
   must reproduce the offline test predictions exactly, and one fitted
   state carried by ``convert.mnist_to_arrays``/``mnist_from_arrays`` onto
   the card and the CPU: on 2,000 test rows the features agree within
   1e-5·max, the scores within 1e-3·max and the predictions exactly.  The
   launch counters of the three kernels do not move in phases 9-11 (the
   path has no hand kernel, as in the JAX package);
12. TimitPipeline at BASELINE config 4's width (``--numCosines 50``, 4096
   cosine features each, ``--numEpochs 5``, no ``--lambda``) on seeded
   synthetic 440-dim frames of 147 classes, 32,768 train and 8,192 test,
   written as CSVs with sparse 1-indexed label files and run through
   ``keystone_tpu_torch.workloads.timit.main``.  Checks: a finite model,
   test error below 20 % (chance 99.3 %) and the peak device memory below
   80 GB, printed beside its estimate; then a Cauchy run at 4 blocks in
   memory with the same checks;
13. phase 12's servable chain at batches 1, 4, 16 and 64, which must
   reproduce the offline test predictions, and one fitted state carried by
   ``convert.timit_to_arrays``/``timit_from_arrays`` onto the card and the
   CPU: on 1,000 test rows the features agree within 1e-5·max, the scores
   within 1e-3·max and the predictions exactly.  The kernels' launch
   counters do not move in phases 12-13;
14. LinearPixels and RandomCifar through their CLIs on phase 3's files.
   RandomCifar's featurize (the fused featurizer with f32 activations) must
   launch the rect+pool kernel's ``conv_rect_pool`` entry on every chunk and
   never the ``rect_pool`` entry; then one 2048-image chunk of its
   Convolver terms through the entry and its plain version on the card
   (within 1e-5·max), timed beside the bound;
15. NewsgroupsPipeline at BASELINE config 2 (``--nGrams 2
   --commonFeatures 100000``) through
   ``keystone_tpu_torch.workloads.newsgroups.main`` on a seeded synthetic
   20-class tree of the 20news-bydate split's sizes, 11,314 train and
   7,532 test documents: test error below 20 %, all 100,000 features used,
   the host's text seconds beside the card's scoring seconds, scores at
   batches 1, 4, 16 and 64 equal to the offline ones bit for bit, and the
   naive-Bayes scores card against CPU within 1e-5·max with equal
   predictions on 2,000 documents.  The kernels' counters do not move;
16. one JSON line per the kernels, the card line, and the final JSON
   line, printed last, after phases 17-19;
17. ImageNetSiftLcsFV at BASELINE config 5's width (1,000 classes; SIFT
   step 3 at scale step 1 with bf16 intermediates, then a signed square
   root; LCS (4, 16, 6); PCA to 64; 16 Gaussians; 4,096 features; the
   class-weighted block solve at lambda 6e-5, mixture weight 0.25; top-5
   evaluation) on seeded synthetic BGR images made on the card, 2,000
   train and 1,000 test at 375x500 and 333x500, through
   ``keystone_tpu_torch.workloads.imagenet_sift_lcs_fv.run``: a reckoned
   lower bound of the peak, which the measured peak must reach, top-5
   error below 50 % (chance 99.5 %),
   a finite model, the Fisher statistics kernel launched in both
   branches; then the fitted branches applied to batches of 1, 4 and 16
   test images, which must reproduce the offline scores within 1e-4·max;
18. card against CPU inside the port: one fitted ImageNet state and four
   images through both branches on both devices (descriptors, Fisher
   statistics, features and scores, each against its own bar);
19. ImageNetSiftLcsFV from JPEG tars with device decode: one training
   image per class and 500 test images of phase 17, encoded by the numpy
   encoder into one tar per synset plus a labels file, through
   ``imagenet_sift_lcs_fv.main([... "--streamIngest", "--deviceDecode"])``:
   the native entropy pass with nothing skipped or routed to the host,
   every pass over a split seeing the same survivors, the fused decode
   launched and the IDCT entry not, the statistics kernel in both
   branches, and the top-5 error below 50 % and within 2 points of an
   in-memory run on the same pixel arrays.

Without a CUDA card it exits with code 1 and prints no result.
"""

from __future__ import annotations

import io
import json
import math
import statistics
import subprocess
import sys
import tarfile
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from keystone_tpu_torch import _build, convert
from keystone_tpu_torch.core.pipeline import Pipeline
from keystone_tpu_torch.core import ingest
from keystone_tpu_torch.loaders import image_loaders
from keystone_tpu_torch.loaders.cifar import cifar_loader
from keystone_tpu_torch.loaders.csv_loader import LabeledData
from keystone_tpu_torch.loaders.image_loaders import (
    VOC_NUM_CLASSES,
    LabeledImages,
    MultiLabeledImages,
)
from keystone_tpu_torch.loaders.newsgroups import CLASSES as NG_CLASSES
from keystone_tpu_torch.loaders.newsgroups import newsgroups_loader
from keystone_tpu_torch.loaders.timit import (
    TIMIT_DIMENSION,
    TIMIT_NUM_CLASSES,
    TimitFeaturesData,
    TimitSplit,
)
from keystone_tpu_torch.ops import fv_stats as fs
from keystone_tpu_torch.ops import jpeg_device as jd
from keystone_tpu_torch.ops import native_entropy
from keystone_tpu_torch.ops import rect_pool as rp
from keystone_tpu_torch.ops.fisher import _fv_from_stats
from keystone_tpu_torch.ops.images import convolver_epilogue
from keystone_tpu_torch.ops.lcs import LCSExtractor
from keystone_tpu_torch.ops.sift import SIFTExtractor
from keystone_tpu_torch.ops.stats import SignedHellingerMapper, StandardScaler
from keystone_tpu_torch.solvers.gmm import GaussianMixtureModel
from keystone_tpu_torch.ops.util import ClassLabelIndicatorsFromIntLabels, MaxClassifier
from keystone_tpu_torch.solvers.block import BlockLeastSquaresEstimator, BlockLinearMapper
from keystone_tpu_torch.testing.corpus import write_newsgroups_tree
from keystone_tpu_torch.testing.jpeg_encode import encode_jpeg
from keystone_tpu_torch.utils.platform import resolve_device
from keystone_tpu_torch.workloads import cifar_random_patch as cifar
from keystone_tpu_torch.workloads import imagenet_sift_lcs_fv as inet
from keystone_tpu_torch.workloads import linear_pixels, newsgroups, random_cifar, timit
from keystone_tpu_torch.workloads import mnist_random_fft as mnist
from keystone_tpu_torch.workloads import voc_sift_fisher as voc
from keystone_tpu_torch.workloads.fv_common import fisher_feature_pipeline, grayscale

# Published peaks of one H100 SXM (NVIDIA data sheet): HBM3 bandwidth and
# the f32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

N_TRAIN, N_TEST, N_CLASSES = 50_000, 10_000, 10
MAIN_FLAGS = [
    "--numFilters", "100", "--patchSize", "6", "--poolSize", "14",
    "--poolStride", "13", "--alpha", "0.25", "--whitenerSize", "100000",
    "--lambda", "10", "--device", "cuda",
]
# (n, oh, ow, F, stride, pool_size, alpha, max_val): the main path's chunk
# ([2048, 27, 27, 100] conv activations) and two odd shapes (F not a
# multiple of 32, truncated edge windows, odd pool size, max_val != 0).
PROD = (2048, 27, 27, 100, 13, 14, 0.25, 0.0)
ODD = [(64, 20, 24, 7, 4, 6, 0.25, 0.0), (64, 16, 16, 3, 5, 5, 0.1, 0.05)]
# The fused entry's flags (normalize_patches, whitener means), and the
# served batches it is also timed at.
FUSED_FLAGS = [(True, True), (True, False), (False, True), (False, False)]
K1_SERVED = (1, 64)

# fv_stats (n, d, D, k, ragged): 32 images of the VOC production shape (a
# 500x375 image gives 73,866 descriptors of 80 dims after PCA, k=256; 32
# because the plain version holds [n, k, D] f32 posteriors, 2.4 GB here),
# then ragged counts and a D that is not a multiple of the kernel's tile.
FV_PROD = (32, 80, 73866, 256, False)
FV_ODD = [(3, 24, 700, 8, True), (3, 24, 333, 8, False)]
# fv_stats is also timed at served batches of one and 16 such images.
FV_SERVED = (1, 16)
# fv_stats at ImageNetSiftLcsFV's shapes (d 64, k 16): the descriptors of a
# 375x500 image in the SIFT branch (step 3, scale step 1) and in the LCS
# branch (stride 4, border 16), checked on 8 images (LCS's with ragged
# counts) and timed at one image, at a test chunk of 32 and at a training
# bucket of 1,000 (one launch each).
FV_IMAGENET = {"sift": (SIFTExtractor(scale_step=1).num_descriptors(375, 500), False),
               "lcs": (LCSExtractor(4, 16, 6).num_keypoints(375, 500), True)}
FV_IMAGENET_BATCHES = (1, 32, 1000)

# idct: the main path's luma launch (a 64-image chunk of 375x500 4:2:0 JPEGs
# is [64, 48, 64, 8, 8]), then one block, a ragged count and leading dims.
IDCT_PROD = (64 * 48 * 64, 8, 8)
IDCT_ODD = [(1, 8, 8), (37, 8, 8), (3, 2, 5, 8, 8)]
# The whole decode: (batch, height, width, sampling) -- the main path's
# 64-image 375x500 4:2:0 chunk, then 4:2:2, 4:4:4 and grayscale at odd sizes.
DECODE_CASES = [
    (64, 375, 500, ((2, 2), (1, 1), (1, 1))),
    (3, 45, 61, ((2, 1), (1, 1), (1, 1))),
    (3, 33, 47, ((1, 1), (1, 1), (1, 1))),
    (3, 33, 47, ((1, 1),)),
    (5, 45, 61, ((2, 2), (1, 1), (1, 1))),
]

# VOCSIFTFisher: VOC 2007's two common image sizes (H, W), images per split.
VOC_SHAPES = {(375, 500): 384, (500, 375): 128}
VOC_CONF = dict(desc_dim=80, vocab_size=256, sift_step_size=3, scale_step=0,
                lam=0.5, num_pca_samples=int(1e6), num_gmm_samples=int(1e6),
                seed=42, device="cuda")


# ImageNetSiftLcsFV at BASELINE config 5's width (the workload's defaults:
# 1,000 classes, SIFT step 3 at scale step 1, LCS (4, 16, 6), PCA to 64, 16
# Gaussians, 4,096 features, lambda 6e-5, mixture weight 0.25, one pass) on
# seeded synthetic BGR images at ImageNet's two common sizes, half each;
# the images cut from 1.28 million to 2 train and 1 test per class.  Phase
# 19 encodes one training image per class and 500 test images as JPEGs.
IMAGENET_CLASSES = 1000
IMAGENET_SHAPES = ((375, 500), (333, 500))
IMAGENET_TRAIN_PER_CLASS, IMAGENET_TEST_PER_CLASS = 2, 1
IMAGENET_TAR_TEST = 500


# MnistRandomFFT: MNIST's splits and width; BASELINE config 1 (README
# "Running pipelines"), then the reference's default number of FFTs.
MNIST_TRAIN, MNIST_TEST, MNIST_PIXELS = 60_000, 10_000, 784
MNIST_FLAGS = ["--numFFTs", "4", "--blockSize", "2048", "--device", "cuda"]
MNIST_WIDE_FFTS = 200
MNIST_CARD_VS_CPU_ROWS = 2000

# TimitPipeline at BASELINE config 4's width (50 blocks of 4096 cosine
# features, 5 epochs, lambda 0) on synthetic 440-dim frames of 147 classes;
# the rows cut from TIMIT's two million frames to 32,768 / 8,192.  The
# class centres carry TIMIT_CENTRE_SCALE of each dimension's unit spread.
TIMIT_TRAIN, TIMIT_TEST = 32_768, 8_192
TIMIT_CENTRE_SCALE = 0.3
TIMIT_FLAGS = ["--numCosines", "50", "--gamma", "0.05555", "--rfType", "gaussian",
               "--numEpochs", "5", "--device", "cuda"]
TIMIT_CAUCHY = dict(num_cosines=4, rf_type="cauchy", gamma=0.002)
TIMIT_CARD_VS_CPU_ROWS = 1000

# RandomCifar at its defaults with lambda 10, on phase 3's files.
RANDOM_CIFAR_FLAGS = [
    "--numFilters", "100", "--patchSize", "6", "--poolSize", "14", "--poolStride", "13",
    "--alpha", "0.25", "--lambda", "10", "--device", "cuda",
]

# NewsgroupsPipeline at BASELINE config 2 on a synthetic tree of the
# 20news-bydate split's sizes.
NG_TRAIN, NG_TEST = 11_314, 7_532
NG_FLAGS = ["--nGrams", "2", "--commonFeatures", "100000", "--device", "cuda"]
NG_CARD_VS_CPU_DOCS = 2000


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median of ``reps`` single-call times, each between two CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rect_pool_bound(z: torch.Tensor, out_numel: int) -> tuple[float, str]:
    """Least time for the rect+pool work: z read once, the f32 output
    written once, against 6 f32 operations per element of z (two
    subtractions, two maxima, two additions)."""
    bytes_ms = (z.numel() * z.element_size() + out_numel * 4) / HBM_BYTES_PER_S * 1e3
    ops_ms = 6 * z.numel() / F32_FLOPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def check_rect_pool(shape, dtype, gen, timed: bool) -> dict:
    n, oh, ow, f, stride, size, alpha, max_val = shape
    z = (2.0 * torch.randn((n, oh, ow, f), generator=gen, device="cuda")).to(dtype)
    kw = dict(pool_stride=stride, pool_size=size, alpha=alpha, max_val=max_val)
    got = rp.rect_pool(z, **kw)
    torch.cuda.synchronize()
    ref = rp.rect_pool_reference(z, **kw)
    torch.cuda.synchronize()
    scale = ref.abs().max().item()
    # Both sides read the same (bf16 or f32) input and sum in f32, in
    # another order: rtol 1e-5, atol 1e-4 * max (the JAX kernel's bar).
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-4 * scale)
    rec = {"shape": [n, oh, ow, f], "dtype": str(dtype).replace("torch.", ""),
           "max_abs_err": (got - ref).abs().max().item()}
    if timed:
        rec["ms"] = cuda_ms(lambda: rp.rect_pool(z, **kw))
        rec["plain_ms"] = cuda_ms(lambda: rp.rect_pool_reference(z, **kw))
        rec["bound_ms"], rec["bound_by"] = rect_pool_bound(z, got.numel())
    log(f"rect_pool {rec}")
    return rec


def conv_terms(n, oh, ow, f, gen, normalize=True, means=True):
    """Seeded Convolver terms at RandomPatchCifar's scale: conv of 0-255
    patches with unit-norm filters, patch means and deviations."""
    conv = 300.0 * torch.randn((n, oh, ow, f), generator=gen, device="cuda")
    mu = 255.0 * torch.rand((n, oh, ow), generator=gen, device="cuda") if normalize else None
    sigma = (5.0 + 75.0 * torch.rand((n, oh, ow), generator=gen, device="cuda")
             if normalize else None)
    fsum = torch.randn((f,), generator=gen, device="cuda")
    fmd = torch.randn((f,), generator=gen, device="cuda") if means else None
    return conv, mu, sigma, fsum, fmd


def conv_rect_pool_bound(terms, out_numel: int) -> tuple[float, str]:
    """Least time for the fused step: conv (and mu, sigma, fsum, fmd) read
    once, the f32 output written once, against 10 f32 operations per conv
    element (the epilogue's product, two subtractions and division, then
    the rect+pool's six)."""
    read = sum(t.numel() * t.element_size() for t in terms if t is not None)
    bytes_ms = (read + out_numel * 4) / HBM_BYTES_PER_S * 1e3
    ops_ms = 10 * terms[0].numel() / F32_FLOPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def check_conv_rect_pool(shape, dtype, flags, gen, timed: bool) -> dict:
    n, oh, ow, f, stride, size, alpha, max_val = shape
    terms = conv_terms(n, oh, ow, f, gen, *flags)
    kw = dict(pool_stride=stride, pool_size=size, alpha=alpha, max_val=max_val,
              activation_dtype=dtype)
    got = rp.conv_rect_pool(*terms, **kw)
    torch.cuda.synchronize()
    ref = rp.conv_rect_pool_reference(*terms, **kw)
    torch.cuda.synchronize()
    scale = ref.abs().max().item()
    # Both sides compute each activation with the same bits (the kernel in
    # the plain epilogue's order, IEEE round-to-nearest) and sum in f32 in
    # another order: rtol 1e-5, atol 1e-4 * max (the JAX kernel's bar).
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-4 * scale)
    rec = {"shape": [n, oh, ow, f], "dtype": str(dtype).replace("torch.", ""),
           "normalize_patches": flags[0], "whitener_means": flags[1],
           "max_abs_err": (got - ref).abs().max().item()}
    if timed:
        rec["ms"] = cuda_ms(lambda: rp.conv_rect_pool(*terms, **kw))
        rec["plain_ms"] = cuda_ms(lambda: rp.conv_rect_pool_reference(*terms, **kw))
        rec["bound_ms"], rec["bound_by"] = conv_rect_pool_bound(terms, got.numel())
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    log(f"conv_rect_pool {rec}")
    return rec


def time_conv_rect_pool(n: int, gen) -> dict:
    """The fused entry's time on ``n`` images of the production shape (bf16
    activations, every term), and its share of the bound."""
    _, oh, ow, f, stride, size, alpha, max_val = PROD
    terms = conv_terms(n, oh, ow, f, gen)
    kw = dict(pool_stride=stride, pool_size=size, alpha=alpha, max_val=max_val)
    ms = cuda_ms(lambda: rp.conv_rect_pool(*terms, **kw), reps=50)
    bound_ms, _ = conv_rect_pool_bound(terms, n * 4 * 2 * f)
    log(f"conv_rect_pool at batch {n}: {ms:.4f} ms, {100 * bound_ms / ms:.1f} % of its "
        f"{bound_ms:.4f} ms bound")
    return {"ms": ms, "bound_ms": bound_ms, "bound_share": bound_ms / ms}


def fv_stats_bound(n: int, d: int, cols: int, k: int) -> tuple[float, str]:
    """Least time for the statistics: x read once and s0/s1/s2 written once,
    against the 8*k*d*D f32 operations of the four contractions per image
    (the k*D exps are left out, in the bound's favour)."""
    bytes_ms = (n * d * cols * 4 + n * (k + 2 * d * k) * 4) / HBM_BYTES_PER_S * 1e3
    ops_ms = 8 * k * d * cols * n / F32_FLOPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def fv_stats_f64(args, n_valid, chunk: int = 8) -> torch.Tensor:
    """The plain version's Fisher vectors on the same inputs in f64, a few
    images at a time (the [n, k, D] posteriors are 1.2 GB per 8 images)."""
    x, counts, means, variances, weights = (
        None if a is None else (a.double() if a.is_floating_point() else a) for a in args
    )
    gmm = (means, variances, weights)
    return torch.cat([
        _fv_from_stats(
            *fs.fv_stats_reference(x[i : i + chunk], None if counts is None else counts[i : i + chunk], *gmm),
            *gmm, n_valid[i : i + chunk].double(),
        )
        for i in range(0, x.shape[0], chunk)
    ])


def time_fv_stats(n: int, gen, d: int = FV_PROD[1], cols: int = FV_PROD[2],
                  k: int = FV_PROD[3], plain: bool = False) -> dict:
    """The kernel's time on ``n`` images of ``[d, cols]`` descriptors (the
    VOC production shape by default), its share of the bound, and with
    ``plain`` the plain version's time on the same inputs."""
    x = torch.randn((n, d, cols), generator=gen, device="cuda")
    means = torch.randn((d, k), generator=gen, device="cuda")
    variances = 0.5 + 1.5 * torch.rand((d, k), generator=gen, device="cuda")
    weights = torch.full((k,), 1.0 / k, device="cuda")
    args = (x, None, means, variances, weights)
    ms = cuda_ms(lambda: fs.fv_stats(*args), reps=10)
    bound_ms, bound_by = fv_stats_bound(n, d, cols, k)
    rec = {"shape": [n, d, cols], "k": k, "ms": ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "bound_share": bound_ms / ms}
    if plain:
        rec["plain_ms"] = cuda_ms(lambda: fs.fv_stats_reference(*args), reps=3, warmup=1)
    del x
    log(f"fv_stats at batch {n} of [{d}, {cols}], k {k}: {ms:.4f} ms, "
        f"{100 * bound_ms / ms:.1f} % of its {bound_ms:.4f} ms bound"
        + (f", plain {rec['plain_ms']:.4f} ms" if plain else ""))
    return rec


def check_fv_stats(shape, gen, timed: bool) -> dict:
    n, d, cols, k, ragged = shape
    x = torch.randn((n, d, cols), generator=gen, device="cuda")
    means = torch.randn((d, k), generator=gen, device="cuda")
    variances = 0.5 + 1.5 * torch.rand((d, k), generator=gen, device="cuda")
    weights = 0.5 + torch.rand((k,), generator=gen, device="cuda")
    weights /= weights.sum()
    counts = (torch.randint(cols // 2, cols + 1, (n,), generator=gen, device="cuda")
              .to(torch.int32) if ragged else None)
    n_valid = (counts.to(torch.float32) if ragged
               else torch.full((n,), float(cols), device="cuda"))
    args = (x, counts, means, variances, weights)
    got = _fv_from_stats(*fs.fv_stats(*args), means, variances, weights, n_valid)
    plain = _fv_from_stats(*fs.fv_stats_reference(*args), means, variances, weights, n_valid)
    torch.cuda.synchronize()
    # Oracle: the plain version in f64 on the same inputs.  The plain f32
    # version sums each of its D-long contractions in one f32 chain and at
    # D = 73,866 drifts past the bar itself; the kernel sums in tiles and
    # stays 10x closer to f64.  Bar: rtol 2e-4, atol 2e-5 * max (the JAX
    # kernel's bar, scaled by the output's largest value).
    ref = fv_stats_f64(args, n_valid)
    scale = ref.abs().max().item()
    torch.testing.assert_close(got.double(), ref, rtol=2e-4, atol=2e-5 * scale)
    rec = {"shape": [n, d, cols], "k": k, "ragged": ragged,
           "max_abs_err": (got.double() - ref).abs().max().item(),
           "plain_f32_max_abs_err": (plain.double() - ref).abs().max().item(),
           "kernel_vs_plain_f32": (got - plain).abs().max().item(),
           "max_abs": scale}
    del ref, got, plain
    if timed:
        rec["ms"] = cuda_ms(lambda: fs.fv_stats(*args), reps=10)
        rec["plain_ms"] = cuda_ms(lambda: fs.fv_stats_reference(*args), reps=5, warmup=1)
        rec["bound_ms"], rec["bound_by"] = fv_stats_bound(n, d, cols, k)
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    log(f"fv_stats {rec}")
    return rec


def idct_bound(n_blocks: int) -> tuple[float, str]:
    """Least time for the IDCT: each f32 block read once and written once,
    against two 8x8x8 products (2 * 512 FMAs = 2048 f32 flops) per block."""
    bytes_ms = n_blocks * 64 * 4 * 2 / HBM_BYTES_PER_S * 1e3
    ops_ms = n_blocks * 2048 / F32_FLOPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def check_idct(shape, gen, timed: bool) -> dict:
    # Dequantised coefficients of a 90-quality JPEG lie within about +-1000.
    x = 200.0 * torch.randn(shape, generator=gen, device="cuda")
    got = jd.idct_blocks(x)
    torch.cuda.synchronize()
    # Oracle: the plain version in f64 on the same inputs (the basis is the
    # same f32 constants).  Bar: rtol 1e-6, atol 2e-6 * max: two 8-term f32
    # sums of terms up to max|x| keep about 16 ulps.
    ref = jd.idct_blocks_reference(x.double())
    scale = ref.abs().max().item()
    torch.testing.assert_close(got.double(), ref, rtol=1e-6, atol=2e-6 * scale)
    rec = {"shape": list(shape), "max_abs_err": (got.double() - ref).abs().max().item(),
           "max_abs": scale}
    if timed:
        a = jd._basis(x.device, torch.float32)
        rec["ms"] = cuda_ms(lambda: jd.idct_blocks(x), reps=50)
        rec["plain_ms"] = cuda_ms(lambda: jd.idct_blocks_reference(x), reps=50)
        rec["library_ms"] = cuda_ms(lambda: torch.einsum("ij,njk,kl->nil", a.T, x, a), reps=50)
        rec["bound_ms"], rec["bound_by"] = idct_bound(x.numel() // 64)
    log(f"idct {rec}")
    return rec


def decode_bound(coeffs, out: torch.Tensor) -> tuple[float, str]:
    """Least time for the whole decode: the int16 coefficients (and the quant
    tables) read once and the f32 BGR pixels written once.  The operations
    (an IDCT's 2048 flops per block, a few dozen per pixel) sit far below."""
    read = sum(c.numel() * c.element_size() for c in coeffs)
    return (read + out.numel() * 4) / HBM_BYTES_PER_S * 1e3, "bytes"


def random_coeff_batch(case, gen):
    """Seeded quantised coefficients of one geometry on the card, scaled as
    a quality-90 encoder leaves them (larger at low frequencies), with a
    quant table per image."""
    b, h, w, sampling = case
    hmax = max(s[0] for s in sampling)
    vmax = max(s[1] for s in sampling)
    block_shape = tuple((-(-h // (8 * vmax)) * v, -(-w // (8 * hmax)) * hh)
                        for hh, v in sampling)
    geom = jd.JpegGeometry(h, w, sampling, block_shape)
    freq = torch.arange(8, device="cuda")
    scale = 40.0 / (1.0 + freq[:, None] + freq[None, :])
    coeffs = [(torch.randn((b, by, bx, 8, 8), generator=gen, device="cuda") * scale)
              .round().to(torch.int16) for by, bx in block_shape]
    qt = torch.randint(1, 9, (b, len(sampling), 8, 8), generator=gen, device="cuda").float()
    return geom, coeffs, qt


def check_decode(case, gen) -> dict:
    geom, coeffs, qt = random_coeff_batch(case, gen)
    got = jd.decode_pixels(geom, coeffs, qt)
    torch.cuda.synchronize()
    ref = jd.decode_pixels_reference(geom, coeffs, qt)
    # Bar: bit equality with the composition on the card (the IDCT kernel
    # in it); every step of the kernel rounds as there.
    if not torch.equal(got, ref):
        raise AssertionError(f"decode {case[:3]} {geom.sampling}: {int((got != ref).sum())} "
                             f"pixels differ from the composition")
    rec = {"batch": case[0], "size": [geom.height, geom.width],
           "sampling": [list(s) for s in geom.sampling], "max_abs_err": 0.0}
    log(f"decode {rec}")
    return rec


def time_decode(geom, coeffs, qt) -> dict:
    """The fused decode and the unfused composition on the card, each timed
    alone, and the decode's bound (coefficients already on the card)."""
    out = jd.decode_pixels(geom, coeffs, qt)
    rec = {"batch": int(qt.shape[0]),
           "ms": cuda_ms(lambda: jd.decode_pixels(geom, coeffs, qt), reps=50),
           "plain_ms": cuda_ms(lambda: jd.decode_pixels_reference(geom, coeffs, qt), reps=20)}
    rec["bound_ms"], rec["bound_by"] = decode_bound(coeffs, out)
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    log(f"decode timing {rec}")
    return rec


def voc_images(rng, shapes: dict, num_classes: int = VOC_NUM_CLASSES) -> MultiLabeledImages:
    """Seeded VOC-shaped images: BGR f32 in [0, 255].  Each image has a
    primary class and, with probability 0.25, a second one.  A class is a
    colour plus an oriented grating with its own orientation and period;
    the second class's grating covers a random half of the image.  Noise
    and random phases and amplitudes make every image different."""
    palette = np.random.default_rng(1).uniform(50, 205, (num_classes, 3))
    angles = np.pi * np.arange(num_classes) / num_classes
    periods = 6.0 + 3.0 * (np.arange(num_classes) % 5)
    images, labels = [], []
    for (h, w), count in shapes.items():
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        for _ in range(count):
            classes = [int(rng.integers(num_classes))]
            if rng.random() < 0.25:
                classes.append(int((classes[0] + rng.integers(1, num_classes)) % num_classes))
            img = rng.standard_normal((h, w, 3), dtype=np.float32) * 20.0
            img += palette[classes[0]].astype(np.float32)
            for i, c in enumerate(classes):
                wave = np.float32(rng.uniform(40, 70)) * np.sin(
                    (xx * np.cos(angles[c]) + yy * np.sin(angles[c])) * (2 * np.pi / periods[c])
                    + rng.uniform(0, 2 * np.pi)
                )
                if i == 1:  # the second class fills one random half
                    half = (xx < w / 2) if rng.random() < 0.5 else (yy < h / 2)
                    wave *= half ^ bool(rng.random() < 0.5)
                img += wave[:, :, None]
            images.append(np.clip(img, 0, 255))
            labels.append(classes)
    order = rng.permutation(len(images))
    return MultiLabeledImages([images[i] for i in order], [labels[i] for i in order],
                              [f"synthetic/{i:06d}.jpg" for i in range(len(images))])


def write_cifar(path: Path, n: int, rng, palette) -> None:
    """CIFAR-binary records of separable synthetic images: a class colour
    from ``palette`` (shared between splits) plus noise, and a class-
    frequency wave in one channel."""
    xx = np.arange(32, dtype=np.float64)[None, None, :]
    with open(path, "wb") as fh:
        for i in range(0, n, 5000):
            m = min(5000, n - i)
            labels = rng.integers(0, N_CLASSES, m)
            img = palette[labels][:, :, None, None] + rng.normal(0, 25, (m, 3, 32, 32))
            img[np.arange(m), labels % 3] += 30 * np.sin(xx / (2.0 + labels[:, None, None]))
            recs = np.empty((m, 3073), np.uint8)
            recs[:, 0] = labels
            recs[:, 1:] = np.clip(img, 0, 255).astype(np.uint8).reshape(m, -1)
            recs.tofile(fh)


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a - b).abs().max() / b.abs().max()).item()


def featurize_breakdown(featurizer, images: np.ndarray) -> dict:
    """One production chunk's featurize stages: the host's share (preparing
    the numpy block, the pageable host -> card copy, as
    ``cifar_random_patch._chunks`` makes them; host clock around each, ending
    in a synchronize) and the card's (CUDA events): the cuDNN convolution,
    the mu/sigma terms, the fused kernel, the featurizer as the path calls
    it, and the unfused chain of the parent as its yardstick (the Convolver's
    epilogue, the bf16 cast, rect+pool)."""
    conv = featurizer.conv
    kw = dict(pool_stride=featurizer.pool_stride, pool_size=featurizer.pool_size,
              alpha=featurizer.alpha, max_val=featurizer.max_val)
    dtype = featurizer.activation_dtype

    def host_ms(fn, reps=10):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times)

    block = np.ascontiguousarray(images, np.float32)
    batch = torch.from_numpy(block).cuda()
    x = conv._images(batch)
    terms = conv.terms(batch)

    def unfused():
        z = convolver_epilogue(*conv.terms(batch), conv.fsum, conv.filter_means_dot)
        return rp.rect_pool(z.to(dtype), **kw)

    z = convolver_epilogue(*terms, conv.fsum, conv.filter_means_dot)
    fused, plain = featurizer(batch), unfused()
    torch.testing.assert_close(fused, plain, rtol=1e-5, atol=1e-4 * plain.abs().max().item())
    return {
        "chunk": int(batch.shape[0]),
        "host_prepare_ms": host_ms(lambda: np.ascontiguousarray(images, np.float32)),
        "h2d_pageable_ms": host_ms(lambda: torch.from_numpy(block).to("cuda")),
        "h2d_bytes": block.nbytes,
        "cudnn_conv_ms": cuda_ms(lambda: torch.nn.functional.conv2d(x, conv._weight), reps=10),
        "mu_sigma_ms": cuda_ms(lambda: conv.patch_stats(x), reps=10),
        "terms_ms": cuda_ms(lambda: conv.terms(batch), reps=10),
        "fused_kernel_ms": cuda_ms(lambda: rp.conv_rect_pool(
            *terms, conv.fsum, conv.filter_means_dot, activation_dtype=dtype, **kw), reps=10),
        "featurizer_ms": cuda_ms(lambda: featurizer(batch), reps=10),
        "unfused_epilogue_ms": cuda_ms(lambda: convolver_epilogue(
            *terms, conv.fsum, conv.filter_means_dot), reps=10),
        "unfused_cast_ms": cuda_ms(lambda: z.to(dtype), reps=10),
        "unfused_rect_pool_ms": cuda_ms(lambda: rp.rect_pool(z.to(dtype), **kw), reps=10),
        "unfused_featurizer_ms": cuda_ms(unfused, reps=10),
        "featurize_chunk_host_ms": host_ms(
            lambda: cifar.featurize_chunked(featurizer, images, len(images), "cuda"), reps=5),
    }


def run_voc(card: str) -> tuple:
    """Phases 6 and 7: the VOCSIFTFisher main path, its servable apply, and
    card against CPU.  Returns the fv_stats launches of the path, the two
    splits and the MAP."""
    rng = np.random.default_rng(7)
    t = time.perf_counter()
    train = voc_images(rng, VOC_SHAPES)
    test = voc_images(rng, VOC_SHAPES)
    log(f"VOC data: {len(train)} train / {len(test)} test images in "
        f"{time.perf_counter() - t:.1f} s")
    conf = voc.SIFTFisherConfig(**VOC_CONF)

    torch.cuda.reset_peak_memory_stats()
    fs.launches = 0
    res = voc.run(conf, train, test)
    fit_launches = fs.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    servable = voc.servable_pipeline(conf, res["bundle"])
    land = [i for i, img in enumerate(test.images) if img.shape[:2] == (375, 500)][:16]
    batch = np.stack([test.images[i] for i in land])
    offline = res["test_scores"][land]
    for chunk in (1, 4, 16):
        served = np.concatenate([
            servable(torch.from_numpy(batch[i : i + chunk]).cuda()).cpu().numpy()
            for i in range(0, len(batch), chunk)
        ])
        err = np.abs(served - offline).max()
        if not err <= 1e-4 * np.abs(offline).max():
            raise AssertionError(f"servable apply at batch {chunk} differs from the "
                                 f"offline scores by {err}")
    main_launches = fs.launches
    need = 2 * len(VOC_SHAPES)  # one FV call per shape bucket per split
    if fit_launches < need:
        raise AssertionError(f"fv_stats launched {fit_launches} times, expected >= {need}")
    if not res["map"] >= 0.5:  # chance is the class prevalence, about 0.06
        raise AssertionError(f"VOC MAP {res['map']} is below 0.5")
    log(json.dumps({
        "main_path": "VOCSIFTFisher", "card": card,
        "train_images": len(train), "test_images": len(test),
        "feature_dim": 2 * conf.desc_dim * conf.vocab_size,
        "map": res["map"], "seconds": res["seconds"],
        **{k: res[k] for k in ("sift_seconds", "pca_seconds", "gmm_seconds",
                               "fisher_seconds", "solve_seconds", "eval_seconds",
                               "featurize_images_per_sec")},
        "peak_memory_gb": peak_gb,
        "fv_stats_launches_fit": fit_launches,
        "fv_stats_launches_serve": main_launches - fit_launches,
    }))

    # 7. Card against CPU inside the port, on one fitted state.
    arrays = convert.voc_to_arrays(servable)
    x = torch.from_numpy(batch[:4])
    fitted = {dev: convert.voc_from_arrays(**arrays, device=dev) for dev in ("cuda", "cpu")}
    f32_sift = SIFTExtractor(step_size=conf.sift_step_size, scale_step=conf.scale_step)
    within, cpu_descs = {}, {}
    for name, sift in (("f32", f32_sift), ("bf16", voc.make_sift(conf))):
        on_card = sift(grayscale(x.cuda())).cpu()
        cpu_descs[name] = sift(grayscale(x))
        within[name] = (on_card - cpu_descs[name]).abs().le(1.0).float().mean().item()
    # From identical (the CPU's f32) descriptors: the statistics, kernel on
    # the card against the plain version on the CPU, at the JAX kernel's bar
    # scaled by each statistic's largest value; then the features of both
    # sides against the f64 chain.  Two f32 chains cannot be held to 1e-3 of
    # each other here: PCA-projected SIFT descriptors are not centred, so the
    # Fisher vector's s2 - 2 mu s1 + (mu^2 - var) s0 cancels, and the signed
    # square root magnifies the near-zero entries; the card must be no
    # further from f64 than the CPU's plain chain (plus 1e-3 * max).
    gmm = {dev: fitted[dev].gmm for dev in fitted}
    pca_desc = {dev: fitted[dev].pca(cpu_descs["f32"].to(dev)) for dev in fitted}
    stats = {dev: [t.cpu() for t in fs.fv_stats(pca_desc[dev], None, gmm[dev].means,
                                                gmm[dev].variances, gmm[dev].weights)]
             for dev in fitted}
    stat_errs = [((a - b).abs().max() / b.abs().max()).item()
                 for a, b in zip(stats["cuda"], stats["cpu"])]
    feats = {dev: fisher_feature_pipeline(gmm[dev])(pca_desc[dev]).cpu() for dev in fitted}
    g64 = [t.double() for t in (gmm["cpu"].means, gmm["cpu"].variances, gmm["cpu"].weights)]
    exact = fisher_feature_pipeline(GaussianMixtureModel(*g64))(pca_desc["cpu"].double())
    scale = exact.abs().max().item()
    card_err = (feats["cuda"].double() - exact).abs().max().item() / scale
    cpu_err = (feats["cpu"].double() - exact).abs().max().item() / scale
    log(f"VOC card vs cpu: SIFT descriptors within +-1: f32 {within['f32']:.6f}, bf16 "
        f"{within['bf16']:.6f} (bound 0.995); FV statistics s0/s1/s2 max rel err "
        f"{stat_errs} (bound 2e-5 + 2e-4); features from f64, max rel err card "
        f"{card_err:.3e}, cpu {cpu_err:.3e}")
    if not min(within.values()) >= 0.995:
        raise AssertionError(f"SIFT descriptors card vs cpu within +-1: {within}")
    for a, b in zip(stats["cuda"], stats["cpu"]):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-5 * b.abs().max().item())
    if not card_err <= cpu_err + 1e-3:
        raise AssertionError(f"card features {card_err} further from f64 than the cpu's {cpu_err}")
    return main_launches, train, test, res["map"]


JPEG_PREFIX = "VOCdevkit/VOC2007/JPEGImages/"


def write_voc_tars(root: Path, splits: dict) -> dict:
    """Encode each split's images as baseline JPEGs (q90, 4:2:0) into
    ``root/<split>.tar`` under ``JPEG_PREFIX``, with one labels CSV in the
    format ``voc_labels_map`` parses.  Returns member name -> (JPEG bytes,
    encoder coefficients, source image) for the test split."""
    rows = ['"id","class","classname","traintesteval","filename"']
    test_members = {}
    with ThreadPoolExecutor(8) as pool:
        for split, data in splits.items():
            encoded = pool.map(lambda img: encode_jpeg(img, 90, "4:2:0"), data.images)
            with tarfile.open(root / f"{split}.tar", "w") as tf:
                for i, ((jpeg, coeffs), labels) in enumerate(zip(encoded, data.labels)):
                    name = f"{JPEG_PREFIX}{split}_{i:06d}.jpg"
                    info = tarfile.TarInfo(name)
                    info.size = len(jpeg)
                    tf.addfile(info, io.BytesIO(jpeg))
                    rows.extend(f'{len(rows)},{c + 1},"c{c}",1,"{name}"' for c in labels)
                    if split == "test":
                        test_members[name] = (jpeg, coeffs, data.images[i])
    (root / "labels.csv").write_text("\n".join(rows) + "\n")
    return test_members


def run_voc_tar(card: str, train, test, memory_map: float) -> tuple[int, int, dict]:
    """Phase 8: VOCSIFTFisher from JPEG tars through ``--streamIngest
    --deviceDecode``.  Returns the decode and fv_stats launches of the path
    and the decode's timings at batches 1 and 64."""
    _build.BUILD_DIR.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as tmp:
        root = Path(tmp)
        t = time.perf_counter()
        members = write_voc_tars(root, {"train": train, "test": test})
        encode_secs = time.perf_counter() - t
        jpeg_bytes = (root / "test.tar").stat().st_size / len(test)
        log(f"VOC JPEG tars: {len(train)} + {len(test)} images encoded in {encode_secs:.1f} s")

        for counter in (ingest.counters, native_entropy.counters, image_loaders.skipped):
            counter.clear()
        torch.cuda.reset_peak_memory_stats()
        jd.launches = jd.decode_launches = fs.launches = 0
        res = voc.main([
            "--trainLocation", str(root / "train.tar"), "--testLocation", str(root / "test.tar"),
            "--labelPath", str(root / "labels.csv"), "--streamIngest", "--deviceDecode",
            "--streamBatchSize", "64", "--device", "cuda",
        ])
        fit_decode, fit_fv = jd.decode_launches, fs.launches
        peak_gb = torch.cuda.max_memory_allocated() / 1e9

        # (f) the servable chain fed coefficient batches of one geometry.
        conf = voc.SIFTFisherConfig(device="cuda")
        servable = voc.servable_pipeline(conf, res["bundle"])
        order = {name: i for i, name in enumerate(res["test_filenames"])}
        chunk = [n for n in res["test_filenames"] if members[n][2].shape[:2] == (375, 500)][:64]
        images = [jd.entropy_decode(members[n][0], backend="native") for n in chunk]
        coeffs, qt = jd.stack_coeff_images(images)
        geom = images[0].geom
        offline = res["test_scores"][[order[n] for n in chunk[:16]]]
        for b in (1, 4, 16):
            served = np.concatenate([
                jd.fused_apply(servable, geom, [c[i : i + b] for c in coeffs], qt[i : i + b],
                               "cuda").cpu().numpy()
                for i in range(0, 16, b)
            ])
            err = np.abs(served - offline).max()
            if not err <= 1e-4 * np.abs(offline).max():
                raise AssertionError(f"fused_apply at batch {b} differs from the offline "
                                     f"scores by {err}")
        decode_launches, fv_launches, idct_launches = jd.decode_launches, fs.launches, jd.launches

    stats = res["ingest"]
    chunks = sum(s["batches"] for s in stats.values())
    # (a) the native entropy pass ran, with nothing skipped or routed away.
    for split, st in stats.items():
        if st["entropy_backend"] != "native":
            raise AssertionError(f"{split}: entropy backend {st['entropy_backend']!r}")
        if st["skipped"] or st["device_fallbacks"] or st["entropy_corrupt"]:
            raise AssertionError(f"{split}: skips or fallbacks in the stream: {st}")
    if ingest.counters or native_entropy.counters or image_loaders.skipped:
        raise AssertionError(f"counted events: {ingest.counters} {native_entropy.counters} "
                             f"{image_loaders.skipped}")
    # (b) one chunk's entropy decode against the encoder's coefficients.
    for name, img in zip(chunk, images):
        if not all(np.array_equal(a, b) for a, b in zip(img.coeffs, members[name][1])):
            raise AssertionError(f"{name}: entropy decode != the encoder's coefficients")
    # (c) that chunk decoded on the card: bit for bit the unfused composition
    # on the card, and against the port's CPU decode.
    dev_coeffs = [torch.from_numpy(c).cuda() for c in coeffs]
    dev_qt = torch.from_numpy(qt).cuda()
    fused = jd.decode_pixels(geom, dev_coeffs, dev_qt)
    if not torch.equal(fused, jd.decode_pixels_reference(geom, dev_coeffs, dev_qt)):
        raise AssertionError("card decode of the chunk differs from the unfused composition")
    on_card = jd.decode_batch(geom, coeffs, qt, "cuda").cpu()
    on_cpu = jd.decode_batch(geom, coeffs, qt, "cpu")
    diff = (on_card - on_cpu).abs()
    equal = diff.eq(0).float().mean().item()
    if not (diff.max().item() <= 1.0 and equal >= 0.999):
        raise AssertionError(f"card decode vs cpu: max {diff.max().item()}, equal {equal}")
    source = torch.from_numpy(np.stack([members[n][2] for n in chunk]))
    source_err = (on_card - source).abs().mean().item()
    # (d) accuracy, against the in-memory run of phase 6 on the same images.
    if not (res["map"] >= 0.5 and abs(res["map"] - memory_map) <= 0.05):
        raise AssertionError(f"VOC MAP from JPEG tars {res['map']} (in memory {memory_map})")
    # (e) the path went through the fused decode (two launches a chunk) and
    # the statistics kernel, and never through the IDCT entry on its own.
    if not (fit_decode >= 2 * chunks and fv_launches >= chunks and idct_launches == 0):
        raise AssertionError(f"launches: decode {fit_decode}, fv_stats {fv_launches}, "
                             f"idct {idct_launches}, {chunks} chunks")
    # Device decode of one production chunk and of one image, coefficients
    # already on the card (these launches are measurements, not the path's).
    decode_times = {b: time_decode(geom, [c[:b] for c in dev_coeffs], dev_qt[:b])
                    for b in (1, len(chunk))}
    decode_ms = decode_times[len(chunk)]["ms"]
    h2d_ms = cuda_ms(lambda: [torch.from_numpy(c).cuda() for c in coeffs], reps=10)
    log(json.dumps({
        "main_path": "VOCSIFTFisher from JPEG tars, --streamIngest --deviceDecode",
        "card": card, "train_images": len(train), "test_images": len(test),
        "map": res["map"], "map_in_memory": memory_map, "seconds": res["seconds"],
        **{k: res[k] for k in ("sift_seconds", "pca_seconds", "gmm_seconds",
                               "fisher_seconds", "solve_seconds", "eval_seconds",
                               "featurize_images_per_sec")},
        "peak_memory_gb": peak_gb, "encode_seconds": encode_secs,
        "jpeg_bytes_per_image": jpeg_bytes,
        "entropy_backend": stats["train"]["entropy_backend"],
        "host_entropy_thread_seconds": {k: s["decode_seconds"] for k, s in stats.items()},
        "chunks": chunks, "device_decode_ms_per_chunk": decode_ms,
        "unfused_decode_ms_per_chunk": decode_times[len(chunk)]["plain_ms"],
        "device_decode_seconds_est": decode_ms * chunks / 1e3,
        "coeff_h2d_ms_per_chunk": h2d_ms,
        "coeff_bytes_per_image": geom.coeff_bytes(),
        "pixel_bytes_per_image": geom.height * geom.width * 3 * 4,
        "decode_launches_fit": fit_decode, "decode_launches_serve": decode_launches - fit_decode,
        "idct_launches": idct_launches,
        "fv_stats_launches_fit": fit_fv, "fv_stats_launches_serve": fv_launches - fit_fv,
        "card_vs_cpu_decode_max_abs": diff.max().item(), "card_vs_cpu_decode_equal": equal,
        "decoded_vs_source_mean_abs": source_err,
    }))
    return decode_launches, fv_launches, decode_times


def mnist_stroke_maps(rng) -> np.ndarray:
    """Ten seeded class maps on the 28x28 grid, each five Gaussian blobs
    (a stroke's ink probability, 0 far from the blobs), flattened to 784."""
    yy, xx = np.mgrid[0:28, 0:28]
    maps = np.zeros((10, 28, 28))
    for c in range(10):
        for _ in range(5):
            cy, cx = rng.uniform(6, 22, 2)
            s = rng.uniform(1.5, 3.0)
            maps[c] += np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
    return np.clip(maps, 0, 1).reshape(10, MNIST_PIXELS)


def mnist_rows(rng, n: int, maps: np.ndarray) -> np.ndarray:
    """``n`` MNIST-shaped rows: the 1-indexed label, then 784 integer pixels
    in [0, 255].  A pixel is inked with probability 0.7 times its class map,
    at a level in [128, 255], else 0: about 13 % of pixels are inked (MNIST:
    19 %), and pixel means stay below their spread, as in MNIST, so no
    rectified FFT feature is zero on every row."""
    labels = rng.integers(0, 10, n)
    ink = rng.random((n, MNIST_PIXELS)) < 0.7 * maps[labels]
    pixels = np.rint(ink * rng.uniform(128, 255, (n, MNIST_PIXELS)))
    return np.column_stack([labels + 1, pixels]).astype(np.int64)


def write_csv(path: Path, rows: np.ndarray) -> None:
    """Integer rows as comma-separated text, the reference's CSV layout."""
    text = np.array([str(i) for i in range(int(rows.max()) + 1)])
    with open(path, "w") as fh:
        for i in range(0, len(rows), 5000):
            fh.write("\n".join(",".join(r) for r in text[rows[i : i + 5000]]) + "\n")


def kernel_launches() -> dict:
    return {"rect_pool": rp.launches, "conv_rect_pool": rp.fused_launches,
            "fv_stats": fs.launches, "idct_blocks": jd.launches,
            "decode_pixels": jd.decode_launches}


def mnist_record(res: dict, peak_gb: float) -> dict:
    """The run's errors, stage seconds and peak memory; raises unless the
    model is finite and both errors are below 10 % (chance is 90 %)."""
    model = res["servable"].nodes[1]
    if not all(bool(torch.isfinite(t).all()) for t in [*model.xs, model.b]):
        raise AssertionError("MnistRandomFFT model is not finite")
    if not (res["train_error"] < 10.0 and res["test_error"] < 10.0):
        raise AssertionError(f"MnistRandomFFT errors {res['train_error']}% / "
                             f"{res['test_error']}% are not below 10%")
    return {
        "features": sum(int(x.shape[0]) for x in model.xs), "blocks": len(model.xs),
        "train_error": res["train_error"], "test_error": res["test_error"],
        **{k: res[k] for k in ("featurize_seconds", "featurize_examples_per_sec",
                               "solve_seconds", "eval_seconds", "seconds")},
        "peak_memory_gb": peak_gb,
    }


def run_mnist(card: str) -> None:
    """Phases 9-11: MnistRandomFFT at BASELINE config 1 through the CLI, at
    the reference's default width in memory, then its servable apply and
    card against CPU.  No hand kernel may launch in them."""
    rng = np.random.default_rng(11)
    maps = mnist_stroke_maps(rng)
    train_rows = mnist_rows(rng, MNIST_TRAIN, maps)
    test_rows = mnist_rows(rng, MNIST_TEST, maps)
    before = kernel_launches()
    torch.cuda.empty_cache()

    # 9. BASELINE config 1 from CSV files, through the CLI.
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as tmp:
        train_path, test_path = Path(tmp) / "train.csv", Path(tmp) / "test.csv"
        t = time.perf_counter()
        write_csv(train_path, train_rows)
        write_csv(test_path, test_rows)
        write_secs = time.perf_counter() - t
        csv_bytes = train_path.stat().st_size + test_path.stat().st_size
        torch.cuda.reset_peak_memory_stats()
        res = mnist.main(["--trainLocation", str(train_path),
                          "--testLocation", str(test_path), *MNIST_FLAGS])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    servable, offline = res["servable"], res["test_predictions"]
    log(json.dumps({
        "main_path": "MnistRandomFFT BASELINE config 1 (--numFFTs 4 --blockSize 2048)",
        "card": card, "train_rows": MNIST_TRAIN, "test_rows": MNIST_TEST,
        "csv_write_seconds": write_secs, "csv_bytes": csv_bytes,
        "csv_load_seconds": res["load_seconds"], **mnist_record(res, peak_gb),
    }))
    del res

    # 10. The reference's default width on the same rows, in memory.
    train = LabeledData.from_rows(train_rows.astype(np.float32), one_indexed=True)
    test = LabeledData.from_rows(test_rows.astype(np.float32), one_indexed=True)
    conf = mnist.MnistRandomFFTConfig(num_ffts=MNIST_WIDE_FFTS, block_size=2048, device="cuda")
    groups = -(-MNIST_WIDE_FFTS // (conf.block_size // 512))
    # The train features as a list, and their concatenation in the fit, then
    # the test features: 4 bytes each.
    estimate_gb = (2 * MNIST_TRAIN + MNIST_TEST) * groups * conf.block_size * 4 / 1e9
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    wide = mnist.run(conf, train, test)
    wide_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rec = mnist_record(wide, wide_peak_gb)
    if not wide_peak_gb < 80.0:
        raise AssertionError(f"--numFFTs {MNIST_WIDE_FFTS} peaked at {wide_peak_gb} GB")
    log(json.dumps({
        "main_path": f"MnistRandomFFT --numFFTs {MNIST_WIDE_FFTS} --blockSize 2048 (in memory)",
        "card": card, "train_rows": MNIST_TRAIN, "test_rows": MNIST_TEST, **rec,
        "peak_estimate_gb": estimate_gb,
    }))
    del wide
    torch.cuda.empty_cache()

    # 11. The servable chain at served batches, then card against CPU.
    x = torch.from_numpy(test.data[:256])
    for chunk in (1, 4, 16, 64):
        served = np.concatenate([servable(x[i : i + chunk].cuda()).cpu().numpy()
                                 for i in range(0, len(x), chunk)])
        if not np.array_equal(served, offline[:256]):
            raise AssertionError(f"MNIST servable apply at batch {chunk} != offline predictions")
    arrays = convert.mnist_to_arrays(servable)
    rows = torch.from_numpy(test.data[:MNIST_CARD_VS_CPU_ROWS])
    out = {}
    for dev in ("cuda", "cpu"):
        fitted = convert.mnist_from_arrays(**arrays, device=dev)
        feats = fitted.servable.nodes[0](rows.to(dev))
        scores = fitted.model(feats)
        out[dev] = (feats.cpu(), scores.cpu(), MaxClassifier()(scores).cpu())
    feat_err = (out["cuda"][0] - out["cpu"][0]).abs().max().item()
    feat_max = out["cpu"][0].abs().max().item()
    score_err = (out["cuda"][1] - out["cpu"][1]).abs().max().item()
    score_max = out["cpu"][1].abs().max().item()
    differ = int((out["cuda"][2] != out["cpu"][2]).sum())
    log(f"MNIST card vs cpu on {len(rows)} rows: features max abs err {feat_err:.4e} of max "
        f"{feat_max:.4e} (bound 1e-5·max), scores {score_err:.4e} of max {score_max:.4e} "
        f"(bound 1e-3·max), {differ} predictions differ (bound 0)")
    if not (feat_err <= 1e-5 * feat_max and score_err <= 1e-3 * score_max and differ == 0):
        raise AssertionError("MNIST card and CPU disagree beyond the bounds")
    after = kernel_launches()
    if after != before:
        raise AssertionError(f"hand kernels launched in the MNIST phases: {before} -> {after}")
    log(f"MNIST phases: kernel launch counters unchanged {after}")


def timit_split(rng, n: int, centres: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``n`` synthetic phone frames: a class centre plus Gaussian noise per
    frame, with the per-dimension variance 1 (centre share TIMIT_CENTRE_SCALE
    squared), rounded to 0.01 as the CSV stores them.  Returns (frames f32
    [n, 440], 0-indexed labels)."""
    labels = rng.integers(0, TIMIT_NUM_CLASSES, n)
    noise = math.sqrt(1.0 - TIMIT_CENTRE_SCALE**2)
    frames = centres[labels] + noise * rng.standard_normal((n, TIMIT_DIMENSION))
    hundredths = np.clip(np.rint(frames * 100), -999, 999).astype(np.int64)
    return (hundredths / 100.0).astype(np.float32), labels


def write_timit_split(data_path: Path, labels_path: Path, frames: np.ndarray,
                      labels: np.ndarray) -> None:
    """Frames as comma-separated text with two decimals, and the sparse
    1-indexed ``row label`` file, the reference's TIMIT layout."""
    text = np.array([f"{k / 100:.2f}" for k in range(-999, 1000)])
    codes = np.rint(frames * 100).astype(np.int64) + 999
    with open(data_path, "w") as fh:
        for i in range(0, len(codes), 4096):
            fh.write("\n".join(",".join(r) for r in text[codes[i : i + 4096]]) + "\n")
    labels_path.write_text("".join(f"{i + 1} {c + 1}\n" for i, c in enumerate(labels)))


def timit_record(res: dict, peak_gb: float, estimate_gb: float) -> dict:
    """The run's error, stage seconds and peak memory; raises unless the
    model is finite, the test error is below 20 % (chance 146/147) and the
    peak is below 80 GB."""
    model = res["servable"].nodes[1]
    if not all(bool(torch.isfinite(t).all()) for t in [*model.xs, model.b]):
        raise AssertionError("TIMIT model is not finite")
    if not res["test_error"] < 20.0:
        raise AssertionError(f"TIMIT test error {res['test_error']}% is not below 20%")
    if not peak_gb < 80.0:
        raise AssertionError(f"TIMIT peaked at {peak_gb} GB")
    return {
        "features": sum(int(x.shape[0]) for x in model.xs), "blocks": len(model.xs),
        "test_error": res["test_error"],
        **{k: res[k] for k in ("featurize_seconds", "solve_seconds", "eval_seconds", "seconds")},
        "peak_memory_gb": peak_gb, "peak_estimate_gb": estimate_gb,
    }


def timit_peak_estimate(n: int, blocks: int, width: int) -> float:
    """GB the fit holds at its peak: the training blocks and their
    concatenation, the blocks' Cholesky factors, and three centred blocks
    (the one in use, the next, and the centring's intermediate)."""
    return (2 * n * blocks * width + blocks * width * width + 3 * n * width) * 4 / 1e9


def run_timit(card: str) -> None:
    """Phases 12-13: TimitPipeline at BASELINE config 4 through the CLI on
    CSVs, a Cauchy run at depth 4, then card against CPU and the servable
    chain at served batches.  No hand kernel may launch in them."""
    rng = np.random.default_rng(13)
    centres = rng.normal(0.0, TIMIT_CENTRE_SCALE, (TIMIT_NUM_CLASSES, TIMIT_DIMENSION))
    train_frames, train_labels = timit_split(rng, TIMIT_TRAIN, centres)
    test_frames, test_labels = timit_split(rng, TIMIT_TEST, centres)
    before = kernel_launches()
    torch.cuda.empty_cache()

    # 12. BASELINE config 4 from CSV files, through the CLI.
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as tmp:
        paths = [Path(tmp) / name for name in ("train.csv", "train.labels", "test.csv",
                                               "test.labels")]
        t = time.perf_counter()
        write_timit_split(paths[0], paths[1], train_frames, train_labels)
        write_timit_split(paths[2], paths[3], test_frames, test_labels)
        write_secs = time.perf_counter() - t
        csv_bytes = sum(p.stat().st_size for p in paths)
        torch.cuda.reset_peak_memory_stats()
        flags = ["--trainDataLocation", "--trainLabelsLocation", "--testDataLocation",
                 "--testLabelsLocation"]
        res = timit.main([a for pair in zip(flags, map(str, paths)) for a in pair]
                         + TIMIT_FLAGS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    estimate_gb = timit_peak_estimate(TIMIT_TRAIN, 50, 4096)
    servable, offline = res["servable"], res["test_scores"].argmax(axis=1)
    log(json.dumps({
        "main_path": "TimitPipeline BASELINE config 4 (--numCosines 50, 4096 features each, "
                     "--numEpochs 5, lambda 0)",
        "card": card, "train_rows": TIMIT_TRAIN, "test_rows": TIMIT_TEST,
        "csv_write_seconds": write_secs, "csv_bytes": csv_bytes,
        "csv_load_seconds": res["load_seconds"], **timit_record(res, peak_gb, estimate_gb),
    }))
    del res
    torch.cuda.empty_cache()

    # The other draw: Cauchy W at depth 4, in memory.  Its kernel is
    # exp(-gamma * L1 distance): at gamma 0.05555 any two 440-dim frames are
    # ~e^-27 apart, so the run uses a gamma that suits the frames' scale.
    data = TimitFeaturesData(TimitSplit(train_frames, train_labels.astype(np.int32)),
                             TimitSplit(test_frames, test_labels.astype(np.int32)))
    conf = timit.TimitConfig(**TIMIT_CAUCHY, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    cauchy = timit.run(conf, data)
    cauchy_peak = torch.cuda.max_memory_allocated() / 1e9
    log(json.dumps({
        "main_path": f"TimitPipeline --rfType cauchy --numCosines {conf.num_cosines} "
                     f"--gamma {conf.gamma} (in memory)",
        "card": card, **timit_record(cauchy, cauchy_peak,
                                     timit_peak_estimate(TIMIT_TRAIN, conf.num_cosines, 4096)),
    }))
    del cauchy
    torch.cuda.empty_cache()

    # 13. Served batches, then card against CPU on one fitted state.
    x = torch.from_numpy(test_frames[:256])
    for chunk in (1, 4, 16, 64):
        served = np.concatenate([servable(x[i : i + chunk].cuda()).cpu().numpy()
                                 for i in range(0, len(x), chunk)])
        if not np.array_equal(served, offline[:256]):
            raise AssertionError(f"TIMIT servable apply at batch {chunk} != offline predictions")
    arrays = convert.timit_to_arrays(servable)
    del servable
    rows = torch.from_numpy(test_frames[:TIMIT_CARD_VS_CPU_ROWS])
    out = {}
    for dev in ("cuda", "cpu"):
        fitted = convert.timit_from_arrays(**arrays, device=dev)
        feats = fitted.servable.nodes[0](rows.to(dev))
        scores = fitted.model(feats)
        out[dev] = (feats.cpu(), scores.cpu(), MaxClassifier()(scores).cpu())
        del fitted, feats, scores
    feat_err = (out["cuda"][0] - out["cpu"][0]).abs().max().item()
    feat_max = out["cpu"][0].abs().max().item()
    score_err = (out["cuda"][1] - out["cpu"][1]).abs().max().item()
    score_max = out["cpu"][1].abs().max().item()
    differ = int((out["cuda"][2] != out["cpu"][2]).sum())
    log(f"TIMIT card vs cpu on {len(rows)} rows: features max abs err {feat_err:.4e} of max "
        f"{feat_max:.4e} (bound 1e-5·max), scores {score_err:.4e} of max {score_max:.4e} "
        f"(bound 1e-3·max), {differ} predictions differ (bound 0)")
    if not (feat_err <= 1e-5 * feat_max and score_err <= 1e-3 * score_max and differ == 0):
        raise AssertionError("TIMIT card and CPU disagree beyond the bounds")
    after = kernel_launches()
    if after != before:
        raise AssertionError(f"hand kernels launched in the TIMIT phases: {before} -> {after}")
    log(f"TIMIT phases: kernel launch counters unchanged {after}")


def run_cifar_variants(card: str, train_path: Path, test_path: Path) -> dict:
    """Phase 14: LinearPixels and RandomCifar through their CLIs on phase
    3's files; RandomCifar's featurize must go through the conv_rect_pool
    entry of the rect+pool kernel (f32 activations) and never through the
    rect_pool entry.  Then one 2048-image chunk's Convolver terms through
    the entry and its plain version on the card.  Returns the entry's
    record on that chunk, with RandomCifar's launches."""
    before = kernel_launches()
    lp = linear_pixels.main(["--trainLocation", str(train_path),
                             "--testLocation", str(test_path), "--device", "cuda"])
    if kernel_launches() != before:
        raise AssertionError("LinearPixels launched a hand kernel")
    lp_error = 100.0 * (1.0 - lp["test_accuracy"])
    rp.launches = rp.fused_launches = 0
    rc = random_cifar.main(["--trainLocation", str(train_path),
                            "--testLocation", str(test_path), *RANDOM_CIFAR_FLAGS])
    rc_fused, rc_unfused = rp.fused_launches, rp.launches
    need = math.ceil(N_TRAIN / 2048) + math.ceil(N_TEST / 2048)
    if rc_fused < need or rc_unfused:
        raise AssertionError(f"RandomCifar: conv_rect_pool launched {rc_fused} times, expected "
                             f">= {need}; rect_pool {rc_unfused} times, expected 0")
    if not (lp_error < 45.0 and rc["test_error"] < 45.0):  # chance is 90%
        raise AssertionError(f"test errors LinearPixels {lp_error}%, RandomCifar "
                             f"{rc['test_error']}% are not well under chance")
    log(json.dumps({
        "main_path": "LinearPixels and RandomCifar", "card": card,
        "train_images": N_TRAIN, "test_images": N_TEST,
        "linear_pixels": {"train_accuracy": lp["train_accuracy"],
                          "test_accuracy": lp["test_accuracy"], "test_error": lp_error,
                          "seconds": lp["seconds"]},
        "random_cifar": {k: rc[k] for k in ("train_error", "test_error", "seconds",
                                            "featurize_seconds", "featurize_images_per_sec",
                                            "solve_seconds")},
        "conv_rect_pool_launches": rc_fused, "rect_pool_launches": rc_unfused,
    }))

    # One production chunk of RandomCifar's Convolver terms through the entry.
    featurizer = rc["servable"].nodes[0]
    conv = featurizer.conv
    images = cifar_loader(str(test_path)).images[:2048]
    terms = (*conv.terms(torch.from_numpy(np.ascontiguousarray(images)).cuda()),
             conv.fsum, conv.filter_means_dot)
    kw = dict(pool_stride=featurizer.pool_stride, pool_size=featurizer.pool_size,
              alpha=featurizer.alpha, activation_dtype=torch.float32)
    got = rp.conv_rect_pool(*terms, **kw)
    ref = rp.conv_rect_pool_reference(*terms, **kw)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    # Both sides compute the same f32 activations and sum them in another
    # order: 1e-5 * max.
    if not err <= 1e-5 * scale:
        raise AssertionError(f"conv_rect_pool f32 on RandomCifar terms: {err} > 1e-5 * {scale}")
    rec = {"shape": list(terms[0].shape), "dtype": "float32", "max_abs_err": err,
           "max_abs": scale,
           "ms": cuda_ms(lambda: rp.conv_rect_pool(*terms, **kw)),
           "plain_ms": cuda_ms(lambda: rp.conv_rect_pool_reference(*terms, **kw)),
           "launches": rc_fused}
    rec["bound_ms"], rec["bound_by"] = conv_rect_pool_bound(terms, got.numel())
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    log(f"conv_rect_pool on a RandomCifar chunk {rec}")
    return rec


def run_newsgroups(card: str) -> None:
    """Phase 15: NewsgroupsPipeline at BASELINE config 2 through the CLI on
    a synthetic tree of the 20news-bydate split's size, then naive-Bayes
    scores card against CPU and at served batches.  No hand kernel may
    launch in it."""
    before = kernel_launches()
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as tmp:
        root = Path(tmp)
        rng = np.random.default_rng(17)
        t = time.perf_counter()
        tokens = 0
        for split, total in (("train", NG_TRAIN), ("test", NG_TEST)):
            per_class = [total // 20 + (c < total % 20) for c in range(20)]
            tokens += write_newsgroups_tree(root / split, NG_CLASSES, per_class, rng)
        write_secs = time.perf_counter() - t
        t = time.perf_counter()
        test = newsgroups_loader(str(root / "test"))
        load_secs = time.perf_counter() - t
        res = newsgroups.main(["--trainLocation", str(root / "train"),
                               "--testLocation", str(root / "test"), *NG_FLAGS])
    if not res["test_error"] < 20.0:  # chance is 95%
        raise AssertionError(f"Newsgroups test error {res['test_error']}% is not below 20%")
    if res["num_features"] != 100_000:
        raise AssertionError(f"Newsgroups kept {res['num_features']} features, not 100,000")
    log(json.dumps({
        "main_path": "NewsgroupsPipeline BASELINE config 2 (--nGrams 2 --commonFeatures 100000)",
        "card": card, "train_docs": NG_TRAIN, "test_docs": NG_TEST, "tokens": tokens,
        "write_seconds": write_secs, "test_load_seconds": load_secs,
        **{k: res[k] for k in ("test_error", "seconds", "text_seconds", "score_seconds",
                               "num_features", "test_nnz")},
    }))

    # Served batches reproduce the offline scores bit for bit; then the same
    # fitted state scores on the CPU.
    nodes = res["servable"].nodes  # the text nodes, vectorizer, model, argmax
    vectorizer, model = nodes[-3:-1]
    score = Pipeline(nodes[:-1])
    docs = test.data[:NG_CARD_VS_CPU_DOCS]
    offline = res["test_scores"]
    for chunk in (1, 4, 16, 64):
        served = np.concatenate([score(docs[i : i + chunk]).cpu().numpy()
                                 for i in range(0, 64, chunk)])
        if not np.array_equal(served, offline[:64]):
            raise AssertionError(f"Newsgroups scores at batch {chunk} differ from offline")
    csr = Pipeline(nodes[:-2])(docs)
    on_cpu = convert.newsgroups_from_arrays(
        vocabulary=list(vectorizer.feature_space), pi=model.pi.cpu().numpy(),
        theta=model.theta.cpu().numpy(), device="cpu",
    ).model(csr).numpy()
    on_card = offline[: len(docs)]
    err = np.abs(on_card - on_cpu).max()
    scale = np.abs(on_cpu).max()
    differ = int((on_card.argmax(axis=1) != on_cpu.argmax(axis=1)).sum())
    log(f"Newsgroups card vs cpu on {len(docs)} documents: scores max abs err {err:.4e} of max "
        f"{scale:.4e} (bound 1e-5·max), {differ} predictions differ (bound 0)")
    if not (err <= 1e-5 * scale and differ == 0):
        raise AssertionError("Newsgroups card and CPU disagree beyond the bounds")
    after = kernel_launches()
    if after != before:
        raise AssertionError(f"hand kernels launched in the Newsgroups phase: {before} -> {after}")
    log(f"Newsgroups phase: kernel launch counters unchanged {after}")


def imagenet_class_params(num_classes: int = IMAGENET_CLASSES) -> tuple:
    """Each class's colour, grating orientation, grating period and grating
    channel.  The colours are distinct points of a 10x10x10 grid over
    [40, 215] (seeded order), so LCS's local colour statistics carry the
    class; the 96 gratings (8 orientations, 4 periods, 3 channels) carry it
    in SIFT's gradients too."""
    levels = np.linspace(40.0, 215.0, 10)
    grid = np.stack(np.meshgrid(levels, levels, levels, indexing="ij"), -1).reshape(-1, 3)
    palette = grid[np.random.default_rng(1).permutation(len(grid))[:num_classes]]
    c = np.arange(num_classes)
    angles = np.pi * (c % 8) / 8
    periods = np.array([5.0, 7.0, 10.0, 14.0])[(c // 8) % 4]
    return palette, angles, periods, (c // 32) % 3


def imagenet_images(seed: int, labels: np.ndarray, shapes: list) -> list:
    """Seeded synthetic BGR images in [0, 255], integer-valued, made on the
    card: the class colour jittered by up to 3 levels, pixel noise of
    spread 12, and the class grating (amplitude 40-60, random phase) in the
    class channel.  Returns one f32 [H, W, 3] host array per label."""
    palette, angles, periods, channels = imagenet_class_params()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = [None] * len(labels)
    for shape in sorted(set(shapes)):
        idx = np.array([i for i, s in enumerate(shapes) if s == shape])
        h, w = shape
        yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device="cuda"),
                                torch.arange(w, dtype=torch.float32, device="cuda"),
                                indexing="ij")
        for i in range(0, len(idx), 64):
            part = idx[i : i + 64]
            c = labels[part]
            b = len(part)

            def t(a):
                return torch.as_tensor(a, dtype=torch.float32, device="cuda")

            base = t(palette[c]) + 6.0 * torch.rand((b, 3), generator=gen, device="cuda") - 3.0
            phase = 2 * np.pi * torch.rand((b, 1, 1), generator=gen, device="cuda")
            amp = 40.0 + 20.0 * torch.rand((b, 1, 1), generator=gen, device="cuda")
            a, period = t(angles[c])[:, None, None], t(periods[c])[:, None, None]
            wave = amp * torch.sin((xx * torch.cos(a) + yy * torch.sin(a)) * (2 * np.pi / period)
                                   + phase)
            img = base[:, None, None, :] + 12.0 * torch.randn((b, h, w, 3), generator=gen,
                                                              device="cuda")
            img[torch.arange(b, device="cuda"), :, :, t(channels[c]).long()] += wave
            host = img.clamp_(0, 255).round_().cpu().numpy()
            for j, k in enumerate(part):
                out[k] = host[j]
    return out


def imagenet_split(seed: int, per_class: int) -> LabeledImages:
    """``per_class`` images of each of the 1,000 classes, alternating
    between the two image sizes, in a seeded random order."""
    labels = np.repeat(np.arange(IMAGENET_CLASSES), per_class)
    shapes = [IMAGENET_SHAPES[i % 2] for i in range(len(labels))]
    images = imagenet_images(seed, labels, shapes)
    order = np.random.default_rng(seed).permutation(len(labels))
    return LabeledImages([images[i] for i in order], labels[order].astype(np.int32),
                         [f"synthetic/{i:07d}" for i in range(len(labels))])


def imagenet_peak_lower_bound(train: LabeledImages, conf) -> float:
    """GB the fit holds at once in the SIFT branch's PCA fit: the raw SIFT
    training descriptors (f32, 128 each) and the column sample three times
    over (the sample, its centred copy and the QR factorisation's copy of
    it).  A lower bound of the peak: the QR factorisation's workspace and
    what the process held before the run come on top and are not reckoned.
    The projected descriptors replace the raw ones bucket by bucket, and the
    test split is featurized 32 images at a time, so neither raises it."""
    sift = SIFTExtractor(scale_step=conf.sift_scale_step)
    cols = sum(sift.num_descriptors(*img.shape[:2]) for img in train.images)
    return (cols + 3 * min(cols, conf.num_pca_samples)) * 128 * 4 / 1e9


class BranchLaunches:
    """Counts the fv_stats launches of each descriptor branch while it is
    active (it wraps ``imagenet_sift_lcs_fv.branch_features``)."""

    def __enter__(self) -> dict:
        self.counts = {b: 0 for b in inet.BRANCHES}
        self._orig = inet.branch_features

        def counted(conf, train_images, test_images, branch):
            before = fs.launches
            try:
                return self._orig(conf, train_images, test_images, branch)
            finally:
                self.counts[branch] += fs.launches - before

        inet.branch_features = counted
        return self.counts

    def __exit__(self, *exc) -> None:
        inet.branch_features = self._orig


def imagenet_record(res: dict) -> dict:
    """The run's errors and stage seconds; raises unless the model is
    finite and the top-5 error is below 50 % (chance 99.5 %)."""
    model = res["bundle"]["model"]
    if not all(bool(torch.isfinite(t).all()) for t in [*model.xs, model.b]):
        raise AssertionError("ImageNetSiftLcsFV model is not finite")
    if not res["top5_err_percent"] < 50.0:
        raise AssertionError(f"ImageNetSiftLcsFV top-5 error {res['top5_err_percent']}% "
                             "is not below 50%")
    return {k: res[k] for k in ("top5_err_percent", "top1_err_percent", "seconds",
                                "sift_branch_seconds", "lcs_branch_seconds", "solve_seconds",
                                "eval_seconds", "featurize_images_per_sec",
                                "branch_stage_seconds")}


def run_imagenet(card: str) -> tuple:
    """Phases 17 and 18: ImageNetSiftLcsFV in memory at full width, its
    fitted branches applied to served batches, then card against CPU.
    Returns the fv_stats launches of the path (fit, eval and served
    batches) and the two splits."""
    t = time.perf_counter()
    train = imagenet_split(19, IMAGENET_TRAIN_PER_CLASS)
    test = imagenet_split(23, IMAGENET_TEST_PER_CLASS)
    data_secs = time.perf_counter() - t
    conf = inet.ImageNetSiftLcsFVConfig(num_classes=IMAGENET_CLASSES, device="cuda")
    bound_gb = imagenet_peak_lower_bound(train, conf)
    log(f"ImageNet data: {len(train)} train / {len(test)} test images in {data_secs:.1f} s; "
        f"reckoned peak at least {bound_gb:.2f} GB (raw SIFT descriptors and the PCA sample "
        "three times over; the QR workspace not reckoned)")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fs.launches = 0
    with BranchLaunches() as by_branch:
        res = inet.run(conf, train, test)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    fit_launches = fs.launches
    rec = imagenet_record(res)
    if not all(by_branch[b] > 0 for b in inet.BRANCHES):
        raise AssertionError(f"fv_stats launches by branch {by_branch}")
    if not bound_gb <= peak_gb < 80.0:
        raise AssertionError(f"ImageNetSiftLcsFV peaked at {peak_gb} GB (reckoned at least "
                             f"{bound_gb} GB)")

    # The fitted branches on new images: batches of 1, 4 and 16 test images
    # of one size reproduce the offline scores.
    fitted = convert.FittedImageNet(res["bundle"], conf)
    land = [i for i, img in enumerate(test.images) if img.shape[:2] == IMAGENET_SHAPES[0]][:16]
    offline = res["test_scores"][land]
    for chunk in (1, 4, 16):
        served = np.concatenate([
            fitted.scores([test.images[j] for j in land[i : i + chunk]]).cpu().numpy()
            for i in range(0, len(land), chunk)
        ])
        err = np.abs(served - offline).max()
        if not err <= 1e-4 * np.abs(offline).max():
            raise AssertionError(f"ImageNet scores at batch {chunk} differ from the offline "
                                 f"scores by {err} (max {np.abs(offline).max()})")
    main_launches = fs.launches
    log(json.dumps({
        "main_path": "ImageNetSiftLcsFV BASELINE config 5 (in memory)", "card": card,
        "classes": IMAGENET_CLASSES, "train_images": len(train), "test_images": len(test),
        "feature_dim": 2 * 2 * conf.desc_dim * conf.vocab_size, "data_seconds": data_secs,
        **rec, "peak_memory_gb": peak_gb, "peak_lower_bound_gb": bound_gb,
        "fv_stats_launches_fit": fit_launches, "fv_stats_launches_by_branch": by_branch,
        "fv_stats_launches_serve": main_launches - fit_launches,
    }))
    arrays = convert.imagenet_to_arrays(res["bundle"], conf)
    del res, fitted
    torch.cuda.empty_cache()
    imagenet_card_vs_cpu(arrays, [test.images[j] for j in land[:4]])
    return main_launches, train, test


def imagenet_card_vs_cpu(arrays: dict, images: list) -> dict:
    """Phase 18: one fitted state on the card and on the CPU; four images
    through both branches on both.  Bars: quantised SIFT descriptors (scale
    step 1, bf16) within +-1 on >= 99.5 % of entries and LCS descriptors
    within rtol 1e-5, atol 255e-6 (the CPU tests' bar against the JAX
    package; the same f32 multiplies and adds run on both devices); from
    identical descriptors, the Fisher statistics within rtol 2e-4, atol
    2e-5·max, and the features and scores no further from their f64
    evaluation on the card than on the CPU plus 1e-3·max (phase 7's bars)."""
    fitted = {dev: convert.imagenet_from_arrays(**arrays, device=dev) for dev in ("cuda", "cpu")}
    conf = fitted["cpu"].conf
    x = torch.from_numpy(np.stack(images))
    sift = SIFTExtractor(scale_step=conf.sift_scale_step, compute_dtype=torch.bfloat16)
    sift_cpu = sift(grayscale(x))
    sift_within = (sift(grayscale(x.cuda())).cpu() - sift_cpu).abs().le(1.0).float().mean().item()
    lcs = LCSExtractor(conf.lcs_stride, conf.lcs_border, conf.lcs_patch)
    lcs_cpu = lcs(x)
    lcs_card = lcs(x.cuda()).cpu()
    lcs_err = (lcs_card - lcs_cpu).abs().max().item()
    if not sift_within >= 0.995:
        raise AssertionError(f"SIFT descriptors card vs cpu within +-1: {sift_within}")
    torch.testing.assert_close(lcs_card, lcs_cpu, rtol=1e-5, atol=255e-6)

    descs = {"sift": SignedHellingerMapper()(sift_cpu), "lcs": lcs_cpu}
    feats = {"cuda": [], "cpu": []}
    exact, stat_errs = [], {}
    for b in inet.BRANCHES:
        pca_desc, gmm = {}, {}
        for dev in fitted:
            pca_desc[dev] = fitted[dev].bundle[f"{b}_pca"](descs[b].to(dev))
            gmm[dev] = fitted[dev].bundle[f"{b}_gmm"]
        stats = {dev: [t.cpu() for t in fs.fv_stats(pca_desc[dev], None, gmm[dev].means,
                                                    gmm[dev].variances, gmm[dev].weights)]
                 for dev in fitted}
        for card_stat, cpu_stat in zip(stats["cuda"], stats["cpu"]):
            torch.testing.assert_close(card_stat, cpu_stat, rtol=2e-4,
                                       atol=2e-5 * cpu_stat.abs().max().item())
        stat_errs[b] = [rel_err(a, c) for a, c in zip(stats["cuda"], stats["cpu"])]
        for dev in fitted:
            feats[dev].append(fisher_feature_pipeline(gmm[dev])(pca_desc[dev]).cpu())
        g64 = GaussianMixtureModel(*(t.double() for t in (gmm["cpu"].means, gmm["cpu"].variances,
                                                          gmm["cpu"].weights)))
        exact.append(fisher_feature_pipeline(g64)(pca_desc["cpu"].double()))
    exact_feats = torch.cat(exact, dim=1)
    model = fitted["cpu"].bundle["model"]
    model64 = BlockLinearMapper([m.double() for m in model.xs], model.block_size, model.b.double())
    exact_scores = model64(exact_feats)
    errs = {}
    for dev in fitted:
        f = torch.cat(feats[dev], dim=1)
        s = fitted[dev].bundle["model"](f.to(dev)).cpu()
        errs[dev] = (((f.double() - exact_feats).abs().max() / exact_feats.abs().max()).item(),
                     ((s.double() - exact_scores).abs().max() / exact_scores.abs().max()).item())
    rec = {"sift_within_1": sift_within, "lcs_max_abs_err": lcs_err,
           "fv_stats_rel_err": stat_errs,
           "features_rel_err_from_f64": {d: e[0] for d, e in errs.items()},
           "scores_rel_err_from_f64": {d: e[1] for d, e in errs.items()}}
    log(f"ImageNet card vs cpu on {len(images)} images: {json.dumps(rec)}")
    for i, what in enumerate(("features", "scores")):
        if not errs["cuda"][i] <= errs["cpu"][i] + 1e-3:
            raise AssertionError(f"card {what} {errs['cuda'][i]} further from f64 than the "
                                 f"cpu's {errs['cpu'][i]}")
    return rec


def synset(c: int) -> str:
    return f"n{c:08d}"


def write_imagenet_tars(root: Path, splits: dict) -> None:
    """Encode each split's images as baseline JPEGs (q90, 4:2:0) into
    ``root/<split>/<synset>.tar``, one tar per class with members
    ``<synset>/<split>_<i>.JPEG``, and write ``root/labels.txt``, one
    ``synset class-id`` line per class."""
    (root / "labels.txt").write_text(
        "".join(f"{synset(c)} {c}\n" for c in range(IMAGENET_CLASSES)))
    with ThreadPoolExecutor(8) as pool:
        for split, data in splits.items():
            (root / split).mkdir()
            encoded = list(pool.map(lambda img: encode_jpeg(img, 90, "4:2:0")[0], data.images))
            by_class: dict = {}
            for i, (jpeg, c) in enumerate(zip(encoded, data.labels)):
                by_class.setdefault(int(c), []).append((i, jpeg))
            for c, members in by_class.items():
                with tarfile.open(root / split / f"{synset(c)}.tar", "w") as tf:
                    for i, jpeg in members:
                        info = tarfile.TarInfo(f"{synset(c)}/{split}_{i:06d}.JPEG")
                        info.size = len(jpeg)
                        tf.addfile(info, io.BytesIO(jpeg))


def run_imagenet_tar(card: str, train: LabeledImages, test: LabeledImages) -> tuple[int, int]:
    """Phase 19: ImageNetSiftLcsFV from JPEG tars through ``--streamIngest
    --deviceDecode``, on one training image per class and the first 500
    test images of phase 17, then in memory on the same pixel arrays.
    Returns the decode and fv_stats launches of the tar path."""
    first: dict = {}
    for i, c in enumerate(train.labels):
        first.setdefault(int(c), i)
    keep = sorted(first.values())
    sub_train = LabeledImages([train.images[i] for i in keep], train.labels[keep],
                              [train.filenames[i] for i in keep])
    sub_test = LabeledImages(test.images[:IMAGENET_TAR_TEST], test.labels[:IMAGENET_TAR_TEST],
                             test.filenames[:IMAGENET_TAR_TEST])
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as tmp:
        root = Path(tmp)
        t = time.perf_counter()
        write_imagenet_tars(root, {"train": sub_train, "test": sub_test})
        encode_secs = time.perf_counter() - t
        tar_bytes = sum(p.stat().st_size for p in root.glob("*/*.tar"))
        log(f"ImageNet JPEG tars: {len(sub_train)} + {len(sub_test)} images encoded in "
            f"{encode_secs:.1f} s")
        for counter in (ingest.counters, native_entropy.counters, image_loaders.skipped):
            counter.clear()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        jd.launches = jd.decode_launches = fs.launches = 0
        with BranchLaunches() as by_branch:
            res = inet.main([
                "--trainLocation", str(root / "train"), "--testLocation", str(root / "test"),
                "--labelPath", str(root / "labels.txt"), "--streamIngest", "--deviceDecode",
                "--numClasses", str(IMAGENET_CLASSES), "--device", "cuda",
            ])
        decode_launches, fv_launches, idct_launches = jd.decode_launches, fs.launches, jd.launches
        peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # The native entropy pass ran with nothing skipped or routed away, and
    # every pass over a split saw the same survivors (the source checks
    # their names; here their counts).
    chunks = 0
    for split, passes in res["ingest"].items():
        want = len(sub_train) if split == "train" else len(sub_test)
        if len(passes) != 2 or any(p["decoded"] != want for p in passes):
            raise AssertionError(f"{split}: passes {passes}")
        for st in passes:
            if st["entropy_backend"] != "native":
                raise AssertionError(f"{split}: entropy backend {st['entropy_backend']!r}")
            if st["skipped"] or st["device_fallbacks"] or st["entropy_corrupt"]:
                raise AssertionError(f"{split}: skips or fallbacks in the stream: {st}")
            chunks += st["batches"]
    if ingest.counters or native_entropy.counters or image_loaders.skipped:
        raise AssertionError(f"counted events: {ingest.counters} {native_entropy.counters} "
                             f"{image_loaders.skipped}")
    # The fused decode ran (two launches a chunk), the IDCT entry never did,
    # and the statistics kernel ran in both branches.
    if not (decode_launches >= 2 * chunks and idct_launches == 0
            and all(by_branch[b] > 0 for b in inet.BRANCHES)):
        raise AssertionError(f"launches: decode {decode_launches}, idct {idct_launches}, "
                             f"fv_stats by branch {by_branch}, {chunks} chunks")
    rec = imagenet_record(res)
    del res
    torch.cuda.empty_cache()
    memory = inet.run(inet.ImageNetSiftLcsFVConfig(num_classes=IMAGENET_CLASSES, device="cuda"), sub_train, sub_test)
    if not abs(rec["top5_err_percent"] - memory["top5_err_percent"]) <= 2.0:
        raise AssertionError(f"top-5 error from JPEG tars {rec['top5_err_percent']}% vs "
                             f"{memory['top5_err_percent']}% in memory on the same pixels")
    log(json.dumps({
        "main_path": "ImageNetSiftLcsFV from JPEG tars, --streamIngest --deviceDecode",
        "card": card, "train_images": len(sub_train), "test_images": len(sub_test),
        **rec, "top5_err_percent_in_memory": memory["top5_err_percent"],
        "top1_err_percent_in_memory": memory["top1_err_percent"],
        "peak_memory_gb": peak_gb, "encode_seconds": encode_secs,
        "tar_bytes_per_image": tar_bytes / (len(sub_train) + len(sub_test)),
        "chunks": chunks, "decode_launches": decode_launches, "idct_launches": idct_launches,
        "fv_stats_launches": fv_launches, "fv_stats_launches_by_branch": by_branch,
    }))
    return decode_launches, fv_launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is available", file=sys.stderr)
        return 1
    # The synthetic data lives under the checkout's git-ignored build/.
    _build.BUILD_DIR.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as tmp:
        return smoke(Path(tmp))


def smoke(data_dir: Path) -> int:
    """Every phase, the CIFAR files of phases 3 and 14 under ``data_dir``."""
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    resolve_device("cuda")  # full f32, no TF32, for every plain version timed below
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 1. Build every kernel from the checkout's sources.
    t = time.perf_counter()
    libs = _build.build("rect_pool", "fv_stats", "idct", "entropy")
    log(f"built {sorted(libs)} in {time.perf_counter() - t:.2f} s")

    # 2. Kernel against its plain version on the card.
    gen = torch.Generator(device="cuda").manual_seed(0)
    prod = check_rect_pool(PROD, torch.bfloat16, gen, timed=True)
    prod_f32 = check_rect_pool(PROD, torch.float32, gen, timed=True)
    odd = [check_rect_pool(s, dt, gen, timed=False)
           for s in ODD for dt in (torch.float32, torch.bfloat16)]
    log("rect_pool library_ms: null (no single PyTorch call rectifies and "
        "sum-pools both signs)")
    fused_prod = check_conv_rect_pool(PROD, torch.bfloat16, (True, True), gen, timed=True)
    fused_prod_f32 = check_conv_rect_pool(PROD, torch.float32, (True, True), gen, timed=True)
    fused_odd = [check_conv_rect_pool(s, dt, fl, gen, timed=False)
                 for s in ODD for dt in (torch.float32, torch.bfloat16) for fl in FUSED_FLAGS]
    fused_odd += [check_conv_rect_pool((64, *PROD[1:]), torch.bfloat16, fl, gen, timed=False)
                  for fl in FUSED_FLAGS[1:]]
    fused_served = {n: time_conv_rect_pool(n, gen) for n in K1_SERVED}
    log("conv_rect_pool library_ms: null (no single PyTorch call applies the "
        "Convolver's epilogue, rectifies and sum-pools both signs)")
    fv_prod = check_fv_stats(FV_PROD, gen, timed=True)
    fv_odd = [check_fv_stats(s, gen, timed=False) for s in FV_ODD]
    torch.cuda.empty_cache()
    fv_served = {n: time_fv_stats(n, gen) for n in FV_SERVED}
    torch.cuda.empty_cache()
    fv_imagenet = {}
    for branch, (cols, ragged) in FV_IMAGENET.items():
        fv_imagenet[branch] = check_fv_stats((8, 64, cols, 16, ragged), gen, timed=False)
        fv_imagenet[branch]["by_batch"] = {
            n: time_fv_stats(n, gen, 64, cols, 16, plain=True) for n in FV_IMAGENET_BATCHES}
        torch.cuda.empty_cache()
    log("fv_stats library_ms: null (no single PyTorch call computes GMM "
        "posteriors and their weighted moments)")
    idct_prod = check_idct(IDCT_PROD, gen, timed=True)
    idct_odd = [check_idct(s, gen, timed=False) for s in IDCT_ODD]
    decode_checks = [check_decode(case, gen) for case in DECODE_CASES]
    torch.cuda.empty_cache()
    log("decode_pixels library_ms: null (no single PyTorch call decodes JPEG "
        "coefficients to pixels; the IDCT entry's yardstick is torch.einsum)")

    train_path, test_path = data_dir / "train.bin", data_dir / "test.bin"
    rng = np.random.default_rng(5)
    palette = rng.uniform(40, 215, (N_CLASSES, 3))
    write_cifar(train_path, N_TRAIN, rng, palette)
    write_cifar(test_path, N_TEST, rng, palette)
    test = cifar_loader(str(test_path))
    test_images = test.images

    # 3. + 4. The main path: fit, eval, then the servable apply.
    rp.launches = rp.fused_launches = 0
    res = cifar.main(["--trainLocation", str(train_path),
                      "--testLocation", str(test_path), *MAIN_FLAGS])
    fit_launches = rp.fused_launches
    servable = res["servable"]
    for chunk in (1, 4, 16, 64):
        served = cifar.apply_servable_chunked(servable, test_images[:256], chunk)
        if not np.array_equal(served, res["test_predictions"][:256]):
            raise AssertionError(f"servable apply at batch {chunk} != offline predictions")
    main_launches, unfused_launches = rp.fused_launches, rp.launches
    need = math.ceil(N_TRAIN / 2048) + math.ceil(N_TEST / 2048)
    if fit_launches < need or unfused_launches:
        raise AssertionError(f"conv_rect_pool launched {fit_launches} times, expected >= "
                             f"{need}; rect_pool {unfused_launches} times, expected 0")
    if not res["test_error"] < 45.0:  # chance is 90%
        raise AssertionError(f"test error {res['test_error']}% is not well under chance")
    log(json.dumps({
        "main_path": "RandomPatchCifar", "card": card,
        "train_images": N_TRAIN, "test_images": N_TEST,
        "train_error": res["train_error"], "test_error": res["test_error"],
        "featurize_images_per_sec": res["featurize_images_per_sec"],
        "featurize_seconds": res["featurize_seconds"],
        "learn_seconds": res["learn_seconds"],
        "solve_seconds": res["solve_seconds"], "seconds": res["seconds"],
        "conv_rect_pool_launches_fit": fit_launches,
        "conv_rect_pool_launches_serve": main_launches - fit_launches,
        "rect_pool_launches": unfused_launches,
    }))
    log("featurize breakdown " + json.dumps(
        {"card": card, **featurize_breakdown(servable.nodes[0], test_images[:2048])}
    ))

    # 5. Card against CPU inside the port, on one fitted state.
    arrays = convert.to_arrays(servable)
    x = torch.from_numpy(test_images[:256])
    for dtype, bound in ((torch.bfloat16, 1e-2), (torch.float32, 2e-5)):
        state = {**arrays, "activation_dtype": dtype}
        on_card = convert.from_arrays(**state, device="cuda").featurizer(x).cpu()
        on_cpu = convert.from_arrays(**state, device="cpu").featurizer(x)
        err = rel_err(on_card, on_cpu)
        log(f"features card vs cpu ({dtype}): max rel err {err:.3e} (bound {bound})")
        if dtype == torch.float32:
            torch.testing.assert_close(on_card, on_cpu, rtol=bound,
                                       atol=bound * on_cpu.abs().max().item())
        elif not err <= bound:
            raise AssertionError(f"bf16 features differ by {err} > {bound}")
    labels = ClassLabelIndicatorsFromIntLabels(N_CLASSES)(torch.from_numpy(test.labels[:256]))
    models = {}
    for dev in ("cuda", "cpu"):
        feats = on_cpu.to(dev)
        scaled = StandardScaler().fit(feats)(feats)
        model = BlockLeastSquaresEstimator(4096, 1, 10.0).fit(scaled, labels.to(dev))
        models[dev] = (model.xs[0].cpu(), model(scaled).cpu())
    w_err = rel_err(models["cuda"][0], models["cpu"][0])
    s_err = rel_err(models["cuda"][1], models["cpu"][1])
    log(f"solve card vs cpu: weights max rel err {w_err:.3e}, scores {s_err:.3e} (bound 1e-3)")
    if not (w_err <= 1e-3 and s_err <= 1e-3):
        raise AssertionError("the solve differs between card and CPU beyond 1e-3")

    voc_launches, voc_train, voc_test, voc_map = run_voc(card)
    decode_launches, tar_fv_launches, decode_times = run_voc_tar(card, voc_train, voc_test,
                                                                 voc_map)
    del voc_train, voc_test
    run_mnist(card)
    run_timit(card)
    random_cifar_rec = run_cifar_variants(card, train_path, test_path)
    run_newsgroups(card)
    torch.cuda.empty_cache()
    inet_launches, inet_train, inet_test = run_imagenet(card)
    inet_tar_decode, inet_tar_fv = run_imagenet_tar(card, inet_train, inet_test)
    del inet_train, inet_test

    # 16. The kernels line, the card line, the result line.
    print(json.dumps({"kernels": [{
        "name": "conv_rect_pool",
        "route": "cuda",
        "source": "keystone_tpu_torch/csrc/rect_pool.cu",
        "replaces": "keystone_tpu/ops/rect_pool_pallas.py:78",
        "launches": main_launches + random_cifar_rec["launches"],
        "launches_by_path": {"random_patch_cifar": main_launches,
                             "random_cifar": random_cifar_rec["launches"]},
        "max_abs_err": max(r["max_abs_err"]
                           for r in [fused_prod, fused_prod_f32, *fused_odd, random_cifar_rec]),
        "ms": fused_prod["ms"],
        "plain_ms": fused_prod["plain_ms"],
        "bound_ms": fused_prod["bound_ms"],
        "bound_by": fused_prod["bound_by"],
        "library_ms": None,
        "f32": {k: fused_prod_f32[k] for k in ("ms", "plain_ms", "bound_ms")},
        "random_cifar_f32": {k: random_cifar_rec[k]
                             for k in ("ms", "plain_ms", "bound_ms", "bound_share")},
        "ms_by_batch": {**{str(n): r["ms"] for n, r in fused_served.items()},
                        str(PROD[0]): fused_prod["ms"]},
        "bound_share": {**{str(n): r["bound_share"] for n, r in fused_served.items()},
                        str(PROD[0]): fused_prod["bound_share"]},
        "rect_pool_entry": {
            "max_abs_err": max(r["max_abs_err"] for r in [prod, prod_f32, *odd]),
            "launches": unfused_launches,
            **{k: prod[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
            "f32": {k: prod_f32[k] for k in ("ms", "plain_ms", "bound_ms")},
        },
    }, {
        "name": "fv_stats",
        "route": "cuda",
        "source": "keystone_tpu_torch/csrc/fv_stats.cu",
        "replaces": "keystone_tpu/ops/fv_pallas.py:95",
        "launches": voc_launches + tar_fv_launches + inet_launches + inet_tar_fv,
        "launches_by_path": {"voc_in_memory": voc_launches, "voc_jpeg_tars": tar_fv_launches,
                             "imagenet_in_memory": inet_launches,
                             "imagenet_jpeg_tars": inet_tar_fv},
        "max_abs_err": max(r["max_abs_err"] for r in [fv_prod, *fv_odd, *fv_imagenet.values()]),
        "ms": fv_prod["ms"],
        "plain_ms": fv_prod["plain_ms"],
        "bound_ms": fv_prod["bound_ms"],
        "bound_by": fv_prod["bound_by"],
        "library_ms": None,
        "ms_by_batch": {**{str(n): r["ms"] for n, r in fv_served.items()},
                        str(FV_PROD[0]): fv_prod["ms"]},
        "bound_share": {**{str(n): r["bound_share"] for n, r in fv_served.items()},
                        str(FV_PROD[0]): fv_prod["bound_share"]},
        "imagenet": {branch: {
            "shape": [64, FV_IMAGENET[branch][0]], "k": 16, "max_abs_err": r["max_abs_err"],
            "bound_by": r["by_batch"][1]["bound_by"],
            **{key: {str(n): t[key] for n, t in r["by_batch"].items()}
               for key in ("ms", "plain_ms", "bound_ms", "bound_share")},
        } for branch, r in fv_imagenet.items()},
    }, {
        "name": "decode_pixels",
        "route": "cuda",
        "source": "keystone_tpu_torch/csrc/idct.cu",
        "replaces": "keystone_tpu/ops/jpeg_device.py:743",
        "launches": decode_launches + inet_tar_decode,
        "launches_by_path": {"voc_jpeg_tars": decode_launches,
                             "imagenet_jpeg_tars": inet_tar_decode},
        "max_abs_err": max(r["max_abs_err"] for r in decode_checks),
        "ms": decode_times[64]["ms"],
        "plain_ms": decode_times[64]["plain_ms"],
        "bound_ms": decode_times[64]["bound_ms"],
        "bound_by": decode_times[64]["bound_by"],
        "library_ms": None,
        "ms_by_batch": {str(b): r["ms"] for b, r in decode_times.items()},
        "plain_ms_by_batch": {str(b): r["plain_ms"] for b, r in decode_times.items()},
        "bound_share": {str(b): r["bound_share"] for b, r in decode_times.items()},
        "idct_entry": {
            "max_abs_err": max(r["max_abs_err"] for r in [idct_prod, *idct_odd]),
            **{k: idct_prod[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                         "library_ms")},
        },
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
