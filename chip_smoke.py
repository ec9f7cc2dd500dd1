#!/usr/bin/env python3
"""Smoke run of keystone_tpu_torch on one CUDA card (the port's quickest
proof that it still builds, is right and runs end to end on the GPU).

Run from the repository root: ``python3 chip_smoke.py``.  Phases, each of
which raises (and so exits non-zero) on failure:

1. card and build: the card's name and power limit, the CUDA version, and
   the build of every kernel under ``keystone_tpu_torch/csrc`` (``nvcc``)
   and of the native entropy loop (``g++``), all started together;
2. every kernel against its plain PyTorch version on the card, at the main
   path's shape and at the odd shapes, timed with CUDA events (the IDCT
   also beside one ``torch.einsum`` call, its library yardstick);
3. the RandomPatchCifar main path at full width (100 filters of 6x6x3,
   pool 14 / stride 13) on seeded synthetic CIFAR-shaped data, 50,000 train
   and 10,000 test images, through
   ``keystone_tpu_torch.workloads.cifar_random_patch.main``;
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
   native entropy pass on the host, the IDCT kernel and the rest of the
   decode on the card.  Checks: the native backend ran with no fallback or
   skip; one chunk's entropy decode equals the encoder's coefficients
   exactly; its card decode is within 1 level of the CPU decode with
   >= 99.9 % of pixels equal; MAP >= 0.5 and within 0.05 of phase 6; the
   kernels' launch counts; and ``fused_apply`` of the servable chain at
   batches 1, 4 and 16 reproduces the offline test scores;
9. one JSON line per the kernels, the card line, and the final JSON line.

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
from keystone_tpu_torch.core import ingest
from keystone_tpu_torch.loaders import image_loaders
from keystone_tpu_torch.loaders.cifar import cifar_loader
from keystone_tpu_torch.loaders.image_loaders import VOC_NUM_CLASSES, MultiLabeledImages
from keystone_tpu_torch.ops import fv_stats as fs
from keystone_tpu_torch.ops import jpeg_device as jd
from keystone_tpu_torch.ops import native_entropy
from keystone_tpu_torch.ops import rect_pool as rp
from keystone_tpu_torch.ops.fisher import _fv_from_stats
from keystone_tpu_torch.ops.sift import SIFTExtractor
from keystone_tpu_torch.ops.stats import StandardScaler
from keystone_tpu_torch.solvers.gmm import GaussianMixtureModel
from keystone_tpu_torch.ops.util import ClassLabelIndicatorsFromIntLabels
from keystone_tpu_torch.solvers.block import BlockLeastSquaresEstimator
from keystone_tpu_torch.testing.jpeg_encode import encode_jpeg
from keystone_tpu_torch.utils.platform import resolve_device
from keystone_tpu_torch.workloads import cifar_random_patch as cifar
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

# fv_stats (n, d, D, k, ragged): 32 images of the VOC production shape (a
# 500x375 image gives 73,866 descriptors of 80 dims after PCA, k=256; 32
# because the plain version holds [n, k, D] f32 posteriors, 2.4 GB here),
# then ragged counts and a D that is not a multiple of the kernel's tile.
FV_PROD = (32, 80, 73866, 256, False)
FV_ODD = [(3, 24, 700, 8, True), (3, 24, 333, 8, False)]

# idct: the main path's luma launch (a 64-image chunk of 375x500 4:2:0 JPEGs
# is [64, 48, 64, 8, 8]), then one block, a ragged count and leading dims.
IDCT_PROD = (64 * 48 * 64, 8, 8)
IDCT_ODD = [(1, 8, 8), (37, 8, 8), (3, 2, 5, 8, 8)]

# VOCSIFTFisher: VOC 2007's two common image sizes (H, W), images per split.
VOC_SHAPES = {(375, 500): 384, (500, 375): 128}
VOC_CONF = dict(desc_dim=80, vocab_size=256, sift_step_size=3, scale_step=0,
                lam=0.5, num_pca_samples=int(1e6), num_gmm_samples=int(1e6),
                seed=42, device="cuda")


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
    """CUDA-event times of one production chunk's featurize stages."""
    batch = torch.from_numpy(images).cuda()
    conv = featurizer.conv(batch)
    z = conv.to(featurizer.activation_dtype)
    kw = dict(pool_stride=featurizer.pool_stride, pool_size=featurizer.pool_size,
              alpha=featurizer.alpha, max_val=featurizer.max_val)
    return {
        "chunk": int(batch.shape[0]),
        "convolver_ms": cuda_ms(lambda: featurizer.conv(batch), reps=10),
        "cast_ms": cuda_ms(lambda: conv.to(featurizer.activation_dtype), reps=10),
        "rect_pool_ms": cuda_ms(lambda: rp.rect_pool(z, **kw), reps=10),
        "featurizer_ms": cuda_ms(lambda: featurizer(batch), reps=10),
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


def run_voc_tar(card: str, train, test, memory_map: float) -> tuple[int, int]:
    """Phase 8: VOCSIFTFisher from JPEG tars through ``--streamIngest
    --deviceDecode``.  Returns the idct and fv_stats launches of the path."""
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
        jd.launches = fs.launches = 0
        res = voc.main([
            "--trainLocation", str(root / "train.tar"), "--testLocation", str(root / "test.tar"),
            "--labelPath", str(root / "labels.csv"), "--streamIngest", "--deviceDecode",
            "--streamBatchSize", "64", "--device", "cuda",
        ])
        fit_idct, fit_fv = jd.launches, fs.launches
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
        idct_launches, fv_launches = jd.launches, fs.launches

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
    # (c) that chunk decoded on the card against the port's CPU decode.
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
    # (e) the path went through both kernels.
    if not (fit_idct >= 3 * chunks and fv_launches >= chunks):
        raise AssertionError(f"launches: idct {fit_idct}, fv_stats {fv_launches}, "
                             f"{chunks} chunks")
    # Device decode time of one production chunk, coefficients already on
    # the card (these launches are measurements, not the path's).
    dev_coeffs = [torch.from_numpy(c).cuda() for c in coeffs]
    dev_qt = torch.from_numpy(qt).cuda()
    decode_ms = cuda_ms(lambda: jd.decode_batch(geom, dev_coeffs, dev_qt), reps=10)
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
        "device_decode_seconds_est": decode_ms * chunks / 1e3,
        "coeff_h2d_ms_per_chunk": h2d_ms,
        "coeff_bytes_per_image": geom.coeff_bytes(),
        "pixel_bytes_per_image": geom.height * geom.width * 3 * 4,
        "idct_launches_fit": fit_idct, "idct_launches_serve": idct_launches - fit_idct,
        "fv_stats_launches_fit": fit_fv, "fv_stats_launches_serve": fv_launches - fit_fv,
        "card_vs_cpu_decode_max_abs": diff.max().item(), "card_vs_cpu_decode_equal": equal,
        "decoded_vs_source_mean_abs": source_err,
    }))
    return idct_launches, fv_launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is available", file=sys.stderr)
        return 1
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
    fv_prod = check_fv_stats(FV_PROD, gen, timed=True)
    fv_odd = [check_fv_stats(s, gen, timed=False) for s in FV_ODD]
    torch.cuda.empty_cache()
    log("fv_stats library_ms: null (no single PyTorch call computes GMM "
        "posteriors and their weighted moments)")
    idct_prod = check_idct(IDCT_PROD, gen, timed=True)
    idct_odd = [check_idct(s, gen, timed=False) for s in IDCT_ODD]

    # The synthetic data lives under the checkout's git-ignored build/.
    _build.BUILD_DIR.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as tmp:
        train_path, test_path = Path(tmp) / "train.bin", Path(tmp) / "test.bin"
        rng = np.random.default_rng(5)
        palette = rng.uniform(40, 215, (N_CLASSES, 3))
        write_cifar(train_path, N_TRAIN, rng, palette)
        write_cifar(test_path, N_TEST, rng, palette)
        test = cifar_loader(str(test_path))
        test_images = test.images

        # 3. + 4. The main path: fit, eval, then the servable apply.
        rp.launches = 0
        res = cifar.main(["--trainLocation", str(train_path),
                          "--testLocation", str(test_path), *MAIN_FLAGS])
        fit_launches = rp.launches
        servable = res["servable"]
        for chunk in (1, 4, 16, 64):
            served = cifar.apply_servable_chunked(servable, test_images[:256], chunk)
            if not np.array_equal(served, res["test_predictions"][:256]):
                raise AssertionError(f"servable apply at batch {chunk} != offline predictions")
        main_launches = rp.launches
    need = math.ceil(N_TRAIN / 2048) + math.ceil(N_TEST / 2048)
    if fit_launches < need:
        raise AssertionError(f"rect_pool launched {fit_launches} times, expected >= {need}")
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
        "rect_pool_launches_fit": fit_launches,
        "rect_pool_launches_serve": main_launches - fit_launches,
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
    idct_launches, tar_fv_launches = run_voc_tar(card, voc_train, voc_test, voc_map)

    # 9. The kernels line, the card line, the result line.
    print(json.dumps({"kernels": [{
        "name": "rect_pool",
        "route": "cuda",
        "source": "keystone_tpu_torch/csrc/rect_pool.cu",
        "replaces": "keystone_tpu/ops/rect_pool_pallas.py:78",
        "launches": main_launches,
        "max_abs_err": max(r["max_abs_err"] for r in [prod, prod_f32, *odd]),
        "ms": prod["ms"],
        "plain_ms": prod["plain_ms"],
        "bound_ms": prod["bound_ms"],
        "bound_by": prod["bound_by"],
        "library_ms": None,
        "f32": {k: prod_f32[k] for k in ("ms", "plain_ms", "bound_ms")},
    }, {
        "name": "fv_stats",
        "route": "cuda",
        "source": "keystone_tpu_torch/csrc/fv_stats.cu",
        "replaces": "keystone_tpu/ops/fv_pallas.py:95",
        "launches": voc_launches + tar_fv_launches,
        "launches_by_path": {"voc_in_memory": voc_launches, "voc_jpeg_tars": tar_fv_launches},
        "max_abs_err": max(r["max_abs_err"] for r in [fv_prod, *fv_odd]),
        "ms": fv_prod["ms"],
        "plain_ms": fv_prod["plain_ms"],
        "bound_ms": fv_prod["bound_ms"],
        "bound_by": fv_prod["bound_by"],
        "library_ms": None,
    }, {
        "name": "idct",
        "route": "cuda",
        "source": "keystone_tpu_torch/csrc/idct.cu",
        "replaces": "keystone_tpu/ops/jpeg_device.py:743",
        "launches": idct_launches,
        "max_abs_err": max(r["max_abs_err"] for r in [idct_prod, *idct_odd]),
        "ms": idct_prod["ms"],
        "plain_ms": idct_prod["plain_ms"],
        "bound_ms": idct_prod["bound_ms"],
        "bound_by": idct_prod["bound_by"],
        "library_ms": idct_prod["library_ms"],
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
