"""Bits the port must not take from the host: every f32 square root whose
bits are compared with the JAX package, or between the CPU and the card,
is correctly rounded (``utils.stats.sqrt_rn``), and the products of the
served chains give each row the same bits at every row count
(``utils.stats.matmul_rows``, the per-matrix ``BatchPCATransformer``,
and ``NormalizeRows`` over ``utils.stats.sum_rows``).

PyTorch's f32 ``torch.sqrt`` on an AMD EPYC host (torch 2.13.0+cpu) is one
ulp from the correctly rounded root on about a sixth of random inputs,
where XLA's CPU root is not; and MKL's rows of ``[6, 256] @ [256, 20]``
differ from the same rows multiplied in a batch of 4.  Each site here is
held to the f64 root rounded to f32, ``torch.equal``; each product to the
rows of a 64-row batch, ``torch.equal``, at row counts 1, 4, 6, 16 and 64
and at shifted positions.  ``tests/test_torch_numerics_bits_cuda.py``
holds the same on the card."""

import numpy as np
import pytest
import torch

from keystone_tpu_torch.ops import fisher, images, sift, stats
from keystone_tpu_torch.solvers import pca as pca_mod
from keystone_tpu_torch.solvers.block import BlockLinearMapper
from keystone_tpu_torch.solvers.pca import BatchPCATransformer, PCATransformer
from keystone_tpu_torch.utils import stats as ustats
from keystone_tpu_torch.utils.stats import matmul_rows, normalize_rows, sqrt_rn
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401

ROW_COUNTS = (1, 4, 6, 16, 64)


def root64(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(x.double()).float()


def _positive(*shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(*shape, generator=g) * 10.0 + 1e-3


def _site_standard_scaler():
    g = torch.Generator().manual_seed(1)
    x = torch.randn(40, 33, generator=g) * 3.0 + 1.0
    got = stats.StandardScaler().fit(x).std
    cnt = float(x.shape[0])
    mean = x.sum(dim=0) / cnt
    var = ((x * x).sum(dim=0) - cnt * mean * mean) / (cnt - 1.0)
    return got, root64(var)


def _site_signed_hellinger():
    g = torch.Generator().manual_seed(2)
    x = torch.randn(17, 301, generator=g) * 5.0
    return stats.SignedHellingerMapper()(x), torch.sign(x) * root64(torch.abs(x))


def _site_fisher():
    g = torch.Generator().manual_seed(3)
    d, k = 6, 5
    s0, s1, s2 = torch.rand(k, generator=g) * 9, torch.randn(d, k, generator=g), \
        torch.rand(d, k, generator=g) * 4
    means, variances = torch.randn(d, k, generator=g), torch.rand(d, k, generator=g) + 0.1
    weights, n = torch.rand(k, generator=g) + 0.05, torch.tensor(9.0)
    got = fisher._fv_from_stats(s0, s1, s2, means, variances, weights, n)
    n_safe = torch.clamp_min(n, 1.0)[..., None, None]
    g_mean = (s1 - means * s0[None, :]) / (root64(variances) * root64(weights) * n_safe)
    g_var = (s2 - 2.0 * means * s1 + (means * means - variances) * s0[None, :]) / (
        variances * root64(2.0 * weights) * n_safe)
    return got, torch.cat([g_mean, g_var], dim=-1)


def _site_patch_stats():
    g = torch.Generator().manual_seed(4)
    filters = torch.randn(4, 3, 3, 3, generator=g)
    conv = images.Convolver(filters, img_channels=3, device="cpu")
    x = conv._images(torch.rand(2, 9, 9, 3, generator=g) * 255.0)
    _mu, sigma = conv.patch_stats(x)
    d = 3 * 3 * 3
    ones = conv._ones
    psum = torch.nn.functional.conv2d(x, ones)[:, 0]
    psumsq = torch.nn.functional.conv2d(x * x, ones)[:, 0]
    mu = psum / d
    var = (psumsq - d * mu * mu) / (d - 1.0)
    return sigma, root64(var + conv.var_constant)


def _site_grayscaler():
    x = _positive(3, 11, 13, 4, seed=5)
    return images.GrayScaler()(x)[..., 0], root64(torch.mean(x * x, dim=-1))


def _site_sift_magnitude():
    g = torch.Generator().manual_seed(6)
    gy, gx = torch.randn(2, 7, 9, generator=g), torch.randn(2, 7, 9, generator=g)
    got = sift._orientation_planes(gy, gx)
    mag = root64(gx * gx + gy * gy)
    nb = got.shape[1]
    a = torch.atan2(gy, gx) * (nb / (2.0 * np.pi))
    t = torch.arange(nb, dtype=a.dtype)[:, None, None]
    d = torch.abs(torch.remainder(a[:, None] - t + nb / 2, nb) - nb / 2)
    return got, mag[:, None] * torch.clamp_min(1.0 - d, 0.0)


def _site_normalize_rows_node():
    g = torch.Generator().manual_seed(13)
    x = torch.randn(9, 300, generator=g)
    norm = root64(ustats.sum_rows(x * x))[:, None]
    return stats.NormalizeRows()(x), x / torch.clamp_min(norm, 2.2e-16)


def _site_normalize_rows():
    g = torch.Generator().manual_seed(7)
    mat = torch.randn(12, 50, generator=g) * 4.0
    mean = mat.mean(dim=1, keepdim=True)
    var = mat.var(dim=1, keepdim=True, correction=1)
    return normalize_rows(mat, 10.0), (mat - mean) / root64(var + 10.0)


def _site_lda_counts():
    seen = []
    real = pca_mod.sqrt_rn

    def spy(x):
        seen.append(x.clone())
        return real(x)

    pca_mod.sqrt_rn = spy
    try:
        g = torch.Generator().manual_seed(8)
        data = torch.randn(60, 4, generator=g)
        labels = torch.arange(60) % 3
        pca_mod.LinearDiscriminantAnalysis(2).fit(data, labels)
    finally:
        pca_mod.sqrt_rn = real
    (counts,) = seen
    return real(counts), root64(counts)


SITES = {
    "ops/stats.py StandardScaler std": _site_standard_scaler,
    "ops/stats.py SignedHellingerMapper": _site_signed_hellinger,
    "ops/fisher.py _fv_from_stats": _site_fisher,
    "ops/images.py Convolver.patch_stats": _site_patch_stats,
    "ops/images.py GrayScaler": _site_grayscaler,
    "ops/sift.py gradient magnitude": _site_sift_magnitude,
    "utils/stats.py normalize_rows": _site_normalize_rows,
    "ops/stats.py NormalizeRows": _site_normalize_rows_node,
    "solvers/pca.py LDA class counts": _site_lda_counts,
}


@pytest.mark.parametrize("site", sorted(SITES))
def test_square_root_sites_are_correctly_rounded(site):
    got, want = SITES[site]()
    assert got.dtype == torch.float32
    assert torch.equal(got, want), site


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
def test_sqrt_rn_rounds_once(dtype):
    x = _positive(4096, seed=9).to(dtype)
    got = sqrt_rn(x)
    assert got.dtype == dtype
    if dtype == torch.float64:
        assert torch.equal(got, torch.sqrt(x))
    else:
        assert torch.equal(got, torch.sqrt(x.double()).float().to(dtype))


def _rows_case(name):
    g = torch.Generator().manual_seed(10)
    if name == "BlockLinearMapper":
        xs = [torch.randn(256, 20, generator=g), torch.randn(100, 20, generator=g)]
        node = BlockLinearMapper(xs, 256, b=torch.randn(20, generator=g))
        return node, torch.randn(64, 356, generator=g)
    if name == "PCATransformer":
        return PCATransformer(torch.randn(128, 80, generator=g)), torch.randn(64, 128, generator=g)
    if name == "NormalizeRows":
        return stats.NormalizeRows(), torch.randn(64, 40960, generator=g)
    return (BatchPCATransformer(torch.randn(128, 16, generator=g)),
            torch.randn(64, 128, 37, generator=g))


@pytest.mark.parametrize("rows", ROW_COUNTS)
@pytest.mark.parametrize("name", ["BlockLinearMapper", "PCATransformer", "BatchPCATransformer",
                                  "NormalizeRows"])
def test_products_keep_their_bits_at_every_row_count(name, rows):
    node, x = _rows_case(name)
    whole = node(x)
    for start in sorted({0, (64 - rows) // 2, 64 - rows}):
        part = node(x[start : start + rows].clone())
        assert torch.equal(part, whole[start : start + rows]), (name, rows, start)


def test_matmul_rows_is_the_product():
    g = torch.Generator().manual_seed(11)
    for n, k, m in ((1, 1, 1), (5, 7, 3), (33, 300, 9), (0, 4, 2), (3, 0, 2)):
        x, w = torch.randn(n, k, generator=g), torch.randn(k, m, generator=g)
        got = matmul_rows(x, w)
        assert got.shape == (n, m)
        torch.testing.assert_close(got, (x.double() @ w.double()).float(), rtol=1e-5,
                                   atol=1e-5)


def test_sum_rows_is_the_sum():
    g = torch.Generator().manual_seed(14)
    for shape in ((1, 1), (3, 7), (2, 5, 300), (4, 0)):
        x = torch.randn(*shape, generator=g)
        got = ustats.sum_rows(x)
        assert got.shape == shape[:-1]
        torch.testing.assert_close(got, x.double().sum(-1).float(), rtol=1e-5, atol=1e-5)


def test_matmul_rows_chunks_do_not_move_a_bit(monkeypatch):
    g = torch.Generator().manual_seed(12)
    x, w = torch.randn(50, 96, generator=g), torch.randn(96, 7, generator=g)
    whole = matmul_rows(x, w)
    monkeypatch.setattr(ustats, "_ROW_PRODUCT_BYTES", 128 * 7 * 4 * 3)  # 3 rows a step
    assert torch.equal(matmul_rows(x, w), whole)
