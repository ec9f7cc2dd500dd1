"""The Fisher-vector statistics CUDA kernel (keystone_tpu_torch/csrc/fv_stats.cu)
against its plain PyTorch version on the card, and the wrapper's checks.

This file imports neither JAX nor the JAX package, so the card tests run on
a machine without them:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_fv_stats_cuda.py``.
Tests that need the card carry the ``cuda`` marker and skip without one.

Tolerance on the card: the Fisher vectors from the kernel's statistics
agree with those of the plain version run in f64 on the same inputs to
rtol 2e-4, atol 2e-5·max (the JAX kernel's bar against its XLA twin).  The
f64 oracle keeps the bar about the kernel: the plain f32 version sums each
D-long contraction in one chain and drifts at large D."""

import numpy as np
import pytest
import torch

from keystone_tpu_torch.ops import fv_stats as fs
from keystone_tpu_torch.ops.fisher import FisherVector, _fv_from_stats
from keystone_tpu_torch.solvers.gmm import GaussianMixtureModel
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc) to build and launch the kernel")
    return torch.device("cuda")


def _case(n, cols, d, k, ragged, device, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d, cols)).astype(np.float32)
    means = rng.normal(size=(d, k)).astype(np.float32)
    variances = rng.uniform(0.5, 2.0, (d, k)).astype(np.float32)
    weights = rng.dirichlet(np.ones(k)).astype(np.float32)
    counts = rng.integers(cols // 2, cols + 1, size=n).astype(np.int32) if ragged else None

    def t(a):
        return None if a is None else torch.from_numpy(a).to(device)

    return t(x), t(counts), t(means), t(variances), t(weights)


def _fv(stats, counts, cols, means, variances, weights):
    s0, s1, s2 = stats
    n_valid = (
        counts.to(s0.dtype) if counts is not None
        else torch.full((s0.shape[0],), float(cols), dtype=s0.dtype, device=s0.device)
    )
    return _fv_from_stats(s0, s1, s2, means, variances, weights, n_valid)


def test_wrapper_rejects_other_devices():
    x = torch.empty((2, 4, 10), device="meta")
    p = torch.empty((4, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fs.fv_stats(x, None, p, p, torch.empty(3, device="meta"))


def test_masked_fisher_vector_off_the_cpu_raises():
    # The name is historical: a masked call off the CPU takes the plain
    # per-image path, as in the JAX package, and launches no kernel.
    p = torch.ones((4, 3), device="meta")
    fv = FisherVector(GaussianMixtureModel(p, p, torch.ones(3, device="meta")))
    before = fs.launches
    out = fv(torch.empty((2, 4, 10), device="meta"), torch.ones((2, 10), device="meta"))
    assert out.device.type == "meta" and out.shape == (2, 4, 6)
    assert fs.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n,cols,d,k,ragged",
    [
        (3, 700, 24, 8, True),  # ragged counts
        (3, 333, 24, 8, False),  # D not a multiple of the tile
        (2, 1000, 16, 8, True),
        (4, 2000, 64, 16, False),  # the bench shape's widths
        (2, 5000, 80, 256, True),  # the VOC widths
        (1, 31, 3, 5, False),  # odd d and k, one partial tile
        (2, 2 * fs.SPLIT_COLS + 77, 64, 16, False),  # the bench widths over three splits
        (2, 2 * fs.SPLIT_COLS + 77, 80, 256, True),  # the VOC widths over three splits
        (2, fs.SPLIT_COLS + 1, 80, 256, False),  # one column past a split boundary
        (3, fs.SPLIT_COLS, 24, 8, False),  # exactly one split
    ],
)
def test_kernel_matches_reference_on_card(cuda_device, n, cols, d, k, ragged):
    x, counts, means, variances, weights = _case(n, cols, d, k, ragged, cuda_device)
    before = fs.launches
    got = fs.fv_stats(x, counts, means, variances, weights)
    torch.cuda.synchronize()
    assert fs.launches == before + 1
    gmm64 = (means.double(), variances.double(), weights.double())
    ref = fs.fv_stats_reference(x.double(), counts, *gmm64)
    got_fv = _fv(got, counts, cols, means, variances, weights).double()
    ref_fv = _fv(ref, counts, cols, *gmm64)
    torch.testing.assert_close(
        got_fv, ref_fv, rtol=2e-4, atol=2e-5 * ref_fv.abs().max().item()
    )


@pytest.mark.cuda
@pytest.mark.parametrize("n,cols,ragged", [
    (2, 10062, True),  # LCS descriptors of a 375x500 image
    (2, 40584, False),  # SIFT descriptors (step 3, scale step 1) of a 375x500 image
    (3, 8892, False),  # LCS at 333x500
])
def test_kernel_at_imagenet_shapes(cuda_device, n, cols, ragged):
    # ImageNetSiftLcsFV's GMM: 16 components over 64 PCA dimensions.
    x, counts, means, variances, weights = _case(n, cols, 64, 16, ragged, cuda_device, seed=5)
    before = fs.launches
    got = fs.fv_stats(x, counts, means, variances, weights)
    assert fs.launches == before + 1
    gmm64 = (means.double(), variances.double(), weights.double())
    ref_fv = _fv(fs.fv_stats_reference(x.double(), counts, *gmm64), counts, cols, *gmm64)
    got_fv = _fv(got, counts, cols, means, variances, weights).double()
    torch.testing.assert_close(got_fv, ref_fv, rtol=2e-4, atol=2e-5 * ref_fv.abs().max().item())
    for i in range(n):
        alone = fs.fv_stats(x[i : i + 1].contiguous(), None if counts is None else counts[i : i + 1],
                            means, variances, weights)
        for b, a in zip(got, alone):
            assert torch.equal(b[i], a[0])


@pytest.mark.cuda
@pytest.mark.parametrize("cols", [fs.SPLIT_COLS, 2 * fs.SPLIT_COLS + 5])
def test_counts_of_zero_and_of_one_split(cuda_device, cols):
    x, _, means, variances, weights = _case(4, cols, 24, 8, False, cuda_device)
    counts = torch.tensor([0, fs.SPLIT_COLS, 1, cols], dtype=torch.int32, device=cuda_device)
    got = fs.fv_stats(x, counts, means, variances, weights)
    ref = fs.fv_stats_reference(x.double(), counts, means.double(), variances.double(),
                                weights.double())
    for g, r in zip(got, ref):
        assert torch.all(g[0] == 0)  # no valid descriptor, no mass
        torch.testing.assert_close(g.double(), r, rtol=2e-4, atol=2e-5 * r.abs().max().item())


@pytest.mark.cuda
def test_kernel_is_batch_invariant(cuda_device):
    # Each image's statistics from a batch of 16 are the bits of that image
    # run alone: the split length is fixed, the sums are ordered.
    x, counts, means, variances, weights = _case(16, 2 * fs.SPLIT_COLS + 100, 80, 256, True,
                                                 cuda_device, seed=3)
    batch = fs.fv_stats(x, counts, means, variances, weights)
    for i in range(16):
        alone = fs.fv_stats(x[i : i + 1].contiguous(), counts[i : i + 1], means, variances,
                            weights)
        for b, a in zip(batch, alone):
            assert torch.equal(b[i], a[0])


@pytest.mark.cuda
def test_masked_fisher_vector_card_matches_cpu(cuda_device):
    x, counts, means, variances, weights = _case(3, 900, 16, 8, True, cuda_device)
    mask = (torch.arange(900, device=cuda_device)[None] < counts[:, None]).float()
    before = fs.launches
    on_card = FisherVector(GaussianMixtureModel(means, variances, weights))(x, mask).cpu()
    assert fs.launches == before
    cpu = [t.cpu() for t in (x, mask, means, variances, weights)]
    on_cpu = FisherVector(GaussianMixtureModel(*cpu[2:]))(cpu[0], cpu[1])
    torch.testing.assert_close(on_card, on_cpu, rtol=2e-4, atol=2e-5 * on_cpu.abs().max().item())


@pytest.mark.cuda
def test_kernel_is_deterministic(cuda_device):
    x, counts, means, variances, weights = _case(2, 3000, 24, 8, True, cuda_device)
    a = fs.fv_stats(x, counts, means, variances, weights)
    b = fs.fv_stats(x, counts, means, variances, weights)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


@pytest.mark.cuda
def test_wrapper_raises_on_card(cuda_device):
    x, counts, means, variances, weights = _case(2, 100, 8, 4, True, cuda_device)
    with pytest.raises(TypeError):
        fs.fv_stats(x.double(), None, means, variances, weights)
    with pytest.raises(ValueError, match="contiguous"):
        fs.fv_stats(x.transpose(1, 2).contiguous().transpose(1, 2), None, means, variances, weights)
    with pytest.raises(ValueError, match="counts"):
        fs.fv_stats(x, counts + 1000, means, variances, weights)
    big = _case(1, 64, 8, 300, False, cuda_device)
    with pytest.raises(ValueError, match="envelope"):
        fs.fv_stats(*big)
    wide = _case(1, 64, fs.MAX_D + 1, 8, False, cuda_device)
    with pytest.raises(ValueError, match="envelope"):
        fs.fv_stats(*wide)


@pytest.mark.cuda
def test_fisher_vector_card_matches_cpu(cuda_device):
    x, _, means, variances, weights = _case(3, 1500, 16, 8, False, cuda_device)
    on_card = FisherVector(GaussianMixtureModel(means, variances, weights))(x).cpu()
    cpu = [t.cpu() for t in (x, means, variances, weights)]
    on_cpu = FisherVector(GaussianMixtureModel(*cpu[1:]))(cpu[0])
    torch.testing.assert_close(on_card, on_cpu, rtol=2e-4, atol=2e-5 * on_cpu.abs().max().item())
