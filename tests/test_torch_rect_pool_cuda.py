"""The rect+pool CUDA kernel (keystone_tpu_torch/csrc/rect_pool.cu) against
its plain PyTorch version on the card, both entries (``rect_pool`` on
activations, ``conv_rect_pool`` on the Convolver's raw terms), and the
wrappers' checks.

This file imports neither JAX nor the JAX package, so the card tests run on
a machine without them:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_rect_pool_cuda.py``.
Tests that need the card carry the ``cuda`` marker and skip without one.

Tolerance on the card: rtol 1e-5, atol 1e-4·max (both sides read the same
input and sum in f32, in another order — the JAX kernel's bar; the fused
entry computes each activation with the plain epilogue's bits).  Batch
invariance is exact: an image's features do not depend on its batch."""

import numpy as np
import pytest
import torch

from keystone_tpu_torch.ops import rect_pool as rp
from keystone_tpu_torch.ops.conv_fused import FusedConvFeaturizer


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc) to build and launch the kernel")
    return torch.device("cuda")


@pytest.mark.parametrize(
    "dim,stride,size,expect",
    [
        (27, 13, 14, [(0, 14), (13, 14)]),  # RandomPatchCifar: overlap at 13
        (24, 4, 6, [(0, 6), (4, 6), (8, 6), (12, 6), (16, 6), (20, 4)]),  # truncated
        (16, 5, 5, [(0, 4), (5, 4), (10, 4)]),  # odd size: span 2*(5//2)
    ],
)
def test_windows(dim, stride, size, expect):
    assert rp.windows(dim, stride, size) == expect
    assert rp.num_pools(dim, stride, size) == len(expect)


def test_wrapper_rejects_other_devices():
    z = torch.empty((2, 8, 8, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        rp.rect_pool(z, pool_stride=4, pool_size=4)
    with pytest.raises(ValueError, match="unsupported device"):
        rp.conv_rect_pool(z, None, None, torch.empty(4), None, pool_stride=4, pool_size=4)


def _terms(n, oh, ow, f, device, seed=0, normalize=True, means=True):
    """Seeded Convolver terms at the scale of RandomPatchCifar's: conv of
    0-255 patches with unit filters, patch means and deviations."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(device)

    conv = t(rng.normal(0, 300, (n, oh, ow, f)))
    mu = t(rng.uniform(0, 255, (n, oh, ow))) if normalize else None
    sigma = t(rng.uniform(5, 80, (n, oh, ow))) if normalize else None
    return conv, mu, sigma, t(rng.normal(0, 1, f)), t(rng.normal(0, 1, f)) if means else None


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n,oh,ow,f,stride,size,alpha,max_val,dtype",
    [
        (64, 27, 27, 100, 13, 14, 0.25, 0.0, torch.bfloat16),
        (64, 27, 27, 100, 13, 14, 0.25, 0.0, torch.float32),
        (5, 20, 24, 7, 4, 6, 0.25, 0.0, torch.float32),
        (5, 16, 16, 3, 5, 5, 0.1, 0.05, torch.bfloat16),
        (3, 9, 9, 300, 3, 3, 0.0, 0.0, torch.float32),  # F above one block
    ],
)
def test_kernel_matches_reference_on_card(
    cuda_device, n, oh, ow, f, stride, size, alpha, max_val, dtype
):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    z = torch.randn((n, oh, ow, f), generator=gen, device=cuda_device).to(dtype)
    kw = dict(pool_stride=stride, pool_size=size, alpha=alpha, max_val=max_val)
    before = rp.launches
    got = rp.rect_pool(z, **kw)
    torch.cuda.synchronize()
    assert rp.launches == before + 1
    ref = rp.rect_pool_reference(z, **kw)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-4 * ref.abs().max().item())


@pytest.mark.cuda
def test_wrapper_raises_on_card(cuda_device):
    z = torch.zeros((2, 8, 8, 4), device=cuda_device)
    with pytest.raises(TypeError):
        rp.rect_pool(z.half(), pool_stride=4, pool_size=4)
    with pytest.raises(ValueError, match="contiguous"):
        rp.rect_pool(z.transpose(1, 2), pool_stride=4, pool_size=4)
    with pytest.raises(ValueError):
        rp.rect_pool(z[0], pool_stride=4, pool_size=4)


FUSED_SHAPES = [
    (2048, 27, 27, 100, 13, 14, 0.25, 0.0),  # the RandomPatchCifar chunk
    (64, 20, 24, 7, 4, 6, 0.25, 0.0),  # F not a multiple of 4, truncated edge
    (64, 16, 16, 3, 5, 5, 0.1, 0.05),  # odd pool size, max_val != 0
    (3, 9, 9, 300, 3, 3, 0.0, 0.0),  # F over one block's 256 channels
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FUSED_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("normalize,means", [(True, True), (True, False), (False, True), (False, False)])
def test_fused_kernel_matches_reference_on_card(cuda_device, shape, dtype, normalize, means):
    n, oh, ow, f, stride, size, alpha, max_val = shape
    if n > 64 and (dtype, normalize, means) != (torch.bfloat16, True, True):
        n = 64  # the production width once, in the production mode
    terms = _terms(n, oh, ow, f, cuda_device, normalize=normalize, means=means)
    kw = dict(pool_stride=stride, pool_size=size, alpha=alpha, max_val=max_val,
              activation_dtype=dtype)
    before = rp.fused_launches, rp.launches
    got = rp.conv_rect_pool(*terms, **kw)
    torch.cuda.synchronize()
    assert (rp.fused_launches, rp.launches) == (before[0] + 1, before[1])
    ref = rp.conv_rect_pool_reference(*terms, **kw)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-4 * ref.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_kernel_is_batch_invariant(cuda_device, dtype):
    terms = _terms(16, 27, 27, 100, cuda_device, seed=3)
    kw = dict(pool_stride=13, pool_size=14, alpha=0.25, activation_dtype=dtype)
    batch = rp.conv_rect_pool(*terms, **kw)
    for i in range(16):
        one = [t if t.dim() == 1 else t[i : i + 1] for t in terms]
        assert torch.equal(rp.conv_rect_pool(*one, **kw)[0], batch[i])


@pytest.mark.cuda
def test_fused_wrapper_raises_on_card(cuda_device):
    conv, mu, sigma, fsum, fmd = _terms(2, 8, 8, 4, cuda_device)
    kw = dict(pool_stride=4, pool_size=4)
    with pytest.raises(ValueError, match="contiguous"):
        rp.conv_rect_pool(conv.transpose(1, 2), mu, sigma, fsum, fmd, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        rp.conv_rect_pool(conv, mu.transpose(1, 2), sigma, fsum, fmd, **kw)
    with pytest.raises(TypeError):
        rp.conv_rect_pool(conv.half(), mu, sigma, fsum, fmd, **kw)
    with pytest.raises(TypeError):
        rp.conv_rect_pool(conv, mu.double(), sigma, fsum, fmd, **kw)
    with pytest.raises(TypeError):
        rp.conv_rect_pool(conv, mu, sigma, fsum, fmd, activation_dtype=torch.float16, **kw)
    with pytest.raises(ValueError, match="is on cpu"):
        rp.conv_rect_pool(conv, mu.cpu(), sigma, fsum, fmd, **kw)
    with pytest.raises(ValueError, match="shape"):
        rp.conv_rect_pool(conv, mu, sigma, fsum[:3], fmd, **kw)
    with pytest.raises(ValueError, match="together"):
        rp.conv_rect_pool(conv, mu, None, fsum, fmd, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bound", [(torch.float32, 2e-5), (torch.bfloat16, 1e-2)])
def test_featurizer_card_matches_cpu(cuda_device, dtype, bound):
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.uniform(0, 255, (16, 32, 32, 3)).astype(np.float32))
    filters = rng.normal(size=(100, 6, 6, 3)).astype(np.float32)
    means = rng.normal(size=(108,)).astype(np.float32)

    def make(device):
        return FusedConvFeaturizer(
            filters, whitener_means=means, pool_stride=13, pool_size=14, alpha=0.25,
            activation_dtype=dtype, device=device,
        )

    ref = make("cpu")(imgs)
    before = rp.fused_launches, rp.launches
    got = make(cuda_device)(imgs).cpu()
    assert (rp.fused_launches, rp.launches) == (before[0] + 1, before[1])
    err = ((got - ref).abs().max() / ref.abs().max()).item()
    assert err < bound, err
