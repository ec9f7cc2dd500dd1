"""keystone_tpu_torch FusedConvFeaturizer and the rect+pool kernel's plain
versions against the JAX package (CPU).  The kernel itself is held against
its plain versions on the card in ``test_torch_rect_pool_cuda.py``.

Tolerances: f32 features rtol 2e-5, atol 2e-5·max (the JAX fused-vs-unfused
bar); bf16 features within 1e-2 of max (one bf16 rounding per activation);
rect+pool rtol 1e-5, atol 1e-4·max (the JAX Pallas-kernel bar).  The
Convolver's terms + epilogue and the fused entry's plain version are held
to the unfused chain bit for bit (``torch.equal``): they run the same ops
in the same order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.ops.conv_fused import FusedConvFeaturizer as JaxFused
from keystone_tpu.ops.rect_pool_pallas import rect_pool_pallas
from keystone_tpu_torch.ops import rect_pool as rp
from keystone_tpu_torch.ops.conv_fused import FusedConvFeaturizer
from keystone_tpu_torch.ops.images import Convolver, convolver_epilogue

SHAPES = [
    (32, 32, 100, 6, 13, 14),  # the RandomPatchCifar shape
    (20, 24, 7, 5, 4, 6),  # uneven dims, truncated edge pools
    (16, 16, 3, 3, 5, 5),  # odd pool size (span ps-1 semantics)
]


def _inputs(rng, h, w, fsz, ws, n=5):
    imgs = rng.uniform(0, 255, (n, h, w, 3)).astype(np.float32)
    filters = rng.normal(size=(fsz, ws, ws, 3)).astype(np.float32)
    means = rng.normal(size=(ws * ws * 3,)).astype(np.float32)
    return imgs, filters, means


def _jax_fused(filters, means, stride, size, dtype):
    return JaxFused(
        jnp.asarray(filters), whitener_means=jnp.asarray(means),
        pool_stride=stride, pool_size=size, alpha=0.25, activation_dtype=dtype,
    )


def _torch_fused(filters, means, stride, size, dtype, device="cpu"):
    return FusedConvFeaturizer(
        filters, whitener_means=means, pool_stride=stride, pool_size=size,
        alpha=0.25, activation_dtype=dtype, device=device,
    )


@pytest.mark.parametrize("h,w,fsz,ws,stride,size", SHAPES)
def test_fused_matches_jax_f32(rng, h, w, fsz, ws, stride, size):
    imgs, filters, means = _inputs(rng, h, w, fsz, ws)
    ref = np.asarray(_jax_fused(filters, means, stride, size, jnp.float32)(jnp.asarray(imgs)))
    got = _torch_fused(filters, means, stride, size, torch.float32)(torch.from_numpy(imgs))
    got = got.numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5 * np.abs(ref).max())


@pytest.mark.parametrize("h,w,fsz,ws,stride,size", SHAPES)
def test_fused_matches_jax_bf16(rng, h, w, fsz, ws, stride, size):
    imgs, filters, means = _inputs(rng, h, w, fsz, ws)
    ref = np.asarray(_jax_fused(filters, means, stride, size, jnp.bfloat16)(jnp.asarray(imgs)))
    got = _torch_fused(filters, means, stride, size, torch.bfloat16)(torch.from_numpy(imgs))
    err = np.abs(got.numpy() - ref).max() / np.abs(ref).max()
    assert err < 1e-2, err


@pytest.mark.parametrize(
    "n,oh,ow,f,stride,size,alpha,max_val",
    [
        (3, 27, 27, 24, 13, 14, 0.25, 0.0),
        (2, 20, 24, 7, 4, 6, 0.25, 0.0),
        (2, 16, 16, 3, 5, 5, 0.1, 0.05),
    ],
)
def test_rect_pool_reference_matches_pallas(rng, n, oh, ow, f, stride, size, alpha, max_val):
    z = rng.normal(size=(n, oh, ow, f)).astype(np.float32)
    ref = np.asarray(
        rect_pool_pallas(
            jnp.asarray(z), pool_stride=stride, pool_size=size, alpha=alpha,
            max_val=max_val, images_per_step=2, interpret=True,
        )
    )
    got = rp.rect_pool_reference(
        torch.from_numpy(z), pool_stride=stride, pool_size=size, alpha=alpha,
        max_val=max_val,
    ).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4 * np.abs(ref).max())


def test_cuda_without_card_raises(rng, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, filters, means = _inputs(rng, 16, 16, 3, 3, n=1)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        _torch_fused(filters, means, 5, 5, torch.float32, device="cuda")


def test_cpu_path_launches_no_kernel(rng, monkeypatch):
    monkeypatch.setattr(rp, "launches", 0)
    imgs, filters, means = _inputs(rng, 16, 16, 3, 3, n=2)
    _torch_fused(filters, means, 5, 5, torch.bfloat16)(torch.from_numpy(imgs))
    assert rp.launches == 0


FLAGS = [(True, True), (True, False), (False, True), (False, False)]


def _unfused_convolver(conv, batch):
    """The Convolver's output as one expression, in the operation order of
    the JAX package's (``keystone_tpu/ops/images.py``)."""
    filters = conv.filters
    _, ws, _, c = filters.shape
    x = batch.contiguous().permute(0, 3, 1, 2)
    cl = torch.channels_last
    weight = filters.permute(0, 3, 1, 2).contiguous(memory_format=cl)
    out = torch.nn.functional.conv2d(x, weight).permute(0, 2, 3, 1)
    if conv.normalize_patches:
        d = ws * ws * c
        ones = torch.ones((1, c, ws, ws)).contiguous(memory_format=cl)
        psum = torch.nn.functional.conv2d(x, ones).permute(0, 2, 3, 1)
        psumsq = torch.nn.functional.conv2d(x * x, ones).permute(0, 2, 3, 1)
        mu = psum / d
        # The correctly rounded root, as XLA's (the host's f32 torch.sqrt
        # is not, utils/stats.sqrt_rn).
        var = (psumsq - d * mu * mu) / (d - 1.0) + conv.var_constant
        sigma = torch.sqrt(var.double()).float()
        out = (out - mu * filters.sum(dim=(1, 2, 3))) / sigma
    if conv.filter_means_dot is not None:
        out = out - conv.filter_means_dot
    return out


@pytest.mark.parametrize("normalize,means", FLAGS)
def test_convolver_terms_and_epilogue_are_the_convolver(rng, normalize, means):
    imgs, filters, wmeans = _inputs(rng, 20, 24, 7, 5, n=3)
    conv = Convolver(filters, whitener_means=wmeans if means else None,
                     normalize_patches=normalize, device="cpu")
    batch = torch.from_numpy(imgs)
    conv_fp, mu, sigma = conv.terms(batch)
    assert conv_fp.shape == (3, 16, 20, 7) and conv_fp.is_contiguous()
    if normalize:
        assert mu.shape == sigma.shape == (3, 16, 20) and mu.is_contiguous()
    else:
        assert mu is None and sigma is None
    got = convolver_epilogue(conv_fp, mu, sigma, conv.fsum, conv.filter_means_dot)
    assert torch.equal(got, conv(batch))
    assert torch.equal(got, _unfused_convolver(conv, batch))


@pytest.mark.parametrize("normalize,means", FLAGS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_rect_pool_reference_is_the_unfused_chain(rng, normalize, means, dtype):
    imgs, filters, wmeans = _inputs(rng, 32, 32, 100, 6, n=2)
    conv = Convolver(filters, whitener_means=wmeans if means else None,
                     normalize_patches=normalize, device="cpu")
    batch = torch.from_numpy(imgs)
    kw = dict(pool_stride=13, pool_size=14, alpha=0.25, max_val=0.0)
    before = rp.fused_launches
    got = rp.conv_rect_pool(*conv.terms(batch), conv.fsum, conv.filter_means_dot,
                            activation_dtype=dtype, **kw)
    assert rp.fused_launches == before  # a CPU tensor takes the plain version
    ref = rp.rect_pool_reference(conv(batch).to(dtype), **kw)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("normalize,means", FLAGS)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_conv_rect_pool_reference_matches_jax(rng, normalize, means, dtype):
    imgs, filters, wmeans = _inputs(rng, 20, 24, 7, 5)
    kw = dict(pool_stride=4, pool_size=6, alpha=0.25)
    ref = np.asarray(JaxFused(
        jnp.asarray(filters), whitener_means=jnp.asarray(wmeans) if means else None,
        normalize_patches=normalize, activation_dtype=dtype, **kw,
    )(jnp.asarray(imgs)))
    conv = Convolver(filters, whitener_means=wmeans if means else None,
                     normalize_patches=normalize, device="cpu")
    got = rp.conv_rect_pool_reference(
        *conv.terms(torch.from_numpy(imgs)), conv.fsum, conv.filter_means_dot,
        activation_dtype=torch.float32 if dtype == jnp.float32 else torch.bfloat16, **kw,
    ).numpy()
    assert got.shape == ref.shape
    if dtype == jnp.float32:
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5 * np.abs(ref).max())
    else:
        err = np.abs(got - ref).max() / np.abs(ref).max()
        assert err < 1e-2, err
