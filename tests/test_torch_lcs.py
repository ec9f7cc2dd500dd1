"""keystone_tpu_torch LCS against the JAX package's (CPU): the zero-padded
"same" true convolution and the whole extractor, at ImageNetSiftLcsFV's
setting (stride 4, border 16, patch 6) and at odd sizes and odd and even
patch sizes, on integer pixels in [0, 255].

Tolerance: rtol 1e-5 and atol 255e-6 (a millionth of the pixel range).
The standard deviation is ``sqrt(max(E[x²] − E[x]², 0))``: one ulp of
E[x²] near 65,025 is 0.004 in the variance, so where the window is flat
(std 0) two correct f32 implementations differ by up to ~1e-4 absolute;
the means, and the convolution alone, agree to a few 1e-7 relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.ops import lcs as jl
from keystone_tpu_torch.ops import lcs as pl

CASES = [
    ((2, 64, 80, 3), 4, 16, 6),  # the workload's setting
    ((1, 61, 77, 3), 5, 12, 3),  # odd sizes, odd patch
    ((2, 50, 53, 3), 3, 10, 5),
    ((1, 48, 64, 3), 4, 16, 4),  # even patch
    ((1, 45, 47, 1), 4, 11, 4),  # one channel
]


def _pixels(rng, shape):
    img = np.round(rng.uniform(0, 255, shape)).astype(np.float32)
    img[0, :20, :20] = 100.0  # a flat patch: std 0, the worst cancellation
    return img


@pytest.mark.parametrize("shape,stride,start,sub", CASES)
def test_lcs_matches_jax(rng, shape, stride, start, sub):
    img = _pixels(rng, shape)
    ref = np.asarray(jl.LCSExtractor(stride, start, sub)(jnp.asarray(img)))
    ext = pl.LCSExtractor(stride, start, sub)
    got = ext(torch.from_numpy(img)).numpy()
    n, h, w, c = shape
    assert got.shape == ref.shape == (n, 2 * 16 * c, ext.num_keypoints(h, w))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=255e-6)


@pytest.mark.parametrize("xlen,ylen", [(6, 6), (3, 5), (4, 1), (1, 7), (2, 2)])
def test_same_conv2d_zero_matches_jax(rng, xlen, ylen):
    img = _pixels(rng, (2, 13, 17, 3))
    xf = rng.uniform(0.1, 1.0, xlen).astype(np.float32)
    yf = rng.uniform(0.1, 1.0, ylen).astype(np.float32)
    ref = np.asarray(jl._same_conv2d_zero(jnp.asarray(img), xf, yf))
    got = pl._same_conv2d_zero(torch.from_numpy(img), xf, yf).numpy()
    assert got.shape == ref.shape == img.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("h,w", [(375, 500), (333, 500), (500, 375), (64, 64)])
def test_num_keypoints_match_jax(h, w):
    port = pl.LCSExtractor(4, 16, 6)
    assert port.num_keypoints(h, w) == jl.LCSExtractor(4, 16, 6).num_keypoints(h, w)
    if (h, w) == (375, 500):
        assert port.num_keypoints(h, w) == 10062


def test_descriptor_is_96_dimensional_for_bgr(rng):
    ext = pl.LCSExtractor(4, 16, 6)
    out = ext(torch.from_numpy(_pixels(rng, (1, 64, 64, 3))))
    assert out.shape == (1, 96, ext.num_keypoints(64, 64))
    assert out.is_contiguous() and out.dtype == torch.float32


def test_negative_offset_guard_raises_in_both(rng):
    img = _pixels(rng, (1, 40, 40, 3))
    with pytest.raises(ValueError, match="too small"):
        pl.LCSExtractor(4, 2, 6)(torch.from_numpy(img))
    with pytest.raises(ValueError, match="too small"):
        jl.LCSExtractor(4, 2, 6)(jnp.asarray(img))


def test_each_image_gets_the_bits_of_its_batch(rng):
    img = torch.from_numpy(_pixels(rng, (5, 61, 77, 3)))
    ext = pl.LCSExtractor(4, 16, 6)
    batch = ext(img)
    for i in range(5):
        assert torch.equal(ext(img[i : i + 1])[0], batch[i])
