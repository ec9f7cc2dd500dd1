"""keystone_tpu_torch's HOG and DAISY nodes against the JAX package's (CPU).

HOG: seeded RGB images in [0, 1] at bin sizes 4 and 8, with widths and
heights whose cell grid rounds up (the gradient reads clamp to the image
interior) and down, an all-zero image and one whose three channels are
equal (tied magnitudes: the highest channel wins).  DAISY at the defaults
on 40×40, 40×52 and a constant image, and once at other parameters.

Tolerance: 1e-6 absolute for both nodes (the JAX suite's bar against its
naive transcriptions is 1e-3).  HOG's histogram sums in another order than
the JAX scatter-add, DAISY's norms in another order than
``jnp.linalg.norm``; features are at most 0.2·4 (HOG) and 1 (DAISY).
Within the port, each image gets the same bits at every batch size."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.ops.daisy import DaisyExtractor as JaxDaisy
from keystone_tpu.ops.hog import HogExtractor as JaxHog
from keystone_tpu_torch.ops import daisy as pd
from keystone_tpu_torch.ops import hog as ph
from keystone_tpu_torch.utils.stats import sqrt_rn

ATOL = 1e-6


def hog_batch(rng, h, w):
    img = rng.uniform(0, 1, (3, h, w, 3)).astype(np.float32)
    img[1, :, :, 1:] = img[1, :, :, :1]  # equal channels: tied magnitudes
    img[2] = 0.0
    return img


def cells(size, bin_size):
    return math.floor(size / bin_size + 0.5)


@pytest.mark.parametrize("h,w,bin_size", [
    (20, 24, 4), (20, 24, 8),  # 20/8 rounds up
    (37, 45, 4), (37, 45, 8),  # both round up at 8
    (41, 50, 4), (41, 50, 8),  # 50/4 rounds up; both round down at 8
    (75, 100, 8),  # 100/8 = 12.5 rounds up (half away from zero)
])
def test_hog_matches_jax(rng, h, w, bin_size):
    img = hog_batch(rng, h, w)
    ref = np.asarray(JaxHog(bin_size)(jnp.asarray(img)))
    got = ph.HogExtractor(bin_size)(torch.from_numpy(img))
    nx, ny = cells(w, bin_size), cells(h, bin_size)
    assert got.shape == ref.shape == (3, (nx - 2) * (ny - 2), 32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL)
    assert torch.all(got[..., 31] == 0.0)
    assert torch.all(got[2] == 0.0)  # no gradient, no feature
    assert got[0].abs().max() > 0.05


@pytest.mark.parametrize("h,w,bin_size", [(8, 8, 4), (13, 19, 8), (40, 9, 4)])
def test_hog_too_small_gives_empty(rng, h, w, bin_size):
    img = rng.uniform(0, 1, (2, h, w, 3)).astype(np.float32)
    got = ph.HogExtractor(bin_size)(torch.from_numpy(img))
    ref = np.asarray(JaxHog(bin_size)(jnp.asarray(img)))
    assert got.shape == ref.shape == (2, 0, 32)


def test_hog_batch_invariant(rng):
    img = torch.from_numpy(hog_batch(rng, 37, 45))
    whole = ph.HogExtractor(4)(img)
    for i in range(3):
        assert torch.equal(ph.HogExtractor(4)(img[i : i + 1])[0], whole[i])


@pytest.mark.parametrize("h,w", [(40, 40), (40, 52)])
def test_daisy_matches_jax(rng, h, w):
    img = rng.uniform(0, 1, (2, h, w)).astype(np.float32)
    ext = pd.DaisyExtractor()
    ref = np.asarray(JaxDaisy()(jnp.asarray(img)))
    got = ext(torch.from_numpy(img))
    assert got.shape == ref.shape == (2, len(ext._keypoints(w)) * len(ext._keypoints(h)), 200)
    assert got.is_contiguous() and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL)
    # the same with a channel axis
    assert torch.equal(ext(torch.from_numpy(img[..., None])), got)


def test_daisy_constant_image_matches_jax():
    # interior gradients are zero, but the zero-padded "same" convolution
    # puts energy at the border, which the normalization amplifies
    img = np.full((1, 40, 40, 1), 0.7, np.float32)
    ref = np.asarray(JaxDaisy()(jnp.asarray(img)))
    got = pd.DaisyExtractor()(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    assert np.abs(got).max() > 0.1


def test_daisy_other_parameters_match_jax(rng):
    kw = dict(daisy_t=4, daisy_q=2, daisy_r=5, daisy_h=4, pixel_border=8, stride=6)
    img = rng.uniform(0, 1, (2, 33, 29)).astype(np.float32)
    ref = np.asarray(JaxDaisy(**kw)(jnp.asarray(img)))
    got = pd.DaisyExtractor(**kw)(torch.from_numpy(img)).numpy()
    assert got.shape == ref.shape == (2, 3 * 3, 4 * (4 * 2 + 1))
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_daisy_feature_size_and_gaussians():
    port, ref = pd.DaisyExtractor(), JaxDaisy()
    assert port.feature_size == ref.feature_size == 8 * (8 * 3 + 1)
    got, want = port._gaussians(), ref._gaussians()
    assert [len(g) for g in got] == [13, 21, 27]
    for g, k in zip(got, want):
        assert g.dtype == np.float32 and np.array_equal(g, k)
    assert len(port._keypoints(500)) * len(port._keypoints(375)) == 117 * 86 == 10062
    assert len(port._keypoints(20)) == 0


def test_daisy_batch_invariant(rng):
    img = torch.from_numpy(rng.uniform(0, 1, (3, 40, 52)).astype(np.float32))
    whole = pd.DaisyExtractor()(img)
    for i in range(3):
        assert torch.equal(pd.DaisyExtractor()(img[i : i + 1])[0], whole[i])


def test_sqrt_rn_is_the_correctly_rounded_root(rng):
    x = rng.uniform(0, 1e4, 1 << 16).astype(np.float32)
    got = sqrt_rn(torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), np.sqrt(x))  # numpy's f32 root is IEEE
