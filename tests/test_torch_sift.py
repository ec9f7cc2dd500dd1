"""keystone_tpu_torch dense SIFT against the JAX package's, on the same
grayscale images (CPU).

Bar: at least 99.5 % of the quantised descriptor entries within ±1 of the
JAX package's, in f32 and with bf16 intermediates (BASELINE.md row 5, the
reference's MATLAB acceptance envelope).  The numpy helpers are copies and
must match exactly; the f32 intermediates match to rtol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.ops import sift as jx
from keystone_tpu_torch.ops import sift as pt

DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


def _np(x):
    return np.asarray(x.detach().cpu().float() if isinstance(x, torch.Tensor) else x)


@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "shape,step,scale_step",
    [((2, 56, 72), 3, 0), ((2, 64, 48), 4, 1)],  # the VOC settings; the op default
)
def test_descriptors_match_jax(rng, dtypes, shape, step, scale_step):
    img = rng.uniform(0, 1, shape).astype(np.float32)
    jd, td = dtypes
    sift = jx.SIFTExtractor(step, scale_step=scale_step, compute_dtype=jd)
    ref = np.asarray(jax.jit(lambda x: sift(x))(jnp.asarray(img)))
    got = _np(pt.SIFTExtractor(step, scale_step=scale_step, compute_dtype=td)(torch.from_numpy(img)))
    assert got.shape == ref.shape
    assert np.mean(np.abs(got - ref) <= 1.0) >= 0.995
    assert got.min() >= 0 and got.max() <= 255


@pytest.mark.parametrize(
    "h,w,step,scales,scale_step",
    [(375, 500, 3, 4, 0), (500, 375, 3, 4, 0), (64, 64, 6, 4, 0), (70, 90, 3, 4, 1), (40, 40, 2, 3, 2)],
)
def test_num_descriptors(h, w, step, scales, scale_step):
    port = pt.SIFTExtractor(step, scales=scales, scale_step=scale_step)
    ref = jx.SIFTExtractor(step, scales=scales, scale_step=scale_step)
    assert port.num_descriptors(h, w) == ref.num_descriptors(h, w)
    if (h, w) == (375, 500):
        assert port.num_descriptors(h, w) == 73866  # the VOC production count
    if h <= 70:
        out = port(torch.zeros((1, h, w)))
        assert out.shape == (1, 128, port.num_descriptors(h, w))


def test_flat_image_gives_zero_descriptors():
    out = pt.SIFTExtractor(3, scale_step=0)(torch.full((2, 48, 60), 0.5))
    assert out.shape[1] == 128 and out.shape[2] > 0
    assert torch.count_nonzero(out) == 0


def test_negative_origin_raises():
    # off = (1 + 2S) - 3s < 0 for S=6, s=5
    with pytest.raises(ValueError, match="negative grid origin"):
        pt.SIFTExtractor(3, scales=6).num_descriptors(100, 100)
    with pytest.raises(ValueError, match="negative grid origin"):
        pt.SIFTExtractor(3, scales=6)(torch.zeros((1, 100, 100)))
    with pytest.raises(ValueError, match="negative grid origin"):
        jx.SIFTExtractor(3, scales=6).num_descriptors(100, 100)


@pytest.mark.parametrize("b", [4, 6, 8, 10])
def test_numpy_helpers_are_copies(b):
    np.testing.assert_array_equal(pt._gaussian_kernel(b / 6.0), jx._gaussian_kernel(b / 6.0))
    np.testing.assert_array_equal(pt._triangular_kernel(b), jx._triangular_kernel(b))
    pos = np.arange(0, 50, 3)
    tri = jx._triangular_kernel(b)
    np.testing.assert_array_equal(
        pt._binned_sampling_matrix(53, pos, tri), jx._binned_sampling_matrix(53, pos, tri)
    )
    assert pt._scale_geometry(60, 80, 3, b, 4, 1)[1].tolist() == (
        jx._scale_geometry(60, 80, 3, b, 4, 1)[1].tolist()
    )


def test_f32_intermediates_match(rng):
    img = rng.uniform(0, 1, (2, 30, 41)).astype(np.float32)
    smoothed = pt._smooth(torch.from_numpy(img), 6 / pt.MAGNIF)
    ref_smoothed = np.asarray(jax.jit(lambda x: jx._smooth(x, 6 / jx.MAGNIF))(jnp.asarray(img)))
    np.testing.assert_allclose(_np(smoothed), ref_smoothed, rtol=1e-5, atol=1e-6)
    gy, gx = pt._gradients(smoothed)
    jgy, jgx = jax.jit(jx._gradients)(jnp.asarray(_np(smoothed)))
    np.testing.assert_allclose(_np(gy), np.asarray(jgy), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(_np(gx), np.asarray(jgx), rtol=1e-5, atol=1e-7)
    planes = pt._orientation_planes(gy, gx)
    ref_planes = np.asarray(jax.jit(jx._orientation_planes)(jgy, jgx))
    np.testing.assert_allclose(_np(planes), ref_planes, rtol=1e-5, atol=1e-6)
