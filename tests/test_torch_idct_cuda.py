"""The 8x8 IDCT CUDA kernel (keystone_tpu_torch/csrc/idct.cu) against its
plain PyTorch version on the card, the wrapper's checks, and the whole
device decode on the card against the CPU.

This file imports neither JAX nor the JAX package, so the card tests run on
a machine without them:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_idct_cuda.py``.
Tests that need the card carry the ``cuda`` marker and skip without one.

Tolerances on the card: the kernel against the plain version run in f64 on
the same inputs, rtol 1e-6 and atol 2e-6·max (two 8-term f32 sums per
element keep about 16 ulps of the largest term).  Decoded pixels, card
against CPU: within 1 level, at least 99.9 % equal (rounding at .5 may flip
where the two IDCTs sum in another order)."""

import numpy as np
import pytest
import torch

from keystone_tpu_torch.ops import jpeg_device as jd
from keystone_tpu_torch.testing.jpeg_encode import encode_jpeg


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc) to build and launch the kernel")
    return torch.device("cuda")


def test_wrapper_rejects_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        jd.idct_blocks(torch.empty((4, 8, 8), device="meta"))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape",
    [
        (64 * 48 * 64, 8, 8),  # the luma of a 64-image 375x500 4:2:0 chunk
        (1, 8, 8),
        (37, 8, 8),  # not a multiple of the kernel's four blocks per CTA
        (3, 2, 5, 8, 8),  # leading dims
    ],
)
def test_kernel_matches_f64_reference(cuda_device, shape):
    x = torch.from_numpy(
        np.random.default_rng(0).normal(0, 200, shape).astype(np.float32)
    ).to(cuda_device)
    before = jd.launches
    got = jd.idct_blocks(x)
    torch.cuda.synchronize()
    assert jd.launches == before + 1
    assert got.shape == x.shape
    ref = jd.idct_blocks_reference(x.double())
    torch.testing.assert_close(got.double(), ref, rtol=1e-6, atol=2e-6 * ref.abs().max().item())


@pytest.mark.cuda
def test_empty_batch_launches_nothing(cuda_device):
    before = jd.launches
    out = jd.idct_blocks(torch.empty((0, 8, 8), device=cuda_device))
    assert out.shape == (0, 8, 8) and jd.launches == before


@pytest.mark.cuda
def test_wrapper_raises_on_card(cuda_device):
    x = torch.randn((6, 8, 8), device=cuda_device)
    with pytest.raises(TypeError):
        jd.idct_blocks(x.double())
    with pytest.raises(ValueError, match="contiguous"):
        jd.idct_blocks(x.transpose(1, 2))
    with pytest.raises(ValueError, match=r"\[\.\.\., 8, 8\]"):
        jd.idct_blocks(torch.randn((6, 8, 4), device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("subsampling", ["4:2:0", "4:4:4"])
def test_decode_batch_card_matches_cpu(cuda_device, subsampling):
    rng = np.random.default_rng(1)
    images = [
        jd.entropy_decode(encode_jpeg(rng.uniform(0, 255, (45, 61, 3)), 90, subsampling)[0])
        for _ in range(3)
    ]
    coeffs, qt = jd.stack_coeff_images(images)
    before = jd.launches
    on_card = jd.decode_batch(images[0].geom, coeffs, qt, cuda_device).cpu()
    assert jd.launches == before + 3  # one launch per component
    on_cpu = jd.decode_batch(images[0].geom, coeffs, qt, "cpu")
    diff = (on_card - on_cpu).abs()
    assert on_card.shape == (3, 45, 61, 3)
    assert diff.max().item() <= 1.0
    assert diff.eq(0).float().mean().item() >= 0.999
