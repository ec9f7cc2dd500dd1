"""keystone_tpu_torch's HOG and DAISY nodes on the card against the same
nodes on the CPU, and two card runs against each other.

This file imports neither JAX nor the JAX package, so the card tests run on
a machine without them:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_daisy_hog_cuda.py``.
Tests that need the card carry the ``cuda`` marker and skip without one.

Tolerance: none.  Both nodes take no atomics, sum in a fixed order and
take correctly rounded square roots, so the card's output must be
``torch.equal`` to the CPU's (as in ``chip_smoke.py`` phase 20), and so
must two card runs and an image alone against its batch."""

import numpy as np
import pytest
import torch

from keystone_tpu_torch.ops.daisy import DaisyExtractor
from keystone_tpu_torch.ops.hog import HogExtractor
from keystone_tpu_torch.utils.stats import sqrt_rn

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def pixels(shape, seed):
    """Integer pixels in [0, 255], with a flat patch (no gradient) in the
    first image."""
    img = np.random.default_rng(seed).integers(0, 256, shape).astype(np.float32)
    img[0, :40, :40] = 100.0
    return torch.from_numpy(img)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,bin_size", [
    ((3, 375, 500, 3), 8), ((3, 500, 375, 3), 8), ((2, 37, 45, 3), 4), ((2, 8, 8, 3), 4),
])
def test_hog_card_matches_cpu(cuda_device, shape, bin_size):
    x = pixels(shape, 0)
    on_cpu = HogExtractor(bin_size)(x)
    on_card = HogExtractor(bin_size)(x.to(cuda_device))
    assert on_card.device.type == "cuda" and on_card.shape == on_cpu.shape
    assert torch.equal(on_card.cpu(), on_cpu)
    assert torch.equal(HogExtractor(bin_size)(x.to(cuda_device)), on_card)
    if shape[1:3] == (375, 500):
        assert on_card.shape == (3, 61 * 45, 32)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 375, 500), (3, 500, 375), (2, 40, 52)])
def test_daisy_card_matches_cpu(cuda_device, shape):
    x = pixels(shape, 1)
    on_cpu = DaisyExtractor()(x)
    on_card = DaisyExtractor()(x.to(cuda_device))
    assert on_card.device.type == "cuda" and on_card.shape == on_cpu.shape
    assert torch.equal(on_card.cpu(), on_cpu)
    assert torch.equal(DaisyExtractor()(x.to(cuda_device)), on_card)
    if shape[1:] == (375, 500):
        assert on_card.shape == (3, 10062, 200)


@pytest.mark.cuda
def test_card_batch_invariant(cuda_device):
    x = pixels((3, 120, 160, 3), 2).to(cuda_device)
    hog, daisy = HogExtractor(8)(x), DaisyExtractor()(x[..., 0])
    for i in range(3):
        assert torch.equal(HogExtractor(8)(x[i : i + 1])[0], hog[i])
        assert torch.equal(DaisyExtractor()(x[i : i + 1, ..., 0])[0], daisy[i])


@pytest.mark.cuda
def test_sqrt_rn_is_the_correctly_rounded_root_on_both(cuda_device):
    x = torch.rand(1 << 20, generator=torch.Generator().manual_seed(3)) * 1e4
    want = torch.from_numpy(np.sqrt(x.numpy()))  # numpy's f32 root is IEEE
    assert torch.equal(sqrt_rn(x.to(cuda_device)).cpu(), want)
    assert torch.equal(sqrt_rn(x), want)
