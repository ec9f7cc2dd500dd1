"""The 8x8 IDCT CUDA kernel (keystone_tpu_torch/csrc/idct.cu) against its
plain PyTorch version on the card, the wrappers' checks, and the whole
device decode (two launches of the same file) against the PyTorch
composition on the card and against the CPU.

This file imports neither JAX nor the JAX package, so the card tests run on
a machine without them:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_idct_cuda.py``.
Tests that need the card carry the ``cuda`` marker and skip without one.

Tolerances on the card: the kernel against the plain version run in f64 on
the same inputs, rtol 1e-6 and atol 2e-6·max (two 8-term f32 sums per
element keep about 16 ulps of the largest term).  The fused decode against
the composition on the card (with the IDCT kernel in it): ``torch.equal``,
every step rounds as there.  Decoded pixels, card against CPU: within 1
level, at least 99.9 % equal (rounding at .5 may flip where the two IDCTs
sum in another order)."""

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
    geom = jd.JpegGeometry(8, 8, ((1, 1),), ((1, 1),))
    with pytest.raises(ValueError, match="unsupported device"):
        jd.decode_pixels(geom, (torch.empty((1, 1, 1, 8, 8), dtype=torch.int16, device="meta"),),
                         torch.empty((1, 1, 8, 8), device="meta"))


def _chunk(subsampling, size, qualities, seed=1):
    """Entropy-decoded JPEGs of seeded noise-and-gradient images, one per
    quality, all of one geometry: (geom, coeffs, qt) as numpy arrays."""
    rng = np.random.default_rng(seed)
    h, w = size
    yy, xx = np.mgrid[0:h, 0:w]
    images = []
    for q in qualities:
        img = rng.uniform(0, 255, (h, w, 3)) * 0.5 + (yy * 3 + xx * 2)[..., None] % 128
        if subsampling == "gray":
            data = encode_jpeg(img[..., 0], q)[0]
        else:
            data = encode_jpeg(img, q, subsampling)[0]
        images.append(jd.entropy_decode(data))
    assert len({img.geom for img in images}) == 1
    return (images[0].geom, *jd.stack_coeff_images(images))


DECODE_CASES = [
    (ss, size)
    for ss in ("4:2:0", "4:2:2", "4:4:4", "gray")
    for size in ((45, 61), (33, 47), (16, 16))
]


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
@pytest.mark.parametrize("subsampling,size", DECODE_CASES)
def test_fused_decode_equals_composition_on_card(cuda_device, subsampling, size):
    geom, coeffs, qt = _chunk(subsampling, size, (75, 90, 95))  # mixed quality
    coeffs = [torch.from_numpy(c).to(cuda_device) for c in coeffs]
    qt = torch.from_numpy(qt).to(cuda_device)
    before = jd.decode_launches, jd.launches
    got = jd.decode_pixels(geom, coeffs, qt)
    torch.cuda.synchronize()
    assert (jd.decode_launches, jd.launches) == (before[0] + 2, before[1])
    ref = jd.decode_pixels_reference(geom, coeffs, qt)
    assert got.shape == (3, *size, 3)
    assert torch.equal(got, ref)
    on_cpu = jd.decode_pixels(geom, [c.cpu() for c in coeffs], qt.cpu())
    diff = (got.cpu() - on_cpu).abs()
    assert diff.max().item() <= 1.0 and diff.eq(0).float().mean().item() >= 0.999


@pytest.mark.cuda
def test_fused_decode_raises_on_card(cuda_device):
    geom, coeffs, qt = _chunk("4:2:0", (33, 47), (90,))
    coeffs = [torch.from_numpy(c).to(cuda_device) for c in coeffs]
    qt = torch.from_numpy(qt).to(cuda_device)
    with pytest.raises(TypeError):
        jd.decode_pixels(geom, [coeffs[0].float(), *coeffs[1:]], qt)
    with pytest.raises(TypeError):
        jd.decode_pixels(geom, coeffs, qt.double())
    with pytest.raises(ValueError, match="contiguous"):
        jd.decode_pixels(geom, [coeffs[0].transpose(3, 4), *coeffs[1:]], qt)
    with pytest.raises(ValueError, match="on cpu"):
        jd.decode_pixels(geom, coeffs, qt.cpu())
    with pytest.raises(ValueError, match="expected"):
        jd.decode_pixels(geom, [coeffs[0][:, :-1].contiguous(), *coeffs[1:]], qt)
    with pytest.raises(ValueError, match="components"):
        jd.decode_pixels(geom, coeffs[:2], qt)
    bad = jd.JpegGeometry(33, 47, ((4, 1), (1, 1), (1, 1)), geom.block_shape)
    with pytest.raises(ValueError, match="1x or 2x"):
        jd.decode_pixels(bad, coeffs, qt)
    empty = jd.decode_pixels(geom, [c[:0] for c in coeffs], qt[:0])
    assert empty.shape == (0, 33, 47, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("subsampling", ["4:2:0", "4:4:4"])
def test_decode_batch_card_matches_cpu(cuda_device, subsampling):
    rng = np.random.default_rng(1)
    images = [
        jd.entropy_decode(encode_jpeg(rng.uniform(0, 255, (45, 61, 3)), 90, subsampling)[0])
        for _ in range(3)
    ]
    coeffs, qt = jd.stack_coeff_images(images)
    before = jd.decode_launches, jd.launches
    on_card = jd.decode_batch(images[0].geom, coeffs, qt, cuda_device).cpu()
    # the planes launch and the pixels launch; the IDCT entry is not used
    assert (jd.decode_launches, jd.launches) == (before[0] + 2, before[1])
    on_cpu = jd.decode_batch(images[0].geom, coeffs, qt, "cpu")
    diff = (on_card - on_cpu).abs()
    assert on_card.shape == (3, 45, 61, 3)
    assert diff.max().item() <= 1.0
    assert diff.eq(0).float().mean().item() >= 0.999
