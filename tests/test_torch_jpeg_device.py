"""The port's JPEG decode (keystone_tpu_torch.ops.jpeg_device and
ops.native_entropy) against the JAX package's on the CPU.

Corpus: seeded baseline JPEGs from PIL, as ``tests/test_jpeg_device.py``
builds its own: noise and smooth images at 4:4:4 / 4:2:2 / 4:2:0 and
quality 85 / 90 / 95, an odd 47x53 at each subsampling, grayscale, and
restart markers.

Tolerances: the entropy pass is bit-identical (geometry, quant tables,
int16 coefficients) on both of the port's backends, with the same
``reason`` slugs and ``JpegEntropyCorrupt`` messages.  The plain IDCT
against ``idct_blocks_jnp`` and the Pallas kernel in interpret mode: rtol
1e-5, atol 1e-5·max (measured: 1.2e-7·max, 1.5 f32 ulps of the largest
value; the two frameworks contract the einsum in other orders).  Decoded pixels
against JAX ``decode_batch``: within 1 level and at least 99.9 % equal (a
.5 rounding may flip); against PIL within the golden bounds
``GOLDEN_MAX_ABS`` = 8, ``GOLDEN_MEAN_ABS`` = 1."""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import faults
from keystone_tpu.ops import jpeg_device as jjd
from keystone_tpu.ops import native_entropy as jne
from keystone_tpu_torch import _build
from keystone_tpu_torch.core.resilience import counters as pcounters
from keystone_tpu_torch.loaders.image_loaders import decode_image
from keystone_tpu_torch.ops import jpeg_device as jd
from keystone_tpu_torch.ops import native_entropy as ne


def _jpeg(arr, **kw) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def _corpus() -> dict:
    rng = np.random.default_rng(0)
    noise = rng.integers(0, 256, (64, 64, 3)).astype(np.uint8)
    yy, xx = np.mgrid[0:64, 0:64]
    smooth = (
        np.stack([(np.sin(yy / 9) + np.cos(xx / 7)) * 60 + 128] * 3, -1)
        .clip(0, 255)
        .astype(np.uint8)
    )
    odd = rng.integers(0, 256, (47, 53, 3)).astype(np.uint8)
    gray = rng.integers(0, 256, (40, 44)).astype(np.uint8)
    cases = {}
    for label, arr in (("noise", noise), ("smooth", smooth)):
        for ss in (0, 1, 2):  # 4:4:4, 4:2:2, 4:2:0
            for q in (85, 90, 95):
                cases[f"{label}/ss{ss}/q{q}"] = _jpeg(arr, quality=q, subsampling=ss)
    for ss in (0, 1, 2):
        cases[f"odd/ss{ss}"] = _jpeg(odd, quality=90, subsampling=ss)
    cases["gray"] = _jpeg(gray, quality=90)
    cases["restart"] = _jpeg(noise, quality=90, subsampling=2, restart_marker_blocks=2)
    return cases


CORPUS = _corpus()
LABELS = sorted(CORPUS)
BACKENDS = ["python", "native"]


@pytest.fixture(autouse=True)
def _native_library(request):
    """A ``native`` case skips, at run time, when the PORT's library
    (``keystone_tpu_torch.ops.native_entropy``, built into a temporary file
    and renamed into place) cannot be built or loaded."""
    callspec = getattr(request.node, "callspec", None)
    if callspec is not None and callspec.params.get("backend") == "native" \
            and not ne.available():
        pytest.skip("the port's native entropy library is unbuildable or unloadable "
                    "(no g++? see KEYSTONE_NATIVE_ENTROPY)")


def _same_coeff_image(port, ref):
    assert (port.geom.height, port.geom.width, port.geom.sampling, port.geom.block_shape) == (
        ref.geom.height, ref.geom.width, ref.geom.sampling, ref.geom.block_shape)
    assert port.qt.dtype == np.float32 and np.array_equal(port.qt, ref.qt)
    assert len(port.coeffs) == len(ref.coeffs)
    for a, b in zip(port.coeffs, ref.coeffs):
        assert a.dtype == np.int16 and np.array_equal(a, b)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("label", LABELS)
def test_entropy_decode_bit_identical(label, backend):
    data = CORPUS[label]
    _same_coeff_image(jd.entropy_decode(data, backend=backend),
                      jjd.entropy_decode(data, backend="python"))


def test_zigzag_and_tables_match_jax():
    np.testing.assert_array_equal(jd.ZIGZAG, jjd.ZIGZAG)
    np.testing.assert_array_equal(jd._idct_basis(), jjd._idct_basis())
    assert ne._ERR_MESSAGES == jne._ERR_MESSAGES
    assert (jd.GOLDEN_MAX_ABS, jd.GOLDEN_MEAN_ABS) == (jjd.GOLDEN_MAX_ABS, jjd.GOLDEN_MEAN_ABS)


def _unsupported_cases() -> dict:
    from PIL import Image

    noise = np.random.default_rng(1).integers(0, 256, (48, 48, 3)).astype(np.uint8)
    base = _jpeg(noise, quality=90, subsampling=0)
    sof = base.find(b"\xff\xc0")
    comp0 = sof + 2 + 2 + 6  # marker+len | P,H,W,Nf -> first component id
    cmyk = io.BytesIO()
    Image.fromarray(noise).convert("CMYK").save(cmyk, "JPEG", quality=90)
    rgb_ids = base[:comp0] + b"R" + base[comp0 + 1 : comp0 + 3] + b"G" + \
        base[comp0 + 4 : comp0 + 6] + b"B" + base[comp0 + 7 :]
    app14 = b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00\x00"
    return {
        "progressive": _jpeg(noise, quality=90, progressive=True),
        "cmyk": cmyk.getvalue(),
        "rgb_ids": rgb_ids,
        "adobe_rgb": base[:2] + app14 + base[2:],
        "12bit": base[: sof + 4] + b"\x0c" + base[sof + 5 :],
        "arithmetic": base.replace(b"\xff\xc0", b"\xff\xc9", 1),
        "subsampling": base[: comp0 + 1] + b"\x41" + base[comp0 + 2 :],
        "not_jpeg": b"\x89PNG not a jpeg at all",
    }


UNSUPPORTED = _unsupported_cases()


@pytest.mark.parametrize("case", sorted(UNSUPPORTED))
def test_unsupported_reasons_match_jax(case):
    data = UNSUPPORTED[case]
    with pytest.raises(jjd.JpegDecodeUnsupported) as ref:
        jjd.entropy_decode(data, backend="python")
    with pytest.raises(jd.JpegDecodeUnsupported) as got:
        jd.entropy_decode(data, backend="python")
    assert got.value.reason == ref.value.reason
    assert str(got.value) == str(ref.value)
    assert ref.value.reason in {"progressive", "cmyk", "rgb_colorspace", "precision",
                                "arithmetic", "subsampling", "not_jpeg"}


def _corrupt_cases() -> dict:
    base = _jpeg(np.random.default_rng(2).integers(0, 256, (48, 48, 3)).astype(np.uint8),
                 quality=90, subsampling=2, restart_marker_blocks=2)
    scan = base.find(b"\xff\xda")
    # stuffed 0xFF bytes mid-scan: 16 one-bits, no code of the standard tables
    garbled = base[: scan + 40] + b"\xff\x00" * 8 + base[scan + 56 :]
    return {
        "truncate": faults.corrupt_jpeg_entropy(base, "truncate"),
        "marker": faults.corrupt_jpeg_entropy(base, "marker"),
        "garbled": garbled,
        "short": base[: scan + 30],
    }


CORRUPT = _corrupt_cases()


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", sorted(CORRUPT))
def test_corrupt_scan_messages_match_jax(case, backend):
    data = CORRUPT[case]
    with pytest.raises(jjd.JpegEntropyCorrupt) as ref:
        jjd.entropy_decode(data, backend="python")
    with pytest.raises(jd.JpegEntropyCorrupt) as got:
        jd.entropy_decode(data, backend=backend)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("shape", [(37, 8, 8), (3, 2, 5, 8, 8)])
def test_idct_reference_matches_jax_and_pallas(shape):
    blocks = np.random.default_rng(3).normal(0, 50, shape).astype(np.float32)
    before = jd.launches
    got = jd.idct_blocks(torch.from_numpy(blocks)).numpy()
    assert jd.launches == before  # a CPU tensor takes the plain version
    for ref in (jjd.idct_blocks_jnp(jnp.asarray(blocks)),
                jjd.idct_blocks_pallas(jnp.asarray(blocks), interpret=True)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def _port_pixels(datas):
    images = [jd.entropy_decode(d) for d in datas]
    coeffs, qt = jd.stack_coeff_images(images)
    out = jd.decode_batch(images[0].geom, coeffs, qt, "cpu")
    assert out.dtype == torch.float32
    return out.numpy()


@pytest.mark.parametrize("label", LABELS)
def test_decode_batch_matches_jax_and_pil(label):
    data = CORPUS[label]
    got = _port_pixels([data])[0]
    ci = jjd.entropy_decode(data, backend="python")
    ref = np.asarray(jjd.decode_batch(ci.geom, *jjd.stack_coeff_images([ci])))[0]
    assert got.shape == ref.shape
    assert np.array_equal(got, np.round(got)) and got.min() >= 0 and got.max() <= 255
    diff = np.abs(got - ref)
    assert diff.max() <= 1.0 and (diff == 0).mean() >= 0.999
    pil = decode_image(data)
    golden = np.abs(got - pil)
    assert golden.max() <= jd.GOLDEN_MAX_ABS and golden.mean() <= jd.GOLDEN_MEAN_ABS


def test_mixed_quality_batch_uses_per_image_quant_tables():
    arr = np.random.default_rng(4).integers(0, 256, (48, 48, 3)).astype(np.uint8)
    datas = [_jpeg(arr, quality=q, subsampling=2) for q in (85, 90, 95)]
    assert len({jd.entropy_decode(d).geom for d in datas}) == 1  # one bucket
    batch = _port_pixels(datas)
    for i, data in enumerate(datas):
        assert np.array_equal(batch[i], _port_pixels([data])[0])
        golden = np.abs(batch[i] - decode_image(data))
        assert golden.max() <= jd.GOLDEN_MAX_ABS and golden.mean() <= jd.GOLDEN_MEAN_ABS


@pytest.mark.parametrize("subsampling", ["4:2:0", "4:2:2", "4:4:4", "gray"])
@pytest.mark.parametrize("size", [(45, 61), (33, 47), (47, 53), (16, 16)])
def test_plane_layout(subsampling, size):
    """Each component's cropped plane and upsampling, as the decode kernel
    is handed them, for the four samplings at odd sizes."""
    from keystone_tpu_torch.testing.jpeg_encode import encode_jpeg

    h, w = size
    img = np.random.default_rng(5).uniform(0, 255, (h, w, 3))
    data = encode_jpeg(img[..., 0], 90)[0] if subsampling == "gray" else encode_jpeg(img, 90, subsampling)[0]
    geom = jd.entropy_decode(data).geom
    half_h, half_w = -(-h // 2), -(-w // 2)
    chroma = {"4:2:0": (half_h, half_w, True, True), "4:2:2": (h, half_w, True, False),
              "4:4:4": (h, w, False, False)}
    expect = [(h, w, False, False)]
    if subsampling != "gray":
        expect += [chroma[subsampling]] * 2
    layout = jd.plane_layout(geom)
    assert [(p.height, p.width, p.up_h, p.up_v) for p in layout] == expect
    for spec, (by, bx) in zip(layout, geom.block_shape):
        assert spec.height <= 8 * by < spec.height + 16 and spec.width <= 8 * bx < spec.width + 16
        assert h <= spec.height * (2 if spec.up_v else 1) <= h + 1
        assert w <= spec.width * (2 if spec.up_h else 1) <= w + 1


def test_fused_apply_is_transform_of_decode():
    data = CORPUS["odd/ss2"]
    ci = jd.entropy_decode(data)
    coeffs, qt = jd.stack_coeff_images([ci])
    out = jd.fused_apply(lambda px: px.mean(dim=(1, 2)), ci.geom, coeffs, qt, "cpu")
    np.testing.assert_array_equal(out.numpy(), _port_pixels([data]).mean(axis=(1, 2)))


def test_native_unavailable_degrades_counted(monkeypatch):
    """Without the library the auto backend runs the Python pass, counted
    once as ``native_entropy_unavailable``; a pinned native backend raises."""
    def no_compiler(*_a, **_k):
        raise RuntimeError("no compiler")

    monkeypatch.setattr(_build, "load", no_compiler)
    before = pcounters.get("native_entropy_unavailable")
    ne.reset()
    try:
        data = CORPUS["restart"]
        _same_coeff_image(jd.entropy_decode(data), jjd.entropy_decode(data, backend="python"))
        jd.entropy_decode(data)
        assert pcounters.get("native_entropy_unavailable") - before == 1
        assert jd.entropy_backend() == "python"
        with pytest.raises(RuntimeError, match="pinned to 'native'"):
            jd.entropy_decode(data, backend="native")
    finally:
        ne.reset()


def test_native_failure_mid_call_falls_back_counted(monkeypatch):
    def boom(*_a, **_k):
        raise OSError("injected")

    monkeypatch.setattr(ne, "decode_scan", boom)
    before = pcounters.get("native_entropy_fallback")
    data = CORPUS["noise/ss2/q90"]
    _same_coeff_image(jd.entropy_decode(data), jjd.entropy_decode(data, backend="python"))
    assert pcounters.get("native_entropy_fallback") - before == 1


def test_env_gate_selects_python(monkeypatch):
    monkeypatch.setenv(ne.NATIVE_ENTROPY_ENV, "0")
    monkeypatch.setattr(ne, "decode_scan", lambda *a: pytest.fail("native loop ran"))
    data = CORPUS["gray"]
    _same_coeff_image(jd.entropy_decode(data), jjd.entropy_decode(data, backend="python"))
    assert jd.entropy_backend() == "python"
