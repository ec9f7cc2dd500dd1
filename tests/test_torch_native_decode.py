"""The port's host JPEG decoder (``keystone_tpu_torch.loaders.native_decode``,
``csrc/ingest.cpp`` built with ``-ljpeg``) against the JAX package's native
decoder and PIL, and ``image_loaders.decode_image``'s order of decoders.

Tolerance: exact (``np.array_equal``).  The two native decoders are one C
source linked against the same libjpeg; where PIL is linked against it too,
its pixels are the same (the PIL comparison assumes that build)."""

import io
import sys

import numpy as np
import pytest
from PIL import Image

import faults
from keystone_tpu.loaders import native_decode as jnative
from keystone_tpu_torch import _build
from keystone_tpu_torch.loaders import image_loaders as ploaders
from keystone_tpu_torch.loaders import native_decode as pnative

CASES = [(sub, q) for sub in (0, 2, "gray") for q in (75, 90)]


def _jpeg(rng, h, w, subsampling, quality) -> bytes:
    buf = io.BytesIO()
    if subsampling == "gray":
        img = Image.fromarray(rng.integers(0, 256, (h, w)).astype(np.uint8), "L")
        img.save(buf, format="JPEG", quality=quality)
    else:
        img = Image.fromarray(rng.integers(0, 256, (h, w, 3)).astype(np.uint8))
        img.save(buf, format="JPEG", quality=quality, subsampling=subsampling)
    return buf.getvalue()


def _pil_bgr(data: bytes) -> np.ndarray:
    arr = np.asarray(Image.open(io.BytesIO(data)), np.float32)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    return arr[:, :, ::-1]


@pytest.fixture
def native_on(monkeypatch):
    monkeypatch.delenv(pnative.NATIVE_DECODE_ENV, raising=False)
    pnative.reset()
    yield
    pnative.reset()


@pytest.mark.parametrize("sub,quality", CASES)
def test_native_equals_jax_native_and_pil(native_on, sub, quality):
    rng = np.random.default_rng(7)
    data = _jpeg(rng, 40, 52, sub, quality)
    got = pnative.decode_jpeg_native(data)
    assert got is not None and got.dtype == np.float32 and got.shape == (40, 52, 3)
    assert np.array_equal(got, jnative.decode_jpeg_native(data))
    assert np.array_equal(got, _pil_bgr(data))
    assert np.array_equal(ploaders.decode_image(data), got)


@pytest.mark.parametrize("case", ["tiny", "corrupt"])
def test_native_rejects_small_and_corrupt(native_on, case):
    rng = np.random.default_rng(8)
    data = _jpeg(rng, 30 if case == "tiny" else 48, 48, 2, 90)
    if case == "corrupt":  # SOI kept, headers scrambled, tail cut
        data = faults.corrupt_jpeg(data, rng)
    assert pnative.decode_jpeg_native(data) is None
    assert jnative.decode_jpeg_native(data) is None
    # PIL applies the same floor and fails the same mangled stream
    assert ploaders.decode_image(data) is None


def test_env_gate_takes_pil(monkeypatch):
    rng = np.random.default_rng(9)
    data = _jpeg(rng, 48, 48, 0, 90)
    monkeypatch.setenv(pnative.NATIVE_DECODE_ENV, "0")
    pnative.reset()
    try:
        assert not pnative.available()
        assert pnative.decode_jpeg_native(data) is None
        assert np.array_equal(ploaders.decode_image(data), _pil_bgr(data))
    finally:
        monkeypatch.delenv(pnative.NATIVE_DECODE_ENV)
        pnative.reset()
    assert pnative.available()


def test_no_decoder_raises_typed(monkeypatch):
    """Neither decoder: raised, never a skip.  A JPEG that native rejected
    on a host without PIL is a rejection (None)."""
    rng = np.random.default_rng(10)
    good = _jpeg(rng, 48, 48, 2, 90)
    monkeypatch.setitem(sys.modules, "PIL", None)
    pnative.reset()
    try:
        assert np.array_equal(ploaders.decode_image(good), pnative.decode_jpeg_native(good))
        assert ploaders.decode_image(faults.corrupt_jpeg(good, rng)) is None
        with pytest.raises(ploaders.HostDecoderUnavailable, match="PIL"):
            ploaders.decode_image(b"\x89PNG\r\n\x1a\n" + bytes(64))
        monkeypatch.setenv(pnative.NATIVE_DECODE_ENV, "0")
        pnative.reset()
        with pytest.raises(ploaders.HostDecoderUnavailable, match="native"):
            ploaders.decode_image(good)
    finally:
        monkeypatch.delenv(pnative.NATIVE_DECODE_ENV, raising=False)
        pnative.reset()


@pytest.mark.parametrize("name", ["ingest", "entropy"])
def test_link_flags_key_the_library(monkeypatch, name):
    """A source's link flags are part of its library's hash."""
    path = _build.library_path(name)
    assert path.name.startswith(f"{name}-")
    monkeypatch.setitem(_build.LINK_FLAGS, name, (*_build.LINK_FLAGS.get(name, ()), "-lm"))
    assert _build.library_path(name) != path
