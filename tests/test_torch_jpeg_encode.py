"""The numpy baseline JPEG encoder (keystone_tpu_torch.testing.jpeg_encode):
its files decode with PIL and with the JAX package's ``entropy_decode``,
its coefficients round-trip exactly through the port's entropy pass on
both backends, and its DQT and DHT segments are byte for byte PIL's.

Tolerances: coefficients exactly; PIL's pixels against the port's decode of
the same file within the golden bounds (8 max, 1 mean), the two decoders
rounding their IDCTs otherwise."""

import io

import numpy as np
import pytest

from keystone_tpu.ops import jpeg_device as jjd
from keystone_tpu_torch.ops import jpeg_device as jd
from keystone_tpu_torch.testing.jpeg_encode import encode_jpeg, quant_tables

CASES = [
    ("4:2:0", 0, (48, 64)), ("4:2:2", 0, (40, 56)), ("4:4:4", 0, (47, 53)),
    ("4:2:0", 2, (47, 53)), ("4:4:4", 3, (40, 48)), ("gray", 0, (40, 44)), ("gray", 5, (41, 45)),
]
BACKENDS = ["python", pytest.param("native", marks=pytest.mark.native_entropy)]


def _image(shape, gray: bool):
    rng = np.random.default_rng(sum(shape))
    yy, xx = np.mgrid[0 : shape[0], 0 : shape[1]]
    base = 120 + 60 * np.sin(xx / 5.0) * np.cos(yy / 7.0)
    if gray:
        return np.clip(base + rng.normal(0, 20, shape), 0, 255)
    img = base[..., None] + np.array([30.0, -20.0, 10.0]) + rng.normal(0, 20, (*shape, 3))
    return np.clip(img, 0, 255)


def _segments(data: bytes, markers=(0xDB, 0xC4)) -> list[bytes]:
    out, i = [], 2
    while data[i + 1] != 0xDA:
        length = (data[i + 2] << 8) | data[i + 3]
        if data[i + 1] in markers:
            out.append(data[i : i + 2 + length])
        i += 2 + length
    return out


@pytest.mark.parametrize("subsampling,restart,shape", CASES)
def test_encoder_files_decode_with_pil_and_jax(subsampling, restart, shape):
    from PIL import Image

    gray = subsampling == "gray"
    img = _image(shape, gray)
    data, coeffs = encode_jpeg(img, 90, "4:2:0" if gray else subsampling, restart)
    ref = jjd.entropy_decode(data, backend="python")
    assert len(ref.coeffs) == len(coeffs) == (1 if gray else 3)
    for a, b in zip(ref.coeffs, coeffs):
        assert np.array_equal(a, b)
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"), np.float32)[..., ::-1]
    ours = jd.decode_batch(ref.geom, *jjd.stack_coeff_images([ref]), "cpu")[0].numpy()
    diff = np.abs(pil - ours)
    assert diff.max() <= jd.GOLDEN_MAX_ABS and diff.mean() <= jd.GOLDEN_MEAN_ABS
    # the encoder's pixels are what was asked for, up to quantisation
    src = np.stack([img] * 3, -1) if gray else img
    assert np.abs(ours - src).mean() < 20.0


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("subsampling,restart,shape", CASES)
def test_coefficients_round_trip_through_the_port(subsampling, restart, shape, backend):
    gray = subsampling == "gray"
    data, coeffs = encode_jpeg(_image(shape, gray), 85, "4:2:0" if gray else subsampling,
                               restart)
    got = jd.entropy_decode(data, backend=backend)
    assert (got.geom.height, got.geom.width) == shape
    assert tuple(c.shape for c in coeffs) == got.geom.coeff_shapes()
    for a, b in zip(got.coeffs, coeffs):
        assert a.dtype == b.dtype == np.int16 and np.array_equal(a, b)


@pytest.mark.parametrize("quality", [50, 75, 90])
def test_tables_are_pils(quality):
    from PIL import Image

    img = _image((32, 48), gray=False)
    buf = io.BytesIO()
    Image.fromarray(img.astype(np.uint8)[..., ::-1]).save(
        buf, format="JPEG", quality=quality, subsampling=2)
    ours, _ = encode_jpeg(img, quality, "4:2:0")
    assert _segments(ours) == _segments(buf.getvalue())
    assert len(_segments(ours)) == 6  # two DQT, four DHT
    assert _segments(ours, (0xC0,)) == _segments(buf.getvalue(), (0xC0,))
    qts = quant_tables(quality)
    assert [q.dtype for q in qts] == [np.uint8, np.uint8]
