"""The port's streaming ingest (keystone_tpu_torch.core.ingest) on the CPU,
against the JAX package's ``core.ingest.stream_batches`` and the port's
eager loader.

Device mode: the same chunk sequence as the JAX stream (index, indices,
names, shape, geometry), equal int16 coefficient arrays and quant tables,
and the same counter names and counts.  A member outside the baseline
subset is decoded on the host on both sides, by PIL in the port and by
libjpeg (or PIL) in the JAX package: mean abs within 1 level, as
``test_torch_voc_sift_fisher.py`` holds the two loaders.  Host mode: pixel
chunks equal to the eager ``voc_loader`` exactly."""

import io
import tarfile

import numpy as np
import pytest
import torch

import faults
from keystone_tpu.core import ingest as jingest
from keystone_tpu.core.resilience import counters as jcounters
from keystone_tpu_torch.core import ingest
from keystone_tpu_torch.core.resilience import counters as pcounters
from keystone_tpu_torch.loaders import image_loaders as ploaders
from keystone_tpu_torch.ops import jpeg_device as jd
from keystone_tpu_torch.workloads import fv_common as pfv
from test_fisher_pipelines import write_voc_tar
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401

EVENTS = ("jpeg_corrupt_entropy", "device_decode_fallback", "corrupt_image")


def _jpeg(arr, **kw) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def _make_tar(path, members):
    with tarfile.open(path, "w") as tf:
        for name, data in members:
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))


@pytest.fixture(scope="module")
def mixed_tar(tmp_path_factory):
    """Two geometries with batch-size remainders, a progressive member, a
    truncated scan and a 30-px image, interleaved."""
    rng = np.random.default_rng(0)

    def img(h, w):
        return rng.integers(0, 256, (h, w, 3)).astype(np.uint8)

    a = [_jpeg(img(48, 48), quality=90, subsampling=2) for _ in range(7)]
    b = [_jpeg(img(40, 56), quality=85, subsampling=0) for _ in range(3)]
    members = [
        ("a0.jpg", a[0]), ("b0.jpg", b[0]), ("a1.jpg", a[1]),
        ("prog.jpg", _jpeg(img(48, 48), quality=90, progressive=True)),
        ("a2.jpg", a[2]), ("trunc.jpg", faults.corrupt_jpeg_entropy(a[6], "truncate")),
        ("a3.jpg", a[3]), ("b1.jpg", b[1]), ("tiny.jpg", _jpeg(img(30, 40), quality=90)),
        ("a4.jpg", a[4]), ("a5.jpg", a[5]), ("b2.jpg", b[2]),
    ]
    path = str(tmp_path_factory.mktemp("ingest") / "mixed.tar")
    _make_tar(path, members)
    return path


def _event_delta(before: dict, after: dict) -> dict:
    return {k: after.get(k, 0) - before.get(k, 0) for k in after
            if k.startswith(EVENTS) and after.get(k, 0) != before.get(k, 0)}


def test_device_stream_matches_jax(mixed_tar):
    before = jcounters.snapshot()
    cfg = jingest.StreamConfig.from_env(decode_mode="device", snapshot_dir="")
    with jingest.stream_batches(mixed_tar, 4, config=cfg, transfer=False) as st:
        ref = list(st)
    assert st.join(10.0)
    ref_stats = st.stats
    ref_events = _event_delta(before, jcounters.snapshot())

    port_before = pcounters.snapshot()
    config = ingest.StreamConfig(decode_mode="device")
    with ingest.stream_batches(mixed_tar, 4, config=config, device="cpu") as st:
        got = list(st)
    assert st.join(10.0)
    assert _event_delta(port_before, pcounters.snapshot()) == ref_events == {
        "jpeg_corrupt_entropy": 1, "device_decode_fallback": 1,
        "device_decode_fallback_progressive": 1, "corrupt_image": 1,
    }
    for field in ("decoded", "skipped", "batches", "entropy_decoded", "entropy_corrupt",
                  "device_fallbacks", "coeff_bytes"):
        assert getattr(st.stats, field) == getattr(ref_stats, field), field
    assert (st.stats.entropy_decoded, st.stats.skipped) == (9, 2)

    assert len(got) == len(ref) == 4  # one full chunk, three tails
    for g, r in zip(got, ref):
        assert (g.index, g.names, g.shape, len(g)) == (r.index, r.names, r.shape, len(r))
        np.testing.assert_array_equal(g.indices, r.indices)
        assert (g.coeff is None) == (r.coeff is None)
        if g.coeff is None:  # the progressive member, decoded on the host
            assert np.abs(g.host - r.host).mean() <= 1.0
            continue
        gg, rg = g.coeff.geom, r.coeff.geom
        assert (gg.height, gg.width, gg.sampling, gg.block_shape) == (
            rg.height, rg.width, rg.sampling, rg.block_shape)
        for a, b in zip(g.coeff.coeffs, r.coeff.coeffs):
            assert a.dtype == np.int16 and np.array_equal(a, b)
        np.testing.assert_array_equal(g.coeff.qt, r.coeff.qt)


def test_device_chunk_decodes_like_single_images(mixed_tar):
    with ingest.stream_batches(mixed_tar, 4, config=ingest.StreamConfig(decode_mode="device"),
                               device="cpu") as st:
        chunk = next(b for b in st if b.coeff is not None)
    pixels = chunk.dev()
    assert pixels.shape == (len(chunk), *chunk.shape, 3)
    for i in range(len(chunk)):
        one = [c[i : i + 1] for c in chunk.coeff.coeffs]
        single = jd.decode_batch(chunk.coeff.geom, one, chunk.coeff.qt[i : i + 1], "cpu")
        assert torch.equal(pixels[i], single[0])
    assert torch.equal(chunk.apply(lambda px: px.sum(dim=(1, 2, 3))), pixels.sum(dim=(1, 2, 3)))


@pytest.fixture(scope="module")
def voc_tar(tmp_path_factory):
    d = tmp_path_factory.mktemp("voc_ingest")
    labels = str(d / "labels.csv")
    open(labels, "w").close()
    write_voc_tar(str(d / "voc.tar"), labels, 11, np.random.default_rng(5))
    return str(d / "voc.tar"), labels


def test_host_stream_equals_eager_loader(voc_tar):
    tar, labels = voc_tar
    eager = ploaders.voc_loader(tar, labels)
    keep_names = set(ploaders.voc_labels_map(labels))
    with ingest.stream_batches(tar, 4, keep=keep_names.__contains__,
                               config=ingest.StreamConfig(decode_threads=3, decode_ahead=1),
                               device="cpu") as st:
        chunks = list(st)
    assert st.join(10.0)
    assert [len(c) for c in chunks] == [4, 4, 3]
    images = [None] * len(eager)
    names = [None] * len(eager)
    for c in chunks:
        for j, i in enumerate(c.indices):
            images[i], names[i] = c.host[j], c.names[j]
    assert names == eager.filenames
    for got, want in zip(images, eager.images):
        np.testing.assert_array_equal(got, want)

    def feats(px):
        return torch.stack([px.mean(dim=(1, 2, 3)), px.amax(dim=(1, 2, 3))], dim=1)

    with ingest.stream_batches(tar, 4, device="cpu") as st:
        streamed, stream_names = pfv.scatter_features_streaming(st, feats, 2)
    assert stream_names == eager.filenames
    np.testing.assert_array_equal(streamed, feats(torch.from_numpy(np.stack(eager.images))).numpy())


def test_producer_error_reraises_in_consumer(voc_tar, monkeypatch):
    real = ploaders._iter_tar_members

    def failing(path):
        for i, member in enumerate(real(path)):
            if i == 5:
                raise OSError("tar went away")
            yield member

    monkeypatch.setattr(ploaders, "_iter_tar_members", failing)
    with ingest.stream_batches(voc_tar[0], 2, device="cpu") as st:
        with pytest.raises(OSError, match="tar went away"):
            for _ in st:
                pass
    assert st.join(10.0)


def test_early_exit_stops_every_thread(voc_tar):
    with ingest.stream_batches(voc_tar[0], 1, config=ingest.StreamConfig(ring_capacity=1),
                               device="cpu") as st:
        first = next(iter(st))
    assert len(first) == 1
    assert st.join(10.0)


@pytest.mark.parametrize("bad", [dict(decode_threads=0), dict(decode_ahead=-1),
                                 dict(ring_capacity=0), dict(decode_mode="gpu")])
def test_stream_config_validates(bad):
    with pytest.raises(ValueError):
        ingest.StreamConfig(**bad)


def test_stream_config_defaults_match_jax():
    cfg = ingest.StreamConfig()
    assert cfg.decode_threads == ploaders.decode_threads() >= 1
    assert cfg.decode_ahead == ploaders.decode_ahead() == 8
    assert cfg.ring_capacity == jingest.DEFAULT_RING_CAPACITY
    assert cfg.window() == cfg.decode_threads + cfg.decode_ahead
    with pytest.raises(ValueError):
        ingest.stream_batches("unused.tar", 0)
