"""The port's snapshot cache (``keystone_tpu_torch.core.snapshot`` and its
ingest and ``fv_common`` integrations), case for case against
``tests/test_snapshot.py`` (its ``snapshot_admin`` cases aside: the tool is
not ported), plus the two packages against each other: the same key for the
same tar and settings, and each package's stream serving the other's
decoded and device-format snapshots.

Tolerance: exact everywhere (``np.array_equal``): a snapshot changes where
the bytes come from, never the bytes."""

import glob
import json
import os

import numpy as np
import pytest
import torch

import faults
from keystone_tpu.core import ingest as jingest
from keystone_tpu.core import snapshot as jsnap
from keystone_tpu_torch.core import ingest
from keystone_tpu_torch.core import snapshot as ksnap
from keystone_tpu_torch.core.resilience import counters
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401


@pytest.fixture
def tar10(tmp_path, rng):
    path = str(tmp_path / "snap.tar")
    names = faults.make_image_tar(path, 10, rng)
    return path, names


def _collect(st):
    out = [(b.index, b.indices.copy(), list(b.names), np.array(b.host)) for b in st]
    assert st.join(10.0)
    return out


def _stream(path, batch, snapshot_dir=None, **kw):
    cfg = ingest.StreamConfig.from_env(snapshot_dir=snapshot_dir, **kw)
    with ingest.stream_batches(path, batch, config=cfg, device="cpu") as st:
        out = _collect(st)
    return out, st


def _jax_stream(path, batch, snapshot_dir=None, **kw):
    cfg = jingest.StreamConfig.from_env(snapshot_dir=snapshot_dir, **kw)
    with jingest.stream_batches(path, batch, transfer=False, config=cfg) as st:
        out = _collect(st)
    return out, st


def _assert_streams_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x[0] == y[0]
        assert np.array_equal(x[1], y[1])
        assert x[2] == y[2]
        assert x[3].dtype == y[3].dtype
        assert np.array_equal(x[3], y[3])


def _shards(root):
    return sorted(glob.glob(os.path.join(root, "snap-*", "chunk_*.npz")))


def _truncate(shard):
    with open(shard, "rb") as fh:
        data = fh.read()
    with open(shard, "wb") as fh:
        fh.write(data[: len(data) // 2])


# -- keys ---------------------------------------------------------------------


def test_key_is_stable_and_moves_with_inputs(tar10):
    path, _ = tar10
    k = ksnap.snapshot_key(path, batch_size=4)
    assert k == ksnap.snapshot_key(path, batch_size=4)
    assert k != ksnap.snapshot_key(path, batch_size=8)
    assert k != ksnap.snapshot_key(path, batch_size=4, extra="voc:prefix")
    st = os.stat(path)
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 10_000_000))
    assert k != ksnap.snapshot_key(path, batch_size=4)


def test_featurized_key_requires_and_folds_in_digest(tar10):
    path, _ = tar10
    with pytest.raises(ValueError, match="featurizer"):
        ksnap.snapshot_key(path, batch_size=4, mode="featurized")
    ka = ksnap.snapshot_key(path, batch_size=4, mode="featurized", featurizer="digest-a")
    kb = ksnap.snapshot_key(path, batch_size=4, mode="featurized", featurizer="digest-b")
    assert ka != kb
    assert ka != ksnap.snapshot_key(path, batch_size=4)


def test_featurizer_digest_moves_with_weights():
    from keystone_tpu_torch.core.checkpoint import CheckpointError
    from keystone_tpu_torch.solvers.pca import BatchPCATransformer

    a = ksnap.featurizer_digest(BatchPCATransformer(torch.ones((4, 2))))
    b = ksnap.featurizer_digest(BatchPCATransformer(torch.full((4, 2), 2.0)))
    assert a != b
    assert a == ksnap.featurizer_digest(BatchPCATransformer(torch.ones((4, 2))))
    with pytest.raises(CheckpointError):
        ksnap.featurizer_digest(lambda x: x)


@pytest.mark.parametrize("mode", ["decoded", "device"])
@pytest.mark.parametrize("extra", [None, "voc:JPEGImages/:labels"])
@pytest.mark.parametrize("batch", [3, 4])
def test_key_equals_the_jax_key(tar10, mode, extra, batch):
    path, _ = tar10
    key = ksnap.snapshot_key(path, batch_size=batch, mode=mode, extra=extra)
    assert key == jsnap.snapshot_key(path, batch_size=batch, mode=mode, extra=extra)
    assert ksnap._dir_for("r", key) == jsnap._dir_for("r", key)


# -- decoded snapshots through the ingest stream ------------------------------


def test_cold_write_then_warm_read_bit_identical(tmp_path, tar10):
    path, _ = tar10
    root = str(tmp_path / "cache")
    cold, st_cold = _stream(path, 4, snapshot_dir=root)
    assert st_cold.stats.snapshot_chunks_written == len(cold)
    assert st_cold.stats.snapshot_chunks_read == 0
    assert st_cold.stats.decoder == "thread"
    committed = [s for s in ksnap.list_snapshots(root) if s["valid"]]
    assert len(committed) == 1 and committed[0]["images"] == 10
    assert committed[0]["batch_size"] == 4
    assert ksnap.validate(root, committed[0]["key"]) == []
    warm, st_warm = _stream(path, 4, snapshot_dir=root)
    assert st_warm.stats.snapshot_chunks_read == len(cold)
    assert st_warm.stats.decoder == ""  # nothing decoded
    _assert_streams_equal(cold, warm)


def test_stale_key_is_counted_and_rewritten(tmp_path, tar10):
    path, _ = tar10
    root = str(tmp_path / "cache")
    cold, _ = _stream(path, 4, snapshot_dir=root)
    st = os.stat(path)
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 10_000_000))
    before = counters.get("snapshot_stale")
    again, st2 = _stream(path, 4, snapshot_dir=root)
    assert counters.get("snapshot_stale") == before + 1
    assert st2.stats.snapshot_chunks_read == 0
    _assert_streams_equal(cold, again)
    keys = {s["key"] for s in ksnap.list_snapshots(root) if s["valid"]}
    assert ksnap.snapshot_key(path, batch_size=4) in keys


def test_corrupt_shard_counted_fallback_and_self_heal(tmp_path, tar10):
    path, _ = tar10
    root = str(tmp_path / "cache")
    cold, _ = _stream(path, 4, snapshot_dir=root)
    _truncate(_shards(root)[1])
    key = ksnap.snapshot_key(path, batch_size=4)
    assert ksnap.validate(root, key)  # the damage is visible to validate
    before = counters.get("snapshot_fallback")
    fb, st_fb = _stream(path, 4, snapshot_dir=root)
    assert counters.get("snapshot_fallback") == before + 1
    assert st_fb.stats.decoded == 10  # the prefix is not counted twice
    _assert_streams_equal(cold, fb)
    healed, st_h = _stream(path, 4, snapshot_dir=root)
    assert counters.get("snapshot_fallback") == before + 1
    assert st_h.stats.snapshot_chunks_read == len(cold)
    _assert_streams_equal(cold, healed)


def test_fallback_divergence_is_typed_never_scrambled(tmp_path, tar10, monkeypatch):
    """A counted skip that shifts the survivors between the snapshot pass
    and its live fallback kills the stream typed."""
    from keystone_tpu_torch.loaders import image_loaders

    path, names = tar10
    root = str(tmp_path / "cache")
    _stream(path, 4, snapshot_dir=root)
    _truncate(_shards(root)[1])
    target = dict(image_loaders._iter_tar_members(path))[names[0]]
    real = image_loaders.decode_image

    def flaky(data):
        return None if data == target else real(data)

    monkeypatch.setattr(image_loaders, "decode_image", flaky)
    before = counters.get("snapshot_fallback_divergence")
    cfg = ingest.StreamConfig.from_env(snapshot_dir=root)
    with pytest.raises(ingest.SnapshotFallbackDivergence):
        with ingest.stream_batches(path, 4, config=cfg, device="cpu") as st:
            for _ in st:
                pass
    assert counters.get("snapshot_fallback_divergence") == before + 1
    assert st.join(10.0)


def test_early_consumer_exit_commits_nothing(tmp_path, tar10):
    path, _ = tar10
    root = str(tmp_path / "cache")
    cfg = ingest.StreamConfig.from_env(snapshot_dir=root, ring_capacity=1)
    with ingest.stream_batches(path, 2, config=cfg, device="cpu") as st:
        next(iter(st))
    assert st.join(10.0)
    assert not [s for s in ksnap.list_snapshots(root) if s["valid"]]
    assert not [s for s in ksnap.list_snapshots(root) if s["dir"].startswith(".tmp-")]


def test_snapshot_write_failure_degrades_to_live(tmp_path, tar10, monkeypatch):
    path, names = tar10
    root = str(tmp_path / "cache")

    def boom(self, *a, **kw):
        raise OSError("disk full (injected)")

    monkeypatch.setattr(ksnap.SnapshotWriter, "add_chunk", boom)
    before = counters.get("snapshot_write_failed")
    got, st = _stream(path, 4, snapshot_dir=root)
    assert sum(len(c[2]) for c in got) == len(names)
    assert counters.get("snapshot_write_failed") == before + 1
    assert st.stats.snapshot_chunks_written == 0
    assert not [s for s in ksnap.list_snapshots(root) if s.get("valid")]


def test_unusable_snapshot_root_degrades_to_live(tmp_path, tar10):
    path, names = tar10
    blocker = tmp_path / "blocker"
    blocker.write_text("a file where a directory must go")
    before = counters.get("snapshot_write_failed")
    got, st = _stream(path, 4, snapshot_dir=str(blocker / "cache"))
    assert sum(len(c[2]) for c in got) == len(names)
    assert counters.get("snapshot_write_failed") == before + 1
    assert st.stats.snapshot_chunks_written == 0


def test_featurized_mode_degrades_to_decoded_where_unsupported(tmp_path, monkeypatch):
    from keystone_tpu_torch.workloads.fv_common import stream_config_from_flags

    monkeypatch.setenv("KEYSTONE_SNAPSHOT_MODE", "featurized")
    before = counters.get("snapshot_mode_unsupported")
    cfg = stream_config_from_flags(snapshot_dir=str(tmp_path / "c"))
    assert cfg.snapshot_mode == "decoded"
    assert counters.get("snapshot_mode_unsupported") == before + 1
    honored = stream_config_from_flags(snapshot_dir=str(tmp_path / "c"), supports_featurized=True)
    assert honored.snapshot_mode == "featurized"
    monkeypatch.delenv("KEYSTONE_SNAPSHOT_DIR", raising=False)
    assert stream_config_from_flags().snapshot_dir is None
    assert counters.get("snapshot_mode_unsupported") == before + 1


def test_keep_filter_without_extra_disables_snapshot(tmp_path, tar10):
    path, names = tar10
    root = str(tmp_path / "cache")
    cfg = ingest.StreamConfig.from_env(snapshot_dir=root)
    with ingest.stream_batches(path, 4, config=cfg, keep=lambda n: True, device="cpu") as st:
        got = list(st)
    assert st.join(10.0)
    assert sum(len(b) for b in got) == len(names)
    assert st.stats.snapshot_chunks_written == 0
    assert ksnap.list_snapshots(root) == []


def test_device_decode_with_decoded_snapshot_is_refused_counted(tmp_path, tar10):
    path, names = tar10
    root = str(tmp_path / "cache")
    before = counters.get("snapshot_mode_unsupported")
    got, st = _stream(path, 4, snapshot_dir=root, decode_mode="device")
    assert counters.get("snapshot_mode_unsupported") == before + 1
    assert st.stats.decoder == "device" and st.stats.snapshot_chunks_written == 0
    assert sum(len(c[2]) for c in got) == len(names)
    assert ksnap.list_snapshots(root) == []


def test_writer_abort_leaves_no_trace(tmp_path):
    root = str(tmp_path / "cache")
    w = ksnap.SnapshotWriter(root, "ab" * 32, mode="decoded")
    w.add_chunk(0, [0], ["x"], np.zeros((1, 4, 4, 3), np.float32))
    w.abort()
    assert ksnap.list_snapshots(root) == []


def test_stale_is_mode_scoped(tmp_path, tar10):
    path, _ = tar10
    root = str(tmp_path / "cache")
    w = ksnap.SnapshotWriter(
        root, ksnap.snapshot_key(path, batch_size=4, mode="featurized", featurizer="d"),
        mode="featurized", meta={"tar": ksnap.tar_identity(path)},
    )
    w.add_chunk(0, [0], ["x"], np.zeros((1, 2), np.float32))
    w.commit()
    snap, reason = ksnap.lookup(root, ksnap.snapshot_key(path, batch_size=4), tar_path=path)
    assert snap is None and reason == "miss"


def test_evict_rejects_sweeping_prefixes(tmp_path, tar10):
    path, _ = tar10
    root = str(tmp_path / "cache")
    _stream(path, 4, snapshot_dir=root)
    with pytest.raises(ValueError, match="prefix"):
        ksnap.evict(root, key_prefix="")
    with pytest.raises(ValueError, match="prefix"):
        ksnap.evict(root, key_prefix="ab")
    assert len(ksnap.list_snapshots(root)) == 1
    key = ksnap.snapshot_key(path, batch_size=4)
    before = counters.get("snapshot_evicted")
    assert ksnap.evict(root, key_prefix=key[:8]) == [f"snap-{key[:16]}"]
    assert counters.get("snapshot_evicted") == before + 1
    assert ksnap.list_snapshots(root) == []


# -- device-format snapshots --------------------------------------------------


def test_device_tier_pads_and_serves_host_decoded_pixels(tmp_path, tar10):
    """The cold pass of a device-decode stream decodes on the host (the
    writer stores host pixels) into f32 shards padded to a multiple of 8
    rows, never compressed; the warm pass serves them as they are."""
    path, _ = tar10
    root = str(tmp_path / "cache")
    host, _ = _stream(path, 4)
    cold, st_cold = _stream(path, 4, snapshot_dir=root, snapshot_mode="device",
                            decode_mode="device")
    assert st_cold.stats.decoder == "thread" and st_cold.stats.entropy_decoded == 0
    _assert_streams_equal(host, cold)
    [snap] = [s for s in ksnap.list_snapshots(root) if s["valid"]]
    snap_obj, _ = ksnap.lookup(root, snap["key"], mode="device")
    assert snap_obj.manifest["compress"] is False
    assert [c["shape"][0] for c in snap_obj.manifest["chunks"]] == [4, 4, 4]  # 2 -> 8 capped
    warm, st_warm = _stream(path, 4, snapshot_dir=root, snapshot_mode="device",
                            decode_mode="device")
    assert st_warm.stats.snapshot_chunks_read == 3 and st_warm.stats.entropy_decoded == 0
    assert st_warm.stats.snapshot_dma_bytes == sum(
        c["payload_bytes"] for c in snap_obj.manifest["chunks"])
    _assert_streams_equal(host, warm)


@pytest.mark.parametrize("pad_to,valid,rows", [(4, 2, 4), (64, 10, 16), (None, 3, 3),
                                               (8, 8, 8)])
def test_device_shard_padding(tmp_path, pad_to, valid, rows):
    root = str(tmp_path / "cache")
    w = ksnap.SnapshotWriter(root, "cd" * 32, mode="device")
    payload = np.arange(valid * 12, dtype=np.uint8).reshape(valid, 2, 2, 3)
    w.add_chunk(0, np.arange(valid), [f"m{i}" for i in range(valid)], payload, pad_to=pad_to)
    w.commit()
    snap, _ = ksnap.lookup(root, "cd" * 32)
    [(entry, arrays)] = list(snap.iter_chunks())
    assert arrays["payload"].dtype == np.float32 and arrays["payload"].shape[0] == rows
    assert int(arrays["valid"]) == valid and entry["images"] == valid
    assert np.array_equal(arrays["payload"][:valid], payload.astype(np.float32))
    assert not arrays["payload"][valid:].any()


# -- the two packages serve each other's snapshots ----------------------------


@pytest.mark.parametrize("mode", ["decoded", "device"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_snapshots_cross_packages(tmp_path, tar10, mode, writer):
    path, _ = tar10
    root = str(tmp_path / "cache")
    write, read = (_jax_stream, _stream) if writer == "jax" else (_stream, _jax_stream)
    cold, st_cold = write(path, 4, snapshot_dir=root, snapshot_mode=mode)
    assert st_cold.stats.snapshot_chunks_written == 3
    warm, st_warm = read(path, 4, snapshot_dir=root, snapshot_mode=mode)
    assert st_warm.stats.snapshot_chunks_read == 3
    assert st_warm.stats.snapshot_chunks_written == 0
    _assert_streams_equal(cold, warm)


# -- featurized snapshots (fv_common helper) ----------------------------------


def test_featurized_snapshot_serves_and_invalidates(tmp_path, tar10):
    from keystone_tpu_torch.workloads.fv_common import stream_features_snapshot

    path, names = tar10
    root = str(tmp_path / "cache")

    def per_batch(batch):
        return np.stack([batch.host.mean(axis=(1, 2, 3)), batch.host.max(axis=(1, 2, 3))],
                        axis=1).astype(np.float32)

    def key(digest):
        return ksnap.snapshot_key(path, batch_size=4, mode="featurized", featurizer=digest)

    def make_stream():
        return ingest.stream_batches(path, 4, config=ingest.StreamConfig.from_env(),
                                     device="cpu")

    live, live_names, st = stream_features_snapshot(
        make_stream, per_batch, root=root, key=key("model-v1"), tar_path=path)
    assert st.decoder == "thread" and st.snapshot_chunks_written == 3
    assert live_names == names
    snap_feats, snap_names, st2 = stream_features_snapshot(
        make_stream, per_batch, root=root, key=key("model-v1"), tar_path=path)
    assert st2.decoder == "" and st2.snapshot_chunks_read == 3 and st2.decoded == 10
    assert snap_names == live_names
    assert np.array_equal(snap_feats, live)
    stale_before = counters.get("snapshot_stale")
    refit, _, st3 = stream_features_snapshot(
        make_stream, per_batch, root=root, key=key("model-v2"), tar_path=path)
    assert st3.snapshot_chunks_read == 0
    assert counters.get("snapshot_stale") == stale_before + 1
    assert np.array_equal(refit, live)
    v1_dir = next(s["dir"] for s in ksnap.list_snapshots(root)
                  if s.get("valid") and s["key"] == key("model-v1"))
    shard = sorted(glob.glob(os.path.join(root, v1_dir, "chunk_*.npz")))[0]
    with open(shard, "r+b") as fh:
        data = bytearray(fh.read())
        data[len(data) // 2] ^= 0xFF
        fh.seek(0)
        fh.write(bytes(data))
    before = counters.get("snapshot_fallback")
    fb, _, st4 = stream_features_snapshot(make_stream, per_batch, root=root,
                                          key=key("model-v1"))
    assert counters.get("snapshot_fallback") >= before + 1
    assert st4.decoder == "thread" and np.array_equal(fb, live)


# -- write-path compression (KEYSTONE_SNAPSHOT_COMPRESS) ----------------------


def _write_snapshot(root, key, payloads, compress):
    w = ksnap.SnapshotWriter(root, key, mode="decoded", compress=compress)
    for i, p in enumerate(payloads):
        w.add_chunk(i, np.arange(p.shape[0]) + i * p.shape[0],
                    [f"img_{i}_{j}.jpg" for j in range(p.shape[0])], p)
    return w.commit()


def _read_payloads(root, key):
    snap, status = ksnap.lookup(root, key)
    assert status == "hit"
    return [arrs["payload"] for _entry, arrs in snap.iter_chunks()]


@pytest.mark.parametrize("integral", [True, False])
def test_compressed_shards_round_trip_bit_identical(tmp_path, rng, integral):
    """Integral f32 pixels are stored as uint8 (exact round trip) and
    deflated; other f32 payloads stay f32."""
    payloads = [rng.integers(0, 256, (4, 8, 8, 3)).astype(np.float32) for _ in range(3)]
    if not integral:
        payloads = [p + 0.5 for p in payloads]
    root = str(tmp_path / "zcache")
    _write_snapshot(root, "aa" * 32, payloads, compress=True)
    snap, _ = ksnap.lookup(root, "aa" * 32)
    assert snap.manifest["chunks"][0]["payload_bytes"] == (
        payloads[0].size if integral else payloads[0].nbytes)
    for want, have in zip(payloads, _read_payloads(root, "aa" * 32)):
        assert have.dtype == want.dtype
        assert np.array_equal(want, have)


def test_compressed_shards_are_smaller_on_compressible_payloads(tmp_path):
    payloads = [np.full((8, 16, 16, 3), 127, np.float32) for _ in range(2)]
    plain_root, comp_root = str(tmp_path / "plain"), str(tmp_path / "comp")
    _write_snapshot(plain_root, "bb" * 32, payloads, compress=False)
    _write_snapshot(comp_root, "cc" * 32, payloads, compress=True)

    def shard_bytes(root, key):
        snap, status = ksnap.lookup(root, key)
        assert status == "hit"
        return sum(c["bytes"] for c in snap.manifest["chunks"])

    assert shard_bytes(comp_root, "cc" * 32) < shard_bytes(plain_root, "bb" * 32) / 2
    snap, _ = ksnap.lookup(comp_root, "cc" * 32)
    assert snap.manifest["compress"] is True
    assert all(c["compressed"] for c in snap.manifest["chunks"])
    assert all(c["payload_bytes"] > 0 for c in snap.manifest["chunks"])


def test_old_uncompressed_shards_stay_readable(tmp_path, rng, monkeypatch):
    payloads = [rng.integers(0, 256, (4, 8, 8, 3)).astype(np.float32)]
    root = str(tmp_path / "old")
    _write_snapshot(root, "dd" * 32, payloads, compress=False)
    [snap_dir] = glob.glob(os.path.join(root, "snap-*"))
    mpath = os.path.join(snap_dir, ksnap.MANIFEST_NAME)
    with open(mpath) as fh:
        manifest = json.load(fh)
    manifest.pop("compress", None)
    manifest["chunks"] = [{k: v for k, v in c.items() if k not in ("compressed", "payload_bytes")}
                          for c in manifest["chunks"]]
    with open(mpath, "w") as fh:
        json.dump(manifest, fh)
    monkeypatch.setenv(ksnap.SNAPSHOT_COMPRESS_ENV, "1")
    assert np.array_equal(_read_payloads(root, "dd" * 32)[0], payloads[0])


def test_compress_env_knob(tmp_path, monkeypatch):
    monkeypatch.delenv(ksnap.SNAPSHOT_COMPRESS_ENV, raising=False)
    assert ksnap.snapshot_compress_env() is True
    monkeypatch.setenv(ksnap.SNAPSHOT_COMPRESS_ENV, "0")
    assert ksnap.snapshot_compress_env() is False
    w = ksnap.SnapshotWriter(str(tmp_path), "ee" * 32, mode="decoded")
    assert w._compress is False
    w.abort()
    assert ksnap.SnapshotWriter(str(tmp_path), "ff" * 32, mode="device", compress=True)._compress \
        is False  # device shards are never compressed


def test_env_knobs_validate(monkeypatch):
    monkeypatch.setenv(ksnap.SNAPSHOT_MODE_ENV, "pixels")
    with pytest.raises(ValueError, match="KEYSTONE_SNAPSHOT_MODE"):
        ksnap.snapshot_mode_env()
    monkeypatch.setenv(ksnap.SNAPSHOT_MODE_ENV, "device")
    assert ksnap.snapshot_mode_env() == "device"
    monkeypatch.setenv(ksnap.SNAPSHOT_DIR_ENV, "  ")
    assert ksnap.snapshot_dir_env() is None
