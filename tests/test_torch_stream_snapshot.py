"""The port's workloads with ``--snapshotDir`` and ``--decodeBackend``, on
the CPU: RandomPatchCifar's featurized and device-format snapshot tiers
through ``run`` (the counterpart of ``tests/test_stream_workloads.py``'s
featurized round trip), its streamed train split through the snapshot
cache, and VOCSIFTFisher and ImageNetSiftLcsFV streamed cold then warm,
each equal to its eager run.  The VOC and ImageNet snapshot keys are the
JAX workloads' keys for the same tar, label file and batch size.

Tolerance: exact (``np.array_equal``) between cold, warm and eager runs on
the same pixels, and between the port's and the JAX loaders' images."""

import dataclasses

import numpy as np
import pytest

from keystone_tpu.core import snapshot as jsnap
from keystone_tpu.workloads import cifar_random_patch as jc
from keystone_tpu_torch.core import snapshot as ksnap
from keystone_tpu_torch.core.resilience import counters
from keystone_tpu_torch.loaders import image_loaders as ploaders
from keystone_tpu_torch.loaders import native_decode
from keystone_tpu_torch.ops import jpeg_device as jd
from keystone_tpu_torch.ops import rect_pool as rp
from keystone_tpu_torch.workloads import cifar_random_patch as pc
from keystone_tpu_torch.workloads import imagenet_sift_lcs_fv as pinet
from keystone_tpu_torch.workloads import voc_sift_fisher as pvoc
from keystone_tpu_torch.workloads.fv_common import stream_config_from_flags
from test_fisher_pipelines import write_voc_tar
from test_stream_workloads import _write_cifar_tar
from test_torch_imagenet import SMALL_CONF, _write_split
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401

CIFAR = dict(num_filters=4, patch_steps=6, lam=10.0, whitener_size=64, featurize_chunk=4,
             num_classes=4, device="cpu")


@pytest.fixture(scope="module")
def cifar(tmp_path_factory):
    d = tmp_path_factory.mktemp("cifar_snap")
    tar = str(d / "cifar48.tar")
    _write_cifar_tar(tar, 10, np.random.default_rng(13))
    return tar, pc.cifar_tar_loader(tar)


def _featurized(root):
    return {s["key"] for s in ksnap.list_snapshots(root)
            if s.get("valid") and s["mode"] == "featurized"}


@pytest.mark.parametrize("device_decode", [False, True])
def test_cifar_featurized_snapshot_round_trip(cifar, tmp_path, monkeypatch, device_decode):
    """The first run tees the test split's conv features, keyed by the
    fitted featurizer's digest and the decode mode; a rerun serves them
    with no decode and no featurize and scores bit-identically; new filters
    miss the cache (a second key)."""
    tar, train = cifar
    monkeypatch.setenv("KEYSTONE_SNAPSHOT_MODE", "featurized")
    root = str(tmp_path / "cache")
    conf = pc.RandomCifarConfig(**CIFAR, stream_test_tar=tar, snapshot_dir=root,
                                device_decode=device_decode)
    cold = pc.run(conf, train, train)
    assert cold["ingest"]["snapshot_chunks_written"] == 3  # 10 images in chunks of 4
    assert cold["ingest"]["decoder"] == ("device" if device_decode else "thread")
    assert len(_featurized(root)) == 1
    warm = pc.run(conf, train, train)
    assert warm["ingest"]["snapshot_chunks_read"] == 3 and warm["ingest"]["decoder"] == ""
    np.testing.assert_array_equal(warm["test_predictions"], cold["test_predictions"])
    assert warm["test_filenames"] == cold["test_filenames"]
    plain = pc.run(dataclasses.replace(conf, snapshot_dir=None), train, train)
    np.testing.assert_array_equal(plain["test_predictions"], cold["test_predictions"])
    refit = pc.run(dataclasses.replace(conf, num_filters=6), train, train)
    assert refit["test_predictions"].shape[0] == len(train.labels)
    assert len(_featurized(root)) == 2


def test_cifar_featurized_corrupt_shard_falls_back(cifar, tmp_path, monkeypatch):
    tar, train = cifar
    monkeypatch.setenv("KEYSTONE_SNAPSHOT_MODE", "featurized")
    root = str(tmp_path / "cache")
    conf = pc.RandomCifarConfig(**CIFAR, stream_test_tar=tar, snapshot_dir=root)
    cold = pc.run(conf, train, train)
    [entry] = [s for s in ksnap.list_snapshots(root) if s.get("valid")]
    shard = tmp_path / "cache" / entry["dir"] / "chunk_00001.npz"
    data = bytearray(shard.read_bytes())
    data[len(data) // 2] ^= 0x01
    shard.write_bytes(bytes(data))
    before = counters.get("snapshot_fallback")
    again = pc.run(conf, train, train)
    assert counters.get("snapshot_fallback") == before + 1
    assert again["ingest"]["snapshot_chunks_written"] == 3  # rewritten
    np.testing.assert_array_equal(again["test_predictions"], cold["test_predictions"])
    assert not ksnap.validate(root, entry["key"])


def test_cifar_device_tier_cold_host_decode_warm_shards(cifar, tmp_path, monkeypatch):
    """Device decode with ``KEYSTONE_SNAPSHOT_MODE=device``: the cold pass
    decodes on the host and writes padded f32 shards, the warm pass copies
    them with no decode; predictions equal the host-decode run's."""
    tar, train = cifar
    monkeypatch.setenv("KEYSTONE_SNAPSHOT_MODE", "device")
    root = str(tmp_path / "cache")
    conf = pc.RandomCifarConfig(**CIFAR, stream_test_tar=tar, snapshot_dir=root,
                                device_decode=True)
    monkeypatch.setattr(jd, "decode_launches", 0)
    monkeypatch.setattr(rp, "fused_launches", 0)
    cold = pc.run(conf, train, train)
    warm = pc.run(conf, train, train)
    host = pc.run(dataclasses.replace(conf, snapshot_dir=None, device_decode=False), train, train)
    assert cold["ingest"]["decoder"] == "thread" and cold["ingest"]["entropy_decoded"] == 0
    assert warm["ingest"]["snapshot_chunks_read"] == 3 and warm["ingest"]["decoder"] == ""
    assert warm["ingest"]["snapshot_dma_bytes"] > 0
    assert (jd.decode_launches, rp.fused_launches) == (0, 0)  # the CPU runs plain versions
    for res in (cold, warm):
        np.testing.assert_array_equal(res["test_predictions"], host["test_predictions"])


def test_cifar_cli_process_backend_equals_thread(cifar, tmp_path):
    tar, _ = cifar
    flags = ["--trainLocation", tar, "--streamTestTar", tar, "--numFilters", "4",
             "--patchSteps", "6", "--whitenerSize", "64", "--lambda", "10", "--device", "cpu"]
    thread = pc.main(flags)
    proc = pc.main([*flags, "--decodeBackend", "process"])
    assert proc["ingest"]["decoder"] == "process" and thread["ingest"]["decoder"] == "thread"
    assert proc["ingest"]["host_decoder"] == ("native" if native_decode.available() else "pil")
    np.testing.assert_array_equal(proc["test_predictions"], thread["test_predictions"])
    assert proc["test_filenames"] == thread["test_filenames"]


def test_cifar_stream_loader_through_the_snapshot(cifar, tmp_path):
    """The streamed train split, cold and warm through the snapshot cache,
    equals the eager loader and the JAX package's streamed loader."""
    tar, eager = cifar
    snap = str(tmp_path / "snap")
    cold = pc.cifar_tar_stream_loader(tar, batch=4, config=stream_config_from_flags(
        snapshot_dir=snap))
    warm = pc.cifar_tar_stream_loader(tar, batch=4, config=stream_config_from_flags(
        snapshot_dir=snap, decode_backend="process"))
    ref = jc.cifar_tar_stream_loader(tar, batch=4)
    for got in (cold, warm):
        np.testing.assert_array_equal(got.images, eager.images)
        np.testing.assert_array_equal(got.labels, eager.labels)
        np.testing.assert_array_equal(got.images, ref.images)
    assert len([s for s in ksnap.list_snapshots(snap) if s["valid"]]) == 1


# -- VOCSIFTFisher and ImageNetSiftLcsFV ---------------------------------------

VOC_SMALL = ["--lambda", "0.05", "--descDim", "16", "--vocabSize", "8",
             "--numPcaSamples", "6000", "--numGmmSamples", "6000", "--scaleStep", "0"]


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    d = tmp_path_factory.mktemp("voc_snap")
    labels = str(d / "labels.csv")
    open(labels, "w").close()
    write_voc_tar(str(d / "voc.tar"), labels, 16, np.random.default_rng(3))
    return str(d / "voc.tar"), labels


def test_voc_snapshot_cold_warm_equal_eager(voc, tmp_path):
    tar, labels = voc
    root = str(tmp_path / "cache")
    base = ["--trainLocation", tar, "--testLocation", tar, "--labelPath", labels, *VOC_SMALL,
            "--device", "cpu"]
    eager = pvoc.main(base)
    stream = [*base, "--streamIngest", "--streamBatchSize", "5", "--snapshotDir", root]
    cold = pvoc.main(stream)
    assert cold["ingest"]["train"]["snapshot_chunks_written"] == 4  # 16 images: 5+5+5+1
    # the test split streams the same tar with the same filter: served
    assert cold["ingest"]["test"]["snapshot_chunks_read"] == 4
    warm = pvoc.main([*stream, "--decodeBackend", "process"])
    for split in ("train", "test"):
        assert warm["ingest"][split]["snapshot_chunks_read"] == 4
        assert warm["ingest"][split]["decoder"] == ""
    for res in (cold, warm):
        assert res["test_filenames"] == eager["test_filenames"]
        np.testing.assert_array_equal(res["test_scores"], eager["test_scores"])
    [snap] = [s for s in ksnap.list_snapshots(root) if s["valid"]]
    prefix = "VOCdevkit/VOC2007/JPEGImages/"
    assert snap["key"] == jsnap.snapshot_key(
        tar, batch_size=5, extra=f"voc:{prefix}:{jsnap.file_identity(labels)}")


def test_voc_device_decode_refuses_a_decoded_snapshot(voc, tmp_path):
    tar, labels = voc
    root = str(tmp_path / "cache")
    base = ["--trainLocation", tar, "--testLocation", tar, "--labelPath", labels, *VOC_SMALL,
            "--device", "cpu", "--streamIngest", "--streamBatchSize", "5", "--deviceDecode"]
    before = counters.get("snapshot_mode_unsupported")
    plain = pvoc.main(base)
    res = pvoc.main([*base, "--snapshotDir", root])
    assert counters.get("snapshot_mode_unsupported") == before + 2  # one per split
    assert ksnap.list_snapshots(root) == []
    assert res["map"] == plain["map"]
    np.testing.assert_array_equal(res["test_scores"], plain["test_scores"])


@pytest.fixture(scope="module")
def imagenet(tmp_path_factory):
    root = tmp_path_factory.mktemp("imagenet_snap")
    rng = np.random.default_rng(21)
    _write_split(root, "train", 3, rng)
    _write_split(root, "test", 1, rng)
    labels = root / "labels.txt"
    labels.write_text("".join(f"syn{c:03d} {c}\n" for c in range(6)))
    return str(root / "train"), str(root / "test"), str(labels)


def test_imagenet_snapshot_second_branch_and_rerun_read_shards(imagenet, tmp_path):
    train_dir, test_dir, labels = imagenet
    root = str(tmp_path / "cache")
    conf = pinet.ImageNetSiftLcsFVConfig(**SMALL_CONF, device="cpu")
    eager = pinet.run(conf, ploaders.imagenet_loader(train_dir, labels),
                      ploaders.imagenet_loader(test_dir, labels))

    def sources(**kw):
        return [pinet.imagenet_stream_source(p, labels, batch_size=4, snapshot_dir=root, **kw)
                for p in (train_dir, test_dir)]

    cold = pinet.run(conf, *sources())
    for split in ("train", "test"):
        first, second = cold["ingest"][split]
        assert first["snapshot_chunks_written"] > 0 and first["decoder"] == "thread"
        assert second["snapshot_chunks_read"] == first["snapshot_chunks_written"]
    warm = pinet.run(conf, *sources(decode_backend="process"))
    assert all(p["decoder"] == "" for split in ("train", "test") for p in warm["ingest"][split])
    for res in (cold, warm):
        assert res["test_filenames"] == eager["test_filenames"]
        np.testing.assert_array_equal(res["test_scores"], eager["test_scores"])
    keys = {s["key"] for s in ksnap.list_snapshots(root) if s["valid"]}
    extra = f"imagenet:{jsnap.file_identity(labels)}"
    assert keys == {jsnap.snapshot_key(p, batch_size=4, extra=extra)
                    for p in (train_dir, test_dir)}
