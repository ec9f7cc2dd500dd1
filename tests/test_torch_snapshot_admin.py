"""``tools/snapshot_admin.py`` (run as it is, in its own process) on a
snapshot root that the port wrote: a decoded snapshot from
``core.ingest.stream_batches`` and a featurized one from RandomPatchCifar's
streamed test split, beside crash debris and a directory with a broken
manifest.  ``list`` reports what the port's own ``list_snapshots`` reads,
``inspect`` validates every shard and finds a flipped byte, ``evict
--temps`` / ``--invalid`` remove only the debris, and ``evict --stale
--tar`` keeps the live snapshot and removes it once the tar changes.  The
port's stream reads what survives.

Both packages' keys fold in whether the native decoder is built, so both
run with ``KEYSTONE_NATIVE_DECODE=0`` (PIL decode)."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from keystone_tpu_torch.core import ingest
from keystone_tpu_torch.core import snapshot as ksnap
from keystone_tpu_torch.loaders import native_decode
from keystone_tpu_torch.workloads import cifar_random_patch as pc
from test_stream_workloads import _write_cifar_tar
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
CIFAR = dict(num_filters=4, patch_steps=6, lam=10.0, whitener_size=64, featurize_chunk=4,
             num_classes=4, device="cpu")


def _admin(*args) -> tuple[int, dict]:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    env["KEYSTONE_NATIVE_DECODE"] = "0"
    out = subprocess.run([sys.executable, str(ROOT / "tools" / "snapshot_admin.py"), *args],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    return out.returncode, json.loads(out.stdout.splitlines()[0])


def _stream(tar: str, root: str) -> dict:
    with ingest.stream_batches(tar, 4, config=ingest.StreamConfig(snapshot_dir=root),
                               device="cpu") as st:
        list(st)
    assert st.join(10.0)
    return st.stats.record()


@pytest.fixture(autouse=True)
def pil_decode(monkeypatch):
    monkeypatch.setenv("KEYSTONE_NATIVE_DECODE", "0")
    native_decode.reset()
    yield
    monkeypatch.undo()
    native_decode.reset()


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """A Cifar-shaped tar of 10 images and the port's snapshot root over it:
    one decoded and one featurized snapshot."""
    d = tmp_path_factory.mktemp("snap_admin")
    tar, root = str(d / "cifar48.tar"), str(d / "root")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KEYSTONE_NATIVE_DECODE", "0")
        native_decode.reset()
        _write_cifar_tar(tar, 10, np.random.default_rng(13))
        assert _stream(tar, root)["snapshot_chunks_written"] == 3
        mp.setenv("KEYSTONE_SNAPSHOT_MODE", "featurized")
        train = pc.cifar_tar_loader(tar)
        pc.run(pc.RandomCifarConfig(**CIFAR, stream_test_tar=tar, snapshot_dir=root),
               train, train)
    native_decode.reset()
    return tar, root


@pytest.fixture
def root(written, tmp_path):
    """A copy of the written root with crash debris and a broken manifest."""
    tar, src = written
    dst = str(tmp_path / "root")
    shutil.copytree(src, dst)
    os.makedirs(os.path.join(dst, ".tmp-crashed"))
    Path(dst, ".tmp-crashed", "chunk_00000.npz").write_bytes(b"partial")
    os.makedirs(os.path.join(dst, "snap-0123456789abcdef"))
    Path(dst, "snap-0123456789abcdef", "manifest.json").write_text("{not json")
    return dst


def _by_mode(root: str) -> dict:
    return {s["mode"]: s for s in ksnap.list_snapshots(root) if s.get("committed")}


def test_list_reads_what_the_port_reads(root):
    rc, rec = _admin(root, "list")
    assert rc == 0 and rec["op"] == "list"
    port = {s["dir"]: s for s in ksnap.list_snapshots(root)}
    tool = {s["dir"]: s for s in rec["snapshots"]}
    assert set(tool) == set(port) and len(tool) == 4
    for name, s in port.items():
        for key in ("committed", "bytes", "key", "mode", "images", "chunks"):
            assert tool[name].get(key) == s.get(key), (name, key)
    modes = _by_mode(root)
    assert set(modes) == {"decoded", "featurized"}
    assert (modes["decoded"]["images"], modes["decoded"]["chunks"]) == (10, 3)
    assert rec["total_bytes"] == sum(s.get("bytes", 0) for s in port.values())


@pytest.mark.parametrize("mode", ["decoded", "featurized"])
def test_inspect_validates_and_finds_a_flipped_byte(root, mode):
    snap = _by_mode(root)[mode]
    rc, rec = _admin(root, "inspect", snap["key"][:12])
    assert rc == 0 and rec["ok"] and rec["problems"] == []
    shard = sorted(Path(root, snap["dir"]).glob("chunk_*"))[1]
    data = bytearray(shard.read_bytes())
    data[len(data) // 2] ^= 0x01
    shard.write_bytes(bytes(data))
    rc, rec = _admin(root, "inspect", snap["key"][:12])
    assert rc == 1 and not rec["ok"] and rec["problems"]
    assert ksnap.validate(root, snap["key"])


def test_evict_temps_and_invalid_remove_only_the_debris(written, root):
    tar, _ = written
    rc, rec = _admin(root, "evict", "--temps")
    assert rc == 0 and [os.path.basename(p) for p in rec["removed"]] == [".tmp-crashed"]
    rc, rec = _admin(root, "evict", "--invalid")
    assert rc == 0 and [os.path.basename(p) for p in rec["removed"]] == [
        "snap-0123456789abcdef"]
    assert sorted(os.listdir(root)) == sorted(s["dir"] for s in _by_mode(root).values())
    stats = _stream(tar, root)  # the port reads the surviving snapshot
    assert stats["snapshot_chunks_read"] == 3 and stats["decoded"] == 10


def test_evict_stale_keeps_the_live_snapshot_until_the_tar_changes(written, root, tmp_path):
    """A tar's identity is its name, size and mtime: a copy that keeps them
    is the live tar, a touched one is not."""
    tar = str(tmp_path / "cifar48.tar")
    shutil.copy2(written[0], tar)
    rc, rec = _admin(root, "evict", "--stale", "--tar", tar)
    assert rc == 0 and rec["removed"] == []
    decoded = _by_mode(root)["decoded"]
    st = os.stat(tar)
    os.utime(tar, ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
    rc, rec = _admin(root, "evict", "--stale", "--tar", tar)
    assert rc == 0 and [os.path.basename(p) for p in rec["removed"]] == [decoded["dir"]]
    assert set(_by_mode(root)) == {"featurized"}  # featurized keys are never "stale"
