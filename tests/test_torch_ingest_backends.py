"""The port's ingest knobs and host decode backends
(``keystone_tpu_torch.core.ingest`` and ``core.decode_workers``), case for
case against ``tests/test_ingest.py``'s: the ``KEYSTONE_*`` environment
knobs and their validation, the process backend bit-identical to the thread
backend and to the JAX package's stream, no shared memory left after an
early exit, a corrupt member counted, a hung decoder tripping the deadline,
and a killed worker respawned.  The worker's entry module imports neither
torch nor jax.

Tolerance: exact (``np.array_equal``): a backend changes where the pixels
are decoded, never the pixels."""

import dataclasses
import glob
import io
import json
import os
import signal
import subprocess
import sys
import tarfile
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import faults
from keystone_tpu.core import ingest as jingest
from keystone_tpu_torch.core import ingest
from keystone_tpu_torch.core.resilience import DeadlineExceeded, counters, deadline
from keystone_tpu_torch.loaders import image_loaders, native_decode

ROOT = Path(__file__).resolve().parent.parent


def _make_tar(path, sizes, rng, corrupt=()):
    names = []
    with tarfile.open(path, "w") as tf:
        for i, (h, w) in enumerate(sizes):
            data = faults.make_jpeg_bytes(rng, h, w)
            if i in corrupt:
                data = faults.corrupt_jpeg(data, rng)
            info = tarfile.TarInfo(f"img_{i:04d}.jpg")
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
            names.append(info.name)
    return names


@pytest.fixture
def tar_uniform(tmp_path, rng):
    path = str(tmp_path / "uniform.tar")
    return path, _make_tar(path, [(48, 48)] * 10, rng)


@pytest.fixture
def tar_mixed(tmp_path, rng):
    path = str(tmp_path / "mixed.tar")
    return path, _make_tar(path, [(48, 48), (64, 40)] * 6, rng)


def _chunks(st):
    out = [(b.index, b.indices.copy(), list(b.names), np.array(b.host)) for b in st]
    return out


def _run(path, batch, **cfg):
    with ingest.stream_batches(path, batch, config=ingest.StreamConfig.from_env(**cfg),
                               device="cpu") as st:
        out = _chunks(st)
    assert st.join(20.0), "decode threads or worker processes leaked"
    return out, st


def _assert_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x[0] == y[0] and x[2] == y[2]
        assert np.array_equal(x[1], y[1])
        assert np.array_equal(x[3], y[3])


def _devshm():
    return set(glob.glob("/dev/shm/psm_*"))


# -- environment knobs ---------------------------------------------------------


@pytest.mark.parametrize("name,getter,good,bad", [
    ("KEYSTONE_DECODE_AHEAD", image_loaders.decode_ahead, ("3", 3), ("nope", "-1")),
    ("KEYSTONE_DECODE_THREADS", image_loaders.decode_threads, ("5", 5), ("x", "0")),
    ("KEYSTONE_RING_CAPACITY", ingest.ring_capacity, ("7", 7), ("1.5", "0")),
])
def test_int_env_knobs(monkeypatch, name, getter, good, bad):
    monkeypatch.setenv(name, good[0])
    assert getter() == good[1]
    for raw in bad:
        monkeypatch.setenv(name, raw)
        with pytest.raises(ValueError, match=name):
            getter()
    monkeypatch.setenv(name, "")
    default = {"KEYSTONE_DECODE_AHEAD": image_loaders._DECODE_AHEAD,
               "KEYSTONE_DECODE_THREADS": image_loaders.host_cores(),
               "KEYSTONE_RING_CAPACITY": ingest.DEFAULT_RING_CAPACITY}[name]
    assert getter() == default


def test_from_env_reads_every_knob(monkeypatch, tmp_path):
    env = {"KEYSTONE_DECODE_THREADS": "3", "KEYSTONE_DECODE_AHEAD": "2",
           "KEYSTONE_RING_CAPACITY": "5", "KEYSTONE_DECODE_BACKEND": "process",
           "KEYSTONE_DECODE_PROCS": "2", "KEYSTONE_DEVICE_DECODE": "1",
           "KEYSTONE_SNAPSHOT_DIR": str(tmp_path), "KEYSTONE_SNAPSHOT_MODE": "device"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cfg = ingest.StreamConfig.from_env()
    ref = jingest.StreamConfig.from_env()
    for field in ("decode_threads", "decode_ahead", "ring_capacity", "decode_backend",
                  "decode_procs", "decode_mode", "snapshot_dir", "snapshot_mode"):
        assert getattr(cfg, field) == getattr(ref, field), field
    assert (cfg.decode_threads, cfg.decode_procs, cfg.window()) == (3, 2, 5)
    # keywords that are not None override the environment
    assert ingest.StreamConfig.from_env(decode_backend="thread", snapshot_dir=None) \
        .decode_backend == "thread"


def test_decode_backend_env_and_validation(monkeypatch):
    monkeypatch.setenv("KEYSTONE_DECODE_BACKEND", "process")
    assert ingest.StreamConfig.from_env().decode_backend == "process"
    monkeypatch.setenv("KEYSTONE_DECODE_BACKEND", "gpu")
    with pytest.raises(ValueError, match="KEYSTONE_DECODE_BACKEND"):
        ingest.StreamConfig.from_env()
    with pytest.raises(ValueError, match="decode_backend"):
        ingest.StreamConfig(decode_threads=1, decode_ahead=0, ring_capacity=1,
                            decode_backend="gpu")
    assert ingest.StreamConfig(decode_threads=3, decode_ahead=0, ring_capacity=1).decode_procs == 3
    monkeypatch.setenv("KEYSTONE_DECODE_BACKEND", "thread")
    monkeypatch.setenv("KEYSTONE_DECODE_PROCS", "0")
    assert ingest.StreamConfig.from_env(decode_threads=2).decode_procs == 2
    monkeypatch.setenv("KEYSTONE_DECODE_PROCS", "-1")
    with pytest.raises(ValueError, match="KEYSTONE_DECODE_PROCS"):
        ingest.StreamConfig.from_env()


@pytest.mark.parametrize("raw,mode", [("", "host"), ("0", "host"), ("host", "host"),
                                      ("1", "device"), ("device", "device"), ("maybe", None)])
def test_device_decode_env(monkeypatch, raw, mode):
    monkeypatch.setenv("KEYSTONE_DEVICE_DECODE", raw)
    if mode is None:
        with pytest.raises(ValueError, match="KEYSTONE_DEVICE_DECODE"):
            ingest.decode_mode_env()
    else:
        assert ingest.decode_mode_env() == mode == jingest.decode_mode_env()


def test_autotune_env_raises(monkeypatch):
    # KEYSTONE_AUTOTUNE seeds the autotuner; a bad interval raises, as in
    # the JAX package.
    monkeypatch.setenv("KEYSTONE_AUTOTUNE", "1")
    assert ingest.StreamConfig.from_env().autotune == jingest.StreamConfig.from_env().autotune
    monkeypatch.setenv("KEYSTONE_AUTOTUNE_INTERVAL", "0")
    with pytest.raises(ValueError, match="KEYSTONE_AUTOTUNE_INTERVAL"):
        ingest.StreamConfig.from_env()


@pytest.mark.parametrize("bad", [dict(decode_procs=-1), dict(snapshot_mode="pixels")])
def test_stream_config_validates_new_fields(bad):
    with pytest.raises(ValueError):
        ingest.StreamConfig(**bad)


def test_ring_stats_count_backpressure(tar_uniform):
    path, _ = tar_uniform
    with ingest.stream_batches(path, 1, config=ingest.StreamConfig(ring_capacity=1),
                               device="cpu") as st:
        for _ in st:
            time.sleep(0.02)  # a slow consumer: the producer waits on the ring
    assert st.join(10.0)
    assert st.stats.ring_capacity == 1 and st.stats.ring_max_depth == 1
    assert st.stats.producer_stalls >= 1
    assert st.stats.decoder == "thread"
    assert st.stats.host_decoder == ("native" if native_decode.available() else "pil")


# -- the process decode backend -------------------------------------------------


def test_process_backend_bit_identical_to_thread_and_jax(tar_mixed):
    path, names = tar_mixed
    thread, st_t = _run(path, 4)
    proc, st_p = _run(path, 4, decode_backend="process", decode_procs=2)
    cfg = jingest.StreamConfig.from_env(snapshot_dir="")
    with jingest.stream_batches(path, 4, transfer=False, config=cfg) as jst:
        ref = _chunks(jst)
    assert jst.join(10.0)
    assert st_p.stats.decoder == "process" and st_t.stats.decoder == "thread"
    assert st_p.stats.decode_seconds > 0
    _assert_equal(thread, proc)
    _assert_equal(ref, proc)
    assert sorted(n for c in proc for n in c[2]) == sorted(names)


def test_process_backend_early_exit_leaks_no_shm(tar_uniform):
    path, _ = tar_uniform
    before = _devshm()
    cfg = ingest.StreamConfig.from_env(decode_backend="process", decode_procs=2, ring_capacity=1)
    st = ingest.stream_batches(path, 2, config=cfg, device="cpu")
    next(iter(st))
    st.close()
    assert st.join(20.0), "decode worker processes leaked"
    assert st._proc_pool is not None and st._proc_pool._live_shm == {}
    # Other test processes may hold blocks for a moment: wait them out.
    for _ in range(200):
        leaked = _devshm() - before
        if not leaked:
            break
        time.sleep(0.05)
    assert not leaked, f"leaked /dev/shm segments: {leaked}"


def test_process_backend_corrupt_member_counted_skip(tmp_path, rng):
    path = str(tmp_path / "bad.tar")
    names = _make_tar(path, [(48, 48)] * 6, rng, corrupt=(2,))
    before = counters.get("corrupt_image")
    got, st = _run(path, 3, decode_backend="process", decode_procs=2)
    assert counters.get("corrupt_image") == before + 1
    assert [n for c in got for n in c[2]] == [n for i, n in enumerate(names) if i != 2]
    assert st.stats.skipped == 1


def test_hung_thread_decoder_trips_deadline(tar_uniform, monkeypatch):
    path, _ = tar_uniform
    real = image_loaders.decode_image
    calls = {"n": 0}

    def hanging(data):
        calls["n"] += 1
        if calls["n"] == 3:
            time.sleep(2.5)
        return real(data)

    monkeypatch.setattr(image_loaders, "decode_image", hanging)
    st = ingest.stream_batches(path, 4, config=ingest.StreamConfig(decode_threads=2),
                               device="cpu")
    with pytest.raises(DeadlineExceeded):
        with deadline(0.6, phase="ingest"):
            for _batch in st:
                pass
    st.close()
    assert st.join(5.0)


def test_hung_worker_process_trips_deadline(tar_uniform):
    """A stopped worker never answers: the consumer's deadline fires typed,
    and the stream's shutdown still reaps every worker."""
    path, _ = tar_uniform
    cfg = ingest.StreamConfig.from_env(decode_backend="process", decode_procs=1,
                                       decode_ahead=0, ring_capacity=1)
    st = ingest.stream_batches(path, 4, config=cfg, device="cpu")
    for _ in range(400):
        if st._proc_pool is not None and st._proc_pool.live_workers():
            break
        time.sleep(0.01)
    [worker] = st._proc_pool.live_workers()
    os.kill(worker.pid, signal.SIGSTOP)
    try:
        with pytest.raises(DeadlineExceeded):
            with deadline(1.5, phase="ingest"):
                for _batch in st:
                    pass
    finally:
        st.close()
        assert st.join(20.0)
    assert not worker.is_alive()


#: The killed-worker stream's own deadline: 16 small images take well
#: under a second, a respawn a few seconds on a loaded host.
KILLED_STREAM_DEADLINE_S = 60.0


def _stream_state(st, got: list) -> dict:
    """What a stuck stream is doing: the batches consumed, its stats and the
    decode pool's workers with their pending tasks."""
    pool = st._proc_pool
    return {
        "batches_consumed": len(got), "stats": dataclasses.asdict(st.stats),
        "pool": None if pool is None else {
            "down": pool._down, "inflight": len(pool._inflight),
            "workers": [{"pid": w.proc.pid, "alive": w.proc.is_alive(),
                         "exitcode": w.proc.exitcode, "pending": len(w.pending)}
                        for w in pool._workers]},
    }


def test_killed_worker_is_respawned(tmp_path, rng):
    path = str(tmp_path / "kill.tar")
    _make_tar(path, [(48, 48)] * 16, rng)
    clean, _ = _run(path, 4)
    before = counters.get("decode_worker_respawn")
    cfg = ingest.StreamConfig.from_env(decode_threads=2, decode_ahead=2, ring_capacity=1,
                                       decode_backend="process", decode_procs=2)
    killed: list = []
    got: list = []
    errors: list = []
    st = ingest.stream_batches(path, 4, config=cfg, device="cpu")

    def consume():
        try:
            for b in st:
                if not killed:
                    pid = st._proc_pool.live_workers()[0].pid
                    os.kill(pid, signal.SIGKILL)
                    killed.append(pid)
                got.append((b.index, b.indices.copy(), list(b.names), np.array(b.host)))
        except BaseException as e:  # noqa: BLE001 — raised below
            errors.append(e)

    # The stream is consumed on a thread with a bounded join, so a stuck
    # stream fails this test, named, instead of holding its worker.
    consumer = threading.Thread(target=consume, name="killed-worker-consumer", daemon=True)
    consumer.start()
    consumer.join(KILLED_STREAM_DEADLINE_S)
    if consumer.is_alive():
        state = _stream_state(st, got)
        st.close()
        pytest.fail(f"the stream did not finish within {KILLED_STREAM_DEADLINE_S} s after "
                    f"decode worker {killed} was killed: {state}")
    st.close()
    if errors:
        raise errors[0]
    assert st.join(20.0)
    assert killed and counters.get("decode_worker_respawn") - before >= 1
    assert st.stats.worker_respawns >= 1
    _assert_equal(clean, got)


def test_worker_entry_module_imports_neither_torch_nor_jax(tar_uniform):
    """In a fresh interpreter that imports no torch: the worker's entry
    module loads without torch or jax, and a process pool decodes a member
    equal to the in-process decode."""
    path, _ = tar_uniform
    code = f"""
import json, sys, tarfile
import keystone_tpu_torch.core.decode_workers as dw
before = sorted(sys.modules)
from keystone_tpu_torch.loaders import image_loaders, native_decode
with tarfile.open({path!r}) as tf:
    m = tf.getmembers()[0]
    data = tf.extractfile(m).read()
pool = dw.ProcessDecodePool(1)
img, secs = pool.submit(m.name, data).result(60.0)
same = bool((img.arr == image_loaders.decode_image(data)).all())
img.release()
pool.shutdown(True)
print(json.dumps({{"modules": before, "after": sorted(sys.modules), "same": same,
                   "joined": pool.joined()}}))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    for mods in (rec["modules"], rec["after"]):
        assert "keystone_tpu_torch.core.decode_workers" in rec["modules"]
        assert not [m for m in mods if m == "torch" or m.startswith("torch.")]
        assert not [m for m in mods if m == "jax" or m == "keystone_tpu"
                    or m.startswith(("jax.", "keystone_tpu."))]
    assert rec["same"] and rec["joined"]


# -- the copy to the card --------------------------------------------------------


def test_cpu_stream_uses_arrays_in_place(tar_uniform):
    path, _ = tar_uniform
    with ingest.stream_batches(path, 4, device="cpu") as st:
        assert st._copier is None
        for b in st:
            assert b.staged is None
            assert b.dev().data_ptr() == torch.from_numpy(b.host).data_ptr()
    assert st.stats.h2d_bytes == 0


def test_unstaged_chunk_never_takes_a_blocking_copy():
    """A chunk reaches a card only through its stream's pinned copy."""
    batch = ingest.StreamBatch(index=0, indices=np.arange(1), names=["a"],
                               host=np.zeros((1, 8, 8, 3), np.float32),
                               device=torch.device("cuda"))
    with pytest.raises(RuntimeError, match="pinned"):
        batch.dev()
