"""Multi-process fit + serve workload, the host-loss drill and the
fleet-observability drill (counterpart of keystone_tpu/workloads/multihost.py),
as one module with three faces.

* **Worker entries** (``python -m keystone_tpu_torch.workloads.multihost
  {fit-serve|serve-host} ... [--device cpu]``): ``fit-serve`` joins the
  process group (``parallel.distributed``, ``gloo``), streams ITS tar shards
  through ``core.ingest``, fits a scaler by deterministic rank-ordered moment
  aggregation, checkpoints it, reshards the checkpoint across processes onto
  the process-spanning mesh, and serves the fit host-locally; ``serve-host``
  is one fleet member — a host-local ``ShapeRouter`` behind a
  ``WireServer`` (which is also the member's obs endpoint), driven over
  stdin by the fleet controller (the host-loss re-anchor path).  Both run on
  the card unless ``--device cpu``.
* **Drivers** (:func:`run_two_process_fit_serve`,
  :func:`run_host_loss_drill`, :func:`run_obs_capture_drill`): spawn the
  workers as REAL subprocesses with auto-picked ports and judge the
  results.  The tests, the chaos ``host_loss`` and ``obs_capture``
  families and ``chip_smoke.py`` drive these three functions.

Bit-identity design: nothing numerical crosses processes through the
communicator.  Each process computes per-shard moment partials with the
same local program, partials are gathered (exact byte transport) and
summed on the host in fixed rank order — and the single-process reference
partitions the same shard list into the same per-rank groups and sums the
same partials in the same order.  Same values, same op, same order:
bit-identical by construction (``parallel.distributed.deterministic_allreduce``).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import glob
import io
import json
import os
import subprocess
import sys
import tarfile
import time

import numpy as np

FEAT_DIM = 8
_TEST_ROWS = 12
#: The directory that holds this checkout's package, put on a spawned
#: worker's PYTHONPATH.
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


# -- synthetic shard tars -----------------------------------------------------


def make_shard_tars(
    dirpath: str,
    shards: int,
    images_per_shard: int,
    seed: int = 0,
    h: int = 48,
    w: int = 48,
) -> list[str]:
    """Deterministic random-texture JPEG tar shards — the dataset every fit
    path (distributed and reference) reads.  One rng stream per member,
    keyed on (seed, shard, image), so the bytes do not depend on which
    process generates or reads them (the JAX package's bytes)."""
    from PIL import Image as PILImage

    os.makedirs(dirpath, exist_ok=True)
    paths = []
    for s in range(shards):
        path = os.path.join(dirpath, f"shard_{s:03d}.tar")
        with tarfile.open(path, "w") as tf:
            for i in range(images_per_shard):
                rng = np.random.default_rng((seed, s, i))
                arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                buf = io.BytesIO()
                PILImage.fromarray(arr).save(buf, format="JPEG", quality=90)
                data = buf.getvalue()
                info = tarfile.TarInfo(f"img_{s:03d}_{i:04d}.jpg")
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
        paths.append(path)
    return paths


# -- deterministic fit --------------------------------------------------------


def _feat_fn(x):
    """[b, H, W, C] pixel batch -> [b, 8] features: per-channel means and
    maxes plus whole-image mean/max.  Elementwise + per-image reductions
    only — one fixed program per batch shape in every process."""
    import torch

    return torch.cat(
        [
            x.mean(dim=(1, 2)),
            x.amax(dim=(1, 2)),
            x.mean(dim=(1, 2, 3))[:, None],
            x.amax(dim=(1, 2, 3))[:, None],
        ],
        dim=1,
    )


def moments_for_shards(shard_paths, batch: int = 4, device="cuda") -> np.ndarray:
    """One process's (or one emulated rank's) moment partial over its shard
    list, packed ``[sum(8), sumsq(8), count]`` float32.  Shards are streamed
    through ``core.ingest`` (pixels to ``device``) in sorted order and
    accumulated on the host in that order — the partial is a pure function
    of the shard list, independent of which process computes it."""
    from ..core import ingest
    from .fv_common import scatter_features_streaming

    s = np.zeros(FEAT_DIM, np.float32)
    sq = np.zeros(FEAT_DIM, np.float32)
    n = 0
    for tar in sorted(shard_paths):
        with ingest.stream_batches(tar, batch, device=device) as st:
            feats, _names = scatter_features_streaming(st, _feat_fn, FEAT_DIM)
        if not st.join(10.0):
            raise RuntimeError(f"{tar}: ingest threads did not exit")
        s += feats.sum(axis=0, dtype=np.float32)
        sq += (feats * feats).sum(axis=0, dtype=np.float32)
        n += feats.shape[0]
    return np.concatenate([s, sq, [np.float32(n)]]).astype(np.float32)


def fit_from_moments(packed: np.ndarray):
    """``(mean, std)`` float32 from the reduced moments — the
    ``StandardScaler`` math (sample variance, degenerate-std guard) in host
    numpy so every rank derives bitwise-identical parameters from the
    bitwise-identical reduced moments."""
    s = packed[:FEAT_DIM].astype(np.float32)
    sq = packed[FEAT_DIM : 2 * FEAT_DIM].astype(np.float32)
    n = np.float32(packed[-1])
    mean = (s / n).astype(np.float32)
    var = ((sq - n * mean * mean) / (n - np.float32(1.0))).astype(np.float32)
    with np.errstate(invalid="ignore"):
        std = np.sqrt(var).astype(np.float32)
    bad = ~np.isfinite(std) | (np.abs(std) < np.float32(1e-12))
    std = np.where(bad, np.float32(1.0), std).astype(np.float32)
    return mean, std


def test_rows(seed: int) -> np.ndarray:
    return np.asarray(
        np.random.default_rng((seed, 7)).normal(size=(_TEST_ROWS, FEAT_DIM)),
        np.float32,
    )


def _worker_device(device: str):
    """The worker's compute device (``cuda`` without a card raises), made
    the device of its mesh slots (``KEYSTONE_DIST_DEVICE``; one slot unless
    ``KEYSTONE_DIST_LOCAL_SLOTS`` says more)."""
    from ..parallel import distributed as kdist
    from ..utils.platform import resolve_device

    dev = resolve_device(device)
    os.environ[kdist.DEVICE_ENV] = device
    os.environ.setdefault(kdist.LOCAL_SLOTS_ENV, "1")
    return dev


def _scaler(mean, std, dev):
    import torch

    from ..ops.stats import StandardScalerModel

    return StandardScalerModel(torch.from_numpy(mean).to(dev), torch.from_numpy(std).to(dev))


def kernel_launches() -> dict:
    """This process's launches of the port's hand kernels, by kernel: the
    counts each wrapper keeps where it launches.  Every worker reports its
    own, and the function that spawns them sums what they launched."""
    from ..ops import fv_stats, jpeg_device, rect_pool

    return {"conv_rect_pool": rect_pool.fused_launches + rect_pool.launches,
            "fv_stats": fv_stats.launches, "decode_pixels": jpeg_device.decode_launches}


def sum_launches(per_process) -> dict:
    total: dict = {}
    for launches in per_process:
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
    return total


def _host_router(get_model, mesh, dev, buckets, label: str):
    """One serving host: a ``ShapeRouter`` over a ``MeshEngineFactory``
    anchored on ``mesh``, with the engine for the drill's rows, behind a
    ``WireServer`` on a free port (through a :class:`_RequestHold`, the
    server's ``target``).  Each engine is built from
    ``get_model()`` when it is built, so a re-anchor serves the state that
    was loaded last.  Returns ``(router, server)``."""
    from ..core import frontend as kfrontend
    from ..core import serve as kserve
    from ..core import wire as kwire

    def build(shape, dtype, mesh_or_none):
        return kserve.ServingEngine(
            get_model(),
            np.zeros(shape, dtype),
            config=kserve.ServeConfig(buckets=buckets, max_wait_ms=2.0),
            label=f"{label}:{'x'.join(str(d) for d in shape)}",
            mesh=mesh_or_none,
            device=dev,
        )

    factory = kfrontend.MeshEngineFactory(build, mesh=mesh)
    router = kfrontend.ShapeRouter(factory, label=label)
    router.add_engine(factory((FEAT_DIM,), np.float32))
    return router, kwire.WireServer(_RequestHold(router), port=0, label=label)


# -- worker: fit-serve --------------------------------------------------------


def fit_serve_main(argv) -> int:
    ap = argparse.ArgumentParser(prog="multihost fit-serve")
    ap.add_argument("--shards-dir", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument(
        "--emulate-world", type=int, default=None,
        help="single-process reference: partition shards into this many "
        "rank groups and sum their partials in rank order",
    )
    args = ap.parse_args(argv)

    import torch

    from ..core import autoshard
    from ..core import serve as kserve
    from ..core.checkpoint import load_pipeline, save_pipeline
    from ..core.ingest import host_shards
    from ..core.resilience import counters
    from ..ops.stats import StandardScalerModel
    from ..parallel import distributed as kdist
    from ..parallel import mesh as kmesh

    t_start = time.monotonic()
    dev = _worker_device(args.device)
    env_world = int(os.environ.get(kdist.PROCS_ENV, "1") or 1)
    if env_world > 1:
        st = kdist.init_process_group()
        world, rank = st.world, st.rank
    else:
        st, world, rank = None, 1, 0
    group = st is not None and st.process_group and world > 1
    record: dict = {"world": world, "rank": rank, "pid": os.getpid(),
                    "device": str(dev), "join_wall_s": round(time.monotonic() - t_start, 4)}

    shards = sorted(glob.glob(os.path.join(args.shards_dir, "*.tar")))
    if not shards:
        raise SystemExit(f"no tar shards under {args.shards_dir}")

    t0 = time.monotonic()
    if group:
        mine = host_shards(shards)
        partial = moments_for_shards(mine, args.batch, dev)
        record["ingest_wall_s"] = round(time.monotonic() - t0, 4)
        total = kdist.deterministic_allreduce(partial)
        record["my_shards"] = [os.path.basename(p) for p in mine]
        record["my_images"] = int(partial[-1])
    else:
        ew = max(1, args.emulate_world or 1)
        parts = [moments_for_shards(host_shards(shards, r, ew), args.batch, dev)
                 for r in range(ew)]
        record["ingest_wall_s"] = round(time.monotonic() - t0, 4)
        total = np.stack(parts, axis=0).sum(axis=0)
        record["emulated_world"] = ew
        record["my_images"] = int(total[-1])
    mean, std = fit_from_moments(total)
    record["fit_wall_s"] = round(time.monotonic() - t0, 4)
    record["n_images"] = int(total[-1])
    record["mean"] = mean.tolist()
    record["std"] = std.tolist()

    model = _scaler(mean, std, dev)
    rows = test_rows(args.seed)
    record["predictions"] = model(torch.from_numpy(rows).to(dev)).cpu().numpy().tolist()

    if args.ckpt:
        local = kmesh.host_local_mesh()
        if rank == 0:
            # Anchor the mean SHARDED so the manifest records a real
            # non-replicated spec the cross-process reshard must re-lower.
            anchored = StandardScalerModel(
                autoshard.spec_sharding("data@dim0", local, 1).place(model.mean), model.std)
            with kmesh.use_mesh(local):
                save_pipeline(args.ckpt, anchored)
        kdist.barrier("ckpt_saved")
        if group:
            gmesh = kmesh.make_mesh()  # every rank's slots: the spanning mesh
            record["global_mesh"] = kmesh.mesh_desc(gmesh)
            record["mesh_spans"] = kmesh.mesh_spans_processes(gmesh)
            before = counters.get("ckpt_reshard_crosshost")
            t1 = time.monotonic()
            resumed = load_pipeline(args.ckpt, mesh=gmesh)
            record["reshard_wall_s"] = round(time.monotonic() - t1, 4)
            record["crosshost_reshard"] = counters.get("ckpt_reshard_crosshost") - before
            # Every window held HERE must be exactly the fit's bytes — the
            # redistribution is verified without any cross-process compute.
            equal, windows = True, 0
            for leaf, want in ((resumed.mean, mean), (resumed.std, std)):
                for _slot, index, t in leaf.addressable_shards():
                    windows += 1
                    equal &= bool(np.array_equal(t.cpu().numpy(), want[index]))
            record["crosshost_bit_equal"] = bool(equal)
            record["crosshost_windows"] = windows
            kdist.barrier("resumed")

    # Serve host-locally (engines never span processes).
    t2 = time.monotonic()
    engine = kserve.ServingEngine(
        model,
        np.zeros(FEAT_DIM, np.float32),
        config=kserve.ServeConfig(buckets=(1, 2, 4), max_wait_ms=2.0),
        label=f"mh{rank}",
        mesh=kmesh.host_local_mesh(),
    )
    with kserve.Server(engine) as server:
        futures = [server.submit(r) for r in rows]
        served = np.stack([np.asarray(f.result(30.0)) for f in futures])
    record["served"] = served.tolist()
    record["serve_wall_s"] = round(time.monotonic() - t2, 4)
    record["parity_ok"] = bool(engine.parity_ok)

    if group:
        record["leaked_threads"] = kdist.shutdown_process_group()
    record["wall_s"] = round(time.monotonic() - t_start, 4)
    record["counters"] = counters.snapshot()
    record["kernel_launches"] = kernel_launches()
    with open(args.out, "w") as fh:
        json.dump(record, fh)
    return 0


# -- worker: serve-host -------------------------------------------------------


class _RequestHold:
    """A serving target that a host-loss drill can stall: after
    ``arm(k)`` it passes k more requests to ``target`` and then holds
    every later one unanswered until ``release()`` (or the SIGKILL the
    drill sends), counting them in ``held``."""

    def __init__(self, target):
        import threading

        self.target = target
        self.held = 0
        self._left: int | None = None
        self._lock = threading.Lock()
        self._released = threading.Event()

    def arm(self, k: int) -> None:
        with self._lock:
            self._left = k

    def release(self) -> None:
        self._released.set()

    def submit(self, arr):
        with self._lock:
            hold = self._left is not None and self._left <= 0
            if hold:
                self.held += 1
            elif self._left is not None:
                self._left -= 1
        if hold:
            self._released.wait()
        return self.target.submit(arr)


def serve_host_main(argv) -> int:
    ap = argparse.ArgumentParser(prog="multihost serve-host")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--buckets", default="1,2,4")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..core import trace
    from ..core.checkpoint import load_pipeline
    from ..core.resilience import counters
    from ..parallel import distributed as kdist
    from ..parallel import mesh as kmesh

    dev = _worker_device(args.device)
    st = kdist.init_process_group(use_torch=False)  # fleet membership only
    rank = st.rank
    buckets = tuple(int(b) for b in args.buckets.split(","))
    state: dict = {}

    def load_model():
        if args.ckpt:
            return load_pipeline(args.ckpt, mesh=kmesh.host_local_mesh())
        mean, std = _drill_params(args.seed)
        return _scaler(mean, std, dev)

    state["model"] = load_model()
    router, server = _host_router(lambda: state["model"], kmesh.host_local_mesh(), dev,
                                  buckets, f"host{rank}")
    hold = server.target
    print(json.dumps({"rank": rank, "port": server.port, "pid": os.getpid()}), flush=True)

    rc = 0
    try:
        for line in sys.stdin:
            parts = line.strip().split()
            if not parts:
                continue
            cmd = parts[0]
            if cmd == "quit":
                break
            if cmd == "peer_lost":
                # The controller (the front-end's liveness verdict) says
                # these ORIGINAL ranks survive: re-form the reduced group,
                # reload the checkpointed state onto this host, and hot-swap
                # every engine — zero request loss, counted.
                survivors = [int(p) for p in parts[1:]]
                t0 = time.monotonic()
                new = kdist.reform_group(survivors)
                state["model"] = load_model()
                info = router.reanchor(
                    kmesh.host_local_mesh(),
                    why=f"host loss (group epoch {new.epoch}, lost {list(new.lost)})",
                )
                wall = round(time.monotonic() - t0, 4)
                counters.record(
                    "host_reanchor",
                    f"host{rank}: survivors={survivors} world={new.world} wall={wall}s",
                )
                print(json.dumps({
                    "ack": "peer_lost",
                    "world": new.world,
                    "epoch": new.epoch,
                    "reanchor_wall_s": wall,
                    "swapped": len(info.get("swapped", [])),
                    "failed": len(info.get("failed", [])),
                }), flush=True)
            elif cmd == "hold_after":
                hold.arm(int(parts[1]))
                print(json.dumps({"holding": int(parts[1])}), flush=True)
            elif cmd == "stats":
                print(json.dumps({"stats": {"counters": counters.snapshot(),
                                            "kernel_launches": kernel_launches(),
                                            "held": hold.held}}), flush=True)
    except (BrokenPipeError, KeyboardInterrupt):  # the controller died
        rc = 1
    finally:
        hold.release()
        server.close()
        router.close()
        final = {"final": {"rank": rank, "counters": counters.snapshot(),
                           "kernel_launches": kernel_launches(),
                           "wire": dataclasses.asdict(server.stats)}}
        print(json.dumps(final), flush=True)
        if trace.enabled():
            trace.flush()
    return rc


# -- drivers ------------------------------------------------------------------


def _worker_cmd(mode: str, extra) -> list[str]:
    return [sys.executable, "-m", "keystone_tpu_torch.workloads.multihost", mode, *extra]


def _hermetic_env(env: dict, tmpdir: str, tag: str, *, trace_path=None) -> dict:
    """Spawned workers must not write the parent's trace or train the
    parent's plan log: each gets a plan log of its own, and this checkout
    on its import path."""
    from ..core.autoshard import PLAN_LOG_ENV

    env = dict(env)
    env[PLAN_LOG_ENV] = os.path.join(tmpdir, f"plan_{tag}.jsonl")
    env["PYTHONPATH"] = os.pathsep.join(p for p in (_ROOT, env.get("PYTHONPATH")) if p)
    if trace_path is None:
        env.pop("KEYSTONE_TRACE", None)
    else:
        env["KEYSTONE_TRACE"] = trace_path
    return env


def run_two_process_fit_serve(
    tmpdir: str,
    *,
    shards_per_host: int = 2,
    images_per_shard: int = 6,
    seed: int = 0,
    local_devices: int = 2,
    device: str = "cuda",
    timeout_s: float = 300.0,
) -> dict:
    """The acceptance run: a REAL 2-process ``gloo`` fit+serve on
    ``device`` (auto-picked coordinator port, per-process tar shards,
    cross-process checkpoint reshard) against the single-process reference
    on the same data — judged bit-identical.  Returns the judged record;
    raises on timeout or a worker that died."""
    from ..parallel import distributed as kdist

    world = 2
    shard_dir = os.path.join(tmpdir, "mh_shards")
    make_shard_tars(shard_dir, world * shards_per_host, images_per_shard, seed)
    ckpt = os.path.join(tmpdir, "mh_ckpt")
    outs = {
        "ref": os.path.join(tmpdir, "mh_ref.json"),
        0: os.path.join(tmpdir, "mh_rank0.json"),
        1: os.path.join(tmpdir, "mh_rank1.json"),
    }
    coord = kdist.pick_coordinator()
    t0 = time.monotonic()
    procs = {}
    common = ["--shards-dir", shard_dir, "--seed", str(seed), "--device", device]
    procs["ref"] = subprocess.Popen(
        _worker_cmd("fit-serve", [*common, "--out", outs["ref"], "--emulate-world", str(world)]),
        env=_hermetic_env(
            kdist.worker_env(0, 1, "", local_devices=local_devices, device=device),
            tmpdir, "ref"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    for r in range(world):
        procs[r] = subprocess.Popen(
            _worker_cmd("fit-serve", [*common, "--out", outs[r], "--ckpt", ckpt]),
            env=_hermetic_env(
                kdist.worker_env(r, world, coord, local_devices=local_devices, device=device),
                tmpdir, f"rank{r}"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
    tails = {}
    for key, p in procs.items():
        left = max(5.0, timeout_s - (time.monotonic() - t0))
        try:
            out, err = p.communicate(timeout=left)
        except subprocess.TimeoutExpired:
            for q in procs.values():
                q.kill()
            for q in procs.values():
                q.wait()
            raise TimeoutError(f"fit-serve worker {key} exceeded {timeout_s}s") from None
        tails[key] = (out or "")[-2000:] + (err or "")[-2000:]
        if p.returncode != 0:
            for q in procs.values():
                if q.poll() is None:
                    q.kill()
                    q.wait()
            raise RuntimeError(f"fit-serve worker {key} died rc={p.returncode}: {tails[key]}")
    records = {}
    for key, path in outs.items():
        with open(path) as fh:
            records[key] = json.load(fh)
    ref, r0, r1 = records["ref"], records[0], records[1]
    ranks = (r0, r1)
    return {
        "world": world,
        "coordinator": coord,
        "device": device,
        "wall_s": round(time.monotonic() - t0, 3),
        "fit_serve_wall_s": max(r["wall_s"] for r in ranks),
        "join_wall_s": max(r["join_wall_s"] for r in ranks),
        "fit_wall_s": max(r["fit_wall_s"] for r in ranks),
        "reshard_wall_s": max(r.get("reshard_wall_s", 0.0) for r in ranks),
        "serve_wall_s": max(r["serve_wall_s"] for r in ranks),
        "ref_fit_wall_s": ref["fit_wall_s"],
        # Each rank's own shards through the ingest and the features,
        # before the gather waits for the other rank.
        "images_per_s_per_rank": [round(r["my_images"] / r["ingest_wall_s"], 3) for r in ranks],
        "n_images": r0["n_images"],
        "bit_identical": (
            ref["predictions"] == r0["predictions"] == r1["predictions"]
            and ref["served"] == r0["served"] == r1["served"]
            and ref["mean"] == r0["mean"] == r1["mean"]
            and ref["std"] == r0["std"] == r1["std"]
        ),
        "crosshost_reshard": min(r.get("crosshost_reshard", 0) for r in ranks),
        "crosshost_bit_equal": all(r.get("crosshost_bit_equal") for r in ranks),
        "mesh_spans": all(r.get("mesh_spans") for r in ranks),
        "leaked_threads": sorted({t for r in ranks for t in r.get("leaked_threads", [])}),
        "parity_ok": all(r["parity_ok"] for r in (ref, r0, r1)),
        # What the reference and both ranks launched, each counted in its
        # own process.
        "kernel_launches": sum_launches(r["kernel_launches"] for r in (ref, r0, r1)),
        "records": records,
    }


# -- host-loss drill ----------------------------------------------------------


class _WorkerIO:
    """One serve-host subprocess with a draining stdout reader: every JSON
    line lands in a queue (a stalled parent can never deadlock the worker
    on a full pipe), stderr goes to a file for the postmortem."""

    def __init__(self, cmd, env, stderr_path: str):
        import queue
        import threading

        self.stderr_path = stderr_path
        self._err_fh = open(stderr_path, "w")
        self.proc = subprocess.Popen(
            cmd, env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=self._err_fh, text=True, bufsize=1,
        )
        self.lines: "queue.Queue" = queue.Queue()
        self._reader = threading.Thread(target=self._drain, name="mh-worker-stdout",
                                        daemon=True)
        self._reader.start()

    def _drain(self) -> None:
        for line in self.proc.stdout:
            line = line.strip()
            if not line:
                continue
            try:
                self.lines.put(json.loads(line))
            except json.JSONDecodeError:
                pass  # stray library output: not protocol
        self.lines.put(None)  # EOF marker

    def _stderr_tail(self) -> str:
        try:
            with open(self.stderr_path) as fh:
                return fh.read()[-2000:]
        except OSError:
            return ""

    def expect(self, key: str, timeout_s: float) -> dict:
        import queue

        end = time.monotonic() + timeout_s
        while True:
            left = end - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"worker pid {self.proc.pid}: no {key!r} message within {timeout_s}s: "
                    f"{self._stderr_tail()}")
            try:
                msg = self.lines.get(timeout=min(left, 0.5))
            except queue.Empty:
                continue
            if msg is None:
                raise RuntimeError(
                    f"worker pid {self.proc.pid} exited before sending {key!r} "
                    f"(rc={self.proc.poll()}): {self._stderr_tail()}")
            if key in msg:
                return msg

    def send(self, line: str) -> None:
        self.proc.stdin.write(line + "\n")
        self.proc.stdin.flush()

    def kill(self) -> None:
        self.proc.kill()

    def stats_then_kill(self, timeout_s: float) -> dict:
        """SIGKILL the worker right after its ``stats`` reply; returns that
        reply (its launches as of its last answer before the kill)."""
        self.send("stats")
        stats = self.expect("stats", timeout_s)["stats"]
        self.kill()
        return stats

    def kill_when_holding(self, timeout_s: float) -> dict:
        """Poll the worker's ``stats`` until it holds a request unanswered
        (``hold_after``), then SIGKILL it; returns that last reply, whose
        ``held`` counts the requests in flight at the kill."""
        end = time.monotonic() + timeout_s
        while True:
            self.send("stats")
            stats = self.expect("stats", timeout_s)["stats"]
            if stats["held"] >= 1:
                self.kill()
                return stats
            if time.monotonic() >= end:
                raise TimeoutError(f"worker pid {self.proc.pid} held no request within "
                                   f"{timeout_s}s")
            time.sleep(0.01)

    def finish(self, timeout_s: float = 20.0) -> int:
        try:
            self.proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=5.0)
        self._err_fh.close()
        return self.proc.returncode


def _start_serve_hosts(workers: list, tmpdir: str, tag: str, stem: str, seed: int, hosts: int,
                       local_devices: int, device: str, timeout_s: float,
                       trace_paths: dict | None = None) -> list:
    """Spawn ``hosts`` ``serve-host`` members on ``device``, appending each
    to ``workers`` as it starts (so the caller's ``finally`` reaps every
    one), with the drill's postmortem directory; wait for every port.
    Returns the members' endpoints."""
    from ..parallel import distributed as kdist

    for r in range(hosts):
        env = _hermetic_env(
            kdist.worker_env(r, hosts, "controller", local_devices=local_devices, device=device),
            tmpdir, f"{tag}{r}", trace_path=(trace_paths or {}).get(r),
        )
        env["KEYSTONE_POSTMORTEM_DIR"] = os.environ["KEYSTONE_POSTMORTEM_DIR"]
        workers.append(_WorkerIO(
            _worker_cmd("serve-host", ["--ckpt", stem, "--seed", str(seed), "--device", device]),
            env,
            os.path.join(tmpdir, f"drill_{tag}{r}.err"),
        ))
    return [("127.0.0.1", w.expect("port", timeout_s / 2)["port"]) for w in workers]


def _drill_params(seed: int):
    """The drill's deterministic scaler parameters (float32 host arrays)."""
    rng = np.random.default_rng((seed, 11))
    mean = rng.normal(size=FEAT_DIM).astype(np.float32)
    std = (np.abs(rng.normal(size=FEAT_DIM)) + 0.5).astype(np.float32)
    return mean, std


def _drill_ckpt(tmpdir: str, mean, std, device) -> str:
    """Checkpoint the scaler with its mean SHARDED over four slots of the
    controller's device, so every host's restore is a real reshard (and a
    plain load a typed refusal)."""
    from ..core import autoshard
    from ..core.checkpoint import save_pipeline
    from ..ops.stats import StandardScalerModel
    from ..parallel import mesh as kmesh

    model = _scaler(mean, std, device)
    pmesh = kmesh.make_mesh(data=4, model=1, devices=[device] * 4)
    anchored = StandardScalerModel(
        autoshard.spec_sharding("data@dim0", pmesh, 1).place(model.mean), model.std)
    stem = os.path.join(tmpdir, "drill_ckpt")
    with kmesh.use_mesh(pmesh):
        save_pipeline(stem, anchored)
    return stem


def _drill_oracle(tmpdir: str, seed: int, requests: int, stream: int, dev):
    """A drill's checkpoint stem, its seeded request rows (rng stream
    ``(seed, stream)``) and their offline answers on ``dev``."""
    import torch

    mean, std = _drill_params(seed)
    stem = _drill_ckpt(tmpdir, mean, std, dev)
    rows = np.asarray(np.random.default_rng((seed, stream)).normal(size=(requests, FEAT_DIM)),
                      np.float32)
    expected = _scaler(mean, std, dev)(torch.from_numpy(rows).to(dev)).cpu().numpy()
    return stem, rows, expected


@contextlib.contextmanager
def _postmortem_dir(tmpdir: str):
    """``KEYSTONE_POSTMORTEM_DIR`` pointed at ``tmpdir/postmortems`` for the
    drill's duration (spawned hosts inherit it); yields the directory."""
    pm_dir = os.path.join(tmpdir, "postmortems")
    os.makedirs(pm_dir, exist_ok=True)
    old_pm = os.environ.get("KEYSTONE_POSTMORTEM_DIR")
    os.environ["KEYSTONE_POSTMORTEM_DIR"] = pm_dir
    try:
        yield pm_dir
    finally:
        if old_pm is None:
            os.environ.pop("KEYSTONE_POSTMORTEM_DIR", None)
        else:
            os.environ["KEYSTONE_POSTMORTEM_DIR"] = old_pm


def _drive_fleet(fleet, rows, results, errors, *, indices=None, threads=4):
    """Continuous concurrent traffic: a thread pool drains an index queue
    through ``fleet.predict`` so requests are ALWAYS in flight while the
    controller kills a host.  Returns the pool's join callable."""
    import queue
    import threading

    idx_q: "queue.Queue" = queue.Queue()
    for i in range(len(rows)) if indices is None else indices:
        idx_q.put(i)

    def work():
        while True:
            try:
                i = idx_q.get_nowait()
            except queue.Empty:
                return
            try:
                results[i] = np.asarray(fleet.predict(rows[i]))
            except Exception as e:  # noqa: BLE001 — judged by the oracle
                errors.append((i, f"{type(e).__name__}: {e}"))

    pool = [threading.Thread(target=work, name=f"drill-client-{t}", daemon=True)
            for t in range(threads)]
    for t in pool:
        t.start()

    def join(timeout_s: float) -> bool:
        end = time.monotonic() + timeout_s
        for t in pool:
            t.join(max(0.1, end - time.monotonic()))
        return not any(t.is_alive() for t in pool)

    return join


def _answered(results) -> int:
    return sum(1 for r in results if r is not None)


def _wait_answered(results, target: int, timeout_s: float) -> None:
    end = time.monotonic() + timeout_s
    while _answered(results) < target:
        if time.monotonic() >= end:
            raise TimeoutError(f"only {_answered(results)}/{target} answers within {timeout_s}s")
        time.sleep(0.005)


def _stitch_worker_trace(path: str, host: int) -> int:
    """Re-emit a dead-or-done worker's counted-fault instants onto the
    controller's trace timeline (host-tagged) — the stitched trace shows
    the fleet's faults, not just the controller's."""
    from ..core import trace

    try:
        with open(path) as fh:
            doc = json.load(fh)
    except (OSError, json.JSONDecodeError):
        return 0
    events = doc.get("traceEvents", []) if isinstance(doc, dict) else doc
    n = 0
    for ev in events:
        if ev.get("ph") == "i" and ev.get("name") == "fault":
            kind = ev.get("args", {}).get("kind")
            if kind:
                trace.instant("fault", kind=kind, host=host, stitched=True,
                              detail=ev.get("args", {}).get("detail", ""))
                n += 1
    return n


def run_host_loss_drill(
    tmpdir: str,
    *,
    hosts: int = 2,
    requests: int = 30,
    seed: int = 0,
    local_devices: int = 2,
    device: str = "cuda",
    subprocess_mode: bool | None = None,
    timeout_s: float = 240.0,
) -> dict:
    """Kill one serving host mid-flight and judge the invariant: every
    request answered bit-equal to the offline oracle, the loss counted
    (``fleet_host_lost``), the survivors re-formed (``dist_reform``) and
    re-anchored (``host_reanchor``, postmortem-linked) — never a silent
    wrong answer, never a dropped request.

    ``subprocess_mode=True`` (default where ``spawn_available``) runs each
    host as a REAL subprocess serving over the wire on ``device`` and
    SIGKILLs one; ``False`` runs in-process wire servers with an abrupt
    socket close standing in for the death — the same fleet/failover/
    re-anchor code paths."""
    from ..core import frontend as kfrontend
    from ..core import trace
    from ..core.resilience import counters
    from ..parallel import distributed as kdist
    from ..utils.platform import resolve_device

    if subprocess_mode is None:
        subprocess_mode = kdist.spawn_available()
    if hosts < 2:
        raise ValueError("the drill needs >= 2 hosts (one must die)")
    dev = resolve_device(device)
    stem, rows, expected = _drill_oracle(tmpdir, seed, requests, 13, dev)
    kill_rank = hosts - 1
    survivors = [r for r in range(hosts) if r != kill_rank]
    t_start = time.monotonic()
    record: dict = {
        "mode": "subprocess" if subprocess_mode else "inprocess",
        "hosts": hosts,
        "kill_rank": kill_rank,
        "requests": requests,
        "device": str(dev),
    }
    with _postmortem_dir(tmpdir) as pm_dir:
        if subprocess_mode:
            _run_drill_subprocess(record, tmpdir, stem, seed, hosts, kill_rank, survivors, rows,
                                  expected, local_devices, device, timeout_s, kfrontend, counters)
        else:
            _run_drill_inprocess(record, stem, hosts, kill_rank, survivors, rows, expected,
                                 local_devices, dev, timeout_s, kdist, kfrontend, counters)
    record["postmortems"] = sorted(os.listdir(pm_dir))
    record["wall_s"] = round(time.monotonic() - t_start, 3)
    trace.instant("host_loss_drill", mode=record["mode"], hosts=hosts,
                  dropped=record["dropped_requests"], mismatches=record["mismatches"])
    return record


def _judge_answers(record, results, errors, expected) -> None:
    mismatches = [i for i, r in enumerate(results)
                  if r is not None and not np.array_equal(r, expected[i])]
    record["answered"] = _answered(results)
    record["dropped_requests"] = len(results) - record["answered"]
    record["errors"] = [e for _, e in errors][:8]
    record["mismatches"] = len(mismatches)


def _run_drill_subprocess(
    record, tmpdir, stem, seed, hosts, kill_rank, survivors, rows, expected, local_devices,
    device, timeout_s, kfrontend, counters,
) -> None:
    workers: list[_WorkerIO] = []
    trace_paths = {r: os.path.join(tmpdir, f"drill_host{r}.json") for r in range(hosts)}
    n = len(rows)
    results: list = [None] * n
    errors: list = []
    try:
        endpoints = _start_serve_hosts(workers, tmpdir, "host", stem, seed, hosts, local_devices,
                                       device, timeout_s, trace_paths)

        # Mid-flight: the doomed host answers its first few requests, then
        # holds every later one unanswered, so requests are outstanding on
        # it when it is SIGKILLed (a fast host could otherwise answer all
        # of them before the kill, and only requests sent after it would
        # meet the loss).
        k = max(1, n // (3 * hosts))
        workers[kill_rank].send(f"hold_after {k}")
        workers[kill_rank].expect("holding", timeout_s / 4)
        with kfrontend.HostFleet(endpoints, label="drill") as fleet:
            join = _drive_fleet(fleet, rows, results, errors)
            doomed = workers[kill_rank].kill_when_holding(timeout_s / 4)
            record["in_flight_at_kill"] = doomed["held"]
            record["killed_at_answered"] = _answered(results)
            _wait_answered(results, (2 * n) // 3, timeout_s / 2)
            # The controller's liveness verdict reaches the survivors:
            # re-form the reduced group, reshard, re-anchor — under the
            # traffic that is still flowing.
            acks = {}
            for r in survivors:
                workers[r].send("peer_lost " + " ".join(str(s) for s in survivors))
            for r in survivors:
                acks[r] = workers[r].expect("ack", timeout_s / 2)
                counters.record(
                    "host_reanchor",
                    f"controller: host{r} re-anchored after losing host{kill_rank} "
                    f"(wall {acks[r].get('reanchor_wall_s')}s, "
                    f"{acks[r].get('swapped')} engine(s))",
                )
            record["acks"] = acks
            if not join(timeout_s / 2):
                raise TimeoutError("drill clients did not drain")
            record["fleet"] = fleet.record()
        finals = {}
        for r in survivors:
            workers[r].send("quit")
            finals[r] = workers[r].expect("final", timeout_s / 4)["final"]
        record["survivor_counters"] = {r: finals[r]["counters"] for r in survivors}
        record["kernel_launches"] = sum_launches(
            [doomed["kernel_launches"], *(finals[r]["kernel_launches"] for r in survivors)])
        record["reanchor_wall_s"] = max(
            float(acks[r].get("reanchor_wall_s") or 0.0) for r in survivors)
    finally:
        record["worker_rcs"] = [w.finish() for w in workers]
    record["stitched_events"] = sum(_stitch_worker_trace(trace_paths[r], r) for r in survivors)
    _judge_answers(record, results, errors, expected)


def _run_drill_inprocess(
    record, stem, hosts, kill_rank, survivors, rows, expected, local_devices, dev, timeout_s,
    kdist, kfrontend, counters,
) -> None:
    from ..core.checkpoint import load_pipeline
    from ..parallel import mesh as kmesh

    # A group the caller already runs is the caller's to shut down.
    own_group = not kdist.is_initialized()
    if own_group:
        kdist.init_process_group(coordinator="controller", world=hosts, rank=0, use_torch=False)
    before, launches_before = counters.snapshot(), kernel_launches()
    routers, servers = [], []
    n = len(rows)
    results: list = [None] * n
    errors: list = []
    try:
        meshes = [kmesh.make_mesh(data=local_devices, model=1, devices=[dev] * local_devices)
                  for _ in range(hosts)]
        for r in range(hosts):
            model = load_pipeline(stem, mesh=meshes[r])
            router, server = _host_router(lambda m=model: m, meshes[r], dev, (1, 2, 4),
                                          f"inhost{r}")
            routers.append(router)
            servers.append(server)
        endpoints = [("127.0.0.1", s.port) for s in servers]

        with kfrontend.HostFleet(endpoints, label="drill") as fleet:
            # Two waves: in-process serving is fast enough that a single
            # stream can fully drain before the close lands, so the
            # post-loss continuity is driven explicitly — wave 2 hits the
            # dead endpoint (round-robin), gets marked lost, reissues.
            join = _drive_fleet(fleet, rows, results, errors, indices=range(n // 2))
            if not join(timeout_s / 4):
                raise TimeoutError("drill wave 1 did not drain")
            # The abrupt stand-in for SIGKILL: the dead host's sockets
            # close under its clients; its router is simply abandoned.
            servers[kill_rank].close()
            record["killed_at_answered"] = _answered(results)
            join = _drive_fleet(fleet, rows, results, errors, indices=range(n // 2, n))
            new = kdist.reform_group(survivors)
            t0 = time.monotonic()
            # The survivors share this process's counters: each one's
            # re-anchor is the count its own step added.
            own: dict = {}
            for r in survivors:
                at = counters.snapshot()
                info = routers[r].reanchor(meshes[r], why=f"host loss (group epoch {new.epoch})")
                counters.record(
                    "host_reanchor",
                    f"controller: inhost{r} re-anchored after losing inhost{kill_rank} "
                    f"({len(info['swapped'])} engine(s))",
                )
                own[r] = {k: counters.get(k) - at.get(k, 0)
                          for k in ("host_reanchor", "mesh_reanchor")}
            record["reanchor_wall_s"] = round(time.monotonic() - t0, 4)
            if not join(timeout_s / 2):
                raise TimeoutError("drill wave 2 did not drain")
            record["fleet"] = fleet.record()
        # Counts this drill added, never those of earlier drills in this
        # process.
        after = counters.snapshot()
        added = {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}
        record["survivor_counters"] = {r: {**added, **own[r]} for r in survivors}
        record["kernel_launches"] = {k: v - launches_before[k]
                                     for k, v in kernel_launches().items()}
        record["stitched_events"] = 0
    finally:
        for r, s in enumerate(servers):
            if r != kill_rank:
                s.close()
        for router in routers:
            router.close()
        if own_group:
            kdist.shutdown_process_group()
    _judge_answers(record, results, errors, expected)


# -- obs-capture drill --------------------------------------------------------


def _pooled_p99_oracle(record, direct, fleet_hists) -> None:
    """The collector's fleet p99 must equal the pick-rule percentile of the
    POOLED per-member samples, and sit near the numpy linear-interpolation
    percentile of the same pool."""
    metric = None
    for cand in ("serve_latency_ms", "wire_request_ms"):
        if any(cand in (d.get("hist_windows") or {}) for d in direct.values()):
            metric = cand
            break
    record["pooled_metric"] = metric
    if metric is None:
        record["p99_match"] = False
        return
    pool = sorted(float(s) for d in direct.values()
                  for s in d["hist_windows"].get(metric, {}).get("samples", ()))
    record["p99_pool_n"] = len(pool)
    fleet_p99 = fleet_hists.get(metric, {}).get("p99")
    pick = pool[min(len(pool) - 1, int(0.99 * len(pool)))] if pool else None
    p99_np = float(np.percentile(pool, 99)) if pool else None
    record["p99_fleet"] = fleet_p99
    record["p99_oracle_pick"] = pick
    record["p99_oracle_np"] = p99_np
    record["p99_match"] = (
        fleet_p99 is not None
        and fleet_p99 == pick
        and abs(fleet_p99 - p99_np) <= max(0.25 * abs(p99_np), 1e-6)
    )


def _counter_sum_check(record, snap, direct) -> None:
    """Fleet counters == the sum of per-member snapshots, key for key, both
    directions."""
    sums: dict = {}
    for d in direct.values():
        stz = d.get("statusz", {})
        for group in ("counters", "faults"):
            for k, v in (stz.get(group) or {}).items():
                sums[k] = sums.get(k, 0) + v
    fleet = dict(snap.get("counters", {}))
    for k, v in snap.get("faults", {}).items():
        fleet[k] = fleet.get(k, 0) + v
    mismatched = {k: (fleet.get(k), sums.get(k)) for k in set(fleet) | set(sums)
                  if fleet.get(k, 0) != sums.get(k, 0)}
    record["counter_sum_ok"] = not mismatched
    if mismatched:
        record["counter_sum_mismatch"] = {k: list(v) for k, v in sorted(mismatched.items())[:8]}


def _judge_incident(record, bundle_path, survivor_keys) -> None:
    """ONE bundle, every surviving member's ring present and non-empty,
    events on one monotone clock-aligned timeline."""
    with open(bundle_path) as fh:
        doc = json.load(fh)
    members = doc.get("members", {})
    ts = [ev["ts"] for ev in doc.get("events", []) if isinstance(ev.get("ts"), (int, float))]
    record["incident"] = {
        "path": bundle_path,
        "schema": doc.get("schema"),
        "trigger": doc.get("trigger", {}).get("kind"),
        "capture_wall_s": doc.get("capture_wall_s"),
        "members": sorted(members),
        "missing": doc.get("missing", []),
        "n_events": len(doc.get("events", [])),
        "survivor_rings_ok": all(k in members and members[k].get("events", 0) > 0
                                 for k in survivor_keys),
        "events_monotone": ts == sorted(ts),
    }


def run_obs_capture_drill(
    tmpdir: str,
    *,
    hosts: int = 2,
    requests: int = 18,
    seed: int = 0,
    local_devices: int = 2,
    subprocess_mode: bool | None = None,
    timeout_s: float = 240.0,
    device: str = "cuda",
) -> dict:
    """The fleet-observability drill: serve across N members with a
    ``core.fleetobs.FleetCollector`` attached, prove on a QUIET fleet that
    (a) fleet counters equal the sum of per-member snapshots and (b) fleet
    p99 comes from the pooled sample windows, then kill one member
    mid-scrape and prove (c) the collector degrades (``obs_member_lost``),
    stays monotone for the survivors, and writes ONE clock-aligned incident
    bundle holding every surviving member's flight ring — while every
    request still answers bit-equal to the offline oracle (collection must
    not touch the serving answers).

    ``subprocess_mode=True`` (default where ``spawn_available``) runs each
    member as a REAL ``serve-host`` subprocess on ``device`` and SIGKILLs
    one; ``False`` runs in-process wire servers on slots of ``device``
    with an abrupt socket close standing in for the SIGKILL — the same
    collector/merge/incident code paths.  ``record["kernel_launches"]``
    sums the hand kernels' launches over every serving process."""
    from ..core import frontend as kfrontend
    from ..core import trace
    from ..core.resilience import counters
    from ..parallel import distributed as kdist
    from ..utils.platform import resolve_device

    if subprocess_mode is None:
        subprocess_mode = kdist.spawn_available()
    if hosts < 2:
        raise ValueError("the drill needs >= 2 hosts (one must die)")
    dev = resolve_device(device)
    stem, rows, expected = _drill_oracle(tmpdir, seed, requests, 17, dev)
    kill_rank = hosts - 1
    survivors = [r for r in range(hosts) if r != kill_rank]
    t_start = time.monotonic()
    record: dict = {
        "mode": "subprocess" if subprocess_mode else "inprocess",
        "hosts": hosts,
        "kill_rank": kill_rank,
        "requests": requests,
        "device": str(dev),
        "incident_dir": os.path.join(tmpdir, "incidents"),
    }
    with _postmortem_dir(tmpdir) as pm_dir:
        if subprocess_mode:
            _run_obs_drill_subprocess(record, tmpdir, stem, seed, hosts, kill_rank, survivors,
                                      rows, expected, local_devices, device, timeout_s,
                                      kfrontend, counters)
        else:
            _run_obs_drill_inprocess(record, stem, hosts, kill_rank, survivors, rows, expected,
                                     local_devices, dev, timeout_s, kfrontend, counters)
    record["postmortems"] = sorted(os.listdir(pm_dir))
    record["wall_s"] = round(time.monotonic() - t_start, 3)
    trace.instant("obs_capture_drill", mode=record["mode"], hosts=hosts,
                  dropped=record["dropped_requests"], mismatches=record["mismatches"],
                  incidents=len(record.get("incidents", [])))
    return record


def _obs_drill_collector_phase(
    record, col, fleet, endpoints, kill, rows, expected, survivor_keys, timeout_s, counters,
) -> None:
    """The collector-side drill body shared by both modes: quiet-fleet
    merge checks, mid-scrape member death, incident + monotonicity
    judgement.  ``kill()`` is the mode's way of killing the chosen
    member."""
    from ..core import wire as kwire

    n = len(rows)
    results: list = [None] * n
    errors: list = []
    fleet.attach_collector(col)
    col.start()
    # Wave 1: drive then DRAIN, so the merge checks compare a quiet fleet
    # (counters moving under the comparison would fake a mismatch).
    join = _drive_fleet(fleet, rows, results, errors, indices=range(n // 2))
    if not join(timeout_s / 4):
        raise TimeoutError("obs drill wave 1 did not drain")
    col.stop()
    # Quiet-fleet comparison discipline: one warm scrape FIRST (any pending
    # collector connect/clock handshake lands now), then the direct pulls
    # (each opens a fresh connection the member counts in the very payload
    # it returns), then the comparison scrape — which reuses live
    # connections and moves nothing, so both sides total the same
    # ``wire_connections``.
    col.scrape_once()
    direct = {}
    clients = [kwire.WireClient(ep[0], ep[1], timeout=10.0) for ep in endpoints]
    try:
        # All connections open, and each one's accept counted (a ping
        # answers only after it), BEFORE any payload is read: in-process
        # members share one registry, so a later connect would move the
        # counters an earlier payload already reported.
        for c in clients:
            c.ping()
        for ep, c in zip(endpoints, clients):
            d = c.obs_snapshot()
            if d is not None:
                direct[f"{ep[0]}:{ep[1]}"] = d
    finally:
        for c in clients:
            c.close()
    t0 = time.monotonic()
    snap_before = col.scrape_once()
    record["scrape_wall_s"] = round(time.monotonic() - t0, 4)
    _counter_sum_check(record, snap_before, direct)
    _pooled_p99_oracle(record, direct, snap_before.get("histograms", {}))
    lost_before = counters.get("obs_member_lost")
    col.start()  # scraping again: the death below lands mid-cadence
    # Wave 2: the kill lands while requests AND scrapes are in flight.
    join = _drive_fleet(fleet, rows, results, errors, indices=range(n // 2, n))
    kill()
    record["killed_at_answered"] = _answered(results)
    if not join(timeout_s / 2):
        raise TimeoutError("obs drill wave 2 did not drain")
    # The collector notices on its own cadence; force one pass if the
    # window closes first (alive->dead triggers exactly once either way).
    end = time.monotonic() + timeout_s / 4
    while counters.get("obs_member_lost") <= lost_before and time.monotonic() < end:
        time.sleep(0.05)
    col.stop()
    if counters.get("obs_member_lost") <= lost_before:
        col.scrape_once()
    snap_after = col.scrape_once()
    record["obs_member_lost"] = counters.get("obs_member_lost") - lost_before
    non_mono = {k: (v, snap_after["counters"].get(k, 0))
                for k, v in snap_before["counters"].items()
                if snap_after["counters"].get(k, 0) < v}
    record["monotone_ok"] = not non_mono
    if non_mono:
        record["monotone_violations"] = {k: list(v) for k, v in sorted(non_mono.items())[:8]}
    record["fleet_alive"] = snap_after["alive"]
    record["fleet_lost"] = snap_after["lost"]
    record["healthz"] = col.fleet_healthz()
    record["incidents"] = list(col.incident_paths)
    record["collector"] = col.record()
    record["fleet"] = fleet.record()
    _judge_answers(record, results, errors, expected)
    bundles = [p for p in col.incident_paths if "obs_member_lost" in p]
    if len(bundles) == 1:
        _judge_incident(record, bundles[0], survivor_keys)
    else:
        record["incident"] = {"error": f"{len(bundles)} bundle(s)"}


def _obs_collector(record):
    from ..core import fleetobs

    return fleetobs.FleetCollector(interval_s=0.1, incident_dir=record["incident_dir"],
                                   window_s=5.0, label="obs-drill")


def _run_obs_drill_subprocess(
    record, tmpdir, stem, seed, hosts, kill_rank, survivors, rows, expected, local_devices,
    device, timeout_s, kfrontend, counters,
) -> None:
    workers: list[_WorkerIO] = []
    doomed: dict = {}

    def kill() -> None:
        doomed.update(workers[kill_rank].stats_then_kill(timeout_s / 4))

    try:
        endpoints = _start_serve_hosts(workers, tmpdir, "obshost", stem, seed, hosts,
                                       local_devices, device, timeout_s)
        survivor_keys = [f"127.0.0.1:{endpoints[r][1]}" for r in survivors]
        with _obs_collector(record) as col, \
                kfrontend.HostFleet(endpoints, label="obs-drill") as fleet:
            _obs_drill_collector_phase(record, col, fleet, endpoints, kill, rows, expected,
                                       survivor_keys, timeout_s, counters)
        finals = {}
        for r in survivors:
            workers[r].send("quit")
            finals[r] = workers[r].expect("final", timeout_s / 4)["final"]
        record["survivor_counters"] = {r: finals[r]["counters"] for r in survivors}
        record["kernel_launches"] = sum_launches(
            [doomed["kernel_launches"], *(finals[r]["kernel_launches"] for r in survivors)])
    finally:
        record["worker_rcs"] = [w.finish() for w in workers]


def _run_obs_drill_inprocess(
    record, stem, hosts, kill_rank, survivors, rows, expected, local_devices, dev, timeout_s,
    kfrontend, counters,
) -> None:
    from ..core.checkpoint import load_pipeline
    from ..parallel import mesh as kmesh

    launches_before = kernel_launches()
    routers, servers = [], []
    try:
        meshes = [kmesh.make_mesh(data=local_devices, model=1, devices=[dev] * local_devices)
                  for _ in range(hosts)]
        for r in range(hosts):
            model = load_pipeline(stem, mesh=meshes[r])
            router, server = _host_router(lambda m=model: m, meshes[r], dev, (1, 2, 4),
                                          f"obshost{r}")
            routers.append(router)
            servers.append(server)
        endpoints = [("127.0.0.1", s.port) for s in servers]
        survivor_keys = [f"127.0.0.1:{servers[r].port}" for r in survivors]
        with _obs_collector(record) as col, \
                kfrontend.HostFleet(endpoints, label="obs-drill") as fleet:
            # The abrupt stand-in for SIGKILL: the member's sockets close
            # under its clients; its router is simply abandoned.
            _obs_drill_collector_phase(record, col, fleet, endpoints, servers[kill_rank].close,
                                       rows, expected, survivor_keys, timeout_s, counters)
        record["survivor_counters"] = {r: counters.snapshot() for r in survivors}
        record["kernel_launches"] = {k: v - launches_before[k]
                                     for k, v in kernel_launches().items()}
    finally:
        for server in servers:  # idempotent: the killed one is closed already
            server.close()
        for router in routers:
            router.close()


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in ("fit-serve", "serve-host"):
        print(
            "usage: python -m keystone_tpu_torch.workloads.multihost "
            "{fit-serve|serve-host} ...",
            file=sys.stderr,
        )
        return 2
    if argv[0] == "fit-serve":
        return fit_serve_main(argv[1:])
    return serve_host_main(argv[1:])


if __name__ == "__main__":
    sys.exit(main())
