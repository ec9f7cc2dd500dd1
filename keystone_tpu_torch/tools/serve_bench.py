"""Serving front-end bench CLI on the port (counterpart of
``tools/serve_bench.py``): the shape-routed endpoint under load,
in-process or over real sockets (``--wire``) from separate client
processes.

Default (in-process) mode builds one deterministic toy engine per
``--shapes`` entry (on the card, each bucket a captured CUDA graph),
registers them with a :class:`~keystone_tpu_torch.core.frontend.ShapeRouter`,
and drives a mixed-shape request stream from concurrent in-process
clients — reporting per-shape p50/p99/QPS, the router's stats (engines,
routes, warm adds, retires), and the ``router_route_overhead_us``
histogram.

``--wire`` additionally binds a :class:`~keystone_tpu_torch.core.wire.WireServer`
and spawns ``--clients`` separate client processes
(``python -m keystone_tpu_torch.tools.serve_client``, which import no
torch, so they create no CUDA context) driving real sockets, round-robin
over the shapes.  Client records are merged with exact cross-client
percentiles; the headline ``wire_p99_ms`` is the p99 over every request of
every client process, and ``client_startup_s`` each client's seconds from
its spawn to its connected socket.  ``--shift`` replays a request-shape-mix
shift over the wire: a shape with no engine goes hot (RETRY_AFTER
backpressure until the router warms an engine for it), then the retire
sweep runs.

``--kill-device N`` anchors the engines on a mesh over
``parallel.mesh.default_devices()`` (set ``KEYSTONE_DIST_DEVICE`` and
``KEYSTONE_DIST_LOCAL_SLOTS`` for slots of one card) and loses slot N
mid-run: the router re-anchors every engine on the survivors with no
request lost.  ``--numerics`` turns the numerics observatory on.

``--hosts N`` benches the multi-host fleet front: N serve-host worker
processes (``keystone_tpu_torch.workloads.multihost``, toy scaler mode, two
slots of ``--device`` each), fronted by a
:class:`~keystone_tpu_torch.core.frontend.HostFleet`; ``--kill-host R``
SIGKILLs rank R mid-flight and the survivors re-anchor with no request
lost; ``--collect`` attaches a fleet collector.

``--drift-refit`` runs the closed-lifecycle drill: a shifted request mix
trips the armed drift monitor of a served incumbent, the
:class:`~keystone_tpu_torch.core.lifecycle.LifecycleController` warm-refits
on fresh data, validates, and hot-swaps the router's engine with requests
in flight.

Every mode runs on the CUDA card unless ``--device cpu`` is given, and
raises where there is no card.  The first stdout line is the
machine-readable JSON record; human-readable lines follow.  Exit 0 on
success, 1 on any failed client or lost request.

Usage:
    python -m keystone_tpu_torch.tools.serve_bench                      # in-process
    python -m keystone_tpu_torch.tools.serve_bench --wire --clients 4   # real sockets
    python -m keystone_tpu_torch.tools.serve_bench --wire --shift       # + mix shift
    KEYSTONE_DIST_LOCAL_SLOTS=4 \\
        python -m keystone_tpu_torch.tools.serve_bench --kill-device 1  # elastic drill
    python -m keystone_tpu_torch.tools.serve_bench --hosts 3 --kill-host 2 --collect
    python -m keystone_tpu_torch.tools.serve_bench --drift-refit        # lifecycle drill
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from ..core.pipeline import Transformer
from .serve_client import _percentile, parse_shape

#: The checkout's root: spawned clients import the package from here.
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_shapes(raw: str) -> list[tuple]:
    return [parse_shape(tok) for tok in raw.split(",") if tok.strip()]


class MulMax(Transformer):
    """``max(x * w, b)``: fusion-invariant (f32 multiply and max are exact),
    so every bucket, the eager chain and the JAX tool's toy engine give the
    same bits.  ``w`` and ``b`` are attributes, so a mesh engine replicates
    them onto each slot's device."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        self.w = w
        self.b = b

    def __call__(self, x):
        return torch.maximum(x * self.w, self.b)


def toy_engine(shape: tuple, dtype=np.dtype(np.float32), mesh=None, device="cuda"):
    """Deterministic per-shape engine; ``w`` and ``b`` are drawn by the JAX
    tool's generator from its seed.  ``mesh`` anchors the engine's buckets
    on a device mesh (the elastic --kill-device drill)."""
    from ..core import frontend, serve as kserve
    from ..utils.platform import resolve_device

    dev = resolve_device(mesh.devices[0, 0] if mesh is not None else device)
    rng = np.random.default_rng(20260803 + int(np.prod(shape, dtype=np.int64)))
    w = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    b = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    cfg = kserve.ServeConfig.from_env(buckets=(1, 4, 16), max_wait_ms=2.0)
    return kserve.ServingEngine(
        MulMax(w, b),
        np.zeros(shape, np.float32),
        config=cfg,
        label=frontend.shape_label("serve_bench", shape),
        mesh=mesh,
        device=dev,
    )


def _shape_key(shape) -> str:
    return "x".join(str(d) for d in shape) or "scalar"


def _per_shape(lat_by_shape: dict, reqs_by_shape: dict) -> dict:
    """Per-shape request counts and latency percentiles."""
    out = {}
    for k, v in lat_by_shape.items():
        v = sorted(v)
        out[k] = {
            "requests": reqs_by_shape[k],
            "p50_ms": round(_percentile(v, 0.50), 3),
            "p99_ms": round(_percentile(v, 0.99), 3),
        }
    return out


def run_inproc(router, shapes, clients, requests_per_client, timeout) -> dict:
    """Concurrent in-process clients, round-robin over shapes, pipelined
    depth 8 — per-shape latency percentiles from the futures' own
    submit-to-answer clocks."""
    lat_by_shape: dict[str, list] = {_shape_key(s): [] for s in shapes}
    errors: list = []
    lock = threading.Lock()

    def client(cid: int):
        shape = shapes[cid % len(shapes)]
        rng = np.random.default_rng(1000 + cid)
        reqs = rng.standard_normal(
            (requests_per_client, *shape)
        ).astype(np.float32)
        lats = []
        try:
            pending = []
            for r in reqs:
                pending.append(router.submit(r))
                if len(pending) >= 8:
                    fut = pending.pop(0)
                    fut.result(timeout)
                    lats.append(fut.latency_seconds() * 1e3)
            for fut in pending:
                fut.result(timeout)
                lats.append(fut.latency_seconds() * 1e3)
            with lock:
                lat_by_shape[_shape_key(shape)].extend(lats)
        except BaseException as e:  # noqa: BLE001 — surfaced in the record
            errors.append(f"client {cid}: {type(e).__name__}: {e}")

    threads = [
        threading.Thread(target=client, args=(c,)) for c in range(clients)
    ]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    wall = time.perf_counter() - t0
    total = sum(len(v) for v in lat_by_shape.values())
    return {
        "clients": clients,
        "requests": total,
        "wall_seconds": round(wall, 4),
        "qps": round(total / wall, 2) if wall > 0 else 0.0,
        "per_shape": _per_shape(
            lat_by_shape, {k: len(v) for k, v in lat_by_shape.items()}
        ),
        "errors": errors,
    }


def _client_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (_ROOT, env.get("PYTHONPATH")) if p)
    return env


def _client_cmd(port: int, shape, requests: int, seed: int, timeout: float) -> list[str]:
    return [
        sys.executable, "-m", "keystone_tpu_torch.tools.serve_client",
        "--port", str(port),
        "--shape", _shape_key(shape),
        "--requests", str(requests),
        "--seed", str(seed),
        "--timeout", str(timeout),
    ]


def _startup_s(rec: dict, spawned_unix: float) -> float | None:
    """Seconds from a client's spawn to its connected socket."""
    at = rec.get("connected_unix_s")
    return None if at is None else round(at - spawned_unix, 3)


def run_wire(
    ws, shapes, clients, requests_per_client, timeout
) -> dict:
    """Spawn ``clients`` separate serve_client processes against the live
    socket server and merge their records (exact percentiles from the
    pooled per-request latencies)."""
    procs = []
    env = _client_env()
    for cid in range(clients):
        shape = shapes[cid % len(shapes)]
        spawned = time.time()
        procs.append(
            (cid, shape, spawned, subprocess.Popen(
                _client_cmd(ws.port, shape, requests_per_client, cid, timeout),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True, env=env, cwd=_ROOT,
            ))
        )
    client_records = []
    errors = []
    for cid, shape, spawned, proc in procs:
        try:
            out, err = proc.communicate(timeout=timeout + 120)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            errors.append(f"client {cid}: timed out")
            continue
        if proc.returncode != 0:
            errors.append(
                f"client {cid}: exit {proc.returncode}: {err[-400:]}"
            )
            continue
        try:
            rec = json.loads(out.splitlines()[0])
        except (json.JSONDecodeError, IndexError) as e:
            errors.append(f"client {cid}: unparsable record: {e}")
            continue
        rec["client"] = cid
        rec["startup_s"] = _startup_s(rec, spawned)
        client_records.append(rec)
    lat_by_shape: dict[str, list] = {}
    reqs_by_shape: dict[str, int] = {}
    for rec in client_records:
        key = _shape_key(rec.get("shape", []))
        lat_by_shape.setdefault(key, []).extend(
            rec.get("latencies_ms", [])
        )
        reqs_by_shape[key] = reqs_by_shape.get(key, 0) + rec["requests"]
    all_lat = sorted(v for vals in lat_by_shape.values() for v in vals)
    for rec in client_records:
        rec.pop("latencies_ms", None)  # merged above; keep records small
    return {
        "clients": clients,
        "client_processes": [
            {"client": r["client"], "pid_record": r} for r in client_records
        ],
        # answered count from the client records themselves — latencies_ms
        # is a (possibly sampled) distribution, not the request ledger.
        "requests": sum(r["requests"] for r in client_records),
        "per_shape": _per_shape(lat_by_shape, reqs_by_shape),
        "wire_p50_ms": round(_percentile(all_lat, 0.50), 3),
        "wire_p99_ms": round(_percentile(all_lat, 0.99), 3),
        "retry_after_total": sum(
            r.get("retry_after", 0) for r in client_records
        ),
        "client_startup_s": [r["startup_s"] for r in client_records],
        "errors": errors,
    }


def run_shift(router, ws, shapes, timeout) -> dict:
    """The mix-shift replay over the wire: a NEW shape goes hot (the
    client absorbs RETRY_AFTER pushback until the router warms an engine),
    then the retire sweep reclaims the now-idle original engines —
    warm add + retire proven over a live socket with zero lost requests."""
    new_shape = (int(np.prod(shapes[0], dtype=np.int64)) + 3,)
    warm_before = router.stats.warm_adds
    retire_before = router.stats.retires
    spawned = time.time()
    proc = subprocess.run(
        _client_cmd(ws.port, new_shape, 24, 777, timeout),
        capture_output=True, text=True, timeout=timeout + 120,
        env=_client_env(), cwd=_ROOT,
    )
    out: dict = {"new_shape": list(new_shape)}
    if proc.returncode != 0:
        out["error"] = f"shift client failed: {proc.stderr[-400:]}"
        return out
    rec = json.loads(proc.stdout.splitlines()[0])
    rec.pop("latencies_ms", None)
    rec["startup_s"] = _startup_s(rec, spawned)
    out["client"] = rec
    out["warm_adds"] = router.stats.warm_adds - warm_before
    # The shifted-away shapes stopped earning traffic — run the retire
    # sweep with a bounded idle threshold so the replay is deterministic
    # (the new engine routed most recently and survives the sweep's
    # idlest-first order + min_engines floor).
    saved = router.config.retire_after_s
    try:
        router.config.retire_after_s = 1.0
        time.sleep(1.1)
        router.adapt()
    finally:
        router.config.retire_after_s = saved
    out["retires"] = router.stats.retires - retire_before
    out["new_shape_live"] = tuple(new_shape) in router.engines()
    # drive() answers every request or dies nonzero (caught above), so a
    # successful client record IS the zero-loss proof.
    out["lost_requests"] = 24 - rec["requests"]
    return out


def drift_refit_drill(tmpdir, *, requests=24, seed=0, timeout=60.0, device="cuda") -> dict:
    """The closed model-lifecycle drill: an incumbent fit on pre-drift
    truth serves an armed router; the request mix shifts (new truth), the
    drift monitor trips, and the
    :class:`~keystone_tpu_torch.core.lifecycle.LifecycleController` runs
    one full cycle — warm refit on fresh data, holdout validation, atomic
    hot-swap — while a pump thread keeps requests in flight across the
    swap.  The record carries the walls (``drift_to_healthy_wall_s``,
    ``refit_wall_s``, ``swap_wall_s``), ``dropped_requests`` (must stay
    0), the post-swap bit-equality verdict, and the controller's
    ``lifecycle:<label>`` statusz section.  The refit's tensors go to the
    incumbent engine's device."""
    from ..core import frontend as kfrontend
    from ..core import numerics as knum
    from ..core import serve as kserve
    from ..core.lifecycle import LifecycleConfig, LifecycleController
    from ..ops.stats import StandardScalerModel
    from ..solvers.block import BlockLeastSquaresEstimator
    from ..utils.platform import resolve_device

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    d, k = 16, 4
    mean0 = rng.normal(size=(d,)).astype(np.float32)
    t1 = rng.normal(size=(d, k)).astype(np.float32)
    t2 = rng.normal(size=(d, k)).astype(np.float32)
    featurizer = StandardScalerModel(torch.from_numpy(mean0).to(dev), None)
    shift = np.zeros(d, np.float32)
    shift[int(np.argmax(np.abs(t1).sum(axis=1)))] = 6.0

    def fit(feats, labels):
        est = BlockLeastSquaresEstimator(block_size=16, num_iter=1, lam=0.0)
        return est.fit(torch.from_numpy(feats).to(dev), torch.from_numpy(labels).to(dev))

    # Pre-drift world: the incumbent's truth is (x - mean0) @ t1.
    xa = rng.normal(size=(128, d)).astype(np.float32)
    feats_a = xa - mean0
    pipe_inc = featurizer.then(fit(feats_a, feats_a @ t1))
    cfg = kserve.ServeConfig(buckets=(1, 2, 4), max_wait_ms=2.0)
    engine = kserve.ServingEngine(
        pipe_inc, np.zeros(d, np.float32), config=cfg, label="lifedrill_inc", device=dev
    )
    baseline = knum.OutputSketch.for_outputs(
        engine.offline(rng.normal(size=(64, d)).astype(np.float32))
    ).record()

    # Post-drift world: shifted requests, new truth (x - mean0) @ t2.
    xb = rng.normal(size=(128, d)).astype(np.float32) + shift
    feats_b = xb - mean0
    labels_b = feats_b @ t2
    hx = rng.normal(size=(64, d)).astype(np.float32) + shift
    hy = (hx - mean0) @ t2
    shifted = rng.normal(size=(max(48, requests), d)).astype(np.float32) + shift
    reqs = rng.normal(size=(requests, d)).astype(np.float32) + shift

    router = kfrontend.ShapeRouter(
        label="lifedrill",
        config=kfrontend.RouterConfig(warm_threshold=1, retire_after_s=300.0),
    )
    record: dict = {"requests": int(requests)}
    dropped = [0]
    pumped = [0]
    ctl = None
    try:
        router.add_engine(engine)
        ctl = LifecycleController(
            router,
            workdir=os.path.join(tmpdir, "lifedrill_wd"),
            featurizer=featurizer,
            fetch=lambda digest: (feats_b, labels_b),
            estimator=lambda: BlockLeastSquaresEstimator(
                block_size=16, num_iter=1, lam=0.0
            ),
            assemble=lambda model: featurizer.then(model),
            holdout=lambda: (hx, hy),
            quality=lambda predict, x, y: -float(
                np.mean((np.asarray(predict(x)) - y) ** 2)
            ),
            example=np.zeros(d, np.float32),
            label="lifedrill",
            serve_config=cfg,
            config=LifecycleConfig(cooldown_s=0.0),
            device=dev,
        )
        with knum.monitored(True):
            engine.arm_drift_baseline(baseline)
            t_drift = time.perf_counter()
            for f in [router.submit(r) for r in shifted]:
                f.result(timeout)
            tripped = ctl.check_signals()
            record["tripped"] = tripped
            # Keep requests in flight ACROSS the swap: the drill's
            # zero-drop claim is about live traffic, not a quiesced
            # router.
            stop = threading.Event()

            def pump():
                i = 0
                while not stop.is_set():
                    try:
                        router.submit(reqs[i % len(reqs)]).result(timeout)
                    except Exception:  # noqa: BLE001 — any loss is a drop
                        dropped[0] += 1
                    pumped[0] += 1
                    i += 1

            pump_thread = threading.Thread(
                target=pump, name="lifedrill-pump", daemon=True
            )
            pump_thread.start()
            try:
                cycle = ctl.run_refit(reason=tripped or "operator")
            finally:
                stop.set()
                pump_thread.join(timeout)
            record["drift_to_healthy_wall_s"] = round(
                time.perf_counter() - t_drift, 6
            )
        record["cycle"] = cycle
        for key in ("refit_wall_s", "validate_wall_s", "swap_wall_s",
                    "total_wall_s"):
            record[key] = cycle.get(key)
        # Post-swap answers must be bit-equal to the NEW engine's own
        # eager oracle (the refit pipeline).
        new_engine = router.server_for((d,)).engine
        post = np.stack(
            [router.submit(r).result(timeout) for r in reqs]
        )
        record["swapped_engine"] = new_engine.label
        record["post_swap_bit_equal"] = bool(
            np.array_equal(post, new_engine.offline(reqs))
        )
        record["in_flight_across_swap"] = int(pumped[0])
        record["dropped_requests"] = int(dropped[0])
        record["lifecycle"] = ctl.record()
        record["ok"] = bool(
            tripped == "serve_output_drift"
            and cycle.get("outcome") == "swapped"
            and new_engine is not engine
            and record["post_swap_bit_equal"]
            and dropped[0] == 0
        )
        return record
    finally:
        if ctl is not None:
            ctl.close()
        router.close()


def run_drift_refit(a) -> int:
    """--drift-refit: the lifecycle drill as a CLI record (JSON first
    line; exit 1 unless the cycle landed with zero dropped requests and
    bit-equal post-swap answers)."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="serve_bench_lifecycle_")
    t0 = time.perf_counter()
    try:
        drill = drift_refit_drill(
            tmp, requests=a.requests, timeout=a.timeout, device=a.device
        )
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    record = {
        "metric": "serve_bench",
        "mode": "drift_refit",
        "drill": drill,
        # Top-level copies for the regression observatory's dotted paths.
        "drift_to_healthy_wall_s": drill.get("drift_to_healthy_wall_s"),
        "refit_wall_s": drill.get("refit_wall_s"),
        "swap_wall_s": drill.get("swap_wall_s"),
        "dropped_requests": drill.get("dropped_requests"),
        "ok": drill.get("ok", False),
        "seconds": round(time.perf_counter() - t0, 3),
    }
    print(json.dumps(record), flush=True)
    cyc = drill.get("cycle", {})
    print(
        f"# lifecycle: tripped on {drill.get('tripped')}, cycle outcome "
        f"{cyc.get('outcome')} (g{cyc.get('generation')}), engine "
        f"{drill.get('swapped_engine')}"
    )
    print(
        f"# walls: drift->healthy {drill.get('drift_to_healthy_wall_s')}s "
        f"(refit {drill.get('refit_wall_s')}s, validate "
        f"{drill.get('validate_wall_s')}s, swap {drill.get('swap_wall_s')}s)"
    )
    print(
        f"# traffic: {drill.get('in_flight_across_swap')} request(s) pumped "
        f"across the swap, {drill.get('dropped_requests')} dropped, "
        f"post-swap bit-equal: {drill.get('post_swap_bit_equal')}"
    )
    return 0 if record["ok"] else 1


def run_hosts(a) -> int:
    """--hosts N: spawn N serve-host worker processes
    (``keystone_tpu_torch.workloads.multihost serve-host``, toy scaler
    mode, two slots of ``--device`` each), front them with a
    :class:`~keystone_tpu_torch.core.frontend.HostFleet`, and drive the
    request stream through the fleet — per-request p50/p99 across hosts,
    per-host request counts, and with ``--kill-host R`` the host-loss
    drill: SIGKILL rank R mid-flight, survivors re-form the reduced group
    and re-anchor (the ack carries ``reanchor_wall_s``) while the fleet
    reissues — zero lost requests or exit 1."""
    import queue
    import tempfile

    from ..core import frontend as kfrontend
    from ..parallel import distributed as kdist
    from ..workloads import multihost as mh

    record: dict = {
        "metric": "serve_bench",
        "hosts": a.hosts,
        "requests_per_client": a.requests,
    }
    if not kdist.spawn_available():
        # The reference's record for a host that cannot spawn processes.
        record.update(multihost_unavailable=True, ok=True)
        print(json.dumps(record), flush=True)
        print("# multihost: process spawn unavailable — nothing benched")
        return 0
    if a.kill_host is not None and not 0 <= a.kill_host < a.hosts:
        print(json.dumps({**record, "ok": False,
                          "error": f"--kill-host {a.kill_host} out of range"}))
        return 2

    clients = a.clients or 4
    n = clients * a.requests
    record["clients"] = clients
    rng = np.random.default_rng(7)
    rows = [rng.normal(size=mh.FEAT_DIM).astype(np.float32)
            for _ in range(n)]

    t0 = time.perf_counter()
    tmpdir = tempfile.mkdtemp(prefix="serve_bench_hosts_")
    workers: list = []
    errors: list = []
    results: list = [None] * n
    lat_ms: list = [None] * n
    col = None
    try:
        for r in range(a.hosts):
            env = mh._hermetic_env(
                kdist.worker_env(r, a.hosts, "controller", local_devices=2, device=a.device),
                tmpdir, f"host{r}",
            )
            workers.append(mh._WorkerIO(
                mh._worker_cmd("serve-host", ["--seed", "7", "--device", a.device]),
                env, os.path.join(tmpdir, f"host{r}.err"),
            ))
        up = [w.expect("port", a.timeout / 2) for w in workers]
        endpoints = [("127.0.0.1", m["port"]) for m in up]
        # The workers start together: this is their start-up (interpreter,
        # imports, device context, engine build) up to the slowest.
        record["bringup_seconds"] = round(time.perf_counter() - t0, 3)

        idx_q: "queue.Queue" = queue.Queue()
        for i in range(n):
            idx_q.put(i)

        with kfrontend.HostFleet(endpoints, label="serve_bench") as fleet:
            if a.collect:
                from ..core import fleetobs

                col = fleetobs.FleetCollector(
                    label="serve_bench", interval_s=0.2
                )
                fleet.attach_collector(col)
                col.start()

            def work():
                while True:
                    try:
                        i = idx_q.get_nowait()
                    except queue.Empty:
                        return
                    s = time.perf_counter()
                    try:
                        results[i] = np.asarray(fleet.predict(rows[i]))
                        lat_ms[i] = (time.perf_counter() - s) * 1000.0
                    except Exception as e:  # noqa: BLE001 — judged below
                        errors.append(f"req {i}: {type(e).__name__}: {e}")

            pool = [
                threading.Thread(
                    target=work, name=f"fleet-client-{t}", daemon=True
                )
                for t in range(clients)
            ]
            for t in pool:
                t.start()
            if a.kill_host is not None:
                mh._wait_answered(results, n // 3, a.timeout / 3)
                workers[a.kill_host].kill()
                record["killed_host"] = a.kill_host
                record["killed_at_answered"] = mh._answered(results)
                survivors = [
                    r for r in range(a.hosts) if r != a.kill_host
                ]
                acks = {}
                for r in survivors:
                    workers[r].send(
                        "peer_lost " + " ".join(str(s) for s in survivors)
                    )
                for r in survivors:
                    acks[r] = workers[r].expect("ack", a.timeout / 2)
                record["reanchor_wall_s"] = max(
                    float(acks[r].get("reanchor_wall_s") or 0.0)
                    for r in survivors
                )
            end = time.monotonic() + a.timeout
            for t in pool:
                t.join(max(0.1, end - time.monotonic()))
            if any(t.is_alive() for t in pool):
                errors.append("fleet clients did not drain in time")
            if col is not None:
                from ..core import resilience

                col.stop()
                snap = col.scrape_once()
                hists = snap.get("histograms") or {}
                metric = next(
                    (m for m in ("serve_latency_ms", "wire_request_ms")
                     if m in hists),
                    None,
                )
                p99 = (hists.get(metric) or {}).get("p99")
                record["fleet_obs"] = {
                    "statusz": snap,
                    "pooled_metric": metric,
                    "fleet_p99_ms": round(p99, 3) if p99 is not None
                    else None,
                    "alive": snap.get("alive"),
                    "lost": snap.get("lost"),
                    # Counted in THIS (collector) process, not a member.
                    "obs_member_lost": int(
                        resilience.counters.get("obs_member_lost")
                    ),
                }
            record["fleet"] = fleet.record()
        live = [r for r in range(a.hosts) if r != a.kill_host]
        for r in live:
            workers[r].send("quit")
        record["survivor_counters"] = {
            r: workers[r].expect("final", a.timeout / 4)["final"]["counters"]
            for r in live
        }
    finally:
        if col is not None:
            col.close()
        record["worker_rcs"] = [w.finish() for w in workers]

    answered = sorted(v for v in lat_ms if v is not None)
    dropped = n - len(answered)
    record["bench"] = {
        "requests": len(answered),
        "errors": errors,
        "p50_ms": round(_percentile(answered, 0.50), 3) if answered else None,
        "p99_ms": round(_percentile(answered, 0.99), 3) if answered else None,
    }
    record["dropped_requests"] = int(dropped)
    ok = not errors and dropped == 0
    record["ok"] = bool(ok)
    record["seconds"] = round(time.perf_counter() - t0, 3)
    print(json.dumps(record), flush=True)
    b = record["bench"]
    print(
        f"# fleet: {a.hosts} host process(es), {b['requests']}/{n} "
        f"requests answered, p50 {b['p50_ms']}ms, p99 {b['p99_ms']}ms"
    )
    for h in record["fleet"]["hosts"]:
        print(
            f"# host {h['endpoint']}: alive={h['alive']} "
            f"requests={h['requests']} reissued={h['reissued']}"
        )
    if a.kill_host is not None:
        print(
            f"# host-loss: killed host {a.kill_host} at "
            f"{record.get('killed_at_answered')} answered, reanchor wall "
            f"{record.get('reanchor_wall_s')}s, {dropped} dropped"
        )
    fo = record.get("fleet_obs")
    if fo:
        print(
            f"# fleet-obs: {fo['alive']}/{a.hosts} member(s) up, fleet "
            f"p99 {fo['fleet_p99_ms']}ms from pooled "
            f"{fo['pooled_metric']} windows, "
            f"member_lost={fo['obs_member_lost']}"
        )
    for err in errors:
        print(f"# ERROR {err}")
    return 0 if ok else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser("serve_bench")
    p.add_argument(
        "--shapes", default="16,64",
        help="comma-separated request shapes (16 or 32x32x3)",
    )
    p.add_argument("--clients", type=int, default=None,
                   help="default: 4 in-process, 2 wire processes")
    p.add_argument("--requests", type=int, default=64,
                   help="requests per client")
    p.add_argument("--wire", action="store_true",
                   help="bind a socket server and drive it from separate "
                   "client processes")
    p.add_argument("--port", type=int, default=0,
                   help="wire port (0 = ephemeral)")
    p.add_argument("--shift", action="store_true",
                   help="with --wire: replay a shape-mix shift (warm add "
                   "+ retire over a live socket)")
    p.add_argument(
        "--kill-device", type=int, default=None, metavar="N",
        help="elastic drill: anchor the engines on a mesh over "
        "parallel.mesh.default_devices(), then mid-run 'lose' device N — the "
        "router must re-anchor every engine onto the surviving mesh with zero "
        "request loss; the record carries reshard_wall_s and "
        "requests_in_flight_across_swap",
    )
    p.add_argument(
        "--numerics", action="store_true",
        help="turn the numerics observatory on for the run "
        "(KEYSTONE_NUMERICS equivalent): per-bucket output probes + drift "
        "verdicts land in the record's router/numerics sections",
    )
    p.add_argument(
        "--hosts", type=int, default=None, metavar="N",
        help="multi-host fleet bench: spawn N serve-host "
        "worker PROCESSES and drive the stream through a HostFleet; "
        "degrades to a no-op record where process spawn is unavailable",
    )
    p.add_argument(
        "--kill-host", type=int, default=None, metavar="R",
        help="with --hosts: SIGKILL worker rank R mid-flight — survivors "
        "re-form the group and re-anchor while the fleet reissues; zero "
        "lost requests or exit 1",
    )
    p.add_argument(
        "--collect", action="store_true",
        help="with --hosts: attach a fleet collector scraping "
        "the workers over the obs wire frames — the record gains "
        "fleet_obs: the merged fleet statusz plus the fleet p99 from "
        "pooled latency windows (never averaged percentiles)",
    )
    p.add_argument(
        "--drift-refit", action="store_true",
        help="closed-lifecycle drill: trip the drift monitor "
        "with a shifted mix, warm-refit, validate, hot-swap with requests "
        "in flight — zero dropped requests or exit 1",
    )
    p.add_argument("--timeout", type=float, default=120.0)
    p.add_argument(
        "--device", default="cuda", help="'cuda' (default; raises without a card) or 'cpu'"
    )
    a = p.parse_args(argv)

    if a.drift_refit:
        return run_drift_refit(a)
    if a.kill_host is not None and a.hosts is None:
        p.error("--kill-host requires --hosts")
    if a.collect and a.hosts is None:
        p.error("--collect requires --hosts")
    if a.hosts is not None:
        if a.hosts < 2:
            p.error("--hosts must be >= 2 (a fleet)")
        return run_hosts(a)

    from ..core import frontend, numerics as knum, trace, wire
    from ..utils.platform import resolve_device

    device = resolve_device(a.device)
    shapes = parse_shapes(a.shapes)
    cfg = frontend.RouterConfig.from_env(warm_threshold=2, min_engines=1)
    record: dict = {
        "metric": "serve_bench",
        "wire": bool(a.wire),
        "shapes": [list(s) for s in shapes],
        "requests_per_client": a.requests,
    }
    clients = a.clients or (2 if a.wire else 4)
    expected_requests = clients * a.requests

    def factory(shape, dtype):
        return toy_engine(shape, dtype, device=device)

    surviving = None
    if a.kill_device is not None:
        from ..parallel.mesh import default_devices, make_mesh, mesh_desc

        devs = list(default_devices())
        if any(d.type != device.type for d in devs):
            p.error(
                f"--kill-device: the mesh's devices ({sorted({str(d) for d in devs})}) "
                f"are not of --device {a.device}'s kind"
            )
        if not 0 <= a.kill_device < len(devs):
            p.error(
                f"--kill-device {a.kill_device}: have {len(devs)} device(s)"
            )
        survivor_devs = [
            d for i, d in enumerate(devs) if i != a.kill_device
        ]
        if not survivor_devs:
            p.error("--kill-device would leave no surviving device")
        full = make_mesh(data=len(devs), model=1, devices=devs)
        surviving = make_mesh(
            data=len(survivor_devs), model=1, devices=survivor_devs
        )
        factory = frontend.MeshEngineFactory(
            lambda shape, dtype, mesh: toy_engine(shape, dtype, mesh=mesh, device=device),
            mesh=full,
        )
        record["mesh"] = mesh_desc(full)

    t0 = time.perf_counter()
    router = frontend.ShapeRouter(
        factory, label="serve_bench", config=cfg
    )
    reshard_info: dict = {}

    def _reanchor_drill():
        # Wait for real traffic so the swap demonstrably lands with
        # requests in flight, then lose the device.
        end = time.monotonic() + a.timeout
        target = max(1, expected_requests // 4)
        while router.stats.routes < target and time.monotonic() < end:
            time.sleep(0.005)
        with router._lock:
            entries = list(router._engines.values())
        answered = sum(e.server.stats.answered for e in entries)
        inflight = max(0, router.stats.routes - answered)
        rec = router.reanchor(
            surviving, why=f"--kill-device {a.kill_device}"
        )
        reshard_info.update(
            killed_device=a.kill_device,
            surviving_mesh=mesh_desc(surviving),
            reshard_wall_s=rec["reshard_wall_s"],
            requests_in_flight_across_swap=int(inflight),
            swapped=len(rec["swapped"]),
            failed=rec["failed"],
        )

    numerics_ctx = knum.monitored(True) if a.numerics else contextlib.nullcontext()
    try:
        with numerics_ctx:
            for shape in shapes:
                router.add_engine(factory(shape, np.dtype(np.float32)))
            record["engine_build_seconds"] = round(time.perf_counter() - t0, 3)
            drill = None
            if a.kill_device is not None:
                drill = threading.Thread(
                    target=_reanchor_drill, name="serve-bench-kill", daemon=True
                )
                drill.start()
            if a.wire:
                with wire.WireServer(
                    router, port=a.port, label="serve_bench"
                ) as ws:
                    bench = run_wire(
                        ws, shapes, clients, a.requests, a.timeout
                    )
                    if a.shift:
                        record["shift"] = run_shift(router, ws, shapes, a.timeout)
                    record["wire_server"] = ws.record()
                record["bench"] = bench
                record["wire_p99_ms"] = bench["wire_p99_ms"]
                ok = not bench["errors"] and bench["requests"] == expected_requests
                if a.shift:
                    sh = record["shift"]
                    ok = ok and "error" not in sh and sh["lost_requests"] == 0 \
                        and sh["warm_adds"] >= 1 and sh["retires"] >= 1
            else:
                bench = run_inproc(
                    router, shapes, clients, a.requests, a.timeout
                )
                record["bench"] = bench
                ok = not bench["errors"] and bench["requests"] == expected_requests
            if drill is not None:
                drill.join(a.timeout)
                dropped = expected_requests - bench["requests"]
                reshard_info["reanchor_dropped_requests"] = int(dropped)
                record["reshard"] = reshard_info
                # Top-level copies for the regression observatory's dotted
                # paths (tools/bench_diff.py): reshard wall must not creep,
                # dropped requests must stay 0.
                record["reshard_wall_s"] = reshard_info.get("reshard_wall_s")
                record["reanchor_dropped_requests"] = int(dropped)
                ok = (
                    ok
                    and "reshard_wall_s" in reshard_info
                    and not reshard_info.get("failed")
                    and dropped == 0
                )
            snap = trace.metrics.snapshot()
            overhead = snap["histograms"].get("router_route_overhead_us", {})
            record["router_route_overhead_us"] = {
                k: round(overhead[k], 3)
                for k in ("mean", "p50", "p99")
                if k in overhead
            }
            record["router"] = router.record()
            if a.numerics:
                # The observatory's view of the benched traffic: per-site
                # output stats + any drift verdicts.
                record["numerics"] = knum.snapshot()
    finally:
        router.close()
    record["ok"] = bool(ok)
    record["seconds"] = round(time.perf_counter() - t0, 3)
    print(json.dumps(record), flush=True)
    b = record.get("bench", {})
    for key, row in sorted(b.get("per_shape", {}).items()):
        print(
            f"# shape {key}: {row['requests']} requests, p50 "
            f"{row['p50_ms']}ms, p99 {row['p99_ms']}ms"
        )
    stats = record["router"]["stats"]
    print(
        f"# router: {len(record['router']['engines'])} engine(s), "
        f"{stats['routes']} routed, {stats['warm_adds']} warm add(s), "
        f"{stats['retires']} retire(s), {stats['rejected']} pushback(s)"
    )
    if a.wire:
        print(
            f"# wire: {b.get('requests')} requests from "
            f"{b.get('clients')} client process(es), p99 "
            f"{b.get('wire_p99_ms')}ms, "
            f"{b.get('retry_after_total')} retry-after"
        )
    if record.get("reshard"):
        rs = record["reshard"]
        print(
            f"# reshard: killed device {rs.get('killed_device')}, "
            f"surviving mesh {rs.get('surviving_mesh')}, wall "
            f"{rs.get('reshard_wall_s')}s, "
            f"{rs.get('requests_in_flight_across_swap')} in flight across "
            f"the swap, {rs.get('reanchor_dropped_requests')} dropped"
        )
    for err in b.get("errors", []):
        print(f"# ERROR {err}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
