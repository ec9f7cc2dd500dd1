"""Shared serving glue for the workload CLIs (counterpart of
keystone_tpu/workloads/serve_common.py): ``--serve`` / ``--serveBench``.

Every workload that checkpoints a fitted SERVABLE chain wires the same two
modes through here:

* ``--serve`` — warm-load the ``--pipelineFile`` artifact into a
  :class:`~..core.serve.ServingEngine` (cold start measured: restore, the
  per-bucket CUDA-graph captures, warmup), register it with a
  :class:`~..core.frontend.ShapeRouter`, answer every request through the
  routed online path, and assert the answers equal the offline
  ``pipeline(x)`` (or, with parity unverified, the engine's own bucketed
  apply).
* ``--serveBench`` — the SLO bench: concurrent synthetic clients with
  pipelined depth drive the same endpoint; p50/p99 latency, sustained QPS,
  batcher occupancy and the batched-vs-unbatched QPS ratio land in
  ``results["serving"]``.

Bucket and deadline knobs come from the ``KEYSTONE_SERVE_*`` env
(``core.serve``); the CLI adds the client side only (``--serveClients`` /
``--serveRequests``).  ``--serveMesh DxM`` serves on a mesh of the
``--device`` kind's devices: the artifact restores through
``load_pipeline(mesh=)`` and every bucket runs on the mesh's slots.
"""

from __future__ import annotations

import logging
import time

import numpy as np

_logger = logging.getLogger("keystone_tpu_torch.workloads.serve")


def add_serve_args(p) -> None:
    """The serving flag block every servable workload CLI shares."""
    p.add_argument(
        "--serve",
        action="store_true",
        help="warm-load --pipelineFile into a serving endpoint "
        "(core.serve: per-bucket CUDA graphs + dynamic request batcher), "
        "answer the test split through it, and assert served predictions "
        "equal the offline apply",
    )
    p.add_argument(
        "--serveBench",
        action="store_true",
        help="the serving SLO bench: concurrent synthetic clients drive "
        "the warm endpoint; reports p50/p99 latency, sustained QPS, "
        "batcher occupancy, and batched-vs-unbatched QPS "
        "(KEYSTONE_SERVE_* env sets buckets / max wait)",
    )
    p.add_argument(
        "--serveClients",
        type=int,
        default=4,
        help="concurrent synthetic clients for --serve/--serveBench",
    )
    p.add_argument(
        "--serveRequests",
        type=int,
        default=256,
        help="max requests drawn from the test split for --serve/--serveBench",
    )
    p.add_argument(
        "--serveMesh",
        default=None,
        metavar="DxM",
        help="serve on a device mesh, e.g. 2x1, over the --device kind's devices: the "
        "checkpoint reshards onto it (whatever topology it recorded) and every bucket "
        "runs on its slots",
    )


def resolve_serve_mesh(spec: str | None, device="cuda"):
    """``--serveMesh DxM`` -> a ``Mesh`` over the first D*M distinct devices
    of the ``--device`` kind, as ``parallel.mesh.parse_mesh`` takes them
    (one CPU, or the cards); ``None`` passes through."""
    if spec is None:
        return None
    from ..parallel.mesh import kind_devices, make_mesh

    try:
        data, model = (int(s) for s in spec.lower().split("x"))
        if data < 1 or model < 1:
            raise ValueError
    except ValueError:
        raise ValueError(f"--serveMesh {spec!r}: expected DxM with positive sizes "
                         "(e.g. 2x1)") from None
    devs = kind_devices(device)
    if data * model > len(devs):
        raise ValueError(
            f"--serveMesh {spec}: needs {data * model} devices but this "
            f"process has {len(devs)}"
        )
    return make_mesh(data=data, model=model, devices=devs[: data * model])


def check_serve_args(a) -> None:
    """Before any data is read: ``--serve``/``--serveBench`` need
    ``--pipelineFile``, and their ``--serveMesh`` must fit the devices."""
    if a.serve or a.serveBench:
        require_pipeline_file(a.pipelineFile)
        resolve_serve_mesh(a.serveMesh, a.device)


def require_pipeline_file(pipeline_file: str | None) -> None:
    if pipeline_file is None:
        raise ValueError(
            "--serve/--serveBench need --pipelineFile — the endpoint "
            "warm-loads the fitted artifact, it never refits"
        )


def serve_fitted(
    pipeline_file: str,
    example,
    requests: np.ndarray,
    *,
    label: str,
    wrap=None,
    bench: bool = False,
    clients: int = 4,
    timeout: float = 120.0,
    device="cuda",
    mesh=None,
    log=None,
) -> dict:
    """Warm-load the fitted pipeline onto ``device`` (or the slots of
    ``mesh``, from ``--serveMesh``) and serve ``requests`` through the
    online path; returns the JSON-able serving record (cold start + engine
    summary + either the routed answers' record or the SLO bench)."""
    from ..core import frontend as kfrontend
    from ..core import serve as kserve

    lg = log or _logger
    requests = np.asarray(requests)
    engine, cold = kserve.load_engine(
        pipeline_file, example, label=label, wrap=wrap, device=device, mesh=mesh
    )
    record: dict = {"cold_start": cold}
    lg.info(
        "%s: serving cold start %.3fs (restore %.3fs, build+capture %.3fs, "
        "warmup %.3fs); live buckets %s%s",
        label,
        cold["cold_start_seconds"],
        cold["checkpoint_load_seconds"],
        cold["compile_seconds"],
        cold["warmup_seconds"],
        list(engine.buckets()),
        f"; mesh {cold['mesh']}" if mesh is not None else "",
    )
    if bench:
        record["bench"] = kserve.serve_bench(
            engine, requests, clients=clients, timeout=timeout
        )
        b = record["bench"]
        lg.info(
            "%s: SLO bench — %s requests via %s clients: p50 %.2fms, "
            "p99 %.2fms, %.1f QPS (unbatched %.1f, x%.2f), occupancy "
            "%.2f, bit_identical=%s",
            label, b["requests"], b["clients"], b["p50_latency_ms"],
            b["p99_latency_ms"], b["qps"], b.get("unbatched_qps", 0.0),
            b.get("batched_vs_unbatched_qps", 0.0),
            b["batcher"]["mean_occupancy"], b["predictions_bit_identical"],
        )
    else:
        offline = engine.offline(requests)
        t0 = time.perf_counter()
        # The single-engine demo rides the same front-end tier a
        # multi-shape deployment uses: routed by shape, with router stats.
        with kfrontend.ShapeRouter(label=f"{label}_router", mesh=mesh) as router:
            key = router.add_engine(engine)
            server = router.server_for(key)
            futs = [router.submit(r) for r in requests]
            answers = np.stack([f.result(timeout) for f in futs])
            lat_ms = sorted(f.latency_seconds() * 1e3 for f in futs)
            stats = server.stats.record()
            slo = server.slo.summary()
            router_record = router.record()
        wall = time.perf_counter() - t0
        record["served"] = {
            "requests": int(requests.shape[0]),
            "qps": round(requests.shape[0] / wall, 2),
            "p50_latency_ms": round(kserve._percentile(lat_ms, 0.50), 3),
            "p99_latency_ms": round(kserve._percentile(lat_ms, 0.99), 3),
            "batcher": stats,
            "phase_breakdown": kserve.phase_breakdown(
                [f.phases for f in futs if f.phases is not None]
            ),
            "router": router_record,
            "slo": slo,
            "predictions_bit_identical": bool(
                np.array_equal(answers, offline)
            ),
        }
        s = record["served"]
        if not engine.parity_ok:
            # Parity unverified at warmup (serve_parity_unverified): the bar
            # is determinism against the engine's own bucketed apply.
            s["parity_unverified"] = True
            s["predictions_deterministic"] = bool(
                np.array_equal(answers, engine.infer(requests))
            )
        lg.info(
            "%s: served %d requests, p50 %.2fms / p99 %.2fms, %.1f QPS, "
            "bit_identical=%s%s",
            label, s["requests"], s["p50_latency_ms"], s["p99_latency_ms"],
            s["qps"], s["predictions_bit_identical"],
            (
                f" (parity unverified; deterministic="
                f"{s['predictions_deterministic']})"
                if not engine.parity_ok
                else ""
            ),
        )
        healthy = s["predictions_bit_identical"] or (
            not engine.parity_ok and s["predictions_deterministic"]
        )
        if not healthy:
            raise AssertionError(
                f"{label}: served predictions differ from the offline "
                "pipeline(x) apply — refusing to report a healthy endpoint"
            )
    record["engine"] = engine.record()
    return record
