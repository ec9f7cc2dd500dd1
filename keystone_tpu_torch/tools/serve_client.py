"""Wire-protocol client for the port's serving front-end (``core.wire``),
and the client process ``keystone_tpu_torch.tools.serve_bench --wire``
spawns (counterpart of ``tools/serve_client.py``).

Connects to a live :class:`~keystone_tpu_torch.core.wire.WireServer` (or
any server speaking the same frames, the JAX package's included), drives a
seeded request stream with a bounded pipeline window, honours RETRY_AFTER
backpressure (sleep the hint, resubmit — the retried request keeps its
ORIGINAL submit timestamp, so reported latency includes the pushback), and
reports per-request latency percentiles.

The process imports no torch (``core.wire``'s client half and
``core.trace`` are torch-free), so a client on the card's host creates no
CUDA context and never competes with the server for the card.

The first stdout line is a machine-readable JSON record; human-readable
lines follow.

Usage:
    python -m keystone_tpu_torch.tools.serve_client --port 9123 --shape 16 --requests 64
    python -m keystone_tpu_torch.tools.serve_client --shape 32x32x3 --requests 16  # env port
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def parse_shape(raw: str) -> tuple:
    """``16`` / ``32x32x3`` / ``scalar`` -> a shape tuple."""
    raw = raw.strip()
    if raw in ("", "scalar"):
        return ()
    return tuple(int(tok) for tok in raw.replace(",", "x").split("x") if tok)


def _percentile(sorted_ms, q):
    if not sorted_ms:
        return 0.0
    return float(sorted_ms[min(len(sorted_ms) - 1, int(q * len(sorted_ms)))])


def drive(client, requests, window: int, timeout: float,
          traced: bool = False, trace_context: bool | None = None) -> dict:
    """Pipelined open-loop drive with per-request latency accounting:
    ``window`` outstanding wire requests; RETRY_AFTER resubmits keep the
    original submit time (backpressure IS latency the client felt).

    ``traced=True`` emits the client's own trace events (``client.submit``
    / ``client.answer`` instants keyed by wire rid), the client half that
    ``tools/trace_view.py --stitch`` joins with the server trace.
    ``trace_context`` additionally sends each request as a
    T_REQUEST_TRACED frame carrying the client span id; pass False against
    a server that answered the clock handshake with an ERROR."""
    if trace_context is None:
        trace_context = traced
    from ..core import trace as ktrace
    from ..core import wire

    n = len(requests)
    t_submit: dict[int, tuple[int, float]] = {}  # rid -> (index, t0)
    latencies = [0.0] * n
    retries = 0
    done = 0
    next_i = 0
    t_start = time.perf_counter()
    end = t_start + timeout
    while done < n:
        if time.perf_counter() >= end:
            raise TimeoutError(f"{done}/{n} answered within {timeout}s")
        while next_i < n and len(t_submit) < max(1, window):
            rid = client.submit(
                requests[next_i],
                client_span=next_i if trace_context else None,
            )
            if traced:
                ktrace.instant("client.submit", rid=rid, span=next_i)
            t_submit[rid] = (next_i, time.perf_counter())
            next_i += 1
        reply = client.read()
        if reply.type == wire.T_RESPONSE:
            idx, t0 = t_submit.pop(reply.request_id)
            latencies[idx] = (time.perf_counter() - t0) * 1e3
            if traced:
                ktrace.instant(
                    "client.answer", rid=reply.request_id, span=idx,
                    ms=round(latencies[idx], 3),
                )
            done += 1
        elif reply.type == wire.T_RETRY_AFTER:
            idx, t0 = t_submit.pop(reply.request_id)
            retries += 1
            time.sleep(min(max(reply.retry_after_s or 0.0, 0.0), 1.0))
            rid = client.submit(
                requests[idx], client_span=idx if trace_context else None
            )
            if traced:
                ktrace.instant("client.submit", rid=rid, span=idx, retry=True)
            t_submit[rid] = (idx, t0)  # latency spans the pushback too
        elif reply.type == wire.T_ERROR:
            raise wire.WireRemoteError(reply.etype, reply.message or "")
    wall = time.perf_counter() - t_start
    lat = sorted(latencies)
    # Raw latencies for the merger (serve_bench --wire): exact cross-client
    # percentiles when the run fits the cap; beyond it an even-stride sample
    # of the sorted list that keeps the max (a prefix would ship only the
    # fastest requests and bias the pooled p99 low).
    cap = 2048
    if len(lat) <= cap:
        sampled = lat
    else:
        stride = -(-len(lat) // cap)  # ceil div
        sampled = lat[::stride]
        if sampled[-1] != lat[-1]:
            sampled.append(lat[-1])
    return {
        "requests": n,
        "wall_seconds": round(wall, 4),
        "qps": round(n / wall, 2) if wall > 0 else 0.0,
        "p50_ms": round(_percentile(lat, 0.50), 3),
        "p99_ms": round(_percentile(lat, 0.99), 3),
        "max_ms": round(lat[-1], 3) if lat else 0.0,
        "retry_after": retries,
        "latencies_ms": [round(v, 3) for v in sampled],
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser("serve_client")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument(
        "--port", type=int, default=None,
        help="wire server port (default: KEYSTONE_WIRE_PORT)",
    )
    p.add_argument(
        "--shape", default="16",
        help="request shape: 16, 32x32x3, or 'scalar'",
    )
    p.add_argument("--dtype", default="float32")
    p.add_argument("--requests", type=int, default=64)
    p.add_argument("--window", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--timeout", type=float, default=120.0)
    p.add_argument(
        "--trace", default=None, metavar="OUT.jsonl",
        help="write the client's own JSONL trace (client.submit/"
        "client.answer instants + the clock-offset handshake) for "
        "tools/trace_view.py --stitch",
    )
    a = p.parse_args(argv)

    from ..core import trace as ktrace
    from ..core.wire import WireClient

    shape = parse_shape(a.shape)
    rng = np.random.default_rng(a.seed)
    requests = rng.standard_normal((a.requests, *shape)).astype(a.dtype)

    clock = None
    if a.trace:
        ktrace.enable(a.trace)
    with WireClient(a.host, a.port, timeout=a.timeout) as client:
        connected = time.time()
        rtt = client.ping()
        if a.trace:
            # The clock-offset handshake comes before the load: its offset
            # event places server spans on the client's timeline.
            clock = client.clock_sync()
            ktrace.instant(
                "client.clock",
                **(clock if clock is not None else {"unsupported": True}),
            )
        record = drive(
            client, list(requests), a.window, a.timeout,
            traced=bool(a.trace),
            # A server that answered the T_CLOCK probe with an ERROR would
            # do the same to every T_REQUEST_TRACED: plain REQUESTs then,
            # the client-side trace kept.
            trace_context=bool(a.trace) and clock is not None,
        )
    if a.trace:
        ktrace.flush()
        ktrace.disable()
        record["trace"] = a.trace
        record["clock_offset_us"] = (
            clock.get("offset_us") if clock else None
        )
    record.update(
        metric="serve_client",
        host=a.host,
        port=a.port,
        shape=list(shape),
        dtype=a.dtype,
        seed=a.seed,
        window=a.window,
        ping_ms=round(rtt * 1e3, 3),
        # The wall clock at the connected socket: a spawner subtracts its
        # spawn time for the client's start-up.
        connected_unix_s=connected,
    )
    # The machine-readable record first, flushed.
    print(json.dumps(record), flush=True)
    print(
        f"# serve_client pid {os.getpid()}: {record['requests']} requests "
        f"shape {a.shape} -> p50 {record['p50_ms']}ms, p99 "
        f"{record['p99_ms']}ms, {record['qps']} QPS, "
        f"{record['retry_after']} retry-after"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
