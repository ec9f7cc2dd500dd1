"""Seeded end-to-end chaos runner on the port (counterpart of
``tools/chaos_run.py``; the command-line face of
:mod:`keystone_tpu_torch.testing.chaos`).

Runs deterministic fault schedules — injected out-of-memory errors in the
solver and the serving buckets, flaky tar opens, corrupt members, NaN
batches, preemption and resume, hung solves and decode threads, corrupt
snapshots, killed decode workers, misbehaving clients, lost device slots
and hosts, drift and refits — against a real workload pipeline, and holds
every run to the chaos invariant: complete with predictions equal to the
fault-free run, or fail with a typed, counted, logged error.

Usage:
    python -m keystone_tpu_torch.tools.chaos_run --seed 3          # one schedule
    python -m keystone_tpu_torch.tools.chaos_run                   # the tier-1 seeds
    python -m keystone_tpu_torch.tools.chaos_run --full            # the full seed set
    python -m keystone_tpu_torch.tools.chaos_run --workload cifar  # RandomPatchCifar
    python -m keystone_tpu_torch.tools.chaos_run --stream          # streaming families
    python -m keystone_tpu_torch.tools.chaos_run --serve           # serving families
    python -m keystone_tpu_torch.tools.chaos_run --hosts 3         # host_loss fleet size
    python -m keystone_tpu_torch.tools.chaos_run --trace DIR       # one trace per schedule
    python -m keystone_tpu_torch.tools.chaos_run --device cpu      # on the CPU

Every schedule runs on the CUDA card unless ``--device cpu`` is given, and
the tool raises where there is no card.  ``--trace DIR`` writes a Chrome
trace per schedule and adds the observability invariant: every counted
fault appears in its schedule's trace as a ``fault`` instant with its
``kind``, and a typed error as a failed span or a fault event.

The first stdout line is the JSON record (the JAX tool's keys); ``#``
summary lines follow.  Exit 0 when every schedule holds, 1 on any
violation or when no schedule matches the selection, 2 for ``--hosts``
below 2.  This module imports no torch at its top: the ``decode_worker_kill``
family spawns decode workers, and a spawned worker re-imports the main
module.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

#: The streaming-ingest families ``--stream`` selects besides ``stream_*``.
STREAM_FAMILIES = ("autotune_thrash", "snapshot_corrupt", "decode_worker_kill",
                   "jpeg_corrupt_entropy", "native_entropy")


def select_seeds(chaos, seed: int | None, full: bool, stream: bool, serve: bool) -> tuple:
    """The schedules a run takes, by the JAX tool's rule: ``--seed`` alone,
    else the full or tier-1 set; ``--stream``/``--serve`` filter the FULL
    set (or the one ``--seed``) down to their families."""
    if seed is not None:
        seeds = (seed,)
    else:
        seeds = chaos.FULL_SEEDS if full else chaos.TIER1_SEEDS
    if not (stream or serve):
        return seeds

    def selected(s: int) -> bool:
        kind = chaos.make_schedule(s).kind
        if stream and (kind.startswith("stream_") or kind in STREAM_FAMILIES):
            return True
        return serve and kind in chaos.SERVE_FAMILIES

    return tuple(s for s in (chaos.FULL_SEEDS if seed is None else seeds) if selected(s))


def main(argv=None) -> int:
    p = argparse.ArgumentParser("chaos_run")
    p.add_argument("--seed", type=int, default=None, help="run ONE schedule")
    p.add_argument("--full", action="store_true",
                   help="run the full seed set instead of the tier-1 subset")
    p.add_argument("--stream", action="store_true",
                   help="run only the streaming-ingest fault schedules (stream_corrupt / "
                   "stream_hang / autotune_thrash / snapshot_corrupt / decode_worker_kill / "
                   "jpeg_corrupt_entropy / native_entropy)")
    p.add_argument("--serve", action="store_true",
                   help="run only the serving fault schedules (slow_client / "
                   "malformed_request / serve_burst_oom / wire_disconnect / slow_loris / "
                   "output_drift)")
    p.add_argument("--workload", default="mnist", choices=("mnist", "cifar"))
    p.add_argument("--hosts", type=int, default=None, metavar="N",
                   help="size of the serving fleet the host_loss and obs_capture families "
                   "spawn (default 2) — sets KEYSTONE_CHAOS_HOSTS for the drills")
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="write a Chrome trace per schedule into DIR and assert every "
                   "injected fault appears in it as a counted event")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    a = p.parse_args(argv)

    if a.hosts is not None:
        if a.hosts < 2:
            print("--hosts must be >= 2 (one host must die)", file=sys.stderr)
            return 2
        os.environ["KEYSTONE_CHAOS_HOSTS"] = str(a.hosts)

    # Hermetic placement search: the plan_mispredict oracle and every
    # bit-equality judge assume the cold search ranking, and the harness's
    # synthetic fits must not train the operator's log.
    from ..core.autoshard import hermetic_plan_log
    from ..utils.platform import resolve_device

    hermetic_plan_log()
    device = str(resolve_device(a.device))

    from ..testing import chaos

    seeds = select_seeds(chaos, a.seed, a.full, a.stream, a.serve)
    if not seeds:
        print("no matching schedules in the selected seed set")
        return 1
    if a.trace is not None:
        os.makedirs(a.trace, exist_ok=True)
        if os.environ.get("KEYSTONE_TRACE", "").strip():
            print("# WARNING: --trace overrides KEYSTONE_TRACE: per-schedule traces reset "
                  "the buffer, so the env-configured session trace will not be written",
                  file=sys.stderr)
    results = chaos.run_suite(seeds, workload=a.workload, trace_dir=a.trace, device=device)
    trace_violations: dict[int, list] = {}
    if a.trace is not None:
        for r in results:
            missing = (chaos.verify_trace(r.trace_path, r) if r.trace_path is not None
                       else ["schedule produced no trace file"])
            if missing:
                trace_violations[r.seed] = missing

    def bad(r) -> bool:
        return (not r.ok() or r.outcome != chaos.expected_outcome(r.fault)
                or r.seed in trace_violations)

    violations = [r for r in results if bad(r)]
    outcomes: dict = {}
    for r in results:
        outcomes[r.outcome] = outcomes.get(r.outcome, 0) + 1
    record = {
        "metric": "chaos",
        "workload": a.workload,
        "seeds": list(seeds),
        "ok": not violations,
        "outcomes": outcomes,
        "results": [r.record() for r in results],
    }
    if a.trace is not None:
        record["trace"] = {
            "dir": a.trace,
            "violations": {str(s): v for s, v in sorted(trace_violations.items())},
        }
    print(json.dumps(record), flush=True)
    for r in results:
        print(f"# {'BAD' if bad(r) else 'ok '} seed={r.seed} {r.fault.kind}: {r.outcome}"
              + (f" ({r.error_type})" if r.error_type else "")
              + f" [{r.seconds:.2f}s]"
              + (f" TRACE: {'; '.join(trace_violations[r.seed])}"
                 if r.seed in trace_violations else ""))
    print(f"# chaos: {len(results) - len(violations)}/{len(results)} schedules honored the "
          "invariant")
    return 1 if violations else 0


if __name__ == "__main__":
    sys.exit(main())
