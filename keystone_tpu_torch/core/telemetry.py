"""Production telemetry tier (counterpart of keystone_tpu/core/telemetry.py):
the live SLO surface, Prometheus exposition of the metrics registry, and
the flight-recorder postmortem dump.

* :class:`SLOTracker` — rolling-window p50/p99/QPS and **error-budget burn
  rate** per serving engine, judged against configurable targets
  (``KEYSTONE_SERVE_SLO_MS`` — one number, or ``label=ms`` pairs;
  ``KEYSTONE_SERVE_SLO_BUDGET`` — the allowed violation fraction).  A burn
  rate of 1.0 means the endpoint is spending its error budget exactly as
  fast as the budget allows; > 1.0 is an SLO page.  Trackers register into
  ``trace.metrics`` as the adopted ``slo`` group, so ONE
  ``metrics.snapshot()`` carries perf counters, the fault ledger, AND the
  SLO surface.
* :func:`prometheus_text` — the full registry snapshot rendered in
  Prometheus text exposition format (counters, gauges, histograms as
  summaries with quantile labels, adopted groups flattened).  Exported by
  a periodic atomic file writer (``KEYSTONE_METRICS_FILE``, interval
  ``KEYSTONE_METRICS_INTERVAL_S``) and/or a tiny in-process HTTP endpoint
  (``KEYSTONE_METRICS_PORT``; ``/metrics``) — both env-activated at
  import, both daemon threads, neither touching torch.
* :func:`maybe_postmortem` — the flight-recorder dump: when a typed fault
  of a :data:`POSTMORTEM_KINDS` family is counted
  (``resilience.counters.record`` calls through here) and
  ``KEYSTONE_POSTMORTEM_DIR`` is set, the recent-event ring
  (``trace.flight_events()`` — running even with tracing disabled), an
  atomic metrics snapshot, and the triggering fault are dumped as ONE
  schema-tagged JSON file, atomically.  Capped per kind per process so a
  fault storm cannot fill a disk.

An SLO burn-rate breach and every postmortem-family fault also open one
bounded device-capture window (``core.profiler.maybe_capture``; a no-op
without ``KEYSTONE_XPROF_DIR``, capped per kind per process), and a dump
lists the capture windows the process opened (``xprof_captures``).

Never on the fit/serve hot path: the SLO observe is one deque append under
a lock, the postmortem check is one set lookup + one env read, and
everything heavier runs on exporter threads or at fault time.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import re
import threading
import time
from collections import deque

from . import trace

_logger = logging.getLogger("keystone_tpu_torch.telemetry")

SLO_MS_ENV = "KEYSTONE_SERVE_SLO_MS"
SLO_BUDGET_ENV = "KEYSTONE_SERVE_SLO_BUDGET"
SLO_WINDOW_ENV = "KEYSTONE_SERVE_SLO_WINDOW_S"
METRICS_FILE_ENV = "KEYSTONE_METRICS_FILE"
METRICS_PORT_ENV = "KEYSTONE_METRICS_PORT"
METRICS_INTERVAL_ENV = "KEYSTONE_METRICS_INTERVAL_S"
POSTMORTEM_DIR_ENV = "KEYSTONE_POSTMORTEM_DIR"

DEFAULT_SLO_MS = 50.0
DEFAULT_SLO_BUDGET = 0.01  # 1% of requests may violate the SLO
DEFAULT_SLO_WINDOW_S = 60.0
DEFAULT_METRICS_INTERVAL_S = 10.0

#: Fault families that trigger a flight-recorder postmortem dump (the
#: typed faults an operator wants last-moments evidence for): OOM
#: step-downs on both the fit ladders and the serving buckets, watchdog
#: trips, parity failures, and snapshot divergence.
POSTMORTEM_KINDS = frozenset(
    {
        "solver_oom_retry",
        "autoshard_stepdown",
        "deadline_exceeded",
        "serve_burst_oom",
        "serve_batch_failed",
        "serve_parity_unverified",
        "serve_bucket_parity_dropped",
        "snapshot_fallback",
        "nonfinite_model",
        # Numerics: a probe catching non-finite values in a streamed or
        # served batch, and a serving engine's output distribution
        # diverging from its fit-time baseline — both carry their
        # provenance/divergence evidence in the dumped metrics snapshot's
        # "numerics" group.
        "numerics_nonfinite",
        "serve_output_drift",
        # Topology loss: a surviving-mesh re-anchor, a host re-anchor, a
        # fleet member declared dead, a peer that never joined.
        "mesh_reanchor",
        "host_reanchor",
        "fleet_host_lost",
        "dist_join_timeout",
        # Model lifecycle: a refit landing, a candidate refused as worse
        # than the incumbent, a refit cycle dying mid-flight.
        "lifecycle_refit",
        "refit_rejected",
        "refit_failed",
        # Fleet observability: a member unreachable mid-scrape.
        "obs_member_lost",
    }
)

POSTMORTEM_SCHEMA = "keystone.postmortem/1"

#: Per-kind dump cap per process: the FIRST occurrences carry the
#: information; a fault storm repeating one kind must not fill a disk.
MAX_DUMPS_PER_KIND = 3


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        _logger.error("%s=%r is not a number — using %g", name, raw, default)
        return default


def slo_target_ms(label: str) -> float:
    """The latency SLO for ``label`` from ``KEYSTONE_SERVE_SLO_MS``: a bare
    number applies to every engine; ``label=ms`` pairs (comma-separated,
    optional ``default=ms`` entry) set per-engine targets."""
    raw = os.environ.get(SLO_MS_ENV, "").strip()
    if not raw:
        return DEFAULT_SLO_MS
    if "=" not in raw:
        try:
            return float(raw)
        except ValueError:
            _logger.error(
                "%s=%r is not a number — using %g",
                SLO_MS_ENV, raw, DEFAULT_SLO_MS,
            )
            return DEFAULT_SLO_MS
    default = DEFAULT_SLO_MS
    for tok in raw.split(","):
        if "=" not in tok:
            continue
        key, _, val = tok.partition("=")
        try:
            ms = float(val)
        except ValueError:
            _logger.error("%s: ignoring malformed entry %r", SLO_MS_ENV, tok)
            continue
        if key.strip() == label:
            return ms
        if key.strip() == "default":
            default = ms
    return default


class SLOTracker:
    """Rolling-window SLO accounting for one serving engine.

    ``observe(latency_ms, ok)`` is called once per answered (or typed-
    failed) request; :meth:`summary` reports window p50/p99/QPS, the
    violation rate (over-SLO latency or error), and the error-budget burn
    rate (violation rate / budget — 1.0 = burning exactly at budget).
    """

    def __init__(
        self,
        label: str,
        slo_ms: float | None = None,
        budget: float | None = None,
        window_s: float | None = None,
        clock=time.monotonic,
    ):
        self.label = label
        self.slo_ms = slo_ms if slo_ms is not None else slo_target_ms(label)
        self.budget = (
            budget
            if budget is not None
            else _env_float(SLO_BUDGET_ENV, DEFAULT_SLO_BUDGET)
        )
        self.window_s = (
            window_s
            if window_s is not None
            else _env_float(SLO_WINDOW_ENV, DEFAULT_SLO_WINDOW_S)
        )
        self._clock = clock
        self._lock = threading.Lock()
        self._window: deque = deque()  # (t, latency_ms, violation)
        self._window_violations = 0  # running count over the live window
        self.total_requests = 0
        self.total_errors = 0
        self.total_violations = 0

    #: window observations required before a burn-rate breach can fire a
    #: capture — one early violation over a 3-request window is noise,
    #: not a page.
    BURN_CAPTURE_MIN_COUNT = 20

    def observe(self, latency_ms: float, ok: bool = True) -> None:
        if _suspended:
            return
        now = self._clock()
        violation = (not ok) or latency_ms > self.slo_ms
        breach = False
        with self._lock:
            self.total_requests += 1
            if not ok:
                self.total_errors += 1
            if violation:
                self.total_violations += 1
                self._window_violations += 1
            self._window.append((now, float(latency_ms), violation))
            self._prune(now)
            if violation and self.budget > 0:
                count = len(self._window)
                breach = (
                    count >= self.BURN_CAPTURE_MIN_COUNT
                    and (self._window_violations / count) / self.budget > 1.0
                )
        if breach:
            # SLO burn-rate breach: the endpoint is spending its error
            # budget faster than the budget allows — open one bounded
            # device capture window (rate-limited per kind per process).
            from . import profiler

            profiler.maybe_capture(
                "slo_burn", reason=f"engine {self.label} burning error budget"
            )

    def _prune(self, now: float) -> None:
        cutoff = now - self.window_s
        w = self._window
        while w and w[0][0] < cutoff:
            if w.popleft()[2]:
                self._window_violations -= 1

    def summary(self) -> dict:
        """JSON-able SLO surface: rolling-window percentiles/QPS/burn rate
        plus process-lifetime totals."""
        now = self._clock()
        with self._lock:
            self._prune(now)
            window = list(self._window)
            totals = (
                self.total_requests, self.total_errors, self.total_violations
            )
        lat = sorted(v for _, v, _ in window)
        violations = sum(1 for _, _, viol in window if viol)
        count = len(window)

        def pick(q: float) -> float:
            if not lat:
                return 0.0
            return round(lat[min(len(lat) - 1, int(q * len(lat)))], 3)

        span_s = (now - window[0][0]) if count else 0.0
        violation_rate = violations / count if count else 0.0
        total_rate = totals[2] / totals[0] if totals[0] else 0.0
        return {
            "label": self.label,
            "slo_ms": self.slo_ms,
            "budget": self.budget,
            "window_seconds": self.window_s,
            "window": {
                "count": count,
                "qps": round(count / span_s, 2) if span_s > 0 else 0.0,
                "p50_ms": pick(0.50),
                "p99_ms": pick(0.99),
                "max_ms": round(lat[-1], 3) if lat else 0.0,
                "violations": violations,
                "violation_rate": round(violation_rate, 6),
                "burn_rate": round(violation_rate / self.budget, 4)
                if self.budget > 0
                else 0.0,
            },
            "total": {
                "requests": totals[0],
                "errors": totals[1],
                "violations": totals[2],
                "burn_rate": round(total_rate / self.budget, 4)
                if self.budget > 0
                else 0.0,
            },
        }


# -- the per-engine tracker registry (the adopted "slo" metrics group) --------

_slo_lock = threading.Lock()
_slo_trackers: dict[str, SLOTracker] = {}
_suspended = False  # telemetry_disabled(): the off-mode control


def register_slo(label: str, **kwargs) -> SLOTracker:
    """Create a fresh tracker for ``label`` and register it as the live SLO
    surface for that engine (a new Server replaces its predecessor's — the
    exporter shows the CURRENT endpoint, not a dead one's history)."""
    tracker = SLOTracker(label, **kwargs)
    with _slo_lock:
        _slo_trackers[label] = tracker
    return tracker


def unregister_slo(label: str) -> None:
    """Drop ``label``'s tracker from the live SLO surface (a retired
    serving engine must stop being exported — its history belongs to the
    records that captured it, not to every future snapshot)."""
    with _slo_lock:
        _slo_trackers.pop(label, None)


def slo_summaries() -> dict:
    with _slo_lock:
        trackers = list(_slo_trackers.values())
    return {t.label: t.summary() for t in trackers}


class _SLOGroup:
    """Adopted-group adapter: ``metrics.snapshot()`` carries the live SLO
    surface under the ``slo`` key (reset is a no-op — SLO state belongs to
    the trackers, not the registry)."""

    def snapshot(self, reset: bool = False) -> dict:
        return slo_summaries()


trace.metrics.adopt("slo", _SLOGroup())


@contextlib.contextmanager
def telemetry_disabled():
    """Everything this tier adds, OFF: flight ring depth 0 and SLO
    observation suspended — the control arm of a telemetry-overhead
    measurement."""
    global _suspended
    prev_depth = trace.flight_depth()
    prev_susp = _suspended
    trace.set_flight_depth(0)
    _suspended = True
    try:
        yield
    finally:
        trace.set_flight_depth(prev_depth)
        _suspended = prev_susp


# -- the /statusz debug surface ------------------------------------------------

_statusz_lock = threading.Lock()
_statusz_providers: dict[str, object] = {}


def register_statusz(name: str, provider) -> None:
    """Register a live-state provider (a zero-arg callable returning a
    JSON-able dict) under ``name`` on the ``/statusz`` debug page —
    routers register their engine tables, streams their ring state.  A
    new registration under the same name replaces the old (the page shows
    the CURRENT object, not a dead one's history)."""
    with _statusz_lock:
        _statusz_providers[name] = provider


def unregister_statusz(name: str, provider=None) -> None:
    """Drop ``name``'s provider.  Pass the registered ``provider`` back to
    make the removal identity-guarded: if a NEWER object has since
    registered under the same name, the old owner's unregister is a no-op
    instead of evicting the live provider."""
    with _statusz_lock:
        if provider is None or _statusz_providers.get(name) is provider:
            _statusz_providers.pop(name, None)


def statusz_snapshot() -> dict:
    """One JSON snapshot of the process's live operational state: every
    registered provider (router engine tables, ring/stream state), the
    rolling SLO windows, the numerics observatory surface, and the
    metrics registry (fault ledger included).  Served at ``/statusz`` on
    the ``KEYSTONE_METRICS_PORT`` endpoint; also directly callable (the
    golden tests pin the schema).  A provider that raises is reported as
    its error string — one sick subsystem must not blank the page."""
    providers: dict = {}
    with _statusz_lock:
        items = list(_statusz_providers.items())
    for name, provider in items:
        try:
            providers[name] = provider()
        except Exception as e:  # noqa: BLE001 — the page must render
            providers[name] = {"error": f"{type(e).__name__}: {e}"[:200]}
    # Importing numerics (torch-free at import) ensures its adopted metrics group
    # exists, so ONE registry snapshot carries the whole surface — no
    # second numerics.snapshot() pass per GET.
    from . import numerics

    snap = trace.metrics.snapshot()
    return {
        "schema": "keystone.statusz/1",
        "time_unix": time.time(),
        "pid": os.getpid(),
        "providers": providers,
        "slo": snap.get("slo", {}),
        "numerics": snap.get("numerics") or numerics.snapshot(),
        "faults": snap.get("faults", {}),
        "counters": snap.get("counters", {}),
        "gauges": snap.get("gauges", {}),
    }


# -- Prometheus text exposition -----------------------------------------------

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _metric_name(*parts: str) -> str:
    return "keystone_" + "_".join(
        _NAME_RE.sub("_", str(p)) for p in parts if str(p)
    )


def _fmt(value) -> str:
    if isinstance(value, bool):
        return "1" if value else "0"
    if isinstance(value, int):
        return str(value)
    return repr(float(value))


_LABEL_VALUE_RE = re.compile(r'["\\\n]')


def render_labels(labels: dict | None, extra: str = "") -> str:
    """Prometheus label block: ``{host="h0",rank="0"}`` — keys sorted and
    sanitized like metric names, values escaped per the exposition format.
    ``extra`` is a pre-rendered ``key="value"`` pair appended last (the
    histogram quantile label).  Empty labels and empty extra render ``""``."""
    pairs = []
    for k in sorted(labels or {}):
        v = labels[k]
        if v is None:
            continue
        val = _LABEL_VALUE_RE.sub(
            lambda m: {"\\": "\\\\", '"': '\\"', "\n": "\\n"}[m.group()],
            str(v),
        )
        pairs.append(f'{_NAME_RE.sub("_", str(k))}="{val}"')
    if extra:
        pairs.append(extra)
    return "{" + ",".join(pairs) + "}" if pairs else ""


def _flatten(prefix: tuple, obj, out: list) -> None:
    """Numeric leaves of an adopted group's nested snapshot, depth-first,
    as (name_parts, value) — non-numeric leaves are skipped (labels and
    notes have no Prometheus representation)."""
    if isinstance(obj, dict):
        for k in sorted(obj):
            _flatten(prefix + (k,), obj[k], out)
    elif isinstance(obj, (int, float)) and not isinstance(obj, bool):
        out.append((prefix, obj))


def prometheus_text(
    snapshot: dict | None = None, labels: dict | None = None
) -> str:
    """Render a ``trace.metrics`` snapshot (default: a fresh one) in the
    Prometheus text exposition format, deterministically ordered.
    Counters/gauges map 1:1; histograms render as summaries (quantile
    labels + ``_sum``/``_count``); adopted groups flatten to gauges
    (``faults`` to counters) prefixed with the group name.

    ``labels`` (e.g. ``{"host": "h0", "rank": 0}``) attaches the same
    label set to EVERY sample line — the multi-process scrape story
    (core.fleetobs labels each member's exposition ``host=``/``rank=``
    so one fleet page carries N processes without name collisions).
    ``labels=None`` renders byte-identically to the pre-label format
    (golden-pinned)."""
    snap = snapshot if snapshot is not None else trace.metrics.snapshot()
    lbl = render_labels(labels)
    lines: list[str] = []
    for name in sorted(snap.get("counters", {})):
        m = _metric_name(name)
        lines.append(f"# TYPE {m} counter")
        lines.append(f"{m}{lbl} {_fmt(snap['counters'][name])}")
    for name in sorted(snap.get("gauges", {})):
        m = _metric_name(name)
        lines.append(f"# TYPE {m} gauge")
        lines.append(f"{m}{lbl} {_fmt(snap['gauges'][name])}")
    for name in sorted(snap.get("histograms", {})):
        h = snap["histograms"][name]
        m = _metric_name(name)
        lines.append(f"# TYPE {m} summary")
        for q in ("p50", "p90", "p99"):
            if q in h:
                qlbl = render_labels(labels, extra=f'quantile="0.{q[1:]}"')
                lines.append(f"{m}{qlbl} {_fmt(h[q])}")
        count = h.get("count", 0)
        mean = h.get("mean", 0.0)
        lines.append(f"{m}_sum{lbl} {_fmt(mean * count)}")
        lines.append(f"{m}_count{lbl} {_fmt(count)}")
    for group in sorted(snap):
        if group in ("counters", "gauges", "histograms"):
            continue
        flat: list = []
        _flatten((group,), snap[group], flat)
        kind = "counter" if group == "faults" else "gauge"
        for parts, value in flat:
            m = _metric_name(*parts)
            lines.append(f"# TYPE {m} {kind}")
            lines.append(f"{m}{lbl} {_fmt(value)}")
    return "\n".join(lines) + "\n"


def _atomic_write_text(path: str, text: str) -> None:
    trace.atomic_write(path, lambda f: f.write(text))


class MetricsWriter:
    """Periodic atomic writer of :func:`prometheus_text` to a file — the
    node-exporter-textfile-collector integration path (a scraper tails the
    file; no port to open, works inside any sandbox)."""

    def __init__(self, path: str, interval_s: float = DEFAULT_METRICS_INTERVAL_S):
        self.path = path
        self.interval_s = max(0.05, float(interval_s))
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="keystone-metrics-writer", daemon=True
        )

    def start(self) -> "MetricsWriter":
        self.write()  # fail fast on an unwritable destination
        self._thread.start()
        return self

    def write(self) -> None:
        _atomic_write_text(self.path, prometheus_text())

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.write()
            except Exception:  # noqa: BLE001 — the exporter must not die
                _logger.exception("metrics file write failed")

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(self.interval_s + 1.0)
        with contextlib.suppress(Exception):
            self.write()  # final snapshot so the file ends current


def start_metrics_server(port: int):
    """Tiny in-process HTTP endpoint on 127.0.0.1: :func:`prometheus_text`
    at ``/metrics`` (and ``/``), the :func:`statusz_snapshot` JSON debug
    page at ``/statusz``, and a ``/healthz`` liveness probe.  ``port=0``
    binds an ephemeral port (``server.server_address[1]``).  Returns the
    live ``ThreadingHTTPServer`` — call ``.shutdown()`` to stop."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 — http.server API
            route = self.path.split("?")[0]
            if route == "/healthz":
                body = b'{"ok": true}\n'
                ctype = "application/json"
            elif route == "/statusz":
                try:
                    body = json.dumps(statusz_snapshot()).encode()
                except Exception as e:  # noqa: BLE001 — a debug page
                    self.send_error(500, f"{type(e).__name__}: {e}"[:200])
                    return
                ctype = "application/json"
            elif route in ("/", "/metrics"):
                body = prometheus_text().encode()
                ctype = "text/plain; version=0.0.4"
            else:
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):  # noqa: A002
            _logger.debug("metrics http: " + fmt, *args)

    server = ThreadingHTTPServer(("127.0.0.1", int(port)), Handler)
    thread = threading.Thread(
        target=server.serve_forever, name="keystone-metrics-http", daemon=True
    )
    thread.start()
    _logger.info(
        "metrics endpoint on http://127.0.0.1:%d/metrics",
        server.server_address[1],
    )
    return server


# -- flight-recorder postmortem dumps -----------------------------------------

_pm_lock = threading.Lock()
_pm_counts: dict[str, int] = {}
_pm_paths: list[str] = []


def postmortem_paths() -> list[str]:
    """Paths of every postmortem dump this process has written (linked
    from ``FitReport``/``ServerStats`` records)."""
    with _pm_lock:
        return list(_pm_paths)


def maybe_postmortem(kind: str, detail: str | None = None, total: int = 0):
    """Dump a flight-recorder postmortem for fault ``kind`` if it is a
    :data:`POSTMORTEM_KINDS` family, ``KEYSTONE_POSTMORTEM_DIR`` is set,
    and the per-kind cap has room.  Returns the written path or None.

    Called by ``resilience.counters.record`` AFTER its lock is released
    (the metrics snapshot below re-enters the fault ledger's own snapshot);
    never raises — a failing dump must not break the fault path it is
    documenting."""
    if kind not in POSTMORTEM_KINDS:
        return None
    # Any postmortem-family fault also triggers a bounded device capture
    # window (core.profiler; no-op without KEYSTONE_XPROF_DIR, capped per
    # kind per process, never raises) — the device-side evidence next to
    # the flight ring's host-side last moments.
    from . import profiler

    profiler.maybe_capture(kind, reason=(detail or "")[:200])
    dump_dir = os.environ.get(POSTMORTEM_DIR_ENV, "").strip()
    if not dump_dir:
        return None
    try:
        with _pm_lock:
            n = _pm_counts.get(kind, 0)
            if n >= MAX_DUMPS_PER_KIND:
                return None
            _pm_counts[kind] = n + 1
        dump = {
            "schema": POSTMORTEM_SCHEMA,
            "time_unix": time.time(),
            "pid": os.getpid(),
            "fault": {"kind": kind, "detail": detail, "total": total},
            "trace_enabled": trace.enabled(),
            "flight_depth": trace.flight_depth(),
            # The ring: the process's last moments, captured even when
            # tracing was never enabled.
            "flight": trace.flight_events(),
            # One atomic registry snapshot: counters, gauges, histograms,
            # the fault ledger, and the live SLO surface.
            "metrics": trace.metrics.snapshot(),
            # Triggered device capture windows this process opened
            # (core.profiler) — the postmortem links the trace evidence.
            "xprof_captures": profiler.capture_paths(),
        }
        os.makedirs(dump_dir, exist_ok=True)
        path = os.path.join(
            dump_dir, f"postmortem_{_NAME_RE.sub('_', kind)}_{os.getpid()}_{n}.json"
        )
        _atomic_write_text(path, json.dumps(dump))
        with _pm_lock:
            _pm_paths.append(path)
        _logger.warning("postmortem dumped -> %s (fault %s)", path, kind)
        return path
    except Exception:  # noqa: BLE001 — never break the fault path
        _logger.exception("postmortem dump for %r failed", kind)
        return None


def _reset_state() -> None:
    """Test isolation: forget dump caps/paths, SLO trackers, and statusz
    providers."""
    with _pm_lock:
        _pm_counts.clear()
        _pm_paths.clear()
    with _slo_lock:
        _slo_trackers.clear()
    with _statusz_lock:
        _statusz_providers.clear()


# -- env activation -----------------------------------------------------------

_env_writer: MetricsWriter | None = None
_env_server = None


def _is_worker_process() -> bool:
    """Spawned helper processes (the decode workers) inherit the parent's
    env, so without this guard every worker would start its own writer and
    atomically clobber the shared metrics file with a near-empty registry
    (and race to bind the metrics port).  Only the MAIN process exports.
    The process NAME is checked as well as the parent handle because a
    spawn child unpickles its target (importing this module) BEFORE the
    bootstrap sets the parent handle — the name is already set by then."""
    import multiprocessing

    return (
        multiprocessing.parent_process() is not None
        or multiprocessing.current_process().name != "MainProcess"
    )


_raw_file = os.environ.get(METRICS_FILE_ENV, "").strip()
if _raw_file and _is_worker_process():
    _raw_file = ""
if _raw_file:
    try:
        _env_writer = MetricsWriter(
            _raw_file,
            _env_float(METRICS_INTERVAL_ENV, DEFAULT_METRICS_INTERVAL_S),
        ).start()
        import atexit as _atexit

        _atexit.register(_env_writer.stop)
    except OSError as e:
        import sys as _sys

        _sys.stderr.write(
            f"keystone_tpu_torch: {METRICS_FILE_ENV}={_raw_file!r} is unusable "
            f"({e}) — metrics file writer disabled\n"
        )
        _logger.error(
            "%s=%r unusable (%s) — metrics file writer disabled",
            METRICS_FILE_ENV, _raw_file, e,
        )

_raw_port = os.environ.get(METRICS_PORT_ENV, "").strip()
if _raw_port and _is_worker_process():
    _raw_port = ""
if _raw_port:
    try:
        _env_server = start_metrics_server(int(_raw_port))
    except (OSError, ValueError) as e:
        import sys as _sys

        _sys.stderr.write(
            f"keystone_tpu_torch: {METRICS_PORT_ENV}={_raw_port!r} is unusable "
            f"({e}) — metrics endpoint disabled\n"
        )
        _logger.error(
            "%s=%r unusable (%s) — metrics endpoint disabled",
            METRICS_PORT_ENV, _raw_port, e,
        )
