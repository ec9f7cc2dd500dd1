"""Unified tracing & metrics: structured spans, a process-wide metrics
registry, and Chrome-trace/JSONL exporters (counterpart of
keystone_tpu/core/trace.py; the same events, names and formats).

* :func:`span` — a thread-safe context manager producing nested structured
  spans: wall time, thread id, nesting depth/parent, arbitrary JSON-able
  attributes (bytes/shape/dtype), optional device-sync time
  (``sp.sync(value)`` synchronizes the CUDA devices the tensors in
  ``value`` live on and records the synced duration).  When tracing is
  disabled ``span()`` returns a shared no-op singleton — no allocation,
  no lock, one attribute check.
* :data:`metrics` — the process-wide registry unifying **counters**,
  **gauges**, and **histograms** behind one API, with an atomic
  :meth:`Metrics.snapshot`.  ``resilience.counters`` (the fault ledger)
  rides along as an adopted group, so one snapshot captures both.
* :func:`instant` — point events (fault counts, probes) that land in the
  same timeline as spans.
* Exporters: **Chrome trace_event JSON** (loads in Perfetto / chrome://
  tracing and in ``tools/trace_view.py``; the default for ``*.json``
  paths) and a **JSONL event log** (``*.jsonl``).  Enable with
  ``KEYSTONE_TRACE=out.json`` (checked once at import; the file is written
  at process exit) or programmatically with :func:`enable` / a workload's
  ``--trace`` flag.
* **Flight recorder** — a bounded ring of the most recent events that runs
  even with tracing DISABLED (``KEYSTONE_FLIGHT_DEPTH``, 0 disables): a
  fault that fires in an untraced process still has its last moments on
  record, and ``core.telemetry`` dumps the ring as a postmortem JSON when
  a typed fault is counted.  The ring is a fixed-capacity deque — old
  events fall off the back, retained memory is bounded and constant once
  warm.

Overhead discipline: with tracing AND the flight ring off the path is a
module-state check returning a cached null object; with only the ring on,
each finished span is one small dict append into a bounded deque.
Enabled, each finished span is one dict append under a lock (bounded at
:data:`MAX_EVENTS`; overflow is counted, never unbounded).

This module imports neither torch nor anything else outside the standard
library; :meth:`Span.sync` imports torch only when a value lives on a card.
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import json
import logging
import os
import tempfile
import threading
import time

_logger = logging.getLogger("keystone_tpu_torch.trace")

#: env var: path of the trace file to write at process exit ("out.json" for
#: Chrome trace_event JSON viewable in Perfetto, "out.jsonl" for JSONL).
TRACE_ENV = "KEYSTONE_TRACE"

#: env var: flight-recorder ring depth (events retained with tracing off);
#: ``0`` disables the ring entirely.
FLIGHT_ENV = "KEYSTONE_FLIGHT_DEPTH"

#: Default flight-ring depth: enough to hold the last few micro-batches of
#: serving lifecycle events around a fault, small enough that the retained
#: footprint (~a few hundred KB of dicts) is production-invisible.
DEFAULT_FLIGHT_DEPTH = 512

#: Hard cap on buffered events — a runaway span loop degrades to a counted
#: drop (``metrics`` counter ``trace_events_dropped``, plus a drop field in
#: both export formats), never unbounded RAM.
MAX_EVENTS = 1_000_000

_EPOCH = time.perf_counter()  # ts origin: microseconds since module import

# getpid() is a real syscall on every call (Python does not cache it), and
# on sandboxed kernels it measures ~10us — per EVENT that would dwarf the
# event itself.  Cached once; refreshed after fork so a forked child's
# events carry ITS pid.
_PID = os.getpid()


def _refresh_pid() -> None:
    global _PID
    _PID = os.getpid()


if hasattr(os, "register_at_fork"):  # pragma: no branch
    os.register_at_fork(after_in_child=_refresh_pid)

_lock = threading.Lock()
_events: list = []
_dropped = 0
#: Bumped by reset(): a span that outlives the buffer it was opened in
#: (e.g. an abandoned decoder thread finishing after a per-schedule
#: reset) must not leak into the NEXT buffer with a stale tid.
_epoch = 0
_enabled = False
_path: str | None = None
_tids: dict[int, int] = {}  # threading.get_ident() -> small sequential tid
_tid_metas: dict[int, dict] = {}  # tid -> its thread_name metadata event
_tids_in_buffer: set = set()  # tids whose metadata reached _events
_tls = threading.local()  # per-thread span stack (nesting/parents)
_atexit_registered = False

# -- the always-on flight recorder ring.  Deliberately separate from the
# trace buffer: it records even when tracing is disabled, it is bounded by
# construction (deque maxlen — old events fall off), and it is never
# exported unless a postmortem asks for it (core.telemetry).
_flight_lock = threading.Lock()
_flight: collections.deque | None = None


def _parse_flight_depth() -> int:
    raw = os.environ.get(FLIGHT_ENV, "").strip()
    if not raw:
        return DEFAULT_FLIGHT_DEPTH
    try:
        depth = int(raw)
    except ValueError:
        _logger.error(
            "%s=%r is not an integer — flight recorder at default depth %d",
            FLIGHT_ENV, raw, DEFAULT_FLIGHT_DEPTH,
        )
        return DEFAULT_FLIGHT_DEPTH
    return max(0, depth)


def _now_us() -> float:
    return (time.perf_counter() - _EPOCH) * 1e6


def now_us() -> float:
    """The trace clock: microseconds since this module's import — the
    ``ts`` origin every span/instant uses.  Public so two processes can
    exchange their trace clocks and align their timelines."""
    return _now_us()


def _tid() -> int:
    """Small sequential id for the calling thread; first sight also emits
    the Chrome ``thread_name`` metadata event so Perfetto labels lanes."""
    ident = threading.get_ident()
    tid = _tids.get(ident)
    if tid is None:
        meta = None
        with _lock:
            tid = _tids.get(ident)
            if tid is None:
                tid = len(_tids)
                _tids[ident] = tid
                meta = {
                    "ph": "M",
                    "name": "thread_name",
                    "pid": _PID,
                    "tid": tid,
                    "args": {"name": threading.current_thread().name},
                }
                # Cached even when tracing is off: a thread first seen in
                # flight-only mode must still get its Perfetto lane label
                # if tracing is enabled later (enable() re-emits these).
                _tid_metas[tid] = meta
                if _enabled:
                    _events.append(meta)
                    _tids_in_buffer.add(tid)
        if meta is not None and _flight is not None:
            with _flight_lock:
                if _flight is not None:
                    _flight.append(meta)
    return tid


def _stack() -> list:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def _record(event: dict) -> None:
    global _dropped
    with _lock:
        if len(_events) >= MAX_EVENTS:
            _dropped += 1
            overflow = True
        else:
            _events.append(event)
            overflow = False
    if overflow:
        # Counted OUTSIDE the trace lock (metrics has its own) so the
        # truncation shows up in every metrics snapshot, not just the
        # exporters' drop fields.
        metrics.inc("trace_events_dropped")


def _emit(event: dict) -> None:
    """Route one finished event: into the flight ring (always, when the
    ring is on) and into the trace buffer (only when tracing is enabled)."""
    if _flight is not None:
        with _flight_lock:
            if _flight is not None:
                _flight.append(event)
    if _enabled:
        _record(event)


def _cuda_devices(value) -> set:
    """Indices of the CUDA devices holding the tensors in ``value`` (a
    tensor, or lists, tuples and dict values of them, nested).  Reads
    ``.device`` only, so this module never imports torch for CPU values."""
    out: set = set()
    stack = [value]
    while stack:
        v = stack.pop()
        if isinstance(v, (list, tuple)):
            stack.extend(v)
        elif isinstance(v, dict):
            stack.extend(v.values())
        else:
            dev = getattr(v, "device", None)
            if getattr(dev, "type", None) == "cuda":
                out.add(dev.index if dev.index is not None else 0)
    return out


class _NullSpan:
    """The disabled-mode span: a shared, allocation-free no-op."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self

    def sync(self, value):
        return value


_NULL = _NullSpan()


class Span:
    """One live span (use via ``with trace.span(...) as sp``)."""

    __slots__ = (
        "name", "cat", "attrs", "t0", "_tid", "_depth", "_parent", "_epoch"
    )

    def __init__(self, name: str, cat: str, attrs: dict):
        self.name = name
        self.cat = cat
        self.attrs = attrs
        self.t0 = 0.0
        self._tid = 0
        self._depth = 0
        self._parent = None
        self._epoch = 0

    def __enter__(self):
        stack = _stack()
        self._depth = len(stack)
        self._parent = stack[-1].name if stack else None
        stack.append(self)
        self._tid = _tid()
        self._epoch = _epoch
        self.t0 = _now_us()
        return self

    def __exit__(self, etype, exc, tb):
        t1 = _now_us()
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:  # exited out of order (generator close) — heal
            stack.remove(self)
        if self._epoch != _epoch:
            # The buffer this span was opened in was reset: a straggler from an abandoned thread must not
            # land in the NEXT trace with a stale tid.
            return False
        args = dict(self.attrs)
        args["depth"] = self._depth
        if self._parent is not None:
            args["parent"] = self._parent
        if etype is not None:
            if issubclass(etype, GeneratorExit):
                # A generator-hosted span (ingest.consume) is closed — not
                # failed — when the consumer stops early or raises outside
                # the generator frame; naming GeneratorExit as the error
                # would mask the consumer's real failure, which lands on
                # whatever span wraps the consumer code.
                args["aborted"] = True
            else:
                # Typed-error spans are never silent: the failure rides in
                # the span itself, matchable against the fault counters.
                args["error"] = etype.__name__
        _emit(
            {
                "ph": "X",
                "name": self.name,
                "cat": self.cat,
                "ts": self.t0,
                "dur": max(t1 - self.t0, 0.0),
                "pid": _PID,
                "tid": self._tid,
                "args": args,
            }
        )
        return False

    def set(self, **attrs) -> "Span":
        """Attach attributes (bytes, shapes, reports) to the span."""
        self.attrs.update(attrs)
        return self

    def sync(self, value):
        """Wait for the CUDA devices that the tensors in ``value`` live on
        (``torch.cuda.synchronize`` of each; nothing to wait for on the
        CPU) and record the device-sync time (span start -> sync
        completion) as ``sync_us``.  Returns ``value`` so call sites stay
        expression-shaped."""
        for index in sorted(_cuda_devices(value)):
            import torch

            torch.cuda.synchronize(index)
        self.attrs["sync_us"] = round(_now_us() - self.t0, 1)
        return value


def span(name: str, cat: str = "span", **attrs):
    """Open a structured span.  With tracing AND the flight ring both off
    this returns a shared no-op — the hot-path cost is two module-state
    checks; with only the flight ring on, the finished span lands in the
    bounded ring and nowhere else."""
    if not _enabled and _flight is None:
        return _NULL
    return Span(name, cat, attrs)


class _IOSpan(Span):
    """A span over a byte-moving operation (snapshot shard IO, shared-memory
    IPC): records ``bytes`` up front and derives ``mb_per_s`` at exit, so
    the trace answers "was this transfer bandwidth-bound?" without
    cross-referencing durations by hand."""

    __slots__ = ()

    def __exit__(self, etype, exc, tb):
        dur_s = (_now_us() - self.t0) / 1e6
        nbytes = self.attrs.get("bytes", 0)
        if dur_s > 0 and nbytes:
            self.attrs["mb_per_s"] = round(nbytes / dur_s / 1e6, 1)
        return super().__exit__(etype, exc, tb)


def io_span(name: str, nbytes: int, cat: str = "io", **attrs):
    """Span for an IO/IPC transfer of ``nbytes`` — like :func:`span`, plus
    achieved-bandwidth accounting (``bytes`` + ``mb_per_s`` attrs)."""
    if not _enabled and _flight is None:
        return _NULL
    attrs["bytes"] = int(nbytes)
    return _IOSpan(name, cat, attrs)


class _PlanSpan(Span):
    """A span over work the placement search PREDICTED a cost for
    (core.autoshard): records ``predicted_s`` (and optionally
    ``predicted_bytes``) up front and derives ``measured_s`` plus the
    predicted/measured ratio ``prediction_error`` at exit — the trace
    answers "how wrong was the cost model on the plan it chose?" without
    cross-referencing the plan log by hand."""

    __slots__ = ()

    def __exit__(self, etype, exc, tb):
        measured = (_now_us() - self.t0) / 1e6
        self.attrs["measured_s"] = round(measured, 6)
        predicted = self.attrs.get("predicted_s")
        if predicted and measured > 0:
            self.attrs["prediction_error"] = round(predicted / measured, 4)
        return super().__exit__(etype, exc, tb)


def plan_span(
    name: str,
    predicted_seconds: float | None = None,
    predicted_bytes: int | None = None,
    cat: str = "plan",
    **attrs,
):
    """Span for a placement-plan choice: like :func:`span`, plus
    predicted-vs-measured cost accounting (``predicted_s`` /
    ``measured_s`` / ``prediction_error`` attrs)."""
    if not _enabled and _flight is None:
        return _NULL
    if predicted_seconds is not None:
        attrs["predicted_s"] = round(float(predicted_seconds), 6)
    if predicted_bytes is not None:
        attrs["predicted_bytes"] = int(predicted_bytes)
    return _PlanSpan(name, cat, attrs)


def instant(name: str, **attrs) -> None:
    """Point event (admission decision, fault count) on the current
    thread's timeline.

    No epoch guard, deliberately (unlike spans): an instant is wholly
    inside the CURRENT buffer's lifetime — a straggler thread firing one
    after a reset() records an event that really happened now, and the
    matching counter increment lands in the same window's delta, so the
    counted-fault -> trace-event pairing stays consistent.  A span, by
    contrast, opened before the reset would carry a stale tid/interval,
    which is why Span.__exit__ drops it."""
    if not _enabled and _flight is None:
        return
    _emit(
        {
            "ph": "i",
            "s": "t",
            "name": name,
            "cat": "instant",
            "ts": _now_us(),
            "pid": _PID,
            "tid": _tid(),
            "args": attrs,
        }
    )


def enabled() -> bool:
    return _enabled


def enable(path: str) -> None:
    """Turn tracing on, writing to ``path`` at :func:`flush` / process
    exit.  ``*.jsonl`` selects the JSONL event log; anything else writes
    Chrome trace_event JSON (Perfetto-loadable)."""
    global _enabled, _path, _atexit_registered
    # Fail fast on an unwritable destination: flush() runs at the END of a
    # (possibly hours-long) run — discovering a missing directory there
    # would lose the whole trace.
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    if not os.access(parent, os.W_OK):
        raise PermissionError(f"trace path directory {parent!r} not writable")
    with _lock:
        _path = path
        _enabled = True
        # Threads first registered while tracing was off (flight-only
        # mode) have cached thread_name metas — emit them now so their
        # lanes are labeled in the flushed trace.
        for tid, meta in _tid_metas.items():
            if tid not in _tids_in_buffer:
                _events.append(meta)
                _tids_in_buffer.add(tid)
        if not _atexit_registered:
            atexit.register(_flush_at_exit)
            _atexit_registered = True
    _logger.info("tracing enabled -> %s", path)


def disable() -> None:
    """Stop recording (buffered events are kept until :func:`reset`)."""
    global _enabled
    _enabled = False


def reset() -> None:
    """Drop every buffered event AND the flight ring (test isolation;
    per-schedule traces).  Spans still open when reset is called belong to
    the OLD buffer and are discarded at their exit (epoch check), never
    recorded into the new one."""
    global _dropped, _epoch
    with _lock:
        _events.clear()
        _tids.clear()
        _tid_metas.clear()
        _tids_in_buffer.clear()
        _dropped = 0
        _epoch += 1
    flight_reset()


def events() -> list:
    """Snapshot (copy) of the buffered events."""
    with _lock:
        return list(_events)


# -- flight recorder ----------------------------------------------------------


def flight_depth() -> int:
    """Current flight-ring capacity (0 = disabled)."""
    with _flight_lock:
        return _flight.maxlen if _flight is not None else 0


def set_flight_depth(depth: int) -> None:
    """Resize the flight ring to ``depth`` events (0 disables it).  The
    most recent events that still fit are kept."""
    global _flight
    with _flight_lock:
        if depth <= 0:
            _flight = None
            return
        kept = list(_flight)[-depth:] if _flight is not None else []
        _flight = collections.deque(kept, maxlen=int(depth))


def flight_events() -> list:
    """Snapshot (copy) of the flight ring, oldest first."""
    with _flight_lock:
        return list(_flight) if _flight is not None else []


def flight_reset() -> None:
    """Drop the flight ring's contents (capacity unchanged)."""
    with _flight_lock:
        if _flight is not None:
            _flight.clear()


def atomic_write(path: str, write) -> None:
    """Crash-safe text-file write (the ``core.checkpoint`` idiom, shared
    by the trace flush and the telemetry exporters): ``write(f)`` runs on
    a same-directory temp file which is fsynced and atomically renamed
    into place — a crash mid-write leaves the previous file intact; a
    failed write unlinks its temp.  The result gets world-readable 0644
    perms (mkstemp's private 0600 would hide exported metrics/traces from
    scraper users)."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path) + ".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            write(f)
            f.flush()
            os.fsync(f.fileno())
        os.chmod(tmp, 0o644)
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise


def flush(path: str | None = None) -> str | None:
    """Write the buffered events to ``path`` (default: the enabled path).
    Chrome format for ``*.json``, JSONL for ``*.jsonl``.  Returns the
    path written, or None when there is nowhere to write.  Crash-safe via
    :func:`atomic_write` — never a truncated Perfetto JSON."""
    path = path or _path
    if path is None:
        return None
    with _lock:
        evs = list(_events)
        dropped = _dropped

    def write(f) -> None:
        if path.endswith(".jsonl"):
            for ev in evs:
                f.write(json.dumps(ev) + "\n")
            if dropped:
                # Truncation must be visible in THIS format too, not
                # just the Chrome JSON's otherData field.
                f.write(
                    json.dumps(
                        {"ph": "M", "name": "dropped_events",
                         "pid": _PID, "tid": 0,
                         "args": {"count": dropped}}
                    ) + "\n"
                )
        else:
            json.dump(
                {
                    "traceEvents": evs,
                    "displayTimeUnit": "ms",
                    "otherData": {
                        "producer": "keystone_tpu_torch.core.trace",
                        "dropped_events": dropped,
                    },
                },
                f,
            )

    atomic_write(path, write)
    return path


def _flush_at_exit() -> None:
    try:
        if _path is not None and (_events or _enabled):
            flush()
    except Exception:  # noqa: BLE001 — never break interpreter shutdown
        _logger.exception("trace flush at exit failed")


# -- metrics registry ---------------------------------------------------------


class _Hist:
    """Streaming histogram: count/sum/min/max plus a bounded sample window
    for percentiles (last :data:`_HIST_WINDOW` observations)."""

    _WINDOW = 1024
    __slots__ = ("count", "total", "min", "max", "samples")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self.samples: collections.deque = collections.deque(maxlen=self._WINDOW)

    def observe(self, value: float) -> None:
        self.count += 1
        self.total += value
        self.min = min(self.min, value)
        self.max = max(self.max, value)
        self.samples.append(value)

    def summary(self) -> dict:
        if not self.count:
            return {"count": 0}
        s = sorted(self.samples)
        pick = lambda q: s[min(len(s) - 1, int(q * len(s)))]  # noqa: E731
        return {
            "count": self.count,
            "mean": self.total / self.count,
            "min": self.min,
            "max": self.max,
            "p50": pick(0.50),
            "p90": pick(0.90),
            "p99": pick(0.99),
        }


class Metrics:
    """Thread-safe registry of counters, gauges, and histograms.

    External counter groups with their own lock (``resilience.counters``)
    are *adopted*: they keep their API and storage, and ride along in
    every :meth:`snapshot` under their group name — one snapshot captures
    the whole process's metrics surface atomically per group.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, int] = {}
        self._gauges: dict[str, float] = {}
        self._hists: dict[str, _Hist] = {}
        self._groups: dict[str, object] = {}

    # counters ---------------------------------------------------------------
    def inc(self, name: str, n: int = 1) -> int:
        with self._lock:
            self._counters[name] = total = self._counters.get(name, 0) + n
        return total

    def get(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    def counters(self) -> dict:
        with self._lock:
            return dict(self._counters)

    # gauges -----------------------------------------------------------------
    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def gauge_value(self, name: str, default: float | None = None) -> float | None:
        """Read one gauge back (controllers consume
        the same live registry the exporters snapshot)."""
        with self._lock:
            return self._gauges.get(name, default)

    # histograms -------------------------------------------------------------
    def observe(self, name: str, value: float) -> None:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = _Hist()
            h.observe(value)

    def hist_windows(self) -> dict:
        """Raw per-histogram sample windows (count/total/min/max plus the
        bounded sample deque as a list), so percentiles over several
        processes come from pooled samples, not averaged percentiles."""
        with self._lock:
            return {
                k: {
                    "count": h.count,
                    "total": h.total,
                    "min": h.min,
                    "max": h.max,
                    "samples": list(h.samples),
                }
                for k, h in self._hists.items()
                if h.count
            }

    # groups -----------------------------------------------------------------
    def adopt(self, name: str, group) -> None:
        """Register an external counter group (must expose
        ``snapshot(reset=False) -> dict``) under ``name``."""
        with self._lock:
            self._groups[name] = group

    # snapshot ---------------------------------------------------------------
    def snapshot(self, reset: bool = False) -> dict:
        """Atomic copy of every counter/gauge/histogram (and each adopted
        group via ITS own atomic snapshot).  ``reset=True`` clears the
        registry under the same lock — read-then-reset can never lose a
        concurrent increment."""
        with self._lock:
            out = {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": {k: h.summary() for k, h in self._hists.items()},
            }
            groups = dict(self._groups)
            if reset:
                self._counters.clear()
                self._gauges.clear()
                self._hists.clear()
        for name, group in groups.items():
            out[name] = group.snapshot(reset=reset)
        return out

    def reset(self) -> None:
        self.snapshot(reset=True)


#: Process-wide registry.  ``resilience.counters`` adopts itself in as the
#: "faults" group, so ``metrics.snapshot()`` captures perf metrics and the
#: fault ledger in one record.
metrics = Metrics()


# -- env activation -----------------------------------------------------------

# The flight recorder is ON by default (the whole point is postmortems for
# faults nobody predicted); KEYSTONE_FLIGHT_DEPTH=0 turns it off.
set_flight_depth(_parse_flight_depth())

_env_path = os.environ.get(TRACE_ENV, "").strip()
if _env_path:
    try:
        enable(_env_path)
    except OSError as e:
        # A bad env var must not make the whole package unimportable for
        # tools that never asked to trace — but the user who DID ask gets
        # told on stderr (the logger tree has no handler this early).
        import sys as _sys

        _sys.stderr.write(
            f"keystone_tpu_torch: {TRACE_ENV}={_env_path!r} is unusable ({e}) — "
            "tracing disabled\n"
        )
        _logger.error(
            "%s=%r unusable (%s) — tracing disabled", TRACE_ENV, _env_path, e
        )
