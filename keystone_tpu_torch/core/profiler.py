"""Device cost attribution (counterpart of keystone_tpu/core/profiler.py):
the per-program ledger, the HBM watermark sampler, and triggered
``torch.profiler`` capture.

* **Program ledger** — the laddered solver fits (``core.memory.run_ladder``),
  the streamed featurize / fused decode dispatches and each hand-kernel
  launch (:func:`launch`) call :func:`record_program` with a synchronized
  wall; the ledger joins it with
  the launch's cost into a per-program MFU, achieved HBM rate and share of
  the roofline bound (:func:`bound_seconds`).  PyTorch has no counterpart
  of XLA's ``cost_analysis``, so the cost comes from its owner: each
  hand-kernel wrapper states the flops and bytes of one launch, reckoned
  from its shapes (``ops.rect_pool.conv_rect_pool_cost``,
  ``ops.fv_stats.fv_stats_cost``, ``ops.jpeg_device.decode_pixels_cost``),
  and a laddered fit counts its matrix-product flops with
  ``torch.utils.flop_counter`` (:func:`counting_flops`), which
  :func:`audit_flops` holds the solver's own hint against.  Exported as
  ``profiler_*`` gauges in ``trace.metrics`` and ``profiler.program``
  trace instants.
* **HBM watermark sampler** — a background thread polls the CUDA caching
  allocator's ``memory_allocated`` every ``KEYSTONE_HBM_SAMPLE_MS`` and
  keeps per-:func:`phase` high-water marks; :func:`audit_plan` compares a
  phase's watermark against the ``core.memory`` plan's charge and counts
  drift beyond ``KEYSTONE_PLAN_DRIFT_TOL`` (``plan_drift``).  The sampler
  never resets the allocator's peak counters (other readers own them).  A
  phase that raises the process peak reads that peak exactly at its exit;
  below an earlier peak it has only the polled samples, and a spike
  shorter than the polling period between two samples is missed.
* **Triggered capture** — :func:`maybe_capture` opens a bounded
  ``torch.profiler`` window writing one Chrome trace into
  ``KEYSTONE_XPROF_DIR`` (at most :data:`MAX_CAPTURES_PER_KIND` per kind
  per process, one window at a time, ``KEYSTONE_XPROF_WINDOW_S`` long),
  fired by an SLO burn (``telemetry.SLOTracker``) or a postmortem-family
  fault.  A Kineto session must stop on the thread that started it (a stop
  from another thread crashes the process), so where the JAX package's
  timer thread closes the window, here the timer only marks it due and it
  closes at the owning thread's next hook (:func:`launch`,
  :func:`attributed_call`, :func:`phase`, :func:`maybe_capture`) or at
  :func:`close_capture`.  While a window is open, each hand-kernel launch
  on its thread runs inside a ``record_function`` range named after the
  wrapper (:func:`launch`), so the trace names the kernels.
* **Graph capture** — inside :func:`graph_tally` (``core.serve``
  captures each batch bucket into a CUDA graph there) a launch is recorded,
  not run: nothing may synchronize, so :func:`launch` and
  :func:`attributed_call` skip the attribution and :func:`launch` tallies
  each kernel's name and stated cost instead.  The engine attributes every
  synced replay of the graph as one program with the summed costs.

Overhead discipline: :func:`enabled` is one flag/env check; with the
profiler off every hook in the execution paths is that one check, and a
kernel launch adds one module-flag check while no window is open.
This module imports no torch at import time.
"""

from __future__ import annotations

import contextlib
import logging
import math
import os
import re
import threading
import time

from . import trace
from .resilience import counters

_logger = logging.getLogger("keystone_tpu_torch.profiler")

#: env var: ``1`` turns the cost-attribution layer on (ledger + sampler).
PROFILER_ENV = "KEYSTONE_PROFILER"
#: env var: HBM watermark sampling period in milliseconds.
HBM_SAMPLE_ENV = "KEYSTONE_HBM_SAMPLE_MS"
#: env var: directory for triggered ``torch.profiler`` capture windows
#: (unset = capture disabled).
XPROF_DIR_ENV = "KEYSTONE_XPROF_DIR"
#: env var: seconds one triggered capture window stays open.
XPROF_WINDOW_ENV = "KEYSTONE_XPROF_WINDOW_S"
#: env var: relative tolerance before watermark-vs-charge drift is counted.
DRIFT_TOL_ENV = "KEYSTONE_PLAN_DRIFT_TOL"

DEFAULT_HBM_SAMPLE_MS = 50.0
DEFAULT_XPROF_WINDOW_S = 0.5
DEFAULT_DRIFT_TOL = 0.25

#: Per-kind capture cap per process: the first windows around a breach
#: carry the information; a fault storm must not fill a disk with traces.
MAX_CAPTURES_PER_KIND = 2

#: A solver's hand-derived ``flops`` hint agrees with the counted flops
#: when within this FACTOR; outside it the mismatch is counted
#: (``flops_hint_mismatch``).
FLOPS_AUDIT_TOL = 8.0

#: Name of the trace file each capture window writes into its directory.
CAPTURE_TRACE_NAME = "trace.json"

_NAME_RE = re.compile(r"[^a-zA-Z0-9_.-]")

_override: bool | None = None


def _env_flag(name: str) -> bool:
    return os.environ.get(name, "").strip().lower() in ("1", "true", "on", "yes")


def enabled() -> bool:
    """Is the cost-attribution layer on?  ``KEYSTONE_PROFILER=1`` or the
    programmatic :func:`profiled` override.  Every hook in the execution
    paths is gated on this one check."""
    if _override is not None:
        return _override
    return _env_flag(PROFILER_ENV)


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        _logger.error("%s=%r is not a number — using %g", name, raw, default)
        return default


def drift_tol() -> float:
    return max(0.0, _env_float(DRIFT_TOL_ENV, DEFAULT_DRIFT_TOL))


# -- device rates --------------------------------------------------------------

#: Peak f32 FLOP/s outside the tensor cores and HBM GB/s by
#: ``torch.cuda.get_device_name`` (NVIDIA's data sheet for the H100 SXM at
#: its 700 W limit; a card set to a lower limit runs slower under load).
DEVICE_RATES: dict[str, dict] = {
    "NVIDIA H100 80GB HBM3": {"peak_flops": 67e12, "hbm_gbps": 3350.0},
}
#: Unknown devices, the CPU included: conservative rates, so only the
#: relative position of two programs is meaningful there.
DEFAULT_RATES = {"peak_flops": 50e9, "hbm_gbps": 20.0}

_rates_cache: dict | None = None


def device_rates() -> dict:
    """``{"device", "peak_flops", "hbm_gbps"}`` for the live card (or the
    defaults without one), read once per process."""
    global _rates_cache
    if _rates_cache is None:
        name = ""
        try:
            import torch

            if torch.cuda.is_available():
                name = torch.cuda.get_device_name(0)
        except Exception:  # noqa: BLE001 — no backend: default rates
            name = ""
        _rates_cache = {"device": name or "cpu",
                        **DEVICE_RATES.get(name, DEFAULT_RATES)}
    return _rates_cache


def bound_seconds(flops: float | None, nbytes: float | None,
                  rates: dict | None = None) -> tuple[float, str]:
    """The least time the device could take for ``flops`` operations over
    ``nbytes`` of traffic: the larger of bytes over the HBM rate and
    operations over the peak rate, and which of the two bounds it
    (``"bytes"`` or ``"operations"``).  The one formula behind the ledger's
    bound share and ``chip_smoke.py``'s ``bound_ms``."""
    rates = rates or device_rates()
    bytes_s = float(nbytes or 0.0) / (rates["hbm_gbps"] * 1e9)
    ops_s = float(flops or 0.0) / rates["peak_flops"]
    return (bytes_s, "bytes") if bytes_s >= ops_s else (ops_s, "operations")


# -- the program ledger --------------------------------------------------------


class _ProgramRow:
    """Aggregated cost attribution for one program label."""

    __slots__ = (
        "label", "runs", "wall_seconds", "flops", "bytes_accessed",
        "bound_seconds", "last_wall_seconds",
    )

    def __init__(self, label: str):
        self.label = label
        self.runs = 0
        self.wall_seconds = 0.0
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self.bound_seconds = 0.0
        self.last_wall_seconds = 0.0

    def record(self) -> dict:
        rates = device_rates()
        wall = self.wall_seconds
        flops_rate = self.flops / wall if wall > 0 and self.flops else None
        gbps = (
            self.bytes_accessed / wall / 1e9
            if wall > 0 and self.bytes_accessed
            else None
        )
        intensity = (
            self.flops / self.bytes_accessed if self.bytes_accessed else None
        )
        ridge = rates["peak_flops"] / (rates["hbm_gbps"] * 1e9)
        return {
            "runs": self.runs,
            "wall_seconds": round(wall, 6),
            "flops": self.flops or None,
            "bytes_accessed": self.bytes_accessed or None,
            "mfu": round(flops_rate / rates["peak_flops"], 6) if flops_rate else None,
            "achieved_hbm_gbps": round(gbps, 3) if gbps else None,
            "intensity_flop_per_byte": round(intensity, 3) if intensity else None,
            "ridge_flop_per_byte": round(ridge, 3),
            # Roofline position: below the ridge intensity the program's
            # ceiling is HBM bandwidth, above it the peak flop rate.
            "bound": (
                ("memory" if intensity < ridge else "compute") if intensity else None
            ),
            # Share of the roofline bound: the least time the device could
            # take for this work over the synchronized wall it took.
            "bound_share": (
                round(self.bound_seconds / wall, 6)
                if wall > 0 and self.bound_seconds else None
            ),
            "last_wall_seconds": round(self.last_wall_seconds, 6),
        }


_ledger_lock = threading.Lock()
_ledger: dict[str, _ProgramRow] = {}
_LEDGER_MAX = 512


def record_program(
    label: str,
    wall_seconds: float,
    *,
    flops: float | None = None,
    bytes_accessed: float | None = None,
) -> dict | None:
    """Attribute one synchronized execution of program ``label`` to the
    ledger: ``flops``/``bytes_accessed`` (the launch's stated cost) with
    ``wall_seconds`` into a per-run MFU, achieved HBM rate and bound share.
    Returns the per-run numbers (None when the profiler is off).  Exported
    live as ``profiler_<label>_mfu`` / ``profiler_<label>_gbps`` gauges and
    a ``profiler.program`` trace instant."""
    if not enabled():
        return None
    rates = device_rates()
    wall = max(float(wall_seconds), 0.0)
    mfu = flops / wall / rates["peak_flops"] if flops and wall > 0 else None
    gbps = bytes_accessed / wall / 1e9 if bytes_accessed and wall > 0 else None
    bound = (
        bound_seconds(flops, bytes_accessed, rates)[0]
        if flops or bytes_accessed else 0.0
    )
    with _ledger_lock:
        row = _ledger.get(label)
        if row is None:
            if len(_ledger) >= _LEDGER_MAX:
                _ledger.pop(next(iter(_ledger)))
            row = _ledger[label] = _ProgramRow(label)
        row.runs += 1
        row.wall_seconds += wall
        row.last_wall_seconds = wall
        row.bound_seconds += bound
        if flops:
            row.flops += flops
        if bytes_accessed:
            row.bytes_accessed += bytes_accessed
    metric = _NAME_RE.sub("_", label)
    if mfu is not None:
        trace.metrics.gauge(f"profiler_{metric}_mfu", round(mfu, 6))
    if gbps is not None:
        trace.metrics.gauge(f"profiler_{metric}_gbps", round(gbps, 3))
    trace.metrics.inc("profiler_programs_recorded")
    out = {
        "label": label,
        "wall_seconds": round(wall, 6),
        "flops": flops,
        "bytes_accessed": bytes_accessed,
        "mfu": round(mfu, 6) if mfu is not None else None,
        "achieved_hbm_gbps": round(gbps, 3) if gbps is not None else None,
        "bound_share": round(bound / wall, 6) if bound and wall > 0 else None,
    }
    trace.instant("profiler.program", **out)
    return out


def ledger() -> dict:
    """Snapshot of the per-program rows (label -> aggregate record)."""
    with _ledger_lock:
        rows = list(_ledger.values())
    return {r.label: r.record() for r in rows}


def ledger_record() -> dict:
    """The ledger plus the device rates its figures were computed against,
    the flops-audit table and the capture paths."""
    return {
        "rates": dict(device_rates()),
        "programs": ledger(),
        "flops_audits": flops_audits(),
        "captures": capture_paths(),
    }


def sync_device() -> None:
    """Wait for the queued device work, when a CUDA context exists."""
    try:
        import torch

        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
    except Exception:  # noqa: BLE001 — an unsyncable backend is not an error
        pass


def synced_wall(out, t0: float) -> float:
    """Wall seconds from ``t0`` to the device's completion of the work that
    produced ``out``: a CUDA synchronize, then the host clock.  A wall
    that omits the device-side completion would read the enqueue."""
    sync_device()
    return time.perf_counter() - t0


def attributed_call(label: str, cost, fn, *args):
    """``fn(*args)`` with ledger attribution: a synchronized wall and one
    :func:`record_program` row under ``label`` carrying ``cost`` (a
    ``(flops, bytes_accessed)`` pair, or None).  The profiled-dispatch
    idiom of the streaming paths (``StreamBatch.apply``,
    ``jpeg_device.fused_apply``); callers gate on :func:`enabled`, so this
    is never on the off path.  Syncing trades the caller's pipelining for
    measurement; values are unchanged.  Inside :func:`graph_tally` it is
    ``fn(*args)`` alone (a capture may not synchronize)."""
    if recording_graph():
        return fn(*args)
    _poll_capture()
    sync_device()
    t0 = time.perf_counter()
    out = fn(*args)
    wall = synced_wall(out, t0)
    flops, nbytes = cost if cost is not None else (None, None)
    record_program(label, wall, flops=flops, bytes_accessed=nbytes)
    return out


@contextlib.contextmanager
def counting_flops():
    """Count the matrix-product flops PyTorch dispatches inside the block
    (``torch.utils.flop_counter.FlopCounterMode``); yields a dict whose
    ``"flops"`` is filled at exit.  The port's stand-in for the compiled
    program's ``cost_analysis`` flops, which :func:`audit_flops` holds a
    solver's hint against.  Factorisations and solves are not counted."""
    from torch.utils.flop_counter import FlopCounterMode

    out = {"flops": None}
    mode = FlopCounterMode(display=False)
    with mode:
        yield out
    out["flops"] = float(mode.get_total_flops()) or None


# -- the hand-derived flops-hint audit -----------------------------------------

_audit_lock = threading.Lock()
_audits: dict[str, dict] = {}


def audit_flops(
    label: str,
    hint_flops: float | None,
    measured_flops: float | None,
    *,
    tol_factor: float = FLOPS_AUDIT_TOL,
) -> float | None:
    """Audit a solver's hand-derived ``flops`` hint against the flops
    :func:`counting_flops` counted for the same run.  Returns the
    hint/measured ratio (None when either side is unknown); a ratio outside
    ``[1/tol_factor, tol_factor]`` is counted (``flops_hint_mismatch``)."""
    if not enabled() or not hint_flops or not measured_flops:
        return None
    ratio = float(hint_flops) / float(measured_flops)
    ok = (1.0 / tol_factor) <= ratio <= tol_factor
    with _audit_lock:
        _audits[label] = {
            "hint_flops": float(hint_flops),
            "counted_flops": float(measured_flops),
            "ratio": round(ratio, 4),
            "tol_factor": tol_factor,
            "ok": ok,
        }
    if not ok:
        counters.record(
            "flops_hint_mismatch",
            f"{label}: hand flops hint x{ratio:.3g} of the counted flops "
            f"(tolerance x{tol_factor}) — the hint misleads the cost model",
        )
    trace.instant("profiler.flops_audit", label=label, ratio=round(ratio, 4), ok=ok)
    return ratio


def flops_audits() -> dict:
    """label -> the most recent audit row for it."""
    with _audit_lock:
        return {k: dict(v) for k, v in _audits.items()}


# -- the HBM watermark sampler -------------------------------------------------


def _cuda_live() -> bool:
    import torch

    return torch.cuda.is_available() and torch.cuda.is_initialized()


def _device_bytes_in_use() -> int | None:
    """Bytes the caching allocator holds in live tensors, or None without
    a CUDA context (the CPU has no allocator statistics)."""
    try:
        import torch

        if not _cuda_live():
            return None
        return int(torch.cuda.memory_allocated())
    except Exception:  # noqa: BLE001 — backends without stats
        return None


def _device_peak_bytes() -> int | None:
    """The allocator's process peak of live tensor bytes (never reset
    here), or None without a CUDA context."""
    try:
        import torch

        if not _cuda_live():
            return None
        return int(torch.cuda.max_memory_allocated())
    except Exception:  # noqa: BLE001
        return None


class HbmSampler:
    """Background thread polling the device's bytes in use.

    Keeps a process-lifetime high-water mark plus one per live
    :func:`phase`; phase exit takes one synchronous sample, and reads the
    allocator's own peak: when it rose during the phase, the new peak is
    the phase's (exact, whatever the polling missed).  A backend that
    cannot report (the CPU) retires the sampler after its first poll —
    watermarks are then ``None`` and every audit skips.  A crash of the
    sampling thread is counted (``profiler_sampler_crash``), never a
    failed run.  ``stats_fn`` (the test seam) replaces the device poll,
    and then the allocator peak is not read."""

    def __init__(self, interval_ms: float | None = None, stats_fn=None):
        self.interval_s = (
            interval_ms
            if interval_ms is not None
            else _env_float(HBM_SAMPLE_ENV, DEFAULT_HBM_SAMPLE_MS)
        ) / 1e3
        self.interval_s = max(self.interval_s, 1e-4)
        self._stats_fn = stats_fn or _device_bytes_in_use
        self._peak_fn = None if stats_fn is not None else _device_peak_bytes
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._global_peak = 0
        self._phase_peaks: dict[str, int] = {}
        self._active: dict[str, int] = {}  # phase -> refcount
        self._entry_peak: dict[str, int | None] = {}  # phase -> allocator peak at entry
        self.samples = 0
        self.crashed = False
        self.unavailable = False
        self._thread = threading.Thread(
            target=self._loop, name="keystone-hbm-sampler", daemon=True
        )

    def start(self) -> "HbmSampler":
        self._thread.start()
        return self

    def _loop(self) -> None:
        try:
            while not self._stop.wait(self.interval_s):
                if not self.sample():
                    return
        except Exception as e:  # noqa: BLE001 — counted, never a failed run
            self.crashed = True
            counters.record(
                "profiler_sampler_crash",
                f"HBM watermark sampler died ({type(e).__name__}: {e}) — "
                "run continues unprofiled",
            )

    def sample(self) -> bool:
        """Take one sample.  Returns False when the backend cannot report
        (the sampler retires itself)."""
        used = self._stats_fn()
        if used is None:
            self.unavailable = True
            self._stop.set()
            return False
        self._note(int(used))
        return True

    def _note(self, used: int) -> None:
        with self._lock:
            self.samples += 1
            self._global_peak = max(self._global_peak, used)
            for name in self._active:
                self._phase_peaks[name] = max(self._phase_peaks.get(name, 0), used)
        trace.metrics.gauge("profiler_hbm_bytes_in_use", used)
        trace.metrics.gauge("profiler_hbm_watermark_bytes", self._global_peak)

    def phase_enter(self, name: str) -> None:
        peak = self._peak_fn() if self._peak_fn is not None else None
        with self._lock:
            n = self._active.get(name, 0)
            if n == 0:
                # Fresh entry: the phase's watermark describes THIS
                # occupancy, not a bigger earlier run under the same name.
                self._phase_peaks.pop(name, None)
                self._entry_peak[name] = peak
            self._active[name] = n + 1

    def phase_exit(self, name: str) -> None:
        # One synchronous sample on the way out: a phase shorter than the
        # polling period still records the bytes it was holding.
        if not (self._stop.is_set() or self.crashed):
            with contextlib.suppress(Exception):
                self.sample()
        peak = self._peak_fn() if self._peak_fn is not None else None
        with self._lock:
            entry = self._entry_peak.get(name)
            if peak is not None and entry is not None and peak > entry:
                # The allocator's process peak rose inside the phase, so
                # the new peak happened inside it.
                self._phase_peaks[name] = max(self._phase_peaks.get(name, 0), peak)
                self._global_peak = max(self._global_peak, peak)
            n = self._active.get(name, 0) - 1
            if n <= 0:
                self._active.pop(name, None)
                self._entry_peak.pop(name, None)
            else:
                self._active[name] = n

    def watermark(self, phase: str | None = None) -> int | None:
        """High-water mark bytes: a phase's (None until it was sampled at
        least once) or the process-lifetime peak."""
        with self._lock:
            if phase is not None:
                return self._phase_peaks.get(phase)
            return self._global_peak or None

    def stop(self, timeout: float = 2.0) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout)

    def record(self) -> dict:
        with self._lock:
            return {
                "samples": self.samples,
                "interval_ms": round(self.interval_s * 1e3, 3),
                "global_watermark_bytes": self._global_peak or None,
                "phase_watermark_bytes": dict(self._phase_peaks),
                "crashed": self.crashed,
                "unavailable": self.unavailable,
            }


_sampler_lock = threading.Lock()
_sampler: HbmSampler | None = None


def ensure_sampler(interval_ms: float | None = None, stats_fn=None) -> HbmSampler | None:
    """The process sampler, started on first use (None when the profiler
    is off).  ``stats_fn`` is the test seam: an injected stats source
    replaces the device poll."""
    if not enabled():
        return None
    global _sampler
    with _sampler_lock:
        if _sampler is None or (
            stats_fn is not None and _sampler._stats_fn is not stats_fn
        ):
            if _sampler is not None:
                _sampler.stop(0.5)
            _sampler = HbmSampler(interval_ms=interval_ms, stats_fn=stats_fn).start()
        return _sampler


def sampler() -> HbmSampler | None:
    return _sampler


def stop_sampler() -> None:
    global _sampler
    with _sampler_lock:
        if _sampler is not None:
            _sampler.stop()
            _sampler = None


@contextlib.contextmanager
def phase(name: str):
    """Attribute HBM watermarks inside this block to ``name`` (the solver
    fits declare themselves; nested phases each get their own watermark).
    A no-op when the profiler is off."""
    s = ensure_sampler()
    if s is None:
        yield
        return
    _poll_capture()
    s.phase_enter(name)
    try:
        yield
    finally:
        s.phase_exit(name)


def watermark(phase_name: str | None = None) -> int | None:
    s = _sampler
    return s.watermark(phase_name) if s is not None else None


def audit_plan(
    label: str,
    plan,
    *,
    phase_name: str | None = None,
    fingerprint: str | None = None,
    features: dict | None = None,
) -> dict | None:
    """Compare the watermark the sampler saw in ``phase_name`` (default
    ``label``) against what the ``core.memory`` plan charged.  Drift beyond
    ``KEYSTONE_PLAN_DRIFT_TOL`` (relative, either direction) is counted
    (``plan_drift``), and the row is appended to the plan-outcome log as an
    ``outcome: "hbm_drift"`` record under ``fingerprint`` (``hbm:<label>``
    without one), with ``features`` (default: ``autoshard.hbm_features`` of
    the plan's byte composition) — the byte-side calibration evidence
    ``core.autoshard.drift_rows`` reads.  Returns the audit row, or None
    when either side is unknown (no sampler, no allocator statistics, no
    charge): skipped, never guessed from the process-lifetime peak."""
    if not enabled():
        return None
    charged = int(getattr(plan, "total_bytes", 0) or 0)
    if charged <= 0:
        return None
    wm = watermark(phase_name or label)
    if not wm:
        return None
    drift = wm / charged
    tol = drift_tol()
    drifted = abs(math.log(drift)) > math.log1p(tol)
    audit = {
        "label": label,
        "charged_bytes": charged,
        "watermark_bytes": int(wm),
        "drift_ratio": round(drift, 4),
        "tolerance": tol,
        "drifted": drifted,
    }
    if drifted:
        from . import memory as kmem

        counters.record(
            "plan_drift",
            f"{label}: device watermark {kmem.fmt_bytes(wm)} vs plan charge "
            f"{kmem.fmt_bytes(charged)} (x{drift:.3g}, tol ±{tol:.0%}) — "
            "the admission model drifted from the device",
        )
    trace.instant("plan_drift", **audit)
    trace.metrics.gauge(f"profiler_{_NAME_RE.sub('_', label)}_plan_drift", round(drift, 4))
    with _audit_lock:
        _plan_audits[label] = dict(audit)
    # One row per audited run, read back by the NEXT process's byte-drift
    # calibration (the log is read once per process).
    from . import autoshard

    if features is None:
        features = autoshard.hbm_features(
            getattr(plan, "argument_bytes", 0),
            getattr(plan, "temp_bytes", 0),
            getattr(plan, "output_bytes", 0),
            getattr(plan, "mesh_axes", None),
        )
    autoshard.append_outcome({
        "fingerprint": fingerprint or f"hbm:{label}",
        "label": label,
        "candidate": label,
        "outcome": "hbm_drift",
        "charged_bytes": charged,
        "watermark_bytes": int(wm),
        "drift_ratio": drift,
        "features": features,
        "ts": time.time(),
    })
    return audit


_plan_audits: dict[str, dict] = {}


def plan_audits() -> dict:
    """label -> the most recent :func:`audit_plan` row for it."""
    with _audit_lock:
        return {k: dict(v) for k, v in _plan_audits.items()}


# -- triggered capture ---------------------------------------------------------

_capture_lock = threading.Lock()
_capture_counts: dict[str, int] = {}
_capture_paths: list[str] = []
_capture_active = False
_capture_due = False
_capture_owner: int | None = None
_capture_timer: threading.Timer | None = None
#: monotonically increasing window id: a timer only marks due the window
#: it was armed for.
_capture_gen = 0
#: the live ``torch.profiler`` session and its directory (real captures).
_session = None


def _xprof_dir() -> str | None:
    raw = os.environ.get(XPROF_DIR_ENV, "").strip()
    return raw or None


def _start_trace(logdir: str) -> None:  # seam: tests patch this
    global _session
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    _session = (prof, logdir)


def _stop_trace() -> None:  # seam: tests patch this
    global _session
    session, _session = _session, None
    if session is None:
        return
    prof, logdir = session
    sync_device()
    prof.stop()
    prof.export_chrome_trace(os.path.join(logdir, CAPTURE_TRACE_NAME))


def capture_paths() -> list[str]:
    """Directories of every capture window this process opened (linked
    from flight-recorder postmortem dumps)."""
    with _capture_lock:
        return list(_capture_paths)


def capture_active() -> bool:
    return _capture_active


def _close_owned() -> None:
    """Stop the open window if this thread owns it."""
    global _capture_active, _capture_due, _capture_owner, _capture_timer
    with _capture_lock:
        if not _capture_active or _capture_owner != threading.get_ident():
            return
        _capture_active = False
        _capture_due = False
        _capture_owner = None
        timer, _capture_timer = _capture_timer, None
    if timer is not None:
        timer.cancel()
    try:
        _stop_trace()
    except Exception:  # noqa: BLE001 — capture is advisory
        _logger.exception("capture stop failed")


def _poll_capture() -> None:
    """Close a window whose time is up, when called on its owning thread.
    One module-flag check while no window is due."""
    if _capture_due and _capture_owner == threading.get_ident():
        _close_owned()


def close_capture() -> None:
    """Close the open window now (on its owning thread; elsewhere a no-op)."""
    _close_owned()


def maybe_capture(kind: str, reason: str = "") -> str | None:
    """Open one bounded ``torch.profiler`` window for trigger ``kind`` if
    ``KEYSTONE_XPROF_DIR`` is set, no window is open and the per-kind cap
    (:data:`MAX_CAPTURES_PER_KIND`) has room.  The window is due after
    ``KEYSTONE_XPROF_WINDOW_S`` and closes at the owning thread's next
    hook.  Returns the capture directory or None.  Never raises and never
    counts through the fault ledger — a capture fired from the fault path
    must not re-enter it."""
    _poll_capture()
    dump_dir = _xprof_dir()
    if dump_dir is None:
        return None
    global _capture_active, _capture_gen, _capture_due, _capture_owner, _capture_timer
    with _capture_lock:
        n = _capture_counts.get(kind, 0)
        if n >= MAX_CAPTURES_PER_KIND or _capture_active:
            return None
        _capture_counts[kind] = n + 1
        _capture_active = True
        _capture_due = False
        _capture_owner = threading.get_ident()
        _capture_gen += 1
        gen = _capture_gen
    path = os.path.join(dump_dir, f"xprof_{_NAME_RE.sub('_', kind)}_{os.getpid()}_{n}")
    try:
        os.makedirs(path, exist_ok=True)
        _start_trace(path)
    except Exception:  # noqa: BLE001 — capture is advisory
        _logger.exception("capture for %r failed to start", kind)
        with _capture_lock:
            _capture_active = False
            _capture_owner = None
            # Refund the budget: no window opened.
            _capture_counts[kind] = max(0, _capture_counts.get(kind, 1) - 1)
        return None

    def _mark_due(gen: int = gen) -> None:
        global _capture_due
        with _capture_lock:
            if gen == _capture_gen and _capture_active:
                _capture_due = True

    timer = threading.Timer(_env_float(XPROF_WINDOW_ENV, DEFAULT_XPROF_WINDOW_S), _mark_due)
    timer.daemon = True
    timer.start()
    with _capture_lock:
        _capture_paths.append(path)
        _capture_timer = timer
    trace.metrics.inc("profiler_captures")
    trace.instant("xprof_capture", kind=kind, path=path, reason=reason)
    _logger.warning(
        "capture window opened -> %s (trigger %s%s)",
        path, kind, f": {reason}" if reason else "",
    )
    return path


def kernel_range(name: str):
    """The context a hand-kernel wrapper launches in: while a capture
    window is open on this thread, a ``record_function`` range named
    ``name`` (so the trace names the launch); otherwise a null context.
    One module-flag check while no window is open."""
    if not _capture_active:
        return contextlib.nullcontext()
    _poll_capture()
    if not _capture_active or _capture_owner != threading.get_ident() or _session is None:
        return contextlib.nullcontext()
    import torch

    return torch.profiler.record_function(name)


def launch(name: str, cost, fn):
    """One hand-kernel launch ``fn()`` as the wrappers run it: inside a
    ``record_function`` range named ``name`` while a capture window is open
    on this thread, and, while the profiler is on, attributed to the
    ledger under ``name`` with ``cost()`` (the wrapper's stated
    ``(flops, bytes)``, evaluated only then) and a synchronized wall.  With
    both off it is two flag checks around the call.  Inside
    :func:`graph_tally` the launch goes into the graph and ``name`` and
    ``cost()`` into the tally; nothing is attributed."""
    tally = getattr(_graph, "tally", None)
    if tally is not None:
        flops, nbytes = cost()
        row = tally.setdefault(name, {"launches": 0, "flops": 0.0, "bytes": 0.0})
        row["launches"] += 1
        row["flops"] += flops or 0.0
        row["bytes"] += nbytes or 0.0
        return fn()
    if enabled():
        return attributed_call(name, cost(), _ranged, name, fn)
    if not _capture_active:
        return fn()
    return _ranged(name, fn)


_graph = threading.local()


def recording_graph() -> bool:
    """True inside :func:`graph_tally` on this thread: launches are being
    recorded into a CUDA graph, not run (the wrappers count no launch)."""
    return getattr(_graph, "tally", None) is not None


@contextlib.contextmanager
def graph_tally():
    """The block captures a CUDA graph on this thread: yields the dict that
    :func:`launch` fills, kernel name -> ``{"launches", "flops",
    "bytes"}`` over the launches the graph records."""
    prev = getattr(_graph, "tally", None)
    _graph.tally = tally = {}
    try:
        yield tally
    finally:
        _graph.tally = prev


def _ranged(name: str, fn):
    with kernel_range(name):
        return fn()


# -- lifecycle / test seams ----------------------------------------------------


def reset_state() -> None:
    """Test isolation: empty ledger and audits, forget capture caps, stop
    and drop the sampler, close an open window this thread owns and
    disarm its timer."""
    stop_sampler()
    global _capture_active, _capture_due, _capture_owner, _capture_timer, _capture_gen
    _close_owned()
    with _capture_lock:
        _capture_counts.clear()
        _capture_paths.clear()
        _capture_active = False
        _capture_due = False
        _capture_owner = None
        _capture_gen += 1
        timer, _capture_timer = _capture_timer, None
    if timer is not None:
        timer.cancel()
    with _ledger_lock:
        _ledger.clear()
    with _audit_lock:
        _audits.clear()
        _plan_audits.clear()


@contextlib.contextmanager
def profiled(on: bool = True, *, interval_ms: float | None = None, stats_fn=None):
    """Programmatic enable/disable for benches and tests: overrides the
    env gate for the block, starts the sampler (with an optional injected
    stats source), and restores the previous state (sampler stopped) on
    exit."""
    global _override
    prev = _override
    _override = on
    try:
        if on:
            device_rates()
            ensure_sampler(interval_ms=interval_ms, stats_fn=stats_fn)
        yield
    finally:
        _override = prev
        if on:
            stop_sampler()
