"""Fault-tolerance primitives (counterpart of keystone_tpu/core/resilience.py):
IO retry with backoff, the fault ledger, and finite-state assertions.

* :func:`retry` — bounded exponential-backoff retry for transient IO
  (tar/file reads).  Tunable via ``KEYSTONE_IO_RETRIES`` /
  ``KEYSTONE_IO_BACKOFF`` / ``KEYSTONE_IO_TIMEOUT``.
* :class:`FaultCounters` / module singleton :data:`counters` — named counts
  of survived faults (corrupt images, unreadable tar members, retried
  opens, entropy-pass fallbacks), logged through the
  ``keystone_tpu_torch`` logger hierarchy, each also a ``fault`` trace
  instant, and a postmortem trigger for the families
  ``core.telemetry`` names.
* :func:`assert_all_finite` — the fit-path guard: every floating tensor
  or array of a fitted model (its attributes, walked recursively) must be
  finite, else the fit fails loudly instead of serving NaN predictions.
* :func:`deadline` / :class:`DeadlineExceeded` — the wall-clock watchdog:
  a phase that hangs is converted into a typed, counted error naming the
  phase, instead of stalling the whole pipeline forever.

Deviation from the JAX package: :func:`numerics_guard_enabled` is always
True (the port's solvers carry the guard unconditionally; the JAX package
lets ``KEYSTONE_NUMERICS_GUARD=0`` turn it off).
"""

from __future__ import annotations

import contextlib
import errno
import functools
import logging
import os
import signal
import sys
import threading
import time
import types
from typing import Callable

import numpy as np

from . import trace

# NO torch import, deliberately: the entropy pass and the loaders count
# their faults here, and they import no torch.  assert_all_finite reads
# tensors through their own methods.

_logger = logging.getLogger("keystone_tpu_torch.resilience")

# Exception types treated as transient by default: filesystem hiccups,
# truncated reads, interrupted syscalls.  (tarfile raises tarfile.TarError
# subclasses for corrupt archives — those are *data* faults, counted and
# skipped by the loaders, not retried.)
DEFAULT_RETRY_ON: tuple[type[BaseException], ...] = (OSError, EOFError)

# OSError subclasses that can never succeed on retry — a typo'd path or a
# permissions problem should fail fast, not sleep through the backoff
# schedule logging misleading io_retry warnings.
PERMANENT_ERRORS: tuple[type[BaseException], ...] = (
    FileNotFoundError,
    IsADirectoryError,
    NotADirectoryError,
    PermissionError,
)


def is_addr_in_use(e: BaseException) -> bool:
    """Is this failure an ``EADDRINUSE`` bind collision?  Transient by
    nature (auto-picked ports race between pick and bind; TIME_WAIT
    lingers), so callers retry it — but it surfaces inconsistently: a
    proper ``OSError`` with errno from Python sockets, an opaque
    ``RuntimeError`` string from services that wrap the socket error
    (a distributed store).  Both spellings are matched."""
    if isinstance(e, OSError) and e.errno == errno.EADDRINUSE:
        return True
    return "address already in use" in str(e).lower()


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        val = int(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r} is not an integer") from None
    if val < 1:
        raise ValueError(f"{name}={raw!r} must be >= 1")
    return val


def _env_float(name: str, default: float | None) -> float | None:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r} is not a number") from None


def retry(
    fn: Callable | None = None,
    *,
    attempts: int | None = None,
    backoff: float | None = None,
    timeout: float | None = None,
    retry_on: tuple[type[BaseException], ...] = DEFAULT_RETRY_ON,
    name: str | None = None,
):
    """Wrap ``fn`` with bounded retry + exponential backoff.

    ``attempts``: total tries (default ``KEYSTONE_IO_RETRIES`` or 3).
    ``backoff``: first sleep in seconds, doubling per retry (default
    ``KEYSTONE_IO_BACKOFF`` or 0.1).
    ``timeout``: total wall-clock budget across attempts (default
    ``KEYSTONE_IO_TIMEOUT`` or unlimited) — when exceeded, the last error
    is raised instead of sleeping again.
    ``retry_on``: exception types considered transient; anything else —
    including the :data:`PERMANENT_ERRORS` subclasses (missing paths,
    permissions) — propagates immediately.

    Usable as a decorator (``@retry``/``@retry(attempts=5)``) or inline
    (``retry(tarfile.open)(path)``).  Every retried failure is logged and
    counted under ``io_retry``.
    """
    if fn is None:
        return functools.partial(
            retry,
            attempts=attempts,
            backoff=backoff,
            timeout=timeout,
            retry_on=retry_on,
            name=name,
        )

    label = name or getattr(fn, "__name__", "fn")

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        n = attempts if attempts is not None else _env_int("KEYSTONE_IO_RETRIES", 3)
        pause = (
            backoff
            if backoff is not None
            else (_env_float("KEYSTONE_IO_BACKOFF", 0.1) or 0.0)
        )
        budget = (
            timeout if timeout is not None else _env_float("KEYSTONE_IO_TIMEOUT", None)
        )
        t0 = time.monotonic()
        for attempt in range(1, n + 1):
            try:
                return fn(*args, **kwargs)
            except retry_on as e:
                if isinstance(e, PERMANENT_ERRORS):
                    raise  # user error, not a transient fault
                out_of_budget = (
                    budget is not None and time.monotonic() - t0 + pause > budget
                )
                if attempt >= n or out_of_budget:
                    _logger.error(
                        "%s failed after %d attempt(s)%s: %s",
                        label,
                        attempt,
                        " (timeout budget exhausted)" if out_of_budget else "",
                        e,
                    )
                    raise
                counters.record(
                    "io_retry", f"{label} attempt {attempt}/{n}: {e}"
                )
                time.sleep(pause)
                pause *= 2.0
        raise AssertionError("unreachable")  # pragma: no cover

    return wrapped


class FaultCounters:
    """Thread-safe named counters for survived faults.

    Loaders and solvers call :meth:`record`; each event is logged (WARNING)
    through the keystone_tpu_torch logger tree so operators see skips as they
    happen, and the totals are queryable (:meth:`counts`) so pipelines and
    tests can assert "N items skipped" instead of guessing from log grep.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: dict[str, int] = {}

    def record(self, kind: str, detail: str | None = None) -> int:
        with self._lock:
            self._counts[kind] = self._counts.get(kind, 0) + 1
            total = self._counts[kind]
            # Every survived fault is also a point event on the trace
            # timeline (no-op when tracing is disabled), so a trace shows
            # WHEN each fault landed relative to the spans it interrupted.
            # Emitted INSIDE the counter lock: any snapshot that observes
            # this count is guaranteed the event is already buffered, so
            # a counted fault and its trace event never form a torn pair.
            trace.instant(
                "fault", kind=kind, total=total,
                **({"detail": detail[:200]} if detail else {}),
            )
        _logger.warning(
            "%s #%d%s", kind, total, f": {detail}" if detail else ""
        )
        # Flight-recorder postmortem (core.telemetry): a typed fault of a
        # postmortem family dumps the recent-event ring + a counters
        # snapshot when KEYSTONE_POSTMORTEM_DIR is set.  OUTSIDE the
        # counter lock: the dump snapshots the metrics registry, whose
        # "faults" group re-enters THIS ledger's snapshot.  Function-local
        # import (a sys.modules lookup at this point) because the module-
        # level binding only exists below this class definition.
        from . import telemetry

        telemetry.maybe_postmortem(kind, detail=detail, total=total)
        return total

    def counts(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def snapshot(self, reset: bool = False) -> dict[str, int]:
        """Atomic copy of the counts; ``reset=True`` clears them under the
        SAME lock acquisition.  Separate ``counts()`` + ``reset()`` calls
        lose any fault recorded between them."""
        with self._lock:
            out = dict(self._counts)
            if reset:
                self._counts.clear()
        return out

    def get(self, kind: str) -> int:
        with self._lock:
            return self._counts.get(kind, 0)

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()


#: Process-wide fault ledger (core.ingest, loaders/image_loaders,
#: ops/native_entropy, ops/jpeg_device).
counters = FaultCounters()

# The fault ledger rides along in every metrics snapshot as the "faults"
# group — one atomic record captures perf metrics AND degradation events.
trace.metrics.adopt("faults", counters)

# Activate the telemetry exporters (KEYSTONE_METRICS_FILE / _PORT) for any
# process that can survive a fault — i.e. any importer of this module.
# telemetry is torch-free and defers http.server until a port is asked for.
from . import telemetry  # noqa: E402,F401  (env-activated exporters)


def numerics_guard_enabled() -> bool:
    """Non-finite checks + Cholesky jitter-retry: always on in the port
    (the JAX package reads ``KEYSTONE_NUMERICS_GUARD``)."""
    return True


def _float_leaves(tree):
    """The floating tensors and arrays of ``tree``, depth-first: a tensor
    or array is a leaf; lists, tuples and dict values are walked; any
    other object but a class or a module is walked through its attributes
    (``vars``), which is where the port's fitted nodes keep their state.
    Each object is visited once."""
    seen: set = set()
    stack = [tree]
    while stack:
        node = stack.pop()
        if id(node) in seen:
            continue
        seen.add(id(node))
        if isinstance(node, (np.ndarray, np.generic)):
            if node.dtype.kind in "fc":
                yield node
        elif hasattr(node, "is_floating_point") and hasattr(node, "isfinite"):
            if node.is_floating_point() or node.is_complex():
                yield node
        elif isinstance(node, (list, tuple)):
            stack.extend(reversed(node))
        elif isinstance(node, dict):
            stack.extend(reversed(list(node.values())))
        elif hasattr(node, "__dict__") and not isinstance(node, (type, types.ModuleType)):
            stack.extend(reversed(list(vars(node).values())))


def _all_finite(leaf) -> bool:
    if isinstance(leaf, (np.ndarray, np.generic)):
        return bool(np.isfinite(leaf).all())
    # one reduction on the tensor's own device; a single bool crosses
    return bool(leaf.isfinite().all())


def assert_all_finite(tree, name: str = "fitted model"):
    """Raise ``FloatingPointError`` if any floating tensor or array of
    ``tree`` (walked as :func:`_float_leaves` says) contains NaN/Inf.
    Returns ``tree`` so fit paths can guard inline:
    ``model = assert_all_finite(est.fit(x, y), "block solve")``."""
    bad = [i for i, leaf in enumerate(_float_leaves(tree)) if not _all_finite(leaf)]
    if bad:
        # NaN provenance (core.numerics): when a probe already bisected a
        # non-finite streamed batch to its tar members, the typed error
        # names the culprit instead of just the model that absorbed it.
        from . import numerics

        note = numerics.provenance_note()
        suffix = f"; {note}" if note else ""
        counters.record(
            "nonfinite_model",
            f"{name}: {len(bad)} non-finite leaf/leaves{suffix}",
        )
        raise FloatingPointError(
            f"{name} contains non-finite values in {len(bad)} leaf/leaves "
            f"(indices {bad}) — refusing to ship a silently-broken model "
            "(ill-conditioned solve, NaN input batch, or overflow upstream)"
            + suffix
        )
    return tree


# -- wall-clock watchdog ------------------------------------------------------


class DeadlineExceeded(RuntimeError):
    """A pipeline phase blew its wall-clock budget.  Typed (never a bare
    traceback), carries the ``phase`` name and the budget so operators and
    tests can assert WHICH stage hung."""

    def __init__(self, phase: str, seconds: float):
        super().__init__(
            f"phase {phase!r} exceeded its {seconds:g}s deadline — "
            "converting the hang into a typed failure"
        )
        self.phase = phase
        self.seconds = seconds
        #: When the trip fired — lets an enclosing deadline's handler tell
        #: "this error is still UNWINDING (raised microseconds ago)" from
        #: "someone caught it and their recovery path is now hanging".
        self.raised_at = time.monotonic()


@contextlib.contextmanager
def deadline(seconds: float, phase: str = "work"):
    """Bound a pipeline phase by wall clock: the block either finishes
    within ``seconds`` or dies with :class:`DeadlineExceeded` (counted
    under ``deadline_exceeded``), never hangs silently.

    On the main thread of a POSIX process the watchdog is a real
    ``SIGALRM`` interval timer, so a genuine hang (a sleep, a stuck read,
    a collective waiting on a dead peer — anything that re-enters the
    Python interpreter) is interrupted mid-flight.  Off the main thread
    (or on platforms without ``setitimer``) signals cannot be armed; the
    fallback checks elapsed time on exit, converting an overrun — though
    not a true never-returns hang — into the same typed error.  Deadlines
    nest: the TIGHTER of the inner budget and the enclosing deadline's
    remaining time is armed (so an outer bound is never suspended by a
    looser inner block), and on inner exit the outer timer is re-armed
    with whatever it has left.
    """
    if seconds <= 0:
        raise ValueError(f"deadline seconds must be positive, got {seconds}")

    armed = False
    old_handler = None
    old_delay = 0.0
    budget = seconds
    t0 = time.monotonic()

    def _trip(signum, frame):
        current = sys.exc_info()[1]
        if (
            isinstance(current, DeadlineExceeded)
            and time.monotonic() - getattr(current, "raised_at", 0.0) < 0.25
        ):
            # A deadline error raised MOMENTS ago is still unwinding
            # through this thread: an inner trip racing the enclosing
            # deadline's re-armed timer (the 1e-3 floor below).  Raising
            # now would REPLACE the inner trip's phase attribution
            # mid-unwind, so postpone briefly.  The recency bound keeps
            # the enclosing deadline REAL: an `except DeadlineExceeded:`
            # suite holds exc_info for its whole body, and without the
            # bound a hung recovery path would be postponed forever.
            signal.setitimer(signal.ITIMER_REAL, 0.05)
            return
        counters.record(
            "deadline_exceeded", f"{phase}: wall clock exceeded {budget:g}s"
        )
        raise DeadlineExceeded(phase, budget)

    try:
        old_handler = signal.signal(signal.SIGALRM, _trip)
        old_delay = signal.setitimer(signal.ITIMER_REAL, seconds)[0]
        if 0.0 < old_delay < seconds:
            # An ENCLOSING deadline had less time left than this block asks
            # for: arming the full inner budget would suspend the outer
            # bound for the inner block's whole duration.  The tighter
            # remaining budget wins (the trip is attributed to the phase
            # that was executing — this one).
            budget = old_delay
            signal.setitimer(signal.ITIMER_REAL, old_delay)
        armed = True
    except (ValueError, AttributeError, OSError):
        # Not the main thread / no setitimer: post-hoc fallback below.
        pass
    try:
        yield
        if not armed and time.monotonic() - t0 > seconds:
            counters.record(
                "deadline_exceeded",
                f"{phase}: wall clock exceeded {seconds:g}s (post-hoc)",
            )
            raise DeadlineExceeded(phase, seconds)
    finally:
        if armed:
            signal.setitimer(signal.ITIMER_REAL, 0.0)
            signal.signal(signal.SIGALRM, old_handler)
            if old_delay > 0.0:
                # Re-arm the enclosing deadline with whatever it has left
                # (floor at a tick so it still fires if already overdue).
                remaining = max(old_delay - (time.monotonic() - t0), 1e-3)
                signal.setitimer(signal.ITIMER_REAL, remaining)
