"""Shape-routed serving front-end (counterpart of the single-process part of
keystone_tpu/core/frontend.py): one warm engine per request shape,
closed-loop engine add/retire, and cross-engine HBM admission.

``core.serve`` serves ONE request shape through one ``ServingEngine`` +
``Server`` pair (its CUDA graphs are captured at fixed shapes).  This module
turns those single-shape engines into one multi-shape service:

* **ShapeRouter** — holds one ``(ServingEngine, Server)`` pair per request
  shape and routes every request to the engine whose example shape it
  matches.  Each engine's label is per-shape (``<label>:<d0>x<d1>``), so
  ``KEYSTONE_SERVE_SLO_MS``'s ``label=ms`` syntax sets per-shape SLO
  targets.
* **Warm add / retire from the observed mix** — requests for an unserved
  shape are counted in a rolling window and answered with a typed
  :class:`RetryLater`; when a shape goes HOT (``warm_threshold`` requests
  inside ``mix_window_s``) the router builds an engine from its
  ``engine_factory`` (its buckets captured while the other engines keep
  serving) and serves the triggering request through it.  An engine idle
  for ``retire_after_s`` is unrouted, DRAINED, then closed — a swap never
  drops a request.  :meth:`ShapeRouter.replace_engine` swaps one shape's
  engine atomically.
* **Cross-engine admission** — each bucket is admission-checked by
  ``core.memory.plan_program``, but each engine plans in isolation; the
  router adds the cross-engine sum: a warm add is denied (counted
  ``router_admission_denied``, answered :class:`RetryLater`) when the new
  engine's peak-bucket bytes plus every live engine's would overrun
  ``core.memory.hbm_budget()``, or on a mesh-anchored router the anchor
  mesh's ``min_chip_budget``.  On the card an engine's bytes are what its
  graphs' captures took (the plans' ``reported`` footprint; a mesh
  engine's per-slot charge, ``slot_charge_bytes``).
* **Surviving-mesh re-anchor** — :class:`MeshEngineFactory` walks the
  solvers' degradation ladder (anchor mesh → ``reduced_mesh`` → the
  single-device floor) when a tier's build fails or only its denied floor
  bucket survives (each step counted ``router_mesh_stepdown``), and
  :meth:`ShapeRouter.reanchor` hot-swaps every live engine onto a new mesh:
  each replacement is built and registered before its predecessor is
  unrouted, drained and closed — no request lost, counted
  ``mesh_reanchor``.

Router state exports into ``trace.metrics`` (``router_engines`` gauge,
``router_routes``/``router_misses``/``router_warm_adds``/
``router_engine_retired`` counters, ``router_route_overhead_us``
histogram); every add/retire/denial is a trace instant.

* **Multi-host fleet** — :class:`HostFleet` fronts N host-local routers,
  each behind a ``core.wire.WireServer``, round-robin; a member whose
  socket dies is declared lost (``fleet_host_lost``) and the same request is
  reissued to a survivor.  ``HostFleet.attach_collector`` registers every
  member with a ``core.fleetobs.FleetCollector`` (the serving socket
  doubles as the member's obs endpoint), and :meth:`HostFleet.reattach`
  registers a re-admitted member with it.

Env knobs: ``KEYSTONE_ROUTER_WARM_THRESHOLD`` (default ``3``),
``KEYSTONE_ROUTER_MIX_WINDOW_S`` (``5``), ``KEYSTONE_ROUTER_RETIRE_AFTER_S``
(``30``), ``KEYSTONE_ROUTER_MAX_ENGINES`` (``8``).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
from collections import deque
from typing import Callable

import numpy as np

from ..parallel import mesh as kmesh
from . import memory as kmem
from . import numerics as knum
from . import telemetry
from . import trace
from .resilience import counters
from .serve import ServeConfig, ServeFuture, Server, ServingEngine
from .serve_errors import (
    NoRouteForShape,
    RetryLater,
    ServeError,
    ServingUnavailable,
    _env_pos_int,
)

_logger = logging.getLogger("keystone_tpu_torch.frontend")

WARM_THRESHOLD_ENV = "KEYSTONE_ROUTER_WARM_THRESHOLD"
MIX_WINDOW_ENV = "KEYSTONE_ROUTER_MIX_WINDOW_S"
RETIRE_AFTER_ENV = "KEYSTONE_ROUTER_RETIRE_AFTER_S"
MAX_ENGINES_ENV = "KEYSTONE_ROUTER_MAX_ENGINES"


def _env_pos_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        val = float(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r} is not a number") from None
    if val <= 0:
        raise ValueError(f"{name}={raw!r} must be > 0")
    return val


def shape_label(label: str, shape) -> str:
    """Per-shape engine label: ``<label>:<d0>x<d1>x...`` (``scalar`` for a
    rank-0 example)."""
    dims = "x".join(str(int(d)) for d in shape)
    return f"{label}:{dims or 'scalar'}"


@dataclasses.dataclass
class RouterConfig:
    """Knob set of one shape router (env-seeded via :meth:`from_env`)."""

    #: unserved-shape requests inside the mix window that make the shape
    #: HOT (worth the capture cost of a warm engine add).
    warm_threshold: int = 3
    #: rolling window over which the request-shape mix is observed.
    mix_window_s: float = 5.0
    #: an engine idle this long stops earning its memory and is retired.
    retire_after_s: float = 30.0
    #: never retire below this many engines.
    min_engines: int = 1
    #: engine-count ceiling; a hot shape at the ceiling can only warm by
    #: retiring the idlest engine.
    max_engines: int = 8
    #: the retry hint carried by :class:`RetryLater` rejections.
    retry_after_s: float = 0.05
    #: opportunistic adapt cadence on the submit path.
    adapt_interval_s: float = 2.0
    #: graceful-retire drain budget before the server is closed anyway.
    drain_timeout_s: float = 30.0

    def __post_init__(self):
        if self.warm_threshold < 1:
            raise ValueError(
                f"warm_threshold must be >= 1, got {self.warm_threshold}"
            )
        if self.mix_window_s <= 0 or self.retire_after_s < 0:
            raise ValueError(
                "mix_window_s must be > 0 and retire_after_s >= 0"
            )
        if self.min_engines < 0 or self.max_engines < 1:
            raise ValueError(
                "min_engines must be >= 0 and max_engines >= 1"
            )

    @classmethod
    def from_env(cls, **overrides) -> "RouterConfig":
        cfg = {
            "warm_threshold": _env_pos_int(WARM_THRESHOLD_ENV, 3),
            "mix_window_s": _env_pos_float(MIX_WINDOW_ENV, 5.0),
            "retire_after_s": _env_pos_float(RETIRE_AFTER_ENV, 30.0),
            "max_engines": _env_pos_int(MAX_ENGINES_ENV, 8),
        }
        cfg.update({k: v for k, v in overrides.items() if v is not None})
        return cls(**cfg)

    def record(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class RouterStats:
    """Counters of one router's lifetime (bench/chaos artifact)."""

    routes: int = 0  #: requests routed to a live engine
    misses: int = 0  #: requests whose shape had no live engine
    warm_adds: int = 0  #: engines warmed from the observed mix
    retires: int = 0  #: engines retired (drained, closed, unregistered)
    rejected: int = 0  #: RetryLater answers (backpressure, retryable)
    replaces: int = 0  #: atomic per-shape engine swaps
    admission_denied: int = 0  #: warm adds denied by the shared HBM budget
    no_route: int = 0  #: NoRouteForShape answers (no factory — permanent)

    def record(self) -> dict:
        return dataclasses.asdict(self)


class _Entry:
    """One live shape family: engine + its batcher, plus mix accounting."""

    __slots__ = ("key", "engine", "server", "added_at", "last_routed", "routes")

    def __init__(self, key: tuple, engine: ServingEngine, server: Server, now: float):
        self.key = key
        self.engine = engine
        self.server = server
        self.added_at = now
        self.last_routed = now
        self.routes = 0


class MeshEngineFactory:
    """Mesh-aware engine factory: builds engines anchored on a target mesh,
    walking the solvers' degradation tiers — anchor mesh → ``reduced_mesh``
    (same slots, model axis collapsed) → the single-device floor — when a
    tier's build raises a typed :class:`~.serve.ServeError` or only its
    denied floor bucket survives (per-slot admission).  Each step down is
    counted ``router_mesh_stepdown``; when the floor fails too the factory
    raises :class:`~.serve.ServingUnavailable`.

    ``build(shape, dtype, mesh_or_none) -> ServingEngine`` constructs one
    engine on one tier (``None``: a meshless engine).  The anchor moves
    with :meth:`ShapeRouter.reanchor` (:meth:`set_mesh`), and every later
    build walks the new ladder.
    """

    def __init__(self, build, mesh=None):
        self._build = build
        self._mesh_lock = threading.Lock()
        self._mesh = mesh

    @property
    def mesh(self):
        with self._mesh_lock:
            return self._mesh

    def set_mesh(self, mesh) -> None:
        """Move the anchor (the surviving mesh after device loss)."""
        with self._mesh_lock:
            self._mesh = mesh

    def _ladder(self) -> list:
        mesh = self.mesh
        tiers = []
        if mesh is not None:
            tiers.append(mesh)
            reduced = kmesh.reduced_mesh(mesh)
            if reduced is not None:
                tiers.append(reduced)
        tiers.append(None)  # the single-device floor: a meshless engine
        return tiers

    @staticmethod
    def _tier_desc(tier) -> str:
        return kmesh.mesh_desc(tier) if tier is not None else "single-device"

    @staticmethod
    def _denied_bucket(engine: ServingEngine) -> int | None:
        """A live bucket that only survived as the engine's denied floor:
        on a mesh tier that is a per-slot admission failure, and a lower
        tier is tried instead."""
        live = set(engine.buckets())
        for bucket, plan in engine.memory_plans.items():
            if bucket in live and not plan.admitted:
                return bucket
        return None

    def __call__(self, shape, dtype) -> ServingEngine:
        key = tuple(int(d) for d in shape)
        tiers = self._ladder()
        last_err: ServeError | None = None
        for i, tier in enumerate(tiers):
            try:
                engine = self._build(key, np.dtype(dtype), tier)
                denied = self._denied_bucket(engine) if tier is not None else None
                if denied is None or i + 1 >= len(tiers):
                    return engine
                counters.record(
                    "router_mesh_stepdown",
                    f"engine for shape {key} on mesh {self._tier_desc(tier)} only "
                    f"serves through its DENIED floor bucket {denied} (per-slot "
                    f"admission) — stepping down to {self._tier_desc(tiers[i + 1])}",
                )
            except ServeError as e:
                last_err = e
                if i + 1 < len(tiers):
                    counters.record(
                        "router_mesh_stepdown",
                        f"engine for shape {key} failed to build on mesh "
                        f"{self._tier_desc(tier)} ({e}) — stepping down to "
                        f"{self._tier_desc(tiers[i + 1])}",
                    )
        raise ServingUnavailable(
            f"engine for shape {key} failed on every mesh tier "
            f"({', '.join(self._tier_desc(t) for t in tiers)}): {last_err}"
        ) from last_err


class ShapeRouter:
    """The multi-shape serving front-end: submit any supported-shape
    request, get a :class:`~.serve.ServeFuture` from the matching engine's
    batcher.

    ``engine_factory(shape, dtype) -> ServingEngine`` (optional) warms
    engines for hot unserved shapes; without it, unserved shapes answer
    :class:`NoRouteForShape`.  Engines added via :meth:`add_engine` serve
    immediately.  ``mesh`` anchors the router: its cross-engine admission
    budgets against the mesh's ``min_chip_budget``, and :meth:`reanchor`
    moves it; a :class:`MeshEngineFactory` and the router share one anchor.
    Use as a context manager (or call :meth:`close`).
    """

    def __init__(
        self,
        engine_factory: Callable[[tuple, np.dtype], ServingEngine] | None = None,
        *,
        label: str = "router",
        config: RouterConfig | None = None,
        server_config: ServeConfig | None = None,
        clock=time.monotonic,
        mesh=None,
    ):
        self._factory = engine_factory
        if isinstance(engine_factory, MeshEngineFactory):
            if mesh is not None:
                engine_factory.set_mesh(mesh)
            else:
                mesh = engine_factory.mesh
        self._mesh = mesh
        self._last_reanchor: dict | None = None
        self.label = label
        self.config = config or RouterConfig.from_env()
        self._server_config = server_config
        self._clock = clock
        self._lock = threading.Lock()
        self._engines: dict[tuple, _Entry] = {}
        self._misses: dict[tuple, deque] = {}
        self._warming: set = set()
        #: shape -> peak bytes of an admitted-but-not-yet-registered warm
        #: add: concurrent warms for DIFFERENT shapes see each other's claim.
        self._warm_reserved: dict[tuple, int] = {}
        self.stats = RouterStats()
        #: JSON-able ledger of cross-engine admission verdicts.
        self.admissions: list[dict] = []
        self._closed = False
        self._adapting = False
        self._last_adapt = self._clock()
        # The router's live state is a /statusz section; unregistered at
        # close(), identity-guarded against a newer same-label router.
        self._statusz_provider = self.record
        telemetry.register_statusz(f"router:{label}", self._statusz_provider)

    # -- engine lifecycle -----------------------------------------------------

    def add_engine(self, engine: ServingEngine) -> tuple:
        """Register a pre-built engine (and its batcher) for its example
        shape.  Returns the routing key (the shape tuple)."""
        key = tuple(int(d) for d in engine.example_shape)
        server = Server(engine, config=self._server_config)
        now = self._clock()
        with self._lock:
            if self._closed:
                server.close()
                server.join()
                raise ServingUnavailable("router is closed")
            if key in self._engines:
                server.close()
                server.join()
                raise ValueError(f"shape {key} already has a live engine")
            self._engines[key] = _Entry(key, engine, server, now)
            n = len(self._engines)
        trace.metrics.gauge("router_engines", n)
        trace.instant(
            "router_engine_added", shape=list(key), label=engine.label,
            engines=n,
        )
        _logger.info(
            "router %s: engine %s live for shape %s (%d engine(s))",
            self.label, engine.label, key, n,
        )
        return key

    def replace_engine(self, engine: ServingEngine, *, why: str = "engine swap") -> tuple:
        """ATOMICALLY swap the engine serving ``engine.example_shape``: the
        replacement registers under ONE routing-table update (add, then
        retire the incumbent after it is unrouted and drained), so a
        request at any instant routes to one or the other.  With no
        incumbent this is :meth:`add_engine`.  Mix accounting carries
        over.  Returns the routing key."""
        key = tuple(int(d) for d in engine.example_shape)
        with self._lock:
            old = self._engines.get(key)
            # SLO trackers and drift monitors unregister BY LABEL: rename a
            # same-label successor BEFORE its Server registers a tracker.
            if old is not None and engine.label == old.engine.label:
                engine.label = f"{old.engine.label}@swap"
        server = Server(engine, config=self._server_config)
        now = self._clock()
        with self._lock:
            if self._closed:
                server.close()
                server.join()
                raise ServingUnavailable("router is closed")
            old = self._engines.get(key)
            entry = _Entry(key, engine, server, now)
            if old is not None:
                entry.routes = old.routes
                entry.last_routed = old.last_routed
                self.stats.replaces += 1
            self._engines[key] = entry
            n = len(self._engines)
        trace.metrics.gauge("router_engines", n)
        trace.instant(
            "router_engine_added", shape=list(key), label=engine.label,
            engines=n, replaced=old.engine.label if old is not None else None,
        )
        if old is not None:
            self._retire_entry(old, why=why)
        _logger.info(
            "router %s: engine %s %s for shape %s (%s)",
            self.label, engine.label,
            "replaced " + old.engine.label if old is not None else "live",
            key, why,
        )
        return key

    def engines(self) -> dict:
        """shape -> engine label of every live engine."""
        with self._lock:
            return {k: e.engine.label for k, e in self._engines.items()}

    def server_for(self, shape) -> Server:
        """The live :class:`~.serve.Server` batching ``shape``'s requests
        (raises :class:`NoRouteForShape` when the shape has no engine)."""
        key = tuple(int(d) for d in shape)
        with self._lock:
            entry = self._engines.get(key)
        if entry is None:
            raise NoRouteForShape(
                f"router {self.label}: no engine serves shape {key}"
            )
        return entry.server

    # -- the request path -----------------------------------------------------

    def submit(self, x) -> ServeFuture:
        """Route one request to the engine serving its shape.  Raises the
        typed errors: ``MalformedRequest``, :class:`RetryLater`,
        :class:`NoRouteForShape`, ``ServingUnavailable``."""
        t0 = time.perf_counter()
        arr = np.asarray(x)
        key = tuple(int(d) for d in arr.shape)
        now = self._clock()
        with self._lock:
            if self._closed:
                raise ServingUnavailable("router is closed")
            entry = self._engines.get(key)
            if entry is not None:
                entry.last_routed = now
                entry.routes += 1
                self.stats.routes += 1
        if entry is not None:
            trace.metrics.observe(
                "router_route_overhead_us", (time.perf_counter() - t0) * 1e6
            )
            trace.metrics.inc("router_routes")
            try:
                fut = entry.server.submit(arr)
            except ServingUnavailable:
                # Retired under our feet: take the miss path (backpressure
                # or a fresh warm), never a dead-engine error.
                return self._miss(arr, key, self._clock())
            self._maybe_adapt(now)
            return fut
        fut = self._miss(arr, key, now)
        self._maybe_adapt(now)
        return fut

    def predict(self, x, timeout: float = 30.0):
        """Blocking convenience: ``submit`` + ``result``, honouring
        :class:`RetryLater` hints until ``timeout``."""
        end = time.monotonic() + timeout
        while True:
            try:
                return self.submit(x).result(max(0.0, end - time.monotonic()))
            except RetryLater as e:
                if time.monotonic() + e.retry_after_s >= end:
                    raise
                time.sleep(e.retry_after_s)

    def _miss(self, arr: np.ndarray, key: tuple, now: float):
        warm_me = False
        with self._lock:
            if self._closed:
                raise ServingUnavailable("router is closed")
            entry = self._engines.get(key)
            if entry is not None:  # lost a warm race — the engine is there
                entry.last_routed = now
                entry.routes += 1
                self.stats.routes += 1
            else:
                self.stats.misses += 1
                trace.metrics.inc("router_misses")
                if self._factory is None:
                    self.stats.no_route += 1
                    raise NoRouteForShape(
                        f"router {self.label}: no engine serves shape {key} "
                        "and no engine factory is configured"
                    )
                dq = self._misses.setdefault(key, deque())
                dq.append(now)
                cutoff = now - self.config.mix_window_s
                while dq and dq[0] < cutoff:
                    dq.popleft()
                hot = len(dq) >= self.config.warm_threshold
                if hot and key not in self._warming:
                    self._warming.add(key)
                    warm_me = True
                elif not hot:
                    self.stats.rejected += 1
                    trace.metrics.inc("router_retry_later")
                    raise RetryLater(
                        f"router {self.label}: shape {key} has no warm "
                        f"engine yet ({len(dq)}/{self.config.warm_threshold} "
                        "recent requests) — retry",
                        self.config.retry_after_s,
                    )
                else:  # another thread is mid-warm for this shape
                    self.stats.rejected += 1
                    trace.metrics.inc("router_retry_later")
                    raise RetryLater(
                        f"router {self.label}: an engine for shape {key} "
                        "is warming — retry",
                        self.config.retry_after_s,
                    )
        if entry is not None:
            return entry.server.submit(arr)
        try:
            return self._warm_and_submit(arr, key, now)
        finally:
            with self._lock:
                self._warming.discard(key)
                self._warm_reserved.pop(key, None)

    # -- warm add (the closed loop's grow side) -------------------------------

    def _warm_and_submit(self, arr: np.ndarray, key: tuple, now: float):
        # At the engine ceiling the only way to warm is to free a slot:
        # retire the idlest engine IF it has stopped earning traffic.
        evict = None
        with self._lock:
            if len(self._engines) >= self.config.max_engines:
                idlest = min(
                    self._engines.values(), key=lambda e: e.last_routed
                )
                if (
                    now - idlest.last_routed >= self.config.mix_window_s
                    and len(self._engines) > self.config.min_engines
                ):
                    evict = self._engines.pop(idlest.key)
                else:
                    self.stats.rejected += 1
                    trace.metrics.inc("router_retry_later")
                    raise RetryLater(
                        f"router {self.label}: at the engine ceiling "
                        f"({self.config.max_engines}) with every engine "
                        "still earning traffic — retry",
                        self.config.retry_after_s,
                    )
        if evict is not None:
            self._retire_entry(evict, why="evicted for a hotter shape")
        with trace.span(
            "router.warm", cat="serve", shape=list(key), label=self.label
        ):
            engine = self._factory(key, arr.dtype)
        admitted, verdict = self._cross_admission(key, engine)
        with self._lock:
            self.admissions.append(verdict)
            del self.admissions[:-16]  # bounded ledger
        if not admitted:
            with self._lock:
                self.stats.admission_denied += 1
                self.stats.rejected += 1
            counters.record(
                "router_admission_denied",
                f"router {self.label}: warm add for shape {key} denied — "
                f"{verdict['reason']}",
            )
            raise RetryLater(
                f"router {self.label}: no HBM headroom to warm an engine "
                f"for shape {key} ({verdict['reason']}) — retry",
                self.config.retry_after_s,
            )
        self.add_engine(engine)
        with self._lock:
            self.stats.warm_adds += 1
            self._misses.pop(key, None)
            entry = self._engines.get(key)
            if entry is not None:
                entry.last_routed = self._clock()
                entry.routes += 1
                self.stats.routes += 1
        trace.metrics.inc("router_warm_adds")
        trace.instant(
            "router_engine_warmed", shape=list(key), label=engine.label
        )
        if entry is None:  # pragma: no cover — add_engine just inserted it
            raise ServingUnavailable("router closed during warm add")
        return entry.server.submit(arr)

    def _engine_peak_bytes(self, engine: ServingEngine) -> int:
        """The engine's steady-state device claim: over its LIVE buckets,
        the largest of each plan's total and (on the card) the bytes its
        capture took (``plan.reported``; a mesh engine's per-slot charge);
        an unanalyzed plan counts the padded batch in + out bytes of its
        bucket."""
        peak = 0
        live = set(engine.buckets())
        for bucket, plan in engine.memory_plans.items():
            if bucket not in live:
                continue
            if plan.reported:
                rep = plan.reported
                # A mesh engine's capture bytes are its card's; a slot is
                # charged its share.
                vals = [rep["slot_charge_bytes"]] if "slot_charge_bytes" in rep else rep.values()
                peak = max(peak, *(int(v) for v in vals))
            if plan.analyzed and plan.total_bytes:
                peak = max(peak, int(plan.total_bytes))
            elif not plan.reported:
                row = int(
                    np.prod(engine.example_shape, dtype=np.int64)
                    * engine.example_dtype.itemsize
                ) if engine.example_shape else engine.example_dtype.itemsize
                peak = max(peak, 2 * bucket * row)
        return peak

    def _cross_admission(
        self, key: tuple, new_engine: ServingEngine
    ) -> tuple[bool, dict]:
        """Live engines' peak bytes, OTHER in-flight warm adds' reserved
        bytes and the candidate's must together fit
        ``core.memory.hbm_budget()`` (an unknown budget admits with the
        reason recorded).  An admitted candidate RESERVES its bytes under
        the same lock; the reservation clears once the engine is routed.
        A mesh-anchored router budgets against the CURRENT anchor's
        ``min_chip_budget``: after a re-anchor, the surviving mesh's."""
        mesh = self._mesh
        budget = kmem.min_chip_budget(mesh)[0] if mesh is not None else kmem.hbm_budget()
        candidate = self._engine_peak_bytes(new_engine)
        with self._lock:
            resident = sum(
                self._engine_peak_bytes(e.engine)
                for e in self._engines.values()
            )
            reserved = sum(
                v for k, v in self._warm_reserved.items() if k != key
            )
            verdict = {
                "label": new_engine.label,
                "resident_bytes": int(resident),
                "reserved_bytes": int(reserved),
                "candidate_bytes": int(candidate),
                "budget_bytes": int(budget) if budget is not None else None,
            }
            if budget is None:
                verdict.update(
                    admitted=True,
                    reason=(
                        "no HBM budget known — cross-engine admission "
                        "skipped"
                    ),
                )
                return True, verdict
            admitted = resident + reserved + candidate <= budget
            if admitted:
                self._warm_reserved[key] = candidate
            verdict.update(
                admitted=admitted,
                reason=(
                    f"{resident + reserved + candidate} bytes across "
                    f"engines vs budget {budget}"
                ),
            )
        trace.instant(
            "router_admission",
            admitted=admitted,
            resident_bytes=int(resident),
            reserved_bytes=int(reserved),
            candidate_bytes=int(candidate),
            budget_bytes=int(budget),
        )
        return admitted, verdict

    # -- retire (the closed loop's shrink side) -------------------------------

    def _maybe_adapt(self, now: float) -> None:
        if now - self._last_adapt < self.config.adapt_interval_s:
            return
        with self._lock:
            if self._adapting or self._closed:
                return
            if now - self._last_adapt < self.config.adapt_interval_s:
                return
            self._adapting = True
            self._last_adapt = now
        threading.Thread(
            target=self._adapt_bg, name="keystone-router-adapt", daemon=True
        ).start()

    def _adapt_bg(self) -> None:
        try:
            self.adapt()
        except Exception:  # noqa: BLE001 — the sweep must not die silently
            _logger.exception("router adapt sweep failed")
        finally:
            self._adapting = False

    def adapt(self) -> dict:
        """One retire sweep: unroute every engine idle past
        ``retire_after_s`` (down to ``min_engines``), drain it, close it,
        unregister its SLO tracker.  Returns the actions taken."""
        now = self._clock()
        retired: list[_Entry] = []
        with self._lock:
            if self._closed:
                return {"retired": []}
            idle_first = sorted(
                self._engines.values(), key=lambda e: e.last_routed
            )
            for entry in idle_first:
                if len(self._engines) <= self.config.min_engines:
                    break
                if now - entry.last_routed >= self.config.retire_after_s:
                    del self._engines[entry.key]
                    retired.append(entry)
        for entry in retired:
            self._retire_entry(entry, why="stopped earning traffic")
        return {"retired": [list(e.key) for e in retired]}

    # -- surviving-mesh re-anchor ---------------------------------------------

    def reanchor(self, mesh, *, why: str = "device loss") -> dict:
        """Hot-swap every live engine onto ``mesh`` (None: the single-device
        floor) — the surviving-mesh re-anchor after device loss.

        No request is lost: each replacement is built by the factory and
        REGISTERED before its predecessor is unrouted; the predecessor then
        drains (every outstanding future resolves) and closes through
        :meth:`_retire_entry`.  A shape whose rebuild fails keeps its old
        engine serving and lands in the record's ``failed`` list.  The event
        is counted ``mesh_reanchor`` and its record is ``last_reanchor`` in
        :meth:`record`."""
        t0 = time.perf_counter()
        if self._factory is None:
            raise ServingUnavailable(
                f"router {self.label}: cannot re-anchor without an engine factory"
            )
        if isinstance(self._factory, MeshEngineFactory):
            self._factory.set_mesh(mesh)
        with self._lock:
            if self._closed:
                raise ServingUnavailable("router is closed")
            self._mesh = mesh
            old_entries = list(self._engines.values())
        desc = kmesh.mesh_desc(mesh) if mesh is not None else "single-device"
        swapped: list[dict] = []
        failed: list[dict] = []
        for old in old_entries:
            try:
                with trace.span(
                    "router.reanchor", cat="serve", shape=list(old.key),
                    label=self.label, mesh=desc,
                ):
                    engine = self._factory(old.key, old.engine.example_dtype)
            except ServeError as e:
                failed.append({"shape": list(old.key), "error": f"{type(e).__name__}: {e}"})
                _logger.warning(
                    "router %s: re-anchor of shape %s onto mesh %s failed (%s) — "
                    "old engine keeps serving", self.label, old.key, desc, e,
                )
                continue
            if engine.label == old.engine.label:
                # SLO trackers and drift monitors unregister BY LABEL when
                # the predecessor retires: the successor takes another name.
                engine.label = f"{old.engine.label}@{desc}"
            server = Server(engine, config=self._server_config)
            now = self._clock()
            with self._lock:
                stale = self._closed or self._engines.get(old.key) is not old
                if not stale:
                    entry = _Entry(old.key, engine, server, now)
                    entry.routes = old.routes
                    entry.last_routed = old.last_routed
                    self._engines[old.key] = entry
            if stale:
                # Retired or replaced mid-build (or the router closed): do
                # not resurrect the shape.
                server.close()
                server.join()
                telemetry.unregister_slo(engine.label)
                knum.unregister_drift(engine.label)
                continue
            trace.instant(
                "router_engine_added", shape=list(old.key), label=engine.label, mesh=desc,
            )
            self._retire_entry(old, why=f"re-anchored onto mesh {desc} ({why})")
            swapped.append({"shape": list(old.key), "label": engine.label})
        wall = time.perf_counter() - t0
        rec = {"mesh": desc, "why": why, "swapped": swapped, "failed": failed,
               "reshard_wall_s": round(wall, 6)}
        with self._lock:
            self._last_reanchor = rec
        counters.record(
            "mesh_reanchor",
            f"router {self.label}: {len(swapped)} engine(s) re-anchored onto mesh "
            f"{desc} in {wall:.3f}s ({why}; {len(failed)} failed)",
        )
        trace.instant(
            "router_reanchor", mesh=desc, swapped=len(swapped), failed=len(failed),
            wall_s=round(wall, 6), why=why,
        )
        _logger.info(
            "router %s: re-anchored %d engine(s) onto mesh %s in %.3fs (%s; %d failed)",
            self.label, len(swapped), desc, wall, why, len(failed),
        )
        return rec

    def _retire_entry(self, entry: _Entry, why: str) -> None:
        """Graceful engine retirement of an ALREADY unrouted entry: drain
        (every outstanding future resolves), then close."""
        drained = entry.server.drain(self.config.drain_timeout_s)
        if not drained:
            _logger.warning(
                "router %s: engine %s did not drain in %.1fs — closing "
                "anyway (stragglers answer ServingUnavailable, typed)",
                self.label, entry.engine.label, self.config.drain_timeout_s,
            )
        entry.server.close()
        entry.server.join()
        telemetry.unregister_slo(entry.engine.label)
        knum.unregister_drift(entry.engine.label)
        with self._lock:
            self.stats.retires += 1
            n = len(self._engines)
        trace.metrics.inc("router_engine_retired")
        trace.metrics.gauge("router_engines", n)
        trace.instant(
            "router_engine_retired", shape=list(entry.key),
            label=entry.engine.label, why=why, drained=drained,
            routes=entry.routes, engines=n,
        )
        _logger.info(
            "router %s: retired engine %s (%s; %d requests routed, "
            "drained=%s)",
            self.label, entry.engine.label, why, entry.routes, drained,
        )

    # -- lifecycle / records --------------------------------------------------

    def drain(self, timeout: float = 30.0) -> bool:
        """Drain every live engine (all outstanding futures resolve)."""
        end = time.monotonic() + timeout
        with self._lock:
            entries = list(self._engines.values())
        ok = True
        for entry in entries:
            ok &= entry.server.drain(max(0.0, end - time.monotonic()))
        return ok

    def close(self) -> None:
        """Close every engine's server (pending requests answer
        ``ServingUnavailable``) and stop routing.  Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            entries = list(self._engines.values())
            self._engines.clear()
        for entry in entries:
            entry.server.close()
            entry.server.join()
            telemetry.unregister_slo(entry.engine.label)
            knum.unregister_drift(entry.engine.label)
        telemetry.unregister_statusz(
            f"router:{self.label}", self._statusz_provider
        )
        trace.metrics.gauge("router_engines", 0)

    def __enter__(self) -> "ShapeRouter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def record(self) -> dict:
        """JSON-able router summary: the live routing table, lifetime
        stats and the admission ledger."""
        now = self._clock()
        with self._lock:
            engines = {
                "x".join(map(str, k)) or "scalar": {
                    "label": e.engine.label,
                    "live_buckets": list(e.engine.buckets()),
                    "routes": e.routes,
                    "idle_seconds": round(now - e.last_routed, 3),
                    "drift": (
                        e.engine.drift.record()
                        if e.engine.drift is not None
                        else None
                    ),
                }
                for k, e in self._engines.items()
            }
            stats = self.stats.record()
            admissions = list(self.admissions)
            last_reanchor = self._last_reanchor
            mesh = self._mesh
        out = {
            "label": self.label,
            "mesh": kmesh.mesh_desc(mesh) if mesh is not None else None,
            "config": self.config.record(),
            "engines": engines,
            "stats": stats,
            "admissions": admissions,
            "last_reanchor": last_reanchor,
        }
        from . import profiler as kprof

        if kprof.enabled():
            out["profiler"] = kprof.ledger_record()
        return out


# -- multi-host fleet front-end -----------------------------------------------


def _endpoint(ep) -> tuple:
    """``(host, port)`` from a tuple or a ``"host:port"`` string."""
    if isinstance(ep, str):
        host, _, port = ep.rpartition(":")
        ep = (host or "127.0.0.1", int(port))
    return str(ep[0]), int(ep[1])


class HostFleet:
    """The wire front-end over N HOST-LOCAL routers: one
    :class:`~.wire.WireClient` per fleet member, requests spread
    round-robin, and a member whose socket dies is declared lost (counted
    ``fleet_host_lost``, postmortem-linked) with the request REISSUED to a
    survivor — a host loss costs the fleet capacity, never an answer.

    Engines never span hosts (``ServingEngine`` refuses a process-spanning
    mesh), so scale-out is N independent ``ShapeRouter`` + ``WireServer``
    pairs — one per host, each anchored on its
    ``parallel.mesh.host_local_mesh`` — fronted by this class.  Predictions
    are pure, so reissuing an in-flight request to a survivor is exact; a
    request only fails when NO host is left (typed
    :class:`ServingUnavailable`).

    Thread-safe: each member's client socket is guarded by its own lock, so
    concurrent callers fan out across members instead of serializing."""

    def __init__(self, endpoints, *, label: str = "fleet", timeout: float = 30.0):
        if not endpoints:
            raise ValueError("HostFleet needs at least one endpoint")
        self.label = label
        self.timeout = float(timeout)
        self._hosts = [self._member(_endpoint(ep)) for ep in endpoints]
        self._rr = 0
        self._rr_lock = threading.Lock()
        self.lost_hosts = 0
        self._collector = None
        trace.instant("fleet.up", label=label, hosts=[list(h["endpoint"]) for h in self._hosts])

    @staticmethod
    def _member(endpoint: tuple) -> dict:
        return {"endpoint": endpoint, "client": None, "lock": threading.Lock(),
                "alive": True, "requests": 0, "reissued": 0}

    def _client(self, h):
        from . import wire

        if h["client"] is None:
            h["client"] = wire.WireClient(h["endpoint"][0], h["endpoint"][1],
                                          timeout=self.timeout)
        return h["client"]

    def _mark_lost(self, h, why: str) -> None:
        if not h["alive"]:
            return
        h["alive"] = False
        self.lost_hosts += 1
        try:
            if h["client"] is not None:
                h["client"].close()
        finally:
            h["client"] = None
        counters.record("fleet_host_lost", f"{self.label}: {h['endpoint']}: {why}")

    def alive_hosts(self) -> list:
        return [h["endpoint"] for h in self._hosts if h["alive"]]

    def attach_collector(self, collector) -> None:
        """Self-register the whole fleet with a
        :class:`~.fleetobs.FleetCollector`: every current member becomes
        an observed obs agent (the serving socket doubles as the obs
        endpoint), and members re-admitted later via :meth:`reattach`
        register too."""
        self._collector = collector
        for rank, h in enumerate(self._hosts):
            collector.register(h["endpoint"], rank=rank)

    def predict(self, arr, timeout: float | None = None):
        """Answer one request through some live host.  A member that dies
        mid-request (reset, closed socket, silence past the deadline) is
        declared lost and the SAME request is reissued to the next member;
        typed remote errors (the server answering "no") propagate — they
        are answers, not host deaths."""
        from . import wire

        budget = timeout if timeout is not None else self.timeout
        tried = 0
        n = len(self._hosts)
        while True:
            live = [h for h in self._hosts if h["alive"]]
            if not live:
                raise ServingUnavailable(f"fleet {self.label!r}: all {n} host(s) lost")
            with self._rr_lock:
                h = live[self._rr % len(live)]
                self._rr += 1
            try:
                with h["lock"]:
                    client = self._client(h)
                    h["requests"] += 1
                    return client.predict(arr, timeout=budget)
            except wire.WireRemoteError:
                raise  # a typed answer from a live host
            except (OSError, TimeoutError, wire.WireProtocolError) as e:
                self._mark_lost(h, f"{type(e).__name__}: {e}")
                tried += 1
                if tried > n:  # pragma: no cover - every host died
                    raise ServingUnavailable(
                        f"fleet {self.label!r}: no host answered: {e}") from e
                h["reissued"] += 1  # this member's loss forced a reissue

    def reattach(self, endpoint) -> None:
        """Re-admit a (restarted) member at ``endpoint`` — the scale-back-up
        half of elasticity.  New endpoint, new member; known endpoint,
        revived in place."""
        endpoint = _endpoint(endpoint)
        trace.instant("fleet.reattach", endpoint=list(endpoint))
        for h in self._hosts:
            if h["endpoint"] == endpoint:
                h["alive"] = True
                h["client"] = None
                if self._collector is not None:
                    self._collector.register(endpoint)
                return
        self._hosts.append(self._member(endpoint))
        if self._collector is not None:
            self._collector.register(endpoint, rank=len(self._hosts) - 1)

    def record(self) -> dict:
        return {
            "label": self.label,
            "hosts": [
                {"endpoint": list(h["endpoint"]), "alive": h["alive"],
                 "requests": h["requests"], "reissued": h["reissued"]}
                for h in self._hosts
            ],
            "lost_hosts": self.lost_hosts,
        }

    def close(self) -> None:
        for h in self._hosts:
            with h["lock"]:
                if h["client"] is not None:
                    try:
                        h["client"].close()
                    except OSError:  # pragma: no cover
                        pass
                    h["client"] = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
