"""Closed-loop model lifecycle: drift-triggered warm refit with
zero-downtime hot-swap (counterpart of keystone_tpu/core/lifecycle.py).

The numerics observatory detects a served model going stale
(``serve_output_drift``) and the router can replace an engine with zero
request loss; :class:`LifecycleController` closes the loop between them.

The healing cycle (one stitched trace: the trip instant, the refit and
validate spans, the swap span, all under one ``lifecycle.cycle`` span)::

      IDLE ──trip──▶ REFITTING ──▶ VALIDATING ──▶ SWAPPING ──▶ COOLDOWN ──▶ IDLE
                         │              │                         ▲
                         │ refit_failed │ refit_rejected          │
                         └──────────────┴─────────────────────────┘

* **Trip**: a watcher thread polls the ``serve_output_drift`` and
  ``cond_warn`` fault counters and the SLO error-budget burn
  (``telemetry.slo_summaries``), plus the operator knob
  :meth:`LifecycleController.request_refit`.  The controller's state is a
  ``/statusz`` section (``lifecycle:<label>``).
* **Warm refit**: ``fit(checkpoint=)`` forces the stepwise per-block BCD
  tier (bit-equal to the fused one, and resumable from its own block
  state); features come through :func:`featurized_training_set`, keyed by
  the fitted featurizer's digest (``core.snapshot.featurizer_digest``), so
  an unchanged featurizer streams features from the committed snapshot
  (zero featurizer recompute) while a CHANGED featurizer moves the key and
  forces a cold featurize pass, counted ``refit_cold_fit``.
* **Validation**: no request is ever answered by an unvalidated or
  half-swapped model.  The candidate must be all-finite, pass the serving
  parity check, and not lose to the incumbent on a fresh holdout (the
  quality gate; a loser is counted ``refit_rejected`` and the incumbent
  keeps serving).  The candidate's own output sketch over the holdout is
  persisted with its checkpoint as the fresh numerics baseline.
* **Hot-swap**: checkpoint → ``serve.load_engine`` →
  ``frontend.ShapeRouter.replace_engine`` (one routing-table update; the
  incumbent drains after it is unrouted).  Drift monitors re-arm on the
  new baseline (counted ``drift_rearmed``).
* **Cooldown**: ``KEYSTONE_REFIT_COOLDOWN_S`` after every cycle; a trip
  inside the window is suppressed, counted ``refit_suppressed``.

A refit that dies is counted ``refit_failed``; a landed swap is counted
``lifecycle_refit``.  All three are postmortem families.

The refit's tensors go to the served engine's device: the router's
incumbent engine's, or ``device=`` (default ``"cuda"``, which raises
without a card) when nothing is routed yet.

Env knobs:

* ``KEYSTONE_REFIT_COOLDOWN_S`` — refit debounce window (default 300).
* ``KEYSTONE_REFIT_POLL_S`` — watcher poll period (default 1.0).
* ``KEYSTONE_REFIT_MARGIN`` — quality slack: the candidate is accepted
  when ``quality >= incumbent_quality - margin`` (default 0.0).
* ``KEYSTONE_REFIT_BURN`` — SLO burn-rate trip threshold (default 0 =
  burn does not trip refits).
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import math
import os
import threading
import time
import types
from typing import Any, Callable

import numpy as np
import torch

from ..utils.platform import resolve_device
from . import numerics as knum
from . import telemetry
from . import trace
from .resilience import assert_all_finite, counters

_logger = logging.getLogger("keystone_tpu_torch.lifecycle")

COOLDOWN_ENV = "KEYSTONE_REFIT_COOLDOWN_S"
POLL_ENV = "KEYSTONE_REFIT_POLL_S"
MARGIN_ENV = "KEYSTONE_REFIT_MARGIN"
BURN_ENV = "KEYSTONE_REFIT_BURN"

DEFAULT_COOLDOWN_S = 300.0
DEFAULT_POLL_S = 1.0

#: Lifecycle states, in cycle order.  COOLDOWN decays to IDLE lazily (the
#: state property consults the clock).
STATES = ("IDLE", "REFITTING", "VALIDATING", "SWAPPING", "COOLDOWN")

#: The fault-counter signals the watcher trips on (process-global deltas
#: since the controller armed / last acted).
WATCHED_COUNTERS = ("serve_output_drift", "cond_warn")


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        _logger.warning("ignoring malformed %s=%r", name, raw)
        return default


@dataclasses.dataclass
class LifecycleConfig:
    """Knobs for one controller (env-seeded via :meth:`from_env`)."""

    cooldown_s: float = DEFAULT_COOLDOWN_S
    poll_interval_s: float = DEFAULT_POLL_S
    #: candidate accepted when quality >= incumbent - margin
    quality_margin: float = 0.0
    #: SLO burn-rate that trips a refit; 0 disables the burn signal
    burn_threshold: float = 0.0
    #: watch the cond_warn counter (ill-conditioned solves page the loop)
    watch_cond: bool = True

    @classmethod
    def from_env(cls, **overrides) -> "LifecycleConfig":
        cfg = cls(
            cooldown_s=_env_float(COOLDOWN_ENV, DEFAULT_COOLDOWN_S),
            poll_interval_s=_env_float(POLL_ENV, DEFAULT_POLL_S),
            quality_margin=_env_float(MARGIN_ENV, 0.0),
            burn_threshold=_env_float(BURN_ENV, 0.0),
        )
        for k, v in overrides.items():
            setattr(cfg, k, v)
        return cfg


def featurized_training_set(
    root: str,
    *,
    tar_path: str,
    featurizer: Any,
    compute: Callable[[], tuple],
    batch_size: int = 256,
    extra: str | None = None,
) -> tuple[np.ndarray, np.ndarray, dict]:
    """Featurizer-digest-keyed training set for warm refits.

    The snapshot key folds in :func:`~.snapshot.featurizer_digest` of the
    fitted ``featurizer``: an unchanged featurizer HITS the committed
    featurized snapshot and the ``(features, labels)`` stream from its
    shards, ``compute`` never called.  A changed featurizer (or input tar)
    moves the key, classifies the old snapshot STALE (counted
    ``snapshot_stale``), and forces the cold ``compute()`` pass, whose
    output is committed for the next refit.

    ``compute``: ``() -> (features [n, D], labels [n, k])`` (numpy arrays
    or tensors).  Labels ride as the trailing ``label_cols`` columns of
    each shard's payload, recorded in the manifest meta.

    Returns ``(features f32, labels f32, info)``, numpy arrays, with
    ``info`` carrying the digest, the snapshot key, and ``source``
    ("snapshot" or "computed")."""
    from . import snapshot as ksnap

    digest = ksnap.featurizer_digest(featurizer)
    key = ksnap.snapshot_key(
        tar_path, batch_size=batch_size, mode="featurized", extra=extra, featurizer=digest
    )
    info: dict = {"digest": digest, "key": key, "stale": False}
    snap, reason = ksnap.lookup(root, key, tar_path=tar_path, mode="featurized")
    if reason == "stale":
        info["stale"] = True
        counters.record(
            "snapshot_stale",
            f"{root}: featurized refit snapshot keyed differently "
            "(featurizer or input moved) — cold featurize pass",
        )
    if snap is not None:
        try:
            label_cols = int(snap.manifest.get("meta", {})["label_cols"])
            parts = [
                np.asarray(arrays["payload"], np.float32) for _entry, arrays in snap.iter_chunks()
            ]
            packed = np.concatenate(parts, axis=0)
            info["source"] = "snapshot"
            return packed[:, :-label_cols], packed[:, -label_cols:], info
        except (KeyError, ValueError, ksnap.SnapshotCorrupt) as e:
            counters.record(
                "snapshot_fallback", f"{snap.path}: {e} — recomputing refit features live"
            )
    feats, labels = compute()
    feats = _host_f32(feats)
    labels = _host_f32(labels)
    if labels.ndim == 1:
        labels = labels[:, None]
    packed = np.concatenate([feats, labels], axis=1)
    info["source"] = "computed"
    try:
        writer = ksnap.SnapshotWriter(
            root,
            key,
            mode="featurized",
            meta={"tar": ksnap.tar_identity(tar_path), "label_cols": int(labels.shape[1])},
        )
        for i in range(0, packed.shape[0], batch_size):
            chunk = packed[i : i + batch_size]
            idx = np.arange(i, i + chunk.shape[0], dtype=np.int64)
            writer.add_chunk(i // batch_size, idx, [str(j) for j in idx.tolist()], chunk)
        writer.commit()
    except (OSError, ksnap.SnapshotError) as e:
        # The cache is an optimization: a full disk drops the writer, not
        # the refit.
        counters.record("snapshot_write_failed", f"cannot commit featurized refit snapshot: {e}")
    return feats, labels, info


def _host_f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float32)


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class LifecycleController:
    """The closed loop for ONE served pipeline behind a
    :class:`~.frontend.ShapeRouter` (see the module docstring).  The
    deployment supplies the model-specific pieces as callables; the
    controller owns the state machine, the gates, the counters and the
    swap:

    ``featurizer``
        The fitted featurizer (or a plain function / method / partial
        returning the current one): digest-checked every cycle; a changed
        digest is counted ``refit_cold_fit``.
    ``fetch``
        ``(digest: str) -> (features, labels)``: fresh featurized training
        data for the refit (route it through :func:`featurized_training_set`
        for the warm snapshot path); numpy arrays or tensors.
    ``estimator``
        ``() -> BlockLeastSquaresEstimator``: a fresh solver per cycle.
    ``assemble``
        ``(model) -> pipe``: the full servable pipeline, checkpointable by
        ``core.checkpoint``.
    ``holdout``
        ``() -> (x, y)``: a request-space holdout batch (numpy) drawn from
        the CURRENT mix.
    ``quality``
        ``(predict, x, y) -> float``, higher is better; ``predict`` maps a
        host batch to host answers (the candidate pipe on the device, or
        the incumbent engine's offline oracle).
    ``example``
        One request row (no batch axis): fixes the routed shape and feeds
        ``load_engine``.
    ``device``
        Where the refit runs when the router has no incumbent to take the
        device from (default ``"cuda"``, which raises without a card).
    """

    def __init__(
        self,
        router,
        *,
        workdir: str,
        featurizer: Any,
        fetch: Callable[[str], tuple],
        estimator: Callable[[], Any],
        assemble: Callable[[Any], Any],
        holdout: Callable[[], tuple],
        quality: Callable[[Callable, Any, Any], float],
        example,
        label: str = "lifecycle",
        serve_config=None,
        config: LifecycleConfig | None = None,
        clock: Callable[[], float] = time.monotonic,
        device="cuda",
    ):
        self._router = router
        self._workdir = workdir
        os.makedirs(workdir, exist_ok=True)
        # A fitted featurizer is usually itself callable, so only plain
        # functions, methods and partials are providers of the CURRENT one.
        if isinstance(featurizer, (types.FunctionType, types.MethodType, functools.partial)):
            self._featurizer = featurizer
        else:
            self._featurizer = lambda: featurizer
        self._fetch = fetch
        self._estimator = estimator
        self._assemble = assemble
        self._holdout = holdout
        self._quality = quality
        self._example = example
        self._shape = tuple(int(d) for d in np.asarray(example).shape)
        self._device = device
        self.label = label
        self._serve_config = serve_config
        self.config = config or LifecycleConfig.from_env()
        self._clock = clock
        self.generation = 0
        self._state = "IDLE"
        self._state_lock = threading.Lock()
        self._cycle_lock = threading.Lock()
        self._cooldown_until = -math.inf
        self._last_cycle: dict | None = None
        self._armed_digest: str | None = None
        self._stop = threading.Event()
        self._watcher: threading.Thread | None = None
        self._refit_requested = threading.Event()
        self._request_reason = "operator"
        #: counter baselines the watcher diffs against, re-based after every
        #: landed cycle so the trip that caused it cannot re-trip it.
        self._sig_base = {k: counters.get(k) for k in WATCHED_COUNTERS}
        self._closed = False
        self._statusz_provider = self.record
        telemetry.register_statusz(f"lifecycle:{label}", self._statusz_provider)

    # -- state ----------------------------------------------------------------

    @property
    def state(self) -> str:
        """Current lifecycle state; COOLDOWN decays to IDLE when the
        debounce window has passed."""
        with self._state_lock:
            s = self._state
            if s == "COOLDOWN" and self._clock() >= self._cooldown_until:
                self._state = s = "IDLE"
            return s

    def _set_state(self, state: str) -> None:
        with self._state_lock:
            self._state = state
        trace.instant("lifecycle_state", label=self.label, state=state)

    def cooldown_remaining_s(self) -> float:
        return max(0.0, self._cooldown_until - self._clock())

    # -- trip signals ---------------------------------------------------------

    def request_refit(self, reason: str = "operator") -> dict | None:
        """The operator knob: with the watcher running the request is
        picked up on its next poll (returns None); without it the cycle
        runs synchronously and returns its record.  Cooldown applies."""
        self._request_reason = reason
        self._refit_requested.set()
        if self._watcher is not None and self._watcher.is_alive():
            return None
        return self.run_refit(reason=reason)

    def check_signals(self) -> str | None:
        """One watcher poll: the trip reason, or None.  Operator requests
        win; then counted drift, conditioning pages, SLO burn."""
        if self._refit_requested.is_set():
            self._refit_requested.clear()
            return self._request_reason
        for kind in WATCHED_COUNTERS:
            if kind == "cond_warn" and not self.config.watch_cond:
                continue
            now = counters.get(kind)
            if now > self._sig_base.get(kind, 0):
                self._sig_base[kind] = now
                return kind
        if self.config.burn_threshold > 0:
            for label, s in telemetry.slo_summaries().items():
                burn = (s.get("window") or {}).get("burn_rate", s.get("burn_rate", 0.0))
                if burn is not None and burn >= self.config.burn_threshold:
                    return f"slo_burn:{label}"
        return None

    def start(self) -> None:
        """Start the background watcher (idempotent)."""
        if self._watcher is not None and self._watcher.is_alive():
            return
        self._stop.clear()
        self._watcher = threading.Thread(
            target=self._watch_loop, name=f"keystone-lifecycle-{self.label}", daemon=True
        )
        self._watcher.start()

    def _watch_loop(self) -> None:
        while not self._stop.is_set():
            try:
                reason = self.check_signals()
                if reason is not None:
                    self.run_refit(reason=reason)
            except Exception:  # noqa: BLE001 — the watcher must not die
                _logger.exception("lifecycle %s: watcher poll failed", self.label)
            self._stop.wait(self.config.poll_interval_s)

    def close(self) -> None:
        """Stop the watcher and unregister the statusz section (idempotent;
        the router and its engines outlive the controller)."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        if self._watcher is not None:
            self._watcher.join(timeout=10.0)
        telemetry.unregister_statusz(f"lifecycle:{self.label}", self._statusz_provider)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- the healing cycle ----------------------------------------------------

    def run_refit(self, *, reason: str = "operator") -> dict:
        """Run one full cycle synchronously and return its record
        (``outcome`` ∈ swapped / rejected / refit_failed / suppressed).  A
        trip while a cycle is mid-flight is a suppression, not a queue."""
        if not self._cycle_lock.acquire(blocking=False):
            counters.record(
                "refit_suppressed",
                f"lifecycle:{self.label}: refit requested ({reason}) while "
                "a cycle is mid-flight — suppressed",
            )
            return {"outcome": "suppressed", "why": "cycle in flight", "reason": reason}
        try:
            now = self._clock()
            if now < self._cooldown_until:
                counters.record(
                    "refit_suppressed",
                    f"lifecycle:{self.label}: refit requested ({reason}) "
                    f"inside the {self.config.cooldown_s:g}s cooldown "
                    f"({self._cooldown_until - now:.1f}s remaining) — storm guard",
                )
                rec = {"outcome": "suppressed", "why": "cooldown", "reason": reason,
                       "cooldown_remaining_s": round(self._cooldown_until - now, 3)}
                self._last_cycle = rec
                return rec
            return self._run_cycle(reason)
        finally:
            self._cycle_lock.release()

    def _finish(self, rec: dict) -> dict:
        """Arm the cooldown (every terminal outcome debounces) and park in
        COOLDOWN."""
        self._cooldown_until = self._clock() + self.config.cooldown_s
        self._set_state("COOLDOWN")
        self._last_cycle = rec
        return rec

    def _refit_device(self) -> torch.device:
        """The incumbent engine's device, else ``device=`` (resolved: CUDA
        without a card raises)."""
        incumbent = self._incumbent_engine()
        if incumbent is not None:
            return incumbent.device
        return resolve_device(self._device)

    def _run_cycle(self, reason: str) -> dict:
        self.generation += 1
        gen = self.generation
        t0 = time.perf_counter()
        rec: dict = {"generation": gen, "reason": reason}
        with trace.span(
            "lifecycle.cycle", cat="lifecycle", label=self.label, generation=gen, reason=reason,
        ):
            trace.instant("lifecycle_trip", label=self.label, kind=reason, generation=gen)
            _logger.info("lifecycle %s: cycle g%d tripped (%s)", self.label, gen, reason)
            # ---- REFITTING ---------------------------------------------------
            self._set_state("REFITTING")
            t_refit = time.perf_counter()
            try:
                with trace.span("lifecycle.refit", cat="lifecycle", generation=gen):
                    dev = self._refit_device()
                    digest = _featurizer_digest(self._featurizer())
                    cold = self._armed_digest is not None and digest != self._armed_digest
                    rec["cold_fit"] = cold
                    if cold:
                        counters.record(
                            "refit_cold_fit",
                            f"lifecycle:{self.label}: featurizer digest moved since "
                            "the incumbent fit — warm start invalid, cold featurize "
                            "pass forced",
                        )
                    feats, labels = self._fetch(digest)
                    est = self._estimator()
                    # checkpoint= forces the stepwise per-block tier, so a
                    # preempted refit resumes from its own block state; its
                    # bits are the fused tier's.
                    ckpt = os.path.join(self._workdir, f"g{gen:04d}_bcd")
                    model = est.fit(
                        torch.as_tensor(feats, device=dev),
                        torch.as_tensor(labels, device=dev),
                        checkpoint=ckpt,
                    )
                    pipe = self._assemble(model)
                    self._armed_digest = digest
            except Exception as e:  # noqa: BLE001 — typed degrade, never a gap
                rec.update(self._degrade("refit", e, gen))
                rec["refit_wall_s"] = round(time.perf_counter() - t_refit, 6)
                rec["total_wall_s"] = round(time.perf_counter() - t0, 6)
                return self._finish(rec)
            rec["refit_wall_s"] = round(time.perf_counter() - t_refit, 6)
            # ---- VALIDATING --------------------------------------------------
            self._set_state("VALIDATING")
            t_val = time.perf_counter()
            try:
                with trace.span("lifecycle.validate", cat="lifecycle", generation=gen):
                    try:
                        assert_all_finite(model, f"refit candidate g{gen}")
                    except FloatingPointError as e:
                        rec["validate_wall_s"] = round(time.perf_counter() - t_val, 6)
                        return self._reject(rec, gen, t0, f"non-finite: {e}")

                    def candidate(x):
                        return _host(pipe(torch.as_tensor(np.asarray(x), device=dev)))

                    hx, hy = self._holdout()
                    cand_q = float(self._quality(candidate, hx, hy))
                    inc_q = None
                    incumbent = self._incumbent_engine()
                    if incumbent is not None:
                        inc_q = float(self._quality(incumbent.offline, hx, hy))
                    rec["quality"] = {"candidate": cand_q, "incumbent": inc_q}
                    if not math.isfinite(cand_q) or (
                        inc_q is not None and cand_q < inc_q - self.config.quality_margin
                    ):
                        rec["validate_wall_s"] = round(time.perf_counter() - t_val, 6)
                        return self._reject(
                            rec, gen, t0,
                            f"holdout quality {cand_q:.6g} vs incumbent "
                            f"{inc_q if inc_q is None else round(inc_q, 6)} "
                            f"(margin {self.config.quality_margin:g})",
                        )
                    # The candidate's OWN output sketch over the current mix:
                    # the baseline the swapped engine re-arms on.
                    baseline = knum.OutputSketch.for_outputs(candidate(hx)).record()
            except Exception as e:  # noqa: BLE001
                rec.update(self._degrade("validate", e, gen))
                rec["validate_wall_s"] = round(time.perf_counter() - t_val, 6)
                rec["total_wall_s"] = round(time.perf_counter() - t0, 6)
                return self._finish(rec)
            rec["validate_wall_s"] = round(time.perf_counter() - t_val, 6)
            # ---- SWAPPING ----------------------------------------------------
            self._set_state("SWAPPING")
            t_swap = time.perf_counter()
            try:
                with trace.span("lifecycle.swap", cat="lifecycle", generation=gen):
                    from .checkpoint import save_pipeline
                    from .serve import load_engine

                    stem = save_pipeline(
                        os.path.join(self._workdir, f"g{gen:04d}"), pipe,
                        numerics_baseline=baseline,
                    )
                    rec["checkpoint"] = stem
                    engine, cold_rec = load_engine(
                        stem, self._example, config=self._serve_config,
                        label=f"{self.label}@g{gen}", device=dev,
                    )
                    rec["cold_start"] = cold_rec
                    if not engine.parity_ok:
                        return self._reject(
                            rec, gen, t0,
                            "candidate engine failed the bucket parity check — served "
                            "answers would not be bit-equal to the refit pipeline",
                        )
                    self._router.replace_engine(engine, why=f"lifecycle refit g{gen} ({reason})")
                    # Re-arm on the candidate's baseline from the swap
                    # instant (counted drift_rearmed).
                    engine.rearm_drift_baseline(baseline)
                    rec["engine_label"] = engine.label
            except Exception as e:  # noqa: BLE001
                rec.update(self._degrade("swap", e, gen))
                rec["swap_wall_s"] = round(time.perf_counter() - t_swap, 6)
                rec["total_wall_s"] = round(time.perf_counter() - t0, 6)
                return self._finish(rec)
            rec["swap_wall_s"] = round(time.perf_counter() - t_swap, 6)
            rec["total_wall_s"] = round(time.perf_counter() - t0, 6)
            rec["outcome"] = "swapped"
            # The trip that caused this cycle must not re-trip the next one.
            self._sig_base = {k: counters.get(k) for k in WATCHED_COUNTERS}
            counters.record(
                "lifecycle_refit",
                f"lifecycle:{self.label}: refit g{gen} landed ({reason}) — "
                f"refit {rec['refit_wall_s']:.3f}s, validate "
                f"{rec['validate_wall_s']:.3f}s, swap {rec['swap_wall_s']:.3f}s; "
                f"engine {rec['engine_label']} serving, drift re-armed on the "
                "fresh baseline",
            )
            _logger.info("lifecycle %s: cycle g%d swapped in %.3fs",
                         self.label, gen, rec["total_wall_s"])
            return self._finish(rec)

    def _reject(self, rec: dict, gen: int, t0: float, why: str) -> dict:
        """The no-unvalidated-model invariant firing: the candidate is
        refused, the incumbent keeps serving, counted."""
        rec["outcome"] = "rejected"
        rec["why"] = why
        rec["total_wall_s"] = round(time.perf_counter() - t0, 6)
        counters.record(
            "refit_rejected",
            f"lifecycle:{self.label}: refit candidate g{gen} REJECTED ({why}) — "
            "incumbent keeps serving",
        )
        return self._finish(rec)

    def _degrade(self, phase: str, e: Exception, gen: int) -> dict:
        """A cycle dying mid-flight is typed and counted, never a service
        gap: the router was not touched, or its atomic replace landed whole
        or not at all."""
        counters.record(
            "refit_failed",
            f"lifecycle:{self.label}: refit cycle g{gen} died in {phase} "
            f"({type(e).__name__}: {e}) — incumbent keeps serving",
        )
        _logger.warning("lifecycle %s: cycle g%d failed in %s: %s", self.label, gen, phase, e)
        return {
            "outcome": "refit_failed",
            "phase": phase,
            "error_type": type(e).__name__,
            "error": str(e)[:300],
        }

    def _incumbent_engine(self):
        from .frontend import NoRouteForShape

        try:
            return self._router.server_for(self._shape).engine
        except NoRouteForShape:
            return None

    # -- records --------------------------------------------------------------

    def record(self) -> dict:
        """JSON-able controller state (the ``lifecycle:<label>`` ``/statusz``
        section)."""
        return {
            "label": self.label,
            "state": self.state,
            "generation": self.generation,
            "shape": list(self._shape),
            "cooldown_s": self.config.cooldown_s,
            "cooldown_remaining_s": round(self.cooldown_remaining_s(), 3),
            "watching": bool(self._watcher is not None and self._watcher.is_alive()),
            "signals": {
                k: counters.get(k) - self._sig_base.get(k, 0) for k in WATCHED_COUNTERS
            },
            "last_cycle": self._last_cycle,
        }


def _featurizer_digest(obj) -> str:
    from . import snapshot as ksnap

    return ksnap.featurizer_digest(obj)
