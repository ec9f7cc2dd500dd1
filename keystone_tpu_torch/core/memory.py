"""HBM admission control: preflight memory planning and graceful
degradation (counterpart of the single-device half of
keystone_tpu/core/memory.py).

* :func:`hbm_budget` — the byte budget a fit may plan against:
  ``KEYSTONE_HBM_BUDGET`` (testing / policy override) or the card's free
  bytes, where the caching allocator's reserved-but-unused blocks count as
  free (``torch.cuda.mem_get_info`` counts them as used); ``None`` on the
  CPU, in which case admission is skipped, never guessed.
* :class:`MemoryPlan` / :func:`plan_program` / :func:`plan_bytes` —
  admit or deny a candidate program with the full breakdown.  PyTorch
  compiles nothing ahead of time, so there is no ``memory_analysis``:
  :func:`plan_program` sums the argument bytes from the tensors (or
  ``meta`` tensors) it is given, takes the output bytes from one run of the
  function on the ``meta`` device where the function allows it, and the
  temp bytes from the caller's ``min_temp_bytes``.  ``reported`` (the
  compiler's own numbers in the JAX package) stays None.
* :func:`run_ladder` — the degradation ladder: an ordered list of
  :class:`Tier` s walked with per-tier preflight; a denied tier is skipped
  with its reason counted, an admitted tier that still runs out of memory
  steps down exactly one tier.  The last tier is the floor.
* :class:`FitReport` — the audit trail estimators expose as
  ``last_fit_report``.
* :func:`plan_cache_bytes` — the auto-Cacher's admission gate
  (``core.optimize``), on one device.
* :func:`min_chip_budget` / :func:`shard_bytes` — per-slot admission of a
  mesh program (``parallel.mesh``): a slot gets its card's budget divided
  by the number of the mesh's slots on that card, so eight slots of one
  80 GB card are each admitted against an eighth of it, never
  the whole card; ``KEYSTONE_HBM_BUDGET`` keeps its per-card meaning.

Not ported: the compile cache (the port compiles nothing).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import re
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from . import profiler
from . import trace
from .resilience import counters

_logger = logging.getLogger("keystone_tpu_torch.memory")

#: env var: byte budget override ("2G", "512M", "1.5T", or plain bytes).
HBM_BUDGET_ENV = "KEYSTONE_HBM_BUDGET"

_SUFFIX = {"": 1, "K": 2**10, "M": 2**20, "G": 2**30, "T": 2**40}


def parse_bytes(spec: str | int | float) -> int:
    """``"16G"`` / ``"512M"`` / ``"1.5GB"`` / ``4096`` -> bytes."""
    if isinstance(spec, (int, float)):
        return int(spec)
    m = re.fullmatch(r"\s*([0-9]+(?:\.[0-9]+)?)\s*([KMGT]?)I?B?\s*", str(spec).upper())
    if not m:
        raise ValueError(
            f"cannot parse byte size {spec!r} (expected e.g. '16G', '512M', "
            "'1.5GB', or a plain byte count)"
        )
    return int(float(m.group(1)) * _SUFFIX[m.group(2)])


def fmt_bytes(b: int | float) -> str:
    """Human-scaled byte count for log/reason strings ('3.25GB', '514KB')."""
    b = float(b)
    for unit in ("B", "KB", "MB", "GB"):
        if abs(b) < 1024 or unit == "GB":
            return f"{b:.2f}{unit}" if unit != "B" else f"{int(b)}B"
        b /= 1024
    return f"{b:.2f}TB"  # pragma: no cover


def budget_is_live() -> bool:
    """True when :func:`hbm_budget` reads the card's live free bytes rather
    than the ``KEYSTONE_HBM_BUDGET`` capacity override.  A live budget
    already excludes device-resident inputs, so their bytes are credited
    back out of a plan's total (``resident_bytes``); a capacity budget
    charges them."""
    return not os.environ.get(HBM_BUDGET_ENV, "").strip()


def hbm_budget(device=None) -> int | None:
    """Bytes a program may plan against, or ``None`` when unknowable.

    Priority: ``KEYSTONE_HBM_BUDGET`` (capacity semantics) > the card's
    free bytes plus what the caching allocator reserved but holds in no
    tensor (``memory_reserved - memory_allocated``: free to this process,
    though ``mem_get_info`` reports it used) > ``None`` (the CPU:
    admission is skipped)."""
    raw = os.environ.get(HBM_BUDGET_ENV, "").strip()
    if raw:
        return parse_bytes(raw)
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    free, _total = torch.cuda.mem_get_info(dev)
    cached = torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
    return int(free) + max(0, int(cached))


def min_chip_budget(mesh) -> tuple[int | None, Any]:
    """``(budget_bytes, device)``: the SMALLEST per-slot byte budget across
    the mesh's slots and the device it came from: what a mesh program is
    admitted against, because every slot allocates its share and the
    tightest one is the one that runs out.

    A slot's budget is its device's :func:`hbm_budget` divided by the
    number of the mesh's slots on that device; ``KEYSTONE_HBM_BUDGET``
    keeps its per-card capacity meaning and is divided the same way.  If
    any device cannot report (the CPU without the override) the answer is
    ``(None, None)``: admission is skipped, never guessed from a subset."""
    from ..parallel.mesh import device_key

    slots: dict = {}
    for dev in mesh.devices.flat:
        d, n = slots.get(device_key(dev), (torch.device(dev), 0))
        slots[device_key(dev)] = (d, n + 1)
    worst: int | None = None
    worst_dev = None
    for dev, n in slots.values():
        free = hbm_budget(dev)
        if free is None:
            return None, None
        per_slot = free // n
        if worst is None or per_slot < worst:
            worst, worst_dev = per_slot, dev
    return worst, worst_dev


def shard_bytes(shape, dtype, mesh=None) -> int:
    """Per-slot bytes of one row-sharded array of global ``shape`` on
    ``mesh``: its block (rows padded to a multiple of the data axis, divided
    by it); without a mesh, the whole array."""
    shape = tuple(int(d) for d in shape)
    itemsize = dtype.itemsize if isinstance(dtype, torch.dtype) else np.dtype(dtype).itemsize
    rows = shape[0] if mesh is None else -(-shape[0] // mesh.shape["data"])
    return rows * int(np.prod(shape[1:])) * itemsize


@dataclasses.dataclass
class MemoryPlan:
    """Admit/deny verdict for one candidate program, with the evidence."""

    label: str
    admitted: bool
    reason: str
    budget_bytes: int | None = None
    argument_bytes: int = 0
    temp_bytes: int = 0
    output_bytes: int = 0
    alias_bytes: int = 0
    extra_bytes: int = 0  # persistent buffers outside the program's args
    resident_bytes: int = 0  # of total, already allocated on the device
    total_bytes: int = 0
    analyzed: bool = False  # False: no budget known, nothing reckoned
    #: The compiler's own byte figures in the JAX package; PyTorch has no
    #: ahead-of-time memory report, so this stays None.
    reported: dict | None = None
    error: str | None = None

    def breakdown(self) -> dict:
        """JSON-able record (GB, 3 decimals)."""
        gb = lambda b: round(b / 2**30, 3)  # noqa: E731
        out = {
            "admitted": self.admitted,
            "analyzed": self.analyzed,
            "argument_gb": gb(self.argument_bytes),
            "temp_gb": gb(self.temp_bytes),
            "output_gb": gb(self.output_bytes),
            "alias_gb": gb(self.alias_bytes),
            "extra_gb": gb(self.extra_bytes),
            "resident_gb": gb(self.resident_bytes),
            "total_gb": gb(self.total_bytes),
            "budget_gb": gb(self.budget_bytes) if self.budget_bytes else None,
            "reason": self.reason,
        }
        if self.error:
            out["error"] = self.error[:200]
        return out


def _admission_event(plan: MemoryPlan) -> MemoryPlan:
    """Every admission decision is a point event on the trace timeline;
    its args are ``plan.breakdown()``."""
    trace.instant("hbm_admission", **{"label": plan.label, **plan.breakdown()})
    return plan


_UNSET = object()
#: (id(fn), arg signature) -> reckoned argument/output bytes; admission is
#: re-evaluated against the current budget on every call.
_plan_cache: dict = {}


def clear_plan_cache() -> None:
    _plan_cache.clear()


def _cache_key(fn, args, kwargs):
    sig = []
    for a in (*args, *sorted(kwargs.items())):
        if isinstance(a, torch.Tensor):
            sig.append(("t", tuple(a.shape), str(a.dtype)))
        else:
            sig.append(("static", repr(a)))
    return (id(fn), tuple(sig))


def _meta(a):
    return torch.empty(a.shape, dtype=a.dtype, device="meta") if isinstance(a, torch.Tensor) else a


def _output_bytes(fn, args, kwargs) -> tuple[int, str | None]:
    """Output bytes of ``fn`` from one run on ``meta`` tensors (nothing is
    allocated), or 0 and the reason when the function cannot run there
    (a hand kernel, a host round trip)."""
    try:
        out = fn(*(_meta(a) for a in args), **{k: _meta(v) for k, v in kwargs.items()})
    except Exception as e:  # noqa: BLE001 — a function without a meta path
        return 0, f"{type(e).__name__}: {e}"[:200]
    return array_bytes(*_tensor_leaves(out)), None


def _tensor_leaves(obj) -> list:
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (list, tuple)):
        return [t for o in obj for t in _tensor_leaves(o)]
    if isinstance(obj, dict):
        return [t for o in obj.values() for t in _tensor_leaves(o)]
    return []


def plan_program(
    fn,
    *args,
    label: str = "program",
    budget: int | None | object = _UNSET,
    extra_bytes: int = 0,
    min_temp_bytes: int = 0,
    resident_bytes: int = 0,
    require_analysis: bool = False,
    meta_run: bool = True,
    **kwargs,
) -> MemoryPlan:
    """Preflight ``fn`` on ``args`` (tensors of any device, ``meta``
    included: planning allocates nothing).  When a budget is known (or
    ``require_analysis``), admission compares

        argument + min_temp_bytes + output + extra

    against the budget; ``resident_bytes`` of that total already on the
    device are credited against a live budget (:func:`budget_is_live`).
    Argument bytes are the tensors' own; output bytes come from a ``meta``
    run of ``fn`` (0, with the reason in ``error``, where it has none).
    ``meta_run=False`` skips that run, for a function that holds tensors on
    a device: mixed with a ``meta`` argument it can only fail, and its first
    failure in a process imports ``torch._dynamo`` (seconds).
    With no budget and no ``require_analysis`` the plan is a pass-through:
    admitted, unanalyzed.  Denials are counted (``hbm_preflight_denied``)."""
    if budget is _UNSET:
        budget = hbm_budget()
    if budget is None and not require_analysis:
        return _admission_event(MemoryPlan(
            label=label,
            admitted=True,
            reason=(
                "no HBM budget known (no CUDA card and "
                f"{HBM_BUDGET_ENV} unset) — admission skipped"
            ),
        ))
    key = _cache_key(fn, args, kwargs)
    cached = _plan_cache.get(key)
    if cached is None:
        out_bytes, err = (
            _output_bytes(fn, args, kwargs) if meta_run else (0, "no meta run (meta_run=False)")
        )
        cached = _plan_cache[key] = {
            "argument": array_bytes(*(a for a in (*args, *kwargs.values()) if isinstance(a, torch.Tensor))),
            "output": out_bytes,
            "error": err,
        }
    arg_bytes, out_bytes = cached["argument"], cached["output"]
    temp = int(min_temp_bytes)
    total = arg_bytes + temp + out_bytes + int(extra_bytes)
    credit = int(resident_bytes) if budget_is_live() else 0
    admitted = budget is None or total - credit <= budget
    h = fmt_bytes
    reason = (
        f"args {h(arg_bytes)} + temp {h(temp)} + out {h(out_bytes)} "
        f"+ extra {h(extra_bytes)} = {h(total)}"
        + (f" (- {h(credit)} already resident)" if credit else "")
        + (f" vs budget {h(budget)}" if budget is not None else " vs no budget")
    )
    plan = MemoryPlan(
        label=label,
        admitted=admitted,
        reason=("fits: " if admitted else "DENIED: ") + reason,
        budget_bytes=budget,
        argument_bytes=arg_bytes,
        temp_bytes=temp,
        output_bytes=out_bytes,
        extra_bytes=int(extra_bytes),
        resident_bytes=int(resident_bytes),
        total_bytes=total,
        analyzed=True,
        error=cached["error"],
    )
    if not admitted:
        counters.record("hbm_preflight_denied", f"{label}: {reason}")
    return _admission_event(plan)


def plan_bytes(
    label: str,
    *,
    argument_bytes: int = 0,
    temp_bytes: int = 0,
    output_bytes: int = 0,
    extra_bytes: int = 0,
    resident_bytes: int = 0,
    budget: int | None | object = _UNSET,
) -> MemoryPlan:
    """Analytic admission from caller-supplied byte figures: no run of the
    program.  Same budget and credit semantics as :func:`plan_program`;
    denials are counted under ``hbm_preflight_denied``."""
    if budget is _UNSET:
        budget = hbm_budget()
    total = int(argument_bytes + temp_bytes + output_bytes + extra_bytes)
    fields = dict(
        argument_bytes=int(argument_bytes), temp_bytes=int(temp_bytes),
        output_bytes=int(output_bytes), extra_bytes=int(extra_bytes),
        resident_bytes=int(resident_bytes), total_bytes=total,
    )
    if budget is None:
        return _admission_event(MemoryPlan(
            label=label,
            admitted=True,
            reason=(
                "no HBM budget known (no CUDA card and "
                f"{HBM_BUDGET_ENV} unset) — analytic admission skipped"
            ),
            **fields,
        ))
    credit = int(resident_bytes) if budget_is_live() else 0
    admitted = total - credit <= budget
    h = fmt_bytes
    reason = (
        ("fits: " if admitted else "DENIED: ")
        + f"analytic args {h(argument_bytes)} + temp {h(temp_bytes)} + "
        f"out {h(output_bytes)} + extra {h(extra_bytes)} = {h(total)}"
        + (f" (- {h(credit)} already resident)" if credit else "")
        + f" vs budget {h(budget)} (no compile)"
    )
    plan = MemoryPlan(
        label=label, admitted=admitted, reason=reason, budget_bytes=budget,
        analyzed=False, **fields,
    )
    if not admitted:
        counters.record("hbm_preflight_denied", f"{label}: {reason}")
    return _admission_event(plan)


def plan_batch(
    planners: Sequence[tuple[str, Callable[[], MemoryPlan]]],
) -> dict[str, MemoryPlan]:
    """Evaluate every ``(label, planner)`` pair; a planner that raises
    becomes a denied plan carrying the error."""
    out: dict[str, MemoryPlan] = {}
    for label, planner in planners:
        try:
            out[label] = planner()
        except Exception as e:  # noqa: BLE001 — a failed plan IS a deny
            out[label] = _admission_event(MemoryPlan(
                label=label,
                admitted=False,
                reason=f"planner failed: {type(e).__name__}: {e}"[:200],
                error=f"{type(e).__name__}: {e}"[:300],
            ))
    return out


def plan_cache_bytes(
    label: str,
    nbytes: int,
    *,
    mesh=None,
    budget: int | None | object = _UNSET,
    headroom: float = 0.5,
) -> MemoryPlan:
    """Admit or deny holding ``nbytes`` of materialized intermediates
    resident on the card — the auto-Cacher's admission gate
    (core.optimize).  Data only, so admission is a straight byte comparison
    against ``headroom`` of :func:`hbm_budget`, or under a ``mesh`` of
    :func:`min_chip_budget` (callers divide a sharded cache's bytes per
    slot first): a cache that fills all free memory starves the very solve
    it was meant to speed up, so the default admits at most half.  No
    budget known -> admitted unanalysed (the CPU), never guessed.  Denials
    are counted under ``cache_admission_denied`` and every verdict is an
    ``hbm_admission`` trace event."""
    if mesh is not None and budget is _UNSET:
        budget, _worst = min_chip_budget(mesh)
    if budget is _UNSET:
        budget = hbm_budget()
    if budget is None:
        return _admission_event(MemoryPlan(
            label=label,
            admitted=True,
            # The JAX package's words: a decision table reads the same in
            # either package.
            reason=(
                "no HBM budget known (no device memory_stats and "
                f"{HBM_BUDGET_ENV} unset) — cache admission skipped"
            ),
            output_bytes=int(nbytes),
            total_bytes=int(nbytes),
        ))
    allowed = int(budget * headroom)
    admitted = int(nbytes) <= allowed
    h = fmt_bytes
    reason = (
        ("fits: " if admitted else "DENIED: ")
        + ("per-chip " if mesh is not None else "")
        + f"cached {h(nbytes)} vs {h(allowed)} "
        f"(budget {h(budget)} x headroom {headroom})"
    )
    plan = MemoryPlan(
        label=label,
        admitted=admitted,
        reason=reason,
        budget_bytes=allowed,
        output_bytes=int(nbytes),
        total_bytes=int(nbytes),
        analyzed=True,
    )
    if not admitted:
        counters.record("cache_admission_denied", f"{label}: {reason}")
    return _admission_event(plan)


# -- OOM detection / recovery -------------------------------------------------

_OOM_MARKERS = ("CUDA out of memory", "RESOURCE_EXHAUSTED", "Out of memory", "out of memory")


class LadderSourceLost(RuntimeError):
    """A ladder tier cannot run because its data source is gone.
    Deliberately NOT an OOM: the ladder must surface it, not retry
    through it."""


def is_oom_error(e: BaseException) -> bool:
    """True for device-memory exhaustion (``torch.OutOfMemoryError``, or a
    ``RuntimeError``/``MemoryError`` carrying the allocator's "CUDA out of
    memory" text) — the only failure the ladder retries; everything else,
    :class:`LadderSourceLost` included, propagates unchanged."""
    if isinstance(e, LadderSourceLost):
        return False
    if isinstance(e, (torch.OutOfMemoryError, MemoryError)):
        return True
    if not isinstance(e, RuntimeError):
        return False
    msg = str(e)
    return any(m in msg for m in _OOM_MARKERS)


def free_buffers(*tensors) -> None:
    """Best-effort immediate release of device buffers (OOM recovery frees
    the failed tier's live tensors before a cheaper tier runs): each CUDA
    tensor's storage is emptied, then the allocator's cache returned."""
    freed = False
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.device.type == "cuda":
            try:
                t.untyped_storage().resize_(0)
                freed = True
            except Exception:  # noqa: BLE001 — freeing is advisory
                pass
    if freed:
        torch.cuda.empty_cache()


def array_bytes(*shaped) -> int:
    """Σ bytes of tensors / numpy arrays (anything with ``shape`` and
    ``dtype``); None entries are skipped."""
    total = 0
    for s in shaped:
        if s is None:
            continue
        if isinstance(s, torch.Tensor):
            total += s.numel() * s.element_size()
            continue
        n = 1
        for dim in s.shape:
            n *= int(dim)
        total += n * np.dtype(s.dtype).itemsize
    return total


# -- the degradation ladder ---------------------------------------------------


@dataclasses.dataclass
class Tier:
    """One rung: ``plan`` is lazy (called at selection time), ``run`` gets
    the plan back; ``flops`` is the tier's hand-derived flop count, which
    a profiled run audits against the flops it counts."""

    name: str
    plan: Callable[[], MemoryPlan]
    run: Callable[[MemoryPlan], Any]
    flops: float | None = None


@dataclasses.dataclass
class FitReport:
    """Audit trail of one laddered fit (``estimator.last_fit_report``)."""

    label: str = ""
    budget_bytes: int | None = None
    plans: dict = dataclasses.field(default_factory=dict)
    chosen: str | None = None
    denials: list = dataclasses.field(default_factory=list)
    oom_retries: list = dataclasses.field(default_factory=list)
    #: the profiler's plan audit of the chosen tier (charge against the
    #: phase watermark), when the profiler was on.
    plan_audit: dict | None = None
    #: the placement search's program fingerprint (set by
    #: ``autoshard.run_search``): the key the profiler's watermark drift
    #: rows join the same program family as the time outcomes under.
    fingerprint: str | None = None
    #: the (data, model) axis sizes of the mesh that ran the solve; None on
    #: one device.
    mesh_shape: dict | None = None
    #: the ``autoshard.PlacementPlan`` record of the searched ranking this
    #: fit ran through; None when the fit walked the hand ladder.
    placement: dict | None = None
    #: ``core.numerics`` on: the per-block κ estimates of the fit's design
    #: matrix (``numerics.design_conditioning``); None when it was off.
    conditioning: list | None = None

    def record(self) -> dict:
        """JSON-able form."""
        from . import telemetry

        return {
            "chosen_tier": self.chosen,
            "conditioning": list(self.conditioning) if self.conditioning else None,
            "mesh_shape": dict(self.mesh_shape) if self.mesh_shape else None,
            "budget_gb": round(self.budget_bytes / 2**30, 3) if self.budget_bytes else None,
            "denials": list(self.denials),
            "oom_retries": list(self.oom_retries),
            "tiers": {k: p.breakdown() for k, p in self.plans.items()},
            "placement": self.placement,
            "plan_audit": self.plan_audit,
            "postmortems": telemetry.postmortem_paths(),
        }

    def summary(self) -> str:
        s = f"{self.label}: tier={self.chosen}"
        if self.mesh_shape:
            s += f", mesh={self.mesh_shape}"
        if self.denials:
            s += f", denied={self.denials}"
        if self.oom_retries:
            s += f", oom_retries={self.oom_retries}"
        return s

    def degraded(self) -> bool:
        return bool(self.denials or self.oom_retries)


def run_ladder(label: str, tiers: Sequence[Tier], report: FitReport):
    """Walk ``tiers`` best-first: preflight each lazily, run the first
    admitted one, and on a runtime out-of-memory step down exactly one
    tier (the failed tier's tensors die with its frame; the allocator's
    cache is returned before the next tier).  The final tier is the floor:
    it runs even when its preflight is a deny, with a warning.  Every
    considered tier's plan lands in ``report``.  With the profiler on, the
    chosen tier's synchronized wall and counted flops land in the ledger,
    its flops hint is audited, and its plan is audited against the HBM
    watermark of the solve's phase."""
    report.label = label
    last_oom: BaseException | None = None
    with trace.span(f"solve:{label}", cat="solve") as solve_sp:
        for i, tier in enumerate(tiers):
            floor = i == len(tiers) - 1
            with trace.span(f"plan:{tier.name}", cat="solve", solve=label):
                plan = tier.plan()
            report.plans[tier.name] = plan
            if plan.budget_bytes is not None:
                report.budget_bytes = plan.budget_bytes
            if not plan.admitted and not floor:
                report.denials.append(tier.name)
                _logger.info("%s: %s denied by preflight — %s", label, tier.name, plan.reason)
                continue
            if not plan.admitted and floor:
                _logger.warning(
                    "%s: floor tier %s denied by preflight (%s) but nothing is "
                    "below it — attempting anyway", label, tier.name, plan.reason,
                )
            counted = {"flops": None}
            failed = None
            try:
                with trace.span(
                    f"tier:{tier.name}", cat="solve", solve=label, admitted=plan.admitted,
                ), profiler.phase(f"solve:{label}"):
                    if profiler.enabled():
                        profiler.sync_device()
                        t_run = time.perf_counter()
                        with profiler.counting_flops() as counted:
                            out = tier.run(plan)
                        wall = profiler.synced_wall(out, t_run)
                    else:
                        out = tier.run(plan)
            except Exception as e:  # noqa: BLE001 — only OOM is retried
                if not is_oom_error(e) or floor:
                    raise
                report.oom_retries.append(tier.name)
                counters.record(
                    "solver_oom_retry",
                    f"{label}/{tier.name}: out of device memory at runtime "
                    f"(preflight said: {plan.reason}) — stepping down one tier",
                )
                # Drop the traceback: its frames hold the failed tier's
                # tensors, which must be freed before the next tier runs.
                failed = e.with_traceback(None)
            if failed is not None:
                last_oom = failed
                if torch.cuda.is_available():
                    torch.cuda.empty_cache()
                continue
            report.chosen = tier.name
            if report.degraded() or tier.name != tiers[0].name:
                counters.record("solver_tier_degraded", report.summary())
            _logger.info("%s: running tier=%s (%s)", label, tier.name, plan.reason)
            if profiler.enabled():
                name = f"{label}:{tier.name}"
                profiler.record_program(name, wall, flops=counted["flops"])
                profiler.audit_flops(name, tier.flops, counted["flops"])
                report.plan_audit = profiler.audit_plan(
                    name, plan, phase_name=f"solve:{label}",
                    fingerprint=report.fingerprint,
                )
            solve_sp.set(report=report.record())
            return out
        raise RuntimeError(f"{label}: every ladder tier failed") from last_oom


def log_fit_report(est, logger=None, label: str = "") -> None:
    """Workload fit-path hook: surface which tier a solve actually ran on
    (one INFO line; degradations are already counted by the ladder)."""
    rep = getattr(est, "last_fit_report", None)
    if rep is None:
        return
    lg = logger or _logger
    lg.info("%s%s", f"{label}: " if label else "", rep.summary())
