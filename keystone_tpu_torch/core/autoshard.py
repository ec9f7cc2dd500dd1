"""Automated placement search: cost-model-ranked plans replace the hand
ladders (counterpart of keystone_tpu/core/autoshard.py, single device).

The degradation ladder (``core.memory.run_ladder``) encodes placement as a
hand-written list: fused -> stepwise -> host-staged.  Given a solve's
candidate executions, the search

1. **prunes** candidates with the zero-cost analytic batch preflight
   (``core.memory.plan_bytes`` / ``plan_batch``: nothing runs; a denied
   plan is free to reject, and each tier's own preflight still guards
   whatever the ladder later selects);
2. **scores** survivors with the shared cost model
   (``core.optimize.CostModel``): an analytic roofline prior over bytes,
   FLOPs, dispatches and transfer volume, multiplied by a calibration
   learned from MEASURED outcomes in the persistent plan-outcome log
   (``~/.keystone_plans.jsonl``, keyed by program fingerprint);
3. **ranks** with a confidence margin: candidates whose predicted costs are
   within one margin FACTOR of the cheapest remaining candidate keep their
   prior (hand-ladder) order (:data:`UNTRAINED_MARGIN` cold,
   :data:`TRAINED_MARGIN` for pairs where BOTH sides carry >=
   :data:`MIN_TRAIN` direct measurements), so an empty log reproduces the
   hand ladder bit for bit; the resilience floor is pinned last;
4. **runs** the ranked list through the same ``run_ladder`` contract: each
   tier preflighted at selection, a runtime out-of-memory error steps down
   the RANKED list one plan at a time (counted ``autoshard_stepdown``),
   typed errors propagate, and the candidate table with its deny/score
   rationale and the chosen plan's predicted-vs-measured cost lands in the
   :class:`PlacementPlan` attached to the solver's ``FitReport``.

Below :data:`MIN_TRAIN` direct measurements a candidate's factor comes
from the cross-program regression (``core.optimize.CalibrationModel``)
over every program's logged outcomes, then from the program's pooled
median.  Only direct measurements tighten the margin.

The plan-outcome log is the JAX package's JSON, line for line: a log
written by either package is read by the other and by
``tools/plan_view.py``.

``KEYSTONE_AUTOSHARD=0`` restores the hand ladders; ``fit(plan=...)``
overrides per call (``False`` hand, ``True`` force search, a
:class:`PlacementPlan` or name list replays a previous ranking).
``KEYSTONE_PLAN_LOG`` points the outcome log elsewhere (``off`` disables);
``KEYSTONE_PLAN_LOG_MAX`` caps its entry count (oldest-first compaction on
write).  The log is read ONCE per process: outcomes appended during a run
train the NEXT process, so a ranking never changes between a baseline and
a comparison fit inside one process.

The mesh candidates come from the block solvers' mesh ladders
(``solvers.block``, ``solvers.weighted``): every ``(data, model)``
factorization of the mesh's slots in the default layout, then, per mesh,
the per-operand spec assignments (``Candidate.specs``, e.g. the class
columns of the labels over the model axis).  A spec string names one mesh
axis over one dimension (``data@dim0``, ``model@dim1``) or full
replication (``replicated``); :func:`spec_pspec` lowers it to the
per-dimension axis names of the JAX ``PartitionSpec`` and
:func:`spec_sharding` to a ``parallel.mesh.SpecSharding`` that places a
tensor on the mesh's slots, so a spec candidate executes a real layout and
its hints charge that layout's bytes (:func:`spec_chip_bytes`).
``KEYSTONE_AUTOSHARD_SPECS=0`` drops the spec candidates (one layout per
mesh shape).
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import logging
import os
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from . import memory as kmem
from . import optimize as kopt
from . import trace
from .resilience import counters

_logger = logging.getLogger("keystone_tpu_torch.autoshard")

#: env var: "0"/"off"/"false" restores the hand ladders process-wide.
AUTOSHARD_ENV = "KEYSTONE_AUTOSHARD"

#: env var: "0"/"off"/"false" drops the per-operand SPEC candidates
#: from the enumeration (one layout per mesh shape).
SPECS_ENV = "KEYSTONE_AUTOSHARD_SPECS"

#: env var: plan-outcome log path; default ``~/.keystone_plans.jsonl``;
#: "0"/"off"/"none" disables persistence.
PLAN_LOG_ENV = "KEYSTONE_PLAN_LOG"
_DEFAULT_PLAN_LOG = "~/.keystone_plans.jsonl"

#: env var: plan-outcome log entry cap (oldest-first compaction on write);
#: "0"/"off" disables capping.
PLAN_LOG_MAX_ENV = "KEYSTONE_PLAN_LOG_MAX"
_DEFAULT_PLAN_LOG_MAX = 20_000

#: measurements per (fingerprint, candidate) before its calibration counts.
MIN_TRAIN = 3
#: cold-start ranking margin: an untrained analytic score must beat the
#: cheapest remaining candidate by this FACTOR before reordering past a
#: prior-earlier plan.
UNTRAINED_MARGIN = 4.0
#: margin for a pair of candidates that BOTH carry >= MIN_TRAIN direct
#: measured outcomes.
TRAINED_MARGIN = 1.15

#: bound on how much of the log one process will read back (newest wins).
_MAX_LOG_RECORDS = 50_000


def _env_off(name: str) -> bool:
    return os.environ.get(name, "").strip().lower() in ("0", "off", "false")


def enabled() -> bool:
    """Search is the default; ``KEYSTONE_AUTOSHARD=0`` restores the hand
    ladders."""
    return not _env_off(AUTOSHARD_ENV)


def specs_enabled() -> bool:
    """Spec-assignment candidates are enumerated by default when the search
    runs; ``KEYSTONE_AUTOSHARD_SPECS=0`` leaves one layout per mesh shape."""
    return not _env_off(SPECS_ENV)


# -- program fingerprints ------------------------------------------------------


def fingerprint(label: str, *parts) -> str:
    """Stable 16-hex-char fingerprint of a solve program's cost identity:
    the label plus whatever shapes, dtypes, statics and device description
    the caller folds in."""
    blob = json.dumps([label, *map(str, parts)], sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def device_fingerprint(devices=None) -> str:
    """``'cuda x1'``-style description of the device set a plan assumed:
    the device type and the count (``parallel.mesh.default_devices`` when
    None).  Mesh slots that share a device say so (``'cuda x8 on 1'``: eight
    slots of one card), so their outcomes never calibrate a mesh of
    distinct cards, nor the other way round."""
    from ..parallel.mesh import default_devices

    try:
        devices = [torch.device(d) for d in
                   (devices if devices is not None else default_devices())]
        out = f"{devices[0].type} x{len(devices)}"
        distinct = len({(d.type, d.index or 0) for d in devices})
        return out if distinct == len(devices) else f"{out} on {distinct}"
    except (IndexError, RuntimeError, TypeError):
        return "unknown x0"


# -- the sharding-spec vocabulary ----------------------------------------------


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return np.dtype(dtype).itemsize


def spec_candidates(aval, mesh_shape: dict) -> list[dict]:
    """Candidate shardings for ONE operand (anything with ``shape`` and a
    numpy or torch ``dtype``) under a (data, model) mesh shape, from its
    own dimensions: the data axis over any evenly-divisible dim, the model
    axis over any other evenly-divisible dim, and replicated (always
    legal).  Each entry carries the spec's per-chip bytes."""
    shape = tuple(int(d) for d in aval.shape)
    itemsize = _itemsize(aval.dtype)
    total = int(np.prod(shape)) * itemsize if shape else itemsize
    out = [{"spec": "replicated", "per_chip_bytes": total}]
    d_sz = int(mesh_shape.get("data", 1))
    m_sz = int(mesh_shape.get("model", 1))
    for dim, n in enumerate(shape):
        if d_sz > 1 and n % d_sz == 0:
            out.append({"spec": f"data@dim{dim}", "per_chip_bytes": total // d_sz})
        if m_sz > 1 and n % m_sz == 0:
            out.append({"spec": f"model@dim{dim}", "per_chip_bytes": total // m_sz})
    return out


def best_spec(aval, mesh_shape: dict) -> dict:
    """The minimum-per-chip-bytes legal sharding for one operand
    (replicated when nothing divides)."""
    cands = spec_candidates(aval, mesh_shape)
    return min(cands, key=lambda c: (c["per_chip_bytes"], c["spec"]))


def spec_pspec(spec: str, ndim: int) -> tuple:
    """Lower one spec string to the mesh axis of each of ``ndim``
    dimensions: the tuple of the JAX ``PartitionSpec`` it names
    (``"model@dim1"``, 2 -> ``(None, "model")``)."""
    from ..parallel.mesh import DATA_AXIS, MODEL_AXIS

    if spec == "replicated":
        return (None,) * ndim
    axis, sep, dim = spec.partition("@dim")
    if not sep or axis not in ("data", "model") or not dim.isdigit():
        raise ValueError(
            f"bad sharding spec {spec!r} (want 'replicated', 'data@dimN' or 'model@dimN')"
        )
    i = int(dim)
    if i >= ndim:
        raise ValueError(f"spec {spec!r} names dim {i} of a {ndim}-d operand")
    parts: list = [None] * ndim
    parts[i] = DATA_AXIS if axis == "data" else MODEL_AXIS
    return tuple(parts)


def spec_sharding(spec: str, mesh, ndim: int):
    """Lower one spec string to the layout on ``mesh`` that the mesh tiers
    place an operand with (``parallel.mesh.SpecSharding``; its ``place``
    builds the per-slot record)."""
    from ..parallel.mesh import SpecSharding

    return SpecSharding(mesh, spec_pspec(spec, ndim))


def spec_chip_bytes(shape, dtype, spec: str, mesh_shape: dict) -> int:
    """Analytic per-chip bytes of one operand under one spec.  The named
    dimension must divide evenly."""
    shape = tuple(int(d) for d in shape)
    total = int(np.prod(shape)) * _itemsize(dtype) if shape else _itemsize(dtype)
    if spec == "replicated":
        return total
    axis, _, dim = spec.partition("@dim")
    size = int(mesh_shape.get(axis, 1))
    n = shape[int(dim)]
    if size <= 1:
        return total
    if n % size:
        raise ValueError(f"spec {spec!r} does not divide dim of size {n} by {size}")
    return total // size


def spec_tag(specs: dict | None) -> str:
    """Compact tag for a spec assignment: ``'labels=model@dim1,models=rep'``."""
    if not specs:
        return "default"
    return ",".join(
        f"{k}={'rep' if v == 'replicated' else v}" for k, v in sorted(specs.items())
    )


# -- the plan-outcome log ------------------------------------------------------


def plan_log_path() -> str | None:
    raw = os.environ.get(PLAN_LOG_ENV, "").strip()
    if raw.lower() in ("0", "off", "none"):
        return None
    return os.path.expanduser(raw or _DEFAULT_PLAN_LOG)


def hermetic_plan_log() -> str:
    """Point the plan-outcome log at a fresh throwaway file and forget any
    cached read.  For measurement runs (``chip_smoke.py``): their
    fixed-seed fits must neither TRAIN the operator's real log nor evict
    real workload records from its bounded tail."""
    import tempfile

    path = os.path.join(tempfile.mkdtemp(prefix="keystone_plans_hermetic_"), "plans.jsonl")
    os.environ[PLAN_LOG_ENV] = path
    clear_outcome_cache()
    return path


def plan_log_max() -> int | None:
    """Entry cap on the plan-outcome log (``KEYSTONE_PLAN_LOG_MAX``;
    default 20k, ``0``/``off`` disables).  Raises ``ValueError`` for a
    malformed or negative value; the append path catches it."""
    raw = os.environ.get(PLAN_LOG_MAX_ENV, "").strip()
    if not raw:
        return _DEFAULT_PLAN_LOG_MAX
    if raw.lower() in ("0", "off", "none"):
        return None
    try:
        val = int(raw)
    except ValueError:
        raise ValueError(f"{PLAN_LOG_MAX_ENV}={raw!r} is not an integer") from None
    if val < 1:
        raise ValueError(f"{PLAN_LOG_MAX_ENV}={raw!r} must be >= 1 (or 'off')")
    return val


#: newest records kept per (fingerprint, candidate) when compaction must
#: drop history (an odd count keeps the median an actual sample).
_COMPACT_KEEP_PAIR = 9


@contextlib.contextmanager
def _log_lock(path: str):
    """Advisory exclusive lock (sidecar ``<path>.lock``) serializing log
    appends against compaction's read-rewrite-replace.  Best-effort: where
    ``fcntl`` or the sidecar is unavailable, appends go unlocked."""
    lf = None
    try:
        try:
            import fcntl

            lf = open(path + ".lock", "a")
            fcntl.flock(lf, fcntl.LOCK_EX)
        except (ImportError, OSError):
            lf = None
        yield
    finally:
        if lf is not None:
            try:
                lf.close()  # closing the fd releases the flock
            except OSError:
                pass


def compact_log(path: str, cap: int) -> int:
    """Oldest-first compaction of the outcome log to a watermark below
    ``cap`` (about 90 %): (1) per (fingerprint, candidate) pair keep the
    newest :data:`_COMPACT_KEEP_PAIR` records; (2) if still over, evict
    whole pairs, least-recently-written first, never the last one; (3) a
    lone surviving pair still over the watermark trims to its newest
    records.  Never wipes the log.  Atomic rewrite; returns the surviving
    record count."""
    with _log_lock(path):
        return _compact_locked(path, cap)


def _compact_locked(path: str, cap: int) -> int:
    try:
        with open(path) as f:
            lines = [ln for ln in (raw.strip() for raw in f) if ln]
    except OSError:
        return 0
    if len(lines) <= cap:
        return len(lines)
    target = max(1, cap - max(1, cap // 10))
    parsed: list = []
    for i, ln in enumerate(lines):
        try:
            r = json.loads(ln)
        except json.JSONDecodeError:
            continue  # a torn line never survives compaction
        parsed.append((i, (r.get("fingerprint"), r.get("candidate")), ln))
    by_pair: dict = {}
    for i, pair, ln in parsed:
        by_pair.setdefault(pair, []).append((i, ln))
    keep = max(1, min(_COMPACT_KEEP_PAIR, target))
    kept_pairs = {p: rows[-keep:] for p, rows in by_pair.items()}
    pairs_by_recency = sorted(kept_pairs, key=lambda p: kept_pairs[p][-1][0])
    total = sum(len(rows) for rows in kept_pairs.values())
    for p in pairs_by_recency:
        if total <= target or len(kept_pairs) == 1:
            break
        total -= len(kept_pairs.pop(p))
    if total > target:  # one pair left: trim, never wipe
        p = next(iter(kept_pairs))
        kept_pairs[p] = kept_pairs[p][-target:]
    survivors = sorted(
        (row for rows in kept_pairs.values() for row in rows), key=lambda row: row[0]
    )
    tmp = f"{path}.compact.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write("".join(ln + "\n" for _i, ln in survivors))
    os.replace(tmp, path)
    return len(survivors)


#: floor on one serialized outcome record's size, converting entries of
#: headroom into bytes of growth for the cap prechecks.
_MIN_RECORD_BYTES = 64

#: path -> byte size below which the file provably holds <= cap entries,
#: so the O(entries) recount runs once per cap's worth of growth.
_compact_skip: dict[str, int] = {}


def append_outcome(record: dict) -> None:
    """Best-effort append of one plan outcome to the persistent log,
    compacting first when it exceeds ``KEYSTONE_PLAN_LOG_MAX`` entries.  A
    broken log path or a malformed cap degrades counted
    (``plan_log_write_failed``): a solve never depends on telemetry."""
    path = plan_log_path()
    if path is None:
        return
    try:
        parent = os.path.dirname(os.path.abspath(path))
        if parent:
            os.makedirs(parent, exist_ok=True)
        cap = plan_log_max()
        with _log_lock(path):
            if cap is not None and os.path.exists(path):
                size = os.path.getsize(path)
                floor = max(cap * _MIN_RECORD_BYTES, _compact_skip.get(path, 0))
                if size > floor:
                    kept = _compact_locked(path, cap)
                    size_now = os.path.getsize(path)
                    rec_bytes = max(_MIN_RECORD_BYTES, size_now // max(1, kept))
                    _compact_skip[path] = size_now + max(0, cap - kept) * rec_bytes
            with open(path, "a") as f:
                f.write(json.dumps(record) + "\n")
    except (OSError, ValueError) as e:
        counters.record("plan_log_write_failed", f"{path}: {e}")


#: path -> parsed records, read once per process.
_outcome_cache: dict[str, list] = {}


def load_outcomes(path: str | None = None) -> list[dict]:
    path = path if path is not None else plan_log_path()
    if path is None:
        return []
    cached = _outcome_cache.get(path)
    if cached is not None:
        return cached
    records: list[dict] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    records.append(json.loads(line))
                except json.JSONDecodeError:
                    continue  # a torn tail line is not an error
    except OSError:
        records = []
    records = records[-_MAX_LOG_RECORDS:]
    _outcome_cache[path] = records
    return records


def clear_outcome_cache() -> None:
    """Test seam: forget the once-per-process log read."""
    _outcome_cache.clear()
    _ratio_cache.clear()
    _model_cache.clear()
    _drift_model_cache.clear()
    _compact_skip.clear()


#: path -> ({(fingerprint, candidate): ratios}, {fingerprint: ratios},
#: model_rows): one pass over the log per process.
_ratio_cache: dict[str, tuple[dict, dict, list]] = {}

#: path -> fitted cross-program model (or None), fitted once per process.
_model_cache: dict[str, object] = {}


def _ratio_index(path: str | None) -> tuple[dict, dict, list]:
    key = path if path is not None else (plan_log_path() or "")
    cached = _ratio_cache.get(key)
    if cached is not None:
        return cached
    by_pair: dict = {}
    by_fp: dict = {}
    rows: list = []
    for r in load_outcomes(path):
        if not (
            r.get("outcome") == "ok"
            and r.get("predicted_seconds")
            and r.get("measured_seconds")
        ):
            continue
        # The regression learns measured vs the RAW analytic prior;
        # records without one fall back to predicted.
        ratio = r["measured_seconds"] / r["predicted_seconds"]
        fp = r.get("fingerprint")
        by_pair.setdefault((fp, r.get("candidate")), []).append(ratio)
        by_fp.setdefault(fp, []).append(ratio)
        feats = r.get("features")
        raw = r.get("raw_seconds")
        if isinstance(feats, dict) and feats:
            rows.append((fp, feats, r["measured_seconds"] / raw if raw else ratio))
    _ratio_cache[key] = (by_pair, by_fp, rows)
    return by_pair, by_fp, rows


def model_rows(path: str | None = None) -> list:
    """The cross-program training rows the log holds:
    ``[(fingerprint, features, measured/raw_ratio)]``."""
    return list(_ratio_index(path)[2])


# -- the device-memory watermark drift calibration -----------------------------

#: path -> fitted byte-drift model (or None), fitted once per process.
_drift_model_cache: dict[str, object] = {}


def hbm_features(
    argument_bytes: float,
    temp_bytes: float,
    output_bytes: float,
    mesh_axes: dict | None,
) -> dict:
    """Featurize one program's CHARGED byte composition for the byte-drift
    calibration: the same vector whether the row comes from a watermark
    audit (``core.profiler.audit_plan``) or a search candidate's hints."""
    charged = float(argument_bytes) + float(temp_bytes) + float(output_bytes)
    return {
        "kind": "hbm",
        "log_charged": float(np.log1p(charged)),
        "log_args": float(np.log1p(float(argument_bytes))),
        "log_temp": float(np.log1p(float(temp_bytes))),
        "log_out": float(np.log1p(float(output_bytes))),
        "data_axis": float((mesh_axes or {}).get("data", 1)),
        "model_axis": float((mesh_axes or {}).get("model", 1)),
    }


def drift_rows(path: str | None = None) -> list:
    """``[(fingerprint, features, watermark/charged_ratio)]`` over the
    ``outcome: "hbm_drift"`` rows ``core.profiler.audit_plan`` appends."""
    rows = []
    for r in load_outcomes(path):
        if r.get("outcome") != "hbm_drift":
            continue
        ratio = r.get("drift_ratio")
        feats = r.get("features")
        if ratio and ratio > 0 and isinstance(feats, dict) and feats:
            rows.append((r.get("fingerprint"), feats, float(ratio)))
    return rows


def _fit_model(rows):
    """A ``CalibrationModel`` over ``rows`` when they hold enough evidence
    (:data:`core.optimize.MIN_MODEL_ROWS` rows from >= 2 programs), else
    None."""
    if len(rows) >= kopt.MIN_MODEL_ROWS and len({fp for fp, _f, _r in rows}) >= 2:
        return kopt.CalibrationModel.fit_rows(rows)
    return None


def _drift_model(path: str | None = None):
    """The fitted byte-drift calibration over :func:`drift_rows`, or None:
    no drift rows means factor 1.0 everywhere."""
    key = path if path is not None else (plan_log_path() or "")
    if key not in _drift_model_cache:
        _drift_model_cache[key] = _fit_model(drift_rows(path))
    return _drift_model_cache[key]


def drift_factor(features: dict, path: str | None = None) -> float:
    """Predicted watermark/charged ratio for one byte-composition feature
    vector (1.0 with no trained model)."""
    model = _drift_model(path)
    if model is None:
        return 1.0
    return model.predict_factor(features)


def _cross_program_model(path: str | None):
    """The fitted cross-program calibration, or None when the log holds too
    few featurized outcomes or only one program."""
    key = path if path is not None else (plan_log_path() or "")
    if key not in _model_cache:
        _model_cache[key] = _fit_model(_ratio_index(path)[2])
    return _model_cache[key]


def plan_features(kind: str, mesh_axes: dict | None, hints: dict) -> dict:
    """Featurize one candidate for the cross-program calibration model:
    log-domain bytes, FLOPs, dispatches and transfer volumes, the mesh
    factorization, the arithmetic intensity, and the strategy kind."""
    b = lambda k: float(hints.get(k, 0) or 0)  # noqa: E731
    touched = b("arg_bytes") + b("temp_bytes") + b("out_bytes")
    flops = b("flops")
    return {
        "kind": kind,
        "log_bytes": float(np.log1p(touched)),
        "log_flops": float(np.log1p(flops)),
        "log_dispatches": float(np.log1p(b("dispatches") or 1.0)),
        "log_h2d": float(np.log1p(b("h2d_bytes"))),
        "log_coll": float(np.log1p(b("coll_bytes"))),
        "log_ai": float(np.log((flops + 1.0) / (touched + 1.0))),
        "data_axis": float((mesh_axes or {}).get("data", 1)),
        "model_axis": float((mesh_axes or {}).get("model", 1)),
    }


def calibrate(
    fp: str,
    candidate: str,
    features: dict | None = None,
    path: str | None = None,
) -> tuple[float, int, str]:
    """``(factor, direct_samples, source)`` for one candidate, most
    specific evidence first:

    1. **direct**: >= :data:`MIN_TRAIN` measured outcomes of this
       (fingerprint, candidate) pair, their median ratio (the only rung
       that tightens the ranking margin);
    2. **model**: the cross-program regression on the candidate's features;
    3. **pooled**: the program-level median, a constant factor across
       uncalibrated siblings;
    4. **none**: factor 1.0.

    The returned sample count is the DIRECT count."""
    by_pair, by_fp, _rows = _ratio_index(path)
    direct = by_pair.get((fp, candidate), ())
    if len(direct) >= MIN_TRAIN:
        return float(np.median(direct)), len(direct), "direct"
    if features is not None:
        model = _cross_program_model(path)
        if model is not None:
            return model.predict_factor(features), len(direct), "model"
    pooled = by_fp.get(fp, ())
    if len(pooled) >= MIN_TRAIN:
        return float(np.median(pooled)), len(direct), "pooled"
    return 1.0, len(direct), "none"


def calibration(fp: str, candidate: str, path: str | None = None) -> tuple[float, int]:
    """:func:`calibrate` without features (direct -> pooled -> 1.0):
    ``(factor, direct_samples)``."""
    factor, n, _source = calibrate(fp, candidate, path=path)
    return factor, n


# -- candidates and the plan record --------------------------------------------


@dataclasses.dataclass
class Candidate:
    """One executable placement: a mesh shape (or none) x execution
    strategy, with the lazy preflight / run closures the ladder consumes
    and the analytic cost hints the search scores."""

    name: str
    kind: str  #: "fused" | "stepwise" | "host_staged" | ...
    plan: Callable[[], "kmem.MemoryPlan"]
    run: Callable[["kmem.MemoryPlan"], Any]
    #: analytic cost hints (CostModel.predict_seconds keys) plus the prune
    #: figures plan_bytes charges (arg/alias/temp/out/extra/resident).
    hints: dict = dataclasses.field(default_factory=dict)
    mesh_axes: dict | None = None
    prior_rank: int = 0  #: hand-ladder position (ties resolve to this)
    floor: bool = False  #: the resilience backstop, always ranked last
    hand: bool = True  #: hand-ladder member (its prunes land in FitReport)
    #: per-operand sharding-spec assignment (operand -> spec string); None
    #: is the strategy's default layout.
    specs: dict | None = None
    #: the flop count the ladder's profiled run audits against the flops it
    #: counts (``core.memory.Tier.flops``); None audits ``hints["flops"]``.
    audit_flops: float | None = None


@dataclasses.dataclass
class CandidateRecord:
    """One row of the plan's candidate table: the deny/score rationale."""

    name: str
    kind: str
    mesh: dict | None
    prior_rank: int
    pruned: bool
    reason: str  #: deny reason when pruned, score rationale otherwise
    predicted_seconds: float | None = None
    raw_seconds: float | None = None  #: analytic prior before calibration
    calibration: float = 1.0
    samples: int = 0  #: DIRECT measured outcomes behind the calibration
    #: which rung produced the factor: "direct" | "model" | "pooled" | "none"
    calibration_source: str = "none"
    #: watermark-drift calibration applied to the scored temp bytes
    byte_drift: float = 1.0
    rank: int | None = None  #: position in the execution ranking
    measured_seconds: float | None = None  #: filled when this plan RAN
    outcome: str | None = None  #: "ok" | "oom" | "error" | "denied"
    specs: dict | None = None
    #: the cross-program feature vector the calibration consumed
    features: dict | None = None

    def record(self) -> dict:
        out = dataclasses.asdict(self)
        for k in ("predicted_seconds", "raw_seconds", "measured_seconds"):
            if out[k] is not None:
                out[k] = round(out[k], 6)
        out["calibration"] = round(self.calibration, 4)
        if out["features"] is not None:
            out["features"] = {
                k: (round(v, 4) if isinstance(v, float) else v)
                for k, v in out["features"].items()
            }
        return out


@dataclasses.dataclass
class PlacementPlan:
    """The search's audit trail (the FitReport's placement): every
    enumerated candidate with its deny/score rationale, the ranking that
    executed, and the chosen plan's predicted-vs-measured cost."""

    label: str
    fingerprint: str
    devices: str
    trained: bool
    margin: float
    candidates: list  #: list[CandidateRecord], prior order
    ranking: list  #: candidate names, execution order (floor last)
    search_seconds: float = 0.0
    chosen: str | None = None
    predicted_seconds: float | None = None
    measured_seconds: float | None = None
    prediction_error: float | None = None  #: predicted / measured
    #: name -> the analytic MemoryPlan the batch preflight produced for a
    #: pruned candidate (handed to the ladder walk: denied for free).
    analytic_plans: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    def candidate(self, name: str) -> CandidateRecord | None:
        for c in self.candidates:
            if c.name == name:
                return c
        return None

    def record(self) -> dict:
        def r(v, nd):
            return round(v, nd) if v is not None else None

        return {
            "label": self.label,
            "fingerprint": self.fingerprint,
            "devices": self.devices,
            "trained": self.trained,
            "margin": self.margin,
            "search_seconds": round(self.search_seconds, 6),
            "ranking": list(self.ranking),
            "chosen": self.chosen,
            "predicted_seconds": r(self.predicted_seconds, 6),
            "measured_seconds": r(self.measured_seconds, 6),
            "prediction_error": r(self.prediction_error, 4),
            "candidates": [c.record() for c in self.candidates],
        }

    def to_json(self) -> str:
        return json.dumps(self.record())

    def summary(self) -> str:
        s = (
            f"autoshard {self.label}[{self.fingerprint}]: "
            f"{len(self.ranking)}/{len(self.candidates)} candidates ranked"
            f" ({'trained' if self.trained else 'untrained'} margin "
            f"{self.margin}x), head={self.ranking[0] if self.ranking else None}"
        )
        if self.chosen is not None:
            s += f", chosen={self.chosen}"
        if self.prediction_error is not None:
            s += f", prediction_error={self.prediction_error:.2f}x"
        return s


# -- search + ranked execution -------------------------------------------------


def _margin_order(body: list) -> list:
    """Margin-aware selection order over ``(Candidate, CandidateRecord)``
    pairs: at each step, among the remaining candidates whose predicted
    cost is within the confidence margin of the CHEAPEST remaining one, the
    lowest prior (hand) rank wins.  The tight :data:`TRAINED_MARGIN`
    applies only when both the candidate and the cheapest one carry >=
    :data:`MIN_TRAIN` direct measurements."""
    ordered: list = []
    remaining = sorted(body, key=lambda sr: sr[1].prior_rank)
    while remaining:
        best = min(remaining, key=lambda sr: (sr[1].predicted_seconds, sr[1].prior_rank))

        def margin(sr, best=best):
            both_trained = sr[1].samples >= MIN_TRAIN and best[1].samples >= MIN_TRAIN
            return TRAINED_MARGIN if both_trained else UNTRAINED_MARGIN

        pick = min(
            (
                sr for sr in remaining
                if sr[1].predicted_seconds <= best[1].predicted_seconds * margin(sr)
            ),
            key=lambda sr: sr[1].prior_rank,
        )
        ordered.append(pick)
        remaining.remove(pick)
    return ordered


def search(
    label: str,
    candidates: Sequence[Candidate],
    *,
    fingerprint: str,
    budget: int | None | object = kmem._UNSET,
    model: "kopt.CostModel | None" = None,
    devices=None,
) -> PlacementPlan:
    """Enumerate -> prune -> score -> rank.  A pure decision pass: nothing
    runs (see :func:`run_search`).  ``devices``: the device slots the
    candidates run on (a mesh's), for the plan's ``devices`` record; the
    process's devices when None."""
    t0 = time.perf_counter()
    model = model if model is not None else kopt.CostModel.for_devices()
    records: list[CandidateRecord] = []
    survivors: list[tuple[Candidate, CandidateRecord]] = []
    with trace.span("autoshard.search", cat="plan", label=label):
        # 1. Zero-cost batch preflight: a LOWER bound of each tier's own
        # admission (aliased argument bytes credited out).
        analytic = kmem.plan_batch([
            (
                c.name,
                lambda c=c: kmem.plan_bytes(
                    f"autoshard:{c.name}",
                    argument_bytes=max(
                        0, c.hints.get("arg_bytes", 0) - c.hints.get("alias_bytes", 0)
                    ),
                    temp_bytes=c.hints.get("temp_bytes", 0),
                    extra_bytes=c.hints.get("extra_bytes", 0),
                    resident_bytes=c.hints.get("resident_bytes", 0),
                    budget=budget,
                ),
            )
            for c in candidates
        ])
        trained = True
        for c in candidates:
            mp = analytic[c.name]
            rec = CandidateRecord(
                name=c.name,
                kind=c.kind,
                mesh=dict(c.mesh_axes) if c.mesh_axes else None,
                prior_rank=c.prior_rank,
                pruned=not mp.admitted and not c.floor,
                reason=mp.reason,
                specs=dict(c.specs) if c.specs else None,
            )
            records.append(rec)
            if rec.pruned:
                rec.outcome = "denied"
                continue
            # 2. Score: the analytic prior (its temp bytes through the
            # byte-drift calibration, 1.0 with no trained model) times the
            # learned calibration.
            hints = c.hints
            dfac = drift_factor(hbm_features(
                hints.get("arg_bytes", 0),
                hints.get("temp_bytes", 0),
                hints.get("out_bytes", 0),
                c.mesh_axes,
            ))
            if dfac != 1.0:
                hints = dict(hints)
                hints["temp_bytes"] = hints.get("temp_bytes", 0) * dfac
            rec.byte_drift = round(dfac, 4)
            raw = model.predict_seconds(hints)
            feats = plan_features(c.kind, c.mesh_axes, c.hints)
            factor, samples, source = calibrate(fingerprint, c.name, features=feats)
            rec.raw_seconds = raw
            rec.calibration = factor
            rec.samples = samples
            rec.calibration_source = source
            rec.features = feats
            rec.predicted_seconds = raw * factor
            if samples < MIN_TRAIN:
                trained = False
            survivors.append((c, rec))
        # 3. Rank: within-margin candidates keep their prior order, the
        # floor pinned last.
        margin = TRAINED_MARGIN if trained and survivors else UNTRAINED_MARGIN
        body = [sr for sr in survivors if not sr[0].floor]
        floor = [sr for sr in survivors if sr[0].floor]
        ordered = _margin_order(body) + sorted(floor, key=lambda sr: sr[1].prior_rank)
        for i, (c, rec) in enumerate(ordered):
            rec.reason = (
                f"rank {i}: predicted {rec.predicted_seconds:.4g}s "
                f"(prior {rec.raw_seconds:.4g}s x calibration "
                f"{rec.calibration:.3g} [{rec.calibration_source}] from "
                f"{rec.samples} direct outcome(s))"
                + (" [floor: pinned last]" if c.floor else "")
            )
        # Pruned HAND candidates keep their hand position in the walk (the
        # ladder records their analytic denial where the hand contract puts
        # it); pruned extra candidates are dropped from the ranking.
        ranking: list[tuple] = list(ordered)
        by_name = {c.name: c for c in candidates}
        pruned_hand = [r for r in records if r.pruned and by_name[r.name].hand]
        for rec in sorted(pruned_hand, key=lambda r: r.prior_rank):
            at = len(ranking)
            for i, (rc, _rrec) in enumerate(ranking):
                if rc.floor or (rc.hand and rc.prior_rank > rec.prior_rank):
                    at = i
                    break
            ranking.insert(at, (by_name[rec.name], rec))
        for i, (_c, rec) in enumerate(ranking):
            rec.rank = i
    plan = PlacementPlan(
        label=label,
        fingerprint=fingerprint,
        devices=device_fingerprint(devices),
        trained=trained,
        margin=margin if survivors else UNTRAINED_MARGIN,
        candidates=records,
        ranking=[rec.name for _, rec in ranking],
        search_seconds=time.perf_counter() - t0,
        analytic_plans={rec.name: analytic[rec.name] for rec in records if rec.pruned},
    )
    trace.instant(
        "autoshard_plan",
        label=label,
        fingerprint=fingerprint,
        ranking=plan.ranking,
        pruned=[r.name for r in records if r.pruned],
        trained=trained,
    )
    trace.metrics.inc("autoshard_searches")
    trace.metrics.observe("autoshard_search_seconds", plan.search_seconds)
    trace.metrics.gauge("autoshard_last_search_trained", 1.0 if trained else 0.0)
    _logger.info("%s", plan.summary())
    return plan


def will_search(plan_arg) -> bool:
    """Whether ``fit(plan=plan_arg)`` will run the placement search."""
    return _resolve(plan_arg)[0]


def _resolve(plan_arg) -> tuple[bool, list | None]:
    """``fit(plan=...)`` semantics -> (search?, forced ranking names)."""
    if plan_arg is None:
        return enabled(), None
    if plan_arg is False:
        return False, None
    if plan_arg is True:
        return True, None
    if isinstance(plan_arg, PlacementPlan):
        return True, list(plan_arg.ranking)
    if isinstance(plan_arg, (list, tuple)):
        return True, [str(n) for n in plan_arg]
    raise TypeError(
        f"fit(plan=...) wants None/bool/PlacementPlan/name list, got "
        f"{type(plan_arg).__name__}"
    )


def _tier(c: Candidate, plan_fn, run) -> "kmem.Tier":
    flops = c.audit_flops if c.audit_flops is not None else c.hints.get("flops")
    return kmem.Tier(c.name, plan_fn, run, flops=flops)


def run_search(
    label: str,
    candidates: Sequence[Candidate],
    report: "kmem.FitReport",
    *,
    fingerprint: str,
    plan=None,
    budget: int | None | object = kmem._UNSET,
    model: "kopt.CostModel | None" = None,
    devices=None,
):
    """The solvers' one entry point: search (or honor the ``plan``
    override), then drive the RANKED candidate list through
    ``core.memory.run_ladder``, the same per-tier admission and
    one-plan-at-a-time out-of-memory step-down contract as the hand
    ladder.  Attaches the :class:`PlacementPlan` record to
    ``report.placement``, appends outcomes to the plan log, and counts every
    step off a ranked plan under ``autoshard_stepdown``.  The chosen tier's
    flops are audited by ``run_ladder`` alone (``Candidate.audit_flops``)."""
    do_search, forced = _resolve(plan)
    report.fingerprint = fingerprint
    by_prior = sorted(candidates, key=lambda c: c.prior_rank)
    if not do_search:
        tiers = [_tier(c, c.plan, c.run) for c in by_prior if c.hand]
        return kmem.run_ladder(label, tiers, report)

    placement = search(label, candidates, fingerprint=fingerprint, budget=budget, model=model,
                       devices=devices)
    if forced is not None:
        known = {c.name for c in candidates}
        ranking = [n for n in forced if n in known]
        # anything the override did not name keeps its searched order
        ranking += [n for n in placement.ranking if n not in ranking]
        # the floor stays the backstop even under a forced ranking
        floors = [c.name for c in by_prior if c.floor and c.name in ranking]
        ranking = [n for n in ranking if n not in floors] + floors
        placement.ranking = ranking
        # Re-stamp the audit table to the order that will execute.
        for rec in placement.candidates:
            rec.rank = None
        for i, name in enumerate(ranking):
            rec = placement.candidate(name)
            if rec is None:
                continue
            rec.rank = i
            if rec.predicted_seconds is not None:
                rec.reason = (
                    f"rank {i} (forced replay): predicted "
                    f"{rec.predicted_seconds:.4g}s (prior "
                    f"{rec.raw_seconds:.4g}s x calibration "
                    f"{rec.calibration:.3g} from {rec.samples} outcome(s))"
                )

    by_name = {c.name: c for c in candidates}
    measured: dict[str, float] = {}

    def wrap(c: Candidate) -> kmem.Tier:
        cached_deny = placement.analytic_plans.get(c.name)
        # A pruned candidate's walk "plan" IS the search's analytic deny.
        plan_fn = (lambda: cached_deny) if cached_deny is not None else c.plan

        def run(mplan):
            rec = placement.candidate(c.name)
            t0 = time.perf_counter()
            with trace.plan_span(
                f"plan:{c.name}",
                predicted_seconds=rec.predicted_seconds if rec else None,
                label=label,
                rank=rec.rank if rec else None,
                specs=spec_tag(rec.specs if rec else None),
            ):
                try:
                    out = c.run(mplan)
                    # Sync before reading the clock: an unsynchronized
                    # measurement records the enqueue, and would train the
                    # calibration toward "free".  The sync also surfaces an
                    # asynchronous out-of-memory error inside the ladder's
                    # try, so it steps down counted.
                    _block_until_ready(out)
                except Exception:
                    measured[c.name] = time.perf_counter() - t0
                    raise
            measured[c.name] = time.perf_counter() - t0
            return out

        return _tier(c, plan_fn, run)

    tiers = [wrap(by_name[n]) for n in placement.ranking if n in by_name]
    try:
        out = kmem.run_ladder(label, tiers, report)
    finally:
        _finish(placement, report, measured, fingerprint, label)
    return out


def _tensor_devices(out) -> set:
    """The CUDA devices of the tensors in a (nested) tier result, a
    ``ShardedRows``' slots among them."""
    if isinstance(out, torch.Tensor):
        return {out.device} if out.device.type == "cuda" else set()
    if hasattr(out, "data_blocks"):
        out = out.data_blocks()
    elif isinstance(out, dict):
        out = out.values()
    elif not isinstance(out, (list, tuple)):
        return set()
    return set().union(*map(_tensor_devices, out))


def _block_until_ready(out) -> None:
    """Synchronize the cards that hold a tier run's result tensors.  Only an
    out-of-memory error (``core.memory.is_oom_error``) is re-raised; any
    other failure of the synchronize is not the measurement's business."""
    try:
        for dev in _tensor_devices(out):
            torch.cuda.synchronize(dev)
    except Exception as e:  # noqa: BLE001 — only OOM matters here
        if kmem.is_oom_error(e):
            raise


def _finish(placement, report, measured, fp, label) -> None:
    """Post-run bookkeeping: predicted-vs-actual on the plan, outcome rows
    to the log, step-downs counted."""
    placement.chosen = report.chosen
    for name, secs in measured.items():
        rec = placement.candidate(name)
        if rec is None:
            continue
        rec.measured_seconds = secs
        # Only a runtime out-of-memory step-down is a memory misprediction;
        # a typed failure that propagated is recorded as "error".
        if name == report.chosen:
            rec.outcome = "ok"
        elif name in report.oom_retries:
            rec.outcome = "oom"
        else:
            rec.outcome = "error"
        append_outcome({
            "fingerprint": fp,
            "label": label,
            "candidate": name,
            "predicted_seconds": rec.predicted_seconds,
            "raw_seconds": rec.raw_seconds,
            "measured_seconds": secs,
            "outcome": rec.outcome,
            "devices": placement.devices,
            "specs": rec.specs,
            # the cross-program training row of the NEXT process
            "features": rec.features,
            "ts": time.time(),
        })
    chosen_rec = placement.candidate(report.chosen) if report.chosen else None
    if chosen_rec is not None:
        placement.predicted_seconds = chosen_rec.predicted_seconds
        placement.measured_seconds = chosen_rec.measured_seconds
        if chosen_rec.predicted_seconds and chosen_rec.measured_seconds:
            placement.prediction_error = (
                chosen_rec.predicted_seconds / chosen_rec.measured_seconds
            )
    for name in report.oom_retries:
        if placement.candidate(name) is not None:
            counters.record(
                "autoshard_stepdown",
                f"{label}: ranked plan {name!r} ran out of device memory at "
                "runtime — stepping down the searched ranking "
                f"(cost-model misprediction logged for {fp})",
            )
    report.placement = placement.record()
