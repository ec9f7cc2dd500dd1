"""Cost-based pipeline optimization: the auto-Cacher and the closed-loop
ingest autotuner (counterpart of keystone_tpu/core/optimize.py).

**Auto-Cacher** (KeystoneML's materialization pass):

* :func:`plan_caches` — the greedy decision over :class:`CacheCandidate`
  rows (node name, full-dataset recompute seconds, full-dataset output
  bytes, measured reuse): a node is worth caching when
  ``recompute_seconds x (reuse - 1)`` exceeds the amortized cost of
  holding ``output_bytes`` resident (bytes / :func:`cache_gbps`); every
  insertion is admitted through ``core.memory.plan_cache_bytes`` against
  the card's budget (under a mesh, each slot's share of the row-sharded
  cache against the slot budget), biggest win first, so a denial drops
  the cheapest wins.  The decision table lands in a :class:`CachePlan`, in the JAX
  package's JSON.
* :func:`apply_cache_plan` — the pipeline rebuilt with memoizing
  ``Cacher`` nodes after each cached node (committing to a
  ``parallel.mesh.SpecSharding`` when given one).
* :func:`auto_cache_chain` — the whole pass for a chained estimator:
  profile the upstream transformer on a sample (after one warm-up
  application, so a kernel's first-use build and the BLAS set-up are not
  scaled up to the dataset), measure reuse by running the fit pattern on
  the sample under ``track_reuse``, scale to the full dataset, plan, and
  rebuild the chain.

**Closed-loop ingest autotuner**: :class:`IngestAutotuner`, attached to a
``core.ingest`` stream, reads the stall counters at every chunk boundary
and retunes decode width, decode-ahead, ring depth and the decode backend
through the stream's live ``StreamConfig``.  Retuning changes concurrency
and buffering only: the stream's output is bit-identical at any knob
trajectory (the ``autotune_thrash`` chaos family holds it to that).

Also here, for the placement search (``core.autoshard``):
the analytic :class:`CostModel` over the port's device rates
(``core.profiler.DEVICE_RATES``) and the cross-program
:class:`CalibrationModel`, and the snapshot advisor
(:func:`advise_snapshot`).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os

from . import memory as kmem
from . import profiler as kprof
from . import trace
from .pipeline import (
    Cacher,
    ChainedEstimator,
    ChainedLabelEstimator,
    Pipeline,
    PipelineProfile,
    _synchronize,
    track_reuse,
)

_logger = logging.getLogger("keystone_tpu_torch.optimize")

#: env var: the materialization-bandwidth exchange rate (GB/s) pricing the
#: amortized cost of holding a cached intermediate resident.
CACHE_GBPS_ENV = "KEYSTONE_CACHE_GBPS"
_DEFAULT_CACHE_GBPS = 1.0


def auto_cache_env() -> bool:
    """``KEYSTONE_AUTOCACHE=1``: opt a workload into the auto-Cacher
    without its ``--autoCache`` flag (the env form of the opt-in)."""
    # Same flag grammar as KEYSTONE_AUTOTUNE (one parser, no drift).
    from .ingest import _env_flag

    return _env_flag("KEYSTONE_AUTOCACHE")


def cache_gbps() -> float:
    """GB/s rate converting cached bytes into amortized seconds — the
    exchange rate between the two sides of the caching inequality.  The
    default (1 GB/s) approximates one host<->device round trip of the
    materialized value; raise it to cache more aggressively, lower it to
    price HBM residency higher (``KEYSTONE_CACHE_GBPS``)."""
    raw = os.environ.get(CACHE_GBPS_ENV, "").strip()
    if not raw:
        return _DEFAULT_CACHE_GBPS
    try:
        val = float(raw)
    except ValueError:
        raise ValueError(f"{CACHE_GBPS_ENV}={raw!r} is not a number") from None
    if val <= 0:
        raise ValueError(f"{CACHE_GBPS_ENV}={raw!r} must be > 0")
    return val


@dataclasses.dataclass
class CacheCandidate:
    """One node's caching economics, scaled to the FULL dataset."""

    index: int  #: node position in the pipeline (-1 for non-pipeline sites)
    name: str
    seconds: float  #: one full-dataset recompute of this node
    output_bytes: int  #: full-dataset materialized output
    reuse: int  #: times the fit path computes this intermediate


@dataclasses.dataclass
class CacheDecision:
    """One row of the optimizer's decision table."""

    index: int
    name: str
    reuse: int
    recompute_seconds: float
    output_bytes: int
    win_seconds: float  #: recompute_seconds x (reuse - 1)
    amortized_seconds: float  #: output_bytes / cache_gbps
    cached: bool
    reason: str

    def record(self) -> dict:
        out = dataclasses.asdict(self)
        out["recompute_seconds"] = round(self.recompute_seconds, 6)
        out["win_seconds"] = round(self.win_seconds, 6)
        out["amortized_seconds"] = round(self.amortized_seconds, 6)
        return out


@dataclasses.dataclass
class CachePlan:
    """The auto-Cacher's audit trail (the ``FitReport`` analog): every
    considered node's decision with the evidence, the admission verdicts,
    and what the budget degradation dropped."""

    decisions: list  #: list[CacheDecision], pipeline order
    budget_bytes: int | None = None
    cached_bytes: int = 0
    dataset_rows: int | None = None
    sample_rows: int | None = None
    gbps: float = _DEFAULT_CACHE_GBPS
    denials: list = dataclasses.field(default_factory=list)
    #: names dropped by the budget degradation path, cheapest win first
    dropped: list = dataclasses.field(default_factory=list)

    def cached(self) -> list:
        return [d for d in self.decisions if d.cached]

    def record(self) -> dict:
        return {
            "cached": [d.name for d in self.cached()],
            "cached_bytes": self.cached_bytes,
            "budget_bytes": self.budget_bytes,
            "dataset_rows": self.dataset_rows,
            "sample_rows": self.sample_rows,
            "gbps": self.gbps,
            "denials": list(self.denials),
            "dropped": list(self.dropped),
            "decisions": [d.record() for d in self.decisions],
        }

    def to_json(self) -> str:
        """The plan as one JSON document, embeddable in bench/chaos
        records (the decision table would otherwise die with the
        process)."""
        return json.dumps(self.record())

    def summary(self) -> str:
        cached = ", ".join(d.name for d in self.cached()) or "nothing"
        s = f"auto-cache: caching {cached} ({kmem.fmt_bytes(self.cached_bytes)})"
        if self.dropped:
            s += f"; budget dropped {self.dropped}"
        return s


def plan_caches(
    candidates,
    *,
    budget=kmem._UNSET,
    mesh=None,
    headroom: float = 0.5,
    gbps: float | None = None,
    dataset_rows: int | None = None,
    sample_rows: int | None = None,
) -> CachePlan:
    """The greedy caching decision over :class:`CacheCandidate` rows.

    Eligibility is KeystoneML's inequality: cache a node iff its win —
    ``recompute_seconds x (reuse - 1)`` — exceeds the amortized residency
    cost ``output_bytes / gbps``.  ``reuse <= 1`` is never cached (nothing
    is saved).  Eligible nodes are then admitted through
    ``core.memory.plan_cache_bytes`` cumulatively, BIGGEST win first, so a
    denial drops the cheapest-win caches: the degradation path under a
    tight ``KEYSTONE_HBM_BUDGET`` is fewer (or no) caches, never a
    caching-induced OOM.  Under a ``mesh`` a row-sharded cache charges its
    per-slot share (bytes / data-axis size) against the slot budget."""
    rate = gbps if gbps is not None else cache_gbps()
    per_slot = 1 if mesh is None else max(1, int(mesh.shape.get("data", 1)))
    decisions: list[CacheDecision] = []
    eligible: list[CacheDecision] = []
    for c in candidates:
        win = c.seconds * max(0, c.reuse - 1)
        amortized = c.output_bytes / (rate * 2**30)
        d = CacheDecision(
            index=c.index,
            name=c.name,
            reuse=c.reuse,
            recompute_seconds=c.seconds,
            output_bytes=c.output_bytes,
            win_seconds=win,
            amortized_seconds=amortized,
            cached=False,
            reason="",
        )
        if c.reuse <= 1:
            d.reason = "reuse <= 1: nothing recomputed, nothing to save"
        elif win <= amortized:
            d.reason = (
                f"win {win:.4f}s <= amortized residency cost "
                f"{amortized:.4f}s ({kmem.fmt_bytes(c.output_bytes)} @ "
                f"{rate}GB/s)"
            )
        else:
            eligible.append(d)
        decisions.append(d)

    plan = CachePlan(
        decisions=decisions,
        dataset_rows=dataset_rows,
        sample_rows=sample_rows,
        gbps=rate,
    )
    # Admission walks the eligible set biggest win first: under a tight
    # budget the caches given up are the cheapest wins.  Each candidate is
    # admitted independently against the REMAINING budget — a denied big
    # win does not abandon smaller ones that still fit (greedy knapsack,
    # not first-failure abort).
    eligible.sort(key=lambda d: d.win_seconds, reverse=True)
    cum = 0
    for d in eligible:
        mp = kmem.plan_cache_bytes(
            f"cache:{d.name}",
            (cum + d.output_bytes) // per_slot,
            mesh=mesh,
            budget=budget,
            headroom=headroom,
        )
        plan.budget_bytes = mp.budget_bytes
        if mp.admitted:
            d.cached = True
            d.reason = (
                f"cached: win {d.win_seconds:.4f}s > amortized "
                f"{d.amortized_seconds:.4f}s; {mp.reason}"
            )
            cum += d.output_bytes
        else:
            d.reason = f"budget denied: {mp.reason}"
            plan.denials.append(d.name)
            plan.dropped.append(d.name)
    plan.cached_bytes = cum
    trace.instant(
        "auto_cache_plan",
        cached=[d.name for d in plan.cached()],
        cached_bytes=cum,
        dropped=list(plan.dropped),
    )
    return plan


def candidates_from_profile(
    profile: PipelineProfile,
    reuse_by_index: dict,
    *,
    dataset_rows: int | None = None,
    sample_rows: int | None = None,
) -> list:
    """Turn a sample-batch :class:`PipelineProfile` into full-dataset
    :class:`CacheCandidate` rows: each node's measured seconds and output
    bytes scale linearly by ``dataset_rows / sample_rows`` (KeystoneML's
    sampling profiler made the same linear extrapolation)."""
    scale = 1.0
    if dataset_rows and sample_rows:
        scale = dataset_rows / float(sample_rows)
    return [
        CacheCandidate(
            index=n.index,
            name=n.name,
            seconds=n.seconds * scale,
            output_bytes=int(n.output_bytes * scale),
            reuse=int(reuse_by_index.get(n.index, 1)),
        )
        for n in profile.nodes
    ]


def apply_cache_plan(pipeline: Pipeline, plan: CachePlan, sharding=None) -> Pipeline:
    """Insert a memoizing ``Cacher(name, sharding)`` after every cached
    node.  Existing Cachers are never doubled.  Returns a new Pipeline
    (the input is untouched); with nothing cached it is an equal-node
    rebuild."""
    cached_at = {d.index for d in plan.cached()}
    nodes = []
    for i, n in enumerate(pipeline.nodes):
        nodes.append(n)
        if i in cached_at and not isinstance(n, Cacher):
            nodes.append(
                Cacher(
                    name=f"auto:{_plan_name(plan, i)}",
                    sharding=sharding,
                    memoize=True,
                )
            )
    return Pipeline(nodes)


def _plan_name(plan: CachePlan, index: int) -> str:
    for d in plan.decisions:
        if d.index == index:
            return d.name
    return str(index)


def measure_chain_reuse(chain, sample, labels=None) -> dict:
    """Execute the workload fit pattern — ``chain.fit(sample)`` followed by
    one application of the fitted pipeline to the same sample — on a SAMPLE
    under ``track_reuse``, and return ``{node_index_in_xform: count}``.
    This is the fit-path reuse measurement: an upstream node counted twice
    is recomputed once per extra count when the real fit runs."""
    xform = chain.xform
    pipe = xform if isinstance(xform, Pipeline) else Pipeline([xform])
    with track_reuse() as counts:
        if isinstance(chain, ChainedLabelEstimator):
            fitted = chain.fit(sample, labels)
        else:
            fitted = chain.fit(sample)
        fitted(sample)
    return {i: counts.get(id(n), 0) for i, n in enumerate(pipe.nodes)}


def auto_cache_chain(
    chain,
    sample,
    dataset_rows: int,
    *,
    labels=None,
    mesh=None,
    sharding=None,
    budget=kmem._UNSET,
    headroom: float = 0.5,
    gbps: float | None = None,
):
    """The whole KeystoneML optimizer pass for one chained estimator.

    1. profile the upstream transformer node-by-node on ``sample``
       (``Pipeline.profile``: wall seconds + output bytes per node), after
       one warm-up application: a first call on the card can hold the load
       of a kernel built at first use and the BLAS set-up, which the
       dataset ratio would otherwise scale up;
    2. measure per-node REUSE by running the fit pattern on the sample
       under ``track_reuse`` (fit + one fitted application — the workload
       usage that recomputes upstream intermediates);
    3. scale costs to ``dataset_rows`` and run :func:`plan_caches` through
       the HBM admission gate (per slot under ``mesh``);
    4. rebuild the chain around the Cacher-annotated pipeline (each Cacher
       committing to ``sharding``, when given).

    Returns ``(optimized_chain, CachePlan)``.  With every cache denied the
    optimized chain is behaviorally identical to the input (and produces
    bit-identical results either way — the memo replays the very arrays
    the fit computed)."""
    if not isinstance(chain, (ChainedEstimator, ChainedLabelEstimator)):
        raise TypeError(
            f"auto_cache_chain wants a ChainedEstimator/ChainedLabelEstimator, "
            f"got {type(chain).__name__}"
        )
    xform = chain.xform
    pipe = xform if isinstance(xform, Pipeline) else Pipeline([xform])
    sample_rows = int(getattr(sample, "shape", [len(sample)])[0])
    with trace.span("optimize.auto_cache", nodes=len(pipe.nodes)):
        _synchronize(pipe(sample))
        profile = pipe.profile(sample)
        reuse = measure_chain_reuse(chain, sample, labels)
        plan = plan_caches(
            candidates_from_profile(
                profile,
                reuse,
                dataset_rows=dataset_rows,
                sample_rows=sample_rows,
            ),
            budget=budget,
            mesh=mesh,
            headroom=headroom,
            gbps=gbps,
            dataset_rows=dataset_rows,
            sample_rows=sample_rows,
        )
    cached_pipe = apply_cache_plan(pipe, plan, sharding=sharding)
    _logger.info("%s", plan.summary())
    rebuilt = type(chain)(cached_pipe, chain.est)
    return rebuilt, plan


def release_caches(pipeline: Pipeline) -> None:
    """Drop every memoized intermediate a cached pipeline holds (frees the
    device memory once the fit path no longer needs the replay)."""
    for n in getattr(pipeline, "nodes", ()):
        if isinstance(n, Cacher):
            n.clear_memo()


# -- the placement cost model (shared with core.autoshard) --------------------

#: The rates the analytic placement prior divides by: peak FLOP/s and
#: memory GB/s by card name from ``core.profiler.DEVICE_RATES`` (unknown
#: devices, the CPU included, take its defaults; only the relative ranking
#: of candidate plans matters there).  ``ici_gbps`` is the interconnect
#: rate of the JAX package's record, kept at its default value until a
#: host with several cards measures NVLink.
_DEFAULT_RATES = {**kprof.DEFAULT_RATES, "ici_gbps": 5.0}


@dataclasses.dataclass
class CostModel:
    """Analytic roofline prior for one candidate placement's solve wall.

    The Learned-Cost-Model placement paper's structure (PAPERS.md): an
    analytic prior over the quantities a plan determines — per-device bytes
    moved through memory, per-device FLOPs, host<->device dispatch round trips,
    H2D streaming traffic, cross-device collective volume — refined by a
    learned per-(program, candidate) calibration factor fitted to measured
    outcomes (core.autoshard reads them from the persistent plan-outcome
    log and multiplies :meth:`predict_seconds` by the measured/predicted
    ratio).  The prior only has to RANK candidates sanely on a cold start;
    the calibration makes the absolute numbers honest across runs.
    """

    peak_flops: float = _DEFAULT_RATES["peak_flops"]
    hbm_gbps: float = _DEFAULT_RATES["hbm_gbps"]
    ici_gbps: float = _DEFAULT_RATES["ici_gbps"]
    h2d_gbps: float = 8.0  #: PCIe-class host->device streaming rate
    dispatch_seconds: float = 1e-3  #: one host->device dispatch round trip

    @classmethod
    def for_devices(cls, devices=None) -> "CostModel":
        """Rates for ``devices`` (``torch.device`` s or card names; the live
        card when None) from ``core.profiler.DEVICE_RATES``, the default
        rates for unknown kinds and the CPU."""
        kind = ""
        try:
            import torch

            if devices is None:
                devices = [torch.device("cuda", 0)] if torch.cuda.is_available() else []
            if devices:
                dev = devices[0]
                if isinstance(dev, str) and not dev.startswith(("cuda", "cpu")):
                    kind = dev
                elif torch.device(dev).type == "cuda":
                    kind = torch.cuda.get_device_name(torch.device(dev))
        except Exception:  # noqa: BLE001 — no backend: relative ranking only
            kind = ""
        rates = kprof.DEVICE_RATES.get(kind, _DEFAULT_RATES)
        return cls(peak_flops=rates["peak_flops"], hbm_gbps=rates["hbm_gbps"])

    def predict_seconds(self, hints: dict) -> float:
        """Prior wall seconds for one candidate from its cost hints.

        ``hints`` keys (all optional, per device): ``arg_bytes`` /
        ``out_bytes`` / ``temp_bytes`` (HBM traffic, charged once),
        ``hbm_passes`` (how many times the solve streams that working set;
        default 1), ``flops``, ``dispatches``, ``h2d_bytes``,
        ``coll_bytes``.  The roofline term takes the MAX of the HBM and
        FLOP times (they overlap on the card); dispatches, H2D streaming,
        and collectives are serial adders."""
        touched = (
            hints.get("arg_bytes", 0)
            + hints.get("out_bytes", 0)
            + hints.get("temp_bytes", 0)
        ) * max(1.0, float(hints.get("hbm_passes", 1)))
        hbm_s = touched / (self.hbm_gbps * 2**30)
        flop_s = float(hints.get("flops", 0.0)) / self.peak_flops
        return (
            max(hbm_s, flop_s)
            + float(hints.get("dispatches", 1)) * self.dispatch_seconds
            + float(hints.get("h2d_bytes", 0)) / (self.h2d_gbps * 2**30)
            + float(hints.get("coll_bytes", 0)) / (self.ici_gbps * 2**30)
        )


# -- the cross-program calibration model ------------------------------------

#: featurized outcomes required before a cross-program fit is attempted
#: (core.autoshard additionally requires >= 2 distinct program
#: fingerprints — transfer between programs is the model's entire point).
MIN_MODEL_ROWS = 8

#: one-sided bound on the learned factor: a regression extrapolating onto
#: a feature vector far outside its training hull must not predict a
#: thousandfold slowdown/speedup and blow a candidate past every margin.
_FACTOR_CLIP = 32.0


@dataclasses.dataclass
class CalibrationModel:
    """Cross-program calibration: ridge regression of
    ``log(measured / analytic-prior)`` on candidate FEATURES (operand
    bytes, mesh factorization, strategy kind, arithmetic intensity — see
    ``core.autoshard.plan_features``), fitted over every program's logged
    outcomes.

    It is the placement search's fallback below its training minimum: a
    median keyed on the program fingerprint cannot say anything about a
    shape it never ran, while a feature-space fit transfers — train on a
    16k x 2k solve, predict the ratio for an 8k x 4k one (the Learned
    Cost Model placement direction, PAPERS.md).  Direct per-pair medians
    still win once they exist, and only THEY tighten the ranking margin;
    the model only shifts absolute predictions toward honesty, bounded by
    :data:`_FACTOR_CLIP`.
    """

    feature_names: list
    kinds: list  #: strategy one-hot vocabulary seen at fit time
    weights: "np.ndarray"  #: [1 + features + kinds] — bias first
    n_rows: int
    n_programs: int

    @classmethod
    def fit_rows(cls, rows, l2: float = 1.0) -> "CalibrationModel | None":
        """Fit from ``[(fingerprint, features_dict, ratio)]`` rows (the
        shape ``core.autoshard.model_rows`` yields).  Returns ``None``
        for degenerate inputs (no rows / no positive ratios)."""
        import numpy as np

        rows = [
            (fp, f, r) for fp, f, r in rows
            if isinstance(f, dict) and r and r > 0
        ]
        if not rows:
            return None
        names = sorted({
            k for _fp, f, _r in rows
            for k, v in f.items()
            if isinstance(v, (int, float))
        })
        kinds = sorted({f.get("kind") for _fp, f, _r in rows} - {None})
        xs, ys = [], []
        for _fp, f, r in rows:
            xs.append(cls._vector(f, names, kinds))
            ys.append(np.log(r))
        x = np.asarray(xs, np.float64)
        y = np.asarray(ys, np.float64)
        reg = l2 * np.eye(x.shape[1])
        reg[0, 0] = 0.0  # the bias absorbs the global mean unpenalized
        w = np.linalg.solve(x.T @ x + reg, x.T @ y)
        return cls(
            feature_names=names,
            kinds=kinds,
            weights=w,
            n_rows=len(rows),
            n_programs=len({fp for fp, _f, _r in rows}),
        )

    @staticmethod
    def _vector(features: dict, names, kinds):
        import numpy as np

        v = [1.0]
        v.extend(float(features.get(k, 0.0) or 0.0) for k in names)
        kind = features.get("kind")
        v.extend(1.0 if kind == k else 0.0 for k in kinds)
        return np.asarray(v, np.float64)

    def predict_factor(self, features: dict) -> float:
        """The calibration factor (measured/prior ratio) this model
        predicts for one candidate's feature vector, clipped to
        ``[1/32, 32]``."""
        import numpy as np

        pred = float(
            self._vector(features, self.feature_names, self.kinds)
            @ self.weights
        )
        lim = float(np.log(_FACTOR_CLIP))
        return float(np.exp(np.clip(pred, -lim, lim)))

    def record(self) -> dict:
        return {
            "n_rows": self.n_rows,
            "n_programs": self.n_programs,
            "features": list(self.feature_names),
            "kinds": list(self.kinds),
        }


# -- the snapshot advisor -----------------------------------------------------

#: env var: assumed snapshot-disk sequential bandwidth (GB/s) used by the
#: advisor when no measured rate is supplied.
SNAPSHOT_GBPS_ENV = "KEYSTONE_SNAPSHOT_GBPS"
_DEFAULT_SNAPSHOT_GBPS = 0.5


def snapshot_gbps() -> float:
    raw = os.environ.get(SNAPSHOT_GBPS_ENV, "").strip()
    if not raw:
        return _DEFAULT_SNAPSHOT_GBPS
    try:
        val = float(raw)
    except ValueError:
        raise ValueError(
            f"{SNAPSHOT_GBPS_ENV}={raw!r} is not a number"
        ) from None
    if val <= 0:
        raise ValueError(f"{SNAPSHOT_GBPS_ENV}={raw!r} must be > 0")
    return val


@dataclasses.dataclass
class SnapshotAdvice:
    """The snapshot advisor's decision row (CachePlan's sibling): should a
    repeat-epoch workload materialize decoded chunks instead of re-decoding
    every epoch?  Same cost-model shape as the caching inequality — decode
    seconds saved across repeat epochs vs the IO cost of writing once and
    reading per epoch."""

    images: int
    epochs: int
    bytes_per_image: int
    decode_images_per_sec: float
    gbps: float
    live_seconds: float  #: epochs x one full decode
    snapshot_seconds: float  #: decode once + write once + read (epochs-1)x
    advise: bool
    reason: str

    def record(self) -> dict:
        out = dataclasses.asdict(self)
        out["live_seconds"] = round(self.live_seconds, 3)
        out["snapshot_seconds"] = round(self.snapshot_seconds, 3)
        return out


def advise_snapshot(
    *,
    images: int,
    bytes_per_image: int,
    decode_images_per_sec: float,
    epochs: int,
    gbps: float | None = None,
) -> SnapshotAdvice:
    """Cost-based snapshot decision: a snapshot pays when the decode time
    it removes from epochs 2..N exceeds the one-time shard write plus the
    per-epoch shard read.  ``decode_images_per_sec`` is the MEASURED live
    decode rate (bench's decode ceiling, or the stream's own stats);
    ``gbps`` prices shard IO (``KEYSTONE_SNAPSHOT_GBPS``)."""
    if images < 0 or epochs < 1 or decode_images_per_sec <= 0:
        raise ValueError(
            "advise_snapshot wants images >= 0, epochs >= 1, "
            "decode_images_per_sec > 0"
        )
    rate = gbps if gbps is not None else snapshot_gbps()
    decode_secs = images / decode_images_per_sec
    io_secs = images * bytes_per_image / (rate * 2**30)
    live = epochs * decode_secs
    snap = decode_secs + io_secs + (epochs - 1) * io_secs
    advise = epochs > 1 and snap < live
    if epochs <= 1:
        reason = "single pass: nothing to amortize"
    elif advise:
        reason = (
            f"snapshot {snap:.2f}s < live {live:.2f}s over {epochs} epochs "
            f"(decode {decode_secs:.2f}s/epoch, shard IO {io_secs:.2f}s @ "
            f"{rate}GB/s)"
        )
    else:
        reason = (
            f"live {live:.2f}s <= snapshot {snap:.2f}s — shard IO would "
            "cost more than the decode it saves"
        )
    out = SnapshotAdvice(
        images=images,
        epochs=epochs,
        bytes_per_image=bytes_per_image,
        decode_images_per_sec=decode_images_per_sec,
        gbps=rate,
        live_seconds=live,
        snapshot_seconds=snap,
        advise=advise,
        reason=reason,
    )
    trace.instant(
        "snapshot_advice", advise=advise, live_seconds=round(live, 3),
        snapshot_seconds=round(snap, 3), epochs=epochs,
    )
    return out


# -- the closed-loop ingest autotuner -----------------------------------------


class IngestAutotuner:
    """Closed-loop controller over one ingest stream's :class:`StreamConfig`.

    Attached by ``core.ingest`` (``config.autotune`` / explicit ``tuner=``),
    it is invoked at every chunk boundary on the consumer thread and, every
    ``autotune_interval`` chunks, reads the interval's stall deltas from the
    stream's stats (the same numbers published as ``ingest_*`` gauges in
    ``trace.metrics``):

    * ``consumer_stalls`` grew, ``producer_stalls`` didn't -> the ring ran
      dry: DECODE-BOUND.  Double the decode width (up to the pool cap) and
      keep the decode-ahead window at least as wide, so the extra lanes can
      actually fill.
    * ``producer_stalls`` grew, ``consumer_stalls`` didn't -> the ring ran
      full: DEVICE/CONSUMER-BOUND.  Narrow decode one step (on a CPU
      backend the decode pool and the featurize share cores — idle decode
      width is stolen featurize time) and deepen the ring (up to the cap)
      to absorb burstiness.
    * both (or neither) moved -> mixed/converged: leave the knobs alone.
    * decode-bound AND the last decode-width doubling bought <
      :attr:`SCALING_FLOOR` (1.3x) chunk throughput -> the pool is
      GIL-bound, not core-bound: promote ``decode_backend`` to
      ``process`` (the stream spins up the spawned shared-memory decode
      pool at its next member), counted ``ingest_backend_promotions``.

    Every retune is appended to :attr:`trajectory`, counted
    (``ingest_retunes``), and emitted as an ``ingest_autotune`` trace
    instant — the knob path is auditable next to the span timeline.
    Retunes touch concurrency/buffering knobs only; output identity is the
    stream's own invariant.
    """

    #: Threaded decode scaling below this after a width doubling reads as
    #: "the GIL is the wall, not core count" — the knob that helps is the
    #: BACKEND, not more width.
    SCALING_FLOOR = 1.3

    def __init__(
        self,
        *,
        interval: int | None = None,
        min_threads: int = 1,
        max_ring: int = 64,
        max_ahead: int = 64,
        allow_backend_switch: bool = True,
    ):
        self._interval = interval
        self._min_threads = min_threads
        self._max_ring = max_ring
        self._max_ahead = max_ahead
        self._allow_backend_switch = allow_backend_switch
        self.trajectory: list = []
        self._chunks = 0
        self._last_prod = 0
        self._last_cons = 0
        self._warmed = False
        self._cfg = None
        self._stats = None
        self._last_decide_t: float | None = None
        self._last_interval_chunks = 0
        #: rate (chunks/sec) measured over the interval BEFORE the last
        #: decode-width doubling — the denominator of the scaling check.
        self._widen_rate: float | None = None
        #: actual width ratio of the widen behind _widen_rate (a widen
        #: capped by max_decode_threads may be far less than a doubling —
        #: the promotion floor must scale with what was really promised)
        self._widen_ratio: float | None = None

    def _now(self) -> float:  # seam for tests
        import time

        return time.monotonic()

    def attach(self, stream) -> None:
        self._cfg = stream.config
        self._stats = stream.stats
        self._last_prod = stream.stats.producer_stalls
        self._last_cons = stream.stats.consumer_stalls

    def on_chunk(self, stream) -> None:
        self._chunks += 1
        interval = self._interval or self._cfg.autotune_interval
        if self._chunks % max(1, interval):
            return
        self._decide()

    def _decide(self) -> None:
        cfg, st = self._cfg, self._stats
        dp = st.producer_stalls - self._last_prod
        dc = st.consumer_stalls - self._last_cons
        self._last_prod = st.producer_stalls
        self._last_cons = st.consumer_stalls
        now = self._now()
        rate = None
        if self._last_decide_t is not None and now > self._last_decide_t:
            rate = (self._chunks - self._last_interval_chunks) / (
                now - self._last_decide_t
            )
        self._last_decide_t = now
        self._last_interval_chunks = self._chunks
        if not self._warmed:
            # The first interval always contains the warm-up stall: the
            # consumer's first ring.get precedes any decoded chunk, so a
            # consumer_stall of 1 here says NOTHING about the steady state
            # — acting on it would widen decode on perfectly converged (or
            # consumer-bound) streams.  Discard it and measure from here.
            self._warmed = True
            return
        changes: dict = {}

        def move(knob: str, new) -> None:
            old = getattr(cfg, knob)
            if new != old:
                setattr(cfg, knob, new)
                changes[knob] = [old, new]

        if dc > 0 and dp == 0:
            # Decode-bound: the consumer found the ring empty this interval.
            # The floor scales with the width ratio actually widened: a
            # full doubling promises SCALING_FLOOR (1.3x); a ceiling-capped
            # 7->8 widen only promises ~1.13x even core-bound — holding it
            # to 1.3x would misread linear scaling as GIL-bound.
            floor = (
                1.0 + (self.SCALING_FLOOR - 1.0) * (self._widen_ratio - 1.0)
                if self._widen_ratio is not None
                else None
            )
            if (
                self._widen_rate is not None
                and floor is not None
                and rate is not None
                and rate / self._widen_rate < floor
                and cfg.decode_backend == "thread"
                and self._allow_backend_switch
            ):
                # A doubling of decode width bought <1.3x — the thread pool
                # is GIL-bound, not core-bound.  Promote the BACKEND: the
                # stream lazily spins up the spawned-process pool at its
                # next member submit.  The pool width must track the TUNED
                # decode width, not the (possibly starved) initial
                # decode_procs resolution — and it must land BEFORE the
                # backend flip: the producer thread polls the config per
                # member, and flipping first could race it into spawning
                # a 1-worker "parallel" pool that is never resized.
                move(
                    "decode_procs",
                    max(cfg.decode_procs, cfg.decode_threads),
                )
                move("decode_backend", "process")
                trace.metrics.inc("ingest_backend_promotions")
                self._widen_rate = None
                self._widen_ratio = None
            else:
                old_width = cfg.decode_threads
                move(
                    "decode_threads",
                    min(cfg.max_decode_threads, cfg.decode_threads * 2),
                )
                move(
                    "decode_ahead",
                    min(
                        self._max_ahead,
                        max(cfg.decode_ahead, cfg.decode_threads),
                    ),
                )
                if "decode_threads" in changes:
                    # Remember the pre-widen rate AND how much wider the
                    # pool really got: the NEXT decode-bound interval's
                    # rate over it is the measured scaling.
                    self._widen_rate = rate
                    self._widen_ratio = cfg.decode_threads / old_width
                elif cfg.decode_threads == cfg.max_decode_threads == old_width:
                    # Already at the width ceiling and still starved: treat
                    # the flatline as scaling evidence too (a capped pool
                    # can never demonstrate a doubling — hold it to the
                    # full-doubling floor so a flat rate reads GIL-bound).
                    self._widen_rate = self._widen_rate or rate
                    self._widen_ratio = self._widen_ratio or 2.0
        elif dp > 0 and dc == 0:
            # Consumer-bound: the producer blocked on a full ring.
            move(
                "decode_threads",
                max(self._min_threads, cfg.decode_threads - 1),
            )
            move("ring_capacity", min(self._max_ring, cfg.ring_capacity * 2))
            self._widen_rate = None
            self._widen_ratio = None
        else:
            # Converged or mixed interval: the pre-widen rate is no longer
            # comparable evidence (chunk mix and load drift between
            # decode-bound episodes) — a promotion must be argued from
            # CONSECUTIVE decode-bound intervals, never a rate measured
            # many intervals ago.
            self._widen_rate = None
            self._widen_ratio = None
        if not changes:
            return
        entry = {
            "chunk": self._chunks,
            "producer_stalls_delta": dp,
            "consumer_stalls_delta": dc,
            "changes": changes,
        }
        self.trajectory.append(entry)
        trace.metrics.inc("ingest_retunes")
        trace.instant("ingest_autotune", **entry)
        _logger.info(
            "ingest autotune @chunk %d: %s (producer_stalls+%d, "
            "consumer_stalls+%d)",
            self._chunks, changes, dp, dc,
        )

    def record(self) -> dict:
        return {
            "retunes": len(self.trajectory),
            "trajectory": list(self.trajectory),
            "final_config": self._cfg.record() if self._cfg else None,
        }
