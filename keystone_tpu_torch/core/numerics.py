"""Numerics & model-quality observatory (counterpart of
keystone_tpu/core/numerics.py): tensor-stat probes, conditioning
monitors, NaN provenance, and serving output-drift detection.

* **Tensor-stat probes** — :func:`probe` computes a small per-tensor
  reduction (count / nonfinite / mean / std / min / max / abs-max /
  zero-frac) on every ``KEYSTONE_NUMERICS_SAMPLE``-th visit to a probe
  site.  A tensor reduces on its own device in one stacked reduction
  (eight scalars cross to the host, never the tensor); a numpy array
  reduces in numpy.  Sites sit at every pipeline node boundary
  (``Pipeline.__call__``) and at the streamed featurize output
  (``StreamBatch.apply``).  Stats export as ``numerics_*`` gauges and
  histograms in ``trace.metrics`` and as ``numerics.node`` trace
  instants.  Probes never change the probed value.
* **Conditioning monitor** — :func:`estimate_gram_condition` runs a
  few-step Lanczos iteration on a gram block (on the gram's device) for a
  cheap κ estimate, emitted as a predictive ``cond_warn`` counted fault
  when κ exceeds ``KEYSTONE_COND_WARN``, before the Cholesky jitter-retry
  in ``solvers.normal_equations`` trips.  :func:`design_conditioning`
  probes the blocks of a blocked design matrix from a bounded row sample.
* **NaN provenance** — when a probe's nonfinite count trips on a streamed
  batch, :func:`nonfinite_rows` bisects to the offending rows and the
  provenance (tar member names, request ids) is counted
  (``numerics_nonfinite``, a postmortem family), stored for
  :func:`provenance_note`, and appended to the typed error
  ``resilience.assert_all_finite`` raises.
* **Output-drift detection** — a :class:`DriftMonitor` keeps a streaming
  :class:`OutputSketch` of an engine's answers against a fit-time
  baseline; divergence beyond ``KEYSTONE_DRIFT_TOL`` is counted
  ``serve_output_drift``.  Detection only — answers are never altered.

Overhead discipline: :func:`active` is one env-flag check (the
``KEYSTONE_NUMERICS=1`` opt-in or the programmatic :func:`monitored`
override); with the observatory OFF every hook is exactly that check and
no per-site state is retained.

This module imports no torch at import time; the reductions import it
when they run.
"""

from __future__ import annotations

import contextlib
import logging
import os
import re
import threading
import time
from collections import deque

import numpy as np

from . import trace
from .resilience import counters

_logger = logging.getLogger("keystone_tpu_torch.numerics")

#: env var: ``1`` turns the numerics observatory on (probes, conditioning
#: monitor, drift detection).
NUMERICS_ENV = "KEYSTONE_NUMERICS"
#: env var: probe every Nth visit to each probe site (default 1 = every).
SAMPLE_ENV = "KEYSTONE_NUMERICS_SAMPLE"
#: env var: output-distribution divergence tolerance before a counted
#: ``serve_output_drift`` fires (total-variation distance for class
#: histograms, IQR-normalized max decile shift otherwise).
DRIFT_TOL_ENV = "KEYSTONE_DRIFT_TOL"
#: env var: κ estimate above this emits the predictive ``cond_warn``.
COND_WARN_ENV = "KEYSTONE_COND_WARN"

DEFAULT_SAMPLE = 1
DEFAULT_DRIFT_TOL = 0.25
#: The f32 direct solve degrades smoothly to κ~1e7 and breaks down
#: (jitter escalations begin) near κ~1/eps_f32.  The few-step
#: Ritz estimate LOWER-bounds true κ by roughly one order of magnitude at
#: :data:`COND_ITERS` steps, so the default threshold sits one decade
#: under the true-κ comfort bound: an estimate past 1e5 means the true
#: gram is at ~1e6+, two decades before the jitter ladder trips —
#: predictive, with normalized-feature pipelines (true κ well under 1e5)
#: never paging.
DEFAULT_COND_WARN = 1e5

#: Answers observed before a drift verdict can fire — a divergent first
#: handful of requests is noise, not a page.
DRIFT_MIN_COUNT = 32
#: Bounded value reservoir backing the quantile sketch.
QUANTILE_RESERVOIR = 4096
#: Class-histogram cardinality cap: wider heads fall back to quantiles.
MAX_CLASSES = 1024
#: Offending rows reported per provenance record (the FIRST rows carry
#: the information; a fully-poisoned batch must not flood the ledger).
MAX_PROVENANCE_ROWS = 32
#: Krylov (Lanczos) steps per κ estimate — each is one gram matvec.
COND_ITERS = 32
#: Row cap for design-block conditioning probes (a κ estimate must never
#: re-upload an 8 GB host-staged design matrix).
COND_ROWS_CAP = 4096
#: Block cap per solve for design conditioning (first blocks suffice as
#: a conditioning fingerprint of the featurization).
COND_BLOCKS_CAP = 8

_NAME_RE = re.compile(r"[^a-zA-Z0-9_.:-]")

_override: bool | None = None


def _env_flag(name: str) -> bool:
    return os.environ.get(name, "").strip().lower() in ("1", "true", "on", "yes")


def active() -> bool:
    """Is the numerics observatory on?  ``KEYSTONE_NUMERICS=1`` or the
    programmatic :func:`monitored` override.  THE hot-path check — every
    probe hook on the pipeline/ingest/serve paths is gated on it."""
    if _override is not None:
        return _override
    return _env_flag(NUMERICS_ENV)


def _env_pos_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        val = int(raw)
    except ValueError:
        _logger.error("%s=%r is not an integer — using %d", name, raw, default)
        return default
    return max(1, val)


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        _logger.error("%s=%r is not a number — using %g", name, raw, default)
        return default


def sample_every() -> int:
    return _env_pos_int(SAMPLE_ENV, DEFAULT_SAMPLE)


def drift_tol() -> float:
    return max(1e-6, _env_float(DRIFT_TOL_ENV, DEFAULT_DRIFT_TOL))


def cond_warn_threshold() -> float:
    return max(1.0, _env_float(COND_WARN_ENV, DEFAULT_COND_WARN))


# -- the tensor-stat reducer ---------------------------------------------------

_STAT_FIELDS = (
    "count", "nonfinite", "mean", "std", "min", "max", "abs_max", "zero_frac",
)


def _torch_stats_vector(v) -> np.ndarray:
    """The eight stats of tensor ``v`` as one stacked reduction on its own
    device; only the eight f32 scalars cross to the host."""
    import torch

    f = v.detach().reshape(-1).to(torch.float32)
    finite = torch.isfinite(f)
    nfin = finite.sum()
    denom = nfin.clamp(min=1).to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=f.device)
    inf = torch.full((), float("inf"), dtype=torch.float32, device=f.device)
    xf = torch.where(finite, f, zero)
    mean = xf.sum() / denom
    var = (torch.sum(xf * xf) / denom - mean * mean).clamp(min=0.0)
    size = torch.full((), float(f.numel()), dtype=torch.float32, device=f.device)
    if f.numel():
        lo = torch.where(finite, f, inf).min()
        hi = torch.where(finite, f, -inf).max()
        amax = torch.where(finite, f.abs(), zero).max()
    else:
        lo, hi, amax = inf, -inf, zero
    vec = torch.stack(
        [
            size,
            size - nfin.to(torch.float32),
            mean,
            torch.sqrt(var),
            lo,
            hi,
            amax,
            torch.where(finite, (f == 0.0).to(torch.float32), zero).sum() / denom,
        ]
    )
    return vec.cpu().numpy().astype(np.float64)


def _np_stats_vector(arr: np.ndarray) -> np.ndarray:
    f = np.asarray(arr, np.float32).ravel()
    finite = np.isfinite(f)
    nfin = int(finite.sum())
    denom = max(nfin, 1)
    xf = np.where(finite, f, 0.0)
    mean = float(xf.sum()) / denom
    var = max(float((xf * xf).sum()) / denom - mean * mean, 0.0)
    return np.array(
        [
            f.size,
            f.size - nfin,
            mean,
            var ** 0.5,
            float(f[finite].min()) if nfin else np.inf,
            float(f[finite].max()) if nfin else -np.inf,
            float(np.abs(f[finite]).max()) if nfin else 0.0,
            (float((f[finite] == 0.0).sum()) / denom) if nfin else 0.0,
        ],
        np.float64,
    )


def tensor_stats(x) -> dict:
    """The probe reduction of one tensor: ``count`` / ``nonfinite`` /
    ``mean`` / ``std`` / ``min`` / ``max`` / ``abs_max`` / ``zero_frac``
    (moments over the FINITE values, so a NaN-poisoned batch still reports
    a meaningful center).  A tensor reduces on its own device in one
    stacked reduction — only eight scalars cross to the host; anything
    else reduces in numpy.  Integer and half-precision dtypes reduce in
    f32."""
    if _is_tensor(x):
        vec = _torch_stats_vector(x)
    else:
        vec = _np_stats_vector(np.asarray(x))
    out = dict(zip(_STAT_FIELDS, (float(v) for v in vec)))
    out["count"] = int(out["count"])
    out["nonfinite"] = int(round(out["nonfinite"]))
    if out["count"] == out["nonfinite"]:
        # No finite value at all: the masked extremes are sentinel ±inf —
        # report zeros rather than leaking the sentinels into gauges/JSON.
        out["min"] = out["max"] = out["abs_max"] = 0.0
    return out


def _is_array_like(x) -> bool:
    return hasattr(x, "shape") and hasattr(x, "dtype")


def _is_tensor(x) -> bool:
    return hasattr(x, "detach") and hasattr(x, "is_floating_point")


# -- NaN provenance ------------------------------------------------------------


def nonfinite_rows(x, limit: int = MAX_PROVENANCE_ROWS) -> list[int]:
    """Host-side bisect to the rows of ``x`` holding non-finite values:
    the row range halves recursively and only halves that report
    non-finite are descended, so a batch with one poisoned member touches
    ``O(log n)`` interval reductions.  Returns at most ``limit`` row
    indices, ascending.  A tensor is copied to the host first (this runs
    only after a probe found a non-finite value)."""
    if _is_tensor(x):
        x = x.detach().float().cpu().numpy()
    arr = np.asarray(x)
    if arr.ndim == 0:
        return [0] if not np.isfinite(arr) else []
    flat = arr.reshape(arr.shape[0], -1)
    out: list[int] = []
    stack = [(0, flat.shape[0])]
    while stack and len(out) < limit:
        lo, hi = stack.pop()
        if np.isfinite(flat[lo:hi]).all():
            continue
        if hi - lo == 1:
            out.append(lo)
            continue
        mid = (lo + hi) // 2
        # Right half pushed first so the pop order walks rows ascending.
        stack.append((mid, hi))
        stack.append((lo, mid))
    return sorted(out)


_prov_lock = threading.Lock()
_provenance: deque = deque(maxlen=8)


def record_provenance(
    site: str, rows: list[int], labels: list | None = None, kind: str = "batch"
) -> dict:
    """Store (and count) one non-finite provenance record: WHICH rows of
    WHICH site went non-finite, named by tar member (``kind="member"``) or
    request id (``kind="request"``) when the caller knows them.  The
    count (``numerics_nonfinite``) is a postmortem family, so the dump
    carries the names; :func:`provenance_note` feeds them into the typed
    error ``assert_all_finite`` raises."""
    named = [str(v) for v in labels] if labels else [str(r) for r in rows]
    rec = {
        "site": site,
        "kind": kind,
        "rows": list(rows),
        "names": named,
        "time_unix": time.time(),
    }
    with _prov_lock:
        _provenance.append(rec)
    counters.record(
        "numerics_nonfinite",
        f"{site}: {len(rows)} non-finite row(s) — {kind}(s) "
        f"{', '.join(named[:8])}{'...' if len(named) > 8 else ''}",
    )
    return rec


def provenance_records() -> list[dict]:
    with _prov_lock:
        return [dict(r) for r in _provenance]


def provenance_note(max_age_s: float = 60.0) -> str | None:
    """One-line summary of the most recent non-finite provenance (None
    when nothing tripped within ``max_age_s``) — appended to
    ``assert_all_finite``'s typed error so the failure names the
    member/request that produced the NaN instead of just the batch that
    carried it.  Worded as a CORRELATION, and age-bounded, because the
    record is process-global: a trip on another stream/engine minutes ago
    must not masquerade as this failure's cause."""
    now = time.time()
    with _prov_lock:
        if not _provenance:
            return None
        rec = _provenance[-1]
        if now - rec["time_unix"] > max_age_s:
            return None
    names = ", ".join(rec["names"][:8])
    more = "..." if len(rec["names"]) > 8 else ""
    return (
        f"most recent non-finite probe trip ({now - rec['time_unix']:.1f}s "
        f"ago) traced to {rec['kind']}(s) {names}{more} at probe site "
        f"{rec['site']!r}"
    )


# -- probe sites ---------------------------------------------------------------


class _SiteState:
    __slots__ = ("visits", "sampled", "nonfinite_total", "last")

    def __init__(self):
        self.visits = 0
        self.sampled = 0
        self.nonfinite_total = 0
        self.last: dict | None = None


_site_lock = threading.Lock()
_sites: dict[str, _SiteState] = {}
_SITES_MAX = 512


def probe(site: str, value, *, names=None, request_ids=None):
    """Record tensor stats for ``value`` at probe site ``site`` (every
    ``KEYSTONE_NUMERICS_SAMPLE``-th visit) and return ``value`` UNCHANGED
    — the probe reads, never mutates, donates, or raises, so a probed
    path is bit-identical to an unmonitored one by construction.

    ``names`` (tar member names) / ``request_ids`` give non-finite trips
    their provenance.  Callers gate on :func:`active` (cheap to call
    unconditionally too — the off path is one flag check and retains no
    state)."""
    if not active() or not _is_array_like(value):
        return value
    try:
        with _site_lock:
            state = _sites.get(site)
            if state is None:
                if len(_sites) >= _SITES_MAX:
                    _sites.pop(next(iter(_sites)))
                state = _sites[site] = _SiteState()
            state.visits += 1
            if (state.visits - 1) % sample_every() != 0:
                return value
            state.sampled += 1
        stats = tensor_stats(value)
        with _site_lock:
            state.last = stats
            if stats["nonfinite"]:
                state.nonfinite_total += stats["nonfinite"]
        metric = _NAME_RE.sub("_", site)
        for field in ("mean", "std", "min", "max", "abs_max", "zero_frac"):
            trace.metrics.gauge(f"numerics_{metric}_{field}", stats[field])
        trace.metrics.gauge(f"numerics_{metric}_nonfinite", stats["nonfinite"])
        trace.metrics.observe(f"numerics_{metric}_abs_max", stats["abs_max"])
        trace.instant("numerics.node", site=site, **stats)
        if stats["nonfinite"]:
            rows = nonfinite_rows(value)
            labels = kind = None
            if request_ids is not None:
                labels = [request_ids[r] for r in rows if r < len(request_ids)]
                kind = "request"
            elif names is not None:
                labels = [names[r] for r in rows if r < len(names)]
                kind = "member"
            record_provenance(site, rows, labels, kind or "row")
    except Exception:  # noqa: BLE001 — observability must never break the path
        _logger.exception("numerics probe at %r failed", site)
    return value


def site_stats() -> dict:
    """site -> {visits, sampled, nonfinite_total, last stats}."""
    with _site_lock:
        return {
            site: {
                "visits": s.visits,
                "sampled": s.sampled,
                "nonfinite_total": s.nonfinite_total,
                **({"last": dict(s.last)} if s.last else {}),
            }
            for site, s in _sites.items()
        }


# -- conditioning monitor ------------------------------------------------------

_cond_tls = threading.local()
_cond_lock = threading.Lock()
_cond_recent: deque = deque(maxlen=64)


@contextlib.contextmanager
def collect_conditioning():
    """Collect every κ estimate recorded inside the block — a fit wraps
    its solve with this so the per-solve ``solve_gram_l2`` estimates join
    the design-block probes.  Per-thread; nesting keeps the inner
    collector until it exits."""
    rows: list = []
    prev = getattr(_cond_tls, "rows", None)
    _cond_tls.rows = rows
    try:
        yield rows
    finally:
        _cond_tls.rows = prev


def _note_condition(row: dict) -> None:
    rows = getattr(_cond_tls, "rows", None)
    if rows is not None:
        rows.append(row)
    with _cond_lock:
        _cond_recent.append(row)
    metric = _NAME_RE.sub("_", row["label"])
    if row.get("kappa") is not None:
        trace.metrics.gauge(f"numerics_{metric}_kappa", row["kappa"])
    trace.instant("numerics.conditioning", **row)
    if row["warned"]:
        counters.record(
            "cond_warn",
            f"{row['label']}: estimated kappa {row['kappa']:.3g} exceeds "
            f"{cond_warn_threshold():.3g} — the f32 Cholesky is heading "
            "into its breakdown range (escalation likely)",
        )


def estimate_gram_condition(
    gram, lam: float = 0.0, label: str = "gram", iters: int = COND_ITERS
) -> dict:
    """Cheap κ estimate of a (PSD) gram block via a few-step Lanczos
    (Krylov power iteration): ``iters`` gram matvecs build an
    orthogonalized Krylov basis whose tridiagonal Ritz values bracket-in
    on BOTH spectrum ends, riding the gram the solver already formed.
    The reported κ is of the REGULARIZED system ``G + λI`` (what the
    Cholesky actually factors), so the predictive ``cond_warn`` fires for
    the solve that will actually struggle.  Ritz values lie inside
    ``[λ_min, λ_max]``, so the estimate LOWER-bounds the true κ — a
    warning is never a false alarm; the few-step form is a monitor, not
    an eigensolver.

    NEVER raises: a non-finite gram (the very fault the solver's finite
    guard exists to convert into a typed error) or any estimator failure
    returns a ``kappa=None`` row — the monitor steps aside so the typed
    recovery path downstream stays intact."""
    try:
        return _estimate_gram_condition(gram, lam, label, iters)
    except Exception:  # noqa: BLE001 — observability must never break the path
        _logger.exception("conditioning estimate for %r failed", label)
        return {
            "label": label,
            "kappa": None,
            "lam_max": None,
            "lam_min": None,
            "warned": False,
            "error": "estimate failed",
        }


def _estimate_gram_condition(gram, lam: float, label: str, iters: int) -> dict:
    import torch

    g = torch.as_tensor(gram).to(torch.float32)
    d = int(g.shape[0])
    k = max(2, min(int(iters), d))
    rng = np.random.default_rng(20260804)
    v = torch.from_numpy(rng.standard_normal(d).astype(np.float32)).to(g.device)
    v = v / torch.linalg.norm(v)
    basis = [v]
    alphas: list[float] = []
    betas: list[float] = []
    for j in range(k):
        w = g @ basis[j]
        alphas.append(float(basis[j] @ w))
        # Full reorthogonalization, TWICE (Parlett's "twice is enough"):
        # k is small, and f32 Lanczos without it manufactures spurious
        # Ritz copies that would poison λ_min.
        for _ in range(2):
            for b in basis:
                w = w - (b @ w) * b
        beta = float(torch.linalg.norm(w))
        # Happy breakdown, judged RELATIVE to the spectrum scale seen so
        # far: once the Krylov space is exhausted the residual is pure
        # f32 noise, and normalizing it would inject junk directions
        # whose off-diagonals smear the Ritz extremes (κ(I) would read
        # above 1 without this stop).
        scale = max(abs(a) for a in alphas) or 1.0
        if beta <= 1e-6 * scale or j == k - 1:
            break
        betas.append(beta)
        basis.append(w / beta)
    tri = np.diag(np.asarray(alphas))
    if betas:
        off = np.asarray(betas)
        tri += np.diag(off, 1) + np.diag(off, -1)
    if not np.isfinite(tri).all():
        # A NaN/Inf gram: κ is meaningless and eigvalsh would raise —
        # report the non-finiteness instead (the solver's own finite
        # guard raises the TYPED error right after this hook returns).
        row = {
            "label": label,
            "dim": d,
            "lam": max(float(lam), 0.0),
            "lam_max": None,
            "lam_min": None,
            "kappa": None,
            "iters": len(alphas),
            "warned": False,
            "nonfinite_gram": True,
        }
        _note_condition(row)
        return row
    ritz = np.linalg.eigvalsh(tri)
    lam_max = float(ritz[-1])
    lam_min = max(float(ritz[0]), 0.0)
    lam = max(float(lam), 0.0)
    # Relative floor on the denominator: an exactly-singular gram reads
    # κ ≈ 1e12 (far past every threshold, and past anything f32 can
    # resolve) instead of inf — every artifact embedding this row stays
    # strict JSON.
    denom = max(lam_min + lam, (lam_max + lam) * 1e-12, 1e-30)
    kappa = (lam_max + lam) / denom
    row = {
        "label": label,
        "dim": d,
        "lam": lam,
        "lam_max": lam_max,
        "lam_min": lam_min,
        "kappa": kappa,
        "iters": len(alphas),
        "warned": bool(kappa > cond_warn_threshold()),
    }
    _note_condition(row)
    return row


def design_conditioning(
    x,
    widths,
    lam: float,
    label: str = "solve",
    rows_cap: int = COND_ROWS_CAP,
    blocks_cap: int = COND_BLOCKS_CAP,
) -> list[dict]:
    """Per-block κ estimates for a blocked design matrix (the solvers'
    ``_blocked_design_matrix`` layout: block i occupies columns
    ``[i·bs, (i+1)·bs)``).  Each probed block's gram forms from a bounded
    row sample (``rows_cap``) on the matrix's own device, so the probe's
    cost stays fixed no matter how big the fit is.  Gated by the caller
    on :func:`active`."""
    import torch

    bs = max(widths)
    rows = min(int(x.shape[0]), rows_cap)
    out = []
    for i, w in enumerate(widths[:blocks_cap]):
        blk = torch.as_tensor(x[:rows, i * bs : i * bs + w]).to(torch.float32)
        gram = blk.T @ blk
        row = estimate_gram_condition(gram, lam, label=f"{label}:block{i}")
        row["block"] = i
        row["rows_sampled"] = rows
        out.append(row)
    if len(widths) > blocks_cap:
        _logger.info(
            "%s: conditioning probed on the first %d of %d blocks",
            label, blocks_cap, len(widths),
        )
    return out


def recent_conditioning() -> list[dict]:
    with _cond_lock:
        return [dict(r) for r in _cond_recent]


# -- serving output-drift detection --------------------------------------------


class OutputSketch:
    """Streaming sketch of an output distribution.

    ``class_histogram`` for classifier heads (integer answers under
    :data:`MAX_CLASSES` distinct values): per-class counts, divergence is
    total-variation distance.  ``quantile`` otherwise: a bounded strided
    reservoir of values, divergence is the max decile shift normalized by
    the BASELINE's inter-decile range — scale-aware, so a regression head
    whose answers drift by a fraction of their spread fires at the same
    tolerance a classifier does."""

    DECILES = tuple(q / 10.0 for q in range(1, 10))

    #: values appended per observe() call (strided) — bounds the per-call
    #: cost no matter how wide the output batch is.
    OBSERVE_CAP = 1024

    def __init__(self, kind: str):
        self.kind = kind
        self.observed = 0
        # BOTH kinds sketch a SLIDING window of the most recent
        # :data:`QUANTILE_RESERVOIR` values, not a from-the-beginning
        # accumulation: a distribution that shifts only after a long
        # healthy serving prefix must still move the sketch (an
        # accumulate-forever histogram dilutes the shift by
        # O(healthy-prefix) and a fill-once reservoir freezes on it).
        self.counts: dict[int, int] = {}
        self._window: deque = deque()  # class values backing `counts`
        self.reservoir: deque = deque(maxlen=QUANTILE_RESERVOIR)

    # -- construction ---------------------------------------------------------

    @classmethod
    def for_outputs(cls, arr) -> "OutputSketch":
        """Fresh sketch whose kind fits ``arr``'s answers: NON-NEGATIVE
        integer dtype with values under :data:`MAX_CLASSES` -> class
        histogram (classifier heads), anything else -> quantiles.  The
        value bound is the memory bound too — a wide-range/negative
        integer head (quantized regression, hashes) must fall to the
        quantile sketch, never grow an unbounded per-value counts dict."""
        a = np.asarray(arr)
        kind = "quantile"
        if a.dtype.kind in "iub" and (
            a.size == 0
            or (
                int(a.min(initial=0)) >= 0
                and int(a.max(initial=0)) < MAX_CLASSES
            )
        ):
            kind = "class_histogram"
        sk = cls(kind)
        sk.observe(a)
        return sk

    def observe(self, arr) -> None:
        a = np.asarray(arr)
        if a.size == 0:
            return
        self.observed += int(a.shape[0]) if a.ndim else 1
        if self.kind == "class_histogram":
            for v in a.astype(np.int64).ravel().tolist():
                self._window.append(v)
                self.counts[v] = self.counts.get(v, 0) + 1
                if len(self._window) > QUANTILE_RESERVOIR:
                    old = self._window.popleft()
                    left = self.counts.get(old, 1) - 1
                    if left:
                        self.counts[old] = left
                    else:
                        self.counts.pop(old, None)
        else:
            flat = np.asarray(a, np.float64).ravel()
            flat = flat[np.isfinite(flat)]
            if flat.size:
                stride = max(1, flat.size // self.OBSERVE_CAP)
                self.reservoir.extend(
                    flat[::stride][: self.OBSERVE_CAP].tolist()
                )

    # -- summaries ------------------------------------------------------------

    def quantiles(self) -> dict[str, float]:
        if not self.reservoir:
            return {}
        qs = np.quantile(np.asarray(self.reservoir), self.DECILES)
        return {f"q{int(q * 100)}": float(v) for q, v in zip(self.DECILES, qs)}

    def record(self) -> dict:
        out: dict = {"kind": self.kind, "observed": self.observed}
        if self.kind == "class_histogram":
            out["counts"] = {str(k): v for k, v in sorted(self.counts.items())}
        else:
            out["quantiles"] = self.quantiles()
        return out

    @classmethod
    def from_record(cls, rec: dict) -> "OutputSketch":
        sk = cls(rec.get("kind", "quantile"))
        sk.observed = int(rec.get("observed", 0))
        if sk.kind == "class_histogram":
            sk.counts = {int(k): int(v) for k, v in rec.get("counts", {}).items()}
        else:
            # A baseline restored from a manifest carries quantiles, not
            # raw values; divergence() reads them via _baseline_quantiles.
            sk._frozen_quantiles = dict(rec.get("quantiles", {}))
        return sk

    def _quantile_view(self) -> dict[str, float]:
        frozen = getattr(self, "_frozen_quantiles", None)
        return frozen if frozen else self.quantiles()

    def divergence(self, live: "OutputSketch") -> float | None:
        """How far ``live``'s distribution sits from THIS (baseline)
        sketch: TV distance in [0, 1] for class histograms, baseline-IQR-
        normalized max decile shift for quantiles.  None when either side
        has nothing to compare."""
        if self.kind != live.kind:
            return 1.0  # the head changed families — maximally divergent
        if self.kind == "class_histogram":
            tot_b = sum(self.counts.values())
            tot_l = sum(live.counts.values())
            if not tot_b or not tot_l:
                return None
            keys = set(self.counts) | set(live.counts)
            return 0.5 * sum(
                abs(
                    self.counts.get(k, 0) / tot_b
                    - live.counts.get(k, 0) / tot_l
                )
                for k in keys
            )
        qb, ql = self._quantile_view(), live._quantile_view()
        shared = sorted(set(qb) & set(ql))
        if not shared:
            return None
        scale = max(abs(qb.get("q90", 0.0) - qb.get("q10", 0.0)), 1e-9)
        return max(abs(qb[k] - ql[k]) for k in shared) / scale


class DriftMonitor:
    """Per-engine output-drift watcher: a fit-time baseline sketch vs a
    live sketch of served answers, judged at ``KEYSTONE_DRIFT_TOL`` once
    :data:`DRIFT_MIN_COUNT` answers are in.  A breach is counted ONCE
    (``serve_output_drift`` — a postmortem family, so the flight-recorder
    dump fires) and latches; it re-arms
    when divergence falls back under half the tolerance, so a persistent
    shift cannot storm the ledger.  Observation only: the monitor never
    touches an answer."""

    def __init__(self, label: str, baseline: dict, tol: float | None = None):
        self.label = label
        self.baseline = OutputSketch.from_record(baseline)
        self.live = OutputSketch(self.baseline.kind)
        self.tol = tol if tol is not None else drift_tol()
        self.latched = False
        self.breaches = 0
        self.last_divergence: float | None = None
        self._lock = threading.Lock()
        with _drift_lock:
            _monitors[label] = self

    def _noise_allowance(self, observed: int) -> float:
        """Sampling-noise slack added to the tolerance while the live
        window is small: the TV distance of an n-sample empirical
        histogram from its own k-class source is ~0.5·sqrt(k/n) in
        expectation (decile noise ~1/sqrt(n) for the quantile kind), so
        judging a 32-answer window at the bare tolerance pages on pure
        sampling noise (a healthy 10-class engine's warmup can breach tol
        0.25 at n≈32).  The allowance decays to ~0 as the
        window fills — a real shift still fires, just not off a handful
        of answers."""
        n = max(observed, 1)
        if self.baseline.kind == "class_histogram":
            k = max(len(self.baseline.counts), 1)
            return 0.5 * (k / n) ** 0.5
        return 2.0 / n ** 0.5

    def observe(self, outputs) -> None:
        try:
            with self._lock:
                self.live.observe(outputs)
                if self.live.observed < DRIFT_MIN_COUNT:
                    return
                d = self.baseline.divergence(self.live)
                if d is None:
                    return
                self.last_divergence = d
                threshold = self.tol + self._noise_allowance(
                    min(self.live.observed, QUANTILE_RESERVOIR)
                )
                fire = d > threshold and not self.latched
                if fire:
                    self.latched = True
                    self.breaches += 1
                elif self.latched and d < 0.5 * self.tol:
                    self.latched = False
            metric = _NAME_RE.sub("_", self.label)
            trace.metrics.gauge(f"numerics_{metric}_output_divergence", d)
            if fire:
                counters.record(
                    "serve_output_drift",
                    f"serve:{self.label}: output distribution diverged "
                    f"{d:.4f} from the fit-time baseline (tol {self.tol:g}, "
                    f"{self.live.observed} answers observed) — the request "
                    "mix or the model moved",
                )
        except Exception:  # noqa: BLE001 — detection must never break serving
            _logger.exception("drift monitor %r failed", self.label)

    def rearm(self, baseline: dict) -> None:
        """Swap in a NEW fit-time baseline and reset the live window and
        the latch (counted ``drift_rearmed``), so answers after a model
        swap are judged against the new model's baseline from the swap
        instant.  ``breaches`` is cumulative across re-arms (the monitor's
        lifetime ledger)."""
        with self._lock:
            self.baseline = OutputSketch.from_record(baseline)
            self.live = OutputSketch(self.baseline.kind)
            self.latched = False
            self.last_divergence = None
        counters.record(
            "drift_rearmed",
            f"serve:{self.label}: drift monitor re-armed on a fresh "
            f"fit-time baseline ({self.baseline.kind}, "
            f"{self.baseline.observed} fit-time answers)",
        )

    def record(self) -> dict:
        with self._lock:
            return {
                "label": self.label,
                "kind": self.baseline.kind,
                "tol": self.tol,
                "observed": self.live.observed,
                "divergence": (
                    round(self.last_divergence, 6)
                    if self.last_divergence is not None
                    else None
                ),
                "drifted": self.latched,
                "breaches": self.breaches,
                "baseline_observed": self.baseline.observed,
            }


_drift_lock = threading.Lock()
_monitors: dict[str, DriftMonitor] = {}


def drift_monitors() -> dict:
    with _drift_lock:
        monitors = list(_monitors.values())
    return {m.label: m.record() for m in monitors}


def unregister_drift(label: str) -> None:
    with _drift_lock:
        _monitors.pop(label, None)


# -- the adopted metrics group / lifecycle -------------------------------------


def snapshot() -> dict:
    """The observatory's whole surface as one JSON-able dict (the adopted
    ``numerics`` metrics group; also what ``/statusz`` and postmortem
    dumps embed)."""
    return {
        "active": active(),
        "sample_every": sample_every(),
        "sites": site_stats(),
        "conditioning": recent_conditioning(),
        "provenance": provenance_records(),
        "drift": drift_monitors(),
    }


class _NumericsGroup:
    def snapshot(self, reset: bool = False) -> dict:
        out = snapshot()
        if reset:
            reset_state(keep_monitors=True)
        return out


trace.metrics.adopt("numerics", _NumericsGroup())


def reset_state(keep_monitors: bool = False) -> None:
    """Test isolation: forget sites, provenance, and conditioning history
    (and drift monitors unless ``keep_monitors``)."""
    with _site_lock:
        _sites.clear()
    with _prov_lock:
        _provenance.clear()
    with _cond_lock:
        _cond_recent.clear()
    if not keep_monitors:
        with _drift_lock:
            _monitors.clear()


@contextlib.contextmanager
def monitored(on: bool = True):
    """Programmatic enable/disable for benches and tests —
    overrides the ``KEYSTONE_NUMERICS`` env gate for the block and
    restores the previous state on exit."""
    global _override
    prev = _override
    _override = on
    try:
        yield
    finally:
        _override = prev
