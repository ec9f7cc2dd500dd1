"""Fleet observability plane (counterpart of keystone_tpu/core/fleetobs.py):
cross-host metrics aggregation, fleet statusz, and one-file clock-aligned
incident capture.

Every observability tier below this one stops at the process boundary —
one registry, one statusz, one flight recorder per process — while the
system itself runs as several processes (``HostFleet`` fronts N
host-local routers).  This module sees the fleet as ONE system, in two
halves:

* **Agent** — every :class:`~.wire.WireServer` answers the
  ``T_OBS_SNAPSHOT`` / ``T_OBS_FLIGHT`` frames by calling
  :func:`agent_payload`, so a serving member's existing port IS its obs
  endpoint.  A process with no serving socket runs an :class:`ObsAgent`
  (a wire server whose only job is the obs frames).  The payload carries
  the registry snapshot, the statusz providers, RAW histogram sample
  windows (:meth:`~.trace.Metrics.hist_windows`), the flight-recorder
  ring, and the member's ``trace.now_us`` clock stamp.

* **Collector** (:class:`FleetCollector`) — scrapes all registered
  members every ``KEYSTONE_OBS_INTERVAL_S`` and merges them into
  fleet-level metrics: counters SUMMED (last-known values retained for
  dead members, carried across re-admitted reformed survivors — the
  fleet view is monotone through a member loss), gauges LABELED per
  host, and latency histograms merged from pooled raw sample windows —
  fleet p50/p99 and error-budget burn are computed from the pooled
  observations, never by averaging per-host percentiles.  The merged
  view renders as a fleet Prometheus exposition with ``host``/``rank``
  labels, a fleet ``/statusz`` (schema-tagged) and ``/healthz`` (a dead
  member = DEGRADED, counted ``obs_member_lost`` — never a collector
  crash).

**Incident capture** — when any member reports a postmortem-family
fault (its fault ledger moved on a :data:`~.telemetry.POSTMORTEM_KINDS`
kind), or a member dies mid-scrape, the collector pulls the flight ring
from EVERY reachable member within a bounded window
(``KEYSTONE_OBS_WINDOW_S``) and writes ONE schema-tagged incident
bundle (``keystone.incident/1``) whose events are aligned onto the
COLLECTOR's clock via the per-member T_CLOCK offsets.  The schemas and
env names are the JAX package's, so the two packages' collectors,
members and ``tools/fleet_view.py`` read each other's payloads and
bundles.

Clock model: :meth:`~.wire.WireClient.clock_sync` estimates
``offset_us`` = member_clock − (collector_clock + rtt/2); a member
timestamp lands on the collector timeline as ``ts − offset_us``.

Imports no torch: the payload is registry state and host clocks.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time

from . import trace
from .resilience import counters

_logger = logging.getLogger("keystone_tpu_torch.fleetobs")

OBS_INTERVAL_ENV = "KEYSTONE_OBS_INTERVAL_S"
OBS_DIR_ENV = "KEYSTONE_OBS_DIR"
OBS_WINDOW_ENV = "KEYSTONE_OBS_WINDOW_S"

DEFAULT_INTERVAL_S = 1.0
DEFAULT_WINDOW_S = 5.0

#: Per-trigger-kind incident-bundle cap per collector (the telemetry
#: postmortem discipline: the FIRST occurrences carry the information; a
#: fault storm repeating one kind must not fill a disk).
MAX_INCIDENTS_PER_KIND = 3

OBS_SCHEMA = "keystone.obs/1"
FLEET_STATUSZ_SCHEMA = "keystone.fleet_statusz/1"
INCIDENT_SCHEMA = "keystone.incident/1"


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        _logger.error("%s=%r is not a number — using %g", name, raw, default)
        return default


# -- the agent payload (served by every WireServer) ---------------------------


def agent_payload(kind: str = "snapshot") -> dict:
    """The per-process observability surface one ``T_OBS_*`` frame ships:
    ``"snapshot"`` = statusz + registry snapshot + raw histogram sample
    windows; ``"flight"`` = the flight-recorder ring.  Both stamped with
    this process's ``trace.now_us`` (the clock the T_CLOCK handshake
    measured) so the collector can align them."""
    from . import telemetry

    out = {
        "schema": OBS_SCHEMA,
        "kind": kind,
        "pid": os.getpid(),
        "time_unix": time.time(),
        "now_us": trace.now_us(),
        "rank": int(os.environ.get("KEYSTONE_DIST_RANK", "0") or 0),
    }
    if kind == "flight":
        out["flight"] = trace.flight_events()
    else:
        out["statusz"] = telemetry.statusz_snapshot()
        out["hist_windows"] = trace.metrics.hist_windows()
    return out


class _NullTarget:
    """Serving target of an obs-only endpoint: every REQUEST is refused
    typed (the port exists for the T_OBS_*/T_CLOCK frames)."""

    def submit(self, arr):
        from .serve import ServingUnavailable

        raise ServingUnavailable("observability-only endpoint serves no model")


class ObsAgent:
    """A standalone obs endpoint for processes WITHOUT a serving wire
    server (fit workers, a fleet controller): a
    :class:`~.wire.WireServer` over a null target — the dispatch path
    already answers T_OBS_SNAPSHOT/T_OBS_FLIGHT/T_CLOCK for every wire
    server, so all this adds is the socket."""

    def __init__(self, port: int = 0, *, label: str = "obs"):
        from . import wire

        self._server = wire.WireServer(
            _NullTarget(), port=port, label=f"obs:{label}"
        )
        self.host = self._server.host
        self.port = self._server.port

    def close(self) -> None:
        self._server.close()

    def __enter__(self) -> "ObsAgent":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# -- pooled-window merge math (pure, tested) ----------------------------------


def merge_windows(windows) -> dict:
    """Merge raw histogram windows (``{"count","total","min","max",
    "samples"}``) into one pooled window.  Associative and — because
    :func:`window_summary` sorts the pool before picking percentiles —
    order-independent in every derived statistic."""
    merged = {
        "count": 0, "total": 0.0,
        "min": float("inf"), "max": float("-inf"), "samples": [],
    }
    for w in windows:
        if not w or not w.get("count"):
            continue
        merged["count"] += int(w["count"])
        merged["total"] += float(w["total"])
        merged["min"] = min(merged["min"], float(w["min"]))
        merged["max"] = max(merged["max"], float(w["max"]))
        merged["samples"].extend(float(s) for s in w.get("samples", ()))
    return merged


def window_summary(window: dict) -> dict:
    """``{count, mean, min, max, p50, p90, p99}`` of a (merged) window —
    percentiles picked from the SORTED pooled samples with the same index
    rule as :class:`~.trace._Hist`, so a fleet of one member summarizes
    exactly like the member itself."""
    count = int(window.get("count", 0))
    if not count:
        return {"count": 0}
    s = sorted(window.get("samples", ()))
    if not s:  # counts without samples (window evicted): totals only
        return {
            "count": count,
            "mean": window["total"] / count,
            "min": window["min"],
            "max": window["max"],
        }
    pick = lambda q: s[min(len(s) - 1, int(q * len(s)))]  # noqa: E731
    return {
        "count": count,
        "mean": window["total"] / count,
        "min": window["min"],
        "max": window["max"],
        "p50": pick(0.50),
        "p90": pick(0.90),
        "p99": pick(0.99),
    }


def merge_slo(summaries) -> dict:
    """Fleet error-budget burn from POOLED windows: violation counts and
    request counts sum across members; burn = pooled violation rate /
    budget.  (Averaging per-member burn rates would weight an idle member
    equal to a loaded one.)"""
    count = violations = t_req = t_viol = 0
    slo_ms = budget = None
    for s in summaries:
        if not isinstance(s, dict):
            continue
        w = s.get("window", {})
        count += int(w.get("count", 0))
        violations += int(w.get("violations", 0))
        t = s.get("total", {})
        t_req += int(t.get("requests", 0))
        t_viol += int(t.get("violations", 0))
        slo_ms = s.get("slo_ms", slo_ms)
        budget = s.get("budget", budget)
    rate = violations / count if count else 0.0
    out = {
        "slo_ms": slo_ms,
        "budget": budget,
        "window": {"count": count, "violations": violations,
                   "violation_rate": round(rate, 6)},
        "total": {"requests": t_req, "violations": t_viol},
    }
    if budget:
        out["window"]["burn_rate"] = round(rate / budget, 4)
    return out


def align_events(events, offset_us: float, member: str) -> list:
    """Member flight events re-stamped onto the collector timeline:
    ``ts`` (and nothing else) shifts by ``-offset_us``; the member's own
    stamp is preserved as ``ts_member`` and every event is tagged with
    the member key.  Metadata events (no ts) pass through tagged."""
    out = []
    for ev in events:
        ev = dict(ev)
        ev["member"] = member
        if isinstance(ev.get("ts"), (int, float)):
            ev["ts_member"] = ev["ts"]
            ev["ts"] = ev["ts"] - offset_us
        out.append(ev)
    return out


def _member_key(endpoint) -> str:
    return f"{endpoint[0]}:{endpoint[1]}"


# -- the collector ------------------------------------------------------------


class FleetCollector:
    """Scrape every registered fleet member's obs agent on an interval
    and merge the results into one fleet view (see module docstring).

    Passive by default — :meth:`scrape_once` is directly callable (tests,
    tools); :meth:`start` runs it on ``interval_s`` in a daemon thread.
    Every scrape failure is absorbed: a dead member degrades the fleet
    (``obs_member_lost``, ``/healthz`` says so), it never crashes the
    collector or the serving path."""

    def __init__(
        self,
        endpoints=None,
        *,
        label: str = "fleet",
        interval_s: float | None = None,
        incident_dir: str | None = None,
        window_s: float | None = None,
        timeout: float = 10.0,
    ):
        self.label = label
        self.interval_s = (
            interval_s
            if interval_s is not None
            else _env_float(OBS_INTERVAL_ENV, DEFAULT_INTERVAL_S)
        )
        self.window_s = (
            window_s
            if window_s is not None
            else _env_float(OBS_WINDOW_ENV, DEFAULT_WINDOW_S)
        )
        self.incident_dir = (
            incident_dir
            if incident_dir is not None
            else (os.environ.get(OBS_DIR_ENV, "").strip() or None)
        )
        self.timeout = float(timeout)
        self._lock = threading.RLock()
        self._members: dict[str, dict] = {}
        self._last: dict | None = None
        self._incident_counts: dict[str, int] = {}
        self.incident_paths: list[str] = []
        self.scrapes = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        for ep in endpoints or ():
            self.register(ep)

    # -- membership -----------------------------------------------------------

    def register(self, endpoint, *, rank: int | None = None) -> None:
        """Admit (or RE-admit) a member.  A known endpoint is revived in
        place; if its process was replaced (new pid on the next scrape),
        the dead incarnation's last counters are folded into a carry so
        the fleet sums stay monotone across the restart."""
        if isinstance(endpoint, str):
            host, _, port = endpoint.rpartition(":")
            endpoint = (host or "127.0.0.1", int(port))
        endpoint = (str(endpoint[0]), int(endpoint[1]))
        key = _member_key(endpoint)
        with self._lock:
            m = self._members.get(key)
            if m is not None:
                if not m["alive"]:
                    m["alive"] = True
                    m["client"] = None
                    trace.instant("obs.member_readmit", member=key)
                if rank is not None:
                    m["rank"] = rank
                return
            self._members[key] = {
                "endpoint": endpoint,
                "rank": rank,
                "client": None,
                "alive": True,
                "pid": None,
                "offset_us": None,
                "rtt_us": None,
                "last": None,       # last scraped payload (retained at death)
                "carry": {},        # counters of dead prior incarnations
                "carry_faults": {},
                "prev_faults": {},  # fault ledger at the previous scrape
                "scrapes": 0,
                "failures": 0,
                "last_scrape_unix": None,
            }
        trace.instant("obs.member_register", member=key, rank=rank)

    def members(self) -> dict:
        with self._lock:
            return self.members_locked()

    def _client(self, m):
        from . import wire

        if m["client"] is None:
            m["client"] = wire.WireClient(
                m["endpoint"][0], m["endpoint"][1], timeout=self.timeout
            )
            sync = m["client"].clock_sync(samples=3)
            if sync is not None:
                m["offset_us"] = sync["offset_us"]
                m["rtt_us"] = sync["rtt_us"]
        return m["client"]

    def _mark_lost(self, m, key: str, why: str) -> None:
        if not m["alive"]:
            return
        m["alive"] = False
        try:
            if m["client"] is not None:
                m["client"].close()
        finally:
            m["client"] = None
        counters.record(
            "obs_member_lost", f"{self.label}: {key}: {why}"
        )

    # -- scraping -------------------------------------------------------------

    def _scrape_member(self, key: str, m: dict):
        """One member's snapshot, or None (dead member, counted).  Never
        raises."""
        from . import wire

        try:
            client = self._client(m)
            payload = client.obs_snapshot()
            if payload is None:  # pre-obs member: degrade, stay alive
                m["failures"] += 1
                return None
            if (
                m["pid"] is not None
                and payload.get("pid") != m["pid"]
                and m["last"] is not None
            ):
                # A reformed survivor took this endpoint over: fold the
                # dead incarnation's counters into the carry so fleet
                # sums never step backwards.
                stz = m["last"].get("statusz", {})
                for name, v in (stz.get("counters") or {}).items():
                    m["carry"][name] = m["carry"].get(name, 0) + v
                for name, v in (stz.get("faults") or {}).items():
                    m["carry_faults"][name] = (
                        m["carry_faults"].get(name, 0) + v
                    )
                m["prev_faults"] = {}
                m["offset_us"] = None
                client.close()
                m["client"] = None
                self._client(m)  # re-sync the new incarnation's clock
            m["pid"] = payload.get("pid")
            m["last"] = payload
            m["alive"] = True
            m["scrapes"] += 1
            m["last_scrape_unix"] = time.time()
            return payload
        except (OSError, TimeoutError, wire.WireError) as e:
            m["failures"] += 1
            self._mark_lost(m, key, f"{type(e).__name__}: {e}")
            return None
        except Exception as e:  # noqa: BLE001 — never a collector crash
            m["failures"] += 1
            _logger.exception("obs scrape of %s failed", key)
            self._mark_lost(m, key, f"{type(e).__name__}: {e}")
            return None

    def scrape_once(self) -> dict:
        """Scrape every member, merge, detect incidents.  Returns (and
        retains) the merged fleet snapshot."""
        triggers: list = []
        with self._lock:
            items = list(self._members.items())
            for key, m in items:
                was_alive = m["alive"]
                payload = self._scrape_member(key, m)
                if payload is None:
                    if was_alive and not m["alive"]:
                        # A loss edge fires once: it goes ahead of any
                        # fault motion seen in the same pass.
                        triggers.insert(
                            0, ("obs_member_lost", key, "member unreachable")
                        )
                    continue
                # Postmortem-family fault motion IN the member triggers
                # fleet-wide incident capture.  The first scrape only
                # seeds the baseline — a fault that predates this
                # collector is not this collector's incident.  A member in
                # the collector's own process shares its fault ledger, so
                # the collector's own ``obs_member_lost`` count shows up
                # there: that echo is the loss already captured above, not
                # the member's incident.
                faults = (
                    payload.get("statusz", {}).get("faults") or {}
                )
                prev = m["prev_faults"]
                echo = payload.get("pid") == os.getpid()
                for kind, total in faults.items():
                    if (
                        m["scrapes"] > 1
                        and self._postmortem_kind(kind)
                        and total > prev.get(kind, 0)
                        and not (echo and kind == "obs_member_lost")
                    ):
                        triggers.append(
                            (kind, key, f"{kind} {prev.get(kind, 0)} -> "
                             f"{total}")
                        )
                m["prev_faults"] = dict(faults)
            self.scrapes += 1
            merged = self._merge_locked()
            self._last = merged
        for kind, key, detail in triggers[:1]:  # one bundle per pass
            self.capture_incident(kind, member=key, detail=detail)
        return merged

    @staticmethod
    def _postmortem_kind(kind: str) -> bool:
        from . import telemetry

        return kind in telemetry.POSTMORTEM_KINDS

    def _merge_locked(self) -> dict:
        """The fleet-level merge of every member's last payload (callers
        hold the lock).  Dead members contribute their retained last
        snapshot — the fleet view stays monotone through a loss."""
        counters_sum: dict = {}
        faults_sum: dict = {}
        gauges: dict = {}
        windows: dict = {}
        slo_parts: dict = {}
        member_statusz: dict = {}
        alive = lost = 0
        for key, m in self._members.items():
            alive += 1 if m["alive"] else 0
            lost += 0 if m["alive"] else 1
            for name, v in m["carry"].items():
                counters_sum[name] = counters_sum.get(name, 0) + v
            for name, v in m["carry_faults"].items():
                faults_sum[name] = faults_sum.get(name, 0) + v
            payload = m["last"]
            if payload is None:
                continue
            stz = payload.get("statusz", {})
            member_statusz[key] = stz
            for name, v in (stz.get("counters") or {}).items():
                counters_sum[name] = counters_sum.get(name, 0) + v
            for name, v in (stz.get("faults") or {}).items():
                faults_sum[name] = faults_sum.get(name, 0) + v
            for name, v in (stz.get("gauges") or {}).items():
                gauges.setdefault(name, {})[key] = v
            for name, w in (payload.get("hist_windows") or {}).items():
                windows.setdefault(name, []).append(w)
            for lbl, s in (stz.get("slo") or {}).items():
                slo_parts.setdefault(lbl, []).append(s)
        merged_windows = {
            name: merge_windows(ws) for name, ws in windows.items()
        }
        return {
            "schema": FLEET_STATUSZ_SCHEMA,
            "label": self.label,
            "time_unix": time.time(),
            "collector_pid": os.getpid(),
            "scrapes": self.scrapes,
            "members": self.members_locked(),
            "alive": alive,
            "lost": lost,
            "degraded": lost > 0,
            "counters": counters_sum,
            "faults": faults_sum,
            "gauges": gauges,
            "histograms": {
                name: window_summary(w) for name, w in merged_windows.items()
            },
            "hist_windows": merged_windows,
            "slo": {
                lbl: merge_slo(parts) for lbl, parts in slo_parts.items()
            },
            "member_statusz": member_statusz,
        }

    def members_locked(self) -> dict:
        return {
            k: {
                "endpoint": list(m["endpoint"]),
                "rank": m["rank"],
                "alive": m["alive"],
                "pid": m["pid"],
                "offset_us": m["offset_us"],
                "rtt_us": m["rtt_us"],
                "scrapes": m["scrapes"],
                "failures": m["failures"],
                "last_scrape_unix": m["last_scrape_unix"],
            }
            for k, m in self._members.items()
        }

    # -- the fleet surface ----------------------------------------------------

    def fleet_statusz(self, *, include_members: bool = True) -> dict:
        """The last merged fleet snapshot (scraping once if none exists).
        ``include_members=False`` drops the per-member statusz bodies
        (the summary tables keep only the merged view)."""
        with self._lock:
            snap = self._last
        if snap is None:
            snap = self.scrape_once()
        if not include_members:
            snap = {k: v for k, v in snap.items() if k != "member_statusz"}
        return snap

    def fleet_healthz(self) -> dict:
        """Liveness verdict: ``ok`` while any member answers; a dead
        member degrades the fleet, it does not fail the probe."""
        with self._lock:
            total = len(self._members)
            alive = sum(1 for m in self._members.values() if m["alive"])
        return {
            "ok": alive > 0,
            "degraded": alive < total,
            "alive": alive,
            "members": total,
        }

    def fleet_prometheus(self) -> str:
        """The fleet exposition: per-member counters/gauges as
        ``host=``/``rank=``-labeled series (one ``# TYPE`` line per
        metric, one sample per member), plus fleet-level aggregates
        (``keystone_fleet_*``): summed counters, pooled-window histogram
        summaries, and membership gauges."""
        from . import telemetry

        snap = self.fleet_statusz()
        lines: list[str] = []
        with self._lock:
            members = [
                (k, m["rank"], m["last"]) for k, m in self._members.items()
            ]
        # per-member series, grouped per metric so TYPE renders once
        per_counter: dict = {}
        per_gauge: dict = {}
        for key, rank, payload in members:
            if payload is None:
                continue
            stz = payload.get("statusz", {})
            for name, v in (stz.get("counters") or {}).items():
                per_counter.setdefault(name, []).append((key, rank, v))
            for name, v in (stz.get("gauges") or {}).items():
                per_gauge.setdefault(name, []).append((key, rank, v))
        for name in sorted(per_counter):
            m = telemetry._metric_name(name)
            lines.append(f"# TYPE {m} counter")
            for key, rank, v in per_counter[name]:
                lbl = telemetry.render_labels({"host": key, "rank": rank})
                lines.append(f"{m}{lbl} {telemetry._fmt(v)}")
        for name in sorted(per_gauge):
            m = telemetry._metric_name(name)
            lines.append(f"# TYPE {m} gauge")
            for key, rank, v in per_gauge[name]:
                lbl = telemetry.render_labels({"host": key, "rank": rank})
                lines.append(f"{m}{lbl} {telemetry._fmt(v)}")
        # fleet aggregates
        for name in sorted(snap.get("counters", {})):
            m = telemetry._metric_name("fleet", name)
            lines.append(f"# TYPE {m} counter")
            lines.append(f"{m} {telemetry._fmt(snap['counters'][name])}")
        for name in sorted(snap.get("histograms", {})):
            h = snap["histograms"][name]
            m = telemetry._metric_name("fleet", name)
            lines.append(f"# TYPE {m} summary")
            for q in ("p50", "p90", "p99"):
                if q in h:
                    lines.append(
                        f'{m}{{quantile="0.{q[1:]}"}} '
                        f"{telemetry._fmt(h[q])}"
                    )
            count = h.get("count", 0)
            lines.append(
                f"{m}_sum {telemetry._fmt(h.get('mean', 0.0) * count)}"
            )
            lines.append(f"{m}_count {telemetry._fmt(count)}")
        hz = self.fleet_healthz()
        for gname, gval in (
            ("fleet_members", hz["members"]),
            ("fleet_members_alive", hz["alive"]),
            ("fleet_degraded", 1 if hz["degraded"] else 0),
        ):
            m = telemetry._metric_name(gname)
            lines.append(f"# TYPE {m} gauge")
            lines.append(f"{m} {telemetry._fmt(gval)}")
        return "\n".join(lines) + "\n"

    # -- incident capture -----------------------------------------------------

    def capture_incident(
        self, kind: str, *, member: str | None = None, detail: str = ""
    ) -> str | None:
        """Pull flight rings from every reachable member within the
        bounded window and write ONE clock-aligned incident bundle.
        Returns the written path, or None (no incident dir, cap reached,
        or an unwritable bundle — never raises)."""
        if not self.incident_dir:
            return None
        try:
            with self._lock:
                n = self._incident_counts.get(kind, 0)
                if n >= MAX_INCIDENTS_PER_KIND:
                    return None
                self._incident_counts[kind] = n + 1
                items = list(self._members.items())
            t0 = time.monotonic()
            deadline = t0 + max(0.5, self.window_s)
            events: list = []
            rings: dict = {}
            missing: list = []
            for key, m in items:
                if time.monotonic() >= deadline:
                    missing.append(key)
                    continue
                ring = self._pull_flight(key, m)
                if ring is None:
                    missing.append(key)
                    continue
                offset = m["offset_us"] or 0.0
                aligned = align_events(ring["flight"], offset, key)
                events.extend(aligned)
                rings[key] = {
                    "rank": m["rank"],
                    "pid": ring.get("pid"),
                    "offset_us": m["offset_us"],
                    "rtt_us": m["rtt_us"],
                    "events": len(aligned),
                }
            # The collector's OWN ring rides along (offset 0 by
            # definition — events are already on the collector clock).
            own = align_events(trace.flight_events(), 0.0, "collector")
            events.extend(own)
            rings["collector"] = {
                "rank": None, "pid": os.getpid(),
                "offset_us": 0.0, "rtt_us": 0.0, "events": len(own),
            }
            events.sort(
                key=lambda ev: ev.get("ts", float("-inf"))
                if isinstance(ev.get("ts"), (int, float)) else float("-inf")
            )
            bundle = {
                "schema": INCIDENT_SCHEMA,
                "time_unix": time.time(),
                "collector_pid": os.getpid(),
                "label": self.label,
                "trigger": {
                    "kind": kind, "member": member, "detail": detail[:500],
                },
                "window_s": self.window_s,
                "capture_wall_s": round(time.monotonic() - t0, 4),
                "members": rings,
                "missing": missing,
                "fleet": self.fleet_healthz(),
                "events": events,
            }
            os.makedirs(self.incident_dir, exist_ok=True)
            safe = "".join(
                c if c.isalnum() or c == "_" else "_" for c in kind
            )
            path = os.path.join(
                self.incident_dir, f"incident_{safe}_{os.getpid()}_{n}.json"
            )
            trace.atomic_write(path, lambda f: json.dump(bundle, f))
            with self._lock:
                self.incident_paths.append(path)
            counters.record(
                "obs_incident_captured",
                f"{kind}: {len(rings)} ring(s), {len(events)} event(s) "
                f"-> {path}",
            )
            _logger.warning("incident bundle -> %s (trigger %s)", path, kind)
            return path
        except Exception:  # noqa: BLE001 — never break the fault path
            _logger.exception("incident capture for %r failed", kind)
            return None

    def _pull_flight(self, key: str, m: dict):
        """One member's flight payload, or None.  Never raises; a member
        that cannot answer is simply missing from the bundle."""
        from . import wire

        try:
            client = self._client(m)
            return client.obs_flight()
        except (OSError, TimeoutError, wire.WireError) as e:
            self._mark_lost(m, key, f"flight pull: {type(e).__name__}: {e}")
            return None
        except Exception:  # noqa: BLE001
            _logger.exception("flight pull from %s failed", key)
            return None

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> "FleetCollector":
        """Run :meth:`scrape_once` every ``interval_s`` on a daemon
        thread.  Idempotent; a collector that was stopped starts scraping
        again."""
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="keystone-obs-collector", daemon=True
        )
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.scrape_once()
            except Exception:  # noqa: BLE001 — the collector must not die
                _logger.exception("fleet scrape failed")

    def stop(self) -> None:
        """Stop the scrape loop and WAIT for any in-flight scrape: after
        ``stop`` returns, no collector connection is mid-handshake (the
        drills compare connection counters and need that quiescence)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(max(30.0, self.interval_s + 5.0) + self.timeout)
            self._thread = None

    def close(self) -> None:
        self.stop()
        with self._lock:
            for m in self._members.values():
                if m["client"] is not None:
                    try:
                        m["client"].close()
                    except OSError:  # pragma: no cover
                        pass
                    m["client"] = None

    def __enter__(self) -> "FleetCollector":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def record(self) -> dict:
        with self._lock:
            return {
                "label": self.label,
                "interval_s": self.interval_s,
                "scrapes": self.scrapes,
                "members": self.members_locked(),
                "incidents": list(self.incident_paths),
            }
