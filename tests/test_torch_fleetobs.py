"""The port's fleet observability plane (``keystone_tpu_torch.core.fleetobs``)
against ``keystone_tpu.core.fleetobs`` on the CPU.

* The merge math: associative and order-independent, fleet percentiles
  from POOLED raw windows (held to a numpy oracle), SLO burn from pooled
  counts, clock alignment onto one monotone timeline under injected
  member-clock skew — and the same seeded windows and events give exactly
  the reference's numbers.
* The agent payload rides the serving socket; the collector sums counters,
  degrades (never crashes) on member death with the fleet view monotone,
  writes ONE schema-tagged incident bundle, caps bundles per kind;
  ``HostFleet.attach_collector`` registers and re-admits members.
* Across packages on localhost: a JAX ``WireClient`` scrapes a port
  ``WireServer``, the port's collector scrapes a JAX member,
  ``tools/fleet_view.py`` scrapes port members and renders a port bundle.
* The end-to-end drill (``dist`` marker): 2 real ``serve-host`` members
  over sockets, one SIGKILLed mid-scrape, serving bit-equal."""

import json
import os
import sys
import time

import numpy as np
import pytest
import torch

from keystone_tpu.core import fleetobs as jfleetobs
from keystone_tpu.core import trace as jtrace
from keystone_tpu.core import wire as jwire
from keystone_tpu_torch.core import fleetobs, telemetry, trace, wire
from keystone_tpu_torch.core import frontend as kfrontend
from keystone_tpu_torch.core.resilience import counters
from keystone_tpu_torch.workloads import multihost
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools"))
import fleet_view  # noqa: E402  (tools/fleet_view.py)


def _window(rng, n):
    samples = np.abs(rng.normal(2.0, 1.0, size=n)).tolist()
    return {
        "count": n,
        "total": float(sum(samples)),
        "min": float(min(samples)),
        "max": float(max(samples)),
        "samples": samples,
    }


def _endpoint(port):
    return ("127.0.0.1", port)


# -- merge math ----------------------------------------------------------------


class TestMergeMath:
    def test_merge_is_associative(self, rng):
        ws = [_window(rng, n) for n in (5, 9, 17, 3)]
        left = fleetobs.merge_windows(
            [fleetobs.merge_windows(ws[:2]), fleetobs.merge_windows(ws[2:])])
        flat = fleetobs.merge_windows(ws)
        assert fleetobs.window_summary(left) == fleetobs.window_summary(flat)
        assert left["count"] == flat["count"]
        assert left["min"] == flat["min"] and left["max"] == flat["max"]

    def test_merge_is_order_independent(self, rng):
        ws = [_window(rng, n) for n in (8, 4, 12)]
        fwd = fleetobs.window_summary(fleetobs.merge_windows(ws))
        rev = fleetobs.window_summary(fleetobs.merge_windows(ws[::-1]))
        # percentiles/extrema/count are exactly order-free; the mean's
        # float summation order differs by at most an ulp
        assert fwd.pop("mean") == pytest.approx(rev.pop("mean"))
        assert fwd == rev

    def test_single_member_fleet_summarizes_like_the_member(self, rng):
        """A fleet of one reports exactly what the one reports — the pick
        rule over the pooled (= its own) sorted samples."""
        w = _window(rng, 21)
        s = fleetobs.window_summary(fleetobs.merge_windows([w]))
        m = trace._Hist()
        for x in w["samples"]:
            m.observe(x)
        assert s["p99"] == m.summary()["p99"]
        assert s["p50"] == m.summary()["p50"]
        assert s["count"] == m.summary()["count"]

    def test_fleet_p99_matches_pooled_numpy_oracle(self, rng):
        """Fleet p99 from merged windows against a pooled-sample numpy
        oracle — pooling is exact; AVERAGING the per-member p99s (the
        anti-pattern) is measurably wrong on skewed members."""
        slow = _window(rng, 40)
        slow["samples"] = (np.asarray(slow["samples"]) * 50.0).tolist()
        slow["total"] = float(sum(slow["samples"]))
        slow["min"], slow["max"] = min(slow["samples"]), max(slow["samples"])
        members = [_window(rng, 40), _window(rng, 40), slow]
        fleet_p99 = fleetobs.window_summary(fleetobs.merge_windows(members))["p99"]
        pool = np.sort(np.concatenate([m["samples"] for m in members]))
        assert fleet_p99 == pool[min(len(pool) - 1, int(0.99 * len(pool)))]
        oracle = float(np.percentile(pool, 99))
        assert abs(fleet_p99 - oracle) <= 0.25 * abs(oracle)
        averaged = float(np.mean([fleetobs.window_summary(m)["p99"] for m in members]))
        assert abs(averaged - oracle) > abs(fleet_p99 - oracle)

    def test_empty_and_sampleless_windows(self):
        assert fleetobs.window_summary(fleetobs.merge_windows([])) == {"count": 0}
        no_samples = {"count": 4, "total": 8.0, "min": 1.0, "max": 3.0, "samples": []}
        s = fleetobs.window_summary(fleetobs.merge_windows([no_samples]))
        assert s == {"count": 4, "mean": 2.0, "min": 1.0, "max": 3.0}

    def test_slo_burn_pools_counts_not_rates(self):
        """Fleet burn = pooled violations / pooled count / budget: a loaded
        member outweighs an idle one."""
        busy = {"slo_ms": 50.0, "budget": 0.01, "window": {"count": 900, "violations": 0},
                "total": {"requests": 900, "violations": 0}}
        idle = {"slo_ms": 50.0, "budget": 0.01, "window": {"count": 100, "violations": 10},
                "total": {"requests": 100, "violations": 10}}
        m = fleetobs.merge_slo([busy, idle])
        assert m["window"]["count"] == 1000
        assert m["window"]["violations"] == 10
        assert m["window"]["burn_rate"] == 1.0  # 1% rate / 1% budget
        assert m["total"]["requests"] == 1000


# -- the reference's numbers ---------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_math_equals_the_reference(seed):
    """The same seeded windows, SLO parts and skewed events through both
    packages: merged windows, summaries, burn and aligned events equal."""
    rng = np.random.default_rng(seed)
    ws = [_window(rng, int(n)) for n in rng.integers(1, 60, size=5)]
    ws.append({"count": 3, "total": 6.0, "min": 1.0, "max": 3.0, "samples": []})
    ws.append({})
    for parts in (ws, ws[::-1], ws[:2]):
        mine, ref = fleetobs.merge_windows(parts), jfleetobs.merge_windows(parts)
        assert mine == ref
        assert fleetobs.window_summary(mine) == jfleetobs.window_summary(ref)
    slos = [{"slo_ms": 25.0, "budget": float(rng.uniform(0.001, 0.05)),
             "window": {"count": int(c), "violations": int(v)},
             "total": {"requests": int(c) * 3, "violations": int(v) * 2}}
            for c, v in zip(rng.integers(1, 500, 4), rng.integers(0, 20, 4))]
    assert fleetobs.merge_slo(slos + [None]) == jfleetobs.merge_slo(slos + [None])
    events = [{"name": f"e{i}", "ph": "i", "ts": float(t)}
              for i, t in enumerate(rng.uniform(0, 1e6, 12))]
    events.append({"ph": "M", "name": "process_name"})
    offset = float(rng.uniform(-2e5, 2e5))
    assert fleetobs.align_events(events, offset, "h1") == jfleetobs.align_events(
        events, offset, "h1")


def test_schemas_knobs_and_cap_match_the_reference():
    for name in ("OBS_SCHEMA", "FLEET_STATUSZ_SCHEMA", "INCIDENT_SCHEMA", "OBS_INTERVAL_ENV",
                 "OBS_DIR_ENV", "OBS_WINDOW_ENV", "DEFAULT_INTERVAL_S", "DEFAULT_WINDOW_S",
                 "MAX_INCIDENTS_PER_KIND"):
        assert getattr(fleetobs, name) == getattr(jfleetobs, name), name
    public = {n for n in dir(jfleetobs) if not n.startswith("_")}
    assert public - {"annotations"} <= set(dir(fleetobs))


# -- clock alignment -----------------------------------------------------------


class TestClockAlignment:
    def test_skewed_members_land_on_one_monotone_timeline(self, rng):
        """Events that happened in a known TRUE order on members whose
        clocks are skewed by injected offsets come out monotone (the true
        order) after alignment."""
        true_ts = np.sort(rng.uniform(0, 1e6, size=30))
        skews = {"a": 250_000.0, "b": -125_000.0, "c": 0.0}
        owners = [list(skews)[i % 3] for i in range(30)]
        aligned = []
        for member, skew in skews.items():
            evs = [{"name": f"e{i}", "ph": "i", "ts": float(t + skew)}
                   for i, t in enumerate(true_ts) if owners[i] == member]
            # offset_us = member_clock - collector_clock = skew
            aligned.extend(fleetobs.align_events(evs, skew, member))
        aligned.sort(key=lambda e: e["ts"])
        out_ts = [e["ts"] for e in aligned]
        assert out_ts == sorted(out_ts)
        np.testing.assert_allclose(out_ts, true_ts, atol=1e-6)
        assert all("ts_member" in e and "member" in e for e in aligned)

    def test_metadata_events_pass_through_tagged(self):
        out = fleetobs.align_events([{"ph": "M", "name": "process_name"}], 1000.0, "h0")
        assert out == [{"ph": "M", "name": "process_name", "member": "h0"}]


# -- agent payload over the live wire socket -----------------------------------


class _Ready:
    def __init__(self, v):
        self._v = v

    def result(self, timeout=None):
        return self._v


class _Doubler:
    def submit(self, arr):
        return _Ready(np.asarray(arr) * 2.0)

    def record(self):
        return {}


class TestAgentAndCollector:
    def test_agent_payload_schema(self):
        trace.metrics.observe("fo_lat_ms", 3.0)
        p = fleetobs.agent_payload()
        assert p["schema"] == fleetobs.OBS_SCHEMA
        assert p["pid"] == os.getpid()
        assert p["statusz"]["schema"].startswith("keystone.statusz/")
        assert "fo_lat_ms" in p["hist_windows"]
        assert p["hist_windows"]["fo_lat_ms"]["samples"] == [3.0]
        f = fleetobs.agent_payload("flight")
        assert "flight" in f and "statusz" not in f

    def test_payload_is_json_clean(self):
        json.dumps(fleetobs.agent_payload())
        json.dumps(fleetobs.agent_payload("flight"))

    def test_collector_sums_counters_and_pools_histograms(self):
        trace.metrics.inc("fo_widgets", 5)
        trace.metrics.observe("fo_pool_ms", 1.0)
        trace.metrics.observe("fo_pool_ms", 9.0)
        with fleetobs.ObsAgent(label="t1") as a1, fleetobs.ObsAgent(label="t2") as a2:
            col = fleetobs.FleetCollector([_endpoint(a1.port), _endpoint(a2.port)],
                                          interval_s=30.0, label="t")
            with col:
                snap = col.scrape_once()
                assert snap["schema"] == fleetobs.FLEET_STATUSZ_SCHEMA
                assert snap["alive"] == 2 and snap["lost"] == 0
                # both members are THIS process: fleet sum is exactly 2x
                assert snap["counters"]["fo_widgets"] == 10
                h = snap["histograms"]["fo_pool_ms"]
                assert h["count"] == 4 and h["max"] == 9.0
                prom = col.fleet_prometheus()
                assert f'keystone_fo_widgets{{host="127.0.0.1:{a1.port}"}} 5' in prom
                assert "keystone_fleet_fo_widgets 10" in prom
                assert "keystone_fleet_members_alive 2" in prom
                assert col.fleet_healthz() == {
                    "ok": True, "degraded": False, "alive": 2, "members": 2}

    def test_member_death_degrades_counted_and_stays_monotone(self, tmp_path):
        """A dead member: counted ``obs_member_lost`` (postmortem family),
        fleet DEGRADED not crashed, its last-known counters retained so the
        fleet totals never step backwards."""
        a1 = fleetobs.ObsAgent(label="m1")
        a2 = fleetobs.ObsAgent(label="m2")
        col = fleetobs.FleetCollector([_endpoint(a1.port), _endpoint(a2.port)],
                                      interval_s=30.0, label="t", incident_dir=str(tmp_path))
        try:
            before_snap = col.scrape_once()
            before = counters.get("obs_member_lost")
            a2.close()
            after_snap = col.scrape_once()  # must NOT raise
            assert counters.get("obs_member_lost") == before + 1
            assert after_snap["lost"] == 1 and after_snap["degraded"]
            hz = col.fleet_healthz()
            assert hz["ok"] and hz["degraded"]
            for k, v in before_snap["counters"].items():
                assert after_snap["counters"].get(k, 0) >= v, k
            # the loss itself produced ONE incident bundle
            assert len(col.incident_paths) == 1
            with open(col.incident_paths[0]) as fh:
                doc = json.load(fh)
            assert doc["schema"] == fleetobs.INCIDENT_SCHEMA
            assert doc["trigger"]["kind"] == "obs_member_lost"
            assert f"127.0.0.1:{a1.port}" in doc["members"]
            ts = [e["ts"] for e in doc["events"] if isinstance(e.get("ts"), (int, float))]
            assert ts == sorted(ts)
            # re-scraping the dead member keeps degrading quietly: no new
            # count (the alive->dead edge fired once), never a raise
            col.scrape_once()
            assert counters.get("obs_member_lost") == before + 1
        finally:
            col.close()
            a1.close()
            a2.close()

    def test_incident_bundles_are_capped_per_kind(self, tmp_path):
        with fleetobs.ObsAgent(label="cap") as a:
            col = fleetobs.FleetCollector([_endpoint(a.port)], interval_s=30.0,
                                          incident_dir=str(tmp_path), label="cap")
            with col:
                col.scrape_once()
                paths = [col.capture_incident("demo_cap", detail=f"n{i}")
                         for i in range(fleetobs.MAX_INCIDENTS_PER_KIND + 2)]
                assert len([p for p in paths if p]) == fleetobs.MAX_INCIDENTS_PER_KIND

    def test_collector_without_incident_dir_never_writes(self):
        with fleetobs.ObsAgent(label="nodir") as a:
            col = fleetobs.FleetCollector([_endpoint(a.port)], interval_s=30.0, label="nodir")
            with col:
                col.scrape_once()
                assert col.capture_incident("demo_nodir") is None
                assert col.incident_paths == []

    def test_register_readmits_known_endpoint(self):
        with fleetobs.ObsAgent(label="readmit") as a:
            col = fleetobs.FleetCollector(interval_s=30.0, label="r")
            with col:
                col.register(_endpoint(a.port), rank=0)
                col.scrape_once()
                key = f"127.0.0.1:{a.port}"
                col._members[key]["alive"] = False  # simulate a loss
                col.register(_endpoint(a.port))
                assert col.members()[key]["alive"]
                assert len(col.members()) == 1  # revived, not duplicated

    def test_obs_frames_live_on_the_serving_socket(self):
        """The serving endpoint IS the obs endpoint: one WireServer answers
        predict AND obs frames."""
        with wire.WireServer(_Doubler(), port=0, label="obs_serve") as s:
            with wire.WireClient("127.0.0.1", s.port, timeout=10.0) as c:
                np.testing.assert_array_equal(np.asarray(c.predict(np.ones(4, np.float32))),
                                              np.full(4, 2.0, np.float32))
                assert c.obs_snapshot()["pid"] == os.getpid()
                assert isinstance(c.obs_flight()["flight"], list)


def test_collector_restarts_after_stop():
    """``start`` after ``stop`` scrapes again on the cadence."""
    with fleetobs.ObsAgent(label="restart") as a:
        with fleetobs.FleetCollector([_endpoint(a.port)], interval_s=0.02, label="rs") as col:
            for _ in range(2):
                seen = col.scrapes
                col.start()
                deadline = time.monotonic() + 10.0
                while col.scrapes <= seen and time.monotonic() < deadline:
                    time.sleep(0.01)
                col.stop()
                assert col.scrapes > seen


# -- HostFleet wiring ----------------------------------------------------------


def test_hostfleet_attach_collector_registers_and_readmits():
    with fleetobs.ObsAgent(label="fa") as a1, fleetobs.ObsAgent(label="fb") as a2:
        eps = [_endpoint(a1.port), _endpoint(a2.port)]
        col = fleetobs.FleetCollector(interval_s=30.0, label="hf")
        with col, kfrontend.HostFleet(eps, label="obs_hf") as fleet:
            fleet.attach_collector(col)
            assert set(col.members()) == {f"127.0.0.1:{a1.port}", f"127.0.0.1:{a2.port}"}
            assert [m["rank"] for m in col.members().values()] == [0, 1]
            col._members[f"127.0.0.1:{a2.port}"]["alive"] = False
            fleet.reattach(_endpoint(a2.port))
            assert col.members()[f"127.0.0.1:{a2.port}"]["alive"]
            with fleetobs.ObsAgent(label="fc") as a3:
                fleet.reattach(_endpoint(a3.port))
                assert col.members()[f"127.0.0.1:{a3.port}"]["rank"] == 2


# -- across packages -----------------------------------------------------------


def test_reference_client_scrapes_a_port_member():
    trace.metrics.inc("fo_cross_port", 2)
    with wire.WireServer(_Doubler(), port=0, label="obs_cross") as s:
        with jwire.WireClient("127.0.0.1", s.port, timeout=10.0) as c:
            snap = c.obs_snapshot()
            assert snap["schema"] == "keystone.obs/1" == jfleetobs.OBS_SCHEMA
            assert snap["statusz"]["counters"]["fo_cross_port"] >= 2
            assert isinstance(c.obs_flight()["flight"], list)
            assert c.clock_sync(samples=2) is not None


def test_port_collector_scrapes_a_reference_member():
    jtrace.metrics.inc("fo_cross_jax", 4)
    with jfleetobs.ObsAgent(label="jx") as a:
        with fleetobs.FleetCollector([_endpoint(a.port), f"127.0.0.1:{a.port}"],
                                     interval_s=30.0, label="x") as col:
            snap = col.scrape_once()
            assert snap["alive"] == 1  # one endpoint (tuple or string), one member
            assert snap["counters"]["fo_cross_jax"] == jtrace.metrics.get("fo_cross_jax")
            assert col.members()[f"127.0.0.1:{a.port}"]["offset_us"] is not None


def test_fleet_view_scrapes_port_members():
    trace.metrics.inc("fo_view_widgets", 3)
    with fleetobs.ObsAgent(label="v1") as a1, fleetobs.ObsAgent(label="v2") as a2:
        snap = fleet_view.scrape_endpoints(f"127.0.0.1:{a1.port},127.0.0.1:{a2.port}")
        assert snap["alive"] == 2
        assert snap["counters"]["fo_view_widgets"] == 2 * trace.metrics.get("fo_view_widgets")
        assert "fo_view_widgets" in fleet_view.render_fleet_statusz(snap)


def test_fleet_view_renders_a_port_bundle(tmp_path):
    trace.instant("fo_bundle_marker", n=1)
    with fleetobs.ObsAgent(label="b1") as a:
        with fleetobs.FleetCollector([_endpoint(a.port)], interval_s=30.0, label="b",
                                     incident_dir=str(tmp_path)) as col:
            col.scrape_once()
            path = col.capture_incident("demo_render", member=f"127.0.0.1:{a.port}",
                                        detail="rendered")
    with open(path) as fh:
        doc = json.load(fh)
    text = fleet_view.render_incident(doc)
    assert "incident keystone.incident/1" in text and "trigger=demo_render" in text
    assert f"127.0.0.1:{a.port}" in text and "fo_bundle_marker" in text
    assert fleet_view.main(["--incident", path]) == 0


# -- the end-to-end acceptance drill ------------------------------------------


@pytest.mark.dist
def test_obs_capture_drill_subprocess_acceptance(tmp_path):
    """2 REAL ``serve-host`` members over sockets with the collector
    attached — (a) fleet counters equal the sum of per-member snapshots,
    (b) fleet p99 from merged windows matches the pooled-sample oracle,
    (c) after one member is SIGKILLed mid-scrape, ONE incident bundle holds
    every surviving member's flight ring on a monotone clock-aligned
    timeline — and every request answers bit-equal to the offline oracle
    (zero dropped)."""
    with telemetry._pm_lock:
        telemetry._pm_counts.pop("obs_member_lost", None)
    rec = multihost.run_obs_capture_drill(str(tmp_path), hosts=2, requests=16,
                                          subprocess_mode=True, timeout_s=180.0, device="cpu")
    assert rec["counter_sum_ok"], rec.get("counter_sum_mismatch")
    assert rec["p99_match"], {k: rec.get(k)
                              for k in ("p99_fleet", "p99_oracle_pick", "p99_oracle_np")}
    assert rec["monotone_ok"], rec.get("monotone_violations")
    assert rec["obs_member_lost"] >= 1
    assert rec["dropped_requests"] == 0
    assert rec["mismatches"] == 0
    inc = rec["incident"]
    assert inc["schema"] == fleetobs.INCIDENT_SCHEMA
    assert inc["survivor_rings_ok"], inc
    assert inc["events_monotone"], inc
    assert rec["fleet_alive"] == 1 and rec["fleet_lost"] == 1
    assert any("obs_member_lost" in p for p in rec["postmortems"])
    assert rec["worker_rcs"][rec["kill_rank"]] != 0  # SIGKILLed, not shut down
    assert rec["kernel_launches"] == {"conv_rect_pool": 0, "fv_stats": 0, "decode_pixels": 0}


def test_drill_refuses_one_host_and_a_missing_card(tmp_path):
    with pytest.raises(ValueError, match="needs >= 2 hosts"):
        multihost.run_obs_capture_drill(str(tmp_path), hosts=1, device="cpu")
    if not torch.cuda.is_available():  # the drill defaults to the card, with no fallback
        with pytest.raises(RuntimeError):
            multihost.run_obs_capture_drill(str(tmp_path), subprocess_mode=False)


# -- labeled exposition rides the fleet renderer -------------------------------


def test_fleet_prometheus_uses_labeled_exposition():
    assert telemetry.render_labels({"host": "h0", "rank": 1}) == '{host="h0",rank="1"}'
