"""The port's ``core.telemetry`` against the JAX package's, on the CPU: the
Prometheus text of one registry snapshot is equal, byte for byte, with and
without labels; ``statusz_snapshot`` has the same keys; the SLO tracker
windows, the postmortem dumps (under ``tmp_path``), the metrics file
writer, the HTTP endpoint on an ephemeral localhost port, and the
worker-process guard of the environment activation."""

import glob
import json
import os
import subprocess
import sys
import textwrap
import urllib.error
import urllib.request

import pytest

from keystone_tpu.core import resilience as jres
from keystone_tpu.core import telemetry as jtel
from keystone_tpu.core import trace as jtrace
from keystone_tpu_torch.core import resilience as pres
from keystone_tpu_torch.core import telemetry
from keystone_tpu_torch.core import trace

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_telemetry():
    telemetry._reset_state()
    trace.flight_reset()
    yield
    telemetry._reset_state()


def _snapshot(trace_mod, res_mod):
    m = trace_mod.Metrics()
    faults = res_mod.FaultCounters()
    m.adopt("faults", faults)
    m.inc("chunks_total", 3)
    m.gauge("ring.depth", 2.5)
    m.gauge("flag", True)
    for v in (1.0, 9.0, 4.0):
        m.observe("latency_ms", v)
    faults.record("io_retry", "probe")
    snap = m.snapshot()
    snap["slo"] = {"eng": {"label": "eng", "window": {"count": 2, "p99_ms": 3.5}}}
    return snap


@pytest.mark.parametrize("labels", [None, {"host": 'h"0', "rank": 1, "none": None}])
def test_prometheus_text_equals_jax(labels):
    port = telemetry.prometheus_text(_snapshot(trace, pres), labels=labels)
    ref = jtel.prometheus_text(_snapshot(jtrace, jres), labels=labels)
    assert port == ref
    assert "# TYPE keystone_chunks_total counter" in port
    assert "keystone_faults_io_retry" in port and "keystone_slo_eng_window_p99_ms" in port


def test_statusz_snapshot_keys_equal_jax():
    telemetry.register_statusz("probe", lambda: {"engines": 2})
    telemetry.register_statusz("sick", lambda: (_ for _ in ()).throw(RuntimeError("down")))
    port = telemetry.statusz_snapshot()
    ref = jtel.statusz_snapshot()
    assert set(port) == set(ref)
    assert set(port["numerics"]) == set(ref["numerics"])
    assert port["schema"] == "keystone.statusz/1"
    assert port["providers"]["probe"] == {"engines": 2}
    assert "RuntimeError" in port["providers"]["sick"]["error"]
    telemetry.unregister_statusz("probe", provider=lambda: None)  # not the owner: kept
    assert "probe" in telemetry.statusz_snapshot()["providers"]


def test_slo_windows_and_burn_rate_equal_jax():
    def drive(mod):
        clock = {"t": 100.0}
        t = mod.SLOTracker("eng", slo_ms=10.0, budget=0.1, window_s=3.0,
                           clock=lambda: clock["t"])
        for i, v in enumerate((1.0, 2.0, 50.0, 3.0, 4.0)):
            clock["t"] = 100.0 + i
            t.observe(v, ok=(i != 4))
        return t.summary()

    port, ref = drive(telemetry), drive(jtel)
    assert port == ref
    # the window kept the last four observations (t >= 101)
    assert port["window"]["count"] == 4
    assert port["window"]["violations"] == 2  # the 50 ms one and the error
    assert port["total"] == {"requests": 5, "errors": 1, "violations": 2, "burn_rate": 4.0}


def test_registered_tracker_rides_in_metrics_snapshot():
    t = telemetry.register_slo("snap_probe", slo_ms=5.0)
    t.observe(1.0)
    assert trace.metrics.snapshot()["slo"]["snap_probe"]["window"]["count"] == 1
    telemetry.unregister_slo("snap_probe")
    assert "snap_probe" not in trace.metrics.snapshot()["slo"]


def test_counted_fault_dumps_postmortem(tmp_path, monkeypatch):
    monkeypatch.setenv(telemetry.POSTMORTEM_DIR_ENV, str(tmp_path))
    assert not trace.enabled()
    with trace.span("doomed_phase", cat="probe"):
        pass
    pres.counters.record("deadline_exceeded", "probe: watchdog tripped")
    (path,) = glob.glob(str(tmp_path / "postmortem_deadline_exceeded_*.json"))
    doc = json.load(open(path))
    assert doc["schema"] == telemetry.POSTMORTEM_SCHEMA == jtel.POSTMORTEM_SCHEMA
    assert doc["fault"]["kind"] == "deadline_exceeded"
    names = [e.get("name") for e in doc["flight"]]
    assert "doomed_phase" in names and "fault" in names
    assert doc["metrics"]["faults"]["deadline_exceeded"] >= 1
    assert path in telemetry.postmortem_paths()
    assert telemetry.POSTMORTEM_KINDS == jtel.POSTMORTEM_KINDS


def test_postmortem_cap_and_kind_filter(tmp_path, monkeypatch):
    monkeypatch.setenv(telemetry.POSTMORTEM_DIR_ENV, str(tmp_path))
    for _ in range(telemetry.MAX_DUMPS_PER_KIND + 2):
        pres.counters.record("serve_burst_oom", "storm")
    assert len(glob.glob(str(tmp_path / "postmortem_serve_burst_oom_*"))) == (
        telemetry.MAX_DUMPS_PER_KIND
    )
    pres.counters.record("io_retry", "transient")
    assert glob.glob(str(tmp_path / "postmortem_io_retry_*")) == []
    monkeypatch.delenv(telemetry.POSTMORTEM_DIR_ENV)
    assert telemetry.maybe_postmortem("nonfinite_model", "no dir") is None


def test_metrics_writer_writes_atomically(tmp_path):
    path = str(tmp_path / "sub" / "m.prom")
    trace.metrics.inc("writer_probe_total", 2)
    w = telemetry.MetricsWriter(path, interval_s=0.05).start()
    try:
        assert "keystone_writer_probe_total" in open(path).read()
        trace.metrics.inc("writer_probe_total")
    finally:
        w.stop()
    assert not w._thread.is_alive()
    assert telemetry.prometheus_text().splitlines()[0] in open(path).read()
    assert not glob.glob(str(tmp_path / "sub" / "*.tmp*"))


def test_http_endpoint_serves_metrics_statusz_healthz():
    trace.metrics.inc("http_probe_total")
    server = telemetry.start_metrics_server(0)
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        assert "keystone_http_probe_total" in urllib.request.urlopen(
            base + "/metrics", timeout=10).read().decode()
        assert json.loads(urllib.request.urlopen(base + "/healthz", timeout=10).read()) == {
            "ok": True}
        doc = json.loads(urllib.request.urlopen(base + "/statusz", timeout=10).read())
        assert doc["schema"] == "keystone.statusz/1"
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(base + "/nope", timeout=10)
    finally:
        server.shutdown()


def test_telemetry_disabled_context():
    depth = trace.flight_depth()
    t = telemetry.SLOTracker("off", slo_ms=1.0)
    with telemetry.telemetry_disabled():
        assert trace.flight_depth() == 0
        t.observe(5.0)
    assert t.total_requests == 0
    assert trace.flight_depth() == depth


def test_env_activation_in_a_fresh_process(tmp_path):
    """``KEYSTONE_METRICS_FILE`` stands up the writer in a process that
    imports the port's resilience layer; a spawned worker of that process
    starts none."""
    path = str(tmp_path / "metrics.prom")
    script = textwrap.dedent(
        """
        import multiprocessing, time
        from keystone_tpu_torch.core import telemetry, trace
        from keystone_tpu_torch.core.resilience import counters

        def child(q):
            from keystone_tpu_torch.core import telemetry as t
            q.put(t._env_writer is None)

        if __name__ == "__main__":
            trace.metrics.inc("env_probe_total", 7)
            time.sleep(0.3)
            ctx = multiprocessing.get_context("spawn")
            q = ctx.Queue()
            p = ctx.Process(target=child, args=(q,))
            p.start()
            print("WORKER_QUIET", q.get(timeout=60))
            p.join(30)
            print("MAIN_WRITER", telemetry._env_writer is not None)
        """
    )
    script_path = tmp_path / "probe.py"
    script_path.write_text(script)
    env = {k: v for k, v in os.environ.items() if not k.startswith("KEYSTONE_")}
    env.update(KEYSTONE_METRICS_FILE=path, KEYSTONE_METRICS_INTERVAL_S="0.05",
               PYTHONPATH=_REPO)
    res = subprocess.run([sys.executable, str(script_path)], capture_output=True, text=True,
                         timeout=120, env=env, cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr[-2000:]
    assert "WORKER_QUIET True" in res.stdout and "MAIN_WRITER True" in res.stdout
    assert "keystone_env_probe_total 7" in open(path).read()
