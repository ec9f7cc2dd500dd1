"""The port's ``core.trace`` and ``core.logging`` against the JAX package's
(keystone_tpu.core.trace / logging), on the CPU.

The same script of spans, instants and metrics runs through both packages:
the event lists are equal once timestamps, durations, pid and tid (and the
attributes derived from durations) are set aside, and the metrics
snapshots are equal.  Both export formats load with
``tools/trace_view.py``.  Each package's trace state is process-global, so
every test starts and ends with both disabled and reset; nothing here sets
``KEYSTONE_TRACE``."""

import gc
import os
import sys
import threading
import tracemalloc

import numpy as np
import pytest
import torch

from keystone_tpu.core import resilience as jres
from keystone_tpu.core import trace as jtrace
from keystone_tpu_torch.core import ingest
from keystone_tpu_torch.core import resilience as pres
from keystone_tpu_torch.core import trace as ptrace
from keystone_tpu_torch.core.logging import configure_logging, stage_timer
from keystone_tpu_torch.loaders import image_loaders
from test_stream_workloads import _write_cifar_tar

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))

import trace_view  # noqa: E402  (tools/trace_view.py)

#: Event keys and span attributes that carry clocks, processes or threads.
_VOLATILE = {"ts", "dur", "pid", "tid"}
_TIMED_ARGS = {"mb_per_s", "measured_s", "prediction_error", "sync_us"}


@pytest.fixture(autouse=True)
def _clean_trace():
    for mod in (ptrace, jtrace):
        mod.disable()
        mod.reset()
    yield
    for mod in (ptrace, jtrace):
        mod.disable()
        mod.reset()


def _normalized(events):
    out = []
    for ev in events:
        ev = {k: v for k, v in ev.items() if k not in _VOLATILE}
        if "args" in ev:
            ev["args"] = {k: v for k, v in ev["args"].items() if k not in _TIMED_ARGS}
        out.append(ev)
    return out


def _script(trace, resilience):
    """Spans (nested, failed, generator-closed, IO, plan), instants, a
    counted fault and a worker thread's span, through one package."""
    with trace.span("outer", cat="stage", rows=3):
        with trace.span("inner", bytes=12) as sp:
            sp.set(shape=[3, 4], dtype="float32")
        trace.instant("admit", decision="ok", n=2)
    with pytest.raises(ValueError):
        with trace.span("fails"):
            raise ValueError("boom")

    def gen():
        with trace.span("hosted"):
            yield 1

    g = gen()
    next(g)
    g.close()
    with trace.io_span("copy", 4096):
        pass
    with trace.plan_span("plan", predicted_seconds=0.5, predicted_bytes=8):
        pass
    worker = threading.Thread(target=lambda: trace.instant("from_worker", k=1), name="w1")
    worker.start()
    worker.join(10.0)
    resilience.FaultCounters().record("corrupt_image", "member.jpg")


def _metrics_script(trace, resilience):
    m = trace.Metrics()
    faults = resilience.FaultCounters()
    m.adopt("faults", faults)
    m.inc("chunks")
    m.inc("chunks", 4)
    m.gauge("ring_depth", 3.0)
    for v in (5.0, 1.0, 3.0, 2.0, 4.0):
        m.observe("latency_ms", v)
    faults.record("io_retry", "attempt 1/3")
    return m


def test_event_lists_equal_jax(tmp_path):
    paths = {}
    for name, trace, res in (("port", ptrace, pres), ("jax", jtrace, jres)):
        paths[name] = str(tmp_path / f"{name}.json")
        trace.enable(paths[name])
        _script(trace, res)
        trace.flush()
    port, ref = (trace_view.load_events(paths[k]) for k in ("port", "jax"))
    assert _normalized(port) == _normalized(ref)
    names = [e["name"] for e in port]
    for want in ("outer", "inner", "fails", "hosted", "copy", "plan", "admit", "fault"):
        assert want in names
    spans = {e["name"]: e for e in port if e["ph"] == "X"}
    assert spans["inner"]["args"]["parent"] == "outer"
    assert spans["fails"]["args"]["error"] == "ValueError"
    assert spans["hosted"]["args"]["aborted"] is True
    assert spans["copy"]["args"]["bytes"] == 4096


def test_metrics_snapshots_equal_jax():
    port = _metrics_script(ptrace, pres).snapshot()
    ref = _metrics_script(jtrace, jres).snapshot()
    assert port == ref
    assert port["counters"] == {"chunks": 5}
    assert port["faults"] == {"io_retry": 1}
    assert port["histograms"]["latency_ms"]["p50"] == 3.0


@pytest.mark.parametrize("suffix", [".json", ".jsonl"])
def test_both_formats_load_with_trace_view(tmp_path, suffix):
    path = str(tmp_path / f"t{suffix}")
    ptrace.enable(path)
    _script(ptrace, pres)
    assert ptrace.flush() == path
    events = trace_view.load_events(path)
    assert {e["name"] for e in trace_view.spans(events)} >= {"outer", "inner", "copy"}
    assert "outer" in trace_view.per_stage(events)
    assert "outer" in trace_view.summarize(path)


def test_disabled_path_is_the_null_singleton():
    assert not ptrace.enabled()
    ptrace.set_flight_depth(0)
    try:
        assert ptrace.span("a") is ptrace._NULL
        assert ptrace.io_span("b", 10) is ptrace._NULL
        assert ptrace.plan_span("c", 1.0) is ptrace._NULL
        with ptrace.span("a") as sp:
            assert sp.sync(5) == 5
    finally:
        ptrace.set_flight_depth(ptrace.DEFAULT_FLIGHT_DEPTH)
    assert ptrace.events() == [] and ptrace.flight_events() == []


def test_disabled_mode_no_allocation_growth():
    """With tracing off, memory retained by the trace module is constant
    once the flight ring is warm: the ring is bounded, and nothing lands in
    the trace buffer."""
    assert ptrace.flight_depth() > 0
    filters = [tracemalloc.Filter(True, ptrace.__file__)]
    tracemalloc.start()
    try:
        for _ in range(ptrace.flight_depth() + 200):
            with ptrace.span("warm", k=1):
                pass
            ptrace.instant("warm", n=1)
        gc.collect()
        before = tracemalloc.take_snapshot().filter_traces(filters)
        for _ in range(5000):
            with ptrace.span("hot"):
                pass
            ptrace.instant("hot", n=1)
        gc.collect()
        after = tracemalloc.take_snapshot().filter_traces(filters)
    finally:
        tracemalloc.stop()
    grown = sum(s.size for s in after.statistics("filename")) - sum(
        s.size for s in before.statistics("filename")
    )
    assert grown < 8192, grown
    assert ptrace.events() == []
    assert len(ptrace.flight_events()) <= ptrace.flight_depth()


def test_span_sync_waits_on_the_cuda_devices_of_its_value(monkeypatch, tmp_path):
    """``Span.sync`` synchronizes each CUDA device its value's tensors live
    on, once, and nothing for CPU values; it records ``sync_us``."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda index=None: calls.append(index))

    class OnCard:
        def __init__(self, index):
            self.device = torch.device("cuda", index)

    ptrace.enable(str(tmp_path / "t.json"))
    value = {"a": [OnCard(1), torch.zeros(2)], "b": (OnCard(0), OnCard(1))}
    with ptrace.span("synced") as sp:
        assert sp.sync(value) is value
    with ptrace.span("cpu") as sp:
        sp.sync(torch.ones(3))
    assert calls == [0, 1]
    spans = {e["name"]: e for e in ptrace.events() if e["ph"] == "X"}
    assert spans["synced"]["args"]["sync_us"] >= 0
    assert "sync_us" in spans["cpu"]["args"]


def test_stage_timer_logs_and_spans(tmp_path, caplog):
    configure_logging()
    ptrace.enable(str(tmp_path / "t.json"))
    with caplog.at_level("INFO", logger="keystone_tpu_torch"):
        with stage_timer("featurize"):
            torch.ones(4).sum()
    assert any("featurize took" in r.getMessage() for r in caplog.records)
    (span,) = [e for e in ptrace.events() if e.get("name") == "featurize"]
    assert span["cat"] == "stage"


def test_counted_fault_is_an_instant_in_the_flight_ring():
    before = pres.counters.get("tar_member_error")
    pres.counters.record("tar_member_error", "x.tar:a.jpg: truncated")
    assert pres.counters.get("tar_member_error") == before + 1
    faults = [e for e in ptrace.flight_events() if e.get("name") == "fault"]
    assert faults[-1]["args"]["kind"] == "tar_member_error"


@pytest.fixture(scope="module")
def cifar_tar(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("trace_tar") / "c.tar")
    _write_cifar_tar(path, 9, np.random.default_rng(3))
    return path


@pytest.mark.parametrize("mode", ["host", "device"])
def test_ingest_spans_and_overlap(cifar_tar, tmp_path, mode):
    """A traced stream records the JAX package's ingest spans, with the
    producer's counts, and ``trace_view`` reads the decode/consume
    overlap off them."""
    path = str(tmp_path / "t.json")
    ptrace.enable(path)
    config = ingest.StreamConfig(decode_mode=mode)
    with ingest.stream_batches(cifar_tar, 4, config=config, device="cpu") as st:
        for batch in st:
            batch.apply(lambda px: px.mean())
    assert st.join(10.0)
    ptrace.flush()
    events = trace_view.load_events(path)
    spans = {}
    for e in trace_view.spans(events):
        spans.setdefault(e["name"], []).append(e)
    decode = "ingest.entropy_decode" if mode == "device" else "ingest.decode"
    assert len(spans[decode]) == 9
    assert len(spans["ingest.consume"]) == len(spans["ingest.ring_put"]) == 3
    assert len(spans["ingest.ring_get"]) == 4  # three chunks and the end
    (prod,) = spans["ingest.produce"]
    assert (prod["args"]["decoded"], prod["args"]["batches"]) == (9, 3)
    if mode == "device":
        assert all(e["args"]["coeff_bytes"] > 0 for e in spans["ingest.ring_put"])
    overlap = trace_view.overlap_from_spans(events)
    assert overlap["decode_spans"] == 9 and overlap["consume_spans"] == 3


def test_early_stopped_stream_leaves_no_suspended_span(cifar_tar, monkeypatch):
    img = np.zeros((40, 40, 3), np.float32)
    monkeypatch.setattr(image_loaders, "decode_image", lambda data: img)
    depth = len(ptrace._stack())
    with ingest.stream_batches(cifar_tar, 2, device="cpu") as st:
        for _batch in st:
            break
    assert st.join(10.0)
    assert len(ptrace._stack()) == depth
    aborted = [e for e in ptrace.flight_events()
               if e.get("name") == "ingest.consume" and e.get("args", {}).get("aborted")]
    assert aborted
