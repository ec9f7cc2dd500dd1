"""Device cost attribution in the port (``keystone_tpu_torch.core.profiler``,
counterpart of ``tests/test_profiler.py``): the per-program ledger and
its bound share, the flops-hint audit, the HBM watermark sampler and
plan-drift accounting, the triggered capture window and its rate limits,
the telemetry hooks that open it, the disabled-mode bound, and the launch
costs the hand-kernel wrappers state.

All on the CPU: the sampler's stats source is injected, the capture seams
are patched (one test runs a real ``torch.profiler`` window on the CPU).
Bars: exact counts; MFU and bound shares to 1e-6 of their formulas."""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from keystone_tpu_torch.core import ingest
from keystone_tpu_torch.core import memory as kmem
from keystone_tpu_torch.core import profiler as kprof
from keystone_tpu_torch.core import telemetry as ktelemetry
from keystone_tpu_torch.core import trace as ktrace
from keystone_tpu_torch.core.resilience import counters
from keystone_tpu_torch.ops import fv_stats as fs
from keystone_tpu_torch.ops import jpeg_device as jd
from keystone_tpu_torch.ops import rect_pool as rp
from keystone_tpu_torch.ops.conv_fused import FusedConvFeaturizer
from keystone_tpu_torch.solvers.block import BlockLeastSquaresEstimator
from keystone_tpu_torch.solvers.weighted import BlockWeightedLeastSquaresEstimator
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401


@pytest.fixture(autouse=True)
def _clean_profiler():
    kprof.reset_state()
    yield
    kprof.reset_state()


def _problem(rng, n=128, d=64, k=4):
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    y = torch.from_numpy((2.0 * np.eye(k)[rng.integers(0, k, n)] - 1.0).astype(np.float32))
    return x, y


# -- the ledger ---------------------------------------------------------------


class TestLedger:
    def test_record_program_mfu_and_bound_share(self):
        with kprof.profiled(True, stats_fn=lambda: 1):
            row = kprof.record_program("t", 0.01, flops=1e9, bytes_accessed=4e8)
            rates = kprof.device_rates()
            assert row["mfu"] == pytest.approx(1e9 / 0.01 / rates["peak_flops"], abs=1e-6)
            bound, by = kprof.bound_seconds(1e9, 4e8)
            assert row["bound_share"] == pytest.approx(bound / 0.01, abs=1e-6)
            led = kprof.ledger()["t"]
        assert led["runs"] == 1 and led["bound"] in ("compute", "memory")
        assert led["bound_share"] == pytest.approx(row["bound_share"], rel=1e-5)

    def test_ledger_aggregates_runs(self):
        with kprof.profiled(True, stats_fn=lambda: 1):
            kprof.record_program("agg", 0.01, flops=10.0)
            kprof.record_program("agg", 0.03, flops=30.0)
            led = kprof.ledger()["agg"]
        assert led["runs"] == 2
        assert led["wall_seconds"] == pytest.approx(0.04, rel=1e-6)
        assert led["flops"] == 40.0

    def test_bound_seconds_takes_the_larger_term(self):
        rates = {"peak_flops": 1e12, "hbm_gbps": 1000.0}
        assert kprof.bound_seconds(1e12, 1e9, rates) == (1.0, "operations")
        assert kprof.bound_seconds(1e6, 2e12, rates) == (2.0, "bytes")

    def test_device_rates_default_without_a_card(self):
        rates = kprof.device_rates()
        if not torch.cuda.is_available():
            assert rates["device"] == "cpu"
            assert rates["peak_flops"] == kprof.DEFAULT_RATES["peak_flops"]
        assert kprof.DEVICE_RATES["NVIDIA H100 80GB HBM3"] == {
            "peak_flops": 67e12, "hbm_gbps": 3350.0}

    def test_attributed_call_records_the_stated_cost(self):
        with kprof.profiled(True, stats_fn=lambda: 1):
            out = kprof.attributed_call("call", (2.0e6, 3.0e6), lambda a: a * 2, torch.ones(4))
            row = kprof.ledger()["call"]
        assert torch.equal(out, torch.full((4,), 2.0))
        assert row["runs"] == 1 and row["flops"] == 2.0e6 and row["bytes_accessed"] == 3.0e6

    def test_kernel_launch_attribution(self):
        """A wrapper's launch: attributed with its stated cost while the
        profiler is on; off, the cost is never reckoned and nothing lands."""
        def never():
            raise AssertionError("cost reckoned with the profiler off")

        assert kprof.launch("k", never, lambda: 0) == 0
        assert kprof.ledger() == {}
        with kprof.profiled(True, stats_fn=lambda: 1):
            assert kprof.launch("k", lambda: (1.0e3, 2.0e3), lambda: 0) == 0
            row = kprof.ledger()["k"]
        assert row["runs"] == 1 and row["flops"] == 1.0e3 and row["bytes_accessed"] == 2.0e3
        assert row["bound_share"] is not None

    def test_run_ladder_feeds_ledger_and_solver_hint_audited(self, rng):
        """A profiled block fit lands its chosen tier in the ledger with the
        flops counted while it ran, and the solver's hand hint agrees with
        them within the audit's factor."""
        x, y = _problem(rng, 512, 128)
        with kprof.profiled(True, stats_fn=lambda: 1):
            BlockLeastSquaresEstimator(128, 2, 1e-2).fit(x, y)
            led = kprof.ledger()
            audits = kprof.flops_audits()
        row = led["bcd_fit:fused"]
        assert row["runs"] == 1 and row["wall_seconds"] > 0 and row["flops"]
        audit = audits["bcd_fit:fused"]
        assert audit["ok"], audit
        assert 1 / kprof.FLOPS_AUDIT_TOL <= audit["ratio"] <= kprof.FLOPS_AUDIT_TOL

    def test_weighted_fit_is_laddered_and_audited(self, rng):
        x, y = _problem(rng, 96, 32, 3)
        with kprof.profiled(True, stats_fn=lambda: 1):
            est = BlockWeightedLeastSquaresEstimator(16, 1, 0.1, 0.25)
            est.fit(x, y)
            audits = kprof.flops_audits()
        assert est.last_fit_report.chosen == "fused"
        assert audits["bwls_fit:fused"]["ok"], audits

    def test_flops_hint_mismatch_is_counted(self):
        before = counters.get("flops_hint_mismatch")
        with kprof.profiled(True, stats_fn=lambda: 1):
            ratio = kprof.audit_flops("bogus", 1e15, 1e6)
        assert ratio is not None and ratio > kprof.FLOPS_AUDIT_TOL
        assert counters.get("flops_hint_mismatch") == before + 1
        assert kprof.flops_audits()["bogus"]["ok"] is False

    def test_counting_flops_counts_matrix_products(self):
        a = torch.ones((8, 16))
        with kprof.counting_flops() as counted:
            a @ a.T
        assert counted["flops"] == 2 * 8 * 16 * 8


# -- disabled mode --------------------------------------------------------------


class TestDisabledMode:
    def test_disabled_hooks_are_inert(self, rng):
        assert not kprof.enabled()
        assert kprof.record_program("off", 0.01, flops=1.0) is None
        assert kprof.audit_flops("off", 1e6, 1e6) is None
        x, y = _problem(rng)
        before = ktrace.metrics.get("profiler_programs_recorded")
        BlockLeastSquaresEstimator(64, 1, 1e-2).fit(x, y)
        assert kprof.ledger() == {}
        assert kprof.sampler() is None
        assert ktrace.metrics.get("profiler_programs_recorded") == before

    def test_phase_is_noop_when_disabled(self):
        with kprof.phase("anything"):
            pass
        assert kprof.sampler() is None

    def test_profiled_restores_disabled(self):
        with kprof.profiled(True, stats_fn=lambda: 1024):
            assert kprof.enabled()
            assert kprof.sampler() is not None
        assert not kprof.enabled()
        assert kprof.sampler() is None

    def test_env_switch(self, monkeypatch):
        monkeypatch.setenv(kprof.PROFILER_ENV, "1")
        assert kprof.enabled()
        monkeypatch.setenv(kprof.PROFILER_ENV, "0")
        assert not kprof.enabled()

    def test_no_sampler_without_cuda_context(self):
        """On the CPU the default stats source cannot report: the sampler
        retires itself and every watermark is None."""
        if torch.cuda.is_available():
            pytest.skip("this host has a CUDA context")
        with kprof.profiled(True, interval_ms=10_000.0):
            s = kprof.sampler()
            assert s.sample() is False and s.unavailable
            with kprof.phase("p"):
                pass
            assert kprof.watermark("p") is None


# -- the HBM watermark sampler -----------------------------------------------


def _plan(total_bytes, label="p") -> kmem.MemoryPlan:
    return kmem.MemoryPlan(
        label=label, admitted=True, reason="test",
        argument_bytes=total_bytes // 2, temp_bytes=total_bytes // 4,
        output_bytes=total_bytes - total_bytes // 2 - total_bytes // 4,
        total_bytes=total_bytes, analyzed=True,
    )


class TestWatermark:
    def test_phase_watermarks(self):
        seq = iter([100, 500, 300, 200])
        with kprof.profiled(True, interval_ms=10_000.0, stats_fn=lambda: next(seq)):
            s = kprof.sampler()
            s.sample()  # 100, no phase
            with kprof.phase("solve"):
                s.sample()  # 500 attributed to "solve"
            # phase exit samples once more (300)
            assert s.watermark("solve") == 500
            assert s.watermark() == 500  # global peak
            with kprof.phase("serve"):
                pass  # exit sample: 200
            assert s.watermark("serve") == 200

    def test_phase_reentry_clears_stale_peak(self):
        seq = iter([5000, 100, 100])
        with kprof.profiled(True, interval_ms=10_000.0, stats_fn=lambda: next(seq)):
            s = kprof.sampler()
            with kprof.phase("solve"):
                s.sample()  # 5000: the big run
            with kprof.phase("solve"):
                s.sample()  # 100: the small run — fresh watermark
            assert s.watermark("solve") == 100

    def test_allocator_peak_read_at_phase_exit(self):
        """A phase that raises the allocator's process peak reads it at its
        exit, whatever the polling saw."""
        peaks = iter([1000, 9000])
        s = kprof.HbmSampler(interval_ms=10_000.0, stats_fn=lambda: 10)
        s._peak_fn = lambda: next(peaks)
        s.phase_enter("fit")
        s.phase_exit("fit")
        assert s.watermark("fit") == 9000

    def test_audit_skips_without_a_phase_sample(self):
        with kprof.profiled(True, interval_ms=10_000.0, stats_fn=lambda: 9999):
            kprof.sampler().sample()  # global peak only, no phase
            assert kprof.audit_plan("never-entered", _plan(10)) is None

    def test_backendless_sampler_retires_itself(self):
        with kprof.profiled(True, interval_ms=10_000.0, stats_fn=lambda: None):
            s = kprof.sampler()
            assert s.sample() is False
            assert s.unavailable
            assert kprof.watermark() is None

    @pytest.mark.parametrize("used, charged, drifted", [(1000, 1100, False), (4000, 1000, True)])
    def test_drift_accounting(self, used, charged, drifted):
        before = counters.get("plan_drift")
        with kprof.profiled(True, interval_ms=10_000.0, stats_fn=lambda: used):
            with kprof.phase("fit:tier"):
                kprof.sampler().sample()
            audit = kprof.audit_plan("fit:tier", _plan(charged))
        assert audit["drifted"] is drifted
        assert audit["drift_ratio"] == pytest.approx(used / charged, rel=1e-3)
        assert counters.get("plan_drift") == before + int(drifted)
        assert kprof.plan_audits()["fit:tier"]["watermark_bytes"] == used

    def test_run_ladder_audits_watermark(self, rng):
        """The ladder's hook: a profiled fit with a live (injected) stats
        source audits its chosen tier's charge against the solve phase's
        watermark, and the report carries the audit."""
        x, y = _problem(rng)
        with kprof.profiled(True, interval_ms=10_000.0, stats_fn=lambda: 10 * 2**20):
            est = BlockLeastSquaresEstimator(64, 1, 1e-2)
            est.fit(x, y)
        audit = est.last_fit_report.plan_audit
        assert audit["label"] == "bcd_fit:fused"
        assert audit["watermark_bytes"] == 10 * 2**20
        assert audit["charged_bytes"] == est.last_fit_report.plans["fused"].total_bytes

    def test_sampler_crash_is_counted_and_run_survives(self):
        calls = {"n": 0}

        def crashing():
            calls["n"] += 1
            if calls["n"] > 2:
                raise RuntimeError("boom")
            return 512

        before = counters.get("profiler_sampler_crash")
        with kprof.profiled(True, interval_ms=1.0, stats_fn=crashing):
            s = kprof.sampler()
            end = time.monotonic() + 5.0
            while not s.crashed and time.monotonic() < end:
                time.sleep(0.005)
            assert s.crashed
        assert counters.get("profiler_sampler_crash") == before + 1


# -- triggered capture ----------------------------------------------------------


@pytest.fixture
def capture_seams(monkeypatch, tmp_path):
    started, stopped = [], []
    monkeypatch.setattr(kprof, "_start_trace", started.append)
    monkeypatch.setattr(kprof, "_stop_trace", lambda: stopped.append(1))
    monkeypatch.setenv(kprof.XPROF_DIR_ENV, str(tmp_path / "xprof"))
    monkeypatch.setenv(kprof.XPROF_WINDOW_ENV, "0.02")
    return started, stopped


class TestCapture:
    def test_rate_limited_per_kind(self, capture_seams):
        started, stopped = capture_seams
        paths = []
        for _ in range(5):
            p = kprof.maybe_capture("slo_burn")
            if p:
                paths.append(p)
            time.sleep(0.05)  # the window falls due between attempts
        assert len(paths) == kprof.MAX_CAPTURES_PER_KIND
        # another kind gets its own budget
        assert kprof.maybe_capture("serve_burst_oom") is not None
        assert len(kprof.capture_paths()) == kprof.MAX_CAPTURES_PER_KIND + 1
        assert len(started) == len(kprof.capture_paths())
        # each due window closed on this thread at the next hook
        assert len(stopped) == kprof.MAX_CAPTURES_PER_KIND

    def test_single_window_at_a_time(self, capture_seams, monkeypatch):
        monkeypatch.setenv(kprof.XPROF_WINDOW_ENV, "5.0")
        assert kprof.maybe_capture("slo_burn") is not None
        # the window is still open — a second trigger (any kind) is a no-op
        assert kprof.maybe_capture("slo_burn") is None
        assert kprof.maybe_capture("deadline_exceeded") is None

    def test_no_dir_no_capture(self, monkeypatch):
        monkeypatch.delenv(kprof.XPROF_DIR_ENV, raising=False)
        assert kprof.maybe_capture("slo_burn") is None

    def test_start_failure_refunds_the_budget(self, capture_seams, monkeypatch):
        calls = {"n": 0}

        def flaky_start(path):
            calls["n"] += 1
            if calls["n"] <= 2:
                raise RuntimeError("profiler session busy")

        monkeypatch.setattr(kprof, "_start_trace", flaky_start)
        assert kprof.maybe_capture("slo_burn") is None
        assert kprof.maybe_capture("slo_burn") is None
        assert kprof.maybe_capture("slo_burn") is not None
        time.sleep(0.05)
        assert kprof.maybe_capture("slo_burn") is not None

    def test_window_closes_only_on_its_own_thread(self, capture_seams):
        """A Kineto session must stop on the thread that started it: a due
        window ignores hooks on other threads and closes at its owner's."""
        started, stopped = capture_seams
        assert kprof.maybe_capture("slo_burn") is not None
        time.sleep(0.05)
        worker = threading.Thread(target=lambda: kprof.kernel_range("x").__enter__())
        worker.start()
        worker.join()
        assert stopped == [] and kprof.capture_active()
        with kprof.kernel_range("conv_rect_pool"):
            pass
        assert stopped == [1] and not kprof.capture_active()

    def test_postmortem_fault_triggers_capture(self, capture_seams):
        before = len(kprof.capture_paths())
        counters.record("serve_burst_oom", "probe: capture trigger")
        assert len(kprof.capture_paths()) == before + 1

    def test_postmortem_dump_links_captures(self, capture_seams, monkeypatch, tmp_path):
        monkeypatch.setenv(ktelemetry.POSTMORTEM_DIR_ENV, str(tmp_path / "pm"))
        ktelemetry._reset_state()
        counters.record("solver_oom_retry", "probe: postmortem")
        path = ktelemetry.postmortem_paths()[-1]
        with open(path) as fh:
            dump = json.load(fh)
        assert dump["xprof_captures"] == kprof.capture_paths()
        assert dump["xprof_captures"]
        ktelemetry._reset_state()

    def test_slo_burn_breach_triggers_capture(self, capture_seams):
        tracker = ktelemetry.SLOTracker("probe", slo_ms=1.0, budget=0.01, window_s=60.0)
        for _ in range(tracker.BURN_CAPTURE_MIN_COUNT + 5):
            tracker.observe(50.0, ok=True)  # every one violates the SLO
        assert any("slo_burn" in p for p in kprof.capture_paths()), kprof.capture_paths()

    def test_real_window_names_the_launch_range(self, monkeypatch, tmp_path):
        """One real ``torch.profiler`` window on the CPU: the trace file is
        written into the capture directory and names the kernel range."""
        monkeypatch.setenv(kprof.XPROF_DIR_ENV, str(tmp_path))
        monkeypatch.setenv(kprof.XPROF_WINDOW_ENV, "60")
        path = kprof.maybe_capture("probe")
        assert path is not None
        with kprof.kernel_range("conv_rect_pool"):
            torch.ones((4, 4)) @ torch.ones((4, 4))
        kprof.close_capture()
        assert not kprof.capture_active()
        with open(os.path.join(path, kprof.CAPTURE_TRACE_NAME)) as fh:
            assert "conv_rect_pool" in fh.read()


# -- the launch costs the wrappers state ------------------------------------------


class TestLaunchCosts:
    def test_conv_rect_pool_cost(self):
        n, oh, ow, f, out = 2, 27, 27, 100, 2 * 4 * 200
        flops, nbytes = rp.conv_rect_pool_cost(n, oh, ow, f, out)
        assert flops == 10 * n * oh * ow * f
        assert nbytes == 4 * (n * oh * ow * f + 2 * n * oh * ow + 2 * f + out)
        _, bare = rp.conv_rect_pool_cost(n, oh, ow, f, out, normalize=False, means=False)
        assert bare == 4 * (n * oh * ow * f + out)

    def test_featurizer_states_its_launch_cost(self, rng):
        feat = FusedConvFeaturizer(
            rng.normal(size=(8, 108)).astype(np.float32), rng.normal(size=108).astype(np.float32),
            pool_stride=13, pool_size=14, img_channels=3, device="cpu",
        )
        out = feat(torch.from_numpy(rng.uniform(0, 255, (2, 32, 32, 3)).astype(np.float32)))
        assert feat.launch_cost((2, 32, 32, 3)) == rp.conv_rect_pool_cost(2, 27, 27, 8, out.numel())

    def test_rect_pool_and_idct_costs(self):
        assert rp.rect_pool_cost((2, 3, 4, 5), 2, 10) == (6.0 * 120, 120 * 2 + 40.0)
        assert jd.idct_cost(10) == (20480.0, 10 * 64 * 8.0)

    def test_fv_stats_cost_counts_valid_descriptors(self):
        flops, nbytes = fs.fv_stats_cost(2, 80, 100, 256)
        assert flops == 8 * 256 * 80 * 200
        assert nbytes == 200 * 80 * 4 + 2 * (256 + 2 * 80 * 256) * 4
        assert fs.fv_stats_cost(2, 80, 100, 256, valid_cols=150)[0] == 8 * 256 * 80 * 150

    def test_decode_pixels_cost(self):
        geom = jd.JpegGeometry(16, 16, ((2, 2), (1, 1), (1, 1)), ((2, 2), (1, 1), (1, 1)))
        flops, nbytes = jd.decode_pixels_cost(geom, 3)
        assert flops == 2048 * 3 * 6
        assert nbytes == 3 * 6 * 64 * 2 + 3 * 3 * 64 * 4 + 3 * 16 * 16 * 3 * 4


def _coeff_chunk(rng, b=2):
    geom = jd.JpegGeometry(16, 16, ((1, 1),), ((2, 2),))
    coeffs = (rng.integers(-20, 20, (b, 2, 2, 8, 8)).astype(np.int16),)
    qt = np.ones((b, 1, 8, 8), np.float32)
    return geom, coeffs, qt


class TestAttribution:
    def test_fused_apply_is_attributed_with_the_decode_cost(self, rng):
        geom, coeffs, qt = _coeff_chunk(rng)
        plain = jd.fused_apply(lambda p: p.sum(dim=(1, 2, 3)), geom, coeffs, qt, "cpu")
        with kprof.profiled(True, stats_fn=lambda: 1):
            got = jd.fused_apply(lambda p: p.sum(dim=(1, 2, 3)), geom, coeffs, qt, "cpu")
            row = kprof.ledger()["fused_decode:16x16"]
        assert torch.equal(got, plain)
        flops, nbytes = jd.decode_pixels_cost(geom, 2)
        assert row["flops"] == flops and row["bytes_accessed"] == nbytes

    def test_stream_batch_apply_is_attributed(self, rng):
        batch = ingest.StreamBatch(
            index=0, indices=np.arange(2), names=["a", "b"],
            host=rng.uniform(0, 1, (2, 8, 8, 3)).astype(np.float32), device=torch.device("cpu"),
        )
        with kprof.profiled(True, stats_fn=lambda: 1):
            out = batch.apply(lambda p: p * 2)
            row = kprof.ledger()["featurize:8x8"]
        assert torch.equal(out, torch.from_numpy(batch.host) * 2)
        assert row["runs"] == 1 and row["flops"] is None
