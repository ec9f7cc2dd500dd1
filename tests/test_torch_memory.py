"""HBM admission in the port (``keystone_tpu_torch.core.memory``,
counterpart of the single-device cases of ``tests/test_memory_plan.py``):
byte parsing and the budget, plans from tensors and ``meta`` runs, denials
counted, the resident-bytes credit, out-of-memory recognition, the
degradation ladder, the solvers' fit reports (the block fit charges its
feature blocks and their concatenation), and the admission of the device
decode in ``fused_apply``.

All on the CPU; budgets come from ``KEYSTONE_HBM_BUDGET`` or are passed in.
Bars: exact byte counts and counts; a fit under a denied plan gives the
same model bits as an admitted one."""

import json
import logging

import numpy as np
import pytest
import torch

from keystone_tpu_torch.core import memory as kmem
from keystone_tpu_torch.core import profiler as kprof
from keystone_tpu_torch.core.resilience import counters
from keystone_tpu_torch.ops import jpeg_device as jd
from keystone_tpu_torch.solvers.block import BlockLeastSquaresEstimator
from keystone_tpu_torch.solvers.weighted import BlockWeightedLeastSquaresEstimator
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401

N, D, K, BS = 32, 256, 4, 64


def _problem(rng):
    a = torch.from_numpy(rng.normal(size=(N, D)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(N, K)).astype(np.float32))
    return a, b


def _fit(a, b):
    est = BlockLeastSquaresEstimator(BS, num_iter=2, lam=0.5)
    model = est.fit(a, b)
    return est, model(a)


class TestBudget:
    def test_parse_bytes(self):
        assert kmem.parse_bytes("512M") == 512 * 2**20
        assert kmem.parse_bytes("16G") == 16 * 2**30
        assert kmem.parse_bytes("1.5GB") == int(1.5 * 2**30)
        assert kmem.parse_bytes("2KiB") == 2048
        assert kmem.parse_bytes("1MB") == 2**20
        assert kmem.parse_bytes(4096) == 4096
        with pytest.raises(ValueError, match="cannot parse"):
            kmem.parse_bytes("a lot")

    def test_fmt_bytes(self):
        assert kmem.fmt_bytes(512) == "512B"
        assert kmem.fmt_bytes(3 * 2**30 + 2**28) == "3.25GB"

    def test_env_budget_wins(self, monkeypatch):
        monkeypatch.setenv(kmem.HBM_BUDGET_ENV, "3G")
        assert kmem.hbm_budget() == 3 * 2**30
        assert not kmem.budget_is_live()

    def test_no_budget_on_cpu(self, monkeypatch):
        monkeypatch.delenv(kmem.HBM_BUDGET_ENV, raising=False)
        assert kmem.hbm_budget("cpu") is None
        if not torch.cuda.is_available():
            assert kmem.hbm_budget() is None

    def test_cached_blocks_count_as_free(self, monkeypatch):
        """The caching allocator's reserved-but-unused blocks are free to
        this process though ``mem_get_info`` reports them used."""
        monkeypatch.delenv(kmem.HBM_BUDGET_ENV, raising=False)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "mem_get_info", lambda dev=None: (100, 1000))
        monkeypatch.setattr(torch.cuda, "memory_reserved", lambda dev=None: 50)
        monkeypatch.setattr(torch.cuda, "memory_allocated", lambda dev=None: 20)
        assert kmem.hbm_budget() == 130
        assert kmem.budget_is_live()


class TestPlanProgram:
    def test_no_budget_skips_analysis(self, monkeypatch):
        monkeypatch.delenv(kmem.HBM_BUDGET_ENV, raising=False)
        plan = kmem.plan_program(lambda x: x @ x.T, torch.empty((8, 8), device="meta"),
                                 label="skip", budget=None)
        assert plan.admitted and not plan.analyzed
        assert "admission skipped" in plan.reason

    def test_breakdown_from_tensors_and_meta_run(self):
        plan = kmem.plan_program(lambda x: x @ x.T, torch.empty((64, 32), device="meta"),
                                 label="mm", budget=None, require_analysis=True)
        assert plan.analyzed and plan.admitted
        assert plan.argument_bytes == 64 * 32 * 4
        assert plan.output_bytes == 64 * 64 * 4
        assert plan.reported is None  # no compiler memory report in PyTorch
        bd = plan.breakdown()
        assert set(bd) >= {"admitted", "argument_gb", "temp_gb", "output_gb", "total_gb"}
        json.dumps(bd)

    def test_function_without_a_meta_path_charges_no_output(self):
        def host_only(x):
            return torch.from_numpy(x.numpy())

        plan = kmem.plan_program(host_only, torch.empty((16,), device="meta"),
                                 label="host", budget=None, require_analysis=True)
        assert plan.admitted and plan.output_bytes == 0 and plan.error

    def test_denial_counted(self):
        before = counters.get("hbm_preflight_denied")
        plan = kmem.plan_program(lambda x: x @ x.T, torch.empty((128, 128), device="meta"),
                                 label="tiny_budget", budget=100)
        assert not plan.admitted and "DENIED" in plan.reason
        assert counters.get("hbm_preflight_denied") == before + 1

    def test_extra_and_floor_bytes_count(self):
        arg = torch.empty((16, 16), device="meta")
        base = kmem.plan_program(lambda x: x + 1, arg, label="b", budget=None,
                                 require_analysis=True)
        plus = kmem.plan_program(lambda x: x + 1, arg, label="p", budget=None,
                                 require_analysis=True, extra_bytes=10_000, min_temp_bytes=5_000)
        assert plus.total_bytes == base.total_bytes + 15_000

    @pytest.mark.parametrize("live, admitted", [(True, True), (False, False)])
    def test_resident_credit_only_against_a_live_budget(self, monkeypatch, live, admitted):
        """A live free-bytes budget already excludes device-resident inputs;
        a capacity budget charges them."""
        if live:
            monkeypatch.delenv(kmem.HBM_BUDGET_ENV, raising=False)
        else:
            monkeypatch.setenv(kmem.HBM_BUDGET_ENV, "1000")
        plan = kmem.plan_bytes("r", argument_bytes=1500, resident_bytes=1000, budget=1000)
        assert plan.admitted is admitted

    def test_plan_batch_turns_a_raising_planner_into_a_denial(self):
        def broken():
            raise ValueError("no shapes")

        plans = kmem.plan_batch([("ok", lambda: kmem.plan_bytes("ok", budget=None)),
                                 ("bad", broken)])
        assert plans["ok"].admitted and not plans["bad"].admitted
        assert "no shapes" in plans["bad"].error


class TestOomDetection:
    @pytest.mark.parametrize("err", [
        torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
        RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB"),
        MemoryError(),
    ])
    def test_oom_is_recognized(self, err):
        assert kmem.is_oom_error(err)

    @pytest.mark.parametrize("err", [
        ValueError("CUDA out of memory"), RuntimeError("shape mismatch"),
        kmem.LadderSourceLost("source gone — refit to keep OOM recovery possible"),
    ])
    def test_other_errors_pass_through(self, err):
        assert not kmem.is_oom_error(err)


def _tier(name, admitted, run):
    return kmem.Tier(name, lambda: kmem.MemoryPlan(name, admitted, "test"), run)


class TestLadder:
    def test_denied_tier_is_skipped(self):
        report = kmem.FitReport()
        out = kmem.run_ladder("l", [_tier("a", False, lambda p: "a"),
                                    _tier("b", True, lambda p: "b")], report)
        assert out == "b" and report.chosen == "b" and report.denials == ["a"]

    def test_floor_runs_despite_its_denial(self):
        report = kmem.FitReport()
        assert kmem.run_ladder("l", [_tier("only", False, lambda p: 7)], report) == 7
        assert report.chosen == "only" and report.denials == []

    def test_oom_steps_down_one_tier(self):
        def oom(plan):
            raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 1 GiB")

        before = counters.get("solver_oom_retry")
        report = kmem.FitReport()
        out = kmem.run_ladder("l", [_tier("a", True, oom), _tier("b", True, lambda p: "b")], report)
        assert out == "b" and report.oom_retries == ["a"] and report.degraded()
        assert counters.get("solver_oom_retry") == before + 1

    def test_non_oom_errors_propagate(self):
        def bad(plan):
            raise ValueError("wrong shapes")

        with pytest.raises(ValueError, match="wrong shapes"):
            kmem.run_ladder("l", [_tier("a", True, bad), _tier("b", True, lambda p: 1)],
                            kmem.FitReport())

    def test_oom_on_the_floor_raises(self):
        def oom(plan):
            raise torch.OutOfMemoryError("CUDA out of memory")

        with pytest.raises(torch.OutOfMemoryError):
            kmem.run_ladder("l", [_tier("a", True, oom)], kmem.FitReport())


class TestSolverReports:
    def test_report_record_is_jsonable(self, rng, monkeypatch):
        monkeypatch.setenv(kmem.HBM_BUDGET_ENV, "1G")
        a, b = _problem(rng)
        est, _ = _fit(a, b)
        blob = json.loads(json.dumps(est.last_fit_report.record()))
        assert blob["chosen_tier"] == "fused"
        assert set(blob["tiers"]) == {"fused"}
        assert blob["tiers"]["fused"]["admitted"] is True

    def test_block_list_and_its_concatenation_are_both_charged(self, rng, monkeypatch):
        monkeypatch.setenv(kmem.HBM_BUDGET_ENV, "1G")
        a, b = _problem(rng)
        blocks = list(torch.split(a, BS, dim=1))
        listed = BlockLeastSquaresEstimator(BS, 1, 0.5).plan_fused(blocks, b, (BS,) * 4)
        whole = BlockLeastSquaresEstimator(BS, 1, 0.5).plan_fused(a, b, (BS,) * 4)
        # a monolithic block-multiple input is its own design matrix (a view)
        assert listed.argument_bytes - whole.argument_bytes == N * D * 4
        assert whole.argument_bytes == N * D * 4 + N * K * 4

    def test_denied_floor_still_fits_the_same_model(self, rng, monkeypatch):
        monkeypatch.setenv(kmem.HBM_BUDGET_ENV, "1G")
        a, b = _problem(rng)
        _, clean = _fit(a, b)
        monkeypatch.setenv(kmem.HBM_BUDGET_ENV, "1K")
        before = counters.get("hbm_preflight_denied")
        est, pinched = _fit(a, b)
        # Every tier is denied and counted; the floor is host_staged.  The
        # fit searches (plan=None), so, as in the JAX package, the search's
        # analytic prune denies each tier once and the floor's own preflight
        # denies it again.
        tiers = ["fused", "stepwise", "host_staged"]
        assert counters.get("hbm_preflight_denied") == before + len(tiers) + 1
        assert [t for t, p in est.last_fit_report.plans.items() if not p.admitted] == tiers
        assert est.last_fit_report.chosen == "host_staged"
        assert torch.equal(clean, pinched)

    def test_weighted_fit_report(self, rng):
        x = torch.from_numpy(rng.normal(size=(60, 24)).astype(np.float32))
        y = torch.from_numpy((2.0 * np.eye(3)[np.arange(60) % 3] - 1.0).astype(np.float32))
        est = BlockWeightedLeastSquaresEstimator(8, 1, 0.1, 0.25)
        est.fit(x, y)
        rep = est.last_fit_report
        assert rep.label == "bwls_fit" and rep.chosen == "fused" and set(rep.plans) == {"fused"}

    def test_log_fit_report(self, rng, caplog):
        a, b = _problem(rng)
        est, _ = _fit(a, b)
        with caplog.at_level(logging.INFO):
            kmem.log_fit_report(est, logging.getLogger("probe"), "probe solve")
        assert "probe solve: bcd_fit: tier=fused" in caplog.text
        kmem.log_fit_report(object())  # no report: nothing to log


class TestBytes:
    def test_array_bytes(self):
        assert kmem.array_bytes(torch.empty((3, 4)), np.zeros((2,), np.float64), None) == 48 + 16
        assert kmem.array_bytes(torch.empty((5,), dtype=torch.bfloat16)) == 10

    def test_free_buffers_leaves_cpu_tensors_alone(self):
        t = torch.ones(4)
        kmem.free_buffers(t, None, "x")
        assert torch.equal(t, torch.ones(4))


class TestDecodeAdmission:
    def _chunk(self, rng, h, w, b=2):
        by, bx = -(-h // 8), -(-w // 8)
        geom = jd.JpegGeometry(h, w, ((1, 1),), ((by, bx),))
        coeffs = (rng.integers(-20, 20, (b, by, bx, 8, 8)).astype(np.int16),)
        return geom, coeffs, np.ones((b, 1, 8, 8), np.float32)

    def test_denial_counted_once_per_geometry_and_values_unchanged(self, rng, monkeypatch):
        """Admission is decided once per (transform, geometry), so the
        pinched run uses a transform of its own."""
        def transform(p):
            return p.mean(dim=(1, 2))

        def pinched(p):
            return p.mean(dim=(1, 2))

        g1, c1, q1 = self._chunk(rng, 16, 24)
        g2, c2, q2 = self._chunk(rng, 24, 16)
        free = [jd.fused_apply(transform, g, c, q, "cpu") for g, c, q in
                ((g1, c1, q1), (g2, c2, q2))]
        monkeypatch.setenv(kmem.HBM_BUDGET_ENV, "1K")
        before = counters.get("device_decode_admission_denied")
        outs = [jd.fused_apply(pinched, g, c, q, "cpu") for g, c, q in
                ((g1, c1, q1), (g1, c1, q1), (g2, c2, q2))]
        assert counters.get("device_decode_admission_denied") == before + 2
        assert torch.equal(outs[0], free[0]) and torch.equal(outs[2], free[1])

    def test_admitted_under_a_roomy_budget(self, rng, monkeypatch):
        monkeypatch.setenv(kmem.HBM_BUDGET_ENV, "1G")
        geom, coeffs, qt = self._chunk(rng, 16, 16)
        before = counters.get("device_decode_admission_denied")
        jd.fused_apply(lambda p: p.sum(dim=(1, 2, 3)), geom, coeffs, qt, "cpu")
        assert counters.get("device_decode_admission_denied") == before


def test_profiled_fit_phases(rng):
    """The block fit declares the phase ``bcd_fit`` and the ladder the
    phase ``solve:bcd_fit``; both get a watermark from a live source."""
    kprof.reset_state()
    a, b = _problem(rng)
    with kprof.profiled(True, interval_ms=10_000.0, stats_fn=lambda: 4096):
        _fit(a, b)
        assert kprof.watermark("bcd_fit") == 4096
        assert kprof.watermark("solve:bcd_fit") == 4096
    kprof.reset_state()
