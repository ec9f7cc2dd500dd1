"""The port's seeded chaos suite (``keystone_tpu_torch.testing.chaos``) on the
CPU, held to the JAX suite's bar (``tests/test_chaos.py``): every schedule
ends in predictions equal to the fault-free run's or in a typed error, its
outcome is the one a healthy system gives (``expected_outcome``), and its
family's fault is counted (``test_chaos.EXPECTED_COUNTER``).

Tier-1 runs ``chaos.TIER1_SEEDS`` on MnistRandomFFT, each traced and held
to ``verify_trace``, and the out-of-memory step-down and NaN-guard schedules
on RandomPatchCifar; the full seed set runs only under ``-m chaos`` (also
marked slow, so the tier-1 ``-m 'not slow'`` filter leaves it out)."""

import pytest

from keystone_tpu_torch.testing import chaos
from test_chaos import EXPECTED_COUNTER
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401

CPU = "cpu"


def _check(r):
    assert r.ok(), r.record()
    assert r.outcome == chaos.expected_outcome(r.fault), r.record()
    counter = EXPECTED_COUNTER[r.fault.kind]
    assert r.counters_delta.get(counter, 0) >= 1, (
        f"schedule survived but its fault went uncounted ({counter} delta 0): {r.record()}")


@pytest.mark.parametrize("seed", chaos.TIER1_SEEDS)
def test_chaos_schedule_mnist(seed, tmp_path):
    """Every family, traced: every counted fault is a kind-tagged ``fault``
    instant, every typed error a failed span or a fault event."""
    trace_path = str(tmp_path / f"chaos_seed{seed}.json")
    r = chaos.run_schedule(seed, "mnist", tmpdir=str(tmp_path), trace_path=trace_path,
                           device=CPU)
    _check(r)
    assert r.trace_path == trace_path
    violations = chaos.verify_trace(trace_path, r)
    assert violations == [], {"seed": seed, "family": r.fault.kind, "violations": violations}


@pytest.mark.parametrize("seed", (0, 4))  # out-of-memory step-down + NaN guard
def test_chaos_schedule_cifar(seed, tmp_path):
    _check(chaos.run_schedule(seed, "cifar", tmpdir=str(tmp_path), device=CPU))


def test_tier1_seed_set_meets_the_chaos_bar():
    """The tier-1 set covers every family, the preempt-then-resume and the
    watchdog schedules among them, and every serving family."""
    assert len(chaos.TIER1_SEEDS) >= 10
    kinds = {chaos.make_schedule(s).kind for s in chaos.TIER1_SEEDS}
    assert kinds == set(chaos.FAMILIES) == set(EXPECTED_COUNTER)
    assert {"preempt_resume", "deadline", "stream_corrupt", "stream_hang"} <= kinds
    assert set(chaos.SERVE_FAMILIES) <= kinds


def test_schedules_are_deterministic():
    for seed in chaos.FULL_SEEDS:
        a, b = chaos.make_schedule(seed), chaos.make_schedule(seed)
        assert a.kind == b.kind and a.params == b.params


def test_deadline_names_the_phase(tmp_path):
    """The watchdog schedule's error carries the phase name."""
    seed = next(s for s in chaos.TIER1_SEEDS if chaos.make_schedule(s).kind == "deadline")
    r = chaos.run_schedule(seed, "mnist", tmpdir=str(tmp_path), device=CPU)
    assert r.error_type == "DeadlineExceeded"
    assert r.phase == "solve"


def test_cuda_without_a_card_raises(tmp_path):
    """The harness runs where it is told: ``device="cuda"`` without a card
    raises before any schedule runs, never falling back to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        chaos.run_schedule(0, "mnist", tmpdir=str(tmp_path), device="cuda")


def _full(seeds, workload):
    results = chaos.run_suite(seeds, workload=workload, device=CPU)
    bad = [r.record() for r in results
           if not r.ok() or r.outcome != chaos.expected_outcome(r.fault)]
    assert not bad, bad


@pytest.mark.chaos
@pytest.mark.slow
def test_chaos_full_schedule_mnist():
    _full(chaos.FULL_SEEDS, "mnist")


@pytest.mark.chaos
@pytest.mark.slow
def test_chaos_full_schedule_cifar():
    _full(chaos.FULL_SEEDS[: len(chaos.FAMILIES)], "cifar")
