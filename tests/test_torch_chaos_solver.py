"""The solver families of the port's chaos harness
(``keystone_tpu_torch.testing.chaos``): ``solver_oom``, ``oom_cascade``,
``preempt_resume``, ``deadline``, ``plan_mispredict`` and
``spec_mispredict``, each on the port's MnistRandomFFT and RandomPatchCifar
at the harness's case sizes and fault parameters, with the fitted run's
record held beyond the harness's own verdict.

The harness's invariant: every faulted run either completes with
predictions equal to the fault-free run's, or fails with a typed error
that the fault ledger counted.  The injection points are the port's:
``solvers.block._fused_bcd_impl`` for the fused tier, and
``_bcd_block_solve``, every tier's block update, whose first call once the
fused tier has failed is the stepwise tier's.  An injected out-of-memory
error is ``torch.OutOfMemoryError``.  ``plan_mispredict`` kills the
placement search's top-ranked plan (the fused tier) and holds the run to
the harness's step-down oracle (``chaos._stepdown_oracle``): the fit chose
the next-ranked plan, counted ``autoshard_stepdown``.  ``spec_mispredict``
runs both workloads on the harness's 4x2 mesh of CPU slots: a spec
candidate on the head mesh of the fault-free mesh run's placement is
forced to the top through ``conf.solve_plan``, its mesh tier
(``solvers.block._execute_fused_bcd_mesh``) dies out of memory, and the run
must step down to the default layout, counted, with predictions equal to
the fault-free mesh run's."""

import os
import time

import numpy as np
import pytest

from keystone_tpu_torch.core.resilience import DeadlineExceeded, counters
from keystone_tpu_torch.testing import chaos
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401

FAMILIES = ("solver_oom", "oom_cascade", "preempt_resume", "deadline", "plan_mispredict",
            "spec_mispredict")


def _forced_spec(placement: dict) -> list[str]:
    """The first spec candidate on the head's mesh that the search did not
    prune, as the harness picks it for ``spec_mispredict``."""
    head = next(c for c in placement["candidates"] if c["name"] == placement["ranking"][0])
    return next([c["name"]] for c in placement["candidates"]
                if c.get("specs") and not c["pruned"] and c["mesh"] == head["mesh"])


@pytest.mark.parametrize("workload", ["mnist", "cifar"])
@pytest.mark.parametrize("kind", FAMILIES)
def test_faulted_run_is_equal_or_typed(kind, workload, tmp_path):
    seed = chaos.FAMILIES.index(kind)
    fault = chaos.make_schedule(seed)
    base = chaos.baseline(workload, mesh=kind == "spec_mispredict", device="cpu")
    before = counters.snapshot()
    t0 = time.monotonic()
    try:
        res = chaos._run_faulted(fault, workload, str(tmp_path), seed, "cpu")
    except DeadlineExceeded as e:
        outcome, counted = "typed_error", counters.get("deadline_exceeded") - before.get(
            "deadline_exceeded", 0)
        assert e.phase == "solve" and counted == 1
    else:
        outcome = ("completed_equal" if np.array_equal(res["test_predictions"],
                                                       base["test_predictions"])
                   else "SILENT_WRONG_MODEL")
    assert outcome == chaos.expected_outcome(fault), outcome
    assert time.monotonic() - t0 < 60.0
    delta = {k: v - before.get(k, 0) for k, v in counters.snapshot().items()
             if v != before.get(k, 0)}
    if kind == "spec_mispredict":
        assert delta.get("autoshard_stepdown") == delta.get("solver_oom_retry") == 1, delta
        placement = res["placement"]
        assert placement["chosen"] == placement["ranking"][1] == "fused[mesh 4x2]"
        assert placement["ranking"][0] == _forced_spec(base["placement"])[0]
        assert res["fit_report"]["chosen_tier"] == "fused[mesh 4x2]"
    if kind in ("solver_oom", "oom_cascade", "plan_mispredict"):
        assert delta.get("solver_oom_retry") == (1 if kind != "oom_cascade" else 2), delta
        assert res["fit_report"]["chosen_tier"] == (
            "host_staged" if kind == "oom_cascade" else "stepwise")
        # plan=None searches, so every ranked plan that died is a counted
        # step-down of the searched ranking, as in the JAX package.
        assert delta.get("autoshard_stepdown") == delta["solver_oom_retry"], delta
        assert res["placement"]["chosen"] == res["fit_report"]["chosen_tier"]
    if kind == "preempt_resume":
        assert os.path.exists(str(tmp_path / f"chaos_bcd_{workload}_{seed}.npz"))
        assert res["fit_report"]["chosen_tier"] == "stepwise[checkpoint]"
