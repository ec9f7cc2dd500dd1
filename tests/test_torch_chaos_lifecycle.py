"""The ``drift_refit`` family of the port's chaos harness
(``keystone_tpu_torch.testing.chaos``) on the port's closed lifecycle
(``keystone_tpu_torch.core.lifecycle``), with the family's schedules in the
tier-1 seeds and the full schedule.

One deployment, the harness's legs in sequence: (0) a shifted request mix
trips the armed drift monitor and the controller sees the trip; (A) a refit
that runs out of memory fetching fresh features degrades typed and counted
(``refit_failed``) to the incumbent; (B) a candidate refit over garbage
labels is rejected by the holdout gate (``refit_rejected``), never swapped;
(C) a mid-swap kill degrades typed and counted to the incumbent; (D) the
clean cycle lands with requests in flight across the swap: counted
``lifecycle_refit``, a postmortem dumped, drift re-armed, zero dropped,
pre-swap answers equal to the incumbent's offline apply and post-swap
answers equal to an offline refit on the same data; (E) a trip inside the
fresh cooldown is a counted suppression.  Any breach raises
``chaos.ChaosOracleError``.  Then, as in the harness, the workload runs and
must complete with predictions equal to the fault-free run's.  The injected
out-of-memory error is ``torch.OutOfMemoryError``."""

import time

import numpy as np
import pytest

from keystone_tpu_torch.testing import chaos
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401

KIND = "drift_refit"
#: The family's schedule in the tier-1 seeds and in the full schedule.
SEEDS = (chaos.FAMILIES.index(KIND), chaos.FAMILIES.index(KIND) + len(chaos.FAMILIES))


@pytest.mark.parametrize("seed", SEEDS)
def test_drift_refit_is_equal_or_typed(seed, tmp_path):
    fault = chaos.make_schedule(seed)
    assert fault.kind == KIND
    baseline = chaos.baseline("mnist", device="cpu")["test_predictions"]
    t0 = time.monotonic()
    landed = chaos._drift_refit_phase(fault, str(tmp_path), seed, "cpu")
    assert landed["outcome"] == "swapped" and landed["requests_in_flight"] == int(
        fault.params["requests"])
    assert not landed["cold_fit"]
    preds = chaos._run_workload("mnist", "cpu")["test_predictions"]
    outcome = "completed_equal" if np.array_equal(preds, baseline) else "SILENT_WRONG_MODEL"
    assert outcome == chaos.expected_outcome(fault), outcome
    assert time.monotonic() - t0 < 60.0
