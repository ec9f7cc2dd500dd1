"""The ``mesh_shrink`` family of the port's chaos harness
(``keystone_tpu_torch.testing.chaos``) on the port's serving tier, with the
family's schedules in the tier-1 seeds and the full schedule.

Leg 1, the live re-anchor: a router anchored on 4 CPU slots has requests
in flight (each batch of the doomed engine held ``hold_seconds``) when the
mesh shrinks to the schedule's survivors; ``ShapeRouter.reanchor`` must
swap the engine onto the surviving slots with every answer equal to the
offline apply, none lost, counted ``mesh_reanchor``.  Leg 2, the reshard
resume (``core.checkpoint.load_pipeline(mesh=)``): a scaler saved with its
mean split ``data@dim0`` over the 4 slots refuses the plain load with a
``CheckpointMismatch`` naming ``mesh=``, then loads onto the survivors,
counted ``ckpt_reshard``, and answers equal to the fault-free scaler.  Any
breach raises ``chaos.ChaosOracleError``.  Then, as in the harness, the
MNIST workload runs and must complete with the fault-free run's
predictions."""

import time

import numpy as np
import pytest

from keystone_tpu_torch.testing import chaos
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401

KIND = "mesh_shrink"
#: The family's schedule in the tier-1 seeds and in the full schedule.
SEEDS = (chaos.FAMILIES.index(KIND), chaos.FAMILIES.index(KIND) + len(chaos.FAMILIES))


@pytest.mark.parametrize("seed", SEEDS)
def test_mesh_shrink_is_equal_or_typed(seed, tmp_path):
    fault = chaos.make_schedule(seed)
    assert fault.kind == KIND
    baseline = chaos.baseline("mnist", device="cpu")["test_predictions"]
    t0 = time.monotonic()
    rec = chaos._mesh_shrink_phase(fault, str(tmp_path), seed, "cpu")
    survivors = int(fault.params["survivors"])
    assert rec["mesh"] == rec["router_mesh"] == f"{survivors}x1"
    assert len(rec["swapped"]) == 1 and rec["in_flight"] > 0
    preds = chaos._run_workload("mnist", "cpu")["test_predictions"]
    outcome = "completed_equal" if np.array_equal(preds, baseline) else "SILENT_WRONG_MODEL"
    assert outcome == chaos.expected_outcome(fault), outcome
    assert time.monotonic() - t0 < 60.0
