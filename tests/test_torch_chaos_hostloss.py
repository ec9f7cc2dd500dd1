"""The ``host_loss`` family of the port's chaos harness
(``keystone_tpu_torch.testing.chaos``) on the port's serving fleet, with the
family's schedules in the tier-1 seeds and the full schedule, in both of the
drill's modes: REAL subprocess hosts serving over the wire (one SIGKILLed
mid-flight; ``dist`` marker) and in-process wire servers (an abrupt socket
close stands in for the death).

``keystone_tpu_torch.workloads.multihost.run_host_loss_drill`` on CPU slots,
held to the harness's bar (``chaos._judge_host_loss``): every request
answered bit-equal to the offline oracle, none dropped, no client error;
every survivor re-formed the group (``dist_reform``) and re-anchored
(``host_reanchor``); the front-end counted the loss (``fleet_host_lost``)
and the controller the re-anchor; a ``host_reanchor`` postmortem was
dumped; in the subprocess mode, a request was in flight on the host when
it was killed."""

import pytest

from keystone_tpu_torch.core.resilience import counters
from keystone_tpu_torch.testing import chaos
from keystone_tpu_torch.workloads.multihost import run_host_loss_drill
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401

KIND = "host_loss"
#: The family's schedule in the tier-1 seeds and in the full schedule.
SEEDS = (chaos.FAMILIES.index(KIND), chaos.FAMILIES.index(KIND) + len(chaos.FAMILIES))


def _host_loss_phase(fault: chaos.Fault, tmpdir: str, seed: int, subprocess_mode: bool) -> dict:
    """The harness's host-loss phase in the given mode.  Returns the
    drill's record."""
    chaos._reopen_postmortems("host_reanchor", "fleet_host_lost", "mesh_reanchor")
    before = counters.snapshot()
    rec = run_host_loss_drill(tmpdir, hosts=chaos._chaos_hosts(fault),
                              requests=int(fault.params["requests"]), seed=seed, device="cpu",
                              subprocess_mode=subprocess_mode, timeout_s=180.0)
    chaos._judge_host_loss(rec, before)
    return rec


@pytest.mark.parametrize("seed", SEEDS)
def test_host_loss_inprocess_is_equal_or_typed(seed, tmp_path):
    fault = chaos.make_schedule(seed)
    assert fault.kind == KIND
    rec = _host_loss_phase(fault, str(tmp_path), seed, subprocess_mode=False)
    assert rec["mode"] == "inprocess" and rec["fleet"]["lost_hosts"] == 1
    assert chaos.expected_outcome(fault) == "completed_equal"


@pytest.mark.dist
@pytest.mark.parametrize("seed", SEEDS)
def test_host_loss_subprocess_is_equal_or_typed(seed, tmp_path):
    fault = chaos.make_schedule(seed)
    assert fault.kind == KIND
    rec = _host_loss_phase(fault, str(tmp_path), seed, subprocess_mode=True)
    assert rec["mode"] == "subprocess" and rec["fleet"]["lost_hosts"] == 1
    assert rec["worker_rcs"][rec["kill_rank"]] != 0  # SIGKILLed, not shut down
    assert rec["in_flight_at_kill"] >= 1  # the kill met a request in flight
    assert chaos.expected_outcome(fault) == "completed_equal"
