"""The ``host_loss`` family of the chaos harness (``tests/chaos.py``) on the
port's serving fleet, with the harness's fault parameters
(``chaos.make_schedule``) and its oracle (``chaos.ChaosOracleError``), in
both of the drill's modes: REAL subprocess hosts serving over the wire (one
SIGKILLed mid-flight; ``dist`` marker) and in-process wire servers (an
abrupt socket close stands in for the death).

The harness's ``_host_loss_phase`` on the port's modules
(``keystone_tpu_torch.workloads.multihost.run_host_loss_drill`` on CPU
slots): every request answered bit-equal to the offline oracle, none
dropped, no client error; every survivor re-formed the group
(``dist_reform``) and re-anchored (``host_reanchor``); the front-end
counted the loss (``fleet_host_lost``) and the controller the re-anchor;
a ``host_reanchor`` postmortem was dumped."""

import os

import pytest

import chaos
from keystone_tpu_torch.core import telemetry as ktelemetry
from keystone_tpu_torch.core.resilience import counters
from keystone_tpu_torch.workloads.multihost import run_host_loss_drill
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401

KIND = "host_loss"
#: The family's schedule in the tier-1 seeds and in the full schedule.
SEEDS = (chaos.FAMILIES.index(KIND), chaos.FAMILIES.index(KIND) + len(chaos.FAMILIES))


def _host_loss_phase(fault: chaos.Fault, tmpdir: str, seed: int, subprocess_mode: bool) -> dict:
    """The harness's ``_host_loss_phase`` on the port's drill.  Returns the
    drill's record."""
    Oracle = chaos.ChaosOracleError
    # The postmortem cap is per kind and per process: earlier tests of this
    # process may have used it up, so the drill's own dumps get room.
    with ktelemetry._pm_lock:
        for kind in ("host_reanchor", "fleet_host_lost", "mesh_reanchor"):
            ktelemetry._pm_counts.pop(kind, None)
    hosts = int(os.environ.get("KEYSTONE_CHAOS_HOSTS", fault.params["hosts"]))
    lost_before = counters.get("fleet_host_lost")
    reanchor_before = counters.get("host_reanchor")
    rec = run_host_loss_drill(tmpdir, hosts=hosts, requests=int(fault.params["requests"]),
                              seed=seed, device="cpu", subprocess_mode=subprocess_mode,
                              timeout_s=180.0)
    if rec["dropped_requests"] != 0:
        raise Oracle(f"host loss dropped {rec['dropped_requests']} request(s) "
                     f"({rec['answered']}/{rec['requests']} answered; errors: {rec['errors']})")
    if rec["mismatches"] != 0:
        raise Oracle(f"{rec['mismatches']} answer(s) differ from the offline oracle after the "
                     "host loss — silent wrong answers")
    if rec["errors"]:
        raise Oracle(f"fleet clients saw errors across the loss: {rec['errors']}")
    for r, sc in rec["survivor_counters"].items():
        if sc.get("dist_reform", 0) < 1:
            raise Oracle(f"survivor {r} never re-formed the group: {sc}")
        if sc.get("host_reanchor", 0) < 1:
            raise Oracle(f"survivor {r} never re-anchored its engines: {sc}")
    if counters.get("fleet_host_lost") - lost_before < 1:
        raise Oracle("the front-end never counted the host loss (fleet_host_lost)")
    if counters.get("host_reanchor") - reanchor_before < 1:
        raise Oracle("the re-anchor was never counted controller-side (host_reanchor)")
    if not [p for p in rec["postmortems"] if "host_reanchor" in p]:
        raise Oracle(f"no host_reanchor postmortem dumped (got {rec['postmortems']})")
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
    assert chaos.expected_outcome(fault) == "completed_equal"
