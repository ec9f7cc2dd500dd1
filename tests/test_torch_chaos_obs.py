"""The ``obs_capture`` family of the chaos harness (``tests/chaos.py``) on the
port's fleet observability plane, with the harness's fault parameters
(``chaos.make_schedule``) and its oracle (``chaos.ChaosOracleError``), in the
drill's in-process mode: wire servers on slots of one CPU device, an abrupt
socket close standing in for the SIGKILL (the subprocess mode is held once,
in ``tests/test_torch_fleetobs.py``).

The harness's ``_obs_capture_phase`` on the port's modules
(``keystone_tpu_torch.workloads.multihost.run_obs_capture_drill``): every
request answered bit-equal to the offline oracle with the collector
attached, none dropped; fleet counters equal the sum of per-member
snapshots; fleet p99 from the pooled windows; the loss counted
``obs_member_lost`` with the fleet view monotone; ONE schema-tagged,
clock-aligned incident bundle holding every surviving member's flight
ring; an ``obs_member_lost`` postmortem dumped."""

import os

import pytest

import chaos
from keystone_tpu_torch.core import telemetry as ktelemetry
from keystone_tpu_torch.core.resilience import counters
from keystone_tpu_torch.workloads.multihost import run_obs_capture_drill
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401

KIND = "obs_capture"
#: The family's schedule in the tier-1 seeds and in the full schedule.
SEEDS = (chaos.FAMILIES.index(KIND), chaos.FAMILIES.index(KIND) + len(chaos.FAMILIES))


def _obs_capture_phase(fault: chaos.Fault, tmpdir: str, seed: int) -> dict:
    """The harness's ``_obs_capture_phase`` on the port's drill.  Returns
    the drill's record."""
    Oracle = chaos.ChaosOracleError
    # The postmortem cap is per kind and per process: earlier tests of this
    # process may have used it up, so the drill's own dumps get room.
    with ktelemetry._pm_lock:
        for kind in ("obs_member_lost", "fleet_host_lost"):
            ktelemetry._pm_counts.pop(kind, None)
    hosts = int(os.environ.get("KEYSTONE_CHAOS_HOSTS", fault.params["hosts"]))
    lost_before = counters.get("obs_member_lost")
    rec = run_obs_capture_drill(tmpdir, hosts=hosts, requests=int(fault.params["requests"]),
                                seed=seed, subprocess_mode=False, timeout_s=180.0,
                                device="cpu")
    if rec["dropped_requests"] != 0:
        raise Oracle(f"obs drill dropped {rec['dropped_requests']} request(s) "
                     f"({rec['answered']}/{rec['requests']} answered; errors: {rec['errors']})")
    if rec["mismatches"] != 0:
        raise Oracle(f"{rec['mismatches']} answer(s) differ from the offline oracle with the "
                     "collector attached — collection touched the serving answers")
    if not rec.get("counter_sum_ok"):
        raise Oracle(f"fleet counters != sum of per-member snapshots: "
                     f"{rec.get('counter_sum_mismatch')}")
    if not rec.get("p99_match"):
        raise Oracle(f"fleet p99 {rec.get('p99_fleet')} does not come from the pooled windows "
                     f"(pick oracle {rec.get('p99_oracle_pick')}, numpy oracle "
                     f"{rec.get('p99_oracle_np')}, pool n={rec.get('p99_pool_n')})")
    if not rec.get("monotone_ok"):
        raise Oracle(f"fleet counters stepped BACKWARDS across the member loss: "
                     f"{rec.get('monotone_violations')}")
    if counters.get("obs_member_lost") - lost_before < 1:
        raise Oracle("the collector never counted the member loss (obs_member_lost)")
    incident = rec.get("incident") or {}
    if incident.get("error"):
        raise Oracle(f"incident capture wrote {incident['error']} for one member loss — "
                     "expected exactly one bundle")
    if incident.get("schema") != "keystone.incident/1":
        raise Oracle(f"incident bundle is not schema-tagged: {incident}")
    if not incident.get("survivor_rings_ok"):
        raise Oracle(f"the incident bundle is missing a surviving member's flight ring: "
                     f"{incident}")
    if not incident.get("events_monotone"):
        raise Oracle("incident bundle events are not on one monotone clock-aligned timeline")
    if not [p for p in rec["postmortems"] if "obs_member_lost" in p]:
        raise Oracle(f"no obs_member_lost postmortem dumped (got {rec['postmortems']})")
    return rec


@pytest.mark.parametrize("seed", SEEDS)
def test_obs_capture_inprocess_is_equal_or_typed(seed, tmp_path):
    fault = chaos.make_schedule(seed)
    assert fault.kind == KIND
    rec = _obs_capture_phase(fault, str(tmp_path), seed)
    assert rec["mode"] == "inprocess" and rec["fleet_alive"] == 1 and rec["fleet_lost"] == 1
    assert rec["kernel_launches"] == {"conv_rect_pool": 0, "fv_stats": 0, "decode_pixels": 0}
    assert chaos.expected_outcome(fault) == "completed_equal"
