"""The ``obs_capture`` family of the port's chaos harness
(``keystone_tpu_torch.testing.chaos``) on the port's fleet observability
plane, with the family's schedules in the tier-1 seeds and the full
schedule, in the drill's in-process mode: wire servers on slots of one CPU
device, an abrupt socket close standing in for the SIGKILL (the subprocess
mode runs in ``tests/test_torch_fleetobs.py`` and in the harness itself).

``keystone_tpu_torch.workloads.multihost.run_obs_capture_drill`` held to the
harness's bar (``chaos._judge_obs_capture``): every request answered
bit-equal to the offline oracle with the collector attached, none dropped;
fleet counters equal the sum of per-member snapshots; fleet p99 from the
pooled windows; the loss counted ``obs_member_lost`` with the fleet view
monotone; ONE schema-tagged, clock-aligned incident bundle holding every
surviving member's flight ring; an ``obs_member_lost`` postmortem dumped."""

import pytest

from keystone_tpu_torch.core.resilience import counters
from keystone_tpu_torch.testing import chaos
from keystone_tpu_torch.workloads.multihost import run_obs_capture_drill
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401

KIND = "obs_capture"
#: The family's schedule in the tier-1 seeds and in the full schedule.
SEEDS = (chaos.FAMILIES.index(KIND), chaos.FAMILIES.index(KIND) + len(chaos.FAMILIES))


@pytest.mark.parametrize("seed", SEEDS)
def test_obs_capture_inprocess_is_equal_or_typed(seed, tmp_path):
    fault = chaos.make_schedule(seed)
    assert fault.kind == KIND
    chaos._reopen_postmortems("obs_member_lost", "fleet_host_lost")
    before = counters.snapshot()
    rec = run_obs_capture_drill(str(tmp_path), hosts=chaos._chaos_hosts(fault),
                                requests=int(fault.params["requests"]), seed=seed,
                                subprocess_mode=False, timeout_s=180.0, device="cpu")
    chaos._judge_obs_capture(rec, before)
    assert rec["mode"] == "inprocess" and rec["fleet_alive"] == 1 and rec["fleet_lost"] == 1
    assert rec["kernel_launches"] == {"conv_rect_pool": 0, "fv_stats": 0, "decode_pixels": 0}
    assert chaos.expected_outcome(fault) == "completed_equal"
