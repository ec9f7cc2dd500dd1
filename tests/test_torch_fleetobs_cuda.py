"""The fleet observability drill on the card: two in-process members serving
the drill's scaler from slots of ``cuda:0`` behind ``WireServer``\\ s, the
collector scraping every 0.1 s, one member's sockets closed mid-scrape.
Fleet counters equal the per-member sums, fleet p99 comes from the pooled
windows, the loss is counted once with the view monotone, ONE incident
bundle holds the survivor's ring, and every answer equals the offline one.

This file imports neither JAX nor the JAX package, so it runs on a machine
without them:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_fleetobs_cuda.py``.
Tests that need the card carry the ``cuda`` marker and skip without one."""

import pytest
import torch

from keystone_tpu_torch.core import telemetry as ktelemetry
from keystone_tpu_torch.workloads import multihost
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_obs_capture_drill_inprocess_on_the_card(cuda, tmp_path):
    with ktelemetry._pm_lock:
        ktelemetry._pm_counts.pop("obs_member_lost", None)
    rec = multihost.run_obs_capture_drill(str(tmp_path), hosts=2, requests=18,
                                          subprocess_mode=False, device="cuda",
                                          timeout_s=120.0)
    assert rec["device"].startswith("cuda")
    assert rec["counter_sum_ok"], rec.get("counter_sum_mismatch")
    assert rec["p99_match"] and rec["monotone_ok"]
    assert rec["obs_member_lost"] >= 1
    assert rec["dropped_requests"] == 0 and rec["mismatches"] == 0
    inc = rec["incident"]
    assert inc["schema"] == "keystone.incident/1"
    assert inc["survivor_rings_ok"] and inc["events_monotone"]
    assert rec["fleet_alive"] == 1 and rec["fleet_lost"] == 1
