"""Multiple processes on the card: the two-process ``gloo`` fit+serve with
each rank's two mesh slots on ``cuda:0`` (pixels streamed to the card,
features, the scaler and the served buckets computed there) is
bit-identical to its single-process reference, spans the processes and
reshards the checkpoint window by window; the host-loss drill with real
subprocess hosts serving on the card drops and changes no answer.

This file imports neither JAX nor the JAX package, so it runs on a machine
without them:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_multihost_cuda.py``.
Tests that need the card carry the ``cuda`` marker and skip without one."""

import pytest
import torch

from keystone_tpu_torch.parallel import distributed as kdist
from keystone_tpu_torch.workloads import multihost
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401


@pytest.fixture
def cuda_spawn():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    assert kdist.spawn_available(), "the card host must spawn workers"


@pytest.mark.cuda
def test_two_process_fit_serve_on_the_card(cuda_spawn, tmp_path):
    j = multihost.run_two_process_fit_serve(str(tmp_path), device="cuda", timeout_s=300.0)
    assert j["bit_identical"] and j["mesh_spans"] and j["parity_ok"]
    assert j["crosshost_reshard"] >= 1 and j["crosshost_bit_equal"]
    assert j["leaked_threads"] == [] and j["n_images"] == 24
    assert all(r["device"].startswith("cuda") for r in j["records"].values())


@pytest.mark.cuda
def test_host_loss_drill_subprocess_on_the_card(cuda_spawn, tmp_path):
    rec = multihost.run_host_loss_drill(str(tmp_path), subprocess_mode=True, hosts=2,
                                        requests=24, device="cuda", timeout_s=240.0)
    assert rec["dropped_requests"] == 0 and rec["mismatches"] == 0 and rec["errors"] == []
    assert rec["in_flight_at_kill"] >= 1
    for sc in rec["survivor_counters"].values():
        assert sc.get("dist_reform", 0) >= 1 and sc.get("host_reanchor", 0) >= 1
    assert rec["fleet"]["lost_hosts"] == 1
