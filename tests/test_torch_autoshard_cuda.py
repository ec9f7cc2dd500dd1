"""The placement search and the closed lifecycle of the port on the card:
a searched fit is bit-equal to the hand ladder for both block solvers, a
real out-of-memory error from the caching allocator at the head of the
searched ranking steps down to the next plan counted
(``autoshard_stepdown``), and a lifecycle hot-swap onto a CUDA-graph engine
answers bit-equal to an offline refit on the same data.

This file imports neither JAX nor the JAX package, so it runs on a machine
without them:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_autoshard_cuda.py``.
Tests that need the card carry the ``cuda`` marker and skip without one.
Every fit here searches and logs its outcome, so each test logs to a fresh
file (``tests/torch_plan_log.py``): the rankings are the untrained ones."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from keystone_tpu_torch.core import frontend as kfrontend
from keystone_tpu_torch.core import memory as kmem
from keystone_tpu_torch.core import serve as kserve
from keystone_tpu_torch.core.lifecycle import LifecycleConfig, LifecycleController
from keystone_tpu_torch.core.resilience import counters
from keystone_tpu_torch.ops.stats import StandardScalerModel
from keystone_tpu_torch.solvers.block import BlockLeastSquaresEstimator
from keystone_tpu_torch.solvers.weighted import BlockWeightedLeastSquaresEstimator
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401

TIERS = ["fused", "stepwise", "host_staged"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _problem(solver, dev):
    rng = np.random.default_rng(11)
    if solver == "bcd":
        x = rng.normal(size=(4096, 2048)).astype(np.float32) + 0.5
        y = rng.normal(size=(4096, 16)).astype(np.float32)
        est = lambda: BlockLeastSquaresEstimator(256, num_iter=2, lam=0.5)  # noqa: E731
    else:
        cls = rng.integers(0, 40, 2048)
        x = (rng.normal(size=(2048, 1024)) + 0.1 * cls[:, None]).astype(np.float32)
        y = (2.0 * np.eye(40)[cls] - 1.0).astype(np.float32)
        est = lambda: BlockWeightedLeastSquaresEstimator(256, 2, 0.1, 0.25)  # noqa: E731
    return torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev), est


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["bcd", "bwls"])
def test_searched_fit_is_bit_equal_to_the_hand_ladder(solver, cuda_device, monkeypatch):
    monkeypatch.delenv(kmem.HBM_BUDGET_ENV, raising=False)
    x, y, make = _problem(solver, cuda_device)
    hand = make().fit(x, y, plan=False)
    est = make()
    searched = est.fit(x, y, plan=True)
    placement = est.last_fit_report.placement
    print(json.dumps({"solver": solver, "ranking": placement["ranking"],
                      "chosen": placement["chosen"], "devices": placement["devices"],
                      "search_seconds": placement["search_seconds"],
                      "predicted_seconds": placement["predicted_seconds"],
                      "measured_seconds": placement["measured_seconds"]}))
    assert placement["devices"] == f"cuda x{torch.cuda.device_count()}"
    assert placement["ranking"] == TIERS and placement["chosen"] == "fused"
    assert placement["measured_seconds"] > 0
    for a, b in zip(searched.xs, hand.xs):
        assert torch.equal(a, b)
    assert torch.equal(searched.b, hand.b)


# Run in a fresh process: there the caching allocator holds only this
# scenario's tensors, so no segment another test left reserved can serve
# the allocation that must fail.
_OOM_SCENARIO = r"""
import json, os
import torch
from keystone_tpu_torch.core.resilience import counters
from keystone_tpu_torch.solvers.block import BlockLeastSquaresEstimator

os.environ.pop("KEYSTONE_HBM_BUDGET", None)
n, bs, nb, k = 32768, 1024, 8, 8
gen = torch.Generator(device="cuda").manual_seed(5)
blocks = [torch.randn((n, bs), generator=gen, device="cuda") for _ in range(nb)]
y = torch.randn((n, k), generator=gen, device="cuda")
ref = BlockLeastSquaresEstimator(bs, num_iter=1, lam=0.5).fit(blocks, y, plan=False)
torch.cuda.synchronize()
torch.cuda.empty_cache()
total = torch.cuda.get_device_properties(0).total_memory
headroom = nb * n * bs * 4 // 2  # half the concatenation the fused tier needs
torch.cuda.set_per_process_memory_fraction((torch.cuda.memory_reserved() + headroom) / total)
before = counters.get("autoshard_stepdown")
est = BlockLeastSquaresEstimator(bs, num_iter=1, lam=0.5)
model = est.fit(blocks, y, plan=True)
rep = est.last_fit_report
fused = [c for c in rep.placement["candidates"] if c["name"] == "fused"][0]
print(json.dumps({
    "ranking": rep.placement["ranking"], "chosen": rep.placement["chosen"],
    "oom_retries": rep.oom_retries, "fused_outcome": fused["outcome"],
    "stepdowns": counters.get("autoshard_stepdown") - before,
    "equal": all(torch.equal(a, b) for a, b in zip(model.xs, ref.xs))
             and torch.equal(model.b, ref.b),
}))
"""


@pytest.mark.cuda
def test_real_allocator_oom_at_the_ranked_head_steps_down_counted(cuda_device):
    """The searched head (fused) concatenates the caller's blocks; with the
    caching allocator capped a little above what is held, that allocation
    fails for real, and the fit steps down to the next ranked plan,
    counted, with the hand ladder's model."""
    root = Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": str(root)}
    env.pop(kmem.HBM_BUDGET_ENV, None)
    run = subprocess.run([sys.executable, "-c", _OOM_SCENARIO], capture_output=True,
                         text=True, timeout=600, env=env, cwd=root)
    assert run.returncode == 0, run.stderr[-4000:]
    rec = json.loads(run.stdout.strip().splitlines()[-1])
    print(json.dumps(rec))
    assert rec == {"ranking": TIERS, "chosen": "stepwise", "oom_retries": ["fused"],
                   "fused_outcome": "oom", "stepdowns": 1, "equal": True}


@pytest.mark.cuda
def test_lifecycle_swap_onto_a_graph_engine_answers_the_offline_refit(cuda_device, tmp_path):
    """A refit swapped in behind the router on the card: its engine's
    buckets are captured CUDA graphs, every answer is bit-equal to the
    offline refit pipeline's, and the refit ran on the incumbent's
    device."""
    rng = np.random.default_rng(20)
    d, k, rows = 512, 8, 4096
    mean = rng.normal(size=(d,)).astype(np.float32)
    t_old = rng.normal(size=(d, k)).astype(np.float32)
    t_new = rng.normal(size=(d, k)).astype(np.float32)
    x = rng.normal(size=(rows, d)).astype(np.float32)
    feats = x - mean
    featurizer = StandardScalerModel(torch.from_numpy(mean).to(cuda_device))

    def fit(labels, checkpoint=None):
        return BlockLeastSquaresEstimator(256, 1, 1e-3).fit(
            torch.from_numpy(feats).to(cuda_device),
            torch.from_numpy(labels).to(cuda_device), checkpoint=checkpoint)

    cfg = kserve.ServeConfig(buckets=(1, 4, 16), max_wait_ms=2.0)
    incumbent = kserve.ServingEngine(featurizer.then(fit(feats @ t_old)),
                                     np.zeros(d, np.float32), config=cfg, label="lc_card_inc")
    hx = rng.normal(size=(256, d)).astype(np.float32)
    hy = (hx - mean) @ t_new
    reqs = rng.normal(size=(48, d)).astype(np.float32)
    offline = featurizer.then(fit(feats @ t_new))(torch.from_numpy(reqs).to(cuda_device))

    def quality(predict, xx, yy):
        return -float(np.mean((np.asarray(predict(xx)) - yy) ** 2))

    before = counters.get("lifecycle_refit")
    with kfrontend.ShapeRouter(label="lc_card") as router:
        router.add_engine(incumbent)
        with LifecycleController(
            router, workdir=str(tmp_path / "wd"), featurizer=featurizer,
            fetch=lambda digest: (feats, feats @ t_new),
            estimator=lambda: BlockLeastSquaresEstimator(256, 1, 1e-3),
            assemble=lambda model: featurizer.then(model), holdout=lambda: (hx, hy),
            quality=quality, example=np.zeros(d, np.float32), label="lc_card",
            serve_config=cfg, config=LifecycleConfig(cooldown_s=0.0),
        ) as ctl:
            rec = ctl.run_refit(reason="operator")
        engine = router.server_for((d,)).engine
        answers = np.stack([router.submit(r).result(60.0) for r in reqs])
    print(json.dumps({k: rec.get(k) for k in ("outcome", "refit_wall_s", "validate_wall_s",
                                               "swap_wall_s", "quality")}))
    assert rec["outcome"] == "swapped", rec
    assert counters.get("lifecycle_refit") - before == 1
    assert engine.device.type == "cuda" and engine.label == rec["engine_label"]
    assert set(engine.buckets()) == {1, 4, 16}
    assert all(isinstance(g, kserve._GraphBucket) for g in engine._exec.values())
    assert np.array_equal(answers, offline.cpu().numpy())
