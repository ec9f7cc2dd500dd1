"""The solver ladder of the port on the card: the tiers of the block
solvers agree, the host-staged tier keeps one block of the matrix on the
card, and a real out-of-memory error from the caching allocator steps the
BCD ladder down one tier.

This file imports neither JAX nor the JAX package, so it runs on a machine
without them:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_solver_ladder_cuda.py``.
Tests that need the card carry the ``cuda`` marker and skip without one.

Bars: fused and stepwise ``torch.equal`` (same arithmetic on the same
layouts); host-staged within rtol 1e-5, atol 1e-5·max of the fused fit
(its blocks are uploaded copies, which cuBLAS may reduce in another
order); the host-staged peak above what it started with no larger than
the reckoning below plus 8 MiB of allocator slack."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from keystone_tpu_torch.core import memory as kmem
from keystone_tpu_torch.solvers import block as block_mod
from keystone_tpu_torch.solvers.block import BlockLeastSquaresEstimator
from keystone_tpu_torch.solvers.weighted import BlockWeightedLeastSquaresEstimator
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401


TIERS = ("fused", "stepwise", "host_staged")
SLACK = 8 * 2**20


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def budget(monkeypatch):
    def set_budget(value):
        if value is None:
            monkeypatch.delenv(kmem.HBM_BUDGET_ENV, raising=False)
        else:
            monkeypatch.setenv(kmem.HBM_BUDGET_ENV, str(value))

    return set_budget


def _bcd_problem(dev, n=4096, d=2048, k=16, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((n, d), generator=gen, device=dev) + 0.5
    y = torch.randn((n, k), generator=gen, device=dev)
    return x, y


def _bwls_problem(dev, n=2048, d=1024, c=40, seed=1):
    rng = np.random.default_rng(seed)
    cls = rng.integers(0, c, n)
    x = torch.from_numpy((rng.normal(size=(n, d)) + 0.1 * cls[:, None]).astype(np.float32))
    y = torch.from_numpy((2.0 * np.eye(c)[cls] - 1.0).astype(np.float32))
    return x.to(dev), y.to(dev)


def _estimator(solver):
    if solver == "bcd":
        return BlockLeastSquaresEstimator(256, num_iter=2, lam=0.5)
    return BlockWeightedLeastSquaresEstimator(256, num_iter=2, lam=0.1, mixture_weight=0.25)


def _fit_each_tier(solver, x, y, budget) -> dict:
    """The fit under each tier, forced by the capacity budget read from the
    reports: roomy, then between fused's and stepwise's totals, then below
    stepwise's (with the inputs on the card the host-staged total is not
    below stepwise's, so the floor runs denied)."""
    models = {}
    budget("64G")
    est = _estimator(solver)
    models["fused"] = est.fit(x, y)
    fused_total = est.last_fit_report.plans["fused"].total_bytes
    budget(fused_total - 1)
    est = _estimator(solver)
    est.fit(x, y)
    step_total = est.last_fit_report.plans["stepwise"].total_bytes
    for tier, value in (("stepwise", (fused_total + step_total) // 2),
                        ("host_staged", step_total - 1)):
        budget(value)
        est = _estimator(solver)
        models[tier] = est.fit(x, y)
        assert est.last_fit_report.chosen == tier
        assert est.last_fit_report.denials == list(TIERS[: TIERS.index(tier)])
    return models


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["bcd", "bwls"])
def test_tiers_agree_on_the_card(solver, cuda_device, budget):
    x, y = (_bcd_problem if solver == "bcd" else _bwls_problem)(cuda_device)
    models = _fit_each_tier(solver, x, y, budget)
    for a, b in zip(models["stepwise"].xs, models["fused"].xs):
        assert torch.equal(a, b)
    assert torch.equal(models["stepwise"].b, models["fused"].b)
    for a, b in zip(models["host_staged"].xs, models["fused"].xs):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * float(b.abs().max()))


@pytest.mark.cuda
def test_host_staged_keeps_one_block_on_the_card(cuda_device, budget, monkeypatch):
    """The caller's card blocks are donated (freed once on the host); from
    then on the card holds one [N, bs] block and its centred copy beside
    the residual, the models and the cached means and factors."""
    n, bs, nb, k = 32768, 512, 16, 8
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    blocks = [torch.randn((n, bs), generator=gen, device=cuda_device) for _ in range(nb)]
    y = torch.randn((n, k), generator=gen, device=cuda_device)
    budget("64G")
    ref = BlockLeastSquaresEstimator(bs, num_iter=2, lam=0.5).fit(blocks, y)

    seen = {}
    real = block_mod._host_staged_bcd_fit

    def measured(*args, **kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        seen["entry"] = torch.cuda.memory_allocated()
        out = real(*args, **kw)
        torch.cuda.synchronize()
        seen["peak"] = torch.cuda.max_memory_allocated()
        return out

    monkeypatch.setattr(block_mod, "_host_staged_bcd_fit", measured)
    budget(1)  # every tier denied: the floor runs
    donated = [b.clone() for b in blocks]
    est = BlockLeastSquaresEstimator(bs, num_iter=2, lam=0.5)
    model = est.fit(donated, y, donate=True)
    assert est.last_fit_report.chosen == "host_staged"
    assert all(b.untyped_storage().nbytes() == 0 for b in donated)
    it = 4
    reckoning = it * (
        2 * n * bs  # the uploaded block and its centred copy
        + nb * bs * bs + nb * bs * k + nb * bs  # cached factors, models, means
        + 4 * bs * bs + 4 * bs * k + 6 * n * k  # the gram and its shift, a step's vectors
    )
    log = (f"host-staged peak above entry {seen['peak'] - seen['entry']} B, "
           f"reckoning {reckoning} B, one block {it * n * bs} B")
    print(log)
    assert seen["peak"] - seen["entry"] <= reckoning + SLACK, log
    for a, b in zip(model.xs, ref.xs):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * float(b.abs().max()))


# Run in a fresh process: there the caching allocator holds only this
# scenario's tensors, so no segment another test left reserved can serve
# the allocation that must fail.
_OOM_SCENARIO = r"""
import json, os
import torch
from keystone_tpu_torch.solvers.block import BlockLeastSquaresEstimator

os.environ.pop("KEYSTONE_HBM_BUDGET", None)
n, bs, nb, k = 32768, 1024, 8, 8
gen = torch.Generator(device="cuda").manual_seed(5)
blocks = [torch.randn((n, bs), generator=gen, device="cuda") for _ in range(nb)]
y = torch.randn((n, k), generator=gen, device="cuda")
ref = BlockLeastSquaresEstimator(bs, num_iter=1, lam=0.5).fit(blocks, y)
torch.cuda.synchronize()
torch.cuda.empty_cache()
total = torch.cuda.get_device_properties(0).total_memory
headroom = nb * n * bs * 4 // 2  # half the concatenation the fused tier needs
torch.cuda.set_per_process_memory_fraction((torch.cuda.memory_reserved() + headroom) / total)
est = BlockLeastSquaresEstimator(bs, num_iter=1, lam=0.5)
model = est.fit(blocks, y)
rep = est.last_fit_report
print(json.dumps({
    "fused_admitted": rep.plans["fused"].admitted, "oom_retries": rep.oom_retries,
    "chosen": rep.chosen,
    "equal": all(torch.equal(a, b) for a, b in zip(model.xs, ref.xs))
             and torch.equal(model.b, ref.b),
}))
"""


@pytest.mark.cuda
def test_real_allocator_oom_steps_down_one_tier(cuda_device):
    """The fused tier concatenates the caller's blocks (another copy of
    them); with the caching allocator capped a little above what is held,
    that allocation fails for real, and the stepwise tier, which walks the
    caller's blocks, fits the same model.  No budget override: the live
    preflight admits the fused tier."""
    root = Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": str(root)}
    env.pop(kmem.HBM_BUDGET_ENV, None)
    run = subprocess.run([sys.executable, "-c", _OOM_SCENARIO], capture_output=True,
                         text=True, timeout=600, env=env, cwd=root)
    assert run.returncode == 0, run.stderr[-4000:]
    rec = json.loads(run.stdout.strip().splitlines()[-1])
    assert rec == {"fused_admitted": True, "oom_retries": ["fused"], "chosen": "stepwise",
                   "equal": True}, rec
