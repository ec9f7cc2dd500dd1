"""The solver ladder of the port (``keystone_tpu_torch.solvers.block`` and
``solvers.weighted``): fused -> stepwise -> host_staged, and the resumable
BCD state, against the JAX package's same tiers on the CPU.

The tier totals come from the estimators' own reports (fit under a roomy
``KEYSTONE_HBM_BUDGET``, read the chosen tier's total, pinch the budget
below it to expose the next tier's plan), so the tests hold behaviour, not
byte counts.  Each package walks its own totals; the JAX fits run the hand
ladder (``plan=False``).

Bars: the port's tiers agree with each other bit for bit where their
blocks hold the same values (fused and stepwise always; host-staged within
rtol 1e-5); a port tier against the JAX package's same tier within
rtol 1e-3, atol 1e-4·max for BCD (``tests/test_torch_solvers.py``'s block
bar) and rtol 1e-4, atol 1e-5·max for BWLS (``tests/test_torch_weighted.py``'s
bar)."""

import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.solvers import block as jblock
from keystone_tpu.solvers.block import BlockLeastSquaresEstimator as JaxBLS
from keystone_tpu.solvers.weighted import BlockWeightedLeastSquaresEstimator as JaxBWLS
from keystone_tpu_torch.core import memory as kmem
from keystone_tpu_torch.core.checkpoint import CheckpointError
from keystone_tpu_torch.core.resilience import counters
from keystone_tpu_torch.solvers import block as block_mod
from keystone_tpu_torch.solvers import weighted as weighted_mod
from keystone_tpu_torch.solvers.block import (
    BlockLeastSquaresEstimator,
    bcd_checkpoint_writer,
    load_bcd_checkpoint,
    save_bcd_checkpoint,
)
from keystone_tpu_torch.solvers.weighted import BlockWeightedLeastSquaresEstimator
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401

TIERS = ("fused", "stepwise", "host_staged")

# The wide-and-short BCD problem of tests/test_memory_plan.py: the fused
# footprint dominates the stepwise one, which dominates the host-staged one.
N, D, K, BS = 32, 1024, 16, 64
# The BWLS problem of tests/test_memory_plan.py::TestBwlsLadder.
BW_N, BW_D, BW_C, BW_BS = 96, 256, 8, 32


class _Killed(RuntimeError):
    """A simulated preemption between two blocks."""


def _bcd_problem(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(N, D)).astype(np.float32),
            rng.normal(size=(N, K)).astype(np.float32))


def _bwls_problem(seed=1):
    rng = np.random.default_rng(seed)
    cls = rng.integers(0, BW_C, BW_N)
    x = (rng.normal(size=(BW_N, BW_D)) + 0.1 * cls[:, None]).astype(np.float32)
    y = (2.0 * np.eye(BW_C)[cls] - 1.0).astype(np.float32)
    return x, y


def _port_bcd(a, b, **kw):
    est = BlockLeastSquaresEstimator(BS, num_iter=2, lam=0.5)
    return est, est.fit(torch.from_numpy(a) if isinstance(a, np.ndarray) else a,
                        torch.from_numpy(b), **kw)


def _port_bwls(x, y, **kw):
    est = BlockWeightedLeastSquaresEstimator(BW_BS, num_iter=2, lam=0.1, mixture_weight=0.5)
    return est, est.fit(torch.from_numpy(x) if isinstance(x, np.ndarray) else x,
                        torch.from_numpy(y), **kw)


def _jax_bcd(a, b):
    est = JaxBLS(BS, num_iter=2, lam=0.5)
    return est, est.fit(a, b, plan=False)


def _jax_bwls(x, y):
    est = JaxBWLS(BW_BS, num_iter=2, lam=0.1, mixture_weight=0.5)
    return est, est.fit(x, y, plan=False)


class _Budget:
    """``KEYSTONE_HBM_BUDGET`` for the length of a ``with`` block."""

    def __init__(self, value):
        self.value = str(value)

    def __enter__(self):
        self.saved = os.environ.get(kmem.HBM_BUDGET_ENV)
        os.environ[kmem.HBM_BUDGET_ENV] = self.value

    def __exit__(self, *exc):
        if self.saved is None:
            os.environ.pop(kmem.HBM_BUDGET_ENV, None)
        else:
            os.environ[kmem.HBM_BUDGET_ENV] = self.saved


def _walk_totals(fit) -> dict:
    """Each tier's planned total, walked down the ladder: ``fit()`` under a
    roomy budget, then under each total less one byte."""
    totals, budget = {}, "1G"
    for tier in TIERS:
        with _Budget(budget):
            est, _ = fit()
        totals[tier] = est.last_fit_report.plans[tier].total_bytes
        budget = totals[tier] - 1
    return totals


def _budget_for(totals: dict, tier: str) -> str:
    """A budget between ``tier``'s total and the next better tier's."""
    if tier == "fused":
        return "1G"
    better = TIERS[TIERS.index(tier) - 1]
    return str((totals[tier] + totals[better]) // 2)


@functools.lru_cache(maxsize=None)
def _totals(package: str, solver: str) -> dict:
    problem = _bcd_problem() if solver == "bcd" else _bwls_problem()
    fit = {("port", "bcd"): _port_bcd, ("port", "bwls"): _port_bwls,
           ("jax", "bcd"): _jax_bcd, ("jax", "bwls"): _jax_bwls}[package, solver]
    return _walk_totals(lambda: fit(*problem))


def _forced(package: str, solver: str, tier: str, *problem, totals=None, **kw):
    """Fit with the budget that selects ``tier`` (from ``totals``, by
    default the totals of the module's problem)."""
    fit = {("port", "bcd"): _port_bcd, ("port", "bwls"): _port_bwls,
           ("jax", "bcd"): _jax_bcd, ("jax", "bwls"): _jax_bwls}[package, solver]
    problem = problem or (_bcd_problem() if solver == "bcd" else _bwls_problem())
    totals = totals or _totals(package, solver)
    with _Budget(_budget_for(totals, tier)):
        est, model = fit(*problem, **kw)
    assert est.last_fit_report.chosen == tier
    assert list(est.last_fit_report.denials) == list(TIERS[: TIERS.index(tier)])
    return est, model


def _weights(model) -> np.ndarray:
    return np.concatenate([np.asarray(x) for x in model.xs])


def _assert_models_equal(got, want):
    assert len(got.xs) == len(want.xs)
    assert all(torch.equal(a, b) for a, b in zip(got.xs, want.xs))
    assert torch.equal(got.b, want.b)


# -- BCD: selection -----------------------------------------------------------


@pytest.mark.parametrize("case", ["generous", "deny_fused", "deny_device_tiers",
                                  "floor_denied"])
def test_bcd_budget_selects_the_tier(case):
    """A roomy budget admits fused and plans nothing below it; a budget
    between two totals selects the lower tier with the denials listed; the
    floor runs when it is denied too."""
    a, b = _bcd_problem()
    totals = _totals("port", "bcd")
    assert totals["host_staged"] < totals["stepwise"] < totals["fused"]
    if case == "floor_denied":
        before = counters.get("hbm_preflight_denied")
        with _Budget(1000):
            est, model = _port_bcd(a, b)
        assert est.last_fit_report.chosen == "host_staged"
        # The search's analytic prune denies the three tiers, then the
        # floor's own preflight denies it again (the JAX package's count).
        assert counters.get("hbm_preflight_denied") == before + 4
        assert all(bool(torch.isfinite(x).all()) for x in model.xs)
        return
    tier = {"generous": "fused", "deny_fused": "stepwise",
            "deny_device_tiers": "host_staged"}[case]
    est, _ = _forced("port", "bcd", tier)
    assert list(est.last_fit_report.plans) == list(TIERS[: TIERS.index(tier) + 1])


@pytest.mark.parametrize("form", ["monolithic", "block_list", "short_last_block"])
def test_bcd_tiers_agree(form):
    """Fused and stepwise give the same bits; host-staged is within
    rtol 1e-5 (on the CPU its blocks are the same values, so it is equal
    too)."""
    a, b = _bcd_problem()
    feats = torch.from_numpy(a)
    feats = {"monolithic": feats, "block_list": list(torch.split(feats, 100, dim=1)),
             "short_last_block": feats[:, :1000]}[form]
    totals = _walk_totals(lambda: _port_bcd(feats, b))
    models = {tier: _forced("port", "bcd", tier, feats, b, totals=totals)[1] for tier in TIERS}
    _assert_models_equal(models["stepwise"], models["fused"])
    for x, y in zip(models["host_staged"].xs, models["fused"].xs):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5 * float(y.abs().max()))


@pytest.mark.parametrize("tier", TIERS)
def test_bcd_tier_matches_the_jax_tier(tier):
    a, b = _bcd_problem()
    _, got = _forced("port", "bcd", tier)
    _, want = _forced("jax", "bcd", tier)
    w = _weights(want)
    np.testing.assert_allclose(_weights(got), w, rtol=1e-3, atol=1e-4 * np.abs(w).max())
    np.testing.assert_allclose(got.b.numpy(), np.asarray(want.b), rtol=1e-5, atol=1e-6)
    scores = np.asarray(want(jnp.asarray(a)))
    np.testing.assert_allclose(got(torch.from_numpy(a)).numpy(), scores, rtol=1e-3,
                               atol=1e-4 * np.abs(scores).max())


# -- BCD: out-of-memory handling ------------------------------------------------


def _oom_once(calls: dict, real=None):
    def boom(*args, **kw):
        calls["n"] += 1
        if calls["n"] == 1 or real is None:
            raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
        return real(*args, **kw)

    return boom


@pytest.mark.parametrize("case", ["oom_steps_down_one_tier", "non_oom_propagates",
                                  "oom_on_the_floor_raises", "lost_source_raises"])
def test_bcd_ladder_never_falls_back_silently(case, monkeypatch):
    monkeypatch.delenv(kmem.HBM_BUDGET_ENV, raising=False)
    a, b = _bcd_problem()
    _, clean = _port_bcd(a, b)
    if case == "oom_steps_down_one_tier":
        before = counters.get("solver_oom_retry")
        monkeypatch.setattr(block_mod, "_fused_bcd_impl", _oom_once({"n": 0}))
        est, model = _port_bcd(a, b)
        assert est.last_fit_report.oom_retries == ["fused"]
        assert est.last_fit_report.chosen == "stepwise"
        assert counters.get("solver_oom_retry") == before + 1
        _assert_models_equal(model, clean)
    elif case == "non_oom_propagates":
        def wrong(*args, **kw):
            raise ValueError("not a memory problem")

        monkeypatch.setattr(block_mod, "_fused_bcd_impl", wrong)
        with pytest.raises(ValueError, match="not a memory problem"):
            _port_bcd(a, b)
    elif case == "oom_on_the_floor_raises":
        for name in ("_fused_bcd_impl", "_bcd_block_solve"):
            monkeypatch.setattr(block_mod, name, _oom_once({"n": 0}))
        with pytest.raises(torch.OutOfMemoryError):
            _port_bcd(a, b)
    else:
        feats = torch.from_numpy(a).clone()
        feats.untyped_storage().resize_(0)
        with pytest.raises(kmem.LadderSourceLost):
            _port_bcd(feats, b)


@pytest.mark.parametrize("est", [BlockLeastSquaresEstimator(BS, 1, 0.5),
                                 BlockWeightedLeastSquaresEstimator(BW_BS, 1, 0.1, 0.5)],
                         ids=["bcd", "bwls"])
@pytest.mark.parametrize("plan", [True, ["fused"]], ids=["true", "plan_list"])
def test_placement_plan_is_refused(est, plan):
    """``plan=True`` and a name list were refused until the placement
    search was ported; as in the JAX package they now run the search and
    fit the hand ladder's model (the named tier first)."""
    x, y = _bwls_problem()
    hand = est.fit(torch.from_numpy(x), torch.from_numpy(y), plan=False)
    assert est.last_fit_report.placement is None
    searched = est.fit(torch.from_numpy(x), torch.from_numpy(y), plan=plan)
    placement = est.last_fit_report.placement
    assert placement["ranking"] == list(TIERS)
    assert placement["chosen"] == est.last_fit_report.chosen == "fused"
    _assert_models_equal(searched, hand)


# -- BCD: the resumable state (the counterparts of TestResumableBCD) ----------


def _resume_data(seed=3, n=96, d=22, k=3):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)),
            torch.from_numpy(rng.normal(size=(n, k)).astype(np.float32)))


def _killer(write, after: int):
    fired = []

    def cb(state):
        write(state)
        fired.append((state["epoch"], state["block"]))
        if len(fired) == after:
            raise _Killed(f"preempted after block {state['block']}")

    return cb


def test_stepwise_writes_a_state_per_block_and_equals_fused():
    x, y = _resume_data()
    est = BlockLeastSquaresEstimator(block_size=6, num_iter=2, lam=0.05)
    fused = est.fit(x, y)
    seen = []
    stepwise = est.fit(x, y, checkpoint=seen.append)
    assert est.last_fit_report.chosen == "stepwise[checkpoint]"
    # one state per (epoch, block): ceil(22/6) = 4 blocks x 2 epochs
    assert [(s["epoch"], s["block"]) for s in seen] == [(e, i) for e in (0, 1) for i in range(4)]
    _assert_models_equal(stepwise, fused)


def test_interrupted_fit_resumes_from_disk(tmp_path):
    x, y = _resume_data()
    est = BlockLeastSquaresEstimator(block_size=6, num_iter=2, lam=0.05)
    fused = est.fit(x, y)
    path = str(tmp_path / "bcd_state")
    with pytest.raises(_Killed):
        est.fit(x, y, checkpoint=_killer(bcd_checkpoint_writer(path), 3))
    state = load_bcd_checkpoint(path)
    assert (state["epoch"], state["block"]) == (0, 2)
    resumed = est.fit(x, y, checkpoint=path, resume_from=path)
    _assert_models_equal(resumed, fused)


@pytest.mark.parametrize("other", ["block_size", "lam", "num_iter", "data"])
def test_resume_refuses_another_fit(other, tmp_path):
    x, y = _resume_data()
    path = str(tmp_path / "bcd_state")
    with pytest.raises(_Killed):
        BlockLeastSquaresEstimator(6, 2, 0.05).fit(
            x, y, checkpoint=_killer(lambda s: save_bcd_checkpoint(path, s), 1))
    est = {"block_size": BlockLeastSquaresEstimator(9, 2, 0.05),
           "lam": BlockLeastSquaresEstimator(6, 2, 0.5),
           "num_iter": BlockLeastSquaresEstimator(6, 3, 0.05),
           "data": BlockLeastSquaresEstimator(6, 2, 0.05)}[other]
    match = {"block_size": "widths", "lam": "lam", "num_iter": "num_iter",
             "data": "DIFFERENT data"}[other]
    with pytest.raises(CheckpointError, match=match):
        est.fit(x * 2.0 if other == "data" else x, y, resume_from=path)


def test_completed_state_resume_is_idempotent(tmp_path):
    x, y = _resume_data()
    est = BlockLeastSquaresEstimator(block_size=6, num_iter=1, lam=0.05)
    path = str(tmp_path / "bcd_state")
    first = est.fit(x, y, checkpoint=path)
    again = est.fit(x, y, checkpoint=path, resume_from=path)
    _assert_models_equal(again, first)


def test_state_file_has_the_jax_keys_and_dtypes(tmp_path):
    x, y = _resume_data()
    mine, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    BlockLeastSquaresEstimator(6, 1, 0.05).fit(x, y, checkpoint=mine)
    JaxBLS(6, 1, 0.05).fit(jnp.asarray(x.numpy()), jnp.asarray(y.numpy()), checkpoint=theirs)
    with np.load(mine + ".npz") as a, np.load(theirs + ".npz") as b:
        assert a.files == b.files
        assert {k: a[k].dtype for k in a.files} == {k: b[k].dtype for k in b.files}
        assert {k: a[k].shape for k in a.files} == {k: b[k].shape for k in b.files}


# -- BCD: each package resumes the other's interrupted fit --------------------


def _bcd_bar(got, want):
    w = _weights(want)
    np.testing.assert_allclose(_weights(got), w, rtol=1e-3, atol=1e-4 * np.abs(w).max())
    np.testing.assert_allclose(np.asarray(got.b), np.asarray(want.b), rtol=1e-5, atol=1e-6)


def test_port_resumes_a_state_the_jax_package_wrote(tmp_path):
    x, y = _resume_data()
    xj, yj = jnp.asarray(x.numpy()), jnp.asarray(y.numpy())
    path = str(tmp_path / "jax_state")
    whole = JaxBLS(6, 2, 0.05).fit(xj, yj)
    with pytest.raises(_Killed):
        JaxBLS(6, 2, 0.05).fit(xj, yj, checkpoint=_killer(jblock.bcd_checkpoint_writer(path), 3))
    resumed = BlockLeastSquaresEstimator(6, 2, 0.05).fit(x, y, resume_from=path)
    _bcd_bar(resumed, whole)


def test_jax_package_resumes_a_state_the_port_wrote(tmp_path):
    x, y = _resume_data()
    path = str(tmp_path / "port_state")
    whole = BlockLeastSquaresEstimator(6, 2, 0.05).fit(x, y)
    with pytest.raises(_Killed):
        BlockLeastSquaresEstimator(6, 2, 0.05).fit(
            x, y, checkpoint=_killer(bcd_checkpoint_writer(path), 5))
    state = jblock.load_bcd_checkpoint(path)
    assert (state["epoch"], state["block"]) == (1, 0)
    resumed = JaxBLS(6, 2, 0.05).fit(jnp.asarray(x.numpy()), jnp.asarray(y.numpy()),
                                     resume_from=path)
    _bcd_bar(resumed, whole)


# -- BWLS ---------------------------------------------------------------------


def test_bwls_budget_walks_the_ladder_and_the_tiers_agree():
    totals = _totals("port", "bwls")
    assert totals["host_staged"] < totals["stepwise"] < totals["fused"]
    models = {tier: _forced("port", "bwls", tier)[1] for tier in TIERS}
    _assert_models_equal(models["stepwise"], models["fused"])
    for x, y in zip(models["host_staged"].xs, models["fused"].xs):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5 * float(y.abs().max()))


@pytest.mark.parametrize("tier", TIERS)
def test_bwls_tier_matches_the_jax_tier(tier):
    _, got = _forced("port", "bwls", tier)
    _, want = _forced("jax", "bwls", tier)
    for g, w in ((_weights(got), _weights(want)), (got.b.numpy(), np.asarray(want.b))):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5 * np.abs(w).max())


def test_bwls_oom_steps_down_one_tier(monkeypatch):
    monkeypatch.delenv(kmem.HBM_BUDGET_ENV, raising=False)
    x, y = _bwls_problem()
    _, clean = _port_bwls(x, y)
    monkeypatch.setattr(weighted_mod, "_fused_bwls_impl", _oom_once({"n": 0}))
    est, model = _port_bwls(x, y)
    assert est.last_fit_report.oom_retries == ["fused"]
    assert est.last_fit_report.chosen == "stepwise"
    _assert_models_equal(model, clean)


@pytest.mark.parametrize("tier", TIERS)
def test_bwls_donate_frees_the_callers_inputs(tier):
    x, y = _bwls_problem()
    _, clean = _forced("port", "bwls", tier)
    xd, yd = torch.from_numpy(x).clone(), torch.from_numpy(y).clone()
    est = BlockWeightedLeastSquaresEstimator(BW_BS, num_iter=2, lam=0.1, mixture_weight=0.5)
    with _Budget(_budget_for(_totals("port", "bwls"), tier)):
        model = est.fit(xd, yd, donate=True)
    assert est.last_fit_report.chosen == tier
    assert xd.untyped_storage().nbytes() == 0 and yd.untyped_storage().nbytes() == 0
    _assert_models_equal(model, clean)
