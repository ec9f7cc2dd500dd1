"""The class-weighted solver's mesh tier (``keystone_tpu_torch.solvers.weighted``)
against the port's single-device fits and the JAX package's mesh fits
(``tests/test_distributed.py``, ``tests/test_weighted_solver.py``).

A mesh here is 8 slots of the one CPU (``make_mesh(4, 2, devices=[cpu] *
8)`` and ``(8, 1)``); the JAX side runs on the conftest's 8 virtual CPU
devices.  Inputs are seeded numpy.

Bars: against the JAX package's mesh fit, 1e-3 (``about_eq``), its own
mesh-against-local bar; against the port's local fit at the same
``class_chunk``, rtol 1e-4, atol 1e-5·max (the BWLS bar); a 1x1 mesh, the
row-sharded inputs and the regroup are held bit for bit.  The conditioning
rows match the JAX package's labels and sample sizes exactly and their κ
within rtol 1e-4 (``tests/test_torch_numerics.py``'s bar for the
estimator)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.core import numerics as jnum
from keystone_tpu.parallel.mesh import padded_shard_rows as jax_padded_shard_rows
from keystone_tpu.solvers.weighted import BlockWeightedLeastSquaresEstimator as JaxBWLS
from keystone_tpu.utils.stats import about_eq
from keystone_tpu_torch.core import memory as kmem
from keystone_tpu_torch.core import numerics as knum
from keystone_tpu_torch.core.resilience import counters
from keystone_tpu_torch.parallel.collectives import exchange_rows
from keystone_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    make_mesh,
    mesh_desc,
    padded_shard_rows,
    use_mesh,
)
from keystone_tpu_torch.solvers import weighted
from keystone_tpu_torch.solvers.weighted import (
    BlockWeightedLeastSquaresEstimator,
    _RegroupPlan,
    _SolveCtx,
)
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401

CPU = torch.device("cpu")
EST = dict(block_size=8, num_iter=2, lam=0.1, mixture_weight=0.4)


def _mesh(data, model):
    return make_mesh(data, model, devices=[CPU] * (data * model))


def _problem(rng, n, d, k):
    labels_int = rng.integers(0, k, size=n)
    feats = rng.normal(size=(n, d)).astype(np.float32)
    labels = (2.0 * np.eye(k)[labels_int] - 1.0).astype(np.float32)
    return feats, labels


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _close(got, want):
    """rtol 1e-4, atol 1e-5·max of ``want``."""
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5 * want.abs().max().item())


def _fit_models(model):
    return [*model.xs, model.b]


# -- the fits against the local fit and the JAX package -------------------------


def test_bwls_mesh42_matches_local_and_jax(rng, mesh42):
    feats, labels = _problem(rng, 120, 18, 5)
    local = BlockWeightedLeastSquaresEstimator(**EST, class_chunk=4).fit(*_t(feats, labels))
    est = BlockWeightedLeastSquaresEstimator(**EST, class_chunk=4, mesh=_mesh(4, 2))
    sharded = est.fit(*_t(feats, labels))
    assert est.last_fit_report.chosen == "fused[mesh 4x2]"
    assert est.last_fit_report.mesh_shape == {DATA_AXIS: 4, MODEL_AXIS: 2}
    jax = JaxBWLS(**EST, class_chunk=4, mesh=mesh42).fit(feats, labels)
    for s, lo, j in zip(_fit_models(sharded), _fit_models(local), [*jax.xs, jax.b]):
        _close(s, lo)
        assert about_eq(s.numpy(), np.asarray(j), 1e-3)
    x = torch.from_numpy(feats)
    assert about_eq(sharded(x).numpy(), np.asarray(jax(jnp.asarray(feats))), 1e-3)


def test_row_sharded_inputs_with_nvalid_match_host_inputs_and_jax(rng, mesh42):
    """n = 117 leaves pad rows on the 4-way data axis: they must stay out of
    the class grouping."""
    feats, labels = _problem(rng, 117, 16, 4)
    mesh = _mesh(4, 2)
    host = BlockWeightedLeastSquaresEstimator(**EST, class_chunk=4, mesh=mesh).fit(
        *_t(feats, labels))
    xs, nvalid = padded_shard_rows(feats, mesh)
    ys, _ = padded_shard_rows(labels, mesh)
    assert nvalid == 117 and xs.rows == 120
    sharded = BlockWeightedLeastSquaresEstimator(**EST, class_chunk=4, mesh=mesh).fit(
        xs, ys, nvalid=nvalid)
    assert all(torch.equal(s, h) for s, h in zip(_fit_models(sharded), _fit_models(host)))
    jx, jn = jax_padded_shard_rows(feats, mesh42)
    jy, _ = jax_padded_shard_rows(labels, mesh42)
    jax = JaxBWLS(**EST, class_chunk=4, mesh=mesh42).fit(jx, jy, nvalid=jn)
    for s, j in zip(_fit_models(sharded), [*jax.xs, jax.b]):
        assert about_eq(s.numpy(), np.asarray(j), 1e-3)
    with pytest.raises(TypeError, match="need a mesh"):
        BlockWeightedLeastSquaresEstimator(**EST).fit(xs, ys)


@pytest.mark.parametrize("sharded", [False, True], ids=["tensors", "row_sharded"])
def test_one_by_one_mesh_is_the_fused_tier_bit_for_bit(rng, sharded):
    feats, labels = _problem(rng, 117, 20, 6)
    x, y = _t(feats, labels)
    fused = BlockWeightedLeastSquaresEstimator(**EST, class_chunk=4)
    want = fused.fit(x, y, plan=False)
    assert fused.last_fit_report.chosen == "fused"
    mesh = _mesh(1, 1)
    if sharded:
        x, y = padded_shard_rows(x, mesh)[0], padded_shard_rows(y, mesh)[0]
    est = BlockWeightedLeastSquaresEstimator(**EST, class_chunk=4, mesh=mesh)
    got = est.fit(x, y)
    assert est.last_fit_report.chosen == "fused[mesh 1x1]"
    assert all(torch.equal(g, w) for g, w in zip(_fit_models(got), _fit_models(want)))


def test_ambient_mesh_is_picked_up(rng):
    feats, labels = _problem(rng, 96, 16, 4)
    est = BlockWeightedLeastSquaresEstimator(**EST, class_chunk=2)
    with use_mesh(_mesh(8, 1)):
        est.fit(*_t(feats, labels))
    assert est.last_fit_report.chosen == "fused[mesh 8x1]"


# -- the class regroup -----------------------------------------------------------


@pytest.mark.parametrize("class_sorted", [False, True], ids=["usable", "skewed"])
def test_regroup_is_the_single_device_sort(rng, class_sorted):
    """The regrouped rows are the single-device sort's on the true rows and
    zero on the tail, through the exchange (random class order) and
    through the chunked gather (class-sorted input: the skew guard)."""
    n, k, data = 61, 5, 4
    class_idx = rng.integers(0, k, n)
    if class_sorted:
        class_idx = np.sort(class_idx)
    x = torch.from_numpy(rng.normal(size=(n, 700)).astype(np.float32))  # > one column chunk
    mesh = _mesh(data, 1)
    ctx = _SolveCtx.of(class_idx, k, torch.float32, 0.4, 4, CPU, data=data)
    assert ctx.p_tot % data == 0 and ctx.p_tot >= n + ctx.n_max
    sh, _ = padded_shard_rows(x, mesh)
    before = counters.snapshot().get("bwls_regroup_skew_fallback", 0)
    blocks = ctx.regroup(sh.data_blocks(), [CPU] * data)
    plan = ctx.regroup_plans[sh.rows]
    assert plan.usable is not class_sorted
    assert (plan.send is None) is class_sorted
    fallbacks = counters.snapshot().get("bwls_regroup_skew_fallback", 0) - before
    assert fallbacks == int(class_sorted)
    got = torch.cat(blocks)
    want = _SolveCtx.of(class_idx, k, torch.float32, 0.4, 4, CPU).sort_pad(x)
    assert torch.equal(got[:n], want[:n])
    assert torch.equal(got[n:], torch.zeros_like(got[n:]))


def test_regroup_plan_matches_the_jax_host_sort(rng):
    """The JAX package's case: n 37 true rows of 40, 48 output rows."""
    n, n_src, cols, d = 37, 40, 5, 4
    x = rng.normal(size=(n_src, cols)).astype(np.float32)
    order = np.argsort(rng.integers(0, 6, n), kind="stable")
    expect = np.zeros((48, cols), np.float32)
    expect[:n] = x[order]
    plan = _RegroupPlan(order, n_src, 48, d)
    assert plan.usable
    blocks = [torch.from_numpy(b) for b in np.split(x, d)]
    got = exchange_rows(blocks, [CPU] * d, plan.send, plan.recv)
    np.testing.assert_array_equal(torch.cat(got).numpy(), expect)


# -- the mesh ladder ---------------------------------------------------------------


def _oom_on(monkeypatch, shapes):
    """Inject an out-of-memory error at ``_execute_fused_bwls_mesh`` on the
    meshes whose shape is in ``shapes``."""
    real = weighted._execute_fused_bwls_mesh
    seen = []

    def execute(plan, xs, ys, ctx, mesh, *args):
        seen.append(mesh_desc(mesh))
        if seen[-1] in shapes:
            raise torch.OutOfMemoryError(f"CUDA out of memory (injected on mesh {seen[-1]})")
        return real(plan, xs, ys, ctx, mesh, *args)

    monkeypatch.setattr(weighted, "_execute_fused_bwls_mesh", execute)
    return seen


@pytest.mark.parametrize("shapes, chosen", [
    ({"4x2"}, "fused[mesh 8x1]"),
    ({"4x2", "8x1"}, "single_device/fused"),
], ids=["reduced_mesh", "single_device"])
def test_hand_ladder_steps_down_one_tier_at_a_time(rng, monkeypatch, shapes, chosen):
    feats, labels = _problem(rng, 100, 16, 4)
    x, y = _t(feats, labels)
    local = BlockWeightedLeastSquaresEstimator(**EST).fit(x, y, plan=False)
    seen = _oom_on(monkeypatch, shapes)
    before = counters.snapshot().get("solver_oom_retry", 0)
    est = BlockWeightedLeastSquaresEstimator(**EST, mesh=_mesh(4, 2))
    model = est.fit(x, y, plan=False)
    rep = est.last_fit_report
    assert seen == ["4x2", "8x1"][: len(shapes) + (chosen != "single_device/fused")]
    assert rep.oom_retries == [f"fused[mesh {s}]" for s in ("4x2", "8x1") if s in shapes]
    assert rep.chosen == chosen
    assert counters.snapshot()["solver_oom_retry"] - before == len(shapes)
    if chosen.startswith("single_device"):
        # The floor refits the true rows on one device: the local fit's bits.
        assert rep.mesh_shape is None
        assert all(torch.equal(m, w) for m, w in zip(_fit_models(model), _fit_models(local)))
    else:
        assert rep.mesh_shape == {DATA_AXIS: 8, MODEL_AXIS: 1}


def test_per_slot_admission_denies_mesh_tiers_the_whole_device_would_fit(rng, monkeypatch):
    """Each mesh tier's per-slot charge fits the device's budget but not an
    eighth of it, so both are denied and the floor runs."""
    feats, labels = _problem(rng, 100, 16, 4)
    x, y = _t(feats, labels)
    est = BlockWeightedLeastSquaresEstimator(**EST, mesh=_mesh(4, 2))
    monkeypatch.setenv(kmem.HBM_BUDGET_ENV, "1")  # every tier denied: read the charges
    est.fit(x, y, plan=False)
    charges = {name: est.last_fit_report.plans[name].total_bytes
               for name in ("fused[mesh 4x2]", "fused[mesh 8x1]")}
    assert charges["fused[mesh 8x1]"] < charges["fused[mesh 4x2]"]
    budget = 8 * min(charges.values()) - 8
    monkeypatch.setenv(kmem.HBM_BUDGET_ENV, str(budget))
    est.fit(x, y, plan=False)
    rep = est.last_fit_report
    for name, total in charges.items():
        plan = rep.plans[name]
        assert plan.budget_bytes == budget // 8 and plan.total_bytes == total <= budget
        assert not plan.admitted
    assert rep.denials[:2] == ["fused[mesh 4x2]", "fused[mesh 8x1]"]
    assert rep.chosen.startswith("single_device/")


def test_searched_ladder_walks_every_factorization_before_the_floor(rng, monkeypatch):
    feats, labels = _problem(rng, 100, 16, 4)
    seen = _oom_on(monkeypatch, {"4x2", "8x1", "2x4", "1x8"})
    est = BlockWeightedLeastSquaresEstimator(**EST, mesh=_mesh(4, 2))
    est.fit(*_t(feats, labels), plan=True)
    placement = est.last_fit_report.placement
    # Every factorization in the default layout, then the spec candidates
    # of each mesh shape (they die on the same meshes; the wide-class one
    # where the 4 classes divide the model axis), then the floor.
    ranking = placement["ranking"]
    assert ranking[:4] == ["fused[mesh 4x2]", "fused[mesh 8x1]", "fused[mesh 2x4]",
                           "fused[mesh 1x8]"]
    assert ranking[4:-1] == [f"fused[mesh {d}x{m}|{tag}]"
                             for d, m in ((4, 2), (8, 1), (2, 4), (1, 8))
                             for tag in ("labels=model@dim1", "labels=rep")
                             if tag == "labels=rep" or (m > 1 and 4 % m == 0)]
    assert ranking[-1] == "single_device"
    assert seen == [name[len("fused[mesh "):][:3] for name in ranking[:-1]]
    assert est.last_fit_report.chosen == "single_device/fused"
    assert placement["devices"] == "cpu x8 on 1"


# -- the conditioning probe -----------------------------------------------------------


def test_conditioning_rows_match_jax_on_one_device_and_on_a_mesh(rng, mesh42, monkeypatch):
    feats, labels = _problem(rng, 120, 20, 4)
    for mod in (knum, jnum):
        monkeypatch.setenv(mod.NUMERICS_ENV, "1")
        mod.reset_state()
    x, y = _t(feats, labels)
    try:
        jax = JaxBWLS(**EST)
        jax.fit(feats, labels)
        want = jax.last_fit_report.conditioning
        for mesh in (None, _mesh(4, 2)):
            est = BlockWeightedLeastSquaresEstimator(**EST, mesh=mesh)
            est.fit(x, y)
            got = est.last_fit_report.conditioning
            assert est.last_fit_report.record()["conditioning"] == got
            assert [(r["label"], r["block"], r["rows_sampled"], r["dim"]) for r in got] == [
                (r["label"], r["block"], r["rows_sampled"], r["dim"]) for r in want]
            np.testing.assert_allclose([r["kappa"] for r in got], [r["kappa"] for r in want],
                                       rtol=1e-4)
    finally:
        for mod in (knum, jnum):
            mod.reset_state()
    monkeypatch.delenv(knum.NUMERICS_ENV)
    off = BlockWeightedLeastSquaresEstimator(**EST)
    off.fit(x, y)
    assert off.last_fit_report.conditioning is None
