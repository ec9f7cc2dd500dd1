"""The port's single-process mesh (``keystone_tpu_torch.parallel.mesh``), its
per-slot admission, and the mesh tiers of the block and linear solvers,
against the port's single-device fits and the JAX package's mesh fits
(``tests/test_mesh.py``, ``tests/test_distributed.py``).

A mesh here is 8 slots of the one CPU (``make_mesh(4, 2, devices=[cpu] *
8)`` and ``(8, 1)``); the JAX side runs on the conftest's 8 virtual CPU
devices.  Inputs are seeded numpy.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.ops.util import VectorSplitter
from keystone_tpu.parallel.mesh import use_mesh as jax_use_mesh
from keystone_tpu.solvers.block import BlockLeastSquaresEstimator as JaxBLS
from keystone_tpu.solvers.linear import LinearMapEstimator as JaxLinear
from keystone_tpu_torch.core import autoshard
from keystone_tpu_torch.core import memory as kmem
from keystone_tpu_torch.core.resilience import counters
from keystone_tpu_torch.ops import rect_pool
from keystone_tpu_torch.ops.conv_fused import FusedConvFeaturizer
from keystone_tpu_torch.parallel import mesh as pmesh
from keystone_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    ShardedRows,
    current_mesh,
    enumerate_mesh_shapes,
    enumerate_meshes,
    make_mesh,
    mask_pad_rows,
    mesh_desc,
    pad_shard_inputs,
    padded_shard_rows,
    parse_mesh,
    reduced_mesh,
    use_mesh,
)
from keystone_tpu_torch.solvers import block
from keystone_tpu_torch.solvers.block import BlockLeastSquaresEstimator
from keystone_tpu_torch.solvers.linear import LinearMapEstimator
from keystone_tpu_torch.utils.stats import about_eq
from keystone_tpu_torch.workloads.cifar_random_patch import featurize_chunked
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401

CPU = torch.device("cpu")
SLOTS = [CPU] * 8


def _mesh(data, model, devices=None):
    return make_mesh(data, model, devices=devices or [CPU] * (data * model))


def _problem(rng, n=192, d=24, k=4, noise=0.05):
    x_true = rng.normal(size=(d, k))
    a = rng.normal(size=(n, d))
    b = a @ x_true + noise * rng.normal(size=(n, k))
    return a.astype(np.float32), b.astype(np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# -- the mesh record and its flag ---------------------------------------------


def test_a_device_listed_eight_times_is_eight_slots():
    mesh = make_mesh(4, 2, devices=SLOTS)
    assert dict(mesh.shape) == {DATA_AXIS: 4, MODEL_AXIS: 2} and mesh.size == 8
    assert mesh_desc(mesh) == "4x2"


@pytest.mark.parametrize("spec, shape", [("1", (1, 1)), ("1x1", (1, 1))])
def test_parse_mesh_on_the_cpu(spec, shape):
    mesh = parse_mesh(spec, "cpu")
    assert (mesh.shape[DATA_AXIS], mesh.shape[MODEL_AXIS]) == shape
    assert parse_mesh(None, "cpu") is None and parse_mesh("", "cpu") is None


@pytest.mark.parametrize("spec, message", [
    ("2", "mesh 2x1 needs 2 devices, have 1"),
    ("4x2", "mesh 4x2 needs 8 devices, have 1"),
    ("0", "bad --mesh spec"),
    ("2x2x2", "bad --mesh spec"),
    ("ax2", "bad --mesh spec"),
])
def test_parse_mesh_refuses_like_the_jax_package(spec, message):
    with pytest.raises(ValueError, match=message):
        parse_mesh(spec, "cpu")


def test_parse_mesh_on_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        parse_mesh("1", "cuda")


def test_use_mesh_is_a_stack():
    outer, inner = _mesh(8, 1), _mesh(4, 2)
    assert current_mesh() is None
    with use_mesh(outer):
        with use_mesh(inner):
            assert current_mesh() is inner
        assert current_mesh() is outer
    assert current_mesh() is None


# -- row-sharded arrays --------------------------------------------------------


def test_padded_shard_rows_splits_in_order_and_pads_with_zeros(rng):
    x = _t(rng.normal(size=(190, 3)).astype(np.float32))
    sh, nvalid = padded_shard_rows(x, _mesh(8, 1))
    assert nvalid == 190 and sh.rows == 192 and sh.shape == (192, 3)
    blocks = sh.data_blocks()
    assert [int(b.shape[0]) for b in blocks] == [24] * 8
    torch.testing.assert_close(torch.cat(blocks)[:190], x, rtol=0, atol=0)
    assert torch.equal(blocks[-1][-2:], torch.zeros(2, 3))
    # A block with no pad rows is a view of the caller's tensor, not a copy.
    assert blocks[0].data_ptr() == x.data_ptr()
    assert torch.equal(sh.gather(), x)


def test_model_slots_of_one_device_share_the_block(rng):
    sh, _ = padded_shard_rows(rng.normal(size=(40, 2)).astype(np.float32), _mesh(4, 2))
    for row in sh.shards:
        assert row[0] is row[1]


def test_reshard_onto_another_layout_keeps_the_true_rows(rng):
    x = _t(rng.normal(size=(50, 4)).astype(np.float32))
    a, _ = padded_shard_rows(x, _mesh(4, 2))
    b, nvalid = padded_shard_rows(a, _mesh(8, 1))
    assert nvalid == 50 and b.rows == 56 and b.mesh.shape[DATA_AXIS] == 8
    assert torch.equal(b.gather(), x)
    same, _ = padded_shard_rows(a, _mesh(4, 2))
    assert same is a


def test_mask_pad_rows_zeroes_only_the_pad_rows(rng):
    sh, _ = padded_shard_rows(rng.normal(size=(10, 2)).astype(np.float32), _mesh(4, 1))
    ones = sh.apply(lambda t: torch.ones_like(t))  # a featurizer that maps 0 -> 1
    masked = mask_pad_rows(ones)
    rows = torch.cat(masked.data_blocks())
    assert torch.equal(rows[:10], torch.ones(10, 2)) and torch.equal(rows[10:], torch.zeros(2, 2))
    plain = torch.ones(5, 2)
    assert torch.equal(mask_pad_rows(plain, 3), torch.tensor([[1.0, 1]] * 3 + [[0.0, 0]] * 2))
    assert mask_pad_rows(plain, 5) is plain


def test_pad_shard_inputs_reports_nvalid_only_when_it_padded(rng):
    a, b = _problem(rng, n=190)
    (xs, ys), nvalid = pad_shard_inputs(_mesh(8, 1), None, a, b)
    assert nvalid == 190 and xs.rows == ys.rows == 192
    (xs, _), nvalid = pad_shard_inputs(_mesh(8, 1), None, a[:184], b[:184])
    assert nvalid is None and xs.rows == 184


def test_sharded_apply_of_a_block_model_is_the_unsharded_apply_bit_for_bit(rng):
    a, b = _problem(rng, n=190, d=36)
    model = BlockLeastSquaresEstimator(12, num_iter=2, lam=0.4).fit(_t(a), _t(b))
    for mesh in (_mesh(4, 2), _mesh(8, 1)):
        sh, _ = padded_shard_rows(a, mesh)
        assert torch.equal(sh.apply(model).gather(), model(_t(a)))


def test_each_slot_featurizes_under_its_own_device_scope(rng, monkeypatch):
    """The K1 wrapper launches on the runtime's current device: every slot's
    chunk must be featurized inside the scope of the slot's device.  Eight
    slots of distinct (CPU-indexed) devices record which scope each call of
    the rect+pool entry ran in."""
    devices = [torch.device("cpu", i) for i in range(8)]
    mesh = make_mesh(8, 1, devices=devices)
    scopes, calls = [], []

    @contextlib.contextmanager
    def recording_scope(dev):
        scopes.append(torch.device(dev))
        try:
            yield
        finally:
            scopes.pop()

    plain = rect_pool.conv_rect_pool_reference

    def recorded(*args, **kw):
        calls.append(scopes[-1] if scopes else None)
        return plain(*args, **kw)

    feat = FusedConvFeaturizer(
        torch.from_numpy(rng.normal(size=(4, 3 * 3 * 3)).astype(np.float32)),
        pool_stride=3, pool_size=3, img_channels=3, device="cpu",
    )
    images = rng.uniform(0, 255, (37, 8, 8, 3)).astype(np.float32)
    whole = featurize_chunked(feat, images, 16, CPU)
    monkeypatch.setattr(pmesh, "device_scope", recording_scope)
    monkeypatch.setattr(rect_pool, "conv_rect_pool_reference", recorded)
    out = featurize_chunked(feat, images, 16, CPU, mesh=mesh)
    # 37 rows over 8 slots: 5 a slot; chunks of 16/8 = 2 rows: 3 chunks a slot.
    assert calls == [d for d in devices for _ in range(3)]
    assert isinstance(out, ShardedRows)
    torch.testing.assert_close(out.gather(), whole, rtol=1e-6, atol=1e-4)
    assert torch.equal(torch.cat(out.data_blocks())[37:], torch.zeros(3, whole.shape[1]))


# -- per-slot admission --------------------------------------------------------


def test_eight_slots_of_one_device_each_get_an_eighth_of_its_budget(monkeypatch):
    monkeypatch.setattr(kmem, "hbm_budget", lambda device=None: 80 << 30)
    budget, dev = kmem.min_chip_budget(_mesh(4, 2))
    assert budget == (80 << 30) // 8 and dev == CPU
    two = make_mesh(2, 2, devices=[torch.device("cpu", 0)] * 3 + [torch.device("cpu", 1)])
    assert kmem.min_chip_budget(two)[0] == (80 << 30) // 3  # the fuller device binds


def test_the_budget_override_keeps_its_per_card_meaning(monkeypatch):
    monkeypatch.setenv(kmem.HBM_BUDGET_ENV, "8G")
    assert kmem.min_chip_budget(_mesh(8, 1))[0] == 1 << 30
    monkeypatch.delenv(kmem.HBM_BUDGET_ENV)
    assert kmem.min_chip_budget(_mesh(8, 1)) == (None, None)  # the CPU reports nothing


def test_shard_bytes_charges_a_slot_its_block():
    assert kmem.shard_bytes((190, 10), torch.float32, _mesh(4, 2)) == 48 * 10 * 4
    assert kmem.shard_bytes((190, 10), torch.float32, _mesh(8, 1)) == 24 * 10 * 4
    assert kmem.shard_bytes((190, 10), np.float32) == 190 * 40


def test_device_fingerprint_tells_shared_slots_from_distinct_cards():
    cards = [torch.device("cuda", i) for i in range(8)]
    assert autoshard.device_fingerprint(cards) == "cuda x8"
    assert autoshard.device_fingerprint([torch.device("cuda", 0)] * 8) == "cuda x8 on 1"
    assert autoshard.device_fingerprint(SLOTS) == "cpu x8 on 1"


# -- meshes: reduction and enumeration (tests/test_mesh.py's cases) ------------


@pytest.mark.parametrize("data, model, want", [(2, 2, "4x1"), (1, 4, "4x1"), (1, 2, "2x1")])
def test_reduced_mesh_collapses_model_onto_data(data, model, want):
    mesh = _mesh(data, model)
    red = reduced_mesh(mesh)
    assert mesh_desc(red) == want and list(red.devices.flat) == list(mesh.devices.flat)


@pytest.mark.parametrize("n", (1, 2, 3, 8))
def test_pure_data_mesh_has_no_rung_below(n):
    assert reduced_mesh(_mesh(n, 1)) is None


@pytest.mark.parametrize("n", (1, 3, 5, 6, 9))
def test_enumerated_meshes_cover_every_factorization(n):
    slots = [CPU] * n
    meshes = enumerate_meshes(slots)
    assert [(m.shape[DATA_AXIS], m.shape[MODEL_AXIS]) for m in meshes] == (
        enumerate_mesh_shapes(n))
    assert all(list(m.devices.flat) == slots for m in meshes)


def test_ladder_walk_over_survivors():
    for n, model in ((4, 2), (2, 2), (3, 1), (1, 1)):
        mesh = _mesh(n // model, model)
        rungs = 0
        while mesh is not None:
            mesh = reduced_mesh(mesh)
            rungs += 1
            assert rungs <= 2, "ladder failed to reach the floor"


# -- the solvers' mesh tiers (tests/test_distributed.py's bars) ----------------


def test_linear_map_estimator_mesh_with_pad_rows_matches_local_and_jax(rng, mesh8):
    a, b = _problem(rng, n=190)  # not a multiple of the 8-way data axis
    local = LinearMapEstimator(lam=0.3).fit(_t(a), _t(b))
    sharded = LinearMapEstimator(lam=0.3, mesh=_mesh(8, 1)).fit(_t(a), _t(b))
    jax_fit = JaxLinear(lam=0.3, mesh=mesh8).fit(jnp.asarray(a), jnp.asarray(b))
    for got, want, jwant in ((sharded.x, local.x, jax_fit.x), (sharded.b, local.b, jax_fit.b)):
        assert about_eq(got.numpy(), want.numpy(), 1e-4)
        assert about_eq(got.numpy(), np.asarray(jwant), 1e-4)
    assert about_eq(sharded(_t(a)).numpy(), local(_t(a)).numpy(), 1e-4)
    with use_mesh(_mesh(4, 2)):  # ambient
        ambient = LinearMapEstimator(lam=0.3).fit(_t(a), _t(b))
    assert about_eq(ambient.x.numpy(), local.x.numpy(), 1e-4)


def test_block_least_squares_ambient_mesh_matches_local_and_jax(rng, mesh42):
    a, b = _problem(rng, n=188, d=36)
    local = BlockLeastSquaresEstimator(12, num_iter=2, lam=0.4).fit(_t(a), _t(b))
    with use_mesh(_mesh(4, 2)):
        est = BlockLeastSquaresEstimator(12, num_iter=2, lam=0.4)
        sharded = est.fit(_t(a), _t(b))
    assert est.last_fit_report.chosen == "fused[mesh 4x2]"
    assert est.last_fit_report.mesh_shape == {DATA_AXIS: 4, MODEL_AXIS: 2}
    with jax_use_mesh(mesh42):
        jax_model = JaxBLS(12, num_iter=2, lam=0.4).fit(jnp.asarray(a), jnp.asarray(b))
    for lm, sm, jm in zip(local.xs, sharded.xs, jax_model.xs):
        assert about_eq(sm.numpy(), lm.numpy(), 1e-4)
        assert about_eq(sm.numpy(), np.asarray(jm), 1e-4)
    assert about_eq(sharded(_t(a)).numpy(), local(_t(a)).numpy(), 1e-4)


def test_multiblock_bcd_model_sharded_matches_monolithic_and_jax(rng, mesh42):
    n, d, k, budget = 600, 96, 5, 16
    a, b = _problem(rng, n=n, d=d, k=k, noise=0.1)
    mono = LinearMapEstimator(lam=0.5).fit(_t(a), _t(b))
    blocks = [_t(a[:, i : i + budget]) for i in range(0, d, budget)]
    assert len(blocks) == d // budget
    blocked = BlockLeastSquaresEstimator(budget, num_iter=12, lam=0.5, mesh=_mesh(4, 2)).fit(
        blocks, _t(b))
    pred_mono = mono(_t(a)).numpy()
    scale = np.abs(pred_mono).max()
    assert np.abs(blocked(_t(a)).numpy() - pred_mono).max() < 2e-2 * scale
    local = BlockLeastSquaresEstimator(budget, num_iter=12, lam=0.5).fit(blocks, _t(b))
    jax_blocked = JaxBLS(budget, num_iter=12, lam=0.5, mesh=mesh42).fit(
        VectorSplitter(budget)(jnp.asarray(a)), jnp.asarray(b))
    for lm, sm, jm in zip(local.xs, blocked.xs, jax_blocked.xs):
        assert about_eq(sm.numpy(), lm.numpy(), 1e-3)
        assert about_eq(sm.numpy(), np.asarray(jm), 1e-3)


@pytest.mark.parametrize("listed", [False, True], ids=["monolithic", "blocks"])
def test_one_by_one_mesh_is_the_fused_tier_bit_for_bit(rng, listed):
    a, b = _problem(rng, n=190, d=40)
    features = [_t(a[:, :16]), _t(a[:, 16:32]), _t(a[:, 32:])] if listed else _t(a)
    fused = BlockLeastSquaresEstimator(16, num_iter=3, lam=0.2)
    want = fused.fit(features, _t(b), plan=False)
    assert fused.last_fit_report.chosen == "fused"
    est = BlockLeastSquaresEstimator(16, num_iter=3, lam=0.2, mesh=_mesh(1, 1))
    got = est.fit(features, _t(b))
    assert est.last_fit_report.chosen == "fused[mesh 1x1]"
    assert all(torch.equal(g, w) for g, w in zip(got.xs, want.xs))
    assert torch.equal(got.b, want.b)
    assert all(torch.equal(g.mean, w.mean)
               for g, w in zip(got.feature_scalers, want.feature_scalers))


def test_row_sharded_inputs_with_nvalid_match_host_inputs(rng):
    a, b = _problem(rng, n=117, d=16)
    mesh = _mesh(4, 2)
    host = BlockLeastSquaresEstimator(8, num_iter=2, lam=0.1, mesh=mesh).fit(_t(a), _t(b))
    xs, nvalid = padded_shard_rows(a, mesh)
    sharded = BlockLeastSquaresEstimator(8, num_iter=2, lam=0.1, mesh=mesh).fit(
        xs, _t(b), nvalid=nvalid)
    assert all(torch.equal(h, s) for h, s in zip(host.xs, sharded.xs))
    with pytest.raises(TypeError, match="need a mesh"):
        BlockLeastSquaresEstimator(8).fit(xs, _t(b))


def test_checkpointing_under_a_mesh_raises(rng, tmp_path):
    a, b = _problem(rng)
    with pytest.raises(ValueError, match="does not run under a mesh"):
        BlockLeastSquaresEstimator(8, mesh=_mesh(8, 1)).fit(
            _t(a), _t(b), checkpoint=str(tmp_path / "bcd"))


# -- the mesh ladder's step-downs ----------------------------------------------


def _oom_on(monkeypatch, shapes):
    """Inject an out-of-memory error at ``_execute_fused_bcd_mesh`` for the
    meshes whose (data, model) shape is in ``shapes``."""
    real = block._execute_fused_bcd_mesh
    seen = []

    def execute(plan, x, labels, *args):
        shape = mesh_desc(x.mesh)
        seen.append(shape)
        if shape in shapes:
            raise torch.OutOfMemoryError(f"CUDA out of memory (injected on mesh {shape})")
        return real(plan, x, labels, *args)

    monkeypatch.setattr(block, "_execute_fused_bcd_mesh", execute)
    return seen


def test_hand_ladder_steps_down_one_tier_at_a_time_to_single_device(rng, monkeypatch):
    a, b = _problem(rng, n=190, d=24)
    local = BlockLeastSquaresEstimator(8, num_iter=2, lam=0.3).fit(_t(a), _t(b))
    seen = _oom_on(monkeypatch, {"4x2", "8x1"})
    before = counters.snapshot().get("solver_oom_retry", 0)
    est = BlockLeastSquaresEstimator(8, num_iter=2, lam=0.3, mesh=_mesh(4, 2))
    model = est.fit(_t(a), _t(b), plan=False)
    rep = est.last_fit_report
    assert seen == ["4x2", "8x1"]
    assert rep.oom_retries == ["fused[mesh 4x2]", "fused[mesh 8x1]"]
    assert rep.chosen == "single_device/fused" and rep.mesh_shape is None
    assert counters.snapshot()["solver_oom_retry"] - before == 2
    # The floor refits the true rows on one device: the local fit's bits.
    assert all(torch.equal(m, w) for m, w in zip(model.xs, local.xs))


def test_one_step_down_lands_on_the_reduced_mesh(rng, monkeypatch):
    a, b = _problem(rng, n=190, d=24)
    seen = _oom_on(monkeypatch, {"4x2"})
    est = BlockLeastSquaresEstimator(8, num_iter=2, lam=0.3, mesh=_mesh(4, 2))
    est.fit(_t(a), _t(b))
    assert seen == ["4x2", "8x1"]
    assert est.last_fit_report.chosen == "fused[mesh 8x1]"
    assert est.last_fit_report.mesh_shape == {DATA_AXIS: 8, MODEL_AXIS: 1}


def test_searched_ladder_walks_every_factorization_before_the_floor(rng, monkeypatch):
    a, b = _problem(rng, n=190, d=24)
    seen = _oom_on(monkeypatch, {"4x2", "8x1", "2x4", "1x8"})
    before = counters.snapshot().get("autoshard_stepdown", 0)
    est = BlockLeastSquaresEstimator(8, num_iter=2, lam=0.3, mesh=_mesh(4, 2))
    est.fit(_t(a), _t(b), plan=True)
    placement = est.last_fit_report.placement
    # Every factorization in the default layout, then the spec candidates
    # of each mesh shape (they die on the same meshes), then the floor.
    ranking = placement["ranking"]
    assert ranking[:4] == ["fused[mesh 4x2]", "fused[mesh 8x1]", "fused[mesh 2x4]",
                           "fused[mesh 1x8]"]
    assert ranking[4:-1] == [f"fused[mesh {s}|{tag}]" for s in ("4x2", "8x1", "2x4", "1x8")
                             for tag in ("labels=model@dim1", "models=rep",
                                         "labels=rep,models=rep")
                             if s != "8x1" or tag == "labels=rep,models=rep"]
    assert ranking[-1] == "single_device"
    assert seen == [name[len("fused[mesh "):][:3] for name in ranking[:-1]]
    assert est.last_fit_report.chosen == "single_device/fused"
    assert counters.snapshot()["autoshard_stepdown"] - before == len(ranking) - 1
    assert placement["devices"] == "cpu x8 on 1"
    meshes = {c["name"]: c["mesh"] for c in placement["candidates"]}
    assert meshes["fused[mesh 2x4]"] == {DATA_AXIS: 2, MODEL_AXIS: 4}
    assert meshes["single_device"] is None


def test_per_slot_admission_denies_mesh_tiers_the_whole_device_would_fit(rng, monkeypatch):
    """Each mesh tier's per-slot charge fits the device's budget but not an
    eighth of it, so both are denied and the floor runs."""
    a, b = _problem(rng, n=190, d=24)
    est = BlockLeastSquaresEstimator(8, num_iter=2, lam=0.3, mesh=_mesh(4, 2))
    monkeypatch.setenv(kmem.HBM_BUDGET_ENV, "1")  # every tier denied: read the charges
    est.fit(_t(a), _t(b), plan=False)
    charges = {name: est.last_fit_report.plans[name].total_bytes
               for name in ("fused[mesh 4x2]", "fused[mesh 8x1]")}
    assert charges["fused[mesh 8x1]"] < charges["fused[mesh 4x2]"]
    budget = 8 * min(charges.values()) - 8
    monkeypatch.setenv(kmem.HBM_BUDGET_ENV, str(budget))
    est.fit(_t(a), _t(b), plan=False)
    rep = est.last_fit_report
    for name, total in charges.items():
        plan = rep.plans[name]
        assert plan.budget_bytes == budget // 8 and plan.total_bytes == total <= budget
        assert not plan.admitted
    assert rep.denials[:2] == ["fused[mesh 4x2]", "fused[mesh 8x1]"]
    assert rep.chosen.startswith("single_device/")
