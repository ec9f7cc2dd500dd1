"""Spec layouts for the mesh tiers of the port, held to the spec cases of
``tests/test_autoshard.py`` and to the JAX package itself on the CPU:

* lowering: ``autoshard.spec_pspec`` is the tuple of the JAX
  ``PartitionSpec`` for every entry of the vocabulary (with the JAX
  ``ValueError``s), and ``spec_sharding``'s per-slot index map equals
  ``NamedSharding.devices_indices_map`` slot for slot, each slot's tensor
  the JAX shard's data, for tensors of rank 1-3;
* per-slot bytes: each placed slot holds at least ``spec_chip_bytes``;
* the searched BCD and BWLS fits on ``make_mesh(4, 2, devices=[cpu] * 8)``
  and 8x1 enumerate every factorization and the JAX package's spec
  candidates, under its names and hints (the BWLS temp bytes aside, see
  :func:`test_bwls_mesh_search_spec_candidates_execute`), deterministically,
  with the default layout at the head; every forced spec plan runs its
  layout and is ``torch.equal`` to the default layout;
  ``KEYSTONE_AUTOSHARD_SPECS=0`` removes every spec candidate;
* the searched featurize placement and ``tools/plan_view.py``'s spec column.

The JAX side runs on the conftest's ``mesh42`` / ``mesh8``; inputs are
seeded numpy.
"""

import contextlib
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.core import autoshard as jshard
from keystone_tpu.solvers.block import BlockLeastSquaresEstimator as JaxBLS
from keystone_tpu.solvers.weighted import BlockWeightedLeastSquaresEstimator as JaxBWLS
from keystone_tpu.utils.stats import about_eq
from keystone_tpu.workloads import fv_common as jfv
from keystone_tpu_torch.core import autoshard
from keystone_tpu_torch.parallel.mesh import (
    ShardedRows,
    SpecLayout,
    enumerate_mesh_shapes,
    make_mesh,
    padded_shard_rows,
    slot_nbytes,
)
from keystone_tpu_torch.solvers.block import BlockLeastSquaresEstimator
from keystone_tpu_torch.solvers.weighted import BlockWeightedLeastSquaresEstimator
from keystone_tpu_torch.workloads import fv_common
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools"))
import plan_view  # noqa: E402  (tools/plan_view.py)

CPU = torch.device("cpu")
SHAPES = {"4x2": (4, 2), "8x1": (8, 1)}


@pytest.fixture(params=sorted(SHAPES))
def meshes(request):
    """(the port's mesh of eight CPU slots, the JAX mesh of the same shape)."""
    data, model = SHAPES[request.param]
    jmesh = request.getfixturevalue("mesh42" if model == 2 else "mesh8")
    return make_mesh(data, model, devices=[CPU] * 8), jmesh


@pytest.fixture
def jax_log(tmp_path):
    """A context for the JAX fits of a test: they log to a file of their
    own (both packages read ``KEYSTONE_PLAN_LOG``), so neither package's
    outcomes calibrate the other's ranking here."""

    @contextlib.contextmanager
    def scope():
        port_log = os.environ.get(jshard.PLAN_LOG_ENV)
        os.environ[jshard.PLAN_LOG_ENV] = str(tmp_path / "jax_plans.jsonl")
        try:
            yield
        finally:
            os.environ[jshard.PLAN_LOG_ENV] = port_log

    return scope


def _problem(rng, n=256, d=128, k=4):
    x = rng.standard_normal((n, d), dtype=np.float32)
    y = (2.0 * np.eye(k, dtype=np.float32)[rng.integers(0, k, n)] - 1.0).astype(np.float32)
    return x, y


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _hints(pkg, monkeypatch) -> dict:
    """Capture each candidate's cost hints as ``pkg.search`` sees them."""
    seen: dict = {}
    real = pkg.search

    def spy(label, cands, **kw):
        seen.update({c.name: dict(c.hints) for c in cands})
        return real(label, cands, **kw)

    monkeypatch.setattr(pkg, "search", spy)
    return seen


def _candidate(placement: dict, name: str) -> dict:
    return next(c for c in placement["candidates"] if c["name"] == name)


def _head_specs(placement: dict) -> list[str]:
    """The spec candidates of the ranked head's mesh, in table order."""
    head = _candidate(placement, placement["ranking"][0])
    return [c["name"] for c in placement["candidates"]
            if c.get("specs") and c["mesh"] == head["mesh"]]


def _equal(a, b) -> bool:
    return torch.equal(a.b, b.b) and all(torch.equal(p, q) for p, q in zip(a.xs, b.xs))


# -- lowering ------------------------------------------------------------------


@pytest.mark.parametrize("spec,ndim", [
    ("replicated", 1), ("replicated", 2), ("data@dim0", 1), ("data@dim0", 2),
    ("model@dim1", 2), ("model@dim2", 3), ("data@dim2", 3), ("model@dim0", 3),
])
def test_spec_pspec_lowers_every_vocabulary_entry(spec, ndim):
    assert autoshard.spec_pspec(spec, ndim) == tuple(jshard.spec_pspec(spec, ndim))


@pytest.mark.parametrize("spec,ndim", [("bogus", 2), ("data@dim5", 2), ("model@dimx", 2),
                                       ("rows@dim0", 2), ("data@dim", 1)])
def test_spec_pspec_refuses_like_the_jax_package(spec, ndim):
    with pytest.raises(ValueError) as want:
        jshard.spec_pspec(spec, ndim)
    with pytest.raises(ValueError) as got:
        autoshard.spec_pspec(spec, ndim)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("shape", [(8,), (8, 6), (8, 4, 16)], ids=["rank1", "rank2", "rank3"])
def test_spec_sharding_places_arrays_per_spec(meshes, shape):
    pmesh, jmesh = meshes
    a = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    specs = {c["spec"] for c in jshard.spec_candidates(
        jax.ShapeDtypeStruct(shape, np.float32), dict(jmesh.shape))}
    specs |= {"replicated", f"model@dim{len(shape) - 1}"}
    for spec in sorted(specs):
        js = jshard.spec_sharding(spec, jmesh, len(shape))
        ps = autoshard.spec_sharding(spec, pmesh, len(shape))
        want_map, got_map = js.devices_indices_map(shape), ps.devices_indices_map(shape)
        placed = jax.device_put(a, js)
        rec = ps.place(torch.from_numpy(a))
        assert isinstance(rec, ShardedRows if spec == "data@dim0" else SpecLayout)
        for shard in placed.addressable_shards:
            d, m = (int(v[0]) for v in np.nonzero(jmesh.devices == shard.device))
            assert got_map[d, m] == want_map[shard.device], (spec, d, m)
            np.testing.assert_array_equal(rec.shards[d][m].numpy(), np.asarray(shard.data))
        whole = rec.gather()
        assert torch.equal(whole, torch.from_numpy(a)), spec


def test_slots_of_one_device_share_one_copy():
    mesh = make_mesh(4, 2, devices=[CPU] * 8)
    t = torch.arange(48, dtype=torch.float32).reshape(8, 6)
    rep = autoshard.spec_sharding("replicated", mesh, 2).place(t)
    assert all(s is rep.shards[0][0] for row in rep.shards for s in row)
    assert rep.shards[0][0].data_ptr() == t.data_ptr()  # a view, not a copy
    cols = autoshard.spec_sharding("model@dim1", mesh, 2).place(t)
    assert all(row[m] is cols.shards[0][m] for row in cols.shards for m in range(2))
    # Admission charges every slot its own bytes all the same.
    assert (slot_nbytes(rep) == t.numel() * 4).all()
    assert (slot_nbytes(cols) == t.numel() * 2).all()


def test_a_window_joins_the_pieces_of_the_slots_that_hold_it():
    mesh = make_mesh(2, 4, devices=[CPU] * 8)
    t = torch.arange(96, dtype=torch.float32).reshape(8, 12)
    cols = autoshard.spec_sharding("model@dim1", mesh, 2).place(t)
    for slot in ((0, 0), (1, 3)):
        for window in ((slice(2, 6), slice(1, 11)), (slice(None), slice(3, 6)),
                       (slice(0, 4), slice(None))):
            assert torch.equal(cols.window(window, slot), t[window])
    rows = autoshard.spec_sharding("data@dim1", make_mesh(4, 2, devices=[CPU] * 8), 2).place(t)
    assert torch.equal(rows.window((slice(1, 7), slice(2, 10)), (3, 1)), t[1:7, 2:10])


@pytest.mark.parametrize("spec", ["data@dim0", "model@dim1", "data@dim1"])
def test_an_axis_that_does_not_divide_the_dimension_is_an_error(spec, mesh42):
    pmesh = make_mesh(4, 2, devices=[CPU] * 8)
    with pytest.raises(ValueError):
        jax.device_put(np.zeros((7, 7), np.float32), jshard.spec_sharding(spec, mesh42, 2))
    with pytest.raises(ValueError, match="not a multiple"):
        autoshard.spec_sharding(spec, pmesh, 2).place(torch.zeros((7, 7)))
    with pytest.raises(ValueError):
        autoshard.spec_chip_bytes((7, 7), np.float32, spec, dict(pmesh.shape))


@pytest.mark.parametrize("shape", [(64, 48), (32, 8, 6)])
def test_spec_candidates_bytes_lower_bound_of_placed_layouts(meshes, shape):
    """The invariant the preflight prune depends on: for every enumerated
    spec, the analytic per-slot bytes are at most what each slot of the
    placed layout holds."""
    pmesh, _jmesh = meshes
    t = torch.zeros(shape)
    cands = autoshard.spec_candidates(t, dict(pmesh.shape))
    assert {c["spec"] for c in cands} >= {"replicated", "data@dim0"}
    for c in cands:
        rec = autoshard.spec_sharding(c["spec"], pmesh, len(shape)).place(t)
        assert (slot_nbytes(rec) >= c["per_chip_bytes"]).all(), c
        assert c["per_chip_bytes"] == autoshard.spec_chip_bytes(
            shape, torch.float32, c["spec"], dict(pmesh.shape))


@pytest.mark.parametrize("value", ["", "1", "on", "0", "off", "false", "OFF", "no"])
def test_specs_enabled_reads_the_knob_as_the_jax_package(value, monkeypatch):
    monkeypatch.setenv(autoshard.SPECS_ENV, value)
    assert autoshard.SPECS_ENV == jshard.SPECS_ENV == "KEYSTONE_AUTOSHARD_SPECS"
    assert autoshard.specs_enabled() == jshard.specs_enabled()


# -- the searched BCD fit ------------------------------------------------------


def test_fit_mesh_search_enumerates_factorizations_deterministically(rng, meshes, jax_log):
    pmesh, jmesh = meshes
    x, y = _problem(rng)

    def one():
        est = BlockLeastSquaresEstimator(64, num_iter=1, lam=1.0, mesh=pmesh)
        est.fit(*_t(x, y), plan=True)
        return est.last_fit_report.placement

    p = one()
    shapes = {f"{c['mesh']['data']}x{c['mesh']['model']}" for c in p["candidates"] if c["mesh"]}
    assert shapes == {f"{d}x{m}" for d, m in enumerate_mesh_shapes(8)}
    assert p["ranking"][-1] == "single_device"
    again = one()
    assert again["fingerprint"] == p["fingerprint"]
    assert again["ranking"] == p["ranking"]
    jest = JaxBLS(64, num_iter=1, lam=1.0, mesh=jmesh)
    with jax_log():
        jest.fit(jnp.asarray(x), jnp.asarray(y), plan=True)
    assert p["ranking"] == jest.last_fit_report.placement["ranking"]


def test_mesh_search_enumerates_spec_candidates(rng, meshes, monkeypatch, jax_log):
    pmesh, jmesh = meshes
    x, y = _problem(rng)
    got_hints, want_hints = _hints(autoshard, monkeypatch), _hints(jshard, monkeypatch)
    est = BlockLeastSquaresEstimator(64, num_iter=1, lam=1.0, mesh=pmesh)
    est.fit(*_t(x, y), plan=True)
    jest = JaxBLS(64, num_iter=1, lam=1.0, mesh=jmesh)
    with jax_log():
        jest.fit(jnp.asarray(x), jnp.asarray(y), plan=True)
    p, jp = est.last_fit_report.placement, jest.last_fit_report.placement
    spec_cands = [c for c in p["candidates"] if c.get("specs")]
    assert [(c["name"], c["specs"], c["mesh"]) for c in spec_cands] == [
        (c["name"], c["specs"], c["mesh"]) for c in jp["candidates"] if c.get("specs")]
    assert "fused[mesh 4x2|labels=model@dim1]" in {c["name"] for c in spec_cands}
    assert got_hints == want_hints
    # Extras: the untrained head stays the hand rung in the default layout.
    head = _candidate(p, p["ranking"][0])
    assert head["specs"] is None and head["name"] == jp["ranking"][0]
    assert all(c["calibration_source"] in ("direct", "model", "pooled", "none")
               for c in p["candidates"] if not c["pruned"])


def test_forced_spec_plan_executes_layout_bit_identical(rng, meshes, jax_log):
    """A spec candidate places its operands in its layout and reproduces
    the default layout's model bit for bit on the same mesh shape; the JAX
    package's forced plan agrees within the mesh tier's tolerance."""
    pmesh, jmesh = meshes
    x, y = _problem(rng)
    est = BlockLeastSquaresEstimator(64, num_iter=1, lam=1.0, mesh=pmesh)
    base = est.fit(*_t(x, y), plan=True)
    names = _head_specs(est.last_fit_report.placement)
    assert len(names) == (3 if pmesh.shape["model"] == 2 else 1)
    for name in names:
        forced = BlockLeastSquaresEstimator(64, num_iter=1, lam=1.0, mesh=pmesh)
        got = forced.fit(*_t(x, y), plan=[name])
        assert forced.last_fit_report.chosen == name
        rec = _candidate(forced.last_fit_report.placement, name)
        assert rec["outcome"] == "ok" and rec["specs"]
        assert _equal(got, base), name
        with jax_log():
            want = JaxBLS(64, num_iter=1, lam=1.0, mesh=jmesh).fit(
                jnp.asarray(x), jnp.asarray(y), plan=[name])
        for g, w in zip(got.xs, want.xs):
            assert about_eq(g.numpy(), np.asarray(w), 1e-4), name
        assert about_eq(got.b.numpy(), np.asarray(want.b), 1e-4)


def test_forced_spec_plan_on_row_sharded_labels(rng):
    """Labels that arrive row-sharded are gathered and placed in the spec's
    layout: the same bits as the default layout."""
    pmesh = make_mesh(4, 2, devices=[CPU] * 8)
    x, y = _problem(rng, n=250, k=5)
    xs, ys = (padded_shard_rows(t, pmesh)[0] for t in _t(x, y))
    base = BlockLeastSquaresEstimator(64, 1, 1.0, mesh=pmesh).fit(xs, ys, plan=False)
    for name in ("fused[mesh 4x2|labels=model@dim1]", "fused[mesh 4x2|labels=rep,models=rep]"):
        forced = BlockLeastSquaresEstimator(64, 1, 1.0, mesh=pmesh)
        assert _equal(forced.fit(xs, ys, plan=[name]), base), name
        assert forced.last_fit_report.chosen == name


def test_bwls_mesh_search_spec_candidates_execute(rng, meshes, monkeypatch, jax_log):
    """The BWLS spec candidates carry the JAX names and hints, but for
    ``temp_bytes``: a model slot of the port solves whole class chunks (the
    standing deviation), so its class-solve slab is ``model`` times the JAX
    one.  Each forced spec plan is ``torch.equal`` to the default layout,
    from tensors and from row-sharded inputs."""
    pmesh, jmesh = meshes
    x, _ = _problem(rng)
    labels = rng.integers(0, 8, 256)
    y = (2.0 * np.eye(8, dtype=np.float32)[labels] - 1.0).astype(np.float32)
    got_hints, want_hints = _hints(autoshard, monkeypatch), _hints(jshard, monkeypatch)
    est = BlockWeightedLeastSquaresEstimator(64, 1, 0.5, 0.5, mesh=pmesh)
    base = est.fit(*_t(x, y), plan=True)
    jest = JaxBWLS(64, 1, 0.5, 0.5, mesh=jmesh)
    with jax_log():
        jest.fit(jnp.asarray(x), jnp.asarray(y), plan=True)
    p, jp = est.last_fit_report.placement, jest.last_fit_report.placement
    assert p["ranking"] == jp["ranking"]
    assert [(c["name"], c["specs"]) for c in p["candidates"]] == [
        (c["name"], c["specs"]) for c in jp["candidates"]]
    n_max, chunk = int(np.bincount(labels).max()), 8
    for name, want in want_hints.items():
        got = dict(got_hints[name])
        model = (_candidate(p, name)["mesh"] or {}).get("model", 1)
        slab = 4 * chunk * n_max * 64
        assert got.pop("temp_bytes", 0) - want.pop("temp_bytes", 0) == slab - slab // model, name
        assert got == want, name
    names = _head_specs(p)
    if pmesh.shape["model"] == 2:
        assert names == ["fused[mesh 4x2|labels=model@dim1]", "fused[mesh 4x2|labels=rep]"]
    else:
        assert names == ["fused[mesh 8x1|labels=rep]"]
    xs, ys = (padded_shard_rows(t, pmesh)[0] for t in _t(x, y))
    for name in names:
        for inputs in (_t(x, y), (xs, ys)):
            forced = BlockWeightedLeastSquaresEstimator(64, 1, 0.5, 0.5, mesh=pmesh)
            assert _equal(forced.fit(*inputs, plan=[name]), base), name
            assert forced.last_fit_report.chosen == name
            assert _candidate(forced.last_fit_report.placement, name)["outcome"] == "ok"


def test_bwls_wide_class_needs_the_class_count_to_divide_the_model_axis(rng):
    x, _ = _problem(rng, n=120, d=64)
    y = (2.0 * np.eye(3, dtype=np.float32)[np.arange(120) % 3] - 1.0).astype(np.float32)
    est = BlockWeightedLeastSquaresEstimator(32, 1, 0.5, 0.5,
                                             mesh=make_mesh(4, 2, devices=[CPU] * 8))
    est.fit(*_t(x, y), plan=True)
    specs = [c["specs"] for c in est.last_fit_report.placement["candidates"] if c["specs"]]
    assert specs and {"labels": "model@dim1"} not in specs


@pytest.mark.parametrize("solver", ["bcd", "bwls"])
def test_specs_env_disables_spec_dimension(rng, solver, monkeypatch):
    x, y = _problem(rng, k=4 if solver == "bcd" else 8)
    pmesh = make_mesh(4, 2, devices=[CPU] * 8)

    def fit():
        est = (BlockLeastSquaresEstimator(64, 1, 1.0, mesh=pmesh) if solver == "bcd"
               else BlockWeightedLeastSquaresEstimator(64, 1, 0.5, 0.5, mesh=pmesh))
        model = est.fit(*_t(x, y), plan=True)
        return model, est.last_fit_report.placement

    with_specs, on = fit()
    monkeypatch.setenv(autoshard.SPECS_ENV, "0")
    without, off = fit()
    assert not any(c.get("specs") for c in off["candidates"])
    # Today's ranking: the spec-free candidates, in the same order.
    names = {c["name"] for c in off["candidates"]}
    assert off["ranking"] == [n for n in on["ranking"] if n in names]
    assert off["ranking"][0] == on["ranking"][0] == "fused[mesh 4x2]"
    assert _equal(without, with_specs)


# -- the searched featurize placement and the plan view -----------------------


def test_searched_featurize_placement(rng, mesh42, jax_log):
    """fv_common's featurize placement rides the same search: the hand
    row-sharded layout at the untrained head (bit-identical to the hand
    path), the spec column in the record, the single-device floor last; the
    JAX package's placement on the same images."""
    images = ([rng.integers(0, 255, (24, 16, 3)).astype(np.uint8) for _ in range(6)]
              + [rng.integers(0, 255, (16, 16, 3)).astype(np.uint8) for _ in range(4)])
    pmesh = make_mesh(4, 2, devices=[CPU] * 8)

    def describe(pixels):
        return pixels.to(torch.float32).sum(dim=(1, 2, 3), keepdim=True)[:, :, None]

    out, placement = fv_common.searched_bucket_featurize(
        "test_featurize", images, describe, CPU, 4, pmesh)
    assert placement["ranking"][0] == "row_sharded[mesh 4x2]"
    assert placement["ranking"][-1] == "single_device"
    assert placement["chosen"] == placement["ranking"][0]
    assert _candidate(placement, "row_sharded[mesh 4x2]")["specs"] == {"batch": "data@dim0"}
    hand = fv_common.describe_buckets(images, describe, CPU, 4, pmesh)
    with jax_log():
        _jout, jplacement = jfv.searched_bucket_featurize(
            "test_featurize", images,
            lambda dev: jnp.asarray(dev, jnp.float32).sum(axis=(1, 2, 3),
                                                          keepdims=True)[:, :, None],
            mesh42)
    assert placement["ranking"] == jplacement["ranking"]
    assert [c["specs"] for c in placement["candidates"]] == [
        c["specs"] for c in jplacement["candidates"]]
    assert set(out) == set(hand) == set(_jout)
    for shape, (idx, rows) in out.items():
        assert np.array_equal(idx, hand[shape][0])
        assert torch.equal(rows.gather(), hand[shape][1].gather())
        want = np.asarray(_jout[shape][1])[: len(idx)]
        np.testing.assert_array_equal(rows.gather().numpy(), want)
    out2, rec2 = fv_common.searched_bucket_featurize(
        "test_featurize", images, describe, CPU, 4, None)
    assert rec2 is None and set(out2) == set(hand)


def test_plan_view_renders_spec_column(rng, tmp_path):
    x, y = _problem(rng)
    est = BlockLeastSquaresEstimator(64, num_iter=1, lam=1.0,
                                     mesh=make_mesh(4, 2, devices=[CPU] * 8))
    est.fit(*_t(x, y), plan=True)
    path = tmp_path / "results.json"
    path.write_text(json.dumps({"solver": est.last_fit_report.record()}))
    out = plan_view.summarize(str(path))
    assert "specs" in out  # the column header
    assert "labels=model@dim1" in out  # a spec assignment
    assert "default" in out  # the hand rungs' layout
