"""The placement search of the port (``keystone_tpu_torch.core.autoshard``
and the enumeration half of ``keystone_tpu_torch.parallel.mesh``) held to
every single-device case of ``tests/test_autoshard.py`` on the CPU, and
against the JAX package itself:

* the same hand-built candidates through both packages' ``search()`` with
  one fixed ``CostModel()`` give the same ranking, margin and trained flag,
  the same predicted seconds (rtol 1e-12) and ``PlacementPlan.record()``
  JSON that is equal with ``devices`` (the device set each package sees)
  and ``search_seconds`` (a host clock reading) aside;
* a plan-outcome log written by either package calibrates the other's
  search to the same factors, and ``tools/plan_view.py`` renders the
  port's placement and log;
* a searched fit is ``torch.equal`` to the hand ladder (``plan=False``),
  and its placement's ranking and chosen tier are the JAX fit's on the same
  inputs, for BCD and BWLS.

The spec cases (``test_spec_pspec_lowers_every_vocabulary_entry``,
``test_spec_sharding_places_arrays_per_spec``,
``test_spec_candidates_bytes_lower_bound_of_compiled_layouts`` (as
``..._of_placed_layouts``: PyTorch compiles no layout),
``test_fit_mesh_search_enumerates_factorizations_deterministically``,
``test_mesh_search_enumerates_spec_candidates``,
``test_forced_spec_plan_executes_layout_bit_identical``,
``test_bwls_mesh_search_spec_candidates_execute``,
``test_specs_env_disables_spec_dimension``,
``test_searched_featurize_placement`` and
``test_plan_view_renders_spec_column``) are held on the mesh in
``tests/test_torch_mesh_specs.py``.
"""

import json
import os
import re
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.core import autoshard as jshard
from keystone_tpu.core import memory as jmem
from keystone_tpu.core import optimize as jopt
from keystone_tpu.solvers.block import BlockLeastSquaresEstimator as JaxBLS
from keystone_tpu.solvers.weighted import BlockWeightedLeastSquaresEstimator as JaxBWLS
from keystone_tpu_torch.core import autoshard
from keystone_tpu_torch.core import memory as kmem
from keystone_tpu_torch.core import optimize as kopt
from keystone_tpu_torch.core.resilience import counters
from keystone_tpu_torch.parallel.mesh import (
    Mesh,
    enumerate_mesh_shapes,
    enumerate_meshes,
    make_mesh,
    mesh_desc,
    reduced_mesh,
)
from keystone_tpu_torch.solvers.block import BlockLeastSquaresEstimator
from keystone_tpu_torch.solvers.weighted import BlockWeightedLeastSquaresEstimator

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools"))
import plan_view  # noqa: E402  (tools/plan_view.py)
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: E402, F401

#: Eight devices of a card host, constructed without any card.
CUDA8 = [torch.device("cuda", i) for i in range(8)]


_CACHES = ("_outcome_cache", "_ratio_cache", "_model_cache", "_drift_model_cache",
           "_compact_skip")


@pytest.fixture(autouse=True)
def plan_log(tmp_path, monkeypatch):
    """Each test's own plan-outcome log for both packages.  The caches of
    the once-per-process log read are put back afterwards, so outcomes
    other tests of this process logged never train a ranking here, and the
    rows these tests write never train theirs."""
    saved = [(pkg, name, dict(getattr(pkg, name)))
             for pkg in (autoshard, jshard) for name in _CACHES]
    path = str(tmp_path / "plans.jsonl")
    monkeypatch.setenv(autoshard.PLAN_LOG_ENV, path)
    yield path
    for pkg, name, cache in saved:
        getattr(pkg, name).clear()
        getattr(pkg, name).update(cache)


def _clear_caches():
    autoshard.clear_outcome_cache()
    jshard.clear_outcome_cache()


# -- parallel/mesh.py enumeration edge cases ----------------------------------


def test_enumerate_mesh_shapes_one_device():
    assert enumerate_mesh_shapes(1) == [(1, 1)]


def test_enumerate_mesh_shapes_prime_count():
    assert enumerate_mesh_shapes(7) == [(7, 1), (1, 7)]


def test_enumerate_mesh_shapes_composite_data_major_descending():
    assert enumerate_mesh_shapes(8) == [(8, 1), (4, 2), (2, 4), (1, 8)]
    for n in (2, 6, 12):
        shapes = enumerate_mesh_shapes(n)
        assert all(d * m == n for d, m in shapes)
        assert [d for d, _ in shapes] == sorted((d for d, _ in shapes), reverse=True)


def test_enumerate_mesh_shapes_rejects_zero():
    with pytest.raises(ValueError):
        enumerate_mesh_shapes(0)


@pytest.mark.parametrize("n", [1, 2, 6, 7, 8, 12])
def test_enumerate_mesh_shapes_matches_jax(n):
    from keystone_tpu.parallel.mesh import enumerate_mesh_shapes as jax_shapes

    assert enumerate_mesh_shapes(n) == jax_shapes(n)


def test_reduced_mesh_on_already_collapsed_mesh_is_none():
    collapsed = make_mesh(data=8, model=1, devices=CUDA8)
    assert reduced_mesh(collapsed) is None
    full = make_mesh(data=4, model=2, devices=CUDA8)
    assert full.shape == {"data": 4, "model": 2} and full.size == 8
    rm = reduced_mesh(full)
    assert mesh_desc(rm) == "8x1"
    assert list(rm.devices.flat) == CUDA8
    assert reduced_mesh(rm) is None


def test_make_mesh_checks_the_device_count():
    with pytest.raises(ValueError):
        make_mesh(data=3, model=3, devices=CUDA8)
    with pytest.raises(ValueError):
        make_mesh(model=3, devices=CUDA8)
    assert mesh_desc(make_mesh(model=2, devices=CUDA8)) == "4x2"
    # The default device list: the CPU here, where there is no card.
    assert isinstance(make_mesh(), Mesh) and make_mesh().size >= 1


def test_enumerate_meshes_deterministic_over_fixed_devices():
    a = enumerate_meshes(CUDA8)
    b = enumerate_meshes(CUDA8)
    assert [mesh_desc(m) for m in a] == [mesh_desc(m) for m in b]
    assert [mesh_desc(m) for m in a] == [f"{d}x{m}" for d, m in enumerate_mesh_shapes(8)]
    for m in a:
        assert list(m.devices.flat) == CUDA8


def test_enumerate_meshes_memoized_per_device_tuple():
    a = enumerate_meshes(CUDA8)
    b = enumerate_meshes(CUDA8)
    assert a is not b
    assert all(x is y for x, y in zip(a, b))


def test_enumerate_mesh_shapes_memoized_returns_fresh_list():
    a = enumerate_mesh_shapes(8)
    b = enumerate_mesh_shapes(8)
    assert a == b and a is not b
    a.append(("junk", 0))
    assert enumerate_mesh_shapes(8) == b  # cache not polluted


# -- the sharding-spec vocabulary ----------------------------------------------


def test_spec_candidates_generated_from_aval_dims():
    aval = torch.zeros((8, 6), dtype=torch.float32)
    specs = {c["spec"]: c["per_chip_bytes"]
             for c in autoshard.spec_candidates(aval, {"data": 2, "model": 3})}
    total = 8 * 6 * 4
    assert specs == {
        "replicated": total,
        "data@dim0": total // 2,
        "data@dim1": total // 2,
        "model@dim1": total // 3,
    }
    # The JAX package's enumeration of the same shape.
    assert autoshard.spec_candidates(aval, {"data": 2, "model": 3}) == jshard.spec_candidates(
        jnp.zeros((8, 6), jnp.float32), {"data": 2, "model": 3})


def test_best_spec_minimizes_per_chip_bytes_and_replicates_when_odd():
    aval = torch.zeros((8, 6), dtype=torch.float32)
    best = autoshard.best_spec(aval, {"data": 4, "model": 2})
    assert best["spec"] == "data@dim0"
    assert best["per_chip_bytes"] == 8 * 6 * 4 // 4
    odd = torch.zeros((7,), dtype=torch.float32)
    assert autoshard.best_spec(odd, {"data": 4, "model": 2})["spec"] == "replicated"


def test_spec_chip_bytes_matches_enumeration():
    mesh_shape = {"data": 2, "model": 3}
    aval = torch.zeros((8, 6), dtype=torch.float32)
    for c in autoshard.spec_candidates(aval, mesh_shape):
        for dtype in (torch.float32, np.float32):
            assert autoshard.spec_chip_bytes((8, 6), dtype, c["spec"], mesh_shape) == (
                c["per_chip_bytes"])
    with pytest.raises(ValueError):
        autoshard.spec_chip_bytes((7,), torch.float32, "data@dim0", mesh_shape)


def test_spec_tag_compact():
    assert autoshard.spec_tag(None) == "default"
    assert autoshard.spec_tag({"models": "replicated", "labels": "model@dim1"}) == (
        "labels=model@dim1,models=rep")


# -- the zero-cost batch preflight --------------------------------------------


def test_plan_bytes_admits_and_denies_analytically():
    ok = kmem.plan_bytes("t", argument_bytes=100, temp_bytes=50, budget=1000)
    assert ok.admitted and not ok.analyzed
    deny = kmem.plan_bytes("t", argument_bytes=2000, budget=1000)
    assert not deny.admitted
    assert "DENIED" in deny.reason
    assert deny.total_bytes == 2000
    # The JAX package's words: a placement table reads the same in either.
    assert deny.reason == jmem.plan_bytes("t", argument_bytes=2000, budget=1000).reason


def test_plan_bytes_without_budget_skips_admission():
    plan = kmem.plan_bytes("t", argument_bytes=1 << 50, budget=None)
    assert plan.admitted
    assert "skipped" in plan.reason


def test_plan_batch_turns_planner_crash_into_deny():
    out = kmem.plan_batch([
        ("good", lambda: kmem.plan_bytes("good", argument_bytes=1, budget=10)),
        ("bad", lambda: (_ for _ in ()).throw(RuntimeError("boom"))),
    ])
    assert out["good"].admitted
    assert not out["bad"].admitted
    assert "boom" in out["bad"].reason


# -- fingerprints and the plan-outcome log ------------------------------------


def test_fingerprint_stable_and_shape_sensitive():
    a = autoshard.fingerprint("bcd", 100, 10, "f32")
    assert a == autoshard.fingerprint("bcd", 100, 10, "f32")
    assert a != autoshard.fingerprint("bcd", 200, 10, "f32")
    assert len(a) == 16
    assert a == jshard.fingerprint("bcd", 100, 10, "f32")  # one key for both packages


def test_device_fingerprint_names_type_and_count():
    assert autoshard.device_fingerprint([torch.device("cpu")]) == "cpu x1"
    assert autoshard.device_fingerprint(CUDA8) == "cuda x8"
    want = "cuda x1" if torch.cuda.is_available() else "cpu x1"
    if torch.cuda.device_count() <= 1:
        assert autoshard.device_fingerprint() == want


def _log_record(fp, cand, predicted, measured, outcome="ok"):
    return {
        "fingerprint": fp, "label": "t", "candidate": cand,
        "predicted_seconds": predicted, "measured_seconds": measured,
        "outcome": outcome, "devices": "cpu x1", "ts": 0.0,
    }


def test_outcome_log_roundtrip_and_calibration(plan_log):
    fp = "f" * 16
    for _ in range(autoshard.MIN_TRAIN - 1):
        autoshard.append_outcome(_log_record(fp, "a", 1.0, 3.0))
    autoshard.clear_outcome_cache()
    assert autoshard.calibration(fp, "a") == (1.0, autoshard.MIN_TRAIN - 1)
    autoshard.append_outcome(_log_record(fp, "a", 1.0, 3.0))
    autoshard.clear_outcome_cache()
    factor, n = autoshard.calibration(fp, "a")
    assert n == autoshard.MIN_TRAIN
    assert factor == pytest.approx(3.0)
    # OOM outcomes never train the ratio; a torn tail line is skipped.
    autoshard.append_outcome(_log_record(fp, "a", 1.0, 9.0, outcome="oom"))
    with open(plan_log, "a") as f:
        f.write('{"torn": ')
    autoshard.clear_outcome_cache()
    assert autoshard.calibration(fp, "a")[0] == pytest.approx(3.0)


def test_outcome_log_disabled_by_env(monkeypatch):
    monkeypatch.setenv(autoshard.PLAN_LOG_ENV, "off")
    assert autoshard.plan_log_path() is None
    autoshard.append_outcome({"x": 1})  # a no-op, not a crash
    assert autoshard.load_outcomes() == []


def test_outcome_log_read_once_per_process(plan_log):
    assert autoshard.load_outcomes() == []
    autoshard.append_outcome(_log_record("a" * 16, "a", 1.0, 2.0))
    assert autoshard.load_outcomes() == []  # the cached read stands
    autoshard.clear_outcome_cache()
    assert len(autoshard.load_outcomes()) == 1


def test_hermetic_plan_log_points_at_a_fresh_file(monkeypatch):
    monkeypatch.setenv(autoshard.PLAN_LOG_ENV, "/nonexistent/plans.jsonl")
    try:
        path = autoshard.hermetic_plan_log()
        assert autoshard.plan_log_path() == path and not os.path.exists(path)
        autoshard.append_outcome(_log_record("a" * 16, "a", 1.0, 2.0))
        assert len(open(path).readlines()) == 1
    finally:
        autoshard.clear_outcome_cache()


#: A port test module that imports the solvers, the workloads or the
#: lifecycle may fit, directly or through a CLI.
_FITS = re.compile(
    r"keystone_tpu_torch\.(solvers|workloads|core\.lifecycle)\b"
    r"|from keystone_tpu_torch import [^\n]*\b(solvers|workloads)\b"
    r"|from keystone_tpu_torch\.core import \(?[^)]*?\blifecycle\b"
)


def test_port_test_modules_that_fit_keep_their_outcomes_to_themselves():
    """The conftest's plan log is one per test process and the JAX tests
    share it; the JAX package's cross-program model fits on every row of it.
    So every port test module that may fit takes ``tests/torch_plan_log.py``'s
    fixtures (a log per module and per test), card test files included."""
    tests = Path(__file__).resolve().parent
    fitting = [p for p in sorted(tests.glob("test_torch_*.py")) if _FITS.search(p.read_text())]
    assert len(fitting) > 30 and Path(__file__).resolve() in fitting
    line = "from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module"
    assert [p.name for p in fitting if line not in p.read_text()] == []


# -- search: prune, score, rank -----------------------------------------------


def _mk_cand(name, prior, dispatches, floor=False, hand=True, arg_bytes=0, pkg=autoshard,
             mem=kmem):
    def run(_plan, name=name):
        return f"{name}:ran"

    return pkg.Candidate(
        name, "fused",
        plan=lambda name=name: mem.MemoryPlan(label=name, admitted=True, reason="test"),
        run=run,
        hints={"dispatches": dispatches, "arg_bytes": arg_bytes},
        prior_rank=prior, floor=floor, hand=hand,
    )


_FP = "0123456789abcdef"


def _search(cands, budget=kmem._UNSET):
    # Fixed CostModel: 1 ms per dispatch on any platform.
    return autoshard.search("t", cands, fingerprint=_FP, budget=budget, model=kopt.CostModel())


def test_untrained_search_keeps_hand_order_within_margin():
    plan = _search([_mk_cand("a", 0, 10), _mk_cand("b", 1, 7)])
    assert plan.ranking == ["a", "b"]
    assert not plan.trained
    assert plan.margin == autoshard.UNTRAINED_MARGIN


def test_untrained_search_reorders_on_decisive_analytic_advantage():
    plan = _search([_mk_cand("a", 0, 10), _mk_cand("c", 1, 1)])
    assert plan.ranking == ["c", "a"]


def test_margin_is_relative_not_bucketed():
    plan = _search([_mk_cand("a", 0, 17), _mk_cand("b", 1, 15)])
    assert plan.ranking == ["a", "b"]


def test_calibration_falls_back_to_program_median(plan_log):
    fp = "e" * 16
    for _ in range(autoshard.MIN_TRAIN):
        autoshard.append_outcome(_log_record(fp, "a", 1.0, 3.0))
    autoshard.clear_outcome_cache()
    factor, n = autoshard.calibration(fp, "b")
    assert n == 0
    assert factor == pytest.approx(3.0)


def test_one_sided_training_cannot_flip_toward_unmeasured_plan(plan_log):
    for _ in range(autoshard.MIN_TRAIN):
        autoshard.append_outcome(_log_record(_FP, "a", 0.01, 0.05))
    autoshard.clear_outcome_cache()
    plan = _search([_mk_cand("a", 0, 10), _mk_cand("b", 1, 10)])
    assert plan.ranking == ["a", "b"]
    assert not plan.trained
    assert plan.candidate("b").calibration == pytest.approx(5.0)


def test_floor_pinned_last_regardless_of_score():
    plan = _search([_mk_cand("a", 0, 10), _mk_cand("cheap_floor", 1, 1, floor=True)])
    assert plan.ranking == ["a", "cheap_floor"]
    assert "floor" in plan.candidate("cheap_floor").reason


def test_pruned_hand_candidate_stays_in_execution_order():
    plan = _search([_mk_cand("big", 0, 1, arg_bytes=10_000), _mk_cand("small", 1, 10)],
                   budget=1000)
    assert plan.ranking == ["big", "small"]
    big = plan.candidate("big")
    assert big.pruned and big.outcome == "denied"
    assert "DENIED" in big.reason
    assert "big" in plan.analytic_plans


def test_pruned_extra_candidate_dropped_from_ranking():
    plan = _search([_mk_cand("hand", 0, 10),
                    _mk_cand("extra", 1, 1, hand=False, arg_bytes=10_000)], budget=1000)
    assert plan.ranking == ["hand"]
    extra = plan.candidate("extra")
    assert extra.pruned and extra.outcome == "denied"


def test_search_deterministic_same_fingerprint_same_ranking():
    def cands():
        return [_mk_cand("a", 0, 10), _mk_cand("b", 1, 7), _mk_cand("c", 2, 2),
                _mk_cand("floor", 3, 30, floor=True)]

    a, b = _search(cands()), _search(cands())
    assert a.ranking == b.ranking
    assert a.fingerprint == b.fingerprint
    assert [c.record() for c in a.candidates] == [c.record() for c in b.candidates]


def test_trained_calibration_reorders_past_margin(plan_log):
    for _ in range(autoshard.MIN_TRAIN):
        autoshard.append_outcome(_log_record(_FP, "a", 0.01, 0.01))
        autoshard.append_outcome(_log_record(_FP, "b", 0.01, 0.0001))
    autoshard.clear_outcome_cache()
    plan = _search([_mk_cand("a", 0, 10), _mk_cand("b", 1, 10)])
    assert plan.trained
    assert plan.margin == autoshard.TRAINED_MARGIN
    assert plan.ranking == ["b", "a"]
    rec = plan.candidate("b")
    assert rec.samples == autoshard.MIN_TRAIN
    assert rec.calibration == pytest.approx(0.01)


def test_placement_plan_summary_and_json():
    plan = _search([_mk_cand("a", 0, 10), _mk_cand("c", 1, 1)])
    assert plan.summary().startswith("autoshard t[0123456789abcdef]: 2/2 candidates ranked")
    assert "head=c" in plan.summary()
    assert json.loads(plan.to_json())["ranking"] == ["c", "a"]


# -- the same search in both packages ------------------------------------------

#: (name, prior, dispatches, floor, hand, arg_bytes) candidate lists and budgets.
_CROSS_CASES = {
    "hand_order": ([("a", 0, 10, False, True, 0), ("b", 1, 7, False, True, 0)], None),
    "decisive": ([("a", 0, 10, False, True, 0), ("c", 1, 1, False, True, 0)], None),
    "floor": ([("a", 0, 10, False, True, 0), ("f", 1, 1, True, True, 0)], None),
    "pruned": ([("big", 0, 1, False, True, 10_000), ("small", 1, 10, False, True, 0),
                ("extra", 2, 1, False, False, 10_000), ("f", 3, 30, True, True, 0)], 1000),
    "bytes": ([("a", 0, 3, False, True, 3 << 30), ("b", 1, 40, False, True, 1 << 20),
               ("c", 2, 2, False, True, 40 << 30)], None),
}


def _both_searches(case):
    rows, budget = _CROSS_CASES[case]
    kw = {} if budget is None else {"budget": budget}
    port = autoshard.search(
        "t", [_mk_cand(*r[:3], floor=r[3], hand=r[4], arg_bytes=r[5]) for r in rows],
        fingerprint=_FP, model=kopt.CostModel(), **kw)
    ref = jshard.search(
        "t", [_mk_cand(*r[:3], floor=r[3], hand=r[4], arg_bytes=r[5], pkg=jshard, mem=jmem)
              for r in rows],
        fingerprint=_FP, model=jopt.CostModel(), **kw)
    return port, ref


def _comparable(record: dict) -> dict:
    return {k: v for k, v in record.items() if k not in ("devices", "search_seconds")}


@pytest.mark.parametrize("case", sorted(_CROSS_CASES))
def test_search_matches_jax_package(case, plan_log):
    port, ref = _both_searches(case)
    assert port.ranking == ref.ranking
    assert (port.margin, port.trained) == (ref.margin, ref.trained)
    for c in ref.candidates:
        got = port.candidate(c.name)
        if c.predicted_seconds is None:
            assert got.predicted_seconds is None
        else:
            np.testing.assert_allclose(got.predicted_seconds, c.predicted_seconds, rtol=1e-12)
    assert json.loads(json.dumps(_comparable(port.record()))) == json.loads(
        json.dumps(_comparable(ref.record())))
    assert port.devices == autoshard.device_fingerprint()


def _featured(fp, cand, measured, kind="fused", bytes_=1e6):
    rec = _log_record(fp, cand, 1.0, measured)
    rec["raw_seconds"] = 1.0
    rec["features"] = autoshard.plan_features(
        kind, {"data": 1, "model": 1}, {"arg_bytes": bytes_, "flops": 1e9, "dispatches": 1})
    return rec


def _seed_log(writer):
    """Direct rows for two candidates of _FP, pooled rows for another
    program, and cross-program featurized rows of ten programs."""
    for _ in range(autoshard.MIN_TRAIN):
        writer.append_outcome(_log_record(_FP, "a", 0.01, 0.02))
        writer.append_outcome(_log_record(_FP, "b", 0.01, 0.0005))
        writer.append_outcome(_log_record("e" * 16, "a", 1.0, 3.0))
    for i in range(10):
        writer.append_outcome(_featured(f"{i:016x}", "fused", 4.0 + i % 3,
                                        bytes_=10.0 ** (5 + i % 3)))


@pytest.mark.parametrize("writer_pkg", ["jax", "torch"])
def test_plan_log_calibrates_the_other_package(writer_pkg, plan_log):
    writer, reader = (jshard, autoshard) if writer_pkg == "jax" else (autoshard, jshard)
    _seed_log(writer)
    _clear_caches()
    feats = autoshard.plan_features("fused", {"data": 1, "model": 1},
                                    {"arg_bytes": 2e6, "flops": 1e9, "dispatches": 1})
    for fp, cand, features in ((_FP, "a", None), (_FP, "b", None), ("e" * 16, "z", None),
                               ("f" * 16, "fused", feats), ("f" * 16, "x", None)):
        got = autoshard.calibrate(fp, cand, features=features)
        want = jshard.calibrate(fp, cand, features=features)
        assert got[1:] == want[1:]
        np.testing.assert_allclose(got[0], want[0], rtol=1e-12)
    assert autoshard.model_rows() == jshard.model_rows()
    assert reader.load_outcomes() == writer.load_outcomes()
    # And the trained searches rank alike.
    port, ref = _both_searches("hand_order")
    assert port.trained and ref.trained
    assert port.ranking == ref.ranking == ["b", "a"]
    assert json.loads(json.dumps(_comparable(port.record()))) == json.loads(
        json.dumps(_comparable(ref.record())))


def test_drift_rows_cross_packages(plan_log):
    """The byte-drift calibration: ``hbm_drift`` rows of either package
    train the same drift factor in both."""
    for i in range(10):
        writer = jshard if i % 2 else autoshard
        writer.append_outcome({
            "fingerprint": f"hbm:{i}", "label": "x", "candidate": "x",
            "outcome": "hbm_drift", "drift_ratio": 1.5 + 0.1 * (i % 3),
            "features": autoshard.hbm_features(1e6 * (i + 1), 1e5, 1e4, None), "ts": 0.0})
    _clear_caches()
    probe = autoshard.hbm_features(2e6, 1e5, 1e4, None)
    assert probe == jshard.hbm_features(2e6, 1e5, 1e4, None)
    assert autoshard.drift_rows() == jshard.drift_rows()
    np.testing.assert_allclose(autoshard.drift_factor(probe), jshard.drift_factor(probe),
                               rtol=1e-12)
    assert autoshard.drift_factor(probe) != 1.0


# -- run_search: the ranked execution contract --------------------------------


def test_run_search_hand_mode_walks_hand_ladder_without_placement():
    report = kmem.FitReport(label="t")
    out = autoshard.run_search(
        "t", [_mk_cand("a", 0, 10), _mk_cand("x", 1, 1, hand=False)],
        report, fingerprint=_FP, plan=False,
    )
    assert out == "a:ran"
    assert report.placement is None
    assert report.fingerprint == _FP


def test_run_search_env_off_walks_hand_ladder(monkeypatch):
    monkeypatch.setenv(autoshard.AUTOSHARD_ENV, "0")
    assert not autoshard.enabled() and not autoshard.will_search(None)
    assert autoshard.will_search(True) and autoshard.will_search(["a"])
    report = kmem.FitReport(label="t")
    assert autoshard.run_search("t", [_mk_cand("a", 0, 10), _mk_cand("c", 1, 1)], report,
                                fingerprint=_FP, model=kopt.CostModel()) == "a:ran"
    assert report.placement is None


def test_run_search_executes_ranked_head_and_records_placement(plan_log):
    report = kmem.FitReport(label="t")
    out = autoshard.run_search(
        "t", [_mk_cand("a", 0, 10), _mk_cand("c", 1, 1)],
        report, fingerprint=_FP, plan=True, model=kopt.CostModel(),
    )
    assert out == "c:ran"
    assert report.chosen == "c"
    p = report.placement
    assert p["chosen"] == "c"
    assert p["ranking"][0] == "c"
    chosen = [c for c in p["candidates"] if c["name"] == "c"][0]
    assert chosen["outcome"] == "ok"
    assert chosen["measured_seconds"] is not None
    # The outcome row, in the JAX package's JSON, read back by it.
    [row] = [json.loads(ln) for ln in open(plan_log)]
    assert row["candidate"] == "c" and row["outcome"] == "ok" and row["fingerprint"] == _FP
    jshard.clear_outcome_cache()
    assert jshard.load_outcomes() == [row]


def test_run_search_forced_ranking_keeps_floor_last():
    report = kmem.FitReport(label="t")
    out = autoshard.run_search(
        "t",
        [_mk_cand("a", 0, 10), _mk_cand("b", 1, 10), _mk_cand("floor", 2, 10, floor=True)],
        report, fingerprint=_FP, plan=["floor", "b"], model=kopt.CostModel(),
    )
    assert out == "b:ran"
    assert report.placement["ranking"] == ["b", "a", "floor"]
    assert "forced replay" in [c for c in report.placement["candidates"]
                               if c["name"] == "b"][0]["reason"]


def test_run_search_replays_a_placement_plan():
    prev = _search([_mk_cand("a", 0, 10), _mk_cand("b", 1, 7)])
    prev.ranking = ["b", "a"]
    report = kmem.FitReport(label="t")
    out = autoshard.run_search("t", [_mk_cand("a", 0, 10), _mk_cand("b", 1, 7)], report,
                               fingerprint=_FP, plan=prev, model=kopt.CostModel())
    assert out == "b:ran" and report.placement["ranking"] == ["b", "a"]


@pytest.mark.parametrize("bad", [42, "fused", 1.5, {"ranking": ["a"]}])
def test_run_search_rejects_bad_plan_arg(bad):
    with pytest.raises(TypeError):
        autoshard.run_search("t", [_mk_cand("a", 0, 1)], kmem.FitReport(label="t"),
                             fingerprint=_FP, plan=bad)


@pytest.mark.parametrize("error", [
    torch.OutOfMemoryError("CUDA out of memory (injected)"),
    RuntimeError("RESOURCE_EXHAUSTED: injected"),
])
def test_run_search_runtime_oom_steps_down_ranked_list_counted(error):
    calls = {"a": 0}

    def dying_run(_plan):
        calls["a"] += 1
        raise error

    top = autoshard.Candidate(
        "a", "fused",
        plan=lambda: kmem.MemoryPlan(label="a", admitted=True, reason="test"),
        run=dying_run, hints={"dispatches": 1}, prior_rank=0,
    )
    report = kmem.FitReport(label="t")
    before = counters.get("autoshard_stepdown")
    out = autoshard.run_search("t", [top, _mk_cand("b", 1, 10)], report,
                               fingerprint=_FP, plan=True, model=kopt.CostModel())
    assert out == "b:ran"
    assert calls["a"] == 1
    assert report.chosen == "b"
    assert "a" in report.oom_retries
    assert counters.get("autoshard_stepdown") - before == 1
    p = report.placement
    assert [c for c in p["candidates"] if c["name"] == "a"][0]["outcome"] == "oom"


def test_run_search_typed_failure_not_recorded_as_oom():
    def dying_run(_plan):
        raise ValueError("bad data, not memory")

    top = autoshard.Candidate(
        "a", "fused",
        plan=lambda: kmem.MemoryPlan(label="a", admitted=True, reason="test"),
        run=dying_run, hints={"dispatches": 1}, prior_rank=0,
    )
    report = kmem.FitReport(label="t")
    with pytest.raises(ValueError):
        autoshard.run_search("t", [top], report, fingerprint=_FP, plan=True,
                             model=kopt.CostModel())
    rec = [c for c in report.placement["candidates"] if c["name"] == "a"][0]
    assert rec["outcome"] == "error"


def test_block_until_ready_reraises_only_oom(monkeypatch):
    autoshard._block_until_ready([torch.zeros(2), {"x": (torch.ones(1),)}, "not a tensor"])
    fake = torch.zeros(1, device="meta")
    monkeypatch.setattr(autoshard, "_tensor_devices", lambda out: {torch.device("cuda", 0)})

    def sync(dev, err):
        raise err

    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda dev=None: sync(dev, RuntimeError("a transient device error")))
    autoshard._block_until_ready(fake)  # not an OOM: swallowed
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda dev=None: sync(dev, torch.OutOfMemoryError("CUDA out of memory")))
    with pytest.raises(torch.OutOfMemoryError):
        autoshard._block_until_ready(fake)


# -- solver-level integration -------------------------------------------------


def _small_problem(rng, n=256, d=128, k=4):
    x = rng.standard_normal((n, d), dtype=np.float32)
    y = (2.0 * np.eye(k, dtype=np.float32)[rng.integers(0, k, n)] - 1.0).astype(np.float32)
    return x, y


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_fit_searched_bit_identical_to_hand_ladder(rng):
    x, y = _t(*_small_problem(rng))
    hand = BlockLeastSquaresEstimator(64, num_iter=1, lam=1.0).fit(x, y, plan=False)
    est = BlockLeastSquaresEstimator(64, num_iter=1, lam=1.0)
    searched = est.fit(x, y, plan=True)
    assert torch.equal(hand.b, searched.b)
    for a, b in zip(hand.xs, searched.xs):
        assert torch.equal(a, b)
    p = est.last_fit_report.placement
    assert p is not None
    assert p["chosen"] == est.last_fit_report.chosen
    assert p["ranking"] == ["fused", "stepwise", "host_staged"]
    assert all(c["reason"] for c in p["candidates"])


def test_fit_default_searches_and_env_restores_hand_ladder(rng, monkeypatch):
    x, y = _t(*_small_problem(rng))
    est = BlockLeastSquaresEstimator(64, 1, 1.0)
    est.fit(x, y)
    assert est.last_fit_report.placement is not None  # plan=None searches
    monkeypatch.setenv(autoshard.AUTOSHARD_ENV, "0")
    est.fit(x, y)
    assert est.last_fit_report.placement is None
    assert est.last_fit_report.chosen == "fused"
    est.fit(x, y, plan=True)  # an explicit True still searches
    assert est.last_fit_report.placement is not None


def test_fit_searched_plan_deterministic_under_fixed_devices(rng):
    x, y = _t(*_small_problem(rng))

    def one():
        est = BlockLeastSquaresEstimator(64, num_iter=1, lam=1.0)
        est.fit(x, y, plan=True)
        return est.last_fit_report.placement

    a, b = one(), one()
    assert a["fingerprint"] == b["fingerprint"]
    assert a["ranking"] == b["ranking"]
    assert [c["name"] for c in a["candidates"]] == [c["name"] for c in b["candidates"]]


def test_fit_plan_replay_accepts_placement_plan_and_name_list(rng):
    x, y = _t(*_small_problem(rng))
    est = BlockLeastSquaresEstimator(64, num_iter=1, lam=1.0)
    base = est.fit(x, y, plan=True)
    prev = est.last_fit_report.placement

    est2 = BlockLeastSquaresEstimator(64, num_iter=1, lam=1.0)
    replay = est2.fit(x, y, plan=list(prev["ranking"]))
    assert est2.last_fit_report.placement["ranking"] == prev["ranking"]
    assert torch.equal(base.b, replay.b)

    plan = autoshard.PlacementPlan(label="bcd_fit", fingerprint=prev["fingerprint"],
                                   devices=prev["devices"], trained=False, margin=4.0,
                                   candidates=[], ranking=["stepwise", "fused", "host_staged"])
    est3 = BlockLeastSquaresEstimator(64, num_iter=1, lam=1.0)
    stepwise = est3.fit(x, y, plan=plan)
    assert est3.last_fit_report.chosen == "stepwise"
    assert est3.last_fit_report.placement["ranking"] == plan.ranking
    for a, b in zip(base.xs, stepwise.xs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bad", [42, "fused"])
def test_fit_rejects_bad_plan_args(rng, bad):
    x, y = _t(*_small_problem(rng))
    with pytest.raises(TypeError):
        BlockLeastSquaresEstimator(64, 1, 1.0).fit(x, y, plan=bad)
    y8 = torch.from_numpy(2.0 * np.eye(8, dtype=np.float32)[rng.integers(0, 8, 256)] - 1.0)
    with pytest.raises(TypeError):
        BlockWeightedLeastSquaresEstimator(64, 1, 0.5, 0.5).fit(x, y8, plan=bad)


def test_fit_checkpoint_bypasses_the_search(rng, tmp_path):
    x, y = _t(*_small_problem(rng))
    est = BlockLeastSquaresEstimator(64, 1, 1.0)
    est.fit(x, y, checkpoint=str(tmp_path / "state"), plan=True)
    assert est.last_fit_report.chosen == "stepwise[checkpoint]"
    assert est.last_fit_report.placement is None


def test_fit_report_record_carries_placement(rng):
    x, y = _t(*_small_problem(rng))
    est = BlockLeastSquaresEstimator(64, num_iter=1, lam=1.0)
    est.fit(x, y, plan=True)
    rec = est.last_fit_report.record()
    assert rec["placement"] is not None
    assert rec["mesh_shape"] is None
    assert est.last_fit_report.fingerprint == rec["placement"]["fingerprint"]
    json.dumps(rec)


def test_fit_stepdown_oom_counts_autoshard_stepdown(rng, monkeypatch):
    from keystone_tpu_torch.solvers import block as block_mod

    x, y = _t(*_small_problem(rng))
    hand = BlockLeastSquaresEstimator(64, 1, 1.0).fit(x, y, plan=False)
    real = block_mod._fused_bcd_impl

    def dying(*a, **kw):
        raise torch.OutOfMemoryError("CUDA out of memory (injected)")

    monkeypatch.setattr(block_mod, "_fused_bcd_impl", dying)
    before = counters.snapshot()
    est = BlockLeastSquaresEstimator(64, 1, 1.0)
    got = est.fit(x, y, plan=True)
    monkeypatch.setattr(block_mod, "_fused_bcd_impl", real)
    delta = {k: counters.get(k) - before.get(k, 0)
             for k in ("autoshard_stepdown", "solver_oom_retry")}
    assert delta == {"autoshard_stepdown": 1, "solver_oom_retry": 1}
    p = est.last_fit_report.placement
    assert p["chosen"] == p["ranking"][1] == "stepwise"
    for a, b in zip(hand.xs, got.xs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("plan", [True, None])
def test_fit_placement_matches_jax_fit(rng, plan):
    x, y = _small_problem(rng)
    jest = JaxBLS(64, num_iter=1, lam=1.0)
    jest.fit(jnp.asarray(x), jnp.asarray(y), plan=plan)
    est = BlockLeastSquaresEstimator(64, num_iter=1, lam=1.0)
    est.fit(*_t(x, y), plan=plan)
    want, got = jest.last_fit_report.placement, est.last_fit_report.placement
    assert got["ranking"] == want["ranking"]
    assert got["chosen"] == want["chosen"] == est.last_fit_report.chosen
    assert [c["name"] for c in got["candidates"]] == [c["name"] for c in want["candidates"]]
    assert [c["pruned"] for c in got["candidates"]] == [c["pruned"] for c in want["candidates"]]


def test_bwls_searched_fit_matches_hand_ladder_and_jax(rng):
    x, _ = _small_problem(rng)
    y = (2.0 * np.eye(8, dtype=np.float32)[rng.integers(0, 8, 256)] - 1.0).astype(np.float32)
    hand = BlockWeightedLeastSquaresEstimator(64, 1, 0.5, 0.5).fit(*_t(x, y), plan=False)
    est = BlockWeightedLeastSquaresEstimator(64, 1, 0.5, 0.5)
    searched = est.fit(*_t(x, y), plan=True)
    assert torch.equal(hand.b, searched.b)
    for a, b in zip(hand.xs, searched.xs):
        assert torch.equal(a, b)
    jest = JaxBWLS(64, 1, 0.5, 0.5)
    jest.fit(jnp.asarray(x), jnp.asarray(y), plan=True)
    got, want = est.last_fit_report.placement, jest.last_fit_report.placement
    assert got["ranking"] == want["ranking"] == ["fused", "stepwise", "host_staged"]
    assert got["chosen"] == want["chosen"]
    # Replays by name list and by PlacementPlan.
    est2 = BlockWeightedLeastSquaresEstimator(64, 1, 0.5, 0.5)
    replay = est2.fit(*_t(x, y), plan=["stepwise"])
    assert est2.last_fit_report.chosen == "stepwise"
    est3 = BlockWeightedLeastSquaresEstimator(64, 1, 0.5, 0.5)
    est3.fit(*_t(x, y), plan=autoshard.PlacementPlan(
        label="bwls_fit", fingerprint=got["fingerprint"], devices=got["devices"],
        trained=False, margin=4.0, candidates=[], ranking=["stepwise"]))
    assert est3.last_fit_report.placement["ranking"] == ["stepwise", "fused", "host_staged"]
    for a, b in zip(searched.xs, replay.xs):
        assert torch.equal(a, b)


def test_bwls_fit_profiled_audits_the_counted_flops(rng):
    from keystone_tpu_torch.core import profiler as kprof

    x, _ = _small_problem(rng, n=96, d=32)
    y = (2.0 * np.eye(3, dtype=np.float32)[np.arange(96) % 3] - 1.0).astype(np.float32)
    with kprof.profiled(True, stats_fn=lambda: 1):
        BlockWeightedLeastSquaresEstimator(16, 1, 0.1, 0.25).fit(*_t(x, y), plan=True)
        audits = kprof.flops_audits()
    assert audits["bwls_fit:fused"]["ok"], audits


# -- the cross-program calibration model --------------------------------------


def _feat(kind="fused", bytes_=1e6, flops=1e9, data=1, model=1):
    return autoshard.plan_features(kind, {"data": data, "model": model},
                                   {"arg_bytes": bytes_, "flops": flops, "dispatches": 1})


def test_plan_features_match_jax():
    hints = {"arg_bytes": 1e6, "temp_bytes": 3e5, "out_bytes": 1e4, "flops": 1e9,
             "dispatches": 7, "h2d_bytes": 5e7}
    assert autoshard.plan_features("stepwise", None, hints) == jshard.plan_features(
        "stepwise", None, hints)


def test_calibration_model_learns_constant_ratio():
    rows = [(f"fp{i}", _feat(bytes_=10.0 ** (5 + i % 3)), 3.0) for i in range(10)]
    model = kopt.CalibrationModel.fit_rows(rows)
    assert model is not None
    assert model.n_programs == 10
    assert model.predict_factor(_feat(bytes_=2e6)) == pytest.approx(3.0, rel=0.05)


def test_calibration_model_factor_clipped():
    rows = [("a", _feat(bytes_=1e5), 1e9), ("b", _feat(bytes_=1e6), 1e9)]
    model = kopt.CalibrationModel.fit_rows(rows)
    assert model.predict_factor(_feat(bytes_=1e7)) <= 32.0


def test_calibrate_uses_cross_program_model_for_unseen_program(plan_log):
    for i in range(10):
        autoshard.append_outcome(_featured(f"{i:016x}", "fused", 4.0,
                                           bytes_=10.0 ** (5 + i % 3)))
    autoshard.clear_outcome_cache()
    factor, n, source = autoshard.calibrate("f" * 16, "fused", features=_feat(bytes_=2e6))
    assert source == "model"
    assert n == 0
    assert factor == pytest.approx(4.0, rel=0.1)
    assert autoshard.calibration("f" * 16, "fused") == (1.0, 0)


def test_empty_log_keeps_untrained_hand_order_with_model_path(plan_log):
    plan = _search([_mk_cand("a", 0, 10), _mk_cand("b", 1, 7)])
    assert plan.ranking == ["a", "b"]
    assert all(c.calibration == 1.0 and c.calibration_source == "none" and c.byte_drift == 1.0
               for c in plan.candidates)


# -- plan-log cap + compaction --------------------------------------------------


def test_plan_log_cap_compacts_oldest_first(plan_log, monkeypatch):
    monkeypatch.setenv(autoshard.PLAN_LOG_MAX_ENV, "50")
    with open(plan_log, "w") as f:
        for _ in range(400):
            f.write(json.dumps(_log_record("old" + "0" * 13, "fused", 1.0, 2.0)) + "\n")
        for _ in range(40):
            f.write(json.dumps(_log_record("hot" + "0" * 13, "fused", 1.0, 5.0)) + "\n")
    autoshard.append_outcome(_log_record("hot" + "0" * 13, "fused", 1.0, 5.0))
    with open(plan_log) as f:
        lines = [ln for ln in f if ln.strip()]
    assert len(lines) <= 51
    autoshard.clear_outcome_cache()
    assert autoshard.calibration("old" + "0" * 13, "fused")[0] == pytest.approx(2.0)
    assert autoshard.calibration("hot" + "0" * 13, "fused")[0] == pytest.approx(5.0)


def test_plan_log_cap_disabled_by_env(monkeypatch):
    monkeypatch.setenv(autoshard.PLAN_LOG_MAX_ENV, "off")
    assert autoshard.plan_log_max() is None
    monkeypatch.delenv(autoshard.PLAN_LOG_MAX_ENV)
    assert autoshard.plan_log_max() == 20_000


def test_plan_log_cap_malformed_env_never_crashes_append(plan_log, monkeypatch):
    autoshard.append_outcome(_log_record("a" * 16, "fused", 1.0, 2.0))
    seeded = open(plan_log).read()
    assert seeded
    for bad in ("unlimited", "-5"):
        monkeypatch.setenv(autoshard.PLAN_LOG_MAX_ENV, bad)
        with pytest.raises(ValueError):
            autoshard.plan_log_max()
        before = counters.get("plan_log_write_failed")
        autoshard.append_outcome(_log_record("a" * 16, "fused", 1.0, 2.0))
        assert counters.get("plan_log_write_failed") - before == 1
    assert open(plan_log).read() == seeded


def test_compact_log_tiny_cap_trims_never_wipes(tmp_path):
    path = str(tmp_path / "plans.jsonl")
    with open(path, "w") as f:
        for i in range(30):
            f.write(json.dumps(_log_record("a" * 16, "fused", 1.0, float(i))) + "\n")
    n = autoshard.compact_log(path, 5)
    assert 1 <= n <= 5
    kept = [json.loads(ln) for ln in open(path)]
    assert len(kept) == n
    assert kept[-1]["measured_seconds"] == 29.0


def test_compact_log_keeps_newest_per_pair(tmp_path):
    path = str(tmp_path / "plans.jsonl")
    with open(path, "w") as f:
        for i in range(30):
            f.write(json.dumps(_log_record("a" * 16, "fused", 1.0, float(i))) + "\n")
    n = autoshard.compact_log(path, 10)
    assert n <= 10
    kept = [json.loads(ln) for ln in open(path)]
    assert [r["measured_seconds"] for r in kept] == list(range(30 - len(kept), 30))


def test_compact_log_matches_jax(tmp_path):
    rows = [_log_record(f"{i % 7:016x}", f"c{i % 3}", 1.0, float(i)) for i in range(300)]
    text = "".join(json.dumps(r) + "\n" for r in rows)
    for name, pkg in (("port.jsonl", autoshard), ("jax.jsonl", jshard)):
        (tmp_path / name).write_text(text)
        assert pkg.compact_log(str(tmp_path / name), 40) <= 40
    assert (tmp_path / "port.jsonl").read_text() == (tmp_path / "jax.jsonl").read_text()


# -- tools/plan_view.py -------------------------------------------------------


def test_plan_view_renders_placement_from_results_json(rng, tmp_path):
    x, y = _t(*_small_problem(rng))
    est = BlockLeastSquaresEstimator(64, num_iter=1, lam=1.0)
    est.fit(x, y, plan=True)
    doc = {"nested": {"solver": est.last_fit_report.record()}}
    path = tmp_path / "results.json"
    path.write_text(json.dumps(doc))
    out = plan_view.summarize(str(path))
    assert "bcd_fit" in out
    assert "chosen:" in out
    for name in est.last_fit_report.placement["ranking"]:
        assert name in out


def test_plan_view_finds_all_embedded_plans():
    plan = {"label": "t", "fingerprint": "f", "devices": "cpu x1",
            "ranking": ["a"], "candidates": [], "chosen": None}
    doc = {"a": [plan, {"b": plan}], "c": plan}
    assert len(plan_view.find_plans(doc)) == 3


def test_plan_view_summarizes_outcome_log(tmp_path):
    path = tmp_path / "plans.jsonl"
    rows = [
        _log_record("ab" * 8, "fused", 1.0, 2.0),
        _log_record("ab" * 8, "fused", 1.0, 4.0),
        _log_record("ab" * 8, "fused", 1.0, 0.0, outcome="oom"),
        _log_record("cd" * 8, "stepwise", 1.0, 1.0),
    ]
    path.write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    out = plan_view.summarize(str(path))
    assert "fused" in out and "stepwise" in out
    filtered = plan_view.summarize(str(path), fingerprint="cd" * 8)
    assert "stepwise" in filtered and "fused" not in filtered


def test_plan_view_summarizes_the_ports_outcome_log(rng, plan_log):
    x, y = _t(*_small_problem(rng))
    est = BlockLeastSquaresEstimator(64, 1, 1.0)
    est.fit(x, y, plan=True)
    fp = est.last_fit_report.fingerprint
    out = plan_view.summarize(plan_log, fingerprint=fp)
    assert fp in out and "fused" in out
