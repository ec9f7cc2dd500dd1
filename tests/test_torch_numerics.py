"""The port's ``core.numerics`` against the JAX package's, on the CPU.

Bars: ``tensor_stats`` has the same count, nonfinite count and extremes
as JAX's exactly, and mean, std and zero fraction within rtol 2e-6 (f32
sums in another order: the two reductions round differently, a few ulps
over a few thousand terms); ``estimate_gram_condition`` within the JAX
tests' own band (the Ritz estimate lower-bounds the true κ and stays
within a factor 20 of it) and within rtol 1e-4 of the JAX estimate;
``OutputSketch`` and ``DriftMonitor`` records equal.  The probes and the
conditioning hooks of the port's pipeline, streams and solvers fire only
while the observatory is on, and never change a value."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.core import numerics as jnum
from keystone_tpu_torch.core import ingest
from keystone_tpu_torch.core import numerics as knum
from keystone_tpu_torch.core import resilience as pres
from keystone_tpu_torch.core.pipeline import FunctionTransformer, Pipeline
from keystone_tpu_torch.solvers.block import BlockLeastSquaresEstimator
from keystone_tpu_torch.solvers.normal_equations import solve_gram_l2
from keystone_tpu_torch.solvers.weighted import BlockWeightedLeastSquaresEstimator
from test_stream_workloads import _write_cifar_tar
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401


@pytest.fixture(autouse=True)
def _clean_numerics(monkeypatch):
    for mod in (knum, jnum):
        monkeypatch.delenv(mod.NUMERICS_ENV, raising=False)
        monkeypatch.delenv(mod.SAMPLE_ENV, raising=False)
        monkeypatch.delenv(mod.DRIFT_TOL_ENV, raising=False)
        mod.reset_state()
    yield
    for mod in (knum, jnum):
        mod.reset_state()


def _inputs():
    rng = np.random.default_rng(11)
    x = rng.normal(3.0, 2.0, (64, 65)).astype(np.float32)
    x[3, 4], x[7, 1], x[9, 9] = np.nan, np.inf, 0.0
    return {
        "f32 with nan/inf": x,
        "f32 small": rng.normal(size=(40, 7)).astype(np.float32),
        "ints": rng.integers(-5, 5, (33,)).astype(np.int32),
        "all nan": np.full((4, 3), np.nan, np.float32),
    }


@pytest.mark.parametrize("name", list(_inputs()))
def test_tensor_stats_match_jax(name):
    arr = _inputs()[name]
    port = knum.tensor_stats(torch.from_numpy(arr))
    ref = jnum.tensor_stats(jnp.asarray(arr))
    assert list(port) == list(ref)
    for key in ("count", "nonfinite", "min", "max", "abs_max"):
        assert port[key] == ref[key], key
    for key in ("mean", "std", "zero_frac"):
        np.testing.assert_allclose(port[key], ref[key], rtol=2e-6, atol=1e-12, err_msg=key)
    # the numpy path of both packages is one code
    assert knum.tensor_stats(arr) == jnum.tensor_stats(arr)


def test_tensor_stats_of_an_empty_tensor():
    """JAX's device reduction raises on an empty array; the port's tensor
    path reports what the numpy path reports."""
    empty = np.zeros((0, 5), np.float32)
    assert knum.tensor_stats(torch.from_numpy(empty)) == knum.tensor_stats(empty)
    assert knum.tensor_stats(empty)["count"] == 0


def test_nonfinite_rows_and_provenance():
    x = np.zeros((37, 3), np.float32)
    x[[2, 17, 36], 1] = np.nan
    for value in (x, torch.from_numpy(x)):
        assert knum.nonfinite_rows(value) == jnum.nonfinite_rows(x) == [2, 17, 36]
    before = pres.counters.get("numerics_nonfinite")
    with knum.monitored():
        out = knum.probe("site", torch.from_numpy(x), names=[f"m{i}.jpg" for i in range(37)])
    assert out is not None and torch.equal(out.isnan(), torch.from_numpy(np.isnan(x)))
    assert pres.counters.get("numerics_nonfinite") - before == 1
    (rec,) = knum.provenance_records()
    assert rec["names"] == ["m2.jpg", "m17.jpg", "m36.jpg"]
    assert "m17.jpg" in knum.provenance_note()


@pytest.mark.parametrize("true_k", [1e2, 1e4])
def test_condition_estimate_matches_jax(true_k):
    rng = np.random.default_rng(7)
    q, _ = np.linalg.qr(rng.standard_normal((48, 48)))
    g = ((q * np.geomspace(1.0, true_k, 48)) @ q.T).astype(np.float32)
    port = knum.estimate_gram_condition(torch.from_numpy(g), 0.0, "est")
    ref = jnum.estimate_gram_condition(jnp.asarray(g), 0.0, "est")
    assert true_k / 20.0 <= port["kappa"] <= true_k * 1.1
    np.testing.assert_allclose(port["kappa"], ref["kappa"], rtol=1e-4)
    assert port["iters"] == ref["iters"] and port["warned"] == ref["warned"]


def test_cond_warn_and_nonfinite_gram():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((256, 16)).astype(np.float32)
    a = np.concatenate([a, a], axis=1)
    before = pres.counters.get("cond_warn")
    row = knum.estimate_gram_condition(torch.from_numpy(a.T @ a), 0.0, "rankdef")
    assert row["warned"] and pres.counters.get("cond_warn") - before == 1
    assert jnum.estimate_gram_condition(jnp.asarray(a.T @ a), 0.0, "rankdef")["warned"]
    nan = torch.full((8, 8), float("nan"))
    assert knum.estimate_gram_condition(nan, 0.0, "nanprobe")["kappa"] is None
    with knum.monitored():
        with pytest.raises(FloatingPointError, match="non-finite"):
            solve_gram_l2(nan, torch.ones(8, 2), 0.1)


def test_sketches_and_drift_records_equal_jax():
    rng = np.random.default_rng(5)
    for arr in (np.array([0, 0, 1, 1, 2, 2]), rng.normal(size=3000).astype(np.float32),
                rng.integers(-3000, 3000, 500)):
        port, ref = knum.OutputSketch.for_outputs(arr), jnum.OutputSketch.for_outputs(arr)
        assert port.record() == ref.record()
        restored = knum.OutputSketch.from_record(json.loads(json.dumps(port.record())))
        assert restored.divergence(port) == pytest.approx(0.0, abs=1e-9)

    def drive(mod):
        base = mod.OutputSketch.for_outputs(np.zeros(64, np.int64)).record()
        mon = mod.DriftMonitor("drifter", base, tol=0.25)
        mon.observe(np.ones(64, np.int64))
        mon.observe(np.ones(64, np.int64))
        for _ in range(40):
            mon.observe(np.zeros(256, np.int64))
        for _ in range(80):
            mon.observe(np.ones(512, np.int64))
        return mon.record()

    before = pres.counters.get("serve_output_drift")
    port, ref = drive(knum), drive(jnum)
    assert port == ref and port["breaches"] == 2
    assert pres.counters.get("serve_output_drift") - before == 2
    assert set(knum.snapshot()) == set(jnum.snapshot())


def test_probes_off_by_default_and_value_unchanged():
    x = torch.randn(16, 8, generator=torch.Generator().manual_seed(0))
    pipe = Pipeline([FunctionTransformer(lambda b: b * 2, name="double"),
                     FunctionTransformer(torch.relu, name="relu")])
    off = pipe(x)
    assert knum.site_stats() == {}
    with knum.monitored():
        on = pipe(x)
    assert torch.equal(off, on)
    sites = knum.site_stats()
    assert set(sites) == {"pipeline.double", "pipeline.relu"}
    assert sites["pipeline.relu"]["last"]["min"] >= 0.0


def test_stream_featurize_probe_names_its_site(tmp_path):
    tar = str(tmp_path / "c.tar")
    _write_cifar_tar(tar, 5, np.random.default_rng(2))
    with knum.monitored():
        with ingest.stream_batches(tar, 4, device="cpu") as st:
            outs = [b.apply(lambda px: px.mean(dim=(1, 2))) for b in st]
    assert [o.shape[0] for o in outs] == [4, 1]
    assert knum.site_stats()["stream.featurize.48x48"]["visits"] == 2


def test_solver_conditioning_hooks():
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(128, 24, generator=gen)
    y = torch.nn.functional.one_hot(torch.arange(128) % 3, 3).float()
    off = BlockLeastSquaresEstimator(8, 1, 0.1).fit(x, y)
    assert knum.recent_conditioning() == []
    with knum.monitored():
        on = BlockLeastSquaresEstimator(8, 1, 0.1).fit(x, y)
        BlockWeightedLeastSquaresEstimator(8, 1, 0.1, 0.25).fit(x, y)
        solve_gram_l2(x.T @ x, x.T @ y, 0.1)
    for a, b in zip(off.xs, on.xs):
        assert torch.equal(a, b)
    labels = [r["label"] for r in knum.recent_conditioning()]
    assert labels == [f"bcd_fit:block{i}" for i in range(3)] + [
        f"bwls_fit:block{i}" for i in range(3)] + ["solve_gram_l2"]
    assert all(r["kappa"] >= 1.0 for r in knum.recent_conditioning())


def test_nonfinite_model_error_carries_provenance():
    x = np.zeros((4, 2), np.float32)
    x[1, 0] = np.nan
    with knum.monitored():
        knum.probe("stream.featurize.48x48", torch.from_numpy(x), names=["a", "bad.jpg", "c", "d"])
    with pytest.raises(FloatingPointError, match="bad.jpg"):
        pres.assert_all_finite([torch.from_numpy(x)], "model")
