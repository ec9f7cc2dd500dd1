"""The TimitPipeline slice (CPU): the loader, ``CosineRandomFeatures`` and the
per-block featurizers against the JAX package's on the same inputs, the
whole run with the JAX draws carried across, the servable chain, the
fitted state through ``keystone_tpu_torch.convert``, and the CLI on CSVs.

The data are ``tests/test_timit.py``'s synthetic phones (24 dims, 6
classes), with class centres close enough that the JAX run errs on about
15 % of the test frames.  Tolerances: Gaussian cosine features atol 1e-5
(the JAX package's own bar for the node); Cauchy features atol
4·eps32·max|xWᵀ+b| (the heavy-tailed draw puts arguments in the hundreds,
where two f32 products that sum in another order differ by a few ulps of
the argument, and cos passes that on); scaler moments rtol 1e-4 (f32 sums
in another order); scores atol 1e-4·max; predictions and test errors
identical."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.loaders.timit import timit_features_loader as jax_loader
from keystone_tpu.ops.stats import CosineRandomFeatures as JaxCRF
from keystone_tpu.ops.util import ClassLabelIndicatorsFromIntLabels as JaxLabels
from keystone_tpu.solvers.block import BlockLeastSquaresEstimator as JaxBLS
from keystone_tpu.workloads import timit as jax_timit
from keystone_tpu_torch import convert
from keystone_tpu_torch.loaders.timit import timit_features_loader
from keystone_tpu_torch.ops.stats import CosineRandomFeatures
from keystone_tpu_torch.solvers.block import BlockLeastSquaresEstimator
from keystone_tpu_torch.solvers.normal_equations import cho_factor
from keystone_tpu_torch.workloads import timit as pt_timit
from test_timit import write_split
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401

D, K = 24, 6
# 3 blocks of 128 cosine features, 2 epochs, at lambda 0 (BASELINE config 4's).
CONF = dict(num_cosines=3, num_cosine_features=128, num_epochs=2, gamma=0.2, lam=0.0,
            num_classes=K, dimension=D)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    rng = np.random.default_rng(3)
    d = tmp_path_factory.mktemp("timit")
    centers = rng.normal(scale=0.3, size=(K, D))
    train = write_split(d, "train", 300, rng, centers)[:2]
    test = write_split(d, "test", 100, rng, centers)[:2]
    return (*train, *test)


@pytest.fixture(scope="module")
def data(files):
    return timit_features_loader(*files)


def test_loader_matches_jax(files, data):
    ref = jax_loader(*files)
    for split in ("train", "test"):
        got, want = getattr(data, split), getattr(ref, split)
        assert got.data.dtype == np.float32 and got.labels.dtype == np.int32
        np.testing.assert_array_equal(got.data, want.data)
        np.testing.assert_array_equal(got.labels, want.labels)


def _carried(rf) -> CosineRandomFeatures:
    return CosineRandomFeatures(torch.from_numpy(np.array(rf.W)), torch.from_numpy(np.array(rf.b)))


@pytest.mark.parametrize("w_dist", ["gaussian", "cauchy"])
def test_cosine_random_features_match_jax(data, w_dist):
    ref = JaxCRF.create(D, 256, 0.2, jax.random.PRNGKey(5), w_dist=w_dist)
    x = data.test.data
    want = np.asarray(ref(jnp.asarray(x)))
    got = _carried(ref)(torch.from_numpy(x)).numpy()
    if w_dist == "gaussian":
        atol = 1e-5
    else:
        arg = np.abs(x.astype(np.float64) @ np.asarray(ref.W, np.float64).T + np.asarray(ref.b))
        assert arg.max() > 1e2  # the heavy tail this tolerance is for
        atol = 4 * np.finfo(np.float32).eps * arg.max()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("w_dist", ["gaussian", "cauchy"])
def test_cosine_random_features_draws(w_dist):
    gen = torch.Generator().manual_seed(0)
    rf = CosineRandomFeatures.create(400, 1000, 0.5, gen, w_dist=w_dist)
    again = CosineRandomFeatures.create(400, 1000, 0.5, torch.Generator().manual_seed(0),
                                        w_dist=w_dist)
    torch.testing.assert_close(rf.W, again.W, rtol=0, atol=0)
    assert tuple(rf.W.shape) == (1000, 400) and tuple(rf.b.shape) == (1000,)
    w = rf.W.numpy()
    if w_dist == "gaussian":
        assert abs(w.mean()) < 0.01 and abs(w.std() - 0.5) < 0.01
    else:  # Cauchy: the median of |W| is gamma, the tail is heavy
        assert abs(np.median(np.abs(w)) - 0.5) < 0.01 and np.abs(w).max() > 1e3
    assert 0 <= rf.b.min() and rf.b.max() < 2 * np.pi
    with pytest.raises(ValueError, match="unknown w_dist"):
        CosineRandomFeatures.create(4, 4, 1.0, gen, w_dist="laplace")


@pytest.fixture(scope="module")
def jax_fit(data):
    """The JAX run and its fitted state, rebuilt step by step as its run
    builds it (the run returns no model)."""
    conf = jax_timit.TimitConfig(**CONF)
    res = jax_timit.run(conf, data)
    featurizers = jax_timit.build_batch_featurizers(conf, jnp.asarray(data.train.data))
    train_batches = [f(jnp.asarray(data.train.data)) for f in featurizers]
    test_batches = [f(jnp.asarray(data.test.data)) for f in featurizers]
    model = JaxBLS(conf.num_cosine_features, conf.num_epochs, conf.lam).fit(
        train_batches, JaxLabels(K)(data.train.labels)
    )
    return dict(
        res=res,
        rfs=[f.nodes[0] for f in featurizers],
        scalers=[f.nodes[1] for f in featurizers],
        train_batches=[np.asarray(b) for b in train_batches],
        scores=np.asarray(model(test_batches)),
        model=model,
    )


def test_batch_featurizers_match_jax(data, jax_fit):
    rfs = [_carried(rf) for rf in jax_fit["rfs"]]
    featurizers, blocks = pt_timit.build_batch_featurizers(rfs, torch.from_numpy(data.train.data))
    assert len(featurizers) == len(blocks) == CONF["num_cosines"]
    for f, want_scaler, block, want in zip(featurizers, jax_fit["scalers"], blocks,
                                           jax_fit["train_batches"]):
        scaler = f.nodes[1]
        np.testing.assert_allclose(scaler.mean.numpy(), np.asarray(want_scaler.mean),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(scaler.std.numpy(), np.asarray(want_scaler.std), rtol=1e-4)
        np.testing.assert_allclose(block.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())
        # The chain applied anew reproduces the block it was fitted on.
        torch.testing.assert_close(f(torch.from_numpy(data.train.data)), block)


@pytest.fixture(scope="module")
def port_run(data, jax_fit):
    conf = pt_timit.TimitConfig(**CONF, device="cpu")
    return pt_timit.run(conf, data, random_features=[_carried(rf) for rf in jax_fit["rfs"]])


def test_run_with_jax_draws_matches_jax(jax_fit, port_run):
    want = jax_fit["scores"]
    np.testing.assert_allclose(port_run["test_scores"], want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    assert port_run["test_error"] == jax_fit["res"]["test_error"]
    assert 0.0 < port_run["test_error"] < 30.0  # chance is 5/6
    for key in ("seconds", "featurize_seconds", "solve_seconds", "eval_seconds"):
        assert port_run[key] > 0, key


@pytest.mark.parametrize("batch", [1, 4, 16])
def test_servable_matches_offline_predictions(data, port_run, batch):
    servable = port_run["servable"]
    x = torch.from_numpy(data.test.data[:48])
    served = np.concatenate([servable(x[i : i + batch]).numpy() for i in range(0, 48, batch)])
    np.testing.assert_array_equal(served, port_run["test_scores"][:48].argmax(axis=1))


def test_state_round_trips_through_convert(data, jax_fit, port_run):
    arrays = convert.timit_to_arrays(port_run["servable"])
    assert len(arrays["W"]) == len(arrays["xs"]) == CONF["num_cosines"]
    fitted = convert.timit_from_arrays(**arrays, device="cpu")
    x = torch.from_numpy(data.test.data)
    scores = fitted.model([f(x) for f in fitted.featurizers]).numpy()
    np.testing.assert_array_equal(scores, port_run["test_scores"])
    # The JAX package's fitted state, carried in, scores as the JAX model.
    model = jax_fit["model"]
    jax_state = convert.timit_from_arrays(
        W=[np.array(rf.W) for rf in jax_fit["rfs"]], b=[np.array(rf.b) for rf in jax_fit["rfs"]],
        scaler_means=[np.array(s.mean) for s in jax_fit["scalers"]],
        scaler_stds=[np.array(s.std) for s in jax_fit["scalers"]],
        xs=[np.array(m) for m in model.xs],
        block_means=[np.array(s.mean) for s in model.feature_scalers],
        intercept=np.array(model.b), block_size=CONF["num_cosine_features"], device="cpu",
    )
    want = jax_fit["scores"]
    got = jax_state.model([f(x) for f in jax_state.featurizers]).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    np.testing.assert_array_equal(jax_state.servable(x).numpy(), want.argmax(axis=1))


def test_run_rejects_a_diverged_model(data, monkeypatch):
    def poisoned_fit(self, features, labels, **kw):
        model = real_fit(self, features, labels, **kw)
        model.xs[0][0, 0] = float("nan")
        return model

    real_fit = BlockLeastSquaresEstimator.fit
    monkeypatch.setattr(BlockLeastSquaresEstimator, "fit", poisoned_fit)
    with pytest.raises(FloatingPointError, match="non-finite"):
        pt_timit.run(pt_timit.TimitConfig(**CONF, device="cpu"), data)


def test_cli_on_csvs(files):
    train_data, train_labels, test_data, test_labels = files
    res = pt_timit.main([
        "--trainDataLocation", train_data, "--trainLabelsLocation", train_labels,
        "--testDataLocation", test_data, "--testLabelsLocation", test_labels,
        "--numCosines", "2", "--numEpochs", "2", "--lambda", "10", "--gamma", "0.2",
        "--rfType", "cauchy", "--device", "cpu",
    ])
    assert res["test_error"] < 50.0  # chance is 5/6
    assert res["load_seconds"] > 0
    arrays = convert.timit_to_arrays(res["servable"])
    assert [w.shape for w in arrays["W"]] == [(4096, D)] * 2


def test_cli_needs_a_card_by_default(files, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    flags = ["--trainDataLocation", "--trainLabelsLocation", "--testDataLocation",
             "--testLabelsLocation"]
    with pytest.raises(RuntimeError, match="no CUDA card"):
        pt_timit.main([a for pair in zip(flags, files) for a in pair])


def test_card_cell_frames_give_nonsingular_grams_at_lambda_0():
    """``chip_smoke.py``'s TIMIT frames, at 2 blocks of 1,024 features and
    3,000 rows: every centred block gram factors in f32 at λ 0 (a singular
    one would NaN the BASELINE config 4 model), with a condition number far
    from f32's reach."""
    import chip_smoke

    rng = np.random.default_rng(13)
    centres = rng.normal(0.0, chip_smoke.TIMIT_CENTRE_SCALE, (147, 440))
    frames, _ = chip_smoke.timit_split(rng, 3000, centres)
    conf = pt_timit.TimitConfig(num_cosines=2, num_cosine_features=1024, device="cpu")
    _, blocks = pt_timit.build_batch_featurizers(
        pt_timit.draw_random_features(conf, "cpu"), torch.from_numpy(frames)
    )
    for block in blocks:
        centred = block - block.mean(dim=0)
        gram = centred.T @ centred
        assert torch.isfinite(cho_factor(gram)).all()
        eig = torch.linalg.eigvalsh(gram.double())
        assert eig[0] > 0 and eig[-1] / eig[0] < 1e4
