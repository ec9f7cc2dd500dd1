"""The MnistRandomFFT slice as a whole (CPU): one JAX-fitted state carried
into the port through ``keystone_tpu_torch.convert``, the port's fit on the
JAX package's features, the port's own run and servable chain, and its CLI
on CSVs.

The data are the 64-pixel, 5-class separable rows of
``tests/test_workloads_mesh.py``.  Tolerances: features atol 1e-5·max
(the two CPU FFTs round differently), scores atol 1e-4·max; predictions
identical; train and test errors within 1e-6 of the JAX run's (the bar of
``test_workloads_mesh.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.loaders.csv_loader import LabeledData as JaxLabeledData
from keystone_tpu.ops.util import (
    ClassLabelIndicatorsFromIntLabels as JaxLabels,
    GroupConcatFeaturizer as JaxGroupConcat,
    ZipVectors as JaxZip,
)
from keystone_tpu.solvers.block import BlockLeastSquaresEstimator as JaxBLS
from keystone_tpu.workloads import mnist_random_fft as jax_mnist
from keystone_tpu_torch import convert
from keystone_tpu_torch.evaluation.multiclass import MulticlassClassifierEvaluator
from keystone_tpu_torch.loaders.csv_loader import LabeledData
from keystone_tpu_torch.ops.util import ClassLabelIndicatorsFromIntLabels, MaxClassifier
from keystone_tpu_torch.solvers.block import BlockLeastSquaresEstimator
from keystone_tpu_torch.workloads import mnist_random_fft as pt_mnist

# 4 FFTs in groups of 2 (blockSize 1024): 2 groups of 2 x 32 features.
CONF = dict(num_ffts=4, block_size=1024, lam=1e-2, mnist_image_size=64, num_classes=5)


def _mnist_data(rng, n, d=64, k=5, centers=None):
    if centers is None:
        centers = rng.normal(size=(k, d))
    labels = rng.integers(0, k, n)
    data = (centers[labels] + 0.3 * rng.normal(size=(n, d))).astype(np.float32)
    return JaxLabeledData(data=data, labels=labels.astype(np.int32)), centers


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(42)
    train, centers = _mnist_data(rng, 203)
    test, _ = _mnist_data(rng, 101, centers=centers)
    return train, test


@pytest.fixture(scope="module")
def jax_fit(data):
    """The JAX run, and its fitted state rebuilt step by step as its run
    builds it (the run returns no model)."""
    train, test = data
    conf = jax_mnist.MnistRandomFFTConfig(**CONF)
    res = jax_mnist.run(conf, train, test)
    groups = jax_mnist.build_featurizer_batches(conf)
    train_batches = [JaxZip.apply([c(jnp.asarray(train.data)) for c in g]) for g in groups]
    test_batches = [JaxZip.apply([c(jnp.asarray(test.data)) for c in g]) for g in groups]
    model = JaxBLS(conf.block_size, 1, conf.lam).fit(
        train_batches, JaxLabels(conf.num_classes)(train.labels)
    )
    scores = np.asarray(model(test_batches))
    np.testing.assert_array_equal(np.argmax(scores, axis=1), res["test_predictions"])
    arrays = dict(
        signs=[[np.array(c.nodes[0].signs) for c in g] for g in groups],
        xs=[np.array(x) for x in model.xs],
        b=np.array(model.b),
        block_means=[np.array(s.mean) for s in model.feature_scalers],
        block_size=conf.block_size,
    )
    return dict(
        res=res, arrays=arrays, scores=scores,
        features=np.asarray(JaxGroupConcat(groups)(jnp.asarray(test.data))),
        train_batches=[np.array(b) for b in train_batches],
        test_batches=[np.array(b) for b in test_batches],
    )


def _port(split) -> LabeledData:
    return LabeledData(labels=split.labels, data=split.data)


def test_carried_over_state_matches_jax(data, jax_fit):
    _, test = data
    fitted = convert.mnist_from_arrays(**jax_fit["arrays"], device="cpu")
    x = torch.from_numpy(test.data)
    feats = fitted.servable.nodes[0](x).numpy()
    want = jax_fit["features"]
    np.testing.assert_allclose(feats, want, rtol=0, atol=1e-5 * np.abs(want).max())
    scores = fitted.model(torch.from_numpy(feats)).numpy()
    np.testing.assert_allclose(
        scores, jax_fit["scores"], rtol=0, atol=1e-4 * np.abs(jax_fit["scores"]).max()
    )
    np.testing.assert_array_equal(fitted.servable(x).numpy(), jax_fit["res"]["test_predictions"])
    again = convert.mnist_from_arrays(**convert.mnist_to_arrays(fitted.servable), device="cpu")
    np.testing.assert_array_equal(again.servable(x).numpy(), jax_fit["res"]["test_predictions"])


def test_port_fit_on_jax_features_matches_jax_errors(data, jax_fit):
    train, test = data
    labels = ClassLabelIndicatorsFromIntLabels(5)(torch.from_numpy(train.labels))
    model = BlockLeastSquaresEstimator(CONF["block_size"], 1, CONF["lam"]).fit(
        [torch.from_numpy(b) for b in jax_fit["train_batches"]], labels
    )
    errors = {}

    def evaluator(split, actual):
        def evaluate(pred):
            metrics = MulticlassClassifierEvaluator(MaxClassifier()(pred), actual, 5)
            errors.setdefault(split, []).append(100.0 * metrics.total_error)
        return evaluate

    model.apply_and_evaluate([torch.from_numpy(b) for b in jax_fit["train_batches"]],
                             evaluator("train", train.labels))
    model.apply_and_evaluate([torch.from_numpy(b) for b in jax_fit["test_batches"]],
                             evaluator("test", test.labels))
    assert len(errors["train"]) == len(errors["test"]) == 2  # one call per block
    res = jax_fit["res"]
    assert abs(errors["train"][-1] - res["train_error"]) < 1e-6
    assert abs(errors["test"][-1] - res["test_error"]) < 1e-6


@pytest.fixture(scope="module")
def port_run(data):
    train, test = data
    conf = pt_mnist.MnistRandomFFTConfig(**CONF, device="cpu")
    return pt_mnist.run(conf, _port(train), _port(test))


def test_port_run_reaches_zero_error_with_its_results(data, jax_fit, port_run):
    _, test = data
    assert port_run["train_error"] == port_run["test_error"] == 0.0
    assert port_run["test_error"] == jax_fit["res"]["test_error"]
    for key in ("seconds", "featurize_seconds", "featurize_examples_per_sec",
                "solve_seconds", "eval_seconds"):
        assert port_run[key] > 0, key
    assert port_run["test_predictions"].shape == (len(test.labels),)
    groups = port_run["servable"].nodes[0].groups
    assert [len(g) for g in groups] == [2, 2]


@pytest.mark.parametrize("batch", [1, 4, 16])
def test_servable_matches_offline_predictions(data, port_run, batch):
    _, test = data
    servable = port_run["servable"]
    served = np.concatenate([
        servable(torch.from_numpy(test.data[i : i + batch])).numpy()
        for i in range(0, 64, batch)
    ])
    np.testing.assert_array_equal(served, port_run["test_predictions"][:64])


def test_run_rejects_a_diverged_model(data, monkeypatch):
    train, test = data

    def poisoned_fit(self, features, labels, **kw):
        model = real_fit(self, features, labels, **kw)
        model.xs[0][0, 0] = float("nan")
        return model

    real_fit = BlockLeastSquaresEstimator.fit
    monkeypatch.setattr(BlockLeastSquaresEstimator, "fit", poisoned_fit)
    conf = pt_mnist.MnistRandomFFTConfig(**CONF, device="cpu")
    with pytest.raises(FloatingPointError, match="non-finite"):
        pt_mnist.run(conf, _port(train), _port(test))


@pytest.fixture(scope="module")
def csv_files(tmp_path_factory):
    """The verify recipe's data: 784-pixel rows, 10 classes, centres shared
    between 600 train and 200 test rows, 1-indexed labels in column 0."""
    rng = np.random.default_rng(7)
    centers = rng.normal(0, 1.0, (10, 784))

    def make(n):
        labels = rng.integers(1, 11, n)
        return np.column_stack([labels, centers[labels - 1] + 0.3 * rng.normal(size=(n, 784))])

    d = tmp_path_factory.mktemp("mnist")
    train, test = str(d / "train.csv"), str(d / "test.csv")
    np.savetxt(train, make(600), delimiter=",", fmt="%.5f")
    np.savetxt(test, make(200), delimiter=",", fmt="%.5f")
    return train, test


def test_cli_on_csvs_reaches_zero_error(csv_files):
    train, test = csv_files
    res = pt_mnist.main(["--trainLocation", train, "--testLocation", test, "--numFFTs", "4",
                         "--blockSize", "512", "--lambda", "10", "--device", "cpu"])
    assert res["train_error"] == 0.0 and res["test_error"] == 0.0
    assert res["load_seconds"] > 0
    assert [len(g) for g in res["servable"].nodes[0].groups] == [1, 1, 1, 1]


def test_cli_needs_a_card_by_default(csv_files, monkeypatch):
    train, test = csv_files
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        pt_mnist.main(["--trainLocation", train, "--testLocation", test])


@pytest.mark.parametrize("flags", [
    ["--mesh", "8"], ["--pipelineFile", "fitted"], ["--solveCheckpoint", "bcd"],
    ["--autoCache"], ["--serve"], ["--trace", "t.json"], ["--blockSize", "300"],
    ["--blockSize", "0"],
])
def test_cli_usage_errors(csv_files, flags):
    train, test = csv_files
    with pytest.raises(SystemExit):
        pt_mnist.main(["--trainLocation", train, "--testLocation", test, "--device", "cpu",
                       *flags])
