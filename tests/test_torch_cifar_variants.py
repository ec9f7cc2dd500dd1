"""LinearPixels and RandomCifar (CPU) against the JAX package's runs on the
same synthetic CIFAR files, with RandomCifar's JAX filter bank carried
across; the binary evaluator and the labelled-image extractors.

The data are ``tests/test_torch_cifar_random_patch.py``'s separable
4-class images, 1,500 / 300, so that LinearPixels' unregularised gram on
1,024 grey pixels is not singular.  Tolerances: RandomCifar features rtol
2e-5, atol 2e-5·max (f32 convolutions and pool sums in another order, the
bar of the f32 RandomPatchCifar featurizer); RandomCifar scores atol
1e-4·max; LinearPixels scores atol 1e-3·max (two f32 Cholesky solves of a
grey-pixel gram with a condition number near 1e5, so κ·eps32 ≈ 1e-2 bounds
them); predictions, errors, accuracies and the binary counts identical."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.evaluation.multiclass import BinaryClassifierEvaluator as JaxBinaryEval
from keystone_tpu.loaders.cifar import LabeledImageBatch as JaxBatch
from keystone_tpu.ops import images as jax_images
from keystone_tpu.ops.stats import StandardScaler as JaxScaler
from keystone_tpu.ops.util import ClassLabelIndicatorsFromIntLabels as JaxLabels
from keystone_tpu.solvers.linear import LinearMapEstimator as JaxLinear
from keystone_tpu.workloads import linear_pixels as jax_lp
from keystone_tpu.workloads import random_cifar as jax_rc
from keystone_tpu_torch import convert
from keystone_tpu_torch.core.pipeline import Pipeline
from keystone_tpu_torch.evaluation.multiclass import BinaryClassifierEvaluator
from keystone_tpu_torch.loaders.cifar import LabeledImageBatch, cifar_loader
from keystone_tpu_torch.ops import images
from keystone_tpu_torch.ops import rect_pool as rp
from keystone_tpu_torch.workloads import cifar_random_patch as pt_cifar
from keystone_tpu_torch.workloads import linear_pixels as pt_lp
from keystone_tpu_torch.workloads import random_cifar as pt_rc
from test_torch_cifar_random_patch import _write_cifar
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401

RC_CONF = dict(num_filters=24, lam=10.0, num_classes=4)


@pytest.fixture(scope="module")
def cifar_files(tmp_path_factory):
    rng = np.random.default_rng(9)
    base = rng.uniform(40, 215, (4, 3))
    d = tmp_path_factory.mktemp("cifar_variants")
    train, test = str(d / "train.bin"), str(d / "test.bin")
    _write_cifar(train, 1500, rng, base)
    _write_cifar(test, 300, rng, base)
    return train, test


@pytest.fixture(scope="module")
def splits(cifar_files):
    return cifar_loader(cifar_files[0]), cifar_loader(cifar_files[1])


def test_linear_pixels_matches_jax(splits):
    train, test = splits
    conf = jax_lp.LinearPixelsConfig(num_classes=4)
    want = jax_lp.run(conf, JaxBatch(train.images, train.labels),
                      JaxBatch(test.images, test.labels))
    res = pt_lp.run(pt_lp.LinearPixelsConfig(num_classes=4, device="cpu"), train, test)
    assert res["train_accuracy"] == want["train_accuracy"]
    assert res["test_accuracy"] == want["test_accuracy"]
    assert res["test_accuracy"] > 0.9  # chance is 1/4
    # The JAX chain's predictions, step by step as its run makes them.
    featurize = jax_images.GrayScaler().then(jax_images.ImageVectorizer())
    model = JaxLinear().fit(featurize(jnp.asarray(train.images)), JaxLabels(4)(train.labels))
    scores = np.asarray(model(featurize(jnp.asarray(test.images))))
    np.testing.assert_array_equal(res["test_predictions"], scores.argmax(axis=1))
    port_scores = Pipeline(res["servable"].nodes[:-1])(torch.from_numpy(test.images))
    np.testing.assert_allclose(port_scores.numpy(), scores, rtol=0,
                               atol=1e-3 * np.abs(scores).max())


@pytest.fixture(scope="module")
def jax_random_cifar(splits):
    """The JAX run, and its fitted state rebuilt step by step as its run
    builds it (the run returns no model)."""
    train, test = splits
    conf = jax_rc.RandomCifarWorkloadConfig(**RC_CONF)
    res = jax_rc.run(conf, JaxBatch(train.images, train.labels), JaxBatch(test.images, test.labels))
    filters = jax.random.normal(jax.random.PRNGKey(conf.seed), (24, 6 * 6 * 3))
    conv = jax_images.Convolver(filters, normalize_patches=True, img_channels=3).then(
        jax_images.SymmetricRectifier(alpha=conf.alpha)).then(
        jax_images.Pooler(conf.pool_stride, conf.pool_size, None, "sum")).then(
        jax_images.ImageVectorizer())
    train_conv = conv(jnp.asarray(train.images))
    scaler = JaxScaler().fit(train_conv)
    model = JaxLinear(lam=conf.lam).fit(scaler(train_conv), JaxLabels(4)(train.labels))
    test_conv = conv(jnp.asarray(test.images))
    scores = np.asarray(model(scaler(test_conv)))
    return dict(res=res, filters=np.asarray(filters), test_conv=np.asarray(test_conv),
                scores=scores, scaler=scaler, model=model)


def test_random_cifar_with_jax_filters_matches_jax(splits, jax_random_cifar, monkeypatch):
    monkeypatch.setattr(rp, "fused_launches", 0)
    train, test = splits
    want = jax_random_cifar
    conf = pt_rc.RandomCifarWorkloadConfig(**RC_CONF, featurize_chunk=256, device="cpu")
    res = pt_rc.run(conf, train, test, filters=torch.from_numpy(want["filters"]))
    assert rp.fused_launches == 0  # the CPU path runs conv_rect_pool's plain version
    featurizer = res["servable"].nodes[0]
    feats = featurizer(torch.from_numpy(test.images)).numpy()
    ref = want["test_conv"]
    np.testing.assert_allclose(feats, ref, rtol=2e-5, atol=2e-5 * np.abs(ref).max())
    np.testing.assert_array_equal(res["test_predictions"], want["scores"].argmax(axis=1))
    assert res["train_error"] == want["res"]["train_error"]
    assert res["test_error"] == want["res"]["test_error"] < 10.0  # chance is 75 %
    for key in ("seconds", "featurize_seconds", "featurize_images_per_sec", "solve_seconds"):
        assert res[key] > 0, key
    for chunk in (1, 16):
        served = pt_cifar.apply_servable_chunked(res["servable"], test.images[:32], chunk)
        np.testing.assert_array_equal(served, res["test_predictions"][:32])


def test_random_cifar_state_carried_from_jax(splits, jax_random_cifar):
    _, test = splits
    want = jax_random_cifar
    model = want["model"]
    fitted = convert.random_cifar_from_arrays(
        filters=want["filters"], scaler_mean=np.asarray(want["scaler"].mean),
        scaler_std=np.asarray(want["scaler"].std), x=np.asarray(model.x), b=np.asarray(model.b),
        feature_mean=np.asarray(model.feature_scaler.mean), device="cpu",
    )
    x = torch.from_numpy(test.images)
    scores = fitted.model(fitted.scaler(fitted.featurizer(x))).numpy()
    np.testing.assert_allclose(scores, want["scores"], rtol=0,
                               atol=1e-4 * np.abs(want["scores"]).max())
    np.testing.assert_array_equal(fitted.servable(x).numpy(), want["scores"].argmax(axis=1))


def test_random_cifar_draws_its_own_filters():
    conf = pt_rc.RandomCifarWorkloadConfig(num_filters=7, seed=3)
    a, b = pt_rc.draw_filters(conf), pt_rc.draw_filters(conf)
    assert tuple(a.shape) == (7, 108) and torch.equal(a, b)
    assert not torch.equal(a, pt_rc.draw_filters(pt_rc.RandomCifarWorkloadConfig(seed=4))[:7])


@pytest.mark.parametrize("module,flags", [
    (pt_lp, []),
    (pt_rc, ["--numFilters", "16", "--lambda", "10", "--sampleFrac", "0.5"]),
])
def test_cli(cifar_files, module, flags, monkeypatch):
    train, test = cifar_files
    res = module.main(["--trainLocation", train, "--testLocation", test, *flags,
                       "--device", "cpu"])
    error = res["test_error"] if "test_error" in res else 100.0 * (1.0 - res["test_accuracy"])
    assert error < 10.0  # chance is 75 %
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        module.main(["--trainLocation", train, "--testLocation", test, *flags])


def test_binary_classifier_evaluator_matches_jax(rng):
    pred = rng.random(200) < 0.4
    actual = rng.random(200) < 0.5
    want = JaxBinaryEval(pred, actual)
    as_tensors = (torch.from_numpy(pred), torch.from_numpy(actual.astype(np.int64)))
    for p, a in ((pred, actual), as_tensors):
        got = BinaryClassifierEvaluator(p, a)
        assert (got.tp, got.fp, got.tn, got.fn) == (want.tp, want.fp, want.tn, want.fn)
        assert got.f_score() == pytest.approx(want.f_score())
    assert want.tp + want.fp + want.tn + want.fn == 200


def test_image_and_label_extractors_match_jax(splits):
    _, test = splits
    batch = LabeledImageBatch(test.images[:5], test.labels[:5])
    jax_batch = JaxBatch(test.images[:5], test.labels[:5])
    for node, jax_node in ((images.ImageExtractor(), jax_images.ImageExtractor()),
                           (images.LabelExtractor(), jax_images.LabelExtractor())):
        np.testing.assert_array_equal(node(batch), jax_node(jax_batch))
    assert images.MultiLabelExtractor is images.LabelExtractor
    assert images.MultiLabeledImageExtractor is images.ImageExtractor
