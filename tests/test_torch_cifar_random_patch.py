"""The RandomPatchCifar slice as a whole: the port's CLI on a small
separable synthetic CIFAR set (CPU), and one JAX-fitted state carried into
the port through ``keystone_tpu_torch.convert``.

Tolerances: f32 features rtol 2e-5, atol 2e-5·max; bf16 features within
1e-2 of max; predictions identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.loaders.cifar import cifar_loader as jax_cifar_loader
from keystone_tpu.ops.conv_fused import FusedConvFeaturizer as JaxFused
from keystone_tpu.ops.stats import StandardScaler as JaxScaler
from keystone_tpu.ops.util import (
    ClassLabelIndicatorsFromIntLabels as JaxLabels,
    MaxClassifier as JaxMax,
)
from keystone_tpu.solvers.block import BlockLeastSquaresEstimator as JaxBLS
from keystone_tpu.workloads import cifar_random_patch as jax_cifar
from keystone_tpu_torch import convert
from keystone_tpu_torch.loaders.cifar import cifar_loader
from keystone_tpu_torch.ops import rect_pool as rp
from keystone_tpu_torch.workloads import cifar_random_patch as pt_cifar
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401

FLAGS = ["--numFilters", "24", "--patchSteps", "2", "--whitenerSize", "3000", "--lambda", "10"]


def _write_cifar(path, n, rng, base):
    labels = rng.integers(0, 4, n).astype(np.uint8)
    recs = np.zeros((n, 3073), np.uint8)
    _, xx = np.mgrid[0:32, 0:32]
    for i in range(n):
        img = base[labels[i]][:, None, None] + rng.normal(0, 25, (3, 32, 32))
        img[labels[i] % 3] += 30 * np.sin(xx / (2.0 + labels[i]))
        recs[i, 0] = labels[i]
        recs[i, 1:] = np.clip(img, 0, 255).astype(np.uint8).reshape(-1)
    recs.tofile(path)


@pytest.fixture(scope="module")
def cifar_files(tmp_path_factory):
    """400 train / 150 test images, 4 classes, palette shared between splits."""
    rng = np.random.default_rng(5)
    base = rng.uniform(40, 215, (4, 3))
    d = tmp_path_factory.mktemp("cifar")
    train, test = str(d / "train.bin"), str(d / "test.bin")
    _write_cifar(train, 400, rng, base)
    _write_cifar(test, 150, rng, base)
    return train, test


@pytest.fixture(scope="module")
def jax_fit(cifar_files):
    """The JAX package's fitted RandomPatchCifar state on the small set."""
    train_path, test_path = cifar_files
    conf = jax_cifar.RandomCifarConfig(
        num_filters=24, patch_steps=2, whitener_size=3000, lam=10.0, featurize_chunk=256
    )
    train, test = jax_cifar_loader(train_path), jax_cifar_loader(test_path)
    filters, whitener = jax_cifar.learn_filters(conf, train.images)
    conv = jax_cifar.build_conv_pipeline(conf, filters, whitener, fused=True)
    train_conv = jax_cifar.featurize_chunked(conv, train.images, conf.featurize_chunk)
    scaler = JaxScaler().fit(train_conv)
    labels = JaxLabels(conf.num_classes)(train.labels)
    model = JaxBLS(4096, 1, conf.lam).fit(scaler(train_conv), labels)
    test_feats = jax_cifar.featurize_chunked(conv, test.images, conf.featurize_chunk)
    test_pred = np.asarray(JaxMax()(model(scaler(test_feats))))
    assert (test_pred == test.labels).all()  # the JAX path reaches 0% too
    arrays = dict(
        filters=np.asarray(filters).reshape(24, 6, 6, 3),
        whitener=np.asarray(whitener.whitener),
        whitener_means=np.asarray(whitener.means),
        scaler_mean=np.asarray(scaler.mean),
        scaler_std=np.asarray(scaler.std),
        xs=[np.asarray(x) for x in model.xs],
        b=np.asarray(model.b),
        block_means=[np.asarray(s.mean) for s in model.feature_scalers],
    )
    return conf, test, arrays, np.asarray(test_feats), test_pred


def test_port_cli_reaches_zero_error(cifar_files, monkeypatch):
    monkeypatch.setattr(rp, "launches", 0)
    train, test = cifar_files
    res = pt_cifar.main(["--trainLocation", train, "--testLocation", test, *FLAGS, "--device", "cpu"])
    assert res["train_error"] == 0.0
    assert res["test_error"] == 0.0
    for key in ("test_predictions", "seconds", "featurize_seconds", "featurize_images_per_sec"):
        assert key in res
    assert rp.launches == 0  # the CPU path runs the plain version
    images = cifar_loader(test).images
    for chunk in (1, 16, 64):
        served = pt_cifar.apply_servable_chunked(res["servable"], images[:64], chunk)
        np.testing.assert_array_equal(served, res["test_predictions"][:64])
    again = convert.from_arrays(**convert.to_arrays(res["servable"]), device="cpu")
    np.testing.assert_array_equal(
        pt_cifar.apply_servable_chunked(again.servable, images, 256), res["test_predictions"]
    )


def test_cli_auto_shard_records_the_placement(cifar_files, monkeypatch, tmp_path):
    """``--autoShard`` forces the placement search of the block solve: the
    results carry its table, and the predictions are the hand ladder's.  The
    test's own empty plan log keeps the untrained ranking."""
    monkeypatch.setenv("KEYSTONE_PLAN_LOG", str(tmp_path / "plans.jsonl"))
    train, test = cifar_files
    argv = ["--trainLocation", train, "--testLocation", test, *FLAGS, "--device", "cpu"]
    searched = pt_cifar.main([*argv, "--autoShard"])
    placement = searched["placement"]
    assert placement["ranking"] == ["fused", "stepwise", "host_staged"]
    assert placement["chosen"] == searched["fit_report"]["chosen_tier"] == "fused"
    monkeypatch.setenv("KEYSTONE_AUTOSHARD", "0")
    hand = pt_cifar.main(argv)
    assert "placement" not in hand and hand["fit_report"]["placement"] is None
    np.testing.assert_array_equal(searched["test_predictions"], hand["test_predictions"])


def test_cli_rejects_unported_flags(cifar_files):
    """Beside ``--mesh``, ``--autoCache`` is taken, with the predictions of
    the ``--mesh 1`` run; so is ``--serveMesh``, which, as in the JAX CLI,
    is not read without ``--serve``: the same predictions again."""
    train, test = cifar_files
    argv = ["--trainLocation", train, "--testLocation", test, *FLAGS, "--device", "cpu",
            "--mesh", "1"]
    cached = pt_cifar.main([*argv, "--autoCache"])
    assert cached["cache_plan"]["cached"] == ["conv_featurize"]
    plain = pt_cifar.main(argv)["test_predictions"]
    np.testing.assert_array_equal(cached["test_predictions"], plain)
    served_mesh = pt_cifar.main([*argv, "--serveMesh", "1x1"])
    assert "serving" not in served_mesh
    np.testing.assert_array_equal(served_mesh["test_predictions"], plain)


def test_carried_over_state_matches_jax(jax_fit):
    conf, test, arrays, jax_test_feats, jax_pred = jax_fit
    fitted = convert.from_arrays(**arrays, device="cpu")
    feats = fitted.featurizer(torch.from_numpy(test.images)).numpy()
    err = np.abs(feats - jax_test_feats).max() / np.abs(jax_test_feats).max()
    assert err < 1e-2, err
    pred = pt_cifar.apply_servable_chunked(fitted.servable, test.images, 64)
    np.testing.assert_array_equal(pred, jax_pred)

    # f32 activations: the exact path against the JAX featurizer in f32.
    f32 = convert.from_arrays(**arrays, activation_dtype=torch.float32, device="cpu")
    ref = np.asarray(
        JaxFused(
            jnp.asarray(arrays["filters"]), whitener_means=jnp.asarray(arrays["whitener_means"]),
            pool_stride=conf.pool_stride, pool_size=conf.pool_size, alpha=conf.alpha,
            activation_dtype=jnp.float32,
        )(jnp.asarray(test.images[:32]))
    )
    got = f32.featurizer(torch.from_numpy(test.images[:32])).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5 * np.abs(ref).max())
    np.testing.assert_array_equal(
        pt_cifar.apply_servable_chunked(f32.servable, test.images, 64), jax_pred
    )

    # The carried whitener applies as the JAX one does.
    patches = np.random.default_rng(0).normal(size=(10, 108)).astype(np.float32)
    expect = (patches - arrays["whitener_means"]) @ arrays["whitener"]
    np.testing.assert_allclose(
        fitted.whitener(torch.from_numpy(patches)).numpy(), expect, rtol=1e-4, atol=1e-4
    )
