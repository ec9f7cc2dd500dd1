"""The port's workloads under a mesh (``run(..., mesh=)`` and ``--mesh``)
against their single-device runs and the JAX package's mesh runs, at the
bars of ``tests/test_workloads_mesh.py``.

The port's meshes are 8 slots of the one CPU; the JAX side runs on the
conftest's 8 virtual CPU devices.  Inputs are seeded numpy; the JAX
package's random draws (MNIST's signs, TIMIT's cosine maps) are carried
into the port so both fit the same features.  The port's Cifar learns its
filters with its own sampler, so its runs are held to the JAX package's
one-flip bands against the JAX runs' errors.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.loaders.cifar import cifar_loader as jax_cifar_loader
from keystone_tpu.loaders.csv_loader import LabeledData as JaxLabeledData
from keystone_tpu.parallel.mesh import make_mesh as jax_make_mesh
from keystone_tpu.workloads import cifar_random_patch as jax_cifar
from keystone_tpu.workloads import mnist_random_fft as jax_mnist
from keystone_tpu.workloads import timit as jax_timit
from keystone_tpu_torch.loaders.cifar import cifar_loader
from keystone_tpu_torch.loaders.csv_loader import LabeledData
from keystone_tpu_torch.loaders.timit import timit_features_loader
from keystone_tpu_torch.ops.stats import CosineRandomFeatures
from keystone_tpu_torch.parallel.mesh import make_mesh
from keystone_tpu_torch.workloads import cifar_random_patch as pt_cifar
from keystone_tpu_torch.workloads import linear_pixels as pt_lp
from keystone_tpu_torch.workloads import mnist_random_fft as pt_mnist
from keystone_tpu_torch.workloads import random_cifar as pt_rc
from keystone_tpu_torch.workloads import timit as pt_timit
from test_cifar_pipeline import write_synthetic_cifar
from test_timit import write_split
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401

CPU = torch.device("cpu")


def _mesh(data, model):
    return make_mesh(data, model, devices=[CPU] * (data * model))


# -- MnistRandomFFT: 203 rows on 4x2, errors within 1e-6 -----------------------

MNIST_CONF = dict(num_ffts=2, block_size=512, lam=1e-2, mnist_image_size=64, num_classes=5)


def _mnist_data(rng, n, d=64, k=5, centers=None):
    if centers is None:
        centers = rng.normal(size=(k, d))
    labels = rng.integers(0, k, n)
    data = (centers[labels] + 0.3 * rng.normal(size=(n, d))).astype(np.float32)
    return JaxLabeledData(data=data, labels=labels.astype(np.int32)), centers


def test_mnist_random_fft_mesh_matches_local_and_jax(rng, mesh42):
    train, centers = _mnist_data(rng, 203)  # deliberately not divisible by 4
    test, _ = _mnist_data(rng, 101, centers=centers)
    jconf = jax_mnist.MnistRandomFFTConfig(**MNIST_CONF)
    jax_sharded = jax_mnist.run(jconf, train, test, mesh=mesh42)
    groups = [[pt_mnist.fft_chain(torch.from_numpy(np.array(chain.nodes[0].signs)))
               for chain in group] for group in jax_mnist.build_featurizer_batches(jconf)]
    conf = pt_mnist.MnistRandomFFTConfig(**MNIST_CONF, device="cpu")
    port = [LabeledData(labels=s.labels, data=s.data) for s in (train, test)]
    local = pt_mnist.run(conf, *port, groups=groups)
    sharded = pt_mnist.run(conf, *port, mesh=_mesh(4, 2), groups=groups)
    assert sharded["fit_report"]["mesh_shape"] == {"data": 4, "model": 2}
    for key in ("train_error", "test_error"):
        assert abs(sharded[key] - local[key]) < 1e-6
        assert abs(sharded[key] - jax_sharded[key]) < 1e-6


# -- TimitPipeline: mesh8, a one-flip band --------------------------------------

TIMIT_CONF = dict(num_cosines=2, num_cosine_features=128, num_epochs=2, gamma=0.2,
                  lam=1e-3, num_classes=6, dimension=24)


@pytest.fixture(scope="module")
def timit_files(tmp_path_factory):
    rng = np.random.default_rng(11)
    d = tmp_path_factory.mktemp("timit")
    centers = rng.normal(scale=2.0, size=(6, 24))
    return (*write_split(d, "train", 205, rng, centers)[:2],
            *write_split(d, "test", 101, rng, centers)[:2])


def test_timit_mesh_matches_local_and_jax(timit_files, mesh8):
    data = timit_features_loader(*timit_files)
    jconf = jax_timit.TimitConfig(**TIMIT_CONF)
    jax_sharded = jax_timit.run(jconf, data, mesh=mesh8)
    jfeats = jax_timit.build_batch_featurizers(jconf, jnp.asarray(data.train.data))
    rfs = [CosineRandomFeatures(torch.from_numpy(np.array(f.nodes[0].W)),
                                torch.from_numpy(np.array(f.nodes[0].b))) for f in jfeats]
    conf = pt_timit.TimitConfig(**TIMIT_CONF, device="cpu")
    local = pt_timit.run(conf, data, random_features=rfs)
    sharded = pt_timit.run(conf, data, random_features=rfs, mesh=_mesh(8, 1))
    assert sharded["fit_report"]["chosen_tier"] == "fused[mesh 8x1]"
    # Error steps are 100/101 = 0.99 points: the band admits exactly one
    # flip from the f32 sums added in another order.
    assert abs(sharded["test_error"] - local["test_error"]) < 1.0
    assert abs(sharded["test_error"] - jax_sharded["test_error"]) < 1.0


# -- RandomPatchCifar: mesh8, train < 0.6, test < 1.1 ---------------------------

CIFAR_CONF = dict(num_filters=12, patch_size=6, patch_steps=2, lam=10.0, whitener_size=1500,
                  featurize_chunk=64, num_classes=4)


@pytest.fixture(scope="module")
def cifar_files(tmp_path_factory):
    rng = np.random.default_rng(42)
    d = tmp_path_factory.mktemp("cifar")
    palette = rng.uniform(40, 215, (4, 3))
    train, test = str(d / "train.bin"), str(d / "test.bin")
    write_synthetic_cifar(train, 201, rng, base=palette)
    write_synthetic_cifar(test, 99, rng, base=palette)
    return train, test


def test_cifar_random_patch_mesh_matches_local_and_jax(cifar_files):
    train_path, test_path = cifar_files
    jax_sharded = jax_cifar.run(
        jax_cifar.RandomCifarConfig(**CIFAR_CONF), jax_cifar_loader(train_path),
        jax_cifar_loader(test_path), mesh=jax_make_mesh(8, 1))
    conf = pt_cifar.RandomCifarConfig(**CIFAR_CONF, device="cpu")
    train, test = cifar_loader(train_path), cifar_loader(test_path)
    local = pt_cifar.run(conf, train, test)
    sharded = pt_cifar.run(conf, train, test, mesh=_mesh(8, 1))
    assert sharded["fit_report"]["chosen_tier"] == "fused[mesh 8x1]"
    # One-flip bands: train steps are 100/201 = 0.50 points, test 100/99 = 1.01.
    for want in (local, jax_sharded):
        assert abs(sharded["train_error"] - want["train_error"]) < 0.6
        assert abs(sharded["test_error"] - want["test_error"]) < 1.1
    assert sharded["test_error"] < 20.0  # chance is 75 %


def test_random_cifar_and_linear_pixels_mesh_match_local(cifar_files):
    train, test = (cifar_loader(p) for p in cifar_files)
    conf = pt_rc.RandomCifarWorkloadConfig(num_filters=12, lam=10.0, num_classes=4,
                                           featurize_chunk=64, device="cpu")
    local = pt_rc.run(conf, train, test)
    sharded = pt_rc.run(conf, train, test, mesh=_mesh(4, 2))
    assert abs(sharded["train_error"] - local["train_error"]) < 0.6
    assert abs(sharded["test_error"] - local["test_error"]) < 1.1
    lp_conf = pt_lp.LinearPixelsConfig(num_classes=4, device="cpu")
    lp_local = pt_lp.run(lp_conf, train, test)
    lp_sharded = pt_lp.run(lp_conf, train, test, mesh=_mesh(8, 1))
    assert abs(lp_sharded["train_accuracy"] - lp_local["train_accuracy"]) < 0.006
    assert abs(lp_sharded["test_accuracy"] - lp_local["test_accuracy"]) < 0.011


# -- the five CLIs: --mesh 1 is the run without a mesh, --mesh 2 is refused ----


@pytest.fixture(scope="module")
def mnist_csvs(tmp_path_factory):
    rng = np.random.default_rng(7)
    d = tmp_path_factory.mktemp("mnist")
    train, centers = _mnist_data(rng, 203)
    test, _ = _mnist_data(rng, 101, centers=centers)
    paths = []
    for name, split in (("train", train), ("test", test)):
        path = d / f"{name}.csv"
        np.savetxt(path, np.column_stack([split.labels + 1, split.data]), delimiter=",",
                   fmt="%.5f")
        paths.append(str(path))
    return paths


CLIS = ["cifar_random_patch", "random_cifar", "linear_pixels", "mnist_random_fft", "timit"]


def _cli_args(name, cifar_files, mnist_csvs, timit_files):
    train, test = cifar_files
    cifar = ["--trainLocation", train, "--testLocation", test]
    return {
        "cifar_random_patch": (pt_cifar, cifar + ["--numFilters", "12", "--patchSteps", "2",
                                                  "--whitenerSize", "1500", "--lambda", "10"]),
        "random_cifar": (pt_rc, cifar + ["--numFilters", "12", "--lambda", "10"]),
        "linear_pixels": (pt_lp, cifar),
        "mnist_random_fft": (pt_mnist, ["--trainLocation", mnist_csvs[0], "--testLocation",
                                        mnist_csvs[1], "--numFFTs", "2", "--blockSize", "512",
                                        "--lambda", "0.01"]),
        "timit": (pt_timit, [a for pair in zip(
            ["--trainDataLocation", "--trainLabelsLocation", "--testDataLocation",
             "--testLabelsLocation"], timit_files) for a in pair]
            + ["--numCosines", "2", "--numEpochs", "2", "--lambda", "10"]),
    }[name]


#: Config fields the CLIs have no flag for, cut so each run takes about a
#: second: the Cifar chunks to the 201 images, TIMIT's 4096 cosines a block.
SMALL = {"cifar_random_patch": ("RandomCifarConfig", dict(featurize_chunk=64)),
         "random_cifar": ("RandomCifarWorkloadConfig", dict(featurize_chunk=64)),
         "timit": ("TimitConfig", dict(num_cosine_features=128))}


@pytest.mark.parametrize("name", CLIS)
def test_cli_mesh_one_is_the_run_without_a_mesh(name, cifar_files, mnist_csvs, timit_files,
                                                monkeypatch):
    module, args = _cli_args(name, cifar_files, mnist_csvs, timit_files)
    args = args + ["--device", "cpu"]
    if name in SMALL:
        cls, fields = SMALL[name]
        monkeypatch.setattr(module, cls, functools.partial(getattr(module, cls), **fields))
    plain = module.main(args)
    meshed = module.main(args + ["--mesh", "1"])
    key = "test_scores" if name == "timit" else "test_predictions"
    assert np.array_equal(np.asarray(meshed[key]), np.asarray(plain[key]))
    if "fit_report" in meshed:
        assert meshed["fit_report"]["chosen_tier"] == "fused[mesh 1x1]"
    with pytest.raises(ValueError, match="mesh 2x1 needs 2 devices, have 1"):
        module.main(args + ["--mesh", "2"])


@pytest.mark.parametrize("name, flag", [
    ("cifar_random_patch", "--autoCache"), ("cifar_random_patch", "--pipelineFile"),
    ("mnist_random_fft", "--autoCache"), ("mnist_random_fft", "--pipelineFile"),
])
def test_cli_flags_without_a_mesh_half_are_usage_errors(name, flag, cifar_files, mnist_csvs,
                                                        timit_files, tmp_path, monkeypatch):
    """Beside ``--mesh`` the flag is taken: the predictions are the
    ``--mesh 1`` run's, and a ``--pipelineFile`` the run saved restores to
    them."""
    module, args = _cli_args(name, cifar_files, mnist_csvs, timit_files)
    if name in SMALL:
        cls, fields = SMALL[name]
        monkeypatch.setattr(module, cls, functools.partial(getattr(module, cls), **fields))
    args = args + ["--device", "cpu", "--mesh", "1"]
    plain = module.main(args)
    extra = [flag, str(tmp_path / "ck")] if flag == "--pipelineFile" else [flag]
    runs = [module.main(args + extra)]
    if flag == "--pipelineFile":
        runs.append(module.main(args + extra))
        assert runs[1]["restored"] and not runs[0].get("restored")
    else:
        assert "cache_plan" in runs[0]
    for res in runs:
        np.testing.assert_array_equal(res["test_predictions"], plain["test_predictions"])


def test_cli_mesh_on_cuda_without_a_card_raises(cifar_files, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    train, test = cifar_files
    with pytest.raises(RuntimeError, match="no CUDA card"):
        pt_lp.main(["--trainLocation", train, "--testLocation", test, "--mesh", "1"])
