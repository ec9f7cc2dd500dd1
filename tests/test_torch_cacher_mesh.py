"""The Cacher and the auto-Cacher under a mesh in the port
(``core.pipeline.Cacher(sharding=SpecSharding)``, ``core.optimize``'s
per-slot charge, the workloads' ``--autoCache`` / ``--pipelineFile`` /
``--autoTune`` beside ``--mesh``), held to the JAX package and to the
port's own runs without the flag, on the CPU:

* ``tests/test_pipeline_core.py::test_cacher_sharding_path``'s counterpart:
  the committed value ``torch.equal`` to the input, a downstream node sees
  it (slot by slot), a record already in the layout passes through, and
  the Cacher is the identity while a capture runs (simulated as
  ``tests/test_torch_optimize.py`` does);
* ``plan_caches(mesh=)``: its decision table (every row and reason) equals
  the JAX package's for the same candidates on 4x2 and 8x1 under one
  budget;
* RandomPatchCifar, MnistRandomFFT, VOCSIFTFisher and ImageNetSiftLcsFV on
  slots of the CPU at small sizes: ``--autoCache`` on the mesh gives
  predictions and scores ``torch.equal`` to the same mesh run without it; a
  ``--pipelineFile`` written under the mesh restores to the fitted run's
  predictions; Cifar's streamed test split with ``--autoTune`` on 2 slots
  predicts as without it.  Bars: bit for bit, every one.
"""

import dataclasses

import numpy as np
import pytest
import torch

from keystone_tpu.core import optimize as joptimize
from keystone_tpu_torch.core import autoshard, optimize
from keystone_tpu_torch.core import pipeline as ppipeline
from keystone_tpu_torch.core.pipeline import Cacher, FunctionTransformer, Pipeline
from keystone_tpu_torch.loaders import image_loaders as ploaders
from keystone_tpu_torch.loaders.cifar import cifar_loader
from keystone_tpu_torch.loaders.csv_loader import LabeledData
from keystone_tpu_torch.parallel.mesh import ShardedRows, SpecLayout, make_mesh
from keystone_tpu_torch.workloads import cifar_random_patch as pc
from keystone_tpu_torch.workloads import imagenet_sift_lcs_fv as pinet
from keystone_tpu_torch.workloads import mnist_random_fft as pmnist
from keystone_tpu_torch.workloads import voc_sift_fisher as pvoc
from test_cifar_pipeline import write_synthetic_cifar
from test_fisher_pipelines import write_voc_tar
from test_stream_workloads import _write_cifar_tar
from test_torch_imagenet import NUM_CLASSES, SMALL_CONF, _write_split
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401

CPU = torch.device("cpu")
CIFAR_CONF = dict(num_filters=12, patch_size=6, patch_steps=2, lam=10.0, whitener_size=1500,
                  featurize_chunk=64, num_classes=4, device="cpu")
MNIST_CONF = dict(num_ffts=2, block_size=512, lam=1e-2, mnist_image_size=64, num_classes=5,
                  device="cpu")
VOC_CONF = dict(lam=0.05, desc_dim=16, vocab_size=8, num_pca_samples=6000,
                num_gmm_samples=6000, sift_step_size=6, device="cpu")


def slots(data: int, model: int = 1):
    return make_mesh(data, model, devices=[CPU] * (data * model))


# -- the Cacher ---------------------------------------------------------------------


def test_cacher_commits_to_a_spec_layout():
    x = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    rows = autoshard.spec_sharding("data@dim0", slots(8), 2)
    cached = Cacher(name="feats", sharding=rows)(x)
    assert isinstance(cached, ShardedRows) and rows.holds(cached)
    assert torch.equal(cached.gather(), x)
    # Already in the layout: passed through unchanged.
    assert Cacher(sharding=rows)(cached) is cached
    # A downstream node sees the sharded value, slot by slot.
    pipe = Pipeline([Cacher(sharding=rows), FunctionTransformer(lambda y: y + 1.0)])
    out = pipe(x)
    assert isinstance(out, ShardedRows) and torch.equal(out.gather(), x + 1.0)
    # Another layout on a 4x2 mesh: the record is gathered, then placed.
    cols = autoshard.spec_sharding("model@dim1", slots(4, 2), 2)
    moved = Cacher(sharding=cols)(cached)
    assert isinstance(moved, SpecLayout) and cols.holds(moved)
    assert torch.equal(moved.gather(), x)
    assert torch.equal(moved.shards[0][1], x[:, 4:])


def test_cacher_spec_layout_is_the_identity_under_capture(monkeypatch):
    x = torch.ones((8, 2))
    monkeypatch.setattr(ppipeline, "_capturing", lambda: True)
    assert Cacher(sharding=autoshard.spec_sharding("data@dim0", slots(4), 2))(x) is x


# -- the per-slot charge against the JAX decision table ------------------------------


@pytest.mark.parametrize("shape", [(4, 2), (8, 1)])
def test_plan_caches_on_a_mesh_equals_jax(shape, mesh42, mesh8):
    """Four candidates, one 16 MiB budget: at 4 or 8 data slots the
    cumulative per-slot charge admits the biggest wins and drops the rest
    exactly where the JAX package does."""
    rows = [("a", 9.0, 40 * 2**20, 2), ("b", 5.0, 30 * 2**20, 2), ("c", 3.0, 10 * 2**20, 3),
            ("d", 0.1, 2**30, 2)]
    budget = 16 * 2**20

    def plan(mod, mesh):
        cands = [mod.CacheCandidate(index=i, name=n, seconds=s, output_bytes=b, reuse=r)
                 for i, (n, s, b, r) in enumerate(rows)]
        return mod.plan_caches(cands, budget=budget, mesh=mesh, gbps=1.0, dataset_rows=100,
                               sample_rows=10).record()

    jax_mesh = mesh42 if shape == (4, 2) else mesh8
    got, want = plan(optimize, slots(*shape)), plan(joptimize, jax_mesh)
    assert got == want
    assert got["cached"] and got["dropped"]  # both sides of the budget are exercised
    assert "per-chip" in got["decisions"][0]["reason"]


# -- the workloads ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def cifar(tmp_path_factory):
    rng = np.random.default_rng(42)
    d = tmp_path_factory.mktemp("cifar_cache_mesh")
    palette = rng.uniform(40, 215, (4, 3))
    train, test = str(d / "train.bin"), str(d / "test.bin")
    write_synthetic_cifar(train, 201, rng, base=palette)
    write_synthetic_cifar(test, 99, rng, base=palette)
    return cifar_loader(train), cifar_loader(test)


def test_cifar_auto_cache_on_a_mesh_is_the_mesh_run(cifar, tmp_path, monkeypatch):
    """With a 1 GiB card budget, each of the 8 slots is admitted against an
    eighth of it, at the gate's half headroom."""
    train, test = cifar
    conf = pc.RandomCifarConfig(**CIFAR_CONF)
    mesh = slots(4, 2)
    monkeypatch.setenv("KEYSTONE_HBM_BUDGET", "1G")
    plain = pc.run(conf, train, test, mesh=mesh)
    stem = str(tmp_path / "cifar")
    cached = pc.run(dataclasses.replace(conf, auto_cache=True, pipeline_file=stem),
                    train, test, mesh=mesh)
    assert cached["cache_plan"]["cached"] == ["conv_featurize"]
    assert "per-chip" in cached["cache_plan"]["decisions"][0]["reason"]
    assert cached["cache_plan"]["budget_bytes"] == 2**30 // 8 // 2
    np.testing.assert_array_equal(cached["test_predictions"], plain["test_predictions"])
    m0, m1 = plain["servable"].nodes[-2], cached["servable"].nodes[-2]
    assert all(torch.equal(a, b) for a, b in zip([*m0.xs, m0.b], [*m1.xs, m1.b]))
    restored = pc.run(dataclasses.replace(conf, pipeline_file=stem), train, test, mesh=mesh)
    assert restored["restored"]
    np.testing.assert_array_equal(restored["test_predictions"], cached["test_predictions"])


def test_cifar_auto_tune_on_a_mesh_predicts_as_without(tmp_path):
    tar = str(tmp_path / "c20.tar")
    _write_cifar_tar(tar, 20, np.random.default_rng(42))
    train = pc.cifar_tar_loader(tar)
    conf = pc.RandomCifarConfig(num_filters=4, patch_steps=6, lam=10.0, whitener_size=64,
                                num_classes=4, featurize_chunk=8, device="cpu",
                                stream_test_tar=tar)
    mesh = slots(2)
    base = pc.run(conf, train, train, mesh=mesh)
    tuned = pc.run(dataclasses.replace(conf, auto_tune=True), train, train, mesh=mesh)
    np.testing.assert_array_equal(tuned["test_predictions"], base["test_predictions"])
    assert "autotune" in tuned and "autotune" not in base


def _mnist_split(rng, n, centers):
    labels = rng.integers(0, len(centers), n)
    data = (centers[labels] + 0.3 * rng.normal(size=(n, centers.shape[1]))).astype(np.float32)
    return LabeledData(labels=labels.astype(np.int32), data=data)


def test_mnist_auto_cache_on_a_mesh_is_the_mesh_run(tmp_path):
    rng = np.random.default_rng(7)
    centers = rng.normal(size=(5, 64))
    train, test = _mnist_split(rng, 203, centers), _mnist_split(rng, 101, centers)
    conf = pmnist.MnistRandomFFTConfig(**MNIST_CONF)
    mesh = slots(4, 2)
    plain = pmnist.run(conf, train, test, mesh=mesh)
    stem = str(tmp_path / "mnist")
    cached = pmnist.run(dataclasses.replace(conf, auto_cache=True, pipeline_file=stem),
                        train, test, mesh=mesh)
    assert cached["cache_plan"]["decisions"][0]["name"] == "fft_features"
    np.testing.assert_array_equal(cached["test_predictions"], plain["test_predictions"])
    restored = pmnist.run(dataclasses.replace(conf, pipeline_file=stem), None, test, mesh=mesh)
    assert restored["restored"]
    np.testing.assert_array_equal(restored["test_predictions"], cached["test_predictions"])


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    d = tmp_path_factory.mktemp("voc_cache_mesh")
    labels = str(d / "labels.csv")
    open(labels, "w").close()
    write_voc_tar(str(d / "train.tar"), labels, 24, np.random.default_rng(42))
    return ploaders.voc_loader(str(d / "train.tar"), labels)


def test_voc_auto_cache_on_a_mesh_is_the_mesh_run(voc, tmp_path):
    conf = pvoc.SIFTFisherConfig(**VOC_CONF)
    mesh = slots(8)
    plain = pvoc.run(conf, voc, voc, mesh=mesh)
    stem = str(tmp_path / "voc")
    cached = pvoc.run(dataclasses.replace(conf, auto_cache=True, pipeline_file=stem),
                      voc, voc, mesh=mesh)
    assert cached["cache_plan"]["decisions"][0]["name"] == "voc_pca_descriptors"
    np.testing.assert_array_equal(cached["test_scores"], plain["test_scores"])
    restored = pvoc.run(dataclasses.replace(conf, pipeline_file=stem), voc, voc, mesh=mesh)
    assert restored["restored"]
    np.testing.assert_array_equal(restored["test_scores"], cached["test_scores"])


def test_imagenet_auto_cache_on_a_mesh_is_the_mesh_run(tmp_path):
    rng = np.random.default_rng(8)
    _write_split(tmp_path, "train", 4, rng)
    _write_split(tmp_path, "test", 2, rng)
    labels = tmp_path / "labels.txt"
    labels.write_text("".join(f"syn{c:03d} {c}\n" for c in range(NUM_CLASSES)))
    train = ploaders.imagenet_loader(str(tmp_path / "train"), str(labels))
    test = ploaders.imagenet_loader(str(tmp_path / "test"), str(labels))
    conf = pinet.ImageNetSiftLcsFVConfig(**SMALL_CONF, device="cpu")
    mesh = slots(4, 2)
    plain = pinet.run(conf, train, test, mesh=mesh)
    stem = str(tmp_path / "inet")
    cached = pinet.run(dataclasses.replace(conf, auto_cache=True, pipeline_file=stem),
                       train, test, mesh=mesh)
    assert set(cached["cache_plan"]) == {"sift", "lcs"}
    np.testing.assert_array_equal(cached["test_scores"], plain["test_scores"])
    restored = pinet.run(dataclasses.replace(conf, pipeline_file=stem), train, test, mesh=mesh)
    assert restored["restored"]
    np.testing.assert_array_equal(restored["test_scores"], cached["test_scores"])
