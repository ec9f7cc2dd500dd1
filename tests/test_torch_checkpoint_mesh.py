"""Sharded checkpoints and the reshard loader of the port
(``keystone_tpu_torch.core.checkpoint``: per-array sharding records,
``load_pipeline(mesh=)`` and its ``_Resharder``), held to the checkpoint
cases of ``tests/test_elastic.py`` and the mesh cases of
``tests/test_checkpoint.py``, and to the JAX package both ways:

* a StandardScaler fitted on 32 rows with its mean anchored ``data@dim0``
  on a 4-slot mesh, written by the JAX package and loaded by the port onto
  2 and 1 slots, and written by the port and loaded by the JAX package
  onto 2 and 1 devices: every restored leaf bit-equal to the saved array
  (the numbers are carried, not refitted), the restored scaler's outputs
  ``torch.equal`` to the saved arrays' arithmetic on every mesh, and within
  rtol 1e-4, atol 1e-4 of the other package's model (the bar of
  ``tests/test_torch_solvers.py``'s scaler cases);
* the guard: the naive load names the recorded ``'data': 4``, ``mesh=``
  and "refusing"; the manifest records ``data@dim0`` and
  ``all_replicated: false``; topology and replication are recorded under
  ``use_mesh``; a foreign device count or mesh is refused; a replicated
  checkpoint loads on any topology;
* the ``_Resharder``'s tiers under a small ``KEYSTONE_HBM_BUDGET``: a
  counted ``spec_fallback``, a typed ``CheckpointError`` when nothing fits,
  and the ``host_staged`` copy under a small
  ``KEYSTONE_RESHARD_CHUNK_BYTES``, bit-equal to the one-copy load.

The JAX side runs on the conftest's 8 virtual CPU devices, the port on
slots of the CPU (``make_mesh(d, m, devices=[cpu] * (d * m))``); inputs
are seeded numpy.
"""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from keystone_tpu.core import checkpoint as jck
from keystone_tpu.core.resilience import counters as jcounters
from keystone_tpu.ops.stats import StandardScaler as JaxScaler
from keystone_tpu.parallel import mesh as jmesh
from keystone_tpu_torch.core import autoshard
from keystone_tpu_torch.core import checkpoint as ck
from keystone_tpu_torch.core.checkpoint import (
    CheckpointError,
    CheckpointMismatch,
    load_pipeline,
    save_pipeline,
)
from keystone_tpu_torch.core.pipeline import Pipeline
from keystone_tpu_torch.core.resilience import counters
from keystone_tpu_torch.loaders.cifar import cifar_loader
from keystone_tpu_torch.ops.stats import StandardScaler, StandardScalerModel
from keystone_tpu_torch.parallel.mesh import (
    LayoutLeafError,
    ShardedRows,
    SpecLayout,
    lower,
    make_mesh,
    map_rows,
    padded_shard_rows,
    replicate,
    use_mesh,
)
from keystone_tpu_torch.solvers.pca import PCATransformer
from keystone_tpu_torch.workloads import cifar_random_patch as pc
from test_cifar_pipeline import write_synthetic_cifar
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401

CPU = torch.device("cpu")
WIDTH = 16
#: The cross-package bar of the scaler cases (tests/test_torch_solvers.py).
RTOL = ATOL = 1e-4


def slots(data: int, model: int = 1):
    return make_mesh(data, model, devices=[CPU] * (data * model))


def _rows(rng):
    """(the 32 fit rows, the 12 test rows), seeded numpy."""
    return (rng.normal(size=(32, WIDTH)).astype(np.float32),
            rng.normal(size=(12, WIDTH)).astype(np.float32))


def _jax_stem(tmp_path, rng, devices, name="jax"):
    """``tests/test_elastic.py``'s fixture: a JAX fit under a 4-device mesh
    with its mean anchored ``data@dim0``.  Returns (stem, test rows, the
    JAX model's outputs)."""
    x, test = _rows(rng)
    full = jmesh.make_mesh(data=4, model=1, devices=devices[:4])
    with jmesh.use_mesh(full):
        model = JaxScaler().fit(jax.device_put(jnp.asarray(x), jmesh.row_sharding(full)))
        model.mean = jax.device_put(model.mean, NamedSharding(full, PartitionSpec("data")))
        stem = jck.save_pipeline(str(tmp_path / name), model)
    return stem, test, np.asarray(model(jnp.asarray(test)))


def _port_stem(tmp_path, rng, name="port"):
    """The same fixture written by the port: fitted on the rows sharded
    over 4 slots, the mean placed ``data@dim0`` on them.  Returns (stem,
    test rows, the port model's outputs)."""
    x, test = _rows(rng)
    full = slots(4)
    with use_mesh(full):
        model = StandardScaler().fit(padded_shard_rows(torch.from_numpy(x), full)[0])
        model.mean = autoshard.spec_sharding("data@dim0", full, 1).place(model.mean)
        stem = save_pipeline(str(tmp_path / name), model)
    return stem, test, replicate(model, CPU)(torch.from_numpy(test))


def _saved(stem) -> dict:
    """The saved arrays by manifest key, as numpy."""
    with np.load(stem + ".npz") as zf:
        return {k: zf[k] for k in zf.files}


def _manifest(stem) -> dict:
    with open(stem + ".json") as fh:
        return json.load(fh)


def _edit_topology(stem, **changes):
    manifest = _manifest(stem)
    manifest["topology"].update(changes)
    with open(stem + ".json", "w") as fh:
        json.dump(manifest, fh)


def _leaf_keys(stem) -> dict:
    """Field name -> array key of the saved StandardScalerModel."""
    data = _manifest(stem)["root"]["data"]
    return {f: data[f]["k"] for f in ("mean", "std")}


@pytest.mark.parametrize("survivors", (2, 1))
def test_jax_sharded_checkpoint_reshards_onto_port_mesh(tmp_path, rng, devices, survivors):
    """Bars: leaves bit-equal to the saved arrays; outputs ``torch.equal``
    to the saved arrays' arithmetic, on a plain tensor and slot by slot on
    the mesh's rows; within rtol/atol 1e-4 of the JAX model."""
    stem, test, jax_out = _jax_stem(tmp_path, rng, devices)
    mesh = slots(survivors)
    before, report = counters.get("ckpt_reshard"), {}
    resumed = load_pipeline(stem, mesh=mesh, report=report)
    assert counters.get("ckpt_reshard") - before == 1
    assert report["arrays"] == 2 and report["resharded"] == 1
    assert isinstance(resumed, StandardScalerModel)
    assert isinstance(resumed.mean, ShardedRows) and isinstance(resumed.std, SpecLayout)
    saved, keys = _saved(stem), _leaf_keys(stem)
    for field, key in keys.items():
        assert torch.equal(lower(getattr(resumed, field), CPU), torch.from_numpy(saved[key]))
    x = torch.from_numpy(test)
    want = StandardScalerModel(torch.from_numpy(saved[keys["mean"]]),
                               torch.from_numpy(saved[keys["std"]]))(x)
    assert torch.equal(replicate(resumed, CPU)(x), want)
    assert torch.equal(map_rows(resumed, padded_shard_rows(x, mesh)[0]).gather(), want)
    np.testing.assert_allclose(want.numpy(), jax_out, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("survivors", (2, 1))
def test_port_sharded_checkpoint_reshards_onto_jax_mesh(tmp_path, rng, devices, survivors):
    """The reverse, the same bars: the JAX package's ``load_pipeline(mesh=)``
    reads the port's per-array record."""
    stem, test, port_out = _port_stem(tmp_path, rng)
    target = jmesh.make_mesh(data=survivors, model=1, devices=devices[:survivors])
    before = jcounters.get("ckpt_reshard")
    resumed = jck.load_pipeline(stem, mesh=target)
    assert jcounters.get("ckpt_reshard") - before == 1
    saved, keys = _saved(stem), _leaf_keys(stem)
    for field, key in keys.items():
        np.testing.assert_array_equal(np.asarray(getattr(resumed, field)), saved[key])
    if survivors > 1:
        assert not resumed.mean.is_fully_replicated
    np.testing.assert_allclose(np.asarray(resumed(jnp.asarray(test))), port_out.numpy(),
                               rtol=RTOL, atol=ATOL)


def test_restored_record_is_refused_typed_by_torch(tmp_path, rng, devices):
    """A restored node not lowered first never meets a PyTorch operator as
    an untyped error: the record raises ``LayoutLeafError``."""
    stem, test, _ = _jax_stem(tmp_path, rng, devices, name="typed")
    resumed = load_pipeline(stem, mesh=slots(2))
    with pytest.raises(LayoutLeafError, match="replicate"):
        resumed(torch.from_numpy(test))


def test_naive_load_refuses_typed_naming_both_topologies(tmp_path, rng, devices):
    """The refusal names the recorded topology, ``mesh=`` and "refusing",
    for a JAX-written and a port-written sharded checkpoint alike."""
    for stem in (_jax_stem(tmp_path, rng, devices)[0], _port_stem(tmp_path, rng)[0]):
        with pytest.raises(CheckpointMismatch) as exc:
            load_pipeline(stem, device="cpu")
        msg = str(exc.value)
        assert "'data': 4" in msg and "mesh=" in msg and "refusing" in msg


def test_manifest_records_per_array_sharding_specs(tmp_path, rng):
    stem = _port_stem(tmp_path, rng)[0]
    manifest = _manifest(stem)
    specs = [spec.get("sharding", "replicated") for spec in manifest["arrays"].values()]
    assert specs.count("data@dim0") == 1  # the mean; the std stays replicated
    assert manifest["all_replicated"] is False
    assert manifest["topology"]["mesh"] == {"data": 4, "model": 1}


def test_reshard_disabled_stays_the_default(tmp_path, rng):
    stem = _port_stem(tmp_path, rng)[0]
    with pytest.raises(CheckpointMismatch):
        load_pipeline(stem, device="cpu", mesh=None)


def test_sharded_checkpoint_loads_plain_on_its_own_topology(tmp_path, rng):
    """Under the recorded mesh shape the naive load is the recorded
    topology: plain tensors on the device, bit-equal to the saved arrays."""
    stem = _port_stem(tmp_path, rng)[0]
    with use_mesh(slots(4)):
        back = load_pipeline(stem, device="cpu")
    saved, keys = _saved(stem), _leaf_keys(stem)
    assert torch.equal(back.mean, torch.from_numpy(saved[keys["mean"]]))


class TestTopologyGuard:
    """The port's counterparts of ``tests/test_checkpoint.py``'s mesh cases."""

    def _sharded(self, rng, mesh):
        rows = torch.from_numpy(rng.normal(size=(16, 2)).astype(np.float32))
        return PCATransformer(padded_shard_rows(rows, mesh)[0])

    def test_topology_and_replication_recorded(self, tmp_path, rng):
        plain = PCATransformer(torch.from_numpy(rng.normal(size=(4, 2)).astype(np.float32)))
        manifest = _manifest(save_pipeline(str(tmp_path / "topo"), plain))
        assert manifest["topology"]["mesh"] is None and manifest["all_replicated"] is True
        mesh = slots(8)
        with use_mesh(mesh):
            manifest2 = _manifest(save_pipeline(str(tmp_path / "sharded"),
                                                self._sharded(rng, mesh)))
        assert manifest2["all_replicated"] is False
        assert manifest2["topology"]["mesh"] == {"data": 8, "model": 1}
        # A record held whole by every slot is replicated.
        with use_mesh(slots(1, 2)):
            manifest3 = _manifest(save_pipeline(str(tmp_path / "whole"),
                                                self._sharded(rng, slots(1, 2))))
        assert manifest3["all_replicated"] is True

    @pytest.mark.parametrize("edit, match", [
        (dict(device_count=16), "topology"),
        (dict(mesh={"data": 4, "model": 2}), "reshard"),
    ])
    def test_sharded_checkpoint_rejects_foreign_topology(self, tmp_path, rng, edit, match):
        mesh = slots(8)
        with use_mesh(mesh):
            stem = save_pipeline(str(tmp_path / "foreign"), self._sharded(rng, mesh))
            _edit_topology(stem, **edit)
            with pytest.raises(CheckpointMismatch, match=match):
                load_pipeline(stem, device="cpu")
        assert issubclass(CheckpointMismatch, CheckpointError)

    def test_replicated_checkpoint_loads_across_topologies(self, tmp_path, rng):
        arr = rng.normal(size=(4, 2)).astype(np.float32)
        stem = save_pipeline(str(tmp_path / "portable"), PCATransformer(torch.from_numpy(arr)))
        _edit_topology(stem, device_count=1024, platform="tpu")
        assert torch.equal(load_pipeline(stem, device="cpu").pca_mat, torch.from_numpy(arr))
        # ... and onto any mesh, replicated on every slot.
        placed = load_pipeline(stem, mesh=slots(4, 2)).pca_mat
        assert isinstance(placed, SpecLayout) and placed.sharding.split is None
        assert all(torch.equal(t, torch.from_numpy(arr)) for row in placed.shards for t in row)


class TestResharderTiers:
    """One ``[16, 4]`` f32 array (256 B) onto 4 slots of the CPU, whose
    ``KEYSTONE_HBM_BUDGET`` is split four ways: each slot's budget is a
    quarter of it."""

    def _stem(self, tmp_path, rng):
        arr = rng.normal(size=(16, 4)).astype(np.float32)
        return save_pipeline(str(tmp_path / "tiers"), PCATransformer(torch.from_numpy(arr))), arr

    def test_spec_fallback_is_counted(self, tmp_path, rng, monkeypatch):
        """A 128 B slot budget denies the replicated 256 B: the rows split
        ``data@dim0`` (64 B a slot) instead, the same numbers."""
        stem, arr = self._stem(tmp_path, rng)
        monkeypatch.setenv("KEYSTONE_HBM_BUDGET", "512")
        report = {}
        placed = load_pipeline(stem, mesh=slots(4), report=report).pca_mat
        assert report["spec_fallback"] == 1
        assert isinstance(placed, ShardedRows) and placed.mesh.shape["data"] == 4
        assert torch.equal(placed.gather(), torch.from_numpy(arr))

    def test_nothing_fits_raises_typed(self, tmp_path, rng, monkeypatch):
        stem, _ = self._stem(tmp_path, rng)
        monkeypatch.setenv("KEYSTONE_HBM_BUDGET", "64")
        with pytest.raises(CheckpointError, match=r"does not fit the target mesh") as exc:
            load_pipeline(stem, mesh=slots(4))
        assert "'a0'" in str(exc.value) and "data@dim0" in str(exc.value)
        assert not isinstance(exc.value, CheckpointMismatch)

    def test_host_staged_is_bit_equal_to_one_copy(self, tmp_path, rng, monkeypatch):
        stem, arr = self._stem(tmp_path, rng)
        mesh = slots(2, 2)
        with use_mesh(mesh):
            spread = save_pipeline(
                str(tmp_path / "spread"),
                PCATransformer(autoshard.spec_sharding("model@dim1", mesh, 2).place(
                    torch.from_numpy(arr))))
        for path in (stem, spread):
            one_copy, host_staged = {}, {}
            one = load_pipeline(path, mesh=mesh, report=one_copy).pca_mat
            monkeypatch.setenv("KEYSTONE_RESHARD_CHUNK_BYTES", "64")
            staged = load_pipeline(path, mesh=mesh, report=host_staged).pca_mat
            monkeypatch.delenv("KEYSTONE_RESHARD_CHUNK_BYTES")
            assert one_copy["host_staged"] == 0 and host_staged["host_staged"] == 1
            assert type(staged) is type(one)
            assert all(torch.equal(a, b) for ra, rb in zip(one.shards, staged.shards)
                       for a, b in zip(ra, rb))
            assert torch.equal(lower(staged, CPU), torch.from_numpy(arr))


def test_resharded_cifar_servable_predicts_as_fitted(tmp_path):
    """A fitted RandomPatchCifar servable whose scaler mean and block
    weights are placed ``data@dim0`` on 4x2 slots and saved under the mesh
    loads onto 2x1 and 1x1 (host-staged under a small chunk size too) and,
    lowered to the device, predicts the fitted run's labels: every node of
    the chain, the conv featurizer's derived state included, is rebuilt
    from the carried numbers."""
    rng = np.random.default_rng(42)
    palette = rng.uniform(40, 215, (4, 3))
    paths = [str(tmp_path / "train.bin"), str(tmp_path / "test.bin")]
    write_synthetic_cifar(paths[0], 96, rng, base=palette)
    write_synthetic_cifar(paths[1], 40, rng, base=palette)
    train, test = (cifar_loader(p) for p in paths)
    conf = pc.RandomCifarConfig(num_filters=12, patch_steps=2, lam=10.0, whitener_size=1500,
                                featurize_chunk=32, num_classes=4, device="cpu")
    fitted = pc.run(conf, train, test)
    servable = fitted["servable"]
    scaler, model = (copy.copy(n) for n in servable.nodes[-3:-1])
    full = slots(4, 2)
    scaler.mean = autoshard.spec_sharding("data@dim0", full, 1).place(scaler.mean)
    model.xs = [autoshard.spec_sharding("data@dim0", full, 2).place(x) for x in model.xs]
    with use_mesh(full):
        stem = save_pipeline(str(tmp_path / "servable"),
                             Pipeline([*servable.nodes[:-3], scaler, model,
                                       servable.nodes[-1]]))
    assert _manifest(stem)["all_replicated"] is False
    with pytest.raises(CheckpointMismatch):
        load_pipeline(stem, device="cpu")
    for mesh, chunk in ((slots(2), None), (slots(1), None), (slots(1), "256")):
        report = {}
        with pytest.MonkeyPatch.context() as mp:
            if chunk is not None:
                mp.setenv("KEYSTONE_RESHARD_CHUNK_BYTES", chunk)
            restored = load_pipeline(stem, mesh=mesh, report=report)
        assert isinstance(restored.nodes[-3].mean, ShardedRows)
        assert bool(report["host_staged"]) == (chunk is not None)
        pred = pc.apply_servable_chunked(replicate(restored, CPU), test.images, 32)
        np.testing.assert_array_equal(pred, fitted["test_predictions"])
