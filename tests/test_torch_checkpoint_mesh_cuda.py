"""The reshard checkpoint loader and the sharded Cacher on the card: a
checkpoint with a ``data@dim0`` leaf and a ``model@dim1`` leaf loads onto
4x2 slots of ``cuda:0`` (in one copy and host-staged), each slot's tensor
``torch.equal`` to the same load onto 4x2 slots of the CPU, and the
restored node, lowered with ``parallel.mesh.replicate``, answers
``torch.equal`` on the card and the CPU; ``Cacher(sharding=SpecSharding)``
commits a card tensor to 4x2 slots of ``cuda:0`` as it commits the CPU
tensor to CPU slots, and a downstream node runs on each slot.

This file imports neither JAX nor the JAX package, so it runs on a machine
without them:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_checkpoint_mesh_cuda.py``.
Tests that need the card carry the ``cuda`` marker and skip without one."""

import numpy as np
import pytest
import torch

from keystone_tpu_torch.core import autoshard
from keystone_tpu_torch.core.checkpoint import load_pipeline, save_pipeline
from keystone_tpu_torch.core.pipeline import Cacher, FunctionTransformer, Pipeline
from keystone_tpu_torch.ops.stats import StandardScalerModel
from keystone_tpu_torch.parallel.mesh import (
    ShardedRows,
    SpecLayout,
    make_mesh,
    map_rows,
    padded_shard_rows,
    replicate,
    use_mesh,
)
from keystone_tpu_torch.solvers.pca import PCATransformer
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401

CPU = torch.device("cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def slots(device, data=4, model=2):
    return make_mesh(data, model, devices=[device] * (data * model))


def same_slots(a, b) -> bool:
    """Every slot of two records holds the same numbers (``b`` on the CPU)."""
    return type(a) is type(b) and all(
        torch.equal(x.cpu(), y) for ra, rb in zip(a.shards, b.shards) for x, y in zip(ra, rb))


@pytest.fixture
def stem(tmp_path):
    """A scaler with its mean split ``data@dim0`` and a projection split
    ``model@dim1``, saved under 4x2 CPU slots."""
    rng = np.random.default_rng(0)
    mesh = slots(CPU)
    mean = torch.from_numpy(rng.normal(size=64).astype(np.float32))
    std = torch.from_numpy(rng.uniform(0.5, 2.0, 64).astype(np.float32))
    pca = torch.from_numpy(rng.normal(size=(64, 8)).astype(np.float32))
    pipe = Pipeline([
        StandardScalerModel(autoshard.spec_sharding("data@dim0", mesh, 1).place(mean), std),
        PCATransformer(autoshard.spec_sharding("model@dim1", mesh, 2).place(pca)),
    ])
    with use_mesh(mesh):
        return save_pipeline(str(tmp_path / "sharded"), pipe)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [None, "64"], ids=["one_copy", "host_staged"])
def test_reshard_load_onto_card_slots_is_the_cpu_load(cuda_device, stem, chunk, monkeypatch):
    if chunk is not None:
        monkeypatch.setenv("KEYSTONE_RESHARD_CHUNK_BYTES", chunk)
    report = {}
    on_card = load_pipeline(stem, mesh=slots(cuda_device), report=report)
    assert report["host_staged"] == (3 if chunk else 0)
    on_cpu = load_pipeline(stem, mesh=slots(CPU))
    scaler, pca = on_card.nodes
    assert isinstance(scaler.mean, ShardedRows) and isinstance(pca.pca_mat, SpecLayout)
    assert all(t.device.type == "cuda" for row in pca.pca_mat.shards for t in row)
    assert same_slots(scaler.mean, on_cpu.nodes[0].mean)
    assert same_slots(pca.pca_mat, on_cpu.nodes[1].pca_mat)
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(24, 64)).astype(np.float32))
    want = replicate(on_cpu.nodes[0], CPU)(x)
    assert torch.equal(replicate(scaler, cuda_device)(x.to(cuda_device)).cpu(), want)
    rows = padded_shard_rows(x.to(cuda_device), slots(cuda_device))[0]
    assert torch.equal(map_rows(scaler, rows).gather().cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("spec", ["data@dim0", "model@dim1"])
def test_sharded_cacher_on_card_slots_is_the_cpu_cacher(cuda_device, spec):
    x = torch.arange(64 * 6, dtype=torch.float32).reshape(64, 6)
    on_cpu = Cacher(sharding=autoshard.spec_sharding(spec, slots(CPU), 2))(x)
    card = autoshard.spec_sharding(spec, slots(cuda_device), 2)
    on_card = Cacher(sharding=card)(x.to(cuda_device))
    assert card.holds(on_card) and same_slots(on_card, on_cpu)
    assert Cacher(sharding=card)(on_card) is on_card
    if spec == "data@dim0":
        pipe = Pipeline([Cacher(sharding=card), FunctionTransformer(lambda y: y * 2.0)])
        out = pipe(x.to(cuda_device))
        assert isinstance(out, ShardedRows) and torch.equal(out.gather().cpu(), x * 2.0)
