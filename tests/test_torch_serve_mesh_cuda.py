"""Serving on slots of the card: a ``ServingEngine`` on 4x2 slots of
``cuda:0`` (each bucket one CUDA graph recording every data slot's rows)
answers ``np.array_equal`` to the single-device engine on the same card,
bucket for bucket, through ``infer`` and a ``Server``; each mesh bucket's
plan carries the per-slot charge of its capture; a checkpoint whose scaler
mean is split ``data@dim0`` over 4 CPU slots loads through
``load_engine(mesh=)`` onto 4x2 card slots and serves the answers of the
plain scaler.

This file imports neither JAX nor the JAX package, so it runs on a machine
without them:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_serve_mesh_cuda.py``.
Tests that need the card carry the ``cuda`` marker and skip without one."""

import numpy as np
import pytest
import torch

from keystone_tpu_torch.core import autoshard
from keystone_tpu_torch.core import serve as kserve
from keystone_tpu_torch.core.checkpoint import save_pipeline
from keystone_tpu_torch.core.pipeline import FunctionTransformer, Pipeline
from keystone_tpu_torch.ops.stats import StandardScalerModel
from keystone_tpu_torch.parallel.mesh import make_mesh, use_mesh
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401

CPU = torch.device("cpu")
WIDTH = 64
BUCKETS = (1, 4, 16, 64)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def slots(device, data=4, model=2):
    return make_mesh(data, model, devices=[device] * (data * model))


def _pipe(device):
    rng = np.random.default_rng(0)
    mean = torch.from_numpy(rng.normal(size=WIDTH).astype(np.float32)).to(device)
    std = torch.from_numpy(rng.uniform(0.5, 2.0, WIDTH).astype(np.float32)).to(device)
    return Pipeline([StandardScalerModel(mean, std),
                     FunctionTransformer(lambda x: torch.clamp_min(x * 1.5, 0.25))])


@pytest.mark.cuda
def test_mesh_engine_answers_the_single_device_engine(cuda_device):
    cfg = kserve.ServeConfig(buckets=BUCKETS, max_wait_ms=2.0)
    pipe = _pipe(cuda_device)
    one = kserve.ServingEngine(pipe, np.zeros(WIDTH, np.float32), config=cfg, label="one")
    mesh = kserve.ServingEngine(pipe, np.zeros(WIDTH, np.float32), config=cfg, label="m42",
                                mesh=slots(cuda_device))
    assert mesh.record()["mesh"] == "4x2" and mesh.parity_ok and mesh.buckets() == BUCKETS
    assert set(mesh.graph_kernels()) == set(BUCKETS)
    for bucket in BUCKETS:
        rep = mesh.memory_plans[bucket].reported
        assert rep["slot_charge_bytes"] == max(rep["capture_allocated_bytes"],
                                               rep["capture_reserved_bytes"]) // 8
    x = np.random.default_rng(1).normal(size=(101, WIDTH)).astype(np.float32)
    want = one.infer(x)
    np.testing.assert_array_equal(mesh.infer(x), want)
    with kserve.Server(mesh) as server:
        served = np.stack([f.result(30.0) for f in [server.submit(r) for r in x]])
    np.testing.assert_array_equal(served, want)


@pytest.mark.cuda
def test_load_engine_reshards_onto_card_slots(cuda_device, tmp_path):
    rng = np.random.default_rng(2)
    mean = torch.from_numpy(rng.normal(size=WIDTH).astype(np.float32))
    std = torch.from_numpy(rng.uniform(0.5, 2.0, WIDTH).astype(np.float32))
    cpu4 = make_mesh(4, 1, devices=[CPU] * 4)
    with use_mesh(cpu4):
        stem = save_pipeline(str(tmp_path / "sharded"), StandardScalerModel(
            autoshard.spec_sharding("data@dim0", cpu4, 1).place(mean), std))
    engine, cold = kserve.load_engine(
        stem, np.zeros(WIDTH, np.float32), config=kserve.ServeConfig(buckets=BUCKETS),
        label="resharded", mesh=slots(cuda_device))
    assert cold["mesh"] == "4x2" and engine.parity_ok
    x = torch.from_numpy(rng.normal(size=(37, WIDTH)).astype(np.float32))
    np.testing.assert_array_equal(engine.infer(x.numpy()),
                                  StandardScalerModel(mean, std)(x).numpy())
