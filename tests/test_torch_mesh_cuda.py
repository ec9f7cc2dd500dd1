"""The single-process mesh on the card: a 1x1 mesh's block fit is the fused
tier bit for bit, and eight slots of ``cuda:0`` featurize RandomPatchCifar
chunks through the hand kernel K1 (``conv_rect_pool``) once per slot and
chunk, each slot in its device's scope, the features those of the
unsharded pass.

This file imports neither JAX nor the JAX package, so it runs on a machine
without them:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_mesh_cuda.py``.
Tests that need the card carry the ``cuda`` marker and skip without one.
Every fit logs its outcome to a fresh file (``tests/torch_plan_log.py``)."""

import math

import numpy as np
import pytest
import torch

from keystone_tpu_torch.ops import rect_pool
from keystone_tpu_torch.parallel.mesh import make_mesh
from keystone_tpu_torch.solvers.block import BlockLeastSquaresEstimator
from keystone_tpu_torch.workloads import cifar_random_patch as cifar
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("listed", [False, True], ids=["monolithic", "blocks"])
def test_one_by_one_mesh_is_the_fused_tier_on_the_card(cuda_device, listed):
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.normal(size=(3000, 600)).astype(np.float32)).to(cuda_device)
    b = torch.from_numpy(rng.normal(size=(3000, 10)).astype(np.float32)).to(cuda_device)
    features = [a[:, :256], a[:, 256:512], a[:, 512:]] if listed else a
    fused = BlockLeastSquaresEstimator(256, num_iter=2, lam=1.0)
    want = fused.fit(features, b, plan=False)
    assert fused.last_fit_report.chosen == "fused"
    est = BlockLeastSquaresEstimator(256, num_iter=2, lam=1.0,
                                     mesh=make_mesh(1, 1, devices=[cuda_device]))
    got = est.fit(features, b)
    assert est.last_fit_report.chosen == "fused[mesh 1x1]"
    assert all(torch.equal(g, w) for g, w in zip(got.xs, want.xs))
    assert torch.equal(got.b, want.b)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 2), (8, 1)], ids=["4x2", "8x1"])
def test_eight_slots_featurize_through_the_kernel(cuda_device, shape):
    rng = np.random.default_rng(1)
    conf = cifar.RandomCifarConfig(num_filters=16, whitener_size=2000, device="cuda")
    images = rng.uniform(0, 255, (1000, 32, 32, 3)).astype(np.float32)
    conv = cifar.build_conv_pipeline(conf, *cifar.learn_filters(conf, images))
    whole = cifar.featurize_chunked(conv, images, 256, cuda_device)
    mesh = make_mesh(*shape, devices=[cuda_device] * 8)
    rect_pool.fused_launches = 0
    sharded = cifar.featurize_chunked(conv, images, 256, cuda_device, mesh=mesh)
    data = shape[0]
    per_slot = math.ceil(math.ceil(1000 / data) / math.ceil(256 / data))
    assert rect_pool.fused_launches == 8 * per_slot
    rows = sharded.gather()
    assert rows.device == whole.device and rows.shape == whole.shape
    err = ((rows - whole).abs().max() / whole.abs().max()).item()
    assert torch.equal(rows, whole) or err <= 1e-2, err
