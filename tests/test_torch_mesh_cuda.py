"""The single-process mesh on the card: a 1x1 mesh's block fit is the fused
tier bit for bit, eight slots of ``cuda:0`` featurize RandomPatchCifar
chunks through the hand kernel K1 (``conv_rect_pool``) once per data slot
and chunk (model slots of one card share the data slot's rows and
results), each slot in its device's scope, the features those of the
unsharded pass, and eight slots compute Fisher features through K2
(``fv_stats``), ``torch.equal`` to the unsharded pass (its split count is
batch-invariant), and every spec candidate of the BCD and BWLS mesh
ladders on 4x2 slots of ``cuda:0`` runs its layout ``torch.equal`` to the
default layout.

This file imports neither JAX nor the JAX package, so it runs on a machine
without them:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_mesh_cuda.py``.
Tests that need the card carry the ``cuda`` marker and skip without one.
Every fit logs its outcome to a fresh file (``tests/torch_plan_log.py``)."""

import math

import numpy as np
import pytest
import torch

from keystone_tpu_torch.ops import fv_stats as fs
from keystone_tpu_torch.ops import rect_pool
from keystone_tpu_torch.parallel.mesh import make_mesh, padded_shard_rows
from keystone_tpu_torch.solvers.block import BlockLeastSquaresEstimator
from keystone_tpu_torch.solvers.weighted import BlockWeightedLeastSquaresEstimator
from keystone_tpu_torch.solvers.gmm import GaussianMixtureModel
from keystone_tpu_torch.workloads import cifar_random_patch as cifar
from keystone_tpu_torch.workloads import fv_common
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
    # The model slots of a data block share its card, so they share its features.
    assert rect_pool.fused_launches == data * per_slot
    rows = sharded.gather()
    assert rows.device == whole.device and rows.shape == whole.shape
    err = ((rows - whole).abs().max() / whole.abs().max()).item()
    assert torch.equal(rows, whole) or err <= 1e-2, err


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 2), (8, 1)], ids=["4x2", "8x1"])
def test_eight_slots_compute_fisher_vectors_through_the_kernel(cuda_device, shape):
    rng = np.random.default_rng(2)
    # Two buckets, of 38 and 19 images; the pixels read as [80, cols] descriptors.
    images = [rng.uniform(0, 255, ((40, 40, 3) if i % 3 else (48, 40, 3))).astype(np.float32)
              for i in range(57)]
    k = 64
    gmm = GaussianMixtureModel(
        torch.from_numpy(rng.uniform(0, 255, (80, k)).astype(np.float32)).to(cuda_device),
        torch.from_numpy(rng.uniform(500, 3000, (80, k)).astype(np.float32)).to(cuda_device),
        torch.full((k,), 1.0 / k, device=cuda_device),
    )
    fisher = fv_common.fisher_feature_pipeline(gmm)

    def describe(px):
        return px.reshape(px.shape[0], 80, -1)

    dim = 2 * 80 * k
    whole = fv_common.scatter_features(
        fv_common.describe_buckets(images, describe, cuda_device, 8), fisher, 57, dim)
    mesh = make_mesh(*shape, devices=[cuda_device] * 8)
    buckets = fv_common.describe_buckets(images, describe, cuda_device, 8, mesh=mesh)
    fs.launches = 0
    sharded = fv_common.scatter_features(buckets, fisher, 57, dim)
    want = 0
    for _idx, descs in buckets.values():
        per, cols = descs.data_blocks()[0].shape[0], descs.shape[2]
        want += shape[0] * math.ceil(per / fs.launch_geometry(per, 80, cols, k).group)
    assert fs.launches == want
    assert torch.equal(sharded, whole)


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["bcd", "bwls"])
def test_spec_candidates_execute_on_eight_slots(cuda_device, solver):
    """Each spec candidate of the 4x2 head, forced to the top, runs its
    layout and gives the default layout's model bit for bit on the card."""
    rng = np.random.default_rng(3)
    n, d, k = 2000, 600, (10 if solver == "bcd" else 16)
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(cuda_device)
    y = torch.from_numpy(
        (2.0 * np.eye(k)[rng.integers(0, k, n)] - 1.0).astype(np.float32)).to(cuda_device)
    mesh = make_mesh(4, 2, devices=[cuda_device] * 8)
    if solver == "bwls":
        x, y = (padded_shard_rows(t, mesh)[0] for t in (x, y))

    def estimator():
        return (BlockLeastSquaresEstimator(256, num_iter=2, lam=1.0, mesh=mesh)
                if solver == "bcd" else
                BlockWeightedLeastSquaresEstimator(256, 1, 0.1, 0.25, mesh=mesh))

    est = estimator()
    base = est.fit(x, y, plan=True)
    placement = est.last_fit_report.placement
    assert est.last_fit_report.chosen == placement["ranking"][0] == "fused[mesh 4x2]"
    names = [c["name"] for c in placement["candidates"]
             if c["specs"] and c["mesh"] == {"data": 4, "model": 2}]
    assert len(names) == (3 if solver == "bcd" else 2)
    for name in names:
        forced = estimator()
        got = forced.fit(x, y, plan=[name])
        assert forced.last_fit_report.chosen == name
        assert torch.equal(got.b, base.b), name
        assert all(torch.equal(a, b) for a, b in zip(got.xs, base.xs)), name
