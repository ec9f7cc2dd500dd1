"""The port's data-axis reductions (``keystone_tpu_torch.parallel.collectives``)
and the solvers built on them, against the port's single-device forms and
the JAX package's mesh forms (``tests/test_distributed.py``'s bars).

The port's meshes are 8 slots of the one CPU (``make_mesh(4, 2,
devices=[cpu] * 8)`` and ``(8, 1)``); the JAX side runs on the conftest's 8
virtual CPU devices.  Inputs are seeded numpy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.parallel.collectives import sharded_gram as jax_sharded_gram
from keystone_tpu.parallel.mesh import padded_shard_rows as jax_padded_shard_rows
from keystone_tpu.solvers.normal_equations import (
    bcd_least_squares_l2 as jax_bcd,
    solve_least_squares as jax_solve,
)
from keystone_tpu_torch.ops.stats import StandardScaler
from keystone_tpu_torch.parallel.collectives import psum, sharded_gram, sharded_moments
from keystone_tpu_torch.parallel.mesh import make_mesh, padded_shard_rows
from keystone_tpu_torch.solvers.normal_equations import bcd_least_squares_l2, solve_least_squares
from keystone_tpu_torch.utils.stats import about_eq
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401

CPU = torch.device("cpu")


def _mesh(data, model):
    return make_mesh(data, model, devices=[CPU] * (data * model))


MESHES = {"4x2": (4, 2), "8x1": (8, 1)}


def _problem(rng, n=192, d=24, k=4, noise=0.05):
    x_true = rng.normal(size=(d, k))
    a = rng.normal(size=(n, d))
    b = a @ x_true + noise * rng.normal(size=(n, k))
    return a.astype(np.float32), b.astype(np.float32)


def test_psum_adds_in_the_order_given():
    parts = [torch.tensor([1e8], dtype=torch.float32), torch.tensor([1.0]),
             torch.tensor([-1e8])]
    # (1e8 + 1) - 1e8 rounds the 1 away; any other order keeps it.
    assert psum(parts).item() == 0.0
    assert psum(parts[::-1]).item() == 0.0 and psum([parts[0], parts[2], parts[1]]).item() == 1.0
    one = torch.arange(3.0)
    assert psum([one]) is one


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_gram_matches_local_and_jax(rng, shape, request):
    a, b = _problem(rng, n=190)
    mesh = _mesh(*MESHES[shape])
    xs, _ = padded_shard_rows(a, mesh)
    ys, _ = padded_shard_rows(b, mesh)
    ata, atb = sharded_gram(xs, ys)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    jmesh = request.getfixturevalue("mesh42" if shape == "4x2" else "mesh8")
    ja, _ = jax_padded_shard_rows(a, jmesh)
    jb, _ = jax_padded_shard_rows(b, jmesh)
    want_a, want_b = jax_sharded_gram(jmesh, ja, jb)
    # Grams of 190 rows: entries up to ~200, f32 sums in another order.
    for got, local, jax_want in ((ata, ta.T @ ta, want_a), (atb, ta.T @ tb, want_b)):
        scale = 1e-6 * float(local.abs().max())
        np.testing.assert_allclose(got.numpy(), local.numpy(), rtol=0, atol=scale)
        np.testing.assert_allclose(got.numpy(), np.asarray(jax_want), rtol=0, atol=scale)


def test_one_data_block_is_the_local_gram_bit_for_bit(rng):
    a, b = _problem(rng)
    xs, _ = padded_shard_rows(a, _mesh(1, 2))
    ys, _ = padded_shard_rows(b, _mesh(1, 2))
    ata, atb = sharded_gram(xs, ys)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert torch.equal(ata, ta.T @ ta) and torch.equal(atb, ta.T @ tb)


def test_sharded_moments_count_pad_rows_and_sum_the_true_ones(rng):
    a, _ = _problem(rng, n=190)
    xs, _ = padded_shard_rows(a, _mesh(8, 1))
    cnt, s, sq = sharded_moments(xs)
    assert cnt == 192.0  # 190 rows padded to a multiple of 8
    np.testing.assert_allclose(s.numpy(), a.sum(0), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(sq.numpy(), (a * a).sum(0), rtol=1e-5)


@pytest.mark.parametrize("normalize", [True, False])
def test_standard_scaler_on_sharded_rows(rng, normalize):
    a, _ = _problem(rng, n=190)
    local = StandardScaler(normalize_std_dev=normalize).fit(torch.from_numpy(a))
    xs, _ = padded_shard_rows(a, _mesh(4, 2))
    sharded = StandardScaler(normalize_std_dev=normalize).fit(xs)
    torch.testing.assert_close(sharded.mean, local.mean, rtol=1e-5, atol=1e-6)
    if normalize:
        torch.testing.assert_close(sharded.std, local.std, rtol=1e-5, atol=1e-6)
    # One data block: the same sums, so the same bits.
    one, _ = padded_shard_rows(a, _mesh(1, 1))
    assert torch.equal(StandardScaler(normalize_std_dev=normalize).fit(one).mean, local.mean)


@pytest.mark.parametrize("shape", MESHES)
def test_solve_least_squares_mesh_matches_local_and_jax(rng, shape, request):
    a, b = _problem(rng, n=190)
    mesh = _mesh(*MESHES[shape])
    local = solve_least_squares(torch.from_numpy(a), torch.from_numpy(b), 0.7)
    sharded = solve_least_squares(torch.from_numpy(a), torch.from_numpy(b), 0.7, mesh=mesh)
    assert about_eq(sharded.numpy(), local.numpy(), 1e-4)
    jmesh = request.getfixturevalue("mesh42" if shape == "4x2" else "mesh8")
    want = jax_solve(jnp.asarray(a), jnp.asarray(b), 0.7, mesh=jmesh)
    assert about_eq(sharded.numpy(), np.asarray(want), 1e-4)


def test_solve_least_squares_pads_class_columns_to_the_model_axis(rng):
    a, b = _problem(rng, k=3)  # 3 classes over a 2-way model axis
    local = solve_least_squares(torch.from_numpy(a), torch.from_numpy(b), 0.5)
    sharded = solve_least_squares(torch.from_numpy(a), torch.from_numpy(b), 0.5,
                                  mesh=_mesh(4, 2))
    assert tuple(sharded.shape) == (24, 3)
    assert about_eq(sharded.numpy(), local.numpy(), 1e-4)


def test_bcd_mesh_matches_local_and_jax(rng, mesh42):
    a, b = _problem(rng, d=30)
    blocks = [a[:, :10], a[:, 10:20], a[:, 20:]]
    tblocks = [torch.from_numpy(np.ascontiguousarray(x)) for x in blocks]
    local = bcd_least_squares_l2(tblocks, torch.from_numpy(b), 0.5, 3)
    sharded = bcd_least_squares_l2(tblocks, torch.from_numpy(b), 0.5, 3, mesh=_mesh(4, 2))
    want = jax_bcd([jnp.asarray(x) for x in blocks], jnp.asarray(b), 0.5, 3, mesh=mesh42)
    for lm, sm, jm in zip(local, sharded, want):
        assert about_eq(sm.numpy(), lm.numpy(), 1e-4)
        assert about_eq(sm.numpy(), np.asarray(jm), 1e-4)
