"""keystone_tpu_torch's linear models against the JAX package's, on the same
numpy inputs (CPU, f32): ``LinearMapEstimator``/``LinearMapper`` (with
zero pad rows masked by ``nvalid``), ``LeastSquaresModel``, and
``BlockLinearMapper.apply_and_evaluate``'s running predictions, call for
call.

Tolerances: the scaler means and the intercept rtol 1e-5, atol 1e-6; the
weights and predictions rtol 1e-4, atol 1e-5·max (two f32 Cholesky solves
of grams with κ below 1e2); the plain products rtol 1e-5, atol 1e-6·max."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.ops.stats import StandardScalerModel as JaxScalerModel
from keystone_tpu.solvers.block import BlockLinearMapper as JaxBlockMapper
from keystone_tpu.solvers.linear import (
    LeastSquaresModel as JaxLSModel,
    LinearMapEstimator as JaxLinearEstimator,
)
from keystone_tpu_torch.ops.stats import StandardScalerModel
from keystone_tpu_torch.solvers.block import BlockLinearMapper
from keystone_tpu_torch.solvers.linear import (
    LeastSquaresModel,
    LinearMapEstimator,
    LinearMapper,
)
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401


def _close(got: torch.Tensor, want, rtol=1e-4, atol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol * np.abs(want).max())


def _problem(rng, n=300, d=10, k=3):
    a = (rng.normal(size=(n, d)) + 5.0).astype(np.float32)  # nonzero means
    b = (a @ rng.normal(size=(d, k)) + 2.0 + 0.01 * rng.normal(size=(n, k))).astype(np.float32)
    return a, b


@pytest.mark.parametrize("lam", [None, 0.1, 10.0])
def test_linear_map_estimator_matches(rng, lam):
    a, b = _problem(rng)
    ref = JaxLinearEstimator(lam).fit(jnp.asarray(a), jnp.asarray(b))
    got = LinearMapEstimator(lam).fit(torch.from_numpy(a), torch.from_numpy(b))
    assert isinstance(got, LinearMapper)
    _close(got.feature_scaler.mean, ref.feature_scaler.mean, rtol=1e-5, atol=1e-6)
    _close(got.b, ref.b, rtol=1e-5, atol=1e-6)
    _close(got.x, ref.x)
    _close(got(torch.from_numpy(a)), ref(jnp.asarray(a)))


def test_linear_map_estimator_masks_pad_rows(rng):
    a, b = _problem(rng, n=90)
    ap = np.concatenate([a, np.zeros((22, a.shape[1]), np.float32)])
    bp = np.concatenate([b, np.zeros((22, b.shape[1]), np.float32)])
    ref = JaxLinearEstimator(0.5).fit(jnp.asarray(ap), jnp.asarray(bp), nvalid=90)
    got = LinearMapEstimator(0.5).fit(torch.from_numpy(ap), torch.from_numpy(bp), nvalid=90)
    whole = LinearMapEstimator(0.5).fit(torch.from_numpy(a), torch.from_numpy(b))
    _close(got.x, ref.x)
    _close(got.b, ref.b, rtol=1e-5, atol=1e-6)
    _close(got.x, whole.x.numpy())
    _close(got(torch.from_numpy(a)), ref(jnp.asarray(a)))


@pytest.mark.parametrize("with_intercept", [True, False])
def test_least_squares_model_matches(rng, with_intercept):
    w = rng.normal(size=(8, 4)).astype(np.float32)
    c = rng.normal(size=4).astype(np.float32) if with_intercept else None
    x = rng.normal(size=(30, 8)).astype(np.float32)
    got = LeastSquaresModel(torch.from_numpy(w), None if c is None else torch.from_numpy(c))
    ref = JaxLSModel(jnp.asarray(w), None if c is None else jnp.asarray(c))
    _close(got(torch.from_numpy(x)), ref(jnp.asarray(x)), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("split", ["monolithic", "blocks"])
@pytest.mark.parametrize("intercept", [True, False])
def test_block_linear_mapper_apply_and_evaluate_matches(rng, split, intercept):
    widths, k = (10, 10, 4), 3
    xs = [rng.normal(size=(w, k)).astype(np.float32) for w in widths]
    means = [rng.normal(size=w).astype(np.float32) for w in widths]
    b = np.ones(k, np.float32) if intercept else None
    data = rng.normal(size=(40, sum(widths))).astype(np.float32)
    got_model = BlockLinearMapper(
        [torch.from_numpy(x) for x in xs], 10, None if b is None else torch.from_numpy(b),
        [StandardScalerModel(torch.from_numpy(m)) for m in means],
    )
    ref_model = JaxBlockMapper(
        [jnp.asarray(x) for x in xs], 10, None if b is None else jnp.asarray(b),
        [JaxScalerModel(jnp.asarray(m)) for m in means],
    )
    cuts = np.cumsum(widths)[:-1]
    t_in = torch.from_numpy(data)
    j_in = jnp.asarray(data)
    if split == "blocks":
        t_in = list(torch.split(t_in, widths, dim=1))
        j_in = [jnp.asarray(p) for p in np.split(data, cuts, axis=1)]
    got, want = [], []
    got_model.apply_and_evaluate(t_in, lambda p: got.append(p.clone()))
    ref_model.apply_and_evaluate(j_in, lambda p: want.append(np.asarray(p)))
    assert len(got) == len(want) == len(widths)
    for g, w in zip(got, want):
        _close(g, w, rtol=1e-5, atol=1e-6)
    # the last call sees the full model; the intercept is added once per call
    _close(got[-1], got_model(torch.from_numpy(data)).numpy(), rtol=1e-6, atol=1e-7)
    first = (data[:, :10] - means[0]) @ xs[0] + (0.0 if b is None else b)
    _close(got[0], first, rtol=1e-5, atol=1e-6)


def test_apply_and_evaluate_rejects_wrong_block_count(rng):
    model = BlockLinearMapper([torch.zeros(4, 2), torch.zeros(4, 2)], 4)
    with pytest.raises(ValueError, match="feature blocks"):
        model.apply_and_evaluate([torch.zeros(3, 4)], lambda p: None)
    with pytest.raises(ValueError, match="wide"):
        model.apply_and_evaluate(torch.zeros(3, 7), lambda p: None)
