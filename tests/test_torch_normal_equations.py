"""keystone_tpu_torch's single-device normal-equations solvers against the
JAX package's, on the same numpy inputs (CPU, f32): ``gram``,
``solve_gram_l2`` with its guard, ``solve_least_squares``,
``NormalEquations`` and the step-at-a-time ``bcd_least_squares_l2``; and the
port's fused block fit against that oracle.

Tolerances: the grams rtol 1e-5 (f32 products in another order); the
solutions rtol 1e-4, atol 1e-5·max (two f32 Cholesky solves of grams with
κ below 1e2); the fused fit against the oracle rtol 2e-4, atol 2e-5 (the
JAX package's own bar for its fused fit).  The guard is checked on
hand-built grams whose factorisation fails or succeeds exactly (a
decoupled negative pivot), so the escalation count does not depend on the
BLAS."""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.solvers import normal_equations as jne
from keystone_tpu_torch.solvers import normal_equations as tne
from keystone_tpu_torch.solvers.block import BlockLeastSquaresEstimator
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401

LAMS = [0.0, 1e-2, 10.0]


def _problem(rng, n=200, d=12, k=3):
    a = (rng.normal(size=(n, d)) + 0.3).astype(np.float32)
    b = (a @ rng.normal(size=(d, k)) + 0.1 * rng.normal(size=(n, k))).astype(np.float32)
    return a, b


def _close(got: torch.Tensor, want, rtol=1e-4, atol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol * np.abs(want).max())


def test_gram_matches(rng):
    a, b = _problem(rng)
    got = tne.gram(torch.from_numpy(a), torch.from_numpy(b))
    want = jne.gram(jnp.asarray(a), jnp.asarray(b))
    for g, w in zip(got, want):
        _close(g, w, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("lam", LAMS)
def test_solve_gram_l2_matches(rng, lam):
    a, b = _problem(rng)
    ata, atb = a.T @ a, a.T @ b
    _close(
        tne.solve_gram_l2(torch.from_numpy(ata), torch.from_numpy(atb), lam),
        jne.solve_gram_l2(jnp.asarray(ata), jnp.asarray(atb), lam),
    )


@pytest.mark.parametrize("lam", LAMS)
def test_solve_least_squares_and_facade_match(rng, lam):
    a, b = _problem(rng)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    want = jne.solve_least_squares(jnp.asarray(a), jnp.asarray(b), lam)
    _close(tne.solve_least_squares(ta, tb, lam), want)
    facade = tne.NormalEquations()
    _close(facade.solve_least_squares_with_l2(ta, tb, lam), want)
    _close(
        facade.solve_least_squares(ta, tb),
        jne.NormalEquations().solve_least_squares(jnp.asarray(a), jnp.asarray(b)),
    )


@pytest.mark.parametrize("num_blocks", [1, 2, 3])
@pytest.mark.parametrize("lam", LAMS)
def test_bcd_least_squares_l2_matches(rng, lam, num_blocks):
    a, b = _problem(rng, d=6 * num_blocks)
    blocks = [a[:, i : i + 6] for i in range(0, a.shape[1], 6)]
    got = tne.bcd_least_squares_l2(
        [torch.from_numpy(x) for x in blocks], torch.from_numpy(b), lam, 3
    )
    want = jne.bcd_least_squares_l2([jnp.asarray(x) for x in blocks], jnp.asarray(b), lam, 3)
    assert len(got) == len(want) == num_blocks
    for g, w in zip(got, want):
        _close(g, w)


def test_bcd_least_squares_l2_warm_start_matches(rng):
    a, b = _problem(rng, d=10)
    blocks = [a[:, :4], a[:, 4:]]
    init = [rng.normal(size=(4, 3)).astype(np.float32), rng.normal(size=(6, 3)).astype(np.float32)]
    got = tne.bcd_least_squares_l2(
        [torch.from_numpy(x) for x in blocks], torch.from_numpy(b), 0.5, 2,
        models_init=[torch.from_numpy(m) for m in init],
    )
    want = jne.bcd_least_squares_l2(
        [jnp.asarray(x) for x in blocks], jnp.asarray(b), 0.5, 2,
        models_init=[jnp.asarray(m) for m in init],
    )
    for g, w in zip(got, want):
        _close(g, w)


def test_fused_fit_matches_stepwise_oracle(rng):
    """The fused block fit reproduces the step-at-a-time oracle run on
    pre-centered blocks: same centering, update order and regularization."""
    n, d, k, bs = 40, 22, 3, 8
    a = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(n, k)).astype(np.float32))
    lam, iters = 0.3, 3
    fused = BlockLeastSquaresEstimator(bs, num_iter=iters, lam=lam).fit(a, b)

    blocks = [a[:, i : i + bs] for i in range(0, d, bs)]
    centered = [blk - blk.mean(dim=0) for blk in blocks]
    oracle = tne.bcd_least_squares_l2(centered, b - b.mean(dim=0), lam, iters)
    for got, want in zip(fused.xs, oracle):
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)
    pred = sum(c @ m for c, m in zip(centered, oracle)) + b.mean(dim=0)
    torch.testing.assert_close(fused(a), pred, rtol=2e-4, atol=2e-4)


def _pivot_gram(t: float):
    """An SPD 3x3 block beside a decoupled pivot ``-t``: the f32 Cholesky
    fails exactly while the shift is below ``t`` and succeeds above it."""
    ata = np.zeros((4, 4), np.float32)
    ata[:3, :3] = [[2.0, 0.5, 0.0], [0.5, 2.0, 0.3], [0.0, 0.3, 2.0]]
    ata[3, 3] = -t
    atb = np.arange(8, dtype=np.float32).reshape(4, 2) + 1.0
    return ata, atb


def _escalations(caplog) -> int:
    return sum("retrying with jitter" in r.getMessage() for r in caplog.records)


@pytest.mark.parametrize("bad", ["gram", "rhs"])
def test_guard_rejects_non_finite_inputs(bad):
    ata, atb = _pivot_gram(-1.0)
    (ata if bad == "gram" else atb)[1, 1] = np.nan
    with pytest.raises(FloatingPointError, match="non-finite entries"):
        tne.solve_gram_l2(torch.from_numpy(ata), torch.from_numpy(atb), 0.0)
    with pytest.raises(FloatingPointError):
        jne.solve_gram_l2(jnp.asarray(ata), jnp.asarray(atb), 0.0)


def test_guard_recovers_tiny_negative_pivot_at_first_escalation(caplog):
    # λ = 0 escalates from 1.2e-7·|mean diag| = 9e-8 (mean diag 0.75): step
    # 1 shifts by 9e-7, which clears a pivot of -5e-7.
    ata, atb = _pivot_gram(5e-7)
    with caplog.at_level(logging.WARNING):
        got = tne.solve_gram_l2(torch.from_numpy(ata), torch.from_numpy(atb), 0.0)
    port_steps = _escalations(caplog)
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        want = jne.solve_gram_l2(jnp.asarray(ata), jnp.asarray(atb), 0.0)
    assert port_steps == _escalations(caplog) == 1
    assert torch.isfinite(got).all()
    _close(got, want, rtol=1e-5, atol=1e-7)


def test_guard_raises_after_three_escalations(caplog):
    ata, atb = _pivot_gram(1.0)
    with caplog.at_level(logging.WARNING):
        with pytest.raises(FloatingPointError, match="after 3 jitter escalations"):
            tne.solve_gram_l2(torch.from_numpy(ata), torch.from_numpy(atb), 0.0)
    port_steps = _escalations(caplog)
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        with pytest.raises(FloatingPointError):
            jne.solve_gram_l2(jnp.asarray(ata), jnp.asarray(atb), 0.0)
    assert port_steps == _escalations(caplog) == 3


def test_guard_positive_lambda_escalates_from_lambda(caplog):
    # λ = 1e-3 escalates 1e-2, 1e-1, 1: a pivot of -0.05 clears at step 2.
    ata, atb = _pivot_gram(0.05)
    with caplog.at_level(logging.WARNING):
        got = tne.solve_gram_l2(torch.from_numpy(ata), torch.from_numpy(atb), 1e-3)
    assert _escalations(caplog) == 2
    _close(got, jne.solve_gram_l2(jnp.asarray(ata), jnp.asarray(atb), 1e-3), rtol=1e-5, atol=1e-7)
