"""Single-device normal-equations least squares (counterpart of
keystone_tpu/solvers/normal_equations.py without the mesh), on
``torch.linalg``: grams, the guarded λ-shifted Cholesky solve, one-shot
least squares, and the step-at-a-time block coordinate descent that the
fused block fit (``solvers/block.py``) is held against.

The numerics guard is always on here: non-finite inputs raise, and a
factorization that fails retries with escalating jitter before raising.
The JAX package can switch it off (``KEYSTONE_NUMERICS_GUARD=0``) and also
feeds a conditioning monitor; the port has neither.
"""

from __future__ import annotations

import logging
from typing import Sequence

import torch

_logger = logging.getLogger("keystone_tpu_torch.solvers.normal_equations")

# The regularizer grows λ·10^k for k = 1..3 before the solve gives up.
_MAX_JITTER_ESCALATIONS = 3


def cho_factor(reg: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of ``reg``.  A matrix that is not positive
    definite yields an all-NaN factor (as ``jax.scipy.linalg.cho_factor``
    does) instead of raising, and without a host sync."""
    low, info = torch.linalg.cholesky_ex(reg)
    return low.masked_fill(info != 0, float("nan"))


def cho_solve(low: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``L L^T x = b`` given the lower factor ``L``."""
    return torch.cholesky_solve(b, low)


def gram(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(AᵀA, AᵀB)."""
    return a.T @ a, a.T @ b


def _solve_gram_l2(ata: torch.Tensor, atb: torch.Tensor, lam: float) -> torch.Tensor:
    d = ata.shape[0]
    reg = ata + lam * torch.eye(d, dtype=ata.dtype, device=ata.device)
    return cho_solve(cho_factor(reg), atb)


def _all_finite(x: torch.Tensor) -> bool:
    return bool(torch.isfinite(x).all())


def solve_gram_l2(ata: torch.Tensor, atb: torch.Tensor, lam: float) -> torch.Tensor:
    """Solve ``(AᵀA + λI) X = AᵀB`` via Cholesky, guarded.

    Non-finite entries in ``ata`` or ``atb`` raise ``FloatingPointError``.
    A non-finite solution (an indefinite or rank-deficient gram NaNs the f32
    factor) retries with λ·10^k for k = 1..3, one warning per step, then
    raises.  λ = 0 escalates from 1.2e-7·|mean diagonal|, about f32 epsilon
    relative to the gram's scale.  The checks cost host syncs per solve.
    """
    if not _all_finite(ata) or not _all_finite(atb):
        raise FloatingPointError(
            "solve_gram_l2: non-finite entries in the gram/right-hand side "
            "— a NaN/Inf batch reached the solver"
        )
    lam0 = float(lam)
    x = _solve_gram_l2(ata, atb, lam0)
    if _all_finite(x):
        return x
    base = lam0
    if base <= 0.0:
        mean_diag = float(torch.diagonal(ata).mean())
        base = 1.2e-7 * abs(mean_diag) if mean_diag != 0.0 else 1.2e-7
    for k in range(1, _MAX_JITTER_ESCALATIONS + 1):
        lam_k = base * (10.0 ** k)
        _logger.warning(
            "solve_gram_l2: Cholesky produced non-finite solution at "
            "lam=%.3g; retrying with jitter lam=%.3g (escalation %d/%d)",
            lam0 if k == 1 else base * (10.0 ** (k - 1)),
            lam_k,
            k,
            _MAX_JITTER_ESCALATIONS,
        )
        x = _solve_gram_l2(ata, atb, lam_k)
        if _all_finite(x):
            return x
    raise FloatingPointError(
        f"solve_gram_l2: solution still non-finite after "
        f"{_MAX_JITTER_ESCALATIONS} jitter escalations "
        f"(final lam={base * 10.0 ** _MAX_JITTER_ESCALATIONS:.3g}) — the "
        "gram is numerically broken beyond regularization"
    )


def solve_least_squares(a: torch.Tensor, b: torch.Tensor, lam: float = 0.0) -> torch.Tensor:
    """One-shot (regularized) least squares ``min ‖AX - B‖² + λ‖X‖²``."""
    ata, atb = gram(a, b)
    return solve_gram_l2(ata, atb, lam)


class NormalEquations:
    """Class-shaped facade matching the ml-matrix API surface."""

    def solve_least_squares(self, a, b):
        return solve_least_squares(a, b, 0.0)

    def solve_least_squares_with_l2(self, a, b, lam):
        return solve_least_squares(a, b, lam)


def bcd_least_squares_l2(
    blocks: Sequence[torch.Tensor],
    labels: torch.Tensor,
    lam: float,
    num_iter: int,
    models_init: Sequence[torch.Tensor] | None = None,
) -> list[torch.Tensor]:
    """Block coordinate descent for ``min ‖Σ_i A_i X_i - B‖² + λΣ‖X_i‖²``,
    one step at a time.

    The fit path is the fused ``solvers.block.BlockLeastSquaresEstimator``;
    this form is the oracle it is tested against, and the entry point for
    callers holding pre-centered blocks.  Per epoch, per block i: solve
    ``(A_iᵀA_i + λI) X_i' = A_iᵀ (R + A_i X_i)``, where ``R = B - Σ_j A_j
    X_j`` is the running residual, then update R.  The block grams are
    computed once.  One block and no initial models is plain (guarded)
    normal equations; the multi-block updates are unguarded, as in the JAX
    package.

    blocks: list of [N, d_i]; labels: [N, k].  Returns the [d_i, k] blocks.
    """
    lam = float(lam)
    if len(blocks) == 1 and models_init is None:
        return [solve_least_squares(blocks[0], labels, lam)]

    grams = [blk.T @ blk for blk in blocks]
    if models_init is None:
        models = [
            torch.zeros((blk.shape[1], labels.shape[1]), dtype=labels.dtype, device=labels.device)
            for blk in blocks
        ]
    else:
        models = list(models_init)

    residual = labels
    for blk, m in zip(blocks, models):
        residual = residual - blk @ m
    for _ in range(num_iter):
        for i, blk in enumerate(blocks):
            r_i = residual + blk @ models[i]
            models[i] = _solve_gram_l2(grams[i], blk.T @ r_i, lam)
            residual = r_i - blk @ models[i]
    return models
