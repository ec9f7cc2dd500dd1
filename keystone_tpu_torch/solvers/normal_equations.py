"""Normal-equations least squares (counterpart of
keystone_tpu/solvers/normal_equations.py), on ``torch.linalg``: grams, the
guarded λ-shifted Cholesky solve, one-shot least squares, and the
step-at-a-time block coordinate descent that the fused block fit
(``solvers/block.py``) is held against.

With a mesh (``parallel.mesh``) the rows are sharded over the data axis:
each data block's gram on its own slot, added in data order
(``parallel.collectives``); the factor of the regularised gram is
replicated, and the solve's right-hand-side columns (the classes) are split
over the model axis, padded with zero columns to a multiple of it (zero
label columns give zero weight columns).

The numerics guard is always on here: non-finite inputs raise, and a
factorization that fails retries with escalating jitter before raising
(the JAX package can switch it off with ``KEYSTONE_NUMERICS_GUARD=0``).
With the numerics observatory on, each guarded solve first feeds the
conditioning monitor (``core.numerics.estimate_gram_condition``).
"""

from __future__ import annotations

import logging
from typing import Sequence

import torch

from ..core import numerics as knum
from ..parallel.collectives import psum, sharded_gram
from ..parallel.mesh import MODEL_AXIS, ShardedRows, on_slot, padded_shard_rows

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


def _guarded_solve(solve_fn, ata: torch.Tensor, atb: torch.Tensor, lam: float) -> torch.Tensor:
    """``solve_fn(ata, atb, lam)``, guarded: non-finite entries in ``ata``
    or ``atb`` raise ``FloatingPointError``; a non-finite solution (an
    indefinite or rank-deficient gram NaNs the f32 factor) retries with
    λ·10^k for k = 1..3, one warning per step, then raises.  λ = 0
    escalates from 1.2e-7·|mean diagonal|, about f32 epsilon relative to
    the gram's scale.  The checks cost host syncs per solve."""
    if knum.active():
        # A κ estimate of the gram this Cholesky is about to factor, counted
        # as a predictive ``cond_warn`` before the jitter retry trips.
        knum.estimate_gram_condition(ata, float(lam), label="solve_gram_l2")
    if not _all_finite(ata) or not _all_finite(atb):
        raise FloatingPointError(
            "solve_gram_l2: non-finite entries in the gram/right-hand side "
            "— a NaN/Inf batch reached the solver"
        )
    lam0 = float(lam)
    x = solve_fn(ata, atb, lam0)
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
        x = solve_fn(ata, atb, lam_k)
        if _all_finite(x):
            return x
    raise FloatingPointError(
        f"solve_gram_l2: solution still non-finite after "
        f"{_MAX_JITTER_ESCALATIONS} jitter escalations "
        f"(final lam={base * 10.0 ** _MAX_JITTER_ESCALATIONS:.3g}) — the "
        "gram is numerically broken beyond regularization"
    )


def solve_gram_l2(ata: torch.Tensor, atb: torch.Tensor, lam: float) -> torch.Tensor:
    """Solve ``(AᵀA + λI) X = AᵀB`` via Cholesky, guarded
    (:func:`_guarded_solve`)."""
    return _guarded_solve(_solve_gram_l2, ata, atb, lam)


def _pad_cols(x: torch.Tensor, mult: int) -> tuple[torch.Tensor, int]:
    """Zero-pad trailing columns to a multiple of ``mult`` (exact for the
    solvers: zero label columns produce zero weight columns)."""
    pad = (-x.shape[1]) % mult
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    return x, pad


def _mesh_solver_fns(mesh):
    """The mesh's two solver steps: ``solve(ata, atb, lam)``, the
    regularised Cholesky solve replicated on model slot ``m`` of data row
    0 for its share of the class columns (the reference's per-class
    column partitioning, BlockWeightedLeastSquares.scala:228-263), and
    ``block_update(blk, ata, m_old, residual, lam)``, one BCD update over a
    row-sharded block and the residual's per-data-block tensors."""
    m_sz = mesh.shape[MODEL_AXIS]
    heads = [mesh.devices[0, m] for m in range(m_sz)]

    def solve(ata, atb, lam):
        km = atb.shape[1] // m_sz
        cols = [
            _solve_gram_l2(on_slot(ata, dev), on_slot(atb[:, m * km : (m + 1) * km], dev), lam)
            for m, dev in enumerate(heads)
        ]
        return torch.cat([on_slot(c, heads[0]) for c in cols], dim=1)

    def block_update(blk: ShardedRows, ata, m_old, residual: list, lam):
        r_i = [r + b @ on_slot(m_old, b.device) for b, r in zip(blk.data_blocks(), residual)]
        m_new = solve(ata, psum([b.T @ r for b, r in zip(blk.data_blocks(), r_i)]), lam)
        return m_new, [r - b @ on_slot(m_new, b.device) for b, r in zip(blk.data_blocks(), r_i)]

    return solve, block_update


def solve_least_squares(a, b, lam: float = 0.0, mesh=None) -> torch.Tensor:
    """One-shot (regularized) least squares ``min ‖AX - B‖² + λ‖X‖²``.

    With ``mesh``: ``a`` and ``b`` (tensors or row-sharded arrays) are
    sharded over the data axis, zero-padded to a multiple of it (exact:
    zero rows add nothing to the grams), the grams reduce in data order and
    the solve splits the class columns over the model axis.  The result is
    on slot (0, 0)'s device."""
    if mesh is None:
        ata, atb = gram(a, b)
        return solve_gram_l2(ata, atb, lam)
    solve, _ = _mesh_solver_fns(mesh)
    a, nvalid = padded_shard_rows(a, mesh)
    b, _ = padded_shard_rows(b, mesh, nvalid=nvalid)
    col_pad = (-b.shape[1]) % mesh.shape[MODEL_AXIS]
    b = b.apply(lambda t: _pad_cols(t, mesh.shape[MODEL_AXIS])[0])
    ata, atb = sharded_gram(a, b)
    x = _guarded_solve(solve, ata, atb, lam)
    return x[:, : x.shape[1] - col_pad] if col_pad else x


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
    mesh=None,
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

    With ``mesh``: blocks and labels are row-sharded (uneven row counts
    zero-padded: zero rows are zero in the blocks and the labels, so grams
    and residual updates are unchanged), the block grams and every update's
    right-hand side reduce over the data axis in data order, and each solve
    splits the class columns over the model axis (:func:`_mesh_solver_fns`).
    """
    lam = float(lam)
    if len(blocks) == 1 and models_init is None:
        return [solve_least_squares(blocks[0], labels, lam, mesh=mesh)]
    if mesh is not None:
        return _bcd_mesh(blocks, labels, lam, num_iter, models_init, mesh)

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


def _bcd_mesh(blocks, labels, lam: float, num_iter: int, models_init, mesh) -> list:
    """:func:`bcd_least_squares_l2` over ``mesh``."""
    _, block_update = _mesh_solver_fns(mesh)
    m_sz = mesh.shape[MODEL_AXIS]
    blocks = [padded_shard_rows(b, mesh)[0] for b in blocks]
    labels, _ = padded_shard_rows(labels, mesh, nvalid=blocks[0].nvalid)
    k = labels.shape[1]
    y = [_pad_cols(t, m_sz)[0] for t in labels.data_blocks()]
    grams = [psum([t.T @ t for t in blk.data_blocks()]) for blk in blocks]
    head = mesh.devices[0, 0]
    if models_init is None:
        models = [
            torch.zeros((blk.shape[1], y[0].shape[1]), dtype=y[0].dtype, device=head)
            for blk in blocks
        ]
    else:
        models = [on_slot(_pad_cols(m, m_sz)[0], head) for m in models_init]
    residual = list(y)
    for blk, m in zip(blocks, models):
        residual = [r - b @ on_slot(m, b.device) for b, r in zip(blk.data_blocks(), residual)]
    for _ in range(num_iter):
        for i, blk in enumerate(blocks):
            models[i], residual = block_update(blk, grams[i], models[i], residual, lam)
    return [m[:, :k] for m in models]
