"""Block linear models (counterpart of keystone_tpu/solvers/block.py).

Only the single-device fused tier is ported: centering, per-block
regularised grams, Cholesky factors (once) and ``num_iter`` epochs of block
coordinate descent, as a Python loop over epochs and blocks.  The mesh,
autoshard, memory-ladder, host-staged and stepwise/checkpoint tiers of the
JAX package are not ported.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from ..core import numerics as knum
from ..core.pipeline import Identity, LabelEstimator, Transformer
from ..ops.stats import StandardScalerModel
from .normal_equations import cho_factor, cho_solve


class BlockLinearMapper(Transformer):
    """Linear model stored as feature blocks.

    xs: list of [d_i, k] weight blocks; b: optional [k] intercept;
    feature_scalers: per-block transformers applied before the product.
    """

    def __init__(
        self,
        xs: Sequence[torch.Tensor],
        block_size: int,
        b=None,
        feature_scalers: Sequence[Transformer] | None = None,
    ):
        self.xs = list(xs)
        self.block_size = block_size
        self.b = b
        self.feature_scalers = (
            list(feature_scalers)
            if feature_scalers is not None
            else [Identity() for _ in self.xs]
        )

    def apply_blocks(self, blocks: Sequence[torch.Tensor]):
        if len(blocks) != len(self.xs):
            raise ValueError(
                f"{len(blocks)} feature blocks vs {len(self.xs)} model blocks"
            )
        out = None
        for blk, x, scaler in zip(blocks, self.xs, self.feature_scalers):
            part = scaler(blk) @ x
            out = part if out is None else out + part
        if self.b is not None:
            out = out + self.b
        return out

    def _split_features(self, batch):
        """Cut [n, D] features into this model's own fitted block widths."""
        widths = [int(x.shape[0]) for x in self.xs]
        if int(batch.shape[-1]) != sum(widths):
            raise ValueError(
                f"feature matrix is {int(batch.shape[-1])} wide but the "
                f"model's blocks sum to {sum(widths)} ({widths})"
            )
        return list(torch.split(batch, widths, dim=-1))

    def __call__(self, batch):
        if isinstance(batch, (list, tuple)):
            return self.apply_blocks(batch)
        return self.apply_blocks(self._split_features(batch))

    def apply_and_evaluate(self, batch_or_blocks, evaluator: Callable[[torch.Tensor], None]):
        """Call ``evaluator`` on the running prediction (intercept included)
        after each block: streaming evaluation, the last call seeing the
        full model."""
        blocks = (
            batch_or_blocks
            if isinstance(batch_or_blocks, (list, tuple))
            else self._split_features(batch_or_blocks)
        )
        if len(blocks) != len(self.xs):
            raise ValueError(
                f"{len(blocks)} feature blocks vs {len(self.xs)} model blocks"
            )
        running = None
        for blk, x, scaler in zip(blocks, self.xs, self.feature_scalers):
            part = scaler(blk) @ x
            running = part if running is None else running + part
            evaluator(running if self.b is None else running + self.b)


def _blocked_design_matrix(features, block_size: int, num_features=None):
    """(x, widths): the [N, B*bs] zero-padded blocked layout the fit
    consumes, from a monolithic [N, d] tensor or a list of feature blocks.
    A monolithic input whose width is a block multiple passes through
    uncopied."""
    if isinstance(features, (list, tuple)):
        widths = tuple(int(b.shape[1]) for b in features)
        bs = max(widths)
        parts = [
            torch.nn.functional.pad(b, (0, bs - w)) if w < bs else b
            for b, w in zip(features, widths)
        ]
        return torch.cat(parts, dim=1), widths
    d = num_features or features.shape[1]
    if d > features.shape[1]:
        raise ValueError(
            f"num_features={d} exceeds the actual feature count "
            f"{features.shape[1]} — the blocked-design contract requires "
            "num_features <= features.shape[1]"
        )
    widths = tuple(min(block_size, d - i) for i in range(0, d, block_size))
    bs = max(widths)
    features = features[:, :d]
    col_pad = len(widths) * bs - d
    if col_pad:
        features = torch.nn.functional.pad(features, (0, col_pad))
    return features, widths


def _fused_bcd_impl(x, labels, lam: float, nvalid: int, num_iter: int, widths):
    """The block-least-squares fit.

    x: [N, B*bs] with feature block i in columns [i*bs, i*bs + widths[i]);
    pad columns and rows at index >= nvalid must be zero.  Pad columns get a
    unit diagonal shift, so their solutions are exactly zero and every block
    gram stays positive definite even at lam = 0.

    Returns (models [B, bs, k], label_mean [k], means [B, bs]).
    """
    bs = max(widths)
    nb = len(widths)
    dtype, dev = labels.dtype, labels.device
    n = labels.shape[0]

    mask = (torch.arange(n, device=dev) < nvalid).to(dtype)[:, None]
    label_mean = (labels * mask).sum(dim=0) / nvalid
    residual = (labels - label_mean) * mask
    mu = (mask[:, 0] @ x) / nvalid  # [B*bs]
    means = mu.reshape(nb, bs)

    def centered_block(i):
        return (x[:, i * bs : (i + 1) * bs] - means[i]) * mask

    chol = []
    for i, w in enumerate(widths):
        a_i = centered_block(i)
        pad_diag = (torch.arange(bs, device=dev) >= w).to(dtype)
        chol.append(cho_factor(a_i.T @ a_i + torch.diag(lam + pad_diag)))

    models = torch.zeros((nb, bs, labels.shape[1]), dtype=dtype, device=dev)
    for _ in range(num_iter):
        for i in range(nb):
            a_i = centered_block(i)
            r_i = residual + a_i @ models[i]
            m_new = cho_solve(chol[i], a_i.T @ r_i)
            residual = r_i - a_i @ m_new
            models[i] = m_new
    return models, label_mean, means


class BlockLeastSquaresEstimator(LabelEstimator):
    """Block coordinate descent least squares with L2.

    Labels are mean-centered, each feature block is mean-centered with its
    own scaler, BCD runs ``num_iter`` epochs over the blocks, and the
    intercept is the label mean.
    """

    def __init__(self, block_size: int, num_iter: int = 1, lam: float = 0.0):
        self.block_size = block_size
        self.num_iter = num_iter
        self.lam = lam

    def fit(
        self,
        features: torch.Tensor,
        labels: torch.Tensor,
        num_features: int | None = None,
        nvalid: int | None = None,
    ) -> BlockLinearMapper:
        """``nvalid``: true row count when the inputs carry zero pad rows."""
        x, widths = _blocked_design_matrix(features, self.block_size, num_features)
        if knum.active():
            # Per-block κ estimates on the design matrix this fit formed
            # (row-capped probe); one flag check when the observatory is off.
            knum.design_conditioning(x, widths, float(self.lam), label="bcd_fit")
        labels = labels.to(device=x.device, dtype=x.dtype)
        if nvalid is None:
            nvalid = int(labels.shape[0])
        models, label_mean, means = _fused_bcd_impl(
            x, labels, float(self.lam), nvalid, self.num_iter, widths
        )
        return BlockLinearMapper(
            [models[i, :w] for i, w in enumerate(widths)],
            self.block_size,
            label_mean,
            [StandardScalerModel(means[i, :w]) for i, w in enumerate(widths)],
        )
