"""Block linear models (counterpart of keystone_tpu/solvers/block.py).

Only the single-device fused tier is ported: centering, per-block
regularised grams, Cholesky factors (once) and ``num_iter`` epochs of block
coordinate descent, as a Python loop over epochs and blocks.  The fit runs
through the degradation ladder (``core.memory.run_ladder``) with that one
tier, which is also the floor: its preflight charges the reckoned working
set, and ``last_fit_report`` records the decision.  The mesh, autoshard,
host-staged and stepwise/checkpoint tiers of the JAX package are not
ported.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from ..core import memory as kmem
from ..core import numerics as knum
from ..core import profiler as kprof
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


def _block_widths(features, block_size: int, num_features=None) -> tuple[int, ...]:
    """The feature-block widths of the blocked layout, from a monolithic
    [N, d] tensor or a list of feature blocks."""
    if isinstance(features, (list, tuple)):
        return tuple(int(b.shape[1]) for b in features)
    d = num_features or features.shape[1]
    if d > features.shape[1]:
        raise ValueError(
            f"num_features={d} exceeds the actual feature count "
            f"{features.shape[1]} — the blocked-design contract requires "
            "num_features <= features.shape[1]"
        )
    return tuple(min(block_size, d - i) for i in range(0, d, block_size))


def _design_is_copy(features, widths) -> bool:
    """Does :func:`_blocked_design_matrix` allocate a new matrix?  A list
    of blocks is concatenated; a monolithic input whose width is a block
    multiple passes through uncopied."""
    if isinstance(features, (list, tuple)):
        return True
    return len(widths) * max(widths) != sum(widths)


def _blocked_design_matrix(features, block_size: int, num_features=None):
    """(x, widths): the [N, B*bs] zero-padded blocked layout the fit
    consumes, from a monolithic [N, d] tensor or a list of feature blocks.
    A monolithic input whose width is a block multiple passes through
    uncopied."""
    widths = _block_widths(features, block_size, num_features)
    bs = max(widths)
    if isinstance(features, (list, tuple)):
        parts = [
            torch.nn.functional.pad(b, (0, bs - w)) if w < bs else b
            for b, w in zip(features, widths)
        ]
        return torch.cat(parts, dim=1), widths
    d = sum(widths)
    features = features[:, :d]
    col_pad = len(widths) * bs - d
    if col_pad:
        features = torch.nn.functional.pad(features, (0, col_pad))
    return features, widths


def _device_bytes(*tensors) -> int:
    """Bytes of the tensors among ``tensors`` that live on a CUDA card
    (the inputs a live budget already excludes)."""
    return kmem.array_bytes(*(
        t for t in tensors if isinstance(t, torch.Tensor) and t.device.type == "cuda"
    ))


def _features_device(features) -> torch.device:
    first = features[0] if isinstance(features, (list, tuple)) else features
    return first.device


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
        self.last_fit_report: kmem.FitReport | None = None

    def plan_fused(self, features, labels, widths) -> kmem.MemoryPlan:
        """Preflight of the fused fit from the shapes alone.  Charged: the
        caller's feature blocks and their concatenation (the blocked design
        matrix is a new allocation unless it is a view of the input), the
        labels, then the transients (two centered [N, bs] blocks, the
        residual and its update, two [bs, bs] grams, the Cholesky stack),
        and the outputs (models, means, intercept)."""
        bs, nb = max(widths), len(widths)
        rows = labels.shape[0]
        k = labels.shape[1]
        feats = list(features) if isinstance(features, (list, tuple)) else [features]
        it = feats[0].element_size()
        x_bytes = it * rows * nb * bs if _design_is_copy(features, widths) else 0
        return kmem.plan_bytes(
            "bcd_fused",
            argument_bytes=kmem.array_bytes(*feats) + x_bytes + it * rows * k,
            temp_bytes=it * (2 * rows * bs + 2 * rows * k + 2 * bs * bs + nb * bs * bs + rows),
            output_bytes=it * (nb * bs * k + nb * bs + k),
            resident_bytes=_device_bytes(*feats, labels),
            budget=kmem.hbm_budget(_features_device(features)),
        )

    def fit(
        self,
        features: torch.Tensor,
        labels: torch.Tensor,
        num_features: int | None = None,
        nvalid: int | None = None,
    ) -> BlockLinearMapper:
        """``nvalid``: true row count when the inputs carry zero pad rows.
        The fit runs inside the profiler phase ``bcd_fit`` through the
        ladder; its decision trail is ``self.last_fit_report``."""
        widths = _block_widths(features, self.block_size, num_features)
        bs, nb = max(widths), len(widths)
        rows, k = int(labels.shape[0]), int(labels.shape[1])

        def run_fused(plan):
            x, _ = _blocked_design_matrix(features, self.block_size, num_features)
            if knum.active():
                # Per-block κ estimates on the design matrix this fit formed
                # (row-capped probe); one flag check when the observatory is off.
                knum.design_conditioning(x, widths, float(self.lam), label="bcd_fit")
            y = labels.to(device=x.device, dtype=x.dtype)
            models, label_mean, means = _fused_bcd_impl(
                x, y, float(self.lam), rows if nvalid is None else nvalid,
                self.num_iter, widths,
            )
            return BlockLinearMapper(
                [models[i, :w] for i, w in enumerate(widths)],
                self.block_size,
                label_mean,
                [StandardScalerModel(means[i, :w]) for i, w in enumerate(widths)],
            )

        report = kmem.FitReport(label="bcd_fit")
        self.last_fit_report = report
        tier = kmem.Tier(
            "fused", lambda: self.plan_fused(features, labels, widths), run_fused,
            flops=2.0 * rows * bs * bs * nb + self.num_iter * 4.0 * rows * bs * k * nb,
        )
        with kprof.phase("bcd_fit"):
            return kmem.run_ladder("bcd_fit", [tier], report)
