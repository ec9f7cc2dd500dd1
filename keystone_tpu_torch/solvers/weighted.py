"""Class-weighted block coordinate descent least squares (counterpart of
keystone_tpu/solvers/weighted.py, single device).

The rows are sorted by class once (a stable sort, as the JAX package's
host argsort) into one zero-tail-padded copy of the design matrix.  Per
block, the population statistics are computed once and kept across
passes; each pass then runs, per block, the population ``XᵀR``, the
per-class solves in chunks of ``class_chunk`` classes (each chunk one
batched factorisation of its mixture-weighted normal equations), and the
model and residual updates.  The intercept comes from the joint means.

The per-class systems ``joint_xtx + λI`` are symmetric positive definite
for λ > 0, so they are solved by Cholesky (``torch.linalg.cholesky_ex``,
then ``cholesky_solve``) where the JAX package uses LU: half the flops.  A
failed factorisation raises ``FloatingPointError`` instead of returning
NaNs.

Not ported: the mesh tiers and the ``all_to_all`` class regroup, the
placement search, memory admission and the degradation ladder, the
conditioning monitor and input donation.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from ..core.pipeline import LabelEstimator
from .block import BlockLinearMapper, _blocked_design_matrix


def _class_sums(x: torch.Tensor, lengths: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Per-class row sums of a class-sorted, zero-tail-padded ``[P, d]``
    block: one ``segment_reduce`` over the class runs, the pad run last and
    dropped.  Each run is summed in stored order with no atomics, so the
    sums are the same bits on every call."""
    return torch.segment_reduce(x, "sum", lengths=lengths, axis=0)[:num_classes]


def _residual_class_means(res, lengths, counts_f, num_classes: int) -> torch.Tensor:
    """Per-class column means of the residual, averaged over the classes
    with equal class weight: ``[C]``."""
    return (_class_sums(res, lengths, num_classes) / counts_f[:, None]).mean(dim=0)


def _class_solves(
    xb, res, starts, counts, pop_cov, pop_mean, pop_xtr, joint_means,
    residual_mean, model_block, lam: float, w: float, n_max: int, chunk: int,
):
    """The per-class solve sweep: ``chunk`` classes at a time, each chunk
    gathered into a ``[chunk, n_max, d]`` slab, built into its
    mixture-weighted normal equations and solved as one batched Cholesky.
    Returns ΔW ``[d, C]``."""
    d = xb.shape[1]
    c_total = starts.shape[0]
    dev, dtype = xb.device, xb.dtype
    row_ids = torch.arange(n_max, device=dev)
    dws = torch.empty((c_total, d), dtype=dtype, device=dev)
    infos = []
    for c0 in range(0, c_total, chunk):
        cls = torch.arange(c0, min(c0 + chunk, c_total), device=dev)
        rows = starts[cls][:, None] + row_ids[None, :]  # [ch, n_max], in the zero tail past a class
        mask = (row_ids[None, :] < counts[cls][:, None]).to(dtype)
        xc = xb[rows] * mask[..., None]  # [ch, n_max, d]
        r_c = res[rows, cls[:, None]] * mask  # each class's own residual column
        n_c = counts[cls].to(dtype)

        class_mean = xc.sum(dim=1) / n_c[:, None]
        zm = (xc - class_mean[:, None, :]) * mask[..., None]
        class_cov = torch.bmm(zm.transpose(1, 2), zm) / n_c[:, None, None]
        class_xtr = torch.bmm(xc.transpose(1, 2), r_c[..., None])[..., 0] / n_c[:, None]
        del xc, zm

        mean_diff = class_mean - pop_mean
        joint_xtx = class_cov.mul_(w).add_(pop_cov * (1.0 - w))
        joint_xtx.addcmul_(mean_diff[:, :, None], mean_diff[:, None, :], value=(1.0 - w) * w)
        joint_xtx.diagonal(dim1=1, dim2=2).add_(lam)
        mean_mixture_wt = residual_mean[cls] * (1.0 - w) + w * (r_c.sum(dim=1) / n_c)
        joint_xtr = (
            pop_xtr.T[cls] * (1.0 - w) + class_xtr * w
            - joint_means[cls] * mean_mixture_wt[:, None]
        )
        factor, info = torch.linalg.cholesky_ex(joint_xtx)
        del joint_xtx
        infos.append(info)
        rhs = (joint_xtr - model_block.T[cls] * lam)[..., None]
        dws[cls] = torch.cholesky_solve(rhs, factor)[..., 0]
    failed = torch.cat(infos).ne(0)
    if bool(failed.any()):
        first = int(torch.nonzero(failed)[0, 0])
        raise FloatingPointError(
            f"the weighted normal equations of class {first} are not positive "
            f"definite (Cholesky info {int(torch.cat(infos)[first])}; lam={lam}, w={w})"
        )
    return dws.T


def _bwls_fit(
    get_block: Callable[[int], torch.Tensor], labels_sorted, valid, lengths, starts,
    counts, counts_f, joint_label_mean, n_rows: int, lam: float, w: float,
    num_iter: int, n_max: int, chunk: int, num_classes: int, widths: Sequence[int],
):
    """The whole solve over ``get_block(i)`` (block ``i`` of the sorted,
    zero-tail-padded design matrix, ``[P, bs]``).  Statistics are computed
    once and kept across passes; the update order is the reference's.
    Returns (models ``[B, bs, C]``, intercept ``[C]``)."""
    bs, nb = max(widths), len(widths)
    dtype, dev = labels_sorted.dtype, labels_sorted.device
    n = float(n_rows)

    res = (labels_sorted - joint_label_mean) * valid
    rmean = _residual_class_means(res, lengths, counts_f, num_classes)

    stats = []
    for i, width in enumerate(widths):
        xb = get_block(i)
        pop_mean = xb.sum(dim=0) / n
        # Pad columns get a unit diagonal: their solutions are exactly zero.
        pad_diag = (torch.arange(bs, device=dev) >= width).to(dtype)
        pop_cov = xb.T @ xb / n - torch.outer(pop_mean, pop_mean) + torch.diag(pad_diag)
        class_means = _class_sums(xb, lengths, num_classes) / counts_f[:, None]
        stats.append((pop_cov, pop_mean, w * class_means + (1.0 - w) * pop_mean))

    models = torch.zeros((nb, bs, num_classes), dtype=dtype, device=dev)
    for _ in range(num_iter):
        for i in range(nb):
            xb = get_block(i)
            pop_cov, pop_mean, joint_means = stats[i]
            pop_xtr = xb.T @ res / n
            dw = _class_solves(
                xb, res, starts, counts, pop_cov, pop_mean, pop_xtr, joint_means,
                rmean, models[i], lam, w, n_max, chunk,
            )
            models[i] += dw
            res = res - xb @ dw
            rmean = _residual_class_means(res, lengths, counts_f, num_classes)

    # b = jointLabelMean − Σ_d jointMeans[c, d] · W[d, c]
    joint_means_all = torch.stack([s[2] for s in stats])
    intercept = joint_label_mean - torch.einsum("bcd,bdc->c", joint_means_all, models)
    return models, intercept


class BlockWeightedLeastSquaresEstimator(LabelEstimator):
    """Weighted BCD least squares with L2.

    ``mixture_weight`` w ∈ (0, 1): how much each class's own examples are
    up-weighted relative to the population (per-class effective weights
    ``(1−w)/n + w/n_c`` on the true-class column, ``(1−w)/n`` elsewhere).
    Labels are ±1 indicators ``[N, C]``; every class needs an example."""

    def __init__(
        self, block_size: int, num_iter: int, lam: float, mixture_weight: float,
        class_chunk: int = 16,
    ):
        self.block_size = block_size
        self.num_iter = num_iter
        self.lam = lam
        self.mixture_weight = mixture_weight
        self.class_chunk = class_chunk

    def fit(
        self,
        features: torch.Tensor,
        labels: torch.Tensor,
        num_features: int | None = None,
    ) -> BlockLinearMapper:
        x, widths = _blocked_design_matrix(features, self.block_size, num_features)
        dev, dtype = x.device, x.dtype
        labels = torch.as_tensor(labels).to(device=dev, dtype=dtype)
        n = int(labels.shape[0])
        n_classes = int(labels.shape[1])

        class_idx = torch.argmax(labels, dim=1).cpu().numpy()
        counts_np = np.bincount(class_idx, minlength=n_classes)
        if np.any(counts_np == 0):
            missing = np.nonzero(counts_np == 0)[0]
            raise ValueError(f"classes with no examples: {missing.tolist()}")
        # The class shuffle: a stable sort of the rows by class, then a zero
        # tail of n_max rows so every class slab stays in bounds.
        order = torch.from_numpy(np.argsort(class_idx, kind="stable")).to(dev)
        n_max = int(counts_np.max())
        p_tot = n + n_max

        def sort_pad(a: torch.Tensor) -> torch.Tensor:
            out = torch.zeros((p_tot, a.shape[1]), dtype=a.dtype, device=dev)
            out[:n] = a[order]
            return out

        xs = sort_pad(x)
        del x
        labels_sorted = sort_pad(labels)
        valid = (torch.arange(p_tot, device=dev) < n).to(dtype)[:, None]
        counts = torch.from_numpy(counts_np).to(dev)
        starts = torch.from_numpy(np.concatenate([[0], np.cumsum(counts_np)[:-1]])).to(dev)
        lengths = torch.from_numpy(np.append(counts_np, n_max)).to(dev)
        w = float(self.mixture_weight)
        # jointLabelMean[c] = 2w + 2(1−w)·n_c/n − 1
        joint_label_mean = torch.as_tensor(
            2.0 * w + 2.0 * (1.0 - w) * counts_np / n - 1.0, dtype=dtype, device=dev
        )
        bs = max(widths)

        def get_block(i: int) -> torch.Tensor:
            return xs[:, i * bs : (i + 1) * bs]

        models, b = _bwls_fit(
            get_block, labels_sorted, valid, lengths, starts, counts, counts.to(dtype),
            joint_label_mean, n, float(self.lam), w, self.num_iter, n_max,
            max(1, min(self.class_chunk, n_classes)), n_classes, widths,
        )
        return BlockLinearMapper(
            [models[i, :wd] for i, wd in enumerate(widths)], self.block_size, b
        )
