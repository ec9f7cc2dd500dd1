"""Class-weighted block coordinate descent least squares (counterpart of
keystone_tpu/solvers/weighted.py, single device).

The rows are sorted by class once (a stable sort, as the JAX package's
host argsort) into a zero-tail-padded copy of the design matrix.  Per
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

The fit runs through the degradation ladder (``core.memory.run_ladder``)
of the JAX package, three tiers over one solve loop
(:func:`_stepwise_bwls_fit`) and the same per-block steps:

* ``fused``: the blocked design matrix sorted in one gather on the device;
* ``stepwise``: the sorted matrix built on the device one caller block at
  a time (no unsorted design matrix, no whole-matrix gather); the solve
  slices it as the fused tier does, so the two give the same bits;
* ``host_staged``: the class sort done on the host, one sorted ``[P, bs]``
  block uploaded at a time.  The floor.

Each tier is preflighted; a runtime out-of-memory error steps down one
tier, anything else propagates.  ``donate=True`` frees the caller's
inputs once their sorted copies exist.  The three tiers are the candidates
of the placement search (``core.autoshard.run_search``, on by default),
with the JAX package's cost hints.

Not ported: the mesh tiers and the ``all_to_all`` class regroup (ROADMAP
Queue 1 item 15b) and the conditioning monitor of the solves.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from ..core import autoshard
from ..core import memory as kmem
from ..core import numerics as knum
from ..core import profiler as kprof
from ..core.pipeline import LabelEstimator
from .block import (
    BlockLinearMapper,
    _Uploader,
    _block_widths,
    _blocked_design_matrix,
    _caller_blocks,
    _check_sources,
    _design_is_copy,
    _device_bytes,
    _dtype_name,
    _feature_list,
    _features_device,
    _host_copy,
    _padded,
    _probe_matrix,
    _release,
)


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




def _bwls_block_stats(xb, lengths, counts_f, n: float, w: float, pad_diag_i,
                      num_classes: int):
    """Population and per-class statistics of one sorted block ``xb``
    ``[P, bs]``: (population covariance with a unit diagonal on the pad
    columns, population mean, joint means ``[C, bs]``)."""
    pop_mean = xb.sum(dim=0) / n
    # Pad columns get a unit diagonal: their solutions are exactly zero.
    pop_cov = xb.T @ xb / n - torch.outer(pop_mean, pop_mean) + torch.diag(pad_diag_i)
    class_means = _class_sums(xb, lengths, num_classes) / counts_f[:, None]
    return pop_cov, pop_mean, w * class_means + (1.0 - w) * pop_mean


def _bwls_block_xtr(xb, res, n: float):
    return xb.T @ res / n


def _bwls_block_apply(xb, res, model, dw):
    return model + dw, res - xb @ dw


def _stepwise_bwls_fit(
    get_block: Callable[[int], torch.Tensor], labels_sorted, valid, lengths, starts,
    counts, counts_f, joint_label_mean, n_rows: int, lam: float, w: float,
    num_iter: int, n_max: int, chunk: int, num_classes: int, widths: Sequence[int],
):
    """The solve over ``get_block(i)`` (block ``i`` of the sorted,
    zero-tail-padded design matrix, ``[P, bs]``, wherever it lives), one
    block at a time.  Statistics are computed once and kept across passes;
    the update order is the reference's.  Every tier runs this loop.
    Returns (models ``[B, bs, C]``, intercept ``[C]``)."""
    bs, nb = max(widths), len(widths)
    dtype, dev = labels_sorted.dtype, labels_sorted.device
    n = float(n_rows)

    res = (labels_sorted - joint_label_mean) * valid
    rmean = _residual_class_means(res, lengths, counts_f, num_classes)

    stats = []
    for i, width in enumerate(widths):
        xb = get_block(i)
        pad_diag = (torch.arange(bs, device=dev) >= width).to(dtype)
        stats.append(_bwls_block_stats(xb, lengths, counts_f, n, w, pad_diag, num_classes))
        del xb

    models = torch.zeros((nb, bs, num_classes), dtype=dtype, device=dev)
    for _ in range(num_iter):
        for i in range(nb):
            xb = get_block(i)
            pop_cov, pop_mean, joint_means = stats[i]
            dw = _class_solves(
                xb, res, starts, counts, pop_cov, pop_mean, _bwls_block_xtr(xb, res, n),
                joint_means, rmean, models[i], lam, w, n_max, chunk,
            )
            models[i], res = _bwls_block_apply(xb, res, models[i], dw)
            rmean = _residual_class_means(res, lengths, counts_f, num_classes)
            del xb

    # b = jointLabelMean − Σ_d jointMeans[c, d] · W[d, c]
    joint_means_all = torch.stack([s[2] for s in stats])
    intercept = joint_label_mean - torch.einsum("bcd,bdc->c", joint_means_all, models)
    return models, intercept


@dataclasses.dataclass
class _SolveCtx:
    """The class sort of one fit, shared by every tier: the stable order of
    the rows by class and the per-class layout of the sorted, zero-tailed
    rows (``p_tot = n + n_max``), on the labels' device."""

    order: np.ndarray  #: [n] row order by class (host)
    n: int
    n_max: int
    p_tot: int
    num_classes: int
    chunk: int
    valid: torch.Tensor  #: [p_tot, 1], 1 on the n real rows
    counts: torch.Tensor
    starts: torch.Tensor
    lengths: torch.Tensor  #: the class runs, then the zero tail
    joint_label_mean: torch.Tensor

    @classmethod
    def of(cls, labels: torch.Tensor, dtype, w: float, class_chunk: int) -> "_SolveCtx":
        dev = labels.device
        n, n_classes = int(labels.shape[0]), int(labels.shape[1])
        class_idx = torch.argmax(labels, dim=1).cpu().numpy()
        counts_np = np.bincount(class_idx, minlength=n_classes)
        if np.any(counts_np == 0):
            missing = np.nonzero(counts_np == 0)[0]
            raise ValueError(f"classes with no examples: {missing.tolist()}")
        n_max = int(counts_np.max())
        return cls(
            order=np.argsort(class_idx, kind="stable"),
            n=n, n_max=n_max, p_tot=n + n_max, num_classes=n_classes,
            chunk=max(1, min(class_chunk, n_classes)),
            valid=(torch.arange(n + n_max, device=dev) < n).to(dtype)[:, None],
            counts=torch.from_numpy(counts_np).to(dev),
            starts=torch.from_numpy(np.concatenate([[0], np.cumsum(counts_np)[:-1]])).to(dev),
            lengths=torch.from_numpy(np.append(counts_np, n_max)).to(dev),
            # jointLabelMean[c] = 2w + 2(1−w)·n_c/n − 1
            joint_label_mean=torch.as_tensor(
                2.0 * w + 2.0 * (1.0 - w) * counts_np / n - 1.0, dtype=dtype, device=dev
            ),
        )

    def gather(self, a: torch.Tensor) -> torch.Tensor:
        """``a``'s rows in class order."""
        return a[torch.from_numpy(self.order).to(a.device)]

    def sort_pad(self, a: torch.Tensor) -> torch.Tensor:
        """``a``'s rows in class order, then a zero tail of ``n_max`` rows,
        so every class slab stays in bounds."""
        out = torch.zeros((self.p_tot, a.shape[1]), dtype=a.dtype, device=a.device)
        out[: self.n] = self.gather(a)
        return out

    def solve(self, get_block, labels_sorted, lam: float, w: float, num_iter: int, widths):
        return _stepwise_bwls_fit(
            get_block, labels_sorted, self.valid, self.lengths, self.starts, self.counts,
            self.counts.to(labels_sorted.dtype), self.joint_label_mean, self.n, lam, w,
            num_iter, self.n_max, self.chunk, self.num_classes, widths,
        )


def _fused_bwls_impl(x, labels_sorted, ctx: _SolveCtx, lam: float, w: float, num_iter: int,
                     widths, on_sorted: Callable[[], None] | None = None):
    """The fused tier: the blocked design matrix ``x`` sorted in one gather
    (a new ``[P, B*bs]`` matrix; ``x`` is dropped, and ``on_sorted`` runs,
    once it exists), then the solve over its column blocks."""
    bs = max(widths)
    xs = ctx.sort_pad(x)
    del x
    if on_sorted is not None:
        on_sorted()
    return ctx.solve(lambda i: xs[:, i * bs : (i + 1) * bs], labels_sorted, lam, w, num_iter,
                     widths)


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
        self.last_fit_report: kmem.FitReport | None = None

    def _shapes(self, features, labels, widths) -> dict:
        """The byte terms every tier's preflight shares."""
        bs, nb = max(widths), len(widths)
        rows, n_classes = int(labels.shape[0]), int(labels.shape[1])
        feats = _feature_list(features)
        it = feats[0].element_size()
        n_max = rows  # the largest class, at most every row
        chunk = max(1, min(self.class_chunk, n_classes))
        return dict(
            bs=bs, nb=nb, rows=rows, c=n_classes, it=it, feats=feats, p_tot=rows + n_max,
            # the sorted labels and the residual's two carries, the per-block
            # statistics, one chunk of per-class slabs and systems
            solve_temps=it * (
                3 * (rows + n_max) * n_classes + nb * (bs * bs + 2 * n_classes * bs + bs)
                + 2 * chunk * bs * bs + 2 * chunk * n_max * bs
            ),
            outputs=it * (nb * bs * n_classes + n_classes),
            resident=_device_bytes(*feats, labels),
            budget=kmem.hbm_budget(_features_device(features)),
        )

    def plan_fused(self, features, labels, widths) -> kmem.MemoryPlan:
        """Preflight of the fused tier from the shapes alone.  Charged: the
        caller's feature blocks and their concatenation, the labels, the
        class-sorted zero-tailed copy of the design matrix and the gather
        that fills it, the per-block statistics, one chunk of per-class
        slabs and systems, the residual, and the outputs."""
        s = self._shapes(features, labels, widths)
        it, rows, d_all = s["it"], s["rows"], s["nb"] * s["bs"]
        x_bytes = it * rows * d_all if _design_is_copy(features, widths) else 0
        return kmem.plan_bytes(
            "bwls_fused",
            argument_bytes=kmem.array_bytes(*s["feats"]) + x_bytes + it * rows * s["c"],
            temp_bytes=it * (s["p_tot"] * d_all + rows * d_all) + s["solve_temps"],
            output_bytes=s["outputs"],
            resident_bytes=s["resident"],
            budget=s["budget"],
        )

    def plan_stepwise(self, features, labels, widths) -> kmem.MemoryPlan:
        """Preflight of the stepwise tier.  Charged: the caller's feature
        blocks (never concatenated) and the labels, the sorted zero-tailed
        matrix and one block's gather, then the solve's transients and the
        outputs as in the fused tier."""
        s = self._shapes(features, labels, widths)
        it, rows, bs = s["it"], s["rows"], s["bs"]
        return kmem.plan_bytes(
            "bwls_stepwise",
            argument_bytes=kmem.array_bytes(*s["feats"]) + it * rows * s["c"],
            temp_bytes=it * (s["p_tot"] * s["nb"] * bs + rows * bs) + s["solve_temps"],
            output_bytes=s["outputs"],
            resident_bytes=s["resident"],
            budget=s["budget"],
        )

    def plan_host_staged(self, features, labels, widths) -> kmem.MemoryPlan:
        """Preflight of the host-staged tier.  Charged: one sorted [P, bs]
        block on the device, the solve's transients and the outputs, and
        the caller's inputs that stay on the device."""
        s = self._shapes(features, labels, widths)
        return kmem.plan_bytes(
            "bwls_host_staged",
            argument_bytes=s["it"] * s["p_tot"] * s["bs"],
            temp_bytes=s["solve_temps"],
            output_bytes=s["outputs"],
            extra_bytes=s["resident"],
            resident_bytes=s["resident"],
            budget=s["budget"],
        )

    def fit(
        self,
        features,
        labels: torch.Tensor,
        num_features: int | None = None,
        donate: bool | None = None,
        plan=None,
    ) -> BlockLinearMapper:
        """The fit runs the ladder fused -> stepwise -> host_staged inside
        the profiler phase ``bwls_fit``; its decision trail is
        ``self.last_fit_report``.  ``donate=True`` frees the caller's
        ``features`` and ``labels`` once their sorted copies exist (a tier
        below one that ran out of memory then has no source and raises
        ``core.memory.LadderSourceLost``).  ``plan`` selects the placement
        search as in ``BlockLeastSquaresEstimator.fit``: None honours
        ``KEYSTONE_AUTOSHARD``, False walks the hand ladder, True forces the
        search, a ``PlacementPlan`` or a list of tier names replays a
        ranking; the searched table is ``last_fit_report.placement``."""
        widths = _block_widths(features, self.block_size, num_features)
        bs, nb = max(widths), len(widths)
        rows, n_classes = int(labels.shape[0]), int(labels.shape[1])
        feats = _feature_list(features)
        dev, dtype = feats[0].device, feats[0].dtype
        lam, w = float(self.lam), float(self.mixture_weight)
        if knum.active():
            # Per-block κ estimates on a row-capped probe matrix.
            knum.design_conditioning(_probe_matrix(features, widths), widths, lam,
                                     label="bwls_fit")
        ctx = _SolveCtx.of(torch.as_tensor(labels).to(device=dev, dtype=dtype), dtype, w,
                           self.class_chunk)

        def sorted_labels():
            _check_sources(labels)
            return ctx.sort_pad(torch.as_tensor(labels).to(device=dev, dtype=dtype))

        def donated():
            if donate:
                _release(*feats, labels)

        def run_fused(plan):
            _check_sources(*feats)
            ls = sorted_labels()
            # Only the callee holds the design matrix, so it goes once sorted.
            return _fused_bwls_impl(
                _blocked_design_matrix(features, self.block_size, num_features)[0], ls, ctx,
                lam, w, self.num_iter, widths, on_sorted=donated,
            )

        def run_stepwise(plan):
            _check_sources(*feats)
            xs = torch.zeros((ctx.p_tot, nb * bs), dtype=dtype, device=dev)
            for i, b in enumerate(_caller_blocks(features, widths)):
                xs[: ctx.n, i * bs : i * bs + widths[i]] = ctx.gather(b)
            ls = sorted_labels()
            donated()
            return ctx.solve(lambda i: xs[:, i * bs : (i + 1) * bs], ls, lam, w,
                             self.num_iter, widths)

        def run_host(plan):
            _check_sources(*feats)
            host = [ctx.sort_pad(_padded(_host_copy(b), bs))
                    for b in _caller_blocks(features, widths)]
            ls = sorted_labels()
            donated()
            return ctx.solve(_Uploader(host, dev), ls, lam, w, self.num_iter, widths)

        report = kmem.FitReport(label="bwls_fit")
        self.last_fit_report = report
        # The flops this solve counts (held by the profiled ladder's audit).
        counted_flops = nb * (2.0 * rows * bs * bs) + self.num_iter * nb * (
            2.0 * rows * bs * bs + 4.0 * rows * bs * n_classes)
        # The JAX package's cost hints, term for term (its ``_fit_ladder``).
        it = dtype.itemsize
        itx = feats[0].element_size()
        n_max, p_tot, chunk = ctx.n_max, ctx.p_tot, ctx.chunk
        d_tot = nb * bs
        stats_bytes = it * nb * (bs * bs + bs + n_classes * bs)
        models_bytes = it * nb * bs * n_classes
        labels_bytes = it * p_tot * n_classes
        src_bytes = _device_bytes(*feats, labels)
        fused_floor = it * (
            2 * p_tot * n_classes + p_tot * bs + chunk * n_max * bs
        ) + stats_bytes + models_bytes
        slab_floor = it * chunk * n_max * bs
        sorted_x_bytes = itx * p_tot * d_tot
        sorted_y_bytes = it * p_tot * n_classes
        flops = self.num_iter * nb * (
            2.0 * p_tot * bs * (bs + 2 * n_classes) + n_classes * n_max * bs * (bs + 2)
        )
        per_block_dispatches = nb * (3 * self.num_iter + 1) + 2
        cands = [
            autoshard.Candidate(
                "fused", "fused", lambda: self.plan_fused(features, labels, widths), run_fused,
                hints={
                    "arg_bytes": sorted_x_bytes + sorted_y_bytes + it * p_tot,
                    # The sorted copies are the fit's own; the JAX program
                    # donates them, and the prune credits them the same way.
                    "alias_bytes": sorted_x_bytes + sorted_y_bytes,
                    "temp_bytes": fused_floor,
                    "out_bytes": it * (nb * bs * n_classes + n_classes),
                    "extra_bytes": src_bytes,
                    "resident_bytes": src_bytes,
                    "flops": flops,
                    "dispatches": 1,
                    "hbm_passes": self.num_iter + 1,
                },
                prior_rank=0, audit_flops=counted_flops,
            ),
            autoshard.Candidate(
                "stepwise", "stepwise", lambda: self.plan_stepwise(features, labels, widths),
                run_stepwise,
                hints={
                    "arg_bytes": itx * p_tot * bs + sorted_y_bytes,
                    "temp_bytes": slab_floor,
                    "out_bytes": it * bs * n_classes,
                    "extra_bytes": (
                        sorted_x_bytes + labels_bytes + stats_bytes + models_bytes + src_bytes
                    ),
                    "resident_bytes": src_bytes,
                    "flops": flops,
                    "dispatches": per_block_dispatches,
                    "hbm_passes": self.num_iter + 1,
                },
                prior_rank=1, audit_flops=counted_flops,
            ),
            autoshard.Candidate(
                "host_staged", "host_staged",
                lambda: self.plan_host_staged(features, labels, widths), run_host,
                hints={
                    "arg_bytes": itx * p_tot * bs + sorted_y_bytes,
                    "temp_bytes": slab_floor,
                    "out_bytes": it * bs * n_classes,
                    "extra_bytes": labels_bytes + stats_bytes + models_bytes + src_bytes,
                    "resident_bytes": src_bytes,
                    "flops": flops,
                    "dispatches": per_block_dispatches,
                    # Every pass re-streams each sorted block to the card.
                    "h2d_bytes": (self.num_iter + 1) * sorted_x_bytes,
                },
                prior_rank=2, floor=True, audit_flops=counted_flops,
            ),
        ]
        with kprof.phase("bwls_fit"):
            models, b = autoshard.run_search(
                "bwls_fit", cands, report,
                fingerprint=autoshard.fingerprint(
                    "bwls_fit", rows, n_classes, n_max, widths, self.num_iter,
                    self.class_chunk, _dtype_name(feats[0].dtype), _dtype_name(dtype), None,
                    autoshard.device_fingerprint(),
                ),
                plan=plan,
                budget=kmem.hbm_budget(_features_device(features)),
            )
        return BlockLinearMapper([models[i, :wd] for i, wd in enumerate(widths)],
                                 self.block_size, b)
