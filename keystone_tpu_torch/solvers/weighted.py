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

With a mesh (``parallel.mesh``: given, or ambient through ``use_mesh``) the
fit runs the mesh ladder of the JAX package: the given ``(data, model)``
mesh, its model-collapsed ``reduced_mesh``, then (when the search runs) the
other factorizations of the same slots, then ``single_device``, the ladder
above on the true rows gathered to slot (0, 0)'s device.  A mesh tier
(:func:`_bwls_mesh_solve`) holds the sorted, zero-tailed rows as one
contiguous run per data slot.  Row-sharded inputs (``ShardedRows``) reach
that layout through the class regroup (:class:`_RegroupPlan`), a
slot-to-slot row exchange (``parallel.collectives.exchange_rows``) that
moves each row once, or a column-chunked gather where the plan's bucket
padding would pass twice the optimum; a tensor is sorted on its device and
split.  The population statistics are the per-block steps' partials added
over the data axis in data order (``collectives.psum``); model slot ``m``
of ``M`` solves every ``M``-th chunk of classes from the ``m``-th,
gathering those classes' rows from the data slots, so each chunk is
batched as on one device (the JAX package splits each chunk over the
model axis instead; here that made each batched solve ``M`` times
narrower and changed its bits).  So a mesh without a data axis (1x1, 1xM)
is the fused tier bit for bit.  Each mesh tier is admitted per slot
(``core.memory.min_chip_budget``); ``last_fit_report.mesh_shape`` says
which mesh ran.  When the search runs, every mesh shape also offers the
JAX package's spec assignments (:func:`_bwls_spec_variants`): the sorted
labels' class columns split in order over the model axis, or the labels
replicated.  Such a candidate places the sorted labels in that layout
(``autoshard.spec_sharding``) and the tier reads each data slot's rows of
every class column from the slots that hold them; the residual and every
product keep the default tier's shapes and the chunk assignment is
unchanged, so it is bit for bit the default layout's model.

With ``core.numerics`` on, the fit records per-block κ estimates of its
design matrix (a row-capped probe) in ``last_fit_report.conditioning``.
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
from ..core.resilience import counters
from ..parallel.collectives import exchange_rows, psum
from ..parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    ShardedRows,
    SpecLayout,
    current_mesh,
    enumerate_meshes,
    mesh_desc,
    on_slot,
    padded_shard_rows,
    reduced_mesh,
    require_local,
    unshard,
)
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

#: Per-row byte budget of one column chunk of the class regroup's gather
#: fallback: each copy moves at most ``[rows, _GATHER_COL_CHUNK bytes]``.
_GATHER_COL_CHUNK = 2048


def _class_sums(x: torch.Tensor, lengths: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Per-class row sums of a class-sorted, zero-tail-padded ``[P, d]``
    block: one ``segment_reduce`` over the class runs, the pad run last and
    dropped.  Each run is summed in stored order with no atomics, so the
    sums are the same bits on every call."""
    return torch.segment_reduce(x, "sum", lengths=lengths, axis=0)[:num_classes]


def _class_mean_of_means(sums, counts_f) -> torch.Tensor:
    """Per-class means from per-class sums ``[C, k]``, averaged over the
    classes with equal class weight: ``[k]``."""
    return (sums / counts_f[:, None]).mean(dim=0)


def _residual_class_means(res, lengths, counts_f, num_classes: int) -> torch.Tensor:
    """Per-class column means of the residual, averaged over the classes
    with equal class weight: ``[C]``."""
    return _class_mean_of_means(_class_sums(res, lengths, num_classes), counts_f)


def _class_chunks(num_classes: int, chunk: int, model: int = 1, slot: int = 0) -> list:
    """The ``(c0, c1)`` class ranges model slot ``slot`` of ``model``
    solves: chunks of ``chunk`` classes, every ``model``-th one from the
    ``slot``-th, so each chunk is batched as on one device."""
    return [(c0, min(c0 + chunk, num_classes))
            for c0 in range(slot * chunk, num_classes, model * chunk)]


def _local_take(xb, res):
    """A class slab's rows and residual entries from one sorted block."""
    return lambda rows, cls: (xb[rows], res[rows, cls[:, None]])


def _class_solves(
    take, starts, counts, pop_cov, pop_mean, pop_xtr, joint_means, residual_mean,
    model_block, lam: float, w: float, n_max: int, chunks,
):
    """The per-class solve sweep over the class ranges ``chunks``: each
    range gathered into a ``[ch, n_max, d]`` slab (``take(rows, cls)``
    gives the slab's rows and each class's own residual column, unmasked),
    built into its mixture-weighted normal equations and solved as one
    batched Cholesky.  Returns ΔWᵀ ``[C, d]``, zero outside ``chunks``."""
    d = pop_cov.shape[0]
    c_total = starts.shape[0]
    dev, dtype = pop_cov.device, pop_cov.dtype
    row_ids = torch.arange(n_max, device=dev)
    dws = torch.zeros((c_total, d), dtype=dtype, device=dev)
    infos = []
    for c0, c1 in chunks:
        cls = torch.arange(c0, c1, device=dev)
        rows = starts[cls][:, None] + row_ids[None, :]  # [ch, n_max], in the zero tail past a class
        mask = (row_ids[None, :] < counts[cls][:, None]).to(dtype)
        xc, r_c = take(rows, cls)
        xc = xc * mask[..., None]  # [ch, n_max, d]
        r_c = r_c * mask  # each class's own residual column
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
    if infos:
        failed = torch.cat(infos).ne(0)
        if bool(failed.any()):
            first = int(torch.nonzero(failed)[0, 0])
            raise FloatingPointError(
                f"the weighted normal equations of class {first} are not positive "
                f"definite (Cholesky info {int(torch.cat(infos)[first])}; lam={lam}, w={w})"
            )
    return dws


def _bwls_stats_partial(xb, lengths, num_classes: int):
    """The row sums of one sorted block's rows: (column sums ``[bs]``,
    gram ``[bs, bs]``, per-class sums ``[C, bs]``)."""
    return xb.sum(dim=0), xb.T @ xb, _class_sums(xb, lengths, num_classes)


def _bwls_stats_finish(col_sums, gram, class_sums, counts_f, n: float, w: float, pad_diag_i):
    """Population and per-class statistics from a block's row sums:
    (population covariance with a unit diagonal on the pad columns,
    population mean, joint means ``[C, bs]``)."""
    pop_mean = col_sums / n
    # Pad columns get a unit diagonal: their solutions are exactly zero.
    pop_cov = gram / n - torch.outer(pop_mean, pop_mean) + torch.diag(pad_diag_i)
    class_means = class_sums / counts_f[:, None]
    return pop_cov, pop_mean, w * class_means + (1.0 - w) * pop_mean


def _bwls_block_stats(xb, lengths, counts_f, n: float, w: float, pad_diag_i,
                      num_classes: int):
    """Population and per-class statistics of one sorted block ``xb``
    ``[P, bs]``."""
    return _bwls_stats_finish(*_bwls_stats_partial(xb, lengths, num_classes), counts_f, n, w,
                              pad_diag_i)


def _bwls_block_xtr(xb, res, n: float):
    return xb.T @ res / n


def _bwls_residual_update(xb, res, dw):
    return res - xb @ dw


def _bwls_block_apply(xb, res, model, dw):
    return model + dw, _bwls_residual_update(xb, res, dw)


def _intercept(joint_label_mean, stats, models):
    """b = jointLabelMean − Σ_d jointMeans[c, d] · W[d, c]."""
    joint_means_all = torch.stack([s[2] for s in stats])
    return joint_label_mean - torch.einsum("bcd,bdc->c", joint_means_all, models)


def _stepwise_bwls_fit(
    get_block: Callable[[int], torch.Tensor], labels_sorted, valid, lengths, starts,
    counts, counts_f, joint_label_mean, n_rows: int, lam: float, w: float,
    num_iter: int, n_max: int, chunk: int, num_classes: int, widths: Sequence[int],
):
    """The solve over ``get_block(i)`` (block ``i`` of the sorted,
    zero-tail-padded design matrix, ``[P, bs]``, wherever it lives), one
    block at a time.  Statistics are computed once and kept across passes;
    the update order is the reference's.  Every single-device tier runs
    this loop.  Returns (models ``[B, bs, C]``, intercept ``[C]``)."""
    bs, nb = max(widths), len(widths)
    dtype, dev = labels_sorted.dtype, labels_sorted.device
    n = float(n_rows)
    chunks = _class_chunks(num_classes, chunk)

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
                _local_take(xb, res), starts, counts, pop_cov, pop_mean,
                _bwls_block_xtr(xb, res, n), joint_means, rmean, models[i], lam, w, n_max,
                chunks,
            ).T
            models[i], res = _bwls_block_apply(xb, res, models[i], dw)
            rmean = _residual_class_means(res, lengths, counts_f, num_classes)
            del xb
    return models, _intercept(joint_label_mean, stats, models)


def _class_order(labels, n: int) -> np.ndarray:
    """The class (argmax) of each of the first ``n`` rows, on the host; of
    row-sharded labels only the ``[n]`` integers leave the slots."""
    if isinstance(labels, ShardedRows):
        parts = [torch.argmax(b, dim=1).cpu() for b in labels.data_blocks()]
        return torch.cat(parts)[:n].numpy()
    return torch.argmax(torch.as_tensor(labels)[:n], dim=1).cpu().numpy()


def _class_counts(class_idx: np.ndarray, num_classes: int) -> np.ndarray:
    counts = np.bincount(class_idx, minlength=num_classes)
    if np.any(counts == 0):
        missing = np.nonzero(counts == 0)[0]
        raise ValueError(f"classes with no examples: {missing.tolist()}")
    return counts


def _run_lengths(runs: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """The lengths of the runs ``runs`` (class runs, then the tail) that
    fall within sorted rows ``[lo, hi)``, zero for a run outside them."""
    ends = np.cumsum(runs)
    return np.clip(np.minimum(ends, hi) - np.maximum(ends - runs, lo), 0, None)


@dataclasses.dataclass
class _SolveCtx:
    """The class sort of one fit on one layout: the stable order of the
    rows by class and the per-class layout of the sorted, zero-tailed rows
    on ``device``.  The tail is at least ``n_max`` rows, so every class
    slab stays in bounds, and rounds ``p_tot`` up to a multiple of the data
    axis; the class chunk rounds up to a multiple of the model axis."""

    order: np.ndarray  #: [n] row order by class (host)
    n: int
    n_max: int
    p_tot: int
    num_classes: int
    chunk: int
    runs: np.ndarray  #: the class runs, then the zero tail (host)
    valid: torch.Tensor  #: [p_tot, 1], 1 on the n real rows
    counts: torch.Tensor
    starts: torch.Tensor
    lengths: torch.Tensor  #: ``runs`` on the device
    joint_label_mean: torch.Tensor
    regroup_plans: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def of(cls, class_idx: np.ndarray, num_classes: int, dtype, w: float, class_chunk: int,
           device, data: int = 1, model: int = 1) -> "_SolveCtx":
        n = int(class_idx.shape[0])
        counts_np = _class_counts(class_idx, num_classes)
        n_max = int(counts_np.max())
        tail = n_max + (-(n + n_max)) % data
        chunk = max(1, min(class_chunk, num_classes))
        runs = np.append(counts_np, tail)
        return cls(
            order=np.argsort(class_idx, kind="stable"),
            n=n, n_max=n_max, p_tot=n + tail, num_classes=num_classes,
            chunk=-(-chunk // model) * model, runs=runs,
            valid=(torch.arange(n + tail, device=device) < n).to(dtype)[:, None],
            counts=torch.from_numpy(counts_np).to(device),
            starts=torch.from_numpy(np.concatenate([[0], np.cumsum(counts_np)[:-1]])).to(device),
            lengths=torch.from_numpy(runs).to(device),
            # jointLabelMean[c] = 2w + 2(1−w)·n_c/n − 1
            joint_label_mean=torch.as_tensor(
                2.0 * w + 2.0 * (1.0 - w) * counts_np / n - 1.0, dtype=dtype, device=device
            ),
        )

    def gather(self, a: torch.Tensor) -> torch.Tensor:
        """``a``'s rows in class order."""
        return a[torch.from_numpy(self.order).to(a.device)]

    def sort_pad(self, a: torch.Tensor) -> torch.Tensor:
        """``a``'s rows in class order, then the zero tail."""
        out = torch.zeros((self.p_tot, a.shape[1]), dtype=a.dtype, device=a.device)
        out[: self.n] = self.gather(a)
        return out

    def solve(self, get_block, labels_sorted, lam: float, w: float, num_iter: int, widths):
        return _stepwise_bwls_fit(
            get_block, labels_sorted, self.valid, self.lengths, self.starts, self.counts,
            self.counts.to(labels_sorted.dtype), self.joint_label_mean, self.n, lam, w,
            num_iter, self.n_max, self.chunk, self.num_classes, widths,
        )

    def regroup(self, blocks: Sequence[torch.Tensor], devices: Sequence) -> list:
        """The sorted, zero-tailed rows as one run of ``p_tot / d`` rows per
        data slot (on ``devices``), from row-sharded ``blocks`` (true rows in
        order, ``len(blocks) == d`` equal blocks, pad rows past ``n``):
        :class:`_RegroupPlan`'s exchange, or its column-chunked gather where
        the plan is unusable."""
        d, n_src = len(blocks), sum(int(b.shape[0]) for b in blocks)
        if n_src not in self.regroup_plans:
            self.regroup_plans[n_src] = _RegroupPlan(self.order, n_src, self.p_tot, d)
        plan = self.regroup_plans[n_src]
        if plan.usable:
            return exchange_rows(blocks, devices, plan.send, plan.recv)
        # A survivable degradation, counted so the regroup path that ran
        # can be read.
        counters.record(
            "bwls_regroup_skew_fallback",
            f"d*m_pad {plan.d * plan.m_pad} > 2*rows_out {2 * plan.rows_out}: bucket "
            "padding beyond 2x optimal — taking the chunked-gather fallback",
        )
        return _chunked_gather(blocks, devices, self.order, plan.rows_in, plan.rows_out)


class _RegroupPlan:
    """The host-side routing of the class regroup: which rows each data
    slot sends to which, so that every row moves once (the reference's
    HashPartitioner shuffle moves each row once between executors).

    Rows are grouped by (source slot, destination slot); each source sends
    its buckets padded to the largest, ``m_pad`` rows, and each destination
    takes its rows from what it received, a zero row for the tail
    (``collectives.exchange_rows``).  The padding costs ``m_pad · d²``
    rows of buffer against the ``n`` moved.  Skew guard: a class-ordered
    input (a near-identity ``order``) puts every row on the diagonal, and
    the buffers approach a whole block per slot; the plan is usable only
    while ``d · m_pad ≤ 2 · rows_out``.  An unusable plan holds no index
    arrays, and the regroup gathers in column chunks instead."""

    def __init__(self, order: np.ndarray, n_src: int, p_tot: int, d: int):
        n = order.shape[0]
        rows_in, rows_out = n_src // d, p_tot // d
        r = np.arange(n)
        src = order // rows_in
        dst = r // rows_out
        # occurrence rank of each row within its (src, dst) bucket, in
        # destination order
        key = src * d + dst
        by_key = np.argsort(key, kind="stable")
        ks = key[by_key]
        change = np.r_[True, ks[1:] != ks[:-1]]
        grp_start = np.maximum.accumulate(np.where(change, np.arange(n), 0))
        j = np.empty(n, np.int64)
        j[by_key] = np.arange(n) - grp_start
        self.d = d
        self.m_pad = int(j.max()) + 1 if n else 1
        self.rows_in, self.rows_out = rows_in, rows_out
        self.usable = d * self.m_pad <= 2 * rows_out
        self.send = self.recv = None
        if self.usable:
            self.send = np.zeros((d, d, self.m_pad), np.int64)
            self.send[src, dst, j] = order % rows_in
            # received layout on dst: [src bucket, j] flattened; d*m_pad is
            # the zero row of the tail
            self.recv = np.full((d, rows_out), d * self.m_pad, np.int64)
            self.recv[dst, r % rows_out] = src * self.m_pad + j


def _chunked_gather(blocks, devices, order: np.ndarray, rows_in: int, rows_out: int) -> list:
    """The regroup as a gather, ``_GATHER_COL_CHUNK`` bytes of columns per
    copy: each destination's true rows fetched from their source slots, the
    tail zero."""
    n, cols = order.shape[0], int(blocks[0].shape[1])
    step = max(1, _GATHER_COL_CHUNK // blocks[0].element_size())
    out = []
    for t, dev in enumerate(devices):
        o = torch.zeros((rows_out, cols), dtype=blocks[0].dtype, device=dev)
        src_rows = order[t * rows_out : min((t + 1) * rows_out, n)]
        for s, block in enumerate(blocks):
            sel = np.nonzero(src_rows // rows_in == s)[0]
            if not len(sel):
                continue
            local = torch.from_numpy(src_rows[sel] % rows_in).to(block.device)
            at = torch.from_numpy(sel).to(o.device)
            for c0 in range(0, cols, step):
                o[at, c0 : c0 + step] = on_slot(block[local, c0 : c0 + step], o.device)
        out.append(o)
    return out


def _mesh_take(x_blocks, res, rows_out: int, device):
    """:func:`_class_solves`' ``take`` over a mesh: the slab's rows and
    residual entries fetched from the data slots that hold them (sorted
    row ``r`` is row ``r % rows_out`` of data slot ``r // rows_out``) onto
    ``device``.  Rows are copied, never added."""

    if len(x_blocks) == 1 and on_slot(x_blocks[0], device) is x_blocks[0]:
        return _local_take(x_blocks[0], res[0])

    def take(rows, cls):
        flat = rows.reshape(-1)
        owner = flat // rows_out
        local = flat - owner * rows_out
        own_cls = cls[:, None].expand_as(rows).reshape(-1)
        xc = torch.empty((flat.numel(), x_blocks[0].shape[1]), dtype=x_blocks[0].dtype,
                         device=device)
        r_c = torch.empty(flat.numel(), dtype=res[0].dtype, device=device)
        for d, (xb, rb) in enumerate(zip(x_blocks, res)):
            sel = torch.nonzero(owner == d)[:, 0]
            if not sel.numel():
                continue
            li = on_slot(local[sel], xb.device)
            xc[sel] = on_slot(xb[li], device)
            r_c[sel] = on_slot(rb[li, on_slot(own_cls[sel], rb.device)], device)
        return xc.reshape(*rows.shape, -1), r_c.reshape(rows.shape)

    return take


def _bwls_spec_variants(m, n_classes: int) -> list[dict]:
    """The per-operand spec assignments the BWLS placement search enumerates
    for one mesh shape beyond the default layout, as the JAX package's: the
    label columns over the model axis (the wide-class layout, when the
    class count divides the axis) and replicated labels.  In a fixed
    order."""
    d_sz, m_sz = m.shape[DATA_AXIS], m.shape[MODEL_AXIS]
    out: list[dict] = []
    if m_sz > 1 and n_classes % m_sz == 0:
        out.append({"labels": "model@dim1"})
    if d_sz * m_sz > 1:
        out.append({"labels": "replicated"})
    return out


def _bwls_mesh_solve(x_blocks, y_blocks, ctx: _SolveCtx, mesh, lam: float, w: float,
                     num_iter: int, widths):
    """The solve over a mesh: ``x_blocks[d]`` ``[p_tot / d, B*bs]`` and
    ``y_blocks[d]`` are data slot ``d``'s run of the sorted, zero-tailed
    design matrix and labels (on slot ``(d, 0)``'s device).  ``y_blocks``
    may instead be the whole sorted labels in a spec layout
    (``parallel.mesh.SpecLayout``): each data slot then reads its run of
    every class column from the slots that hold it.  Every row sum
    (population sums and grams, class sums, ``XᵀR``) is the per-block
    steps' partials added over the data axis in data order; model slot
    ``m`` solves its class chunks (:func:`_class_chunks`) on slot
    ``(0, m)``'s device, and ΔW is assembled on slot (0, 0)'s.  Returns
    (models ``[B, bs, C]``, intercept ``[C]``) there."""
    dev = mesh.devices
    d_sz, m_sz = mesh.shape[DATA_AXIS], mesh.shape[MODEL_AXIS]
    bs, nb = max(widths), len(widths)
    num_classes, head = ctx.num_classes, dev[0, 0]
    rows_out = ctx.p_tot // d_sz
    n = float(ctx.n)
    data_devs = [dev[d, 0] for d in range(d_sz)]
    if isinstance(y_blocks, SpecLayout):
        y_blocks = [y_blocks.window((slice(d * rows_out, (d + 1) * rows_out), slice(None)),
                                    (d, 0)) for d in range(d_sz)]
    dtype = y_blocks[0].dtype
    lengths = [torch.from_numpy(_run_lengths(ctx.runs, d * rows_out, (d + 1) * rows_out))
               .to(data_devs[d]) for d in range(d_sz)]
    counts_f = ctx.counts.to(dtype)
    jlm = ctx.joint_label_mean
    res = [
        (y - on_slot(jlm, data_devs[d]))
        * on_slot(ctx.valid[d * rows_out : (d + 1) * rows_out], data_devs[d])
        for d, y in enumerate(y_blocks)
    ]

    def class_means(res):
        return _class_mean_of_means(
            psum([_class_sums(r, lengths[d], num_classes) for d, r in enumerate(res)]),
            counts_f)

    def block(d, i):
        return x_blocks[d][:, i * bs : (i + 1) * bs]

    rmean = class_means(res)
    stats = []
    for i, width in enumerate(widths):
        parts = [_bwls_stats_partial(block(d, i), lengths[d], num_classes) for d in range(d_sz)]
        pad_diag = (torch.arange(bs, device=head) >= width).to(dtype)
        stats.append(_bwls_stats_finish(*(psum(p) for p in zip(*parts)), counts_f, n, w,
                                        pad_diag))

    model_devs = [dev[0, m] for m in range(m_sz)]
    shared = {m: [on_slot(t, model_devs[m]) for t in (ctx.starts, ctx.counts)]
              for m in range(m_sz)}
    models = torch.zeros((nb, bs, num_classes), dtype=dtype, device=head)
    for _ in range(num_iter):
        for i in range(nb):
            blocks_i = [block(d, i) for d in range(d_sz)]
            pop_xtr = psum([b.T @ r for b, r in zip(blocks_i, res)]) / n
            dws = torch.empty((num_classes, bs), dtype=dtype, device=head)
            for m, mdev in enumerate(model_devs):
                chunks = _class_chunks(num_classes, ctx.chunk, m_sz, m)
                if not chunks:
                    continue
                pop_cov, pop_mean, joint_means = (on_slot(t, mdev) for t in stats[i])
                part = _class_solves(
                    _mesh_take(blocks_i, res, rows_out, mdev), *shared[m], pop_cov, pop_mean,
                    on_slot(pop_xtr, mdev), joint_means, on_slot(rmean, mdev),
                    on_slot(models[i], mdev), lam, w, ctx.n_max, chunks,
                )
                for lo, hi in chunks:
                    dws[lo:hi] = on_slot(part[lo:hi], head)
            dw = dws.T
            models[i] = models[i] + dw
            res = [_bwls_residual_update(blocks_i[d], res[d], on_slot(dw, data_devs[d]))
                   for d in range(d_sz)]
            rmean = class_means(res)
    return models, _intercept(jlm, stats, models)


def _execute_fused_bwls_mesh(plan, x_blocks, y_blocks, ctx, mesh, lam: float, w: float,
                             num_iter: int, widths):
    """Run one mesh tier (:func:`_bwls_mesh_solve`).  Module level so the
    fault harness can intercept it: a test injects an out-of-memory error
    here to drive the mesh ladder's step-down."""
    del plan
    return _bwls_mesh_solve(x_blocks, y_blocks, ctx, mesh, lam, w, num_iter, widths)


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


def _true_rows(t, n: int):
    """The first ``n`` rows of a tensor, or the true rows of a
    ``ShardedRows``, as one tensor."""
    return unshard(t) if isinstance(t, ShardedRows) else t[:n]


class BlockWeightedLeastSquaresEstimator(LabelEstimator):
    """Weighted BCD least squares with L2.

    ``mixture_weight`` w ∈ (0, 1): how much each class's own examples are
    up-weighted relative to the population (per-class effective weights
    ``(1−w)/n + w/n_c`` on the true-class column, ``(1−w)/n`` elsewhere).
    Labels are ±1 indicators ``[N, C]``; every class needs an example.
    ``mesh``: fit over this mesh (else the ambient one of ``use_mesh``, if
    any)."""

    def __init__(
        self, block_size: int, num_iter: int, lam: float, mixture_weight: float,
        class_chunk: int = 16, mesh=None,
    ):
        self.block_size = block_size
        self.num_iter = num_iter
        self.lam = lam
        self.mixture_weight = mixture_weight
        self.class_chunk = class_chunk
        self.mesh = mesh
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
        labels,
        num_features: int | None = None,
        nvalid: int | None = None,
        donate: bool | None = None,
        plan=None,
    ) -> BlockLinearMapper:
        """Fit on ``features`` (a tensor, a list of feature blocks, or their
        row-sharded ``ShardedRows``) and ``labels``.  ``nvalid``: the true
        row count when the inputs carry pad rows (a ``ShardedRows``' own by
        default); pad rows are left out of the class grouping.

        Without a mesh the fit runs the ladder fused -> stepwise ->
        host_staged inside the profiler phase ``bwls_fit``; its decision
        trail is ``self.last_fit_report``.  ``donate=True`` frees the
        caller's ``features`` and ``labels`` once their sorted copies exist
        (a tier below one that ran out of memory then has no source and
        raises ``core.memory.LadderSourceLost``).  ``plan`` selects the
        placement search as in ``BlockLeastSquaresEstimator.fit``: None
        honours ``KEYSTONE_AUTOSHARD``, False walks the hand ladder, True
        forces the search, a ``PlacementPlan`` or a list of tier names
        replays a ranking; the searched table is
        ``last_fit_report.placement``.

        With a mesh (``self.mesh``, or ambient through
        ``parallel.mesh.use_mesh``) the fit runs the mesh ladder (module
        docstring); ``donate`` has no effect there.  Row-sharded inputs
        need a mesh."""
        mesh = self.mesh if self.mesh is not None else current_mesh()
        inputs = [*_feature_list(features), labels]
        sharded = [t for t in inputs if isinstance(t, ShardedRows)]
        if mesh is None and sharded:
            raise TypeError("row-sharded inputs need a mesh: fit(...) under use_mesh or "
                            "BlockWeightedLeastSquaresEstimator(mesh=...)")
        if nvalid is None and sharded:
            nvalid = sharded[0].nvalid
        n = int(labels.shape[0]) if nvalid is None else int(nvalid)
        widths = _block_widths(features, self.block_size, num_features)
        cond_rows = None
        if knum.active():
            # Per-block κ estimates on a row-capped probe matrix.
            cond_rows = knum.design_conditioning(
                _probe_matrix(features, widths), widths, float(self.lam), label="bwls_fit")
        if mesh is not None:
            require_local(mesh, "BlockWeightedLeastSquaresEstimator.fit")
            models, b = self._fit_mesh_ladder(features, labels, num_features, n, widths, mesh,
                                              plan)
        else:
            if nvalid is not None:
                features = ([f[:n] for f in features] if isinstance(features, (list, tuple))
                            else features[:n])
                labels = labels[:n]
            self.last_fit_report = kmem.FitReport(label="bwls_fit")
            models, b = self._fit_single(features, labels, num_features, widths, donate, plan,
                                         self.last_fit_report)
        if cond_rows:
            self.last_fit_report.conditioning = cond_rows
        return BlockLinearMapper([models[i, :wd] for i, wd in enumerate(widths)],
                                 self.block_size, b)

    def _fit_single(self, features, labels, num_features, widths, donate, plan,
                    report: kmem.FitReport):
        """The single-device ladder (searched unless ``plan`` is False),
        recorded in ``report``.  Returns (models ``[B, bs, C]``, intercept)."""
        bs, nb = max(widths), len(widths)
        rows, n_classes = int(labels.shape[0]), int(labels.shape[1])
        feats = _feature_list(features)
        dev, dtype = feats[0].device, feats[0].dtype
        lam, w = float(self.lam), float(self.mixture_weight)
        ctx = _SolveCtx.of(_class_order(labels, rows), n_classes, dtype, w, self.class_chunk,
                           dev)

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
            return autoshard.run_search(
                "bwls_fit", cands, report,
                fingerprint=autoshard.fingerprint(
                    "bwls_fit", rows, n_classes, n_max, widths, self.num_iter,
                    self.class_chunk, _dtype_name(feats[0].dtype), _dtype_name(dtype), None,
                    autoshard.device_fingerprint(),
                ),
                plan=plan,
                budget=kmem.hbm_budget(_features_device(features)),
            )

    def _fit_mesh_ladder(self, features, labels, num_features, n: int, widths, mesh,
                         plan_arg):
        """The mesh ladder (module docstring), with the JAX package's cost
        hints: per-slot admission, a runtime out-of-memory error steps down
        exactly one tier, and the single_device floor gathers the true rows
        to slot (0, 0)'s device and walks the hand ladder there.
        ``report.mesh_shape`` records the mesh that ran; a floor run is
        reported as ``single_device/<tier>``."""
        bs, nb = max(widths), len(widths)
        d_tot = nb * bs
        feats = _feature_list(features)
        listed = isinstance(features, (list, tuple))
        n_classes = int(labels.shape[1])
        xdt = dtype = feats[0].dtype
        it = itx = dtype.itemsize
        lam, w = float(self.lam), float(self.mixture_weight)
        class_idx = _class_order(labels, n)
        n_max = int(_class_counts(class_idx, n_classes).max())
        regrouped = any(isinstance(t, ShardedRows) for t in [*feats, labels])
        report = kmem.FitReport(label="bwls_fit")
        self.last_fit_report = report

        def meta(shape, dt):
            return torch.empty(shape, dtype=dt, device="meta")

        def design(parts):
            return _blocked_design_matrix(parts if listed else parts[0], self.block_size,
                                          num_features)[0]

        def sorted_blocks(ctx, m, sources, make):
            """The sorted, zero-tailed rows of ``make(sources)`` as one run
            per data slot: regrouped from the slots when an input is
            row-sharded, else sorted on the source's device and split."""
            devs = [m.devices[d, 0] for d in range(m.shape[DATA_AXIS])]
            rows_out = ctx.p_tot // len(devs)
            if regrouped:
                shards = [padded_shard_rows(t, m, nvalid=n)[0] for t in sources]
                blocks = [make([t.shards[d][0] for t in shards]) for d in range(len(devs))]
                return ctx.regroup(blocks, devs)
            whole = ctx.sort_pad(make([_true_rows(t, n) for t in sources]))
            return [on_slot(whole[d * rows_out : (d + 1) * rows_out], dev)
                    for d, dev in enumerate(devs)]

        def mesh_tier(m, prior_rank: int, hand: bool, specs=None) -> autoshard.Candidate:
            """One fused-mesh candidate: ``specs`` None is the default layout
            (the hand rung); a spec assignment places the sorted labels in
            that layout, its hints and admission charging its bytes."""
            name = f"fused[mesh {mesh_desc(m)}]"
            if specs:
                name = f"fused[mesh {mesh_desc(m)}|{autoshard.spec_tag(specs)}]"
            d_sz, m_sz = m.shape[DATA_AXIS], m.shape[MODEL_AXIS]
            mdict = dict(m.shape)
            lspec = (specs or {}).get("labels", "data@dim0")
            # The tier's padded layout, reckoned without the class sort.
            p_tot = n + n_max + (-(n + n_max)) % d_sz
            chunk = max(1, min(self.class_chunk, n_classes))
            chunk = -(-chunk // m_sz) * m_sz
            # The residual carries charged in the labels layout (the JAX
            # package's accounting).
            res_b = autoshard.spec_chip_bytes((p_tot, n_classes), dtype, lspec, mdict)
            # Per-slot transient floor: two residual carries, one row block
            # slice, one chunk's class-solve slab, the replicated statistics
            # and models.
            floor = 2 * res_b + it * (
                p_tot * bs // d_sz + chunk * n_max * bs
                + nb * (bs * bs + bs + n_classes * bs) + nb * bs * n_classes
            )
            # The regroup's send and receive buffers: at most 2·p_tot/d rows
            # each under the skew guard.
            exchange = 4 * (p_tot // d_sz) * d_tot * itx if regrouped else 0
            if specs:
                # The bytes of the layout the candidate executes; the
                # valid/segment vectors charged replicated.
                arg_bytes = (autoshard.spec_chip_bytes((p_tot, d_tot), xdt, "data@dim0", mdict)
                             + autoshard.spec_chip_bytes((p_tot, n_classes), dtype, lspec, mdict)
                             + it * p_tot)
            else:
                # The lower bound: each operand's cheapest legal spec.
                arg_bytes = sum(
                    autoshard.best_spec(meta(shape, dt), mdict)["per_chip_bytes"]
                    for shape, dt in (((p_tot, d_tot), xdt), ((p_tot, n_classes), dtype))
                ) + it * p_tot
            hints = {
                "arg_bytes": arg_bytes,
                "temp_bytes": floor,
                "out_bytes": it * (nb * bs * n_classes + n_classes),
                "flops": self.num_iter * nb * (
                    2.0 * p_tot * bs * (bs + 2 * n_classes)
                    + n_classes * n_max * bs * (bs + 2)
                ) / (d_sz * m_sz),
                "dispatches": 1,
                "hbm_passes": self.num_iter + 1,
                "coll_bytes": (it * self.num_iter * nb * (bs * bs + bs * n_classes)
                               if d_sz > 1 else 0),
            }

            def plan():
                budget, _dev = kmem.min_chip_budget(m)
                return kmem.plan_bytes(
                    f"bwls_{name}",
                    argument_bytes=(arg_bytes if specs else
                                    kmem.shard_bytes((p_tot, d_tot), xdt, m)
                                    + kmem.shard_bytes((p_tot, n_classes), dtype, m)
                                    + it * p_tot),
                    temp_bytes=floor + exchange,
                    output_bytes=hints["out_bytes"],
                    budget=budget,
                )

            def run(plan):
                report.mesh_shape = dict(m.shape)
                ctx = _SolveCtx.of(class_idx, n_classes, dtype, w, self.class_chunk,
                                   m.devices[0, 0], data=d_sz, model=m_sz)
                xs = sorted_blocks(ctx, m, feats, design)
                if lspec == "data@dim0":
                    ys = sorted_blocks(ctx, m, [labels],
                                       lambda parts: torch.as_tensor(parts[0]).to(dtype))
                else:
                    whole = on_slot(torch.as_tensor(_true_rows(labels, n)), m.devices[0, 0])
                    ys = autoshard.spec_sharding(lspec, m, 2).place(
                        ctx.sort_pad(whole.to(dtype)))
                return _execute_fused_bwls_mesh(plan, xs, ys, ctx, m, lam, w, self.num_iter,
                                                widths)

            return autoshard.Candidate(name, "fused_mesh", plan, run, hints=hints,
                                       mesh_axes=mdict, prior_rank=prior_rank, hand=hand,
                                       specs=dict(specs) if specs else None)

        def plan_single():
            return kmem.MemoryPlan(
                label="single_device", admitted=True,
                reason=("mesh ladder floor: single-device degradation ladder "
                        "(its own per-tier admission runs inside)"),
            )

        inner_chosen = []

        def run_single(_plan):
            report.mesh_shape = None
            x = [_true_rows(f, n) for f in feats]
            out = self._fit_single(x if listed else x[0], _true_rows(labels, n), num_features,
                                   widths, None, False, report)
            inner_chosen.append(report.chosen)
            return out

        cands = [mesh_tier(mesh, 0, True)]
        rm = reduced_mesh(mesh)
        if rm is not None:
            cands.append(mesh_tier(rm, 1, True))
        if autoshard.will_search(plan_arg):
            # The searched set: the other factorizations of the same slots,
            # then (KEYSTONE_AUTOSHARD_SPECS) the spec assignments of every
            # mesh shape, ranked after the hand rungs on an untrained prior.
            hand_shapes = {mesh_desc(c) for c in (mesh, rm) if c is not None}
            searched = [c for c in (mesh, rm) if c is not None]
            for extra in enumerate_meshes(list(mesh.devices.flat)):
                if mesh_desc(extra) not in hand_shapes:
                    searched.append(extra)
                    cands.append(mesh_tier(extra, len(cands), False))
            if autoshard.specs_enabled():
                for sm in searched:
                    for sp in _bwls_spec_variants(sm, n_classes):
                        cands.append(mesh_tier(sm, len(cands), False, specs=sp))
        p_one = n + n_max
        cands.append(autoshard.Candidate(
            "single_device", "single_device", plan_single, run_single,
            hints={
                "arg_bytes": itx * p_one * d_tot + it * p_one * n_classes,
                "h2d_bytes": itx * p_one * d_tot + it * p_one * n_classes,
                "flops": self.num_iter * nb * (
                    2.0 * p_one * bs * (bs + 2 * n_classes)
                    + n_classes * n_max * bs * (bs + 2)
                ),
                "dispatches": 3,
            },
            prior_rank=len(cands), floor=True,
        ))
        slots = list(mesh.devices.flat)
        with kprof.phase("bwls_fit"):
            out = autoshard.run_search(
                "bwls_fit", cands, report,
                fingerprint=autoshard.fingerprint(
                    "bwls_fit", n, n_classes, n_max, widths, self.num_iter, self.class_chunk,
                    _dtype_name(xdt), _dtype_name(dtype), dict(mesh.shape),
                    autoshard.device_fingerprint(slots),
                ),
                plan=plan_arg,
                budget=kmem.min_chip_budget(mesh)[0],
                devices=slots,
            )
        if inner_chosen and report.chosen == "single_device":
            report.chosen = f"single_device/{inner_chosen[0]}"
        return out
