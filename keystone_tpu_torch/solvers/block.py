"""Block linear models (counterpart of keystone_tpu/solvers/block.py).

The block-least-squares fit (centering, per-block regularised grams and
their Cholesky factors, ``num_iter`` epochs of block coordinate descent)
runs through the single-device degradation ladder of the JAX package,
``core.memory.run_ladder`` over three tiers:

* ``fused``: one blocked design matrix on the device (the caller's blocks
  concatenated, or a monolithic input padded to whole blocks); every
  block's mean and factor first, then the epochs;
* ``stepwise``: the caller's own blocks on their device, never
  concatenated; each factor made when its block first comes up.  This is
  also the resumable tier: ``fit(checkpoint=, resume_from=)`` runs it alone,
  with a state after every completed block in the JAX package's ``.npz``
  format (:func:`save_bcd_checkpoint`), so either package resumes the
  other's interrupted fit;
* ``host_staged``: the blocks copied to host RAM, one ``[N, bs]`` block on
  the device at a time (uploaded through two reused pinned buffers), the
  means and factors cached on the device.  The floor.

Every tier calls the same per-block functions (:func:`_bcd_block_mean`,
:func:`_bcd_block_factor`, :func:`_bcd_block_solve`; they take the block
itself, so they are also the JAX package's host-staged ``_hs_block_*``
twins), and the centred block
each of them works on is a fresh contiguous tensor whatever the layout of
the block it came from, so on one device the fused and stepwise tiers give
the same bits, and the host-staged tier does too where its blocks are the
same values.  Each tier is preflighted (``last_fit_report`` records the
plans); a runtime out-of-memory error steps down one tier, anything else
propagates.

The three tiers are the candidates of the placement search
(``core.autoshard.run_search``, on by default), with the JAX package's
cost hints: with an empty plan log it ranks them in the hand order above,
bit for bit; ``last_fit_report.placement`` records the searched table.

With a mesh (``parallel.mesh``: given, or ambient through ``use_mesh``) the
fit runs the mesh ladder: the given ``(data, model)`` mesh, its
model-collapsed ``reduced_mesh``, then (when the search runs) the other
factorizations of the same slots, then ``single_device``, which runs the
ladder above on the rows gathered to slot (0, 0)'s device.  A mesh tier
(:func:`_fused_bcd_mesh_impl`) shards the rows of the blocked design
matrix and the labels over the data axis and splits the class columns over
the model axis; it calls the same per-block steps on each slot's rows,
with every reduction over rows (means, grams, right-hand sides) added in
data order (``parallel.collectives.psum``).  So a 1x1 mesh is the fused
tier bit for bit, and a data-axis mesh differs from it only in the order
of the partial sums.  Each mesh tier is admitted per slot
(``core.memory.min_chip_budget``: a slot gets its card's budget divided by
the mesh's slots on that card); ``last_fit_report.mesh_shape`` says which
mesh ran.  When the search runs, every mesh shape also offers the JAX
package's spec assignments (:func:`_bcd_spec_variants`: the label columns
over the model axis, replicated models, replicated labels and models),
each executed as that layout (``autoshard.spec_sharding``) with the
default tier's products, so bit for bit the default layout's model.
"""

from __future__ import annotations

import io
import logging
import os
from typing import Callable, Sequence

import numpy as np
import torch

from ..core import autoshard
from ..core import memory as kmem
from ..core import numerics as knum
from ..core import profiler as kprof
from ..core import trace
from ..core.checkpoint import CheckpointError, _atomic_write_bytes
from ..core.pipeline import Identity, LabelEstimator, Transformer
from ..ops.stats import StandardScalerModel
from ..parallel.collectives import psum
from ..parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    ShardedRows,
    current_mesh,
    device_key,
    enumerate_meshes,
    mesh_desc,
    on_slot,
    padded_shard_rows,
    reduced_mesh,
    require_local,
    unshard,
)
from ..utils.stats import matmul_rows
from .normal_equations import _pad_cols, cho_factor, cho_solve

_logger = logging.getLogger("keystone_tpu_torch.solvers.block")


class BlockLinearMapper(Transformer):
    """Linear model stored as feature blocks.

    xs: list of [d_i, k] weight blocks; b: optional [k] intercept;
    feature_scalers: per-block transformers applied before the product.
    Each block's product is ``utils.stats.matmul_rows``: a served row's
    scores do not depend on how many rows share its batch, so the sharded
    apply (``ShardedRows.apply(mapper)``) gives every row the bits of the
    unsharded one.
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
            part = matmul_rows(scaler(blk), x)
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
        full model.  Row-sharded blocks are gathered in data order (their
        true rows) first."""
        blocks = (
            [unshard(b) for b in batch_or_blocks]
            if isinstance(batch_or_blocks, (list, tuple))
            else self._split_features(batch_or_blocks)
        )
        if len(blocks) != len(self.xs):
            raise ValueError(
                f"{len(blocks)} feature blocks vs {len(self.xs)} model blocks"
            )
        running = None
        for blk, x, scaler in zip(blocks, self.xs, self.feature_scalers):
            part = matmul_rows(scaler(blk), x)
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
    """(x, widths): the [N, B*bs] zero-padded blocked layout the fused
    tier consumes, from a monolithic [N, d] tensor or a list of feature
    blocks.  A monolithic input whose width is a block multiple passes
    through uncopied."""
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


def _caller_blocks(features, widths) -> list[torch.Tensor]:
    """The caller's feature blocks, uncopied: the list itself, or the
    column slices of a monolithic matrix (block ``i`` is columns
    ``[i*bs, i*bs + widths[i])``)."""
    if isinstance(features, (list, tuple)):
        return list(features)
    bs = max(widths)
    return [features[:, i * bs : i * bs + w] for i, w in enumerate(widths)]


def _padded(block: torch.Tensor, bs: int) -> torch.Tensor:
    """``block`` zero-padded on the right to ``bs`` columns (itself when
    it is that wide already)."""
    w = int(block.shape[1])
    return block if w == bs else torch.nn.functional.pad(block, (0, bs - w))


def _device_bytes(*tensors) -> int:
    """Bytes of the tensors among ``tensors`` that live on a CUDA card
    (the inputs a live budget already excludes)."""
    return kmem.array_bytes(*(
        t for t in tensors if isinstance(t, torch.Tensor) and t.device.type == "cuda"
    ))


def _features_device(features) -> torch.device:
    first = features[0] if isinstance(features, (list, tuple)) else features
    return first.device


def _feature_list(features) -> list:
    return list(features) if isinstance(features, (list, tuple)) else [features]


def _check_sources(*tensors) -> None:
    """Raise :class:`core.memory.LadderSourceLost` when a caller tensor a
    tier reads has had its storage freed (a ``donate=True`` fit, or the
    caller): no tier can rebuild its inputs from it."""
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.numel() and t.untyped_storage().nbytes() == 0:
            raise kmem.LadderSourceLost(
                f"a {tuple(t.shape)} input on {t.device} has been freed (donate=True "
                "or by the caller) — no ladder tier can rebuild it; refit with "
                "donate=False to keep the out-of-memory step-down possible"
            )


def _release(*tensors) -> None:
    """Free the storage of caller tensors handed over with ``donate=True``
    (card tensors through ``core.memory.free_buffers``; a CPU storage that
    cannot be resized, such as one numpy owns, is left alone)."""
    cuda = [t for t in tensors if isinstance(t, torch.Tensor) and t.device.type == "cuda"]
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.device.type == "cpu":
            try:
                t.untyped_storage().resize_(0)
            except RuntimeError:
                pass
    kmem.free_buffers(*cuda)


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """``t`` in host RAM: the tensor itself when it is there already."""
    return t if t.device.type == "cpu" else t.cpu()


class _Uploader:
    """Block ``i`` of a matrix held in host RAM, on ``device``.  To a card,
    each block is copied into one of two reused pinned buffers and from
    there with a copy on the current stream; a buffer is refilled only once
    the copy that last read it has completed, so the host copy of the next
    block overlaps the upload and use of this one.  On the CPU the host
    block itself is returned."""

    def __init__(self, host_blocks: Sequence[torch.Tensor], device: torch.device):
        self.blocks = host_blocks
        self.device = device
        self._bufs: list = []
        self._done: list = [None, None]
        self._calls = 0

    def __call__(self, i: int) -> torch.Tensor:
        block = self.blocks[i]
        if self.device.type != "cuda":
            return block
        if not self._bufs:
            self._bufs = [torch.empty(block.shape, dtype=block.dtype, pin_memory=True)
                          for _ in range(2)]
        slot = self._calls % 2
        self._calls += 1
        if self._done[slot] is not None:
            self._done[slot].synchronize()
        buf = self._bufs[slot]
        buf.copy_(block)
        out = buf.to(self.device, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        self._done[slot] = done
        return out


# -- the per-block steps: one copy of the arithmetic for every tier -----------


def _bcd_mean_partial(xi: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-column sums of block ``xi`` ``[N, bs]`` over its valid rows.
    The product runs on a contiguous copy, so its bits do not depend on
    whether the block is a slice of a wider matrix or a tensor of its own."""
    return mask[:, 0] @ xi.contiguous()


def _bcd_block_mean(xi: torch.Tensor, mask: torch.Tensor, nvalid: int) -> torch.Tensor:
    """Per-column means of block ``xi`` ``[N, bs]`` over the valid rows."""
    return _bcd_mean_partial(xi, mask) / nvalid


def _centred(xi, mu_i, mask) -> torch.Tensor:
    """The centred, row-masked block: one new ``[N, bs]`` tensor (the mask
    is applied in place, so the block is never held twice over)."""
    return (xi - mu_i).mul_(mask)


def _bcd_gram_partial(xi, mu_i, mask) -> torch.Tensor:
    """The centred gram of block ``xi``'s rows."""
    a_i = _centred(xi, mu_i, mask)
    return a_i.T @ a_i


def _bcd_gram_factor(gram, lam: float, pad_diag_i) -> torch.Tensor:
    """Cholesky factor of a block's regularised centred gram: made once per
    block and reused across epochs.  Pad columns get a unit diagonal shift,
    so their solutions are exactly zero and the gram stays positive
    definite even at lam = 0."""
    return cho_factor(gram + torch.diag(lam + pad_diag_i))


def _bcd_block_factor(xi, mu_i, mask, lam: float, pad_diag_i) -> torch.Tensor:
    """Cholesky factor of block ``xi``'s regularised centred gram."""
    return _bcd_gram_factor(_bcd_gram_partial(xi, mu_i, mask), lam, pad_diag_i)


def _bcd_block_rhs(xi, mu_i, mask, residual, m_old):
    """The row-local half of a block update: ``(a_i, r_i, a_iᵀ r_i)``, the
    centred block, the residual with the block's old model added back, and
    the right-hand side over these rows."""
    a_i = _centred(xi, mu_i, mask)
    r_i = residual + a_i @ m_old
    return a_i, r_i, a_i.T @ r_i


def _bcd_block_solve(xi, mu_i, mask, residual, m_old, c_i):
    """One BCD block update given the cached factor: ``(m_new,
    residual')``."""
    a_i, r_i, atb = _bcd_block_rhs(xi, mu_i, mask, residual, m_old)
    m_new = cho_solve(c_i, atb)
    return m_new, r_i - a_i @ m_new


def _centred_labels(labels: torch.Tensor, nvalid: int):
    """(row mask ``[N, 1]``, label mean ``[k]``, centred masked labels)."""
    n = labels.shape[0]
    mask = (torch.arange(n, device=labels.device) < nvalid).to(labels.dtype)[:, None]
    label_mean = (labels * mask).sum(dim=0) / nvalid
    return mask, label_mean, (labels - label_mean) * mask


def _pad_diagonals(widths, dtype, device) -> torch.Tensor:
    """``[B, bs]``: 1 on each block's pad columns, 0 on its real ones."""
    bs = max(widths)
    cols = torch.arange(bs, device=device)[None, :]
    return (cols >= torch.tensor(widths, device=device)[:, None]).to(dtype)


def _fused_bcd_impl(x, labels, lam: float, nvalid: int, num_iter: int, widths):
    """The fused tier: BCD over the one blocked design matrix ``x``
    ``[N, B*bs]`` (feature block i in columns ``[i*bs, i*bs + widths[i])``;
    pad columns and rows at index >= nvalid zero).  Every block's mean and
    factor first, then the epochs.

    Returns (models [B, bs, k], label_mean [k], means [B, bs])."""
    bs, nb = max(widths), len(widths)
    mask, label_mean, residual = _centred_labels(labels, nvalid)
    pad = _pad_diagonals(widths, labels.dtype, labels.device)

    def block(i):
        return x[:, i * bs : (i + 1) * bs]

    means = torch.stack([_bcd_block_mean(block(i), mask, nvalid) for i in range(nb)])
    chol = [_bcd_block_factor(block(i), means[i], mask, lam, pad[i]) for i in range(nb)]
    models = torch.zeros((nb, bs, labels.shape[1]), dtype=labels.dtype, device=labels.device)
    for _ in range(num_iter):
        for i in range(nb):
            models[i], residual = _bcd_block_solve(
                block(i), means[i], mask, residual, models[i], chol[i]
            )
    return models, label_mean, means


def _fused_bcd_mesh_impl(x: ShardedRows, labels, lam: float, nvalid: int, num_iter: int,
                         widths, models_spec: str = "model@dim2"):
    """The fused tier over a mesh: ``x`` the row-sharded blocked design
    matrix (as :func:`_fused_bcd_impl`'s), ``labels`` the ``[rows, k_pad]``
    labels with the class columns padded to a multiple of the model axis,
    row-sharded on the same layout (the default) or in a spec layout
    (``parallel.mesh.SpecLayout``: class columns over the model axis, or
    replicated).  Slot ``(d, m)`` works on data block ``d``'s rows and model
    column share ``m``, read from wherever its labels layout holds them;
    the means, the block grams and every update's right-hand side are the
    per-block steps' partials added over the data axis in data order, and
    each factor is made once and replicated.  ``models_spec``
    ``"model@dim2"`` keeps each model slot's column share of the models;
    ``"replicated"`` gives every device the whole models, each update's
    shares copied to it as they are solved.  A layout changes where tensors
    live, never a product's shape, so every layout gives the same bits.
    The result is on slot (0, 0)'s device.

    Returns (models [B, bs, k_pad], label_mean [k_pad], means [B, bs])."""
    if models_spec not in ("model@dim2", "replicated"):
        raise ValueError(f"unsupported models spec {models_spec!r}")
    mesh = x.mesh
    dev = mesh.devices
    d_sz, m_sz = mesh.shape[DATA_AXIS], mesh.shape[MODEL_AXIS]
    bs, nb = max(widths), len(widths)
    km = labels.shape[1] // m_sz
    dtype, head = labels.dtype, dev[0, 0]
    slots = [(d, m) for d in range(d_sz) for m in range(m_sz)]
    first = np.cumsum([0] + [int(b.shape[0]) for b in x.data_blocks()])
    mask, y = {}, {}
    for d, m in slots:
        rows = torch.arange(int(first[d]), int(first[d + 1]), device=dev[d, m])
        mask[d, m] = (rows < nvalid).to(dtype)[:, None]
        cols = slice(m * km, (m + 1) * km)
        share = (labels.shards[d][m][:, cols] if isinstance(labels, ShardedRows)
                 else labels.window((slice(int(first[d]), int(first[d + 1])), cols), (d, m)))
        y[d, m] = share.contiguous()
    label_mean = [
        psum([(y[d, m] * mask[d, m]).sum(dim=0) for d in range(d_sz)]) / nvalid
        for m in range(m_sz)
    ]
    residual = {(d, m): (y[d, m] - on_slot(label_mean[m], dev[d, m])) * mask[d, m]
                for d, m in slots}
    pad = _pad_diagonals(widths, dtype, head)

    def block(d, m, i):
        return x.shards[d][m][:, i * bs : (i + 1) * bs]

    means = torch.stack([
        psum([_bcd_mean_partial(block(d, 0, i), mask[d, 0]) for d in range(d_sz)]) / nvalid
        for i in range(nb)
    ])
    chol = [
        _bcd_gram_factor(psum([
            _bcd_gram_partial(block(d, 0, i), on_slot(means[i], dev[d, 0]), mask[d, 0])
            for d in range(d_sz)
        ]), lam, pad[i])
        for i in range(nb)
    ]
    # The replicated means and factors, copied once to each device.
    devices = {device_key(d): d for d in mesh.devices.flat}
    means_on = {k: on_slot(means, d) for k, d in devices.items()}
    chol_on = {k: [on_slot(c, d) for c in chol] for k, d in devices.items()}

    if models_spec == "replicated":
        whole = {k: torch.zeros((nb, bs, m_sz * km), dtype=dtype, device=d)
                 for k, d in devices.items()}

        def model_share(d, m, i):
            return whole[device_key(dev[d, m])][i][:, m * km : (m + 1) * km].contiguous()
    else:
        models = [torch.zeros((nb, bs, km), dtype=dtype, device=dev[0, m]) for m in range(m_sz)]

        def model_share(d, m, i):
            return on_slot(models[m][i], dev[d, m])

    for _ in range(num_iter):
        for i in range(nb):
            parts = {
                (d, m): _bcd_block_rhs(
                    block(d, m, i), means_on[device_key(dev[d, m])][i], mask[d, m],
                    residual[d, m], model_share(d, m, i),
                )
                for d, m in slots
            }
            for m in range(m_sz):
                atb = psum([parts[d, m][2] for d in range(d_sz)])
                m_new = cho_solve(chol_on[device_key(dev[0, m])][i], atb)
                if models_spec == "replicated":
                    for k, d in devices.items():
                        whole[k][i][:, m * km : (m + 1) * km] = on_slot(m_new, d)
                else:
                    models[m][i] = m_new
                for d in range(d_sz):
                    a_i, r_i, _ = parts[d, m]
                    residual[d, m] = r_i - a_i @ on_slot(m_new, dev[d, m])
    label_mean = (label_mean[0] if m_sz == 1
                  else torch.cat([on_slot(t, head) for t in label_mean]))
    if models_spec == "replicated":
        return whole[device_key(head)], label_mean, means
    if m_sz == 1:
        return models[0], label_mean, means
    return torch.cat([on_slot(t, head) for t in models], dim=2), label_mean, means


def _execute_fused_bcd_mesh(plan, x, labels, lam: float, nvalid: int, num_iter: int, widths,
                            specs=None):
    """Run one mesh tier (:func:`_fused_bcd_mesh_impl`) in the layout
    ``specs`` names (a candidate's spec assignment; None is the default).
    Module level so the fault harness can intercept it: a test injects an
    out-of-memory error here to drive the mesh ladder's step-down."""
    del plan
    return _fused_bcd_mesh_impl(x, labels, lam, nvalid, num_iter, widths,
                                (specs or {}).get("models", "model@dim2"))


def _bcd_spec_variants(m) -> list[dict]:
    """The per-operand spec assignments the BCD placement search enumerates
    for one mesh shape beyond the default layout (row-sharded inputs, model
    columns over the model axis), as the JAX package's: the label columns
    over the model axis (the wide-class layout), replicated models, and
    replicated labels and models.  Legal by construction (the class columns
    are padded to a model-axis multiple first) and in a fixed order."""
    d_sz, m_sz = m.shape[DATA_AXIS], m.shape[MODEL_AXIS]
    out: list[dict] = []
    if m_sz > 1:
        out.append({"labels": "model@dim1"})
        out.append({"models": "replicated"})
    if d_sz * m_sz > 1:
        out.append({"labels": "replicated", "models": "replicated"})
    return out


# -- the resumable BCD state (the JAX package's on-disk format) ---------------

BCD_STATE_VERSION = 1


def bcd_checkpoint_path(path) -> str:
    """Canonical on-disk location of a BCD state for a stem or path (the
    one place the ``.npz`` suffix rule lives)."""
    path = os.fspath(path)
    return path if path.endswith(".npz") else path + ".npz"


def _host_array(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def save_bcd_checkpoint(path, state: dict) -> str:
    """Write a resumable BCD state: one ``.npz``, written atomically, with
    the keys and dtypes the JAX package writes."""
    buf = io.BytesIO()
    np.savez(
        buf,
        version=np.int64(state.get("version", BCD_STATE_VERSION)),
        epoch=np.int64(state["epoch"]),
        block=np.int64(state["block"]),
        models=_host_array(state["models"]),
        residual=_host_array(state["residual"]),
        widths=np.asarray(state["widths"], np.int64),
        num_iter=np.int64(state["num_iter"]),
        lam=np.float64(state["lam"]),
        nvalid=np.int64(state["nvalid"]),
        data_sum=np.asarray(state["data_sum"], np.float64),
    )
    path = bcd_checkpoint_path(path)
    _atomic_write_bytes(path, buf.getvalue())
    return path


def load_bcd_checkpoint(path) -> dict:
    """Read a state written by :func:`save_bcd_checkpoint` (or by the JAX
    package's)."""
    path = bcd_checkpoint_path(path)
    try:
        with np.load(path) as zf:
            state = {k: zf[k] for k in zf.files}
    except (OSError, ValueError) as e:
        raise CheckpointError(f"cannot read BCD checkpoint {path}: {e}") from e
    version = int(state.get("version", -1))
    if version != BCD_STATE_VERSION:
        raise CheckpointError(
            f"{path}: BCD state version {version} (this build reads {BCD_STATE_VERSION})"
        )
    return {
        "version": version,
        "epoch": int(state["epoch"]),
        "block": int(state["block"]),
        "models": state["models"],
        "residual": state["residual"],
        "widths": tuple(int(w) for w in state["widths"]),
        "num_iter": int(state["num_iter"]),
        "lam": float(state["lam"]),
        "nvalid": int(state["nvalid"]),
        "data_sum": tuple(float(v) for v in state["data_sum"]),
    }


def bcd_checkpoint_writer(path) -> Callable[[dict], None]:
    """Per-block callback that persists each completed block's state to
    ``path`` (atomically: a preemption mid-write loses at most one block)."""

    def write(state: dict) -> None:
        save_bcd_checkpoint(path, state)

    return write


def _state_tensor(v, dtype, device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=dtype)
    return torch.from_numpy(np.asarray(v)).to(device=device, dtype=dtype)


def _resume_point(state: dict, widths, num_iter, nvalid, lam, data_sum, models_shape,
                  residual_shape, dtype, device):
    """Check ``state`` against this fit and return (models, residual,
    epoch, block) to continue from; :class:`CheckpointError` when the state
    belongs to another fit."""
    for field, want in (
        ("widths", tuple(widths)),
        ("num_iter", int(num_iter)),
        ("nvalid", int(nvalid)),
        ("lam", float(lam)),
    ):
        got = state.get(field)
        if got != want:
            raise CheckpointError(
                f"resume_from state disagrees with this fit: {field} is {got!r} in "
                f"the checkpoint, {want!r} here"
            )
    got_sum = state.get("data_sum")
    if got_sum is not None and not np.allclose(got_sum, data_sum, rtol=1e-5, atol=1e-6):
        raise CheckpointError(
            "resume_from state was written for DIFFERENT data (input fingerprint "
            f"{tuple(got_sum)} vs {data_sum}) — refusing to resume a fit against "
            "features it was not computing on"
        )
    models = _state_tensor(state["models"], dtype, device)
    residual = _state_tensor(state["residual"], dtype, device)
    if tuple(models.shape) != tuple(models_shape) or tuple(residual.shape) != tuple(
        residual_shape
    ):
        raise CheckpointError(
            "resume_from state shapes do not match this fit "
            f"(models {tuple(models.shape)}, residual {tuple(residual.shape)})"
        )
    epoch, block = int(state["epoch"]), int(state["block"]) + 1  # block last COMPLETED
    if block >= len(widths):
        epoch, block = epoch + 1, 0
    _logger.info(
        "resuming BCD fit at epoch %d block %d (of %d epochs x %d blocks)",
        epoch, block, num_iter, len(widths),
    )
    return models, residual, epoch, block


def _stepwise_bcd_fit(
    blocks: Sequence[torch.Tensor],
    labels,
    lam: float,
    nvalid: int,
    num_iter: int,
    widths,
    checkpoint_cb: Callable[[dict], None] | None = None,
    resume_state: dict | None = None,
):
    """The stepwise tier: BCD over the caller's own blocks (``blocks[i]``
    ``[N, widths[i]]``, padded to ``bs`` one at a time when short), never
    concatenated.  ``checkpoint_cb`` gets the state after every completed
    block; ``resume_state`` (a state from such a callback or from
    :func:`load_bcd_checkpoint`) restarts at the block after the last
    completed one, once it has been checked against this fit: ``widths``,
    ``num_iter``, ``nvalid`` and ``lam`` must agree, the inputs' sums
    (``data_sum``) within rtol 1e-5, atol 1e-6, and the shapes of
    ``models`` and ``residual``.  Factors are cached across epochs.

    Returns (models [B, bs, k], label_mean [k], means [B, bs])."""
    bs, nb = max(widths), len(widths)
    dtype, dev = labels.dtype, labels.device
    mask, label_mean, residual = _centred_labels(labels, nvalid)
    pad = _pad_diagonals(widths, dtype, dev)

    def block(i):
        return _padded(blocks[i], bs)

    means = torch.stack([_bcd_block_mean(block(i), mask, nvalid) for i in range(nb)])
    # Cheap content fingerprint of the inputs: shapes alone cannot tell
    # "same fit, resumed" from "different data of the same shape".
    data_sum = (
        float(sum(b.sum(dtype=torch.float64) for b in blocks)),
        float(labels.sum(dtype=torch.float64)),
    )
    models = torch.zeros((nb, bs, labels.shape[1]), dtype=dtype, device=dev)
    e0, b0 = 0, 0
    if resume_state is not None:
        models, residual, e0, b0 = _resume_point(
            resume_state, widths, num_iter, nvalid, lam, data_sum, models.shape,
            residual.shape, dtype, dev,
        )
    chol: dict[int, torch.Tensor] = {}
    for e in range(e0, num_iter):
        for i in range(b0 if e == e0 else 0, nb):
            xi = block(i)
            if i not in chol:
                chol[i] = _bcd_block_factor(xi, means[i], mask, lam, pad[i])
            models[i], residual = _bcd_block_solve(xi, means[i], mask, residual, models[i],
                                                   chol[i])
            del xi
            if checkpoint_cb is not None:
                # models is a snapshot: later blocks update it in place.
                checkpoint_cb({
                    "version": BCD_STATE_VERSION,
                    "epoch": e,
                    "block": i,
                    "models": models.clone(),
                    "residual": residual,
                    "widths": tuple(widths),
                    "num_iter": int(num_iter),
                    "lam": float(lam),
                    "nvalid": int(nvalid),
                    "data_sum": data_sum,
                })
    return models, label_mean, means


def _host_blocks(features, widths, release: bool) -> list[torch.Tensor]:
    """The design matrix in host RAM, one ``[N, bs]`` CPU tensor per block
    (short blocks zero-padded on the host).  A list of card blocks is
    copied block by block, never concatenated on the card; with
    ``release`` each card block is freed once it is on the host."""
    bs = max(widths)
    if isinstance(features, (list, tuple)):
        out = []
        for b in features:
            out.append(_padded(_host_copy(b), bs))
            if release and b.device.type != "cpu":
                _release(b)
        return out
    host = _host_copy(features)
    if release and features.device.type != "cpu":
        _release(features)
    return [_padded(b, bs) for b in _caller_blocks(host, widths)]


def _host_staged_bcd_fit(host_blocks: Sequence[torch.Tensor], labels, lam: float,
                         nvalid: int, num_iter: int, widths):
    """The host-staged tier, the floor: ``host_blocks[i]`` (``[N, bs]`` in
    host RAM) is uploaded once per epoch and freed before the next, so one
    block of the matrix is on the device at a time beside the residual and
    the cached means and factors.  The arithmetic stays on ``labels``'
    device.

    Returns (models [B, bs, k], label_mean [k], means [B, bs])."""
    bs, nb = max(widths), len(widths)
    dtype, dev = labels.dtype, labels.device
    mask, label_mean, residual = _centred_labels(labels, nvalid)
    pad = _pad_diagonals(widths, dtype, dev)
    upload = _Uploader(host_blocks, dev)
    means: dict[int, torch.Tensor] = {}
    chol: dict[int, torch.Tensor] = {}
    models = torch.zeros((nb, bs, labels.shape[1]), dtype=dtype, device=dev)
    for _ in range(num_iter):
        for i in range(nb):
            xi = upload(i)
            if i not in means:
                means[i] = _bcd_block_mean(xi, mask, nvalid)
                chol[i] = _bcd_block_factor(xi, means[i], mask, lam, pad[i])
            models[i], residual = _bcd_block_solve(xi, means[i], mask, residual, models[i],
                                                   chol[i])
            del xi  # the one block on the device, freed before the next upload
    return models, label_mean, torch.stack([means[i] for i in range(nb)])


def _dtype_name(dtype: torch.dtype) -> str:
    """``'float32'`` for ``torch.float32``: the numpy name the JAX package's
    plan fingerprints fold in."""
    return str(dtype).removeprefix("torch.")


def _probe_matrix(features, widths):
    """A row-capped blocked design matrix for the conditioning probe: the
    monolithic input itself (the probe caps the rows), or the first rows of
    each block concatenated, so no tier's full matrix is formed for it.
    Row-sharded input is probed on its first data block."""
    if isinstance(features, ShardedRows):
        features = features.data_blocks()[0]
    elif isinstance(features, (list, tuple)) and isinstance(features[0], ShardedRows):
        features = [f.data_blocks()[0] for f in features]
    if not isinstance(features, (list, tuple)):
        return features
    cap = knum.COND_ROWS_CAP
    return torch.cat([_padded(b[:cap], max(widths)) for b in features], dim=1)


class BlockLeastSquaresEstimator(LabelEstimator):
    """Block coordinate descent least squares with L2.

    Labels are mean-centered, each feature block is mean-centered with its
    own scaler, BCD runs ``num_iter`` epochs over the blocks, and the
    intercept is the label mean.
    """

    def __init__(self, block_size: int, num_iter: int = 1, lam: float = 0.0, mesh=None):
        self.block_size = block_size
        self.num_iter = num_iter
        self.lam = lam
        self.mesh = mesh
        self.last_fit_report: kmem.FitReport | None = None

    def _shapes(self, features, labels, widths) -> dict:
        """The byte terms every tier's preflight shares."""
        bs, nb = max(widths), len(widths)
        n, k = int(labels.shape[0]), int(labels.shape[1])
        feats = _feature_list(features)
        it = feats[0].element_size()
        return dict(
            bs=bs, nb=nb, n=n, k=k, it=it, feats=feats,
            # labels, the models stack and the cached Cholesky factors
            persist=it * (n * k + nb * bs * k + nb * bs * bs),
            resident=_device_bytes(*feats, labels),
            budget=kmem.hbm_budget(_features_device(features)),
        )

    def plan_fused(self, features, labels, widths) -> kmem.MemoryPlan:
        """Preflight of the fused tier from the shapes alone.  Charged: the
        caller's feature blocks and their concatenation (the blocked design
        matrix is a new allocation unless it is a view of the input), the
        labels, then the transients (two centered [N, bs] blocks, the
        residual and its update, two [bs, bs] grams, the Cholesky stack),
        and the outputs (models, means, intercept)."""
        s = self._shapes(features, labels, widths)
        bs, nb, n, k, it = s["bs"], s["nb"], s["n"], s["k"], s["it"]
        x_bytes = it * n * nb * bs if _design_is_copy(features, widths) else 0
        return kmem.plan_bytes(
            "bcd_fused",
            argument_bytes=kmem.array_bytes(*s["feats"]) + x_bytes + it * n * k,
            temp_bytes=it * (2 * n * bs + 2 * n * k + 2 * bs * bs + nb * bs * bs + n),
            output_bytes=it * (nb * bs * k + nb * bs + k),
            resident_bytes=s["resident"],
            budget=s["budget"],
        )

    def plan_stepwise(self, features, labels, widths) -> kmem.MemoryPlan:
        """Preflight of the stepwise tier.  Charged: the caller's blocks
        (never concatenated) and one padded copy of a short block, the
        per-block step's other arguments (the means, the row mask, the
        residual, one model block, one factor), its transients (the centred
        block and the updated residual) and outputs, and what persists
        across steps: the labels, the models stack and the cached factors."""
        s = self._shapes(features, labels, widths)
        bs, nb, n, k, it = s["bs"], s["nb"], s["n"], s["k"], s["it"]
        pad_copy = it * n * bs if min(widths) < bs else 0
        return kmem.plan_bytes(
            "bcd_stepwise",
            argument_bytes=kmem.array_bytes(*s["feats"]) + pad_copy
            + it * (nb * bs + n + n * k + bs * k + bs * bs),
            temp_bytes=it * (n * bs + n * k),
            output_bytes=it * (bs * k + n * k),
            extra_bytes=s["persist"],
            resident_bytes=s["resident"],
            budget=s["budget"],
        )

    def plan_host_staged(self, features, labels, widths) -> kmem.MemoryPlan:
        """Preflight of the host-staged tier.  Charged: one [N, bs] block and
        the per-block step's other arguments, transients and outputs, what
        persists (the labels, the models stack, the cached factors and
        means), and the caller's inputs that stay on the device."""
        s = self._shapes(features, labels, widths)
        bs, nb, n, k, it = s["bs"], s["nb"], s["n"], s["k"], s["it"]
        return kmem.plan_bytes(
            "bcd_host_staged",
            argument_bytes=it * (n * bs + bs + n + n * k + bs * k + bs * bs),
            temp_bytes=it * (n * bs + n * k),
            output_bytes=it * (bs * k + n * k),
            extra_bytes=s["persist"] + it * nb * bs + s["resident"],
            resident_bytes=s["resident"],
            budget=s["budget"],
        )

    def fit(
        self,
        features,
        labels: torch.Tensor,
        num_features: int | None = None,
        nvalid: int | None = None,
        checkpoint=None,
        resume_from=None,
        donate: bool | None = None,
        plan=None,
    ) -> BlockLinearMapper:
        """``nvalid``: true row count when the inputs carry zero pad rows.

        ``checkpoint`` is a path (the state written atomically after every
        completed block, :func:`bcd_checkpoint_writer`) or a callback that
        gets the state dict; ``resume_from`` is a path or a state dict of an
        interrupted fit, which restarts at the block after the last
        completed one.  Either runs the stepwise tier alone, in the trace
        span ``tier:stepwise[checkpoint]``.

        Otherwise the fit runs the ladder fused -> stepwise -> host_staged
        inside the profiler phase ``bcd_fit``; the decision trail is
        ``self.last_fit_report``.  ``donate=True`` hands the caller's card
        feature blocks to the fit: the host-staged tier frees each one once
        it is on the host (PyTorch has no aliasing to donate into, so it
        has no other effect).

        Placement search (``core.autoshard``, on by default): the fit runs
        the cost-model RANKED tier list, pruned by the analytic preflight,
        with the hand order as the untrained tie-break and host_staged
        pinned last; a runtime out-of-memory error steps down the ranked
        list (counted ``autoshard_stepdown``).  ``plan``: None honours
        ``KEYSTONE_AUTOSHARD``, False walks the hand ladder, True forces the
        search, a ``PlacementPlan`` or a list of tier names replays a
        ranking; anything else raises ``TypeError``.  The searched table is
        ``last_fit_report.placement``.

        With a mesh (``self.mesh``, or ambient through
        ``parallel.mesh.use_mesh``) the inputs (tensors or row-sharded
        ``ShardedRows``, with ``nvalid`` their true row count) run the mesh
        ladder (module docstring); checkpointing needs the stepwise tier,
        which runs on one device, so it raises ``ValueError`` there.
        Row-sharded inputs need a mesh."""
        mesh = self.mesh if self.mesh is not None else current_mesh()
        resumable = checkpoint is not None or resume_from is not None
        if mesh is not None and resumable:
            raise ValueError(
                "checkpoint/resume_from use the stepwise BCD path, which does not run "
                "under a mesh — fit without a mesh or without checkpointing"
            )
        if mesh is None and any(isinstance(f, ShardedRows)
                                for f in [*_feature_list(features), labels]):
            raise TypeError("row-sharded inputs need a mesh: fit(...) under use_mesh or "
                            "BlockLeastSquaresEstimator(mesh=...)")
        widths = _block_widths(features, self.block_size, num_features)
        nv = int(labels.shape[0]) if nvalid is None else int(nvalid)
        lam = float(self.lam)
        if knum.active():
            # Per-block κ estimates on a row-capped probe matrix; one flag
            # check when the observatory is off.
            knum.design_conditioning(_probe_matrix(features, widths), widths, lam,
                                     label="bcd_fit")

        if mesh is not None:
            require_local(mesh, "BlockLeastSquaresEstimator.fit")
            return self._mapper(
                self._fit_mesh_ladder(features, labels, num_features, nvalid, widths, mesh,
                                      plan),
                widths,
            )

        def y_on(dev, dtype):
            _check_sources(labels)
            return labels.to(device=dev, dtype=dtype)

        def caller_blocks():
            feats = _feature_list(features)
            _check_sources(*feats)
            return _caller_blocks(features, widths)

        if resumable:
            self.last_fit_report = kmem.FitReport(label="bcd_fit", chosen="stepwise[checkpoint]")
            cb = checkpoint if callable(checkpoint) or checkpoint is None else (
                bcd_checkpoint_writer(checkpoint)
            )
            state = resume_from if isinstance(resume_from, dict) or resume_from is None else (
                load_bcd_checkpoint(resume_from)
            )
            # The resumable path bypasses run_ladder (its tier is forced), so
            # it opens its own tier span.
            with kprof.phase("bcd_fit"), trace.span(
                "tier:stepwise[checkpoint]", cat="solve", solve="bcd_fit",
                resuming=state is not None,
            ):
                blocks = caller_blocks()
                out = _stepwise_bcd_fit(
                    blocks, y_on(blocks[0].device, blocks[0].dtype), lam, nv,
                    self.num_iter, widths, checkpoint_cb=cb, resume_state=state,
                )
            return self._mapper(out, widths)

        report = kmem.FitReport(label="bcd_fit")
        self.last_fit_report = report
        out = self._fit_single(features, labels, num_features, nv, widths, donate, plan, report)
        return self._mapper(out, widths)

    def _fit_single(self, features, labels, num_features, nv: int, widths, donate, plan,
                    report: kmem.FitReport):
        """The single-device ladder (searched unless ``plan`` is False),
        recorded in ``report``."""
        bs, nb = max(widths), len(widths)
        rows, k = int(labels.shape[0]), int(labels.shape[1])
        lam = float(self.lam)

        def y_on(dev, dtype):
            _check_sources(labels)
            return labels.to(device=dev, dtype=dtype)

        def caller_blocks():
            feats = _feature_list(features)
            _check_sources(*feats)
            return _caller_blocks(features, widths)

        def run_fused(plan):
            _check_sources(*_feature_list(features))
            x, _ = _blocked_design_matrix(features, self.block_size, num_features)
            return _fused_bcd_impl(x, y_on(x.device, x.dtype), lam, nv, self.num_iter, widths)

        def run_stepwise(plan):
            blocks = caller_blocks()
            return _stepwise_bcd_fit(blocks, y_on(blocks[0].device, blocks[0].dtype), lam, nv,
                                     self.num_iter, widths)

        def run_host(plan):
            feats = _feature_list(features)
            _check_sources(*feats)
            host = _host_blocks(features, widths, release=bool(donate))
            return _host_staged_bcd_fit(host, y_on(feats[0].device, feats[0].dtype), lam, nv,
                                        self.num_iter, widths)

        # The JAX package's cost hints, term for term (its
        # ``_fit_ladder``), but for ``alias_bytes``: PyTorch donates nothing
        # into an alias, so no argument bytes are credited out of the prune.
        feats = _feature_list(features)
        it = labels.element_size()
        itx = feats[0].element_size()
        x_bytes, y_bytes = itx * rows * nb * bs, it * rows * k
        persist = it * (rows * k + nb * bs * k + nb * bs * bs)
        fused_floor = it * (rows * bs + nb * bs * bs + 2 * rows * k + nb * bs * k)
        resident = _device_bytes(*feats, labels)
        flops = 2.0 * rows * bs * bs * nb + self.num_iter * 4.0 * rows * bs * k * nb
        per_block_dispatches = nb * (self.num_iter + 1) + 2
        cands = [
            autoshard.Candidate(
                "fused", "fused", lambda: self.plan_fused(features, labels, widths), run_fused,
                hints={
                    "arg_bytes": x_bytes + y_bytes,
                    "temp_bytes": fused_floor,
                    "out_bytes": it * (nb * bs * k + k + nb * bs),
                    "resident_bytes": resident,
                    "flops": flops,
                    "dispatches": 1,
                    "hbm_passes": self.num_iter + 1,
                },
                prior_rank=0,
            ),
            autoshard.Candidate(
                "stepwise", "stepwise", lambda: self.plan_stepwise(features, labels, widths),
                run_stepwise,
                hints={
                    "arg_bytes": x_bytes + y_bytes,
                    "temp_bytes": it * (rows * bs + rows * k),
                    "out_bytes": it * nb * bs * k,
                    "extra_bytes": persist,
                    "resident_bytes": resident,
                    "flops": flops,
                    "dispatches": per_block_dispatches,
                    "hbm_passes": self.num_iter + 1,
                },
                prior_rank=1,
            ),
            autoshard.Candidate(
                "host_staged", "host_staged",
                lambda: self.plan_host_staged(features, labels, widths), run_host,
                hints={
                    "arg_bytes": itx * rows * bs + y_bytes,
                    "temp_bytes": it * rows * k,
                    "extra_bytes": persist + it * nb * bs,
                    "resident_bytes": resident,
                    "flops": flops,
                    "dispatches": per_block_dispatches,
                    # Each epoch re-streams every block to the card: the
                    # term that keeps the floor last in an untrained ranking.
                    "h2d_bytes": self.num_iter * x_bytes,
                },
                prior_rank=2, floor=True,
            ),
        ]
        with kprof.phase("bcd_fit"):
            return autoshard.run_search(
                "bcd_fit", cands, report,
                fingerprint=autoshard.fingerprint(
                    "bcd_fit", rows, k, widths, self.num_iter, _dtype_name(feats[0].dtype),
                    _dtype_name(labels.dtype), None, autoshard.device_fingerprint(),
                ),
                plan=plan,
                budget=kmem.hbm_budget(_features_device(features)),
            )

    def _fit_mesh_ladder(self, features, labels, num_features, nvalid, widths, mesh, plan_arg):
        """The mesh ladder (module docstring): per-slot admission, a runtime
        out-of-memory error steps down exactly one tier, and the
        single_device floor gathers the true rows to slot (0, 0)'s device
        and walks the hand ladder there.  ``report.mesh_shape`` records the
        mesh that ran; a floor run is reported as ``single_device/<tier>``."""
        bs, nb = max(widths), len(widths)
        feats = _feature_list(features)
        k = int(labels.shape[1])
        if nvalid is None:
            nvalid = next((f.nvalid for f in (*feats, labels) if isinstance(f, ShardedRows)),
                          int(labels.shape[0]))
        n0 = int(nvalid)
        dtype, xdt = labels.dtype, feats[0].dtype
        it, itx = dtype.itemsize, xdt.itemsize
        lam = float(self.lam)
        report = kmem.FitReport(label="bcd_fit")
        self.last_fit_report = report

        def meta(shape, dt):
            return torch.empty(shape, dtype=dt, device="meta")

        def mesh_tier(m, prior_rank: int, hand: bool, specs=None) -> autoshard.Candidate:
            """One fused-mesh candidate: ``specs`` None is the default layout
            (the hand rung); a spec assignment executes that layout, its
            hints and admission charging that layout's per-slot bytes."""
            name = f"fused[mesh {mesh_desc(m)}]"
            if specs:
                name = f"fused[mesh {mesh_desc(m)}|{autoshard.spec_tag(specs)}]"
            d_sz, m_sz = m.shape[DATA_AXIS], m.shape[MODEL_AXIS]
            n_pad, k_pad = n0 + (-n0) % d_sz, k + (-k) % m_sz
            mdict = dict(m.shape)
            lspec = (specs or {}).get("labels", "data@dim0")
            mspec = (specs or {}).get("models", "model@dim2")
            # The residual carries charged in the labels layout, the models
            # in theirs (the JAX package's accounting).
            res_b = autoshard.spec_chip_bytes((n_pad, k_pad), dtype, lspec, mdict)
            models_b = autoshard.spec_chip_bytes((nb, bs, k_pad), dtype, mspec, mdict)
            # Per-slot transient floor: one centred row block, the
            # replicated factor stack, two residual carries, the models.
            floor = it * (n_pad * bs // d_sz + nb * bs * bs) + 2 * res_b + models_b
            if specs:
                # The bytes of the layout the candidate executes.
                arg_bytes = (autoshard.spec_chip_bytes((n_pad, nb * bs), xdt, "data@dim0", mdict)
                             + autoshard.spec_chip_bytes((n_pad, k_pad), dtype, lspec, mdict))
            else:
                # The lower bound: each operand's cheapest legal spec.
                arg_bytes = sum(
                    autoshard.best_spec(meta(shape, dt), mdict)["per_chip_bytes"]
                    for shape, dt in (((n_pad, nb * bs), xdt), ((n_pad, k_pad), dtype))
                )
            hints = {
                "arg_bytes": arg_bytes,
                "temp_bytes": floor,
                "out_bytes": it * (k_pad + nb * bs) + models_b,
                "flops": (2.0 * n_pad * bs * bs * nb
                          + self.num_iter * 4.0 * n_pad * bs * k_pad * nb) / (d_sz * m_sz),
                "dispatches": 1,
                "hbm_passes": self.num_iter + 1,
                "coll_bytes": it * nb * (bs * bs + self.num_iter * bs * k_pad) if d_sz > 1 else 0,
            }

            def plan():
                budget, _dev = kmem.min_chip_budget(m)
                return kmem.plan_bytes(
                    f"bcd_{name}",
                    argument_bytes=(arg_bytes if specs else
                                    kmem.shard_bytes((n_pad, nb * bs), xdt, m)
                                    + kmem.shard_bytes((n_pad, k_pad), dtype, m)),
                    temp_bytes=floor,
                    output_bytes=hints["out_bytes"],
                    budget=budget,
                )

            def run(plan):
                report.mesh_shape = dict(m.shape)
                x, y = self._mesh_inputs(features, labels, num_features, widths, n0, m, lspec)
                models, label_mean, means = _execute_fused_bcd_mesh(
                    plan, x, y, lam, n0, self.num_iter, widths, specs)
                return models[:, :, :k], label_mean[:k], means

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
            x = [unshard(f) for f in features] if isinstance(features, (list, tuple)) else (
                unshard(features))
            out = self._fit_single(x, unshard(labels), num_features, n0, widths, None, False,
                                   report)
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
                    for sp in _bcd_spec_variants(sm):
                        cands.append(mesh_tier(sm, len(cands), False, specs=sp))
        cands.append(autoshard.Candidate(
            "single_device", "single_device", plan_single, run_single,
            hints={
                # Gather and refit on one device: nothing divides, and the
                # whole design matrix moves first.
                "arg_bytes": itx * n0 * nb * bs + it * n0 * k,
                "h2d_bytes": itx * n0 * nb * bs + it * n0 * k,
                "flops": 2.0 * n0 * bs * bs * nb + self.num_iter * 4.0 * n0 * bs * k * nb,
                "dispatches": 3,
            },
            prior_rank=len(cands), floor=True,
        ))
        slots = list(mesh.devices.flat)
        with kprof.phase("bcd_fit"):
            out = autoshard.run_search(
                "bcd_fit", cands, report,
                fingerprint=autoshard.fingerprint(
                    "bcd_fit", n0, k, widths, self.num_iter, _dtype_name(xdt),
                    _dtype_name(dtype), dict(mesh.shape), autoshard.device_fingerprint(slots),
                ),
                plan=plan_arg,
                budget=kmem.min_chip_budget(mesh)[0],
                devices=slots,
            )
        if inner_chosen and report.chosen == "single_device":
            report.chosen = f"single_device/{inner_chosen[0]}"
        return out

    def _mesh_inputs(self, features, labels, num_features, widths, nvalid: int, mesh,
                     labels_spec: str = "data@dim0"):
        """(x, y): the blocked design matrix sharded over ``mesh`` and the
        labels (columns padded to a multiple of the model axis, in the
        features' dtype) in the ``labels_spec`` layout: row-sharded on x's
        layout by default, else the whole padded labels placed by
        ``autoshard.spec_sharding``.  A tensor's data blocks are views where
        no pad rows are added; each slot's design block is built once per
        device."""
        bs = max(widths)
        m_sz = mesh.shape[MODEL_AXIS]
        listed = isinstance(features, (list, tuple))
        feats = [padded_shard_rows(f, mesh, nvalid=nvalid)[0] for f in _feature_list(features)]
        ys = (padded_shard_rows(labels, mesh, nvalid=nvalid)[0]
              if labels_spec == "data@dim0" else None)
        built: dict = {}
        xs, yl = [], []
        for d in range(mesh.shape[DATA_AXIS]):
            xrow, yrow = [], []
            for m in range(m_sz):
                key = (d, device_key(mesh.devices[d, m]))
                if key not in built:
                    parts = [f.shards[d][m] for f in feats]
                    x_dm, _ = _blocked_design_matrix(parts if listed else parts[0], bs,
                                                     num_features)
                    y_dm = (None if ys is None
                            else _pad_cols(ys.shards[d][m].to(x_dm.dtype), m_sz)[0])
                    built[key] = (x_dm, y_dm)
                xrow.append(built[key][0])
                yrow.append(built[key][1])
            xs.append(xrow)
            yl.append(yrow)
        x = ShardedRows(mesh, xs, nvalid)
        if ys is not None:
            return x, ShardedRows(mesh, yl, nvalid)
        y = on_slot(torch.as_tensor(unshard(labels))[:nvalid], mesh.devices[0, 0])
        y = _pad_cols(y.to(xs[0][0].dtype), m_sz)[0]
        y = torch.nn.functional.pad(y, (0, 0, 0, x.rows - nvalid))
        return x, autoshard.spec_sharding(labels_spec, mesh, 2).place(y)

    def _mapper(self, out, widths) -> BlockLinearMapper:
        models, label_mean, means = out
        return BlockLinearMapper(
            [models[i, :w] for i, w in enumerate(widths)],
            self.block_size,
            label_mean,
            [StandardScalerModel(means[i, :w]) for i, w in enumerate(widths)],
        )
