"""Reductions over a mesh's data axis (counterpart of
keystone_tpu/parallel/collectives.py, one process).

The JAX package lowers its reductions to XLA collectives (``psum`` inside
``shard_map``, or implicitly under ``jit``).  Here a mesh is a grid of slots
in one process (``parallel.mesh``), so a reduction is explicit: every data
block computes its partial on its own slot, and :func:`psum` adds the
partials in data-index order on the first one's device.  The order is
fixed, so a result never depends on timing; a caller copies it to the slots
that need it (``parallel.mesh.on_slot``).  The model axis never reduces: it
splits the class columns (``solvers.normal_equations``).

  treeReduce/treeAggregate  ->  :func:`psum` of per-block partials
                                (:func:`sharded_gram`, :func:`sharded_moments`)
  broadcast                 ->  ``parallel.mesh.on_slot`` / ``replicate``
  collect                   ->  ``ShardedRows.gather`` (data order)
  lax.all_to_all (the class  ->  :func:`exchange_rows`, slot to slot
  shuffle of BWLS)
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .mesh import ShardedRows, on_slot


def psum(partials: Sequence[torch.Tensor]) -> torch.Tensor:
    """The partials summed in the order given (data-index order), on the
    first one's device.  One partial is returned as it is."""
    total = partials[0]
    for p in partials[1:]:
        total = total + on_slot(p, total.device)
    return total


def psum_gram(x_blocks: Sequence[torch.Tensor], y_blocks: Sequence[torch.Tensor]):
    """``(XᵀX, XᵀY)`` from row blocks in data order: each block's local
    gram on its own device, then :func:`psum` (the reference's treeReduce,
    BlockWeightedLeastSquares.scala:186-216)."""
    return (psum([x.T @ x for x in x_blocks]),
            psum([x.T @ y for x, y in zip(x_blocks, y_blocks)]))


def sharded_gram(x: ShardedRows, y: ShardedRows):
    """``(XᵀX, XᵀY)`` of two row-sharded arrays of one layout, on slot
    (0, 0)'s device.  Zero pad rows add nothing."""
    return psum_gram(x.data_blocks(), y.data_blocks())


def sharded_moments(x: ShardedRows):
    """``(count, Σx, Σx²)`` over the rows of a row-sharded array, pad rows
    included in the count (they are zero in the sums); the reference's
    treeAggregate(MultivariateOnlineSummarizer),
    nodes/stats/StandardScaler.scala:46-48."""
    blocks = x.data_blocks()
    return (float(x.rows), psum([b.sum(dim=0) for b in blocks]),
            psum([(b * b).sum(dim=0) for b in blocks]))


def exchange_rows(blocks: Sequence[torch.Tensor], devices: Sequence, send: np.ndarray,
                  recv: np.ndarray) -> list[torch.Tensor]:
    """A row exchange between the data slots (the single-process
    ``lax.all_to_all`` of the BWLS class regroup).  ``blocks[s]`` is source
    slot ``s``'s rows; ``send[s, t]`` (``[d, d, m]``) lists the local rows
    that ``s`` sends to destination ``t``, padded to ``m``; ``recv[t]``
    indexes what ``t`` received, laid out as ``[source, m]`` flattened,
    with ``d * m`` for a zero row.  Each source gathers its send buckets on
    its own device, each bucket is copied onto its destination's device,
    and each destination concatenates its buckets in source order and takes
    its rows.  Rows are moved, never added: the output is the input's rows
    permuted, bit for bit.  Returns one tensor per destination, on
    ``devices[t]``."""
    d, m = int(send.shape[0]), int(send.shape[2])
    buckets = []
    for s, block in enumerate(blocks):
        idx = torch.from_numpy(np.ascontiguousarray(send[s].reshape(-1), np.int64))
        buckets.append(block[idx.to(block.device)].reshape(d, m, *block.shape[1:]))
    out = []
    for t, dev in enumerate(devices):
        got = [on_slot(buckets[s][t], dev) for s in range(d)]
        got.append(got[0].new_zeros((1, *got[0].shape[1:])))  # the zero row, index d*m
        flat = torch.cat(got)
        idx = torch.from_numpy(np.ascontiguousarray(recv[t], np.int64)).to(flat.device)
        out.append(flat[idx])
    return out
