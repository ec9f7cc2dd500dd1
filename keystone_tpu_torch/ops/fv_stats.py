"""Fisher-vector sufficient statistics (counterpart of
keystone_tpu/ops/fv_pallas.py::fv_stats_pallas).

:func:`fv_stats` maps descriptor matrices ``x [N, d, D]`` (f32, descriptors
as columns), optional prefix-valid ``counts [N]`` and a diagonal GMM
(``means``/``variances [d, k]``, ``weights [k]``) to ``s0 [N, k]``,
``s1 [N, d, k]`` and ``s2 [N, d, k]``: the posterior mass, and the
posterior-weighted sums of the descriptors and of their squares.

On a CUDA tensor it launches the hand-written kernel ``csrc/fv_stats.cu``
(or raises); on a CPU tensor it runs :func:`fv_stats_reference`, the plain
PyTorch version the tests and ``chip_smoke.py`` hold the kernel against,
one image at a time, so that an image's statistics do not depend on its
batch on either device.
:func:`fv_stats_cost` states a call's flops and bytes, from which
``core.profiler`` reckons the roofline bound.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from .. import _build
from ..core import profiler as kprof
from ..utils.platform import device_scope

#: Kernel launches made by :func:`fv_stats` (never by the plain version,
#: nor while a CUDA graph records it: ``core.serve`` counts the graph's
#: replays): one per group of images (see :func:`launch_geometry`).
launches = 0

#: The kernel's envelope: ``2d`` rows of ``[x; x*x]`` and ``k`` components
#: within the register tiles of one block (``2d <= 160``, ``k <= 256``;
#: ``kMaxD`` and ``kMaxK`` in ``csrc/fv_stats.cu``).  Beyond it the wrapper
#: raises.
MAX_D = 80
MAX_K = 256
#: Descriptor columns per tile (``kTile`` in ``csrc/fv_stats.cu``).
TILE = 32
#: Column tiles per block.  The kernel splits each image's columns into
#: fixed runs of this many tiles and sums the runs in order, so an image's
#: statistics are the same bits whatever else is in the batch: the signed
#: square root downstream would turn order-dependent rounding in near-zero
#: entries into visible differences between a served and an offline image.
#: 18 tiles (576 columns) give a 500x375 VOC image (73,866 descriptors) 129
#: blocks, one for nearly each of an H100's 132 SMs.
TILES_PER_SPLIT = 18
SPLIT_COLS = TILE * TILES_PER_SPLIT
#: Most bytes of per-split partials one launch may hold; larger batches go
#: through the kernel in groups of images, which changes no bit of any.
WORKSPACE_BYTES = 2**31


class Geometry(NamedTuple):
    splits: int  # column runs per image, each SPLIT_COLS long (the last shorter)
    group: int  # images per launch
    workspace_bytes: int  # partials of one launch: group * splits * (k + 2dk) f32


def check_envelope(d: int, k: int) -> None:
    if not (1 <= d <= MAX_D and 1 <= k <= MAX_K):
        raise ValueError(
            f"fv_stats: d={d}, k={k} is outside the kernel's envelope "
            f"(1 <= d <= {MAX_D}, 1 <= k <= {MAX_K})"
        )


def launch_geometry(n: int, d: int, cols: int, k: int) -> Geometry:
    """How :func:`fv_stats` cuts ``[n, d, cols]`` for the kernel.  The
    splits depend on ``cols`` alone; ``n`` sets only how many images share a
    launch."""
    splits = -(-cols // SPLIT_COLS)
    per_image = splits * (k + 2 * d * k) * 4
    group = max(1, min(n, WORKSPACE_BYTES // per_image))
    return Geometry(splits, group, group * per_image)


_SIGNATURES = {
    "fv_stats_prepare": (
        ctypes.c_int,
        [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # means, variances, weights
            ctypes.c_void_p,  # params
            ctypes.c_int, ctypes.c_int,  # d, k
            ctypes.c_void_p,  # stream
        ],
    ),
    "fv_stats_launch": (
        ctypes.c_int,
        [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # x, counts, params
            ctypes.c_void_p, ctypes.c_void_p,  # out, workspace
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # n d D k
            ctypes.c_int, ctypes.c_int,  # splits, tiles_per_split
            ctypes.c_void_p,  # stream
        ],
    ),
}


def fv_stats_cost(n: int, d: int, cols: int, k: int,
                  valid_cols: int | None = None) -> tuple[float, float]:
    """(flops, bytes) of :func:`fv_stats` on ``[n, d, cols]`` descriptors
    with ``k`` components: the valid descriptors read once and s0/s1/s2
    written once, against the 8*k*d f32 operations per descriptor of the
    four contractions (the k exps per descriptor are left out, in the
    bound's favour).  ``valid_cols``: the descriptors the counts leave
    valid over the whole batch (default all ``n * cols``)."""
    used = n * cols if valid_cols is None else valid_cols
    return 8.0 * k * d * used, float(used * d * 4 + n * (k + 2 * d * k) * 4)


def _logit_terms(means, variances, weights):
    """(A [d, k], B [d, k], c [k]) with ``logit = A^T x - B^T x^2 / 2 + c``:
    ``A = mu / var``, ``B = 1 / var``,
    ``c = log w - (sum mu^2/var + sum log var + d log 2pi) / 2``."""
    d = means.shape[0]
    inv_var = 1.0 / variances
    c = torch.log(weights) - 0.5 * (
        torch.sum(means * means * inv_var, dim=0)
        + torch.sum(torch.log(variances), dim=0)
        + d * math.log(2.0 * math.pi)
    )
    return means * inv_var, inv_var, c


def fv_stats_reference(x, counts, means, variances, weights):
    """Plain PyTorch version of the kernel: the same parameterisation, with
    the [N, k, D] posteriors materialised."""
    a, b, c = _logit_terms(means, variances, weights)
    x2 = x * x
    logit = torch.matmul(a.T, x) - 0.5 * torch.matmul(b.T, x2) + c[:, None]
    q = torch.softmax(logit, dim=1)  # [N, k, D]
    if counts is not None:
        cols = torch.arange(x.shape[2], device=x.device)
        q = q * (cols[None, :] < counts.to(x.device)[:, None]).to(q.dtype)[:, None, :]
    qt = q.transpose(1, 2)
    return q.sum(dim=2), torch.matmul(x, qt), torch.matmul(x2, qt)


def fv_stats(x, counts, means, variances, weights):
    """[N, d, D] descriptors -> (s0 [N, k], s1 [N, d, k], s2 [N, d, k])."""
    if x.device.type == "cpu":
        if x.shape[0] <= 1:
            return fv_stats_reference(x, counts, means, variances, weights)
        # One image at a time: the plain version's batched products pick
        # their kernel by N, and an image's statistics must not depend on
        # the batch it rides in (a mesh slot's rows, a served bucket), as
        # the kernel's do not.
        parts = [fv_stats_reference(x[i : i + 1], None if counts is None else counts[i : i + 1],
                                    means, variances, weights) for i in range(x.shape[0])]
        return tuple(torch.cat(p) for p in zip(*parts))
    if x.device.type != "cuda":
        raise ValueError(f"fv_stats: unsupported device {x.device}")
    if x.dim() != 3:
        raise ValueError(f"fv_stats: expected x [N, d, D], got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"fv_stats: x must be float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("fv_stats: x must be contiguous")
    n, d, cols = x.shape
    k = int(weights.shape[0])
    if means.shape != (d, k) or variances.shape != (d, k):
        raise ValueError(
            f"fv_stats: means/variances must be [d={d}, k={k}], got "
            f"{tuple(means.shape)} / {tuple(variances.shape)}"
        )
    for name, t in (("means", means), ("variances", variances), ("weights", weights)):
        if t.device != x.device or t.dtype != torch.float32:
            raise ValueError(f"fv_stats: {name} must be float32 on {x.device}")
    if n == 0 or d == 0 or cols == 0:
        raise ValueError(f"fv_stats: empty problem x={tuple(x.shape)}")
    check_envelope(d, k)
    if counts is not None:
        if counts.shape != (n,) or counts.device != x.device:
            raise ValueError(f"fv_stats: counts must be [{n}] on {x.device}")
        counts = counts.to(torch.int32).contiguous()
        lo, hi = torch.aminmax(counts)
        if int(lo) < 0 or int(hi) > cols:
            raise ValueError(f"fv_stats: counts must lie in [0, {cols}]")
    geom = launch_geometry(n, d, cols, k)
    per_image = k + 2 * d * k
    # w [2 MAX_D, MAX_K] and c [MAX_K] of _logit_terms, padded, made by the library.
    params = torch.empty(2 * MAX_D * MAX_K + MAX_K, dtype=torch.float32, device=x.device)
    out = torch.empty((n, per_image), dtype=torch.float32, device=x.device)
    workspace = torch.empty(
        (geom.group, geom.splits, per_image), dtype=torch.float32, device=x.device
    )
    lib = _build.load("fv_stats", _SIGNATURES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    gmm = [t.contiguous() for t in (means, variances, weights)]
    global launches
    # A ctypes launch runs on the runtime's current device: x's, whatever
    # device the caller (a mesh slot of another card) has current.
    with device_scope(x.device):
        rc = lib.fv_stats_prepare(*(t.data_ptr() for t in gmm), params.data_ptr(), d, k,
                                  stream)
        if rc != 0:
            raise RuntimeError(f"fv_stats_prepare launch failed: cudaError {rc}")
        for i in range(0, n, geom.group):
            m = min(geom.group, n - i)
            rc = kprof.launch(
                "fv_stats",
                lambda: fv_stats_cost(
                    m, d, cols, k, None if counts is None else int(counts[i : i + m].sum())),
                lambda: lib.fv_stats_launch(
                    x[i].data_ptr(), None if counts is None else counts[i].data_ptr(),
                    params.data_ptr(), out[i].data_ptr(), workspace.data_ptr(),
                    m, d, cols, k, geom.splits, TILES_PER_SPLIT, stream,
                ),
            )
            if rc != 0:
                raise RuntimeError(f"fv_stats kernel launch failed: cudaError {rc}")
            if not kprof.recording_graph():  # a graph's replays launch it (core.serve)
                launches += 1
    s1 = out[:, k : k + d * k].reshape(n, d, k)
    s2 = out[:, k + d * k :].reshape(n, d, k)
    return out[:, :k], s1, s2
