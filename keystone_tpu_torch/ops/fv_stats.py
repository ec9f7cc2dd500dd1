"""Fisher-vector sufficient statistics (counterpart of
keystone_tpu/ops/fv_pallas.py::fv_stats_pallas).

:func:`fv_stats` maps descriptor matrices ``x [N, d, D]`` (f32, descriptors
as columns), optional prefix-valid ``counts [N]`` and a diagonal GMM
(``means``/``variances [d, k]``, ``weights [k]``) to ``s0 [N, k]``,
``s1 [N, d, k]`` and ``s2 [N, d, k]``: the posterior mass, and the
posterior-weighted sums of the descriptors and of their squares.

On a CUDA tensor it launches the hand-written kernel ``csrc/fv_stats.cu``
(or raises); on a CPU tensor it runs :func:`fv_stats_reference`, the plain
PyTorch version the tests and ``chip_smoke.py`` hold the kernel against.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import _build

#: Kernel launches made by :func:`fv_stats` (never by the plain version).
launches = 0

#: The kernel's envelope: one thread per component, and its shared memory
#: (``4 * (2d*TILE + 2d*k + k*(TILE + 1))`` bytes) within an H100 block's
#: 227 KB.  Beyond it the wrapper raises.
MAX_K = 256
TILE = 32
MAX_SMEM_BYTES = 232448
#: Column tiles per block.  The kernel splits each image's columns into
#: fixed runs of this many tiles and sums the runs in order, so an image's
#: statistics are the same bits whatever else is in the batch: the signed
#: square root downstream would turn order-dependent rounding in near-zero
#: entries into visible differences between a served and an offline image.
TILES_PER_SPLIT = 64

_SIGNATURES = {
    "fv_stats_launch": (
        ctypes.c_int,
        [
            ctypes.c_void_p, ctypes.c_void_p,  # x, counts
            ctypes.c_void_p, ctypes.c_void_p,  # w, c
            ctypes.c_void_p, ctypes.c_void_p,  # out, workspace
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # n d D k
            ctypes.c_int, ctypes.c_int,  # splits, tiles_per_split
            ctypes.c_void_p,  # stream
        ],
    )
}


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
        return fv_stats_reference(x, counts, means, variances, weights)
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
    smem = 4 * (2 * d * TILE + 2 * d * k + k * (TILE + 1))
    if k > MAX_K or smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"fv_stats: d={d}, k={k} is outside the kernel's envelope "
            f"(k <= {MAX_K} and 4*(2d*{TILE} + 2d*k + k*{TILE + 1}) = {smem} "
            f"<= {MAX_SMEM_BYTES} bytes of shared memory)"
        )
    if n == 0 or d == 0 or cols == 0:
        raise ValueError(f"fv_stats: empty problem x={tuple(x.shape)}")
    if counts is not None:
        if counts.shape != (n,) or counts.device != x.device:
            raise ValueError(f"fv_stats: counts must be [{n}] on {x.device}")
        counts = counts.to(torch.int32).contiguous()
        lo, hi = torch.aminmax(counts)
        if int(lo) < 0 or int(hi) > cols:
            raise ValueError(f"fv_stats: counts must lie in [0, {cols}]")
    a, b, c = _logit_terms(means, variances, weights)
    w = torch.cat([a, -0.5 * b], dim=0).contiguous()  # [2d, k]
    c = c.contiguous()
    per = TILES_PER_SPLIT
    splits = -(-cols // (TILE * per))
    per_image = k + 2 * d * k
    out = torch.empty((n, per_image), dtype=torch.float32, device=x.device)
    workspace = torch.empty((n, splits, per_image), dtype=torch.float32, device=x.device)
    lib = _build.load("fv_stats", _SIGNATURES)
    rc = lib.fv_stats_launch(
        x.data_ptr(), None if counts is None else counts.data_ptr(),
        w.data_ptr(), c.data_ptr(), out.data_ptr(), workspace.data_ptr(),
        n, d, cols, k, splits, per, torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"fv_stats kernel launch failed: cudaError {rc}")
    global launches
    launches += 1
    s1 = out[:, k : k + d * k].reshape(n, d, k)
    s2 = out[:, k + d * k :].reshape(n, d, k)
    return out[:, :k], s1, s2
