"""Device selection for the port (counterpart of keystone_tpu/utils/platform.py).

Every entry point takes an explicit ``device`` defaulting to ``"cuda"``.
There is no silent CPU fallback: asking for CUDA without a card raises.

On CUDA the first use pins full-f32 convolutions and matmuls.  cuDNN runs
f32 convolutions in TF32 by default, and the Convolver's per-patch sigma
comes from ``sum(p^2) - d*mu^2`` over raw 0-255 pixels — a cancellation
that needs every f32 bit (ops/images.py).
"""

from __future__ import annotations

import contextlib
import threading

import torch

_F32_PINNED = False


def _pin_full_f32() -> None:
    global _F32_PINNED
    if _F32_PINNED:
        return
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # Newer PyTorch releases carry the same switch as ``fp32_precision``.
    conv = getattr(torch.backends.cudnn, "conv", None)
    if conv is not None and hasattr(conv, "fp32_precision"):
        conv.fp32_precision = "ieee"
    if hasattr(torch.backends.cuda.matmul, "fp32_precision"):
        torch.backends.cuda.matmul.fp32_precision = "ieee"
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "could not disable TF32 for cuDNN convolutions / cuBLAS matmuls"
        )
    _F32_PINNED = True


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises for CUDA without a card."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but no CUDA card is available "
                "(pass device='cpu' / --device cpu to run on the CPU)"
            )
        _pin_full_f32()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (use 'cuda' or 'cpu')")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for queued work on ``device`` (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_scope(device):
    """Make ``device`` the current CUDA device inside the block (a no-op
    context for the CPU).  PyTorch's own operators follow their tensors'
    device, but a hand kernel launched through ``ctypes`` runs on the
    runtime's current device: each launch, and each mesh slot's work,
    enters the scope of the device its tensors live on."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


_constants = threading.local()


@contextlib.contextmanager
def retained_constants():
    """Inside the block, :func:`device_constant` makes and copies each of its
    constants once and keeps it in the yielded dict.  A CUDA graph cannot
    copy from the host while it captures, and it reads each tensor at the
    address it was captured with: ``core.serve`` warms a bucket up and
    captures it in one such block and holds the dict as long as the
    graph."""
    prev = getattr(_constants, "store", None)
    _constants.store = store = {}
    try:
        yield store
    finally:
        _constants.store = prev


def device_constant(key, make, device) -> torch.Tensor:
    """``make()`` (a CPU tensor built from host data) on ``device``.
    Outside :func:`retained_constants` it is made and copied on every call;
    inside, once per ``key`` and device."""
    store = getattr(_constants, "store", None)
    if store is None:
        return make().to(device)
    k = (key, str(device))
    t = store.get(k)
    if t is None:
        t = store[k] = make().to(device)
    return t
