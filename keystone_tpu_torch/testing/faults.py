"""Fault injectors for the port's chaos harness (counterpart of the
repository's ``tests/faults.py``, with the same names and signatures).

* **corrupt data**: :func:`corrupt_jpeg` mangles a valid JPEG stream (the
  SOI marker kept, so decoders engage and must fail cleanly);
  :func:`corrupt_jpeg_entropy` damages only the entropy-coded scan;
  :func:`make_image_tar` writes a tar with chosen members mangled;
  :func:`truncate_tail` chops an archive's end.
* **transient IO**: :func:`flaky` / :func:`transient_faults` make a callable
  (or a module attribute) raise ``OSError`` for its first N calls, which
  ``core.resilience.retry`` must absorb.
* **poisoned numerics**: :func:`inject_nan` and :func:`rank_deficient_gram`.
* **device memory exhaustion**: :func:`resource_exhausted_error` is the
  exception PyTorch's caching allocator raises when the card is full
  (``torch.OutOfMemoryError`` with its "CUDA out of memory" text, what
  ``core.memory.is_oom_error`` recognises); :func:`oom_faults` makes a
  callable die with it for its first N calls.

From the same ``rng`` every builder gives the same bytes as the JAX
package's: JPEGs through PIL, tars, damaged streams and NaN masks.  Only
:func:`resource_exhausted_error` and :func:`oom_faults` import torch.
"""

from __future__ import annotations

import contextlib
import io
import os
import tarfile

import numpy as np

#: The allocator's grammar for an exhausted card, as ``torch.cuda`` words it.
OOM_MESSAGE = "CUDA out of memory. Tried to allocate {nbytes} bytes (injected fault)"


def make_jpeg_bytes(rng, h: int = 48, w: int = 48, quality: int = 90) -> bytes:
    """A valid random-texture JPEG."""
    from PIL import Image as PILImage

    arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    buf = io.BytesIO()
    PILImage.fromarray(arr).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def corrupt_jpeg(data: bytes, rng) -> bytes:
    """Mangle a JPEG stream: keep the SOI marker (so decoders engage rather
    than reject on sniffing), truncate the tail, and scramble a slice of
    the entropy-coded body."""
    keep = max(8, len(data) // 3)
    body = bytearray(data[:keep])
    lo = min(6, len(body) - 1)
    body[lo:] = rng.integers(0, 256, max(0, keep - lo), dtype=np.uint8).tobytes()
    return bytes(body)


def corrupt_jpeg_entropy(data: bytes, mode: str = "truncate") -> bytes:
    """Damage ONLY the entropy-coded scan of a baseline JPEG: every header
    (SOF/DQT/DHT/SOS) stays intact, so a decoder that validates headers
    engages the scan and must fail there, typed.  ``truncate`` chops the
    scan mid-stream (bits run out inside an MCU); ``marker`` splices an
    early EOI into it (the MCU count comes up short).  Both are always
    detectable, so no chaos schedule depends on random bytes happening to
    form an invalid Huffman sequence."""
    sos = data.find(b"\xff\xda")
    if sos < 0:
        raise ValueError("not a JPEG with an SOS marker")
    seg_len = (data[sos + 2] << 8) | data[sos + 3]
    scan = sos + 2 + seg_len
    keep = scan + max(4, (len(data) - scan) // 3)
    if mode == "truncate":
        return data[:keep]
    if mode == "marker":
        return data[:keep] + b"\xff\xd9"
    raise ValueError(f"unknown entropy corruption mode {mode!r}")


def make_image_tar(
    path: str,
    n_images: int,
    rng,
    corrupt: tuple[int, ...] = (),
    h: int = 48,
    w: int = 48,
    name_fmt: str = "img_{:04d}.jpg",
    corrupt_fn=None,
) -> list[str]:
    """Write a tar of JPEGs; members whose index is in ``corrupt`` carry
    mangled bytes (their decode must fail mid-archive without breaking the
    members after them).  ``corrupt_fn(data)`` overrides how a member is
    mangled (default :func:`corrupt_jpeg`).  Returns the member names."""
    names = []
    with tarfile.open(path, "w") as tf:
        for i in range(n_images):
            data = make_jpeg_bytes(rng, h, w)
            if i in corrupt:
                data = corrupt_fn(data) if corrupt_fn is not None else corrupt_jpeg(data, rng)
            info = tarfile.TarInfo(name_fmt.format(i))
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
            names.append(info.name)
    return names


def truncate_tail(path: str, nbytes: int = 1024) -> None:
    """Chop the last ``nbytes`` off an archive: a partly transferred tar
    whose final member (and end-of-archive blocks) are gone."""
    size = os.path.getsize(path)
    with open(path, "r+b") as fh:
        fh.truncate(max(0, size - nbytes))


def flaky(fn, failures: int, exc: type[BaseException] = OSError,
          message: str = "injected transient fault"):
    """Wrap ``fn`` to raise ``exc`` for its first ``failures`` calls, then
    delegate.  The wrapper's ``.state`` holds ``calls`` and ``left``."""
    state = {"calls": 0, "left": failures}

    def wrapped(*args, **kwargs):
        state["calls"] += 1
        if state["left"] > 0:
            state["left"] -= 1
            raise exc(f"{message} (call {state['calls']})")
        return fn(*args, **kwargs)

    wrapped.state = state
    return wrapped


@contextlib.contextmanager
def transient_faults(obj, attr: str, failures: int, exc: type[BaseException] = OSError,
                     message: str = "injected transient fault"):
    """Patch ``obj.attr`` with a :func:`flaky` wrapper for the block, e.g.
    ``transient_faults(image_loaders.tarfile, "open", 2)`` makes the next
    two tar opens fail with ``OSError``."""
    original = getattr(obj, attr)
    wrapper = flaky(original, failures, exc, message)
    setattr(obj, attr, wrapper)
    try:
        yield wrapper
    finally:
        setattr(obj, attr, original)


def resource_exhausted_error(nbytes: int = 1 << 33) -> BaseException:
    """An exception indistinguishable from the card running out of memory:
    ``torch.OutOfMemoryError`` with the caching allocator's text."""
    import torch

    return torch.OutOfMemoryError(OOM_MESSAGE.format(nbytes=nbytes))


@contextlib.contextmanager
def oom_faults(obj, attr: str, failures: int = 1):
    """Patch ``obj.attr`` to raise ``torch.OutOfMemoryError`` for its first
    ``failures`` calls, e.g. ``oom_faults(block, "_fused_bcd_impl", 1)``
    makes the next fused BCD tier die as a too-small card does, driving the
    fit ladder's one-tier step-down."""
    import torch

    with transient_faults(obj, attr, failures, exc=torch.OutOfMemoryError,
                          message=OOM_MESSAGE.format(nbytes=1 << 33)) as wrapper:
        yield wrapper


def inject_nan(batch, rng, frac: float = 0.01):
    """Copy of ``batch`` with about ``frac`` of its entries NaN.
    ``order="C"``: a copy in the source's layout would make ``reshape(-1)``
    of a transposed input (the CIFAR loader's NHWC images) a copy, and the
    NaN writes would be lost."""
    out = np.array(batch, copy=True, order="C")
    flat = out.reshape(-1)
    k = max(1, int(frac * flat.size))
    flat[rng.choice(flat.size, k, replace=False)] = np.nan
    return out


def rank_deficient_gram(rng, n: int = 32, d: int = 8, k: int = 2):
    """(AᵀA, AᵀB) from a design matrix with duplicated columns: the
    unregularised gram is singular, so only jitter recovery solves it."""
    a = rng.normal(size=(n, d)).astype(np.float32)
    a[:, d // 2:] = a[:, : d - d // 2]
    b = rng.normal(size=(n, k)).astype(np.float32)
    return a.T @ a, a.T @ b
