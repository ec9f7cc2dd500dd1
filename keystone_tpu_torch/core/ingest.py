"""Streaming ingest (counterpart of keystone_tpu/core/ingest.py, the subset
the VOC tar path runs).

``stream_batches(path, batch_size)`` turns tar -> decode -> featurize into a
bounded pipeline:

* one **producer thread** reads the tar serially, submits each kept member's
  decode to a thread pool under an in-order FIFO window of
  ``config.window()`` decodes, buckets the results by shape (host pixels)
  or by :class:`~..ops.jpeg_device.JpegGeometry` (coefficients), and puts
  every full bucket as a chunk into a **ring** of ``ring_capacity`` chunks.
  A full ring blocks the producer, so decode never runs unboundedly ahead.
  At end of stream the partial buckets are flushed in the order of their
  first image.
* under ``decode_mode="device"`` each decode is the host **entropy pass**
  only (:func:`~..ops.jpeg_device.entropy_decode`); the ring carries int16
  coefficient chunks and :meth:`StreamBatch.apply` decodes them on the card
  straight into the featurizer.  JPEGs outside the baseline subset are
  decoded on the host instead, counted per reason; damaged scans are
  counted skips.
* the **consumer** iterates :class:`StreamBatch` chunks in emission order;
  each carries the global image ordinals (``indices``, decode-survival
  order) and member ``names``.  A producer exception re-raises in the
  consumer, never as a silent end of stream; leaving the ``with`` block
  stops the producer, and ``join()`` proves every thread exited.

Events are counted in ``core.resilience.counters`` under the JAX
package's names: ``corrupt_image``, ``jpeg_corrupt_entropy``,
``device_decode_fallback`` and ``device_decode_fallback_<reason>``.  With
tracing on (``core.trace``) the stream records the JAX package's spans:
``ingest.produce`` on the producer lane, ``ingest.decode`` /
``ingest.entropy_decode`` per member on the decode lanes,
``ingest.ring_put`` (its length is the backpressure stall),
``ingest.ring_get`` and ``ingest.consume`` (the consumer's work on one
chunk) on the consumer lane.  With the numerics observatory on, each
chunk's featurize output is a probe site named by its tar members.  Not
ported (ROADMAP Queue 1 item 10): the autotuner, the process decode
backend, snapshots, two-in-flight H2D on CUDA streams and environment
knobs.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FutureTimeout
from typing import Callable

import numpy as np
import torch

from ..loaders import image_loaders
from ..ops import jpeg_device as jdev
from . import numerics as knum
from . import profiler as kprof
from . import trace
from .resilience import counters

_logger = logging.getLogger(__name__)

#: Assembled chunks the ring holds before the producer blocks.
DEFAULT_RING_CAPACITY = 4

#: Where pixels are born: ``host`` (full decode on the host) or ``device``
#: (entropy pass on the host, the rest on the card).
DECODE_MODES = ("host", "device")

#: Every blocking wait polls at this period, so stop flags are observed.
_POLL_SECONDS = 0.05


@dataclasses.dataclass
class StreamConfig:
    """The knobs of one stream: they change concurrency and buffering only,
    never the order or content of what the stream yields."""

    decode_threads: int = dataclasses.field(default_factory=image_loaders.decode_threads)
    decode_ahead: int = dataclasses.field(default_factory=image_loaders.decode_ahead)
    ring_capacity: int = DEFAULT_RING_CAPACITY
    decode_mode: str = "host"

    def __post_init__(self):
        if self.decode_threads < 1:
            raise ValueError(f"decode_threads must be >= 1, got {self.decode_threads}")
        if self.decode_ahead < 0:
            raise ValueError(f"decode_ahead must be >= 0, got {self.decode_ahead}")
        if self.ring_capacity < 1:
            raise ValueError(f"ring_capacity must be >= 1, got {self.ring_capacity}")
        if self.decode_mode not in DECODE_MODES:
            raise ValueError(
                f"decode_mode={self.decode_mode!r} must be one of {DECODE_MODES}"
            )

    def window(self) -> int:
        """In-flight decode window: pool width + decode-ahead."""
        return self.decode_threads + self.decode_ahead


class _Cancelled(Exception):
    """Internal: the consumer stopped the stream — unwind the producer."""


class _FallbackPixels:
    """Device-mode task result: the JPEG is outside the baseline subset
    (``reason``) and was decoded on the host instead."""

    __slots__ = ("reason", "img")

    def __init__(self, reason: str, img):
        self.reason = reason
        self.img = img


class _CorruptEntropy:
    """Device-mode task result: the entropy-coded scan is damaged."""

    __slots__ = ("detail",)

    def __init__(self, detail: str):
        self.detail = detail


def _timed(task, data: bytes, name: str, span_name: str):
    """``(task(data), seconds it took)`` on the calling decode thread; with
    tracing on, the decode is a ``span_name`` span on that thread's lane."""
    start = time.perf_counter()
    if trace.enabled():
        with trace.span(span_name, cat="ingest", member=name):
            out = task(data)
    else:
        out = task(data)
    return out, time.perf_counter() - start


def _entropy_decode_task(data: bytes):
    """One member's device-mode decode task: the entropy pass into a
    ``CoeffImage``.  A JPEG the device path cannot claim is decoded on the
    host (``_FallbackPixels``; where PIL is missing that raises, and the
    stream fails), a damaged scan comes back as ``_CorruptEntropy``, and an
    image under ``MIN_DIM`` as None, the host decoder's reject rule."""
    try:
        ci = jdev.entropy_decode(data)
    except jdev.JpegEntropyCorrupt as e:
        return _CorruptEntropy(str(e))
    except jdev.JpegDecodeUnsupported as e:
        return _FallbackPixels(e.reason, image_loaders.decode_image(data))
    if ci.geom.height < image_loaders.MIN_DIM or ci.geom.width < image_loaders.MIN_DIM:
        return None
    return ci


@dataclasses.dataclass
class CoeffChunk:
    """Device-decode payload of one chunk: the quantised DCT coefficients
    of a batch of same-geometry JPEGs."""

    geom: jdev.JpegGeometry
    coeffs: tuple  #: per-component [b, by, bx, 8, 8] int16 host arrays
    qt: np.ndarray  #: [b, ncomp, 8, 8] f32 per-image dequant tables

    def nbytes(self) -> int:
        return sum(int(c.nbytes) for c in self.coeffs) + int(self.qt.nbytes)


@dataclasses.dataclass
class StreamBatch:
    """One shape-bucketed chunk: host pixels, or (device decode) the
    coefficients of same-geometry JPEGs."""

    index: int  #: chunk ordinal (emission order)
    indices: np.ndarray  #: [b] global image ordinals in decode-survival order
    names: list  #: [b] tar member names
    host: np.ndarray | None  #: [b, H, W, C] f32 host pixels (None for coeff)
    device: torch.device  #: where :meth:`dev` / :meth:`apply` put the pixels
    coeff: CoeffChunk | None = None

    @property
    def shape(self) -> tuple:
        """The bucket key: per-image (H, W)."""
        if self.coeff is not None:
            return (self.coeff.geom.height, self.coeff.geom.width)
        return tuple(self.host.shape[1:3])

    def __len__(self) -> int:
        return len(self.names)

    def dev(self) -> torch.Tensor:
        """The pixel batch on the stream's device (decoded there for
        coefficient chunks)."""
        if self.coeff is not None:
            return jdev.decode_batch(self.coeff.geom, self.coeff.coeffs, self.coeff.qt, self.device)
        return torch.from_numpy(self.host).to(self.device)

    def apply(self, transform):
        """``transform(pixels)`` for this chunk; for coefficient chunks the
        pixels are decoded on the device first, admitted and attributed by
        :func:`~..ops.jpeg_device.fused_apply`.  With the profiler on, a
        pixel chunk's featurize is attributed to the ledger
        (``core.profiler.attributed_call``) with the transform's stated
        cost where it has one (``launch_cost``)."""
        if self.coeff is not None:
            out = jdev.fused_apply(
                transform, self.coeff.geom, self.coeff.coeffs, self.coeff.qt, self.device
            )
        elif not kprof.enabled():
            out = transform(self.dev())
        else:
            pixels = self.dev()
            launch_cost = getattr(transform, "launch_cost", None)
            out = kprof.attributed_call(
                f"featurize:{self.shape[0]}x{self.shape[1]}",
                launch_cost(tuple(pixels.shape)) if launch_cost is not None else None,
                transform, pixels,
            )
        return self._probed(out)

    def _probed(self, out):
        """Numerics observatory hook (``KEYSTONE_NUMERICS=1``): the
        featurize output of every streamed chunk is a tensor-stat probe
        site, with this chunk's member ``names`` as the NaN-provenance
        map.  One flag check when off; the value passes through unchanged
        either way."""
        if knum.active():
            knum.probe(
                f"stream.featurize.{self.shape[0]}x{self.shape[1]}", out, names=self.names
            )
        return out


@dataclasses.dataclass
class StreamStats:
    """Per-stream ingest counts."""

    decoded: int = 0  #: images kept
    skipped: int = 0  #: members skipped (also counted in ``counters``)
    batches: int = 0  #: chunks emitted into the ring
    entropy_decoded: int = 0  #: images entropy-decoded (device mode)
    entropy_backend: str = ""  #: scan loop backend ("native"/"python")
    entropy_corrupt: int = 0  #: damaged scans skipped
    device_fallbacks: int = 0  #: JPEGs decoded on the host instead
    coeff_bytes: int = 0  #: int16 coefficient bytes carried by the ring
    decode_seconds: float = 0.0  #: host decode time summed over the pool's threads


class _Ring:
    """Bounded FIFO between the producer thread and the consumer.  The
    producer ends the stream with :meth:`close` (after :meth:`fail` when it
    raised); :meth:`stop` is the consumer's early exit."""

    _END = object()

    def __init__(self, capacity: int):
        self._q: queue.Queue = queue.Queue(maxsize=capacity)
        self._stopped = threading.Event()

    @property
    def stopped(self) -> bool:
        return self._stopped.is_set()

    def put(self, item) -> bool:
        """Blocks while full; False when the consumer stopped the stream."""
        while not self._stopped.is_set():
            try:
                self._q.put(item, timeout=_POLL_SECONDS)
                return True
            except queue.Full:
                continue
        return False

    def get(self, producer: threading.Thread):
        """The next chunk, ``_Ring._END`` at end of stream; re-raises a
        producer failure."""
        while True:
            try:
                item = self._q.get(timeout=_POLL_SECONDS)
            except queue.Empty:
                if not producer.is_alive() and self._q.empty():
                    raise RuntimeError("ingest producer exited without ending the stream")
                continue
            if isinstance(item, BaseException):
                raise item
            return item

    def fail(self, error: BaseException) -> None:
        self.put(error)

    def close(self) -> None:
        self.put(self._END)

    def stop(self) -> None:
        self._stopped.set()


class IngestStream:
    """The streaming pipeline: iterate to consume, ``with`` (or ``close``)
    to guarantee shutdown, ``join()`` to assert no thread leaked."""

    def __init__(
        self,
        path: str,
        batch_size: int,
        *,
        keep: Callable[[str], bool] | None = None,
        config: StreamConfig | None = None,
        device="cuda",
    ):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self._path = path
        self._batch_size = batch_size
        self._keep = keep
        self.config = config if config is not None else StreamConfig()
        self.device = torch.device(device)
        self.stats = StreamStats()
        self._ring = _Ring(self.config.ring_capacity)
        self._workers: list[threading.Thread] = []
        self._pool: ThreadPoolExecutor | None = None
        self._chunk_counter = 0
        _logger.info(
            "streaming ingest %s: batch=%d threads=%d ahead=%d ring=%d mode=%s",
            path, batch_size, self.config.decode_threads, self.config.decode_ahead,
            self.config.ring_capacity, self.config.decode_mode,
        )
        self._iter = self._drain()
        self._thread = threading.Thread(
            target=self._produce, name="keystone-ingest-producer", daemon=True
        )
        self._thread.start()

    # -- producer side --------------------------------------------------------

    def _register_worker(self):
        self._workers.append(threading.current_thread())

    def _await_decode(self, fut):
        """Poll a decode future so a stopped stream abandons a hung decoder
        instead of waiting for it forever."""
        while True:
            if self._ring.stopped:
                raise _Cancelled()
            try:
                return fut.result(timeout=_POLL_SECONDS)
            except _FutureTimeout:
                continue

    def _produce(self):
        clean = False
        try:
            self._produce_live()
            clean = True
        except _Cancelled:
            pass
        except BaseException as e:  # noqa: BLE001 — re-raised by the consumer
            self._ring.fail(e)
        finally:
            self._ring.close()
            if self._pool is not None:
                self._pool.shutdown(wait=clean, cancel_futures=not clean)

    def _produce_live(self):
        device_mode = self.config.decode_mode == "device"
        if device_mode:
            # Build the native scan loop before the pool spins up, and
            # record which backend this pass runs.
            self.stats.entropy_backend = jdev.entropy_backend()
        task = _entropy_decode_task if device_mode else image_loaders.decode_image
        span_name = "ingest.entropy_decode" if device_mode else "ingest.decode"
        self._pool = ThreadPoolExecutor(
            max_workers=self.config.decode_threads,
            thread_name_prefix="keystone-decode",
            initializer=self._register_worker,
        )
        # shape or geometry -> (ordinals, names, images); insertion-ordered
        buckets: dict = {}
        window: collections.deque = collections.deque()
        ordinal = 0

        def keep_decoded(name, img):
            nonlocal ordinal
            self.stats.decoded += 1
            if isinstance(img, jdev.CoeffImage):
                self.stats.entropy_decoded += 1
                self.stats.coeff_bytes += img.geom.coeff_bytes()
                key = img.geom
            else:
                key = img.shape[:2]
            idx, names, imgs = buckets.setdefault(key, ([], [], []))
            idx.append(ordinal)
            names.append(name)
            imgs.append(img)
            ordinal += 1
            if len(imgs) >= self._batch_size:
                self._emit(buckets.pop(key))

        def drain_one():
            name, fut = window.popleft()
            img, seconds = self._await_decode(fut)
            self.stats.decode_seconds += seconds
            if isinstance(img, _CorruptEntropy):
                # A damaged scan under device decode: a counted skip, never
                # silent wrong pixels.
                counters.record("jpeg_corrupt_entropy", f"{name}: {img.detail}")
                self.stats.skipped += 1
                self.stats.entropy_corrupt += 1
                return
            if isinstance(img, _FallbackPixels):
                counters.record("device_decode_fallback", f"{name}: {img.reason}")
                counters.record(f"device_decode_fallback_{img.reason}", name)
                self.stats.device_fallbacks += 1
                img = img.img
            if img is None:
                counters.record("corrupt_image", name)
                self.stats.skipped += 1
                return
            keep_decoded(name, img)

        with trace.span("ingest.produce", cat="ingest", path=self._path) as prod_sp:
            try:
                for name, data in image_loaders._iter_tar_members(self._path):
                    if self._ring.stopped:
                        raise _Cancelled()
                    if self._keep is not None and not self._keep(name):
                        continue
                    window.append(
                        (name, self._pool.submit(_timed, task, data, name, span_name))
                    )
                    while len(window) >= self.config.window():
                        drain_one()
                while window:
                    drain_one()
                # Flush the batch-size remainders, oldest bucket first.
                for bucket in sorted(buckets.values(), key=lambda b: b[0][0]):
                    self._emit(bucket)
            except _Cancelled:
                # The consumer stopped the stream: routine shutdown, marked
                # aborted rather than errored.
                prod_sp.set(aborted=True)
                raise
            finally:
                prod_sp.set(
                    decoded=self.stats.decoded,
                    skipped=self.stats.skipped,
                    batches=self.stats.batches,
                )

    def _emit(self, bucket):
        idx, names, imgs = bucket
        if isinstance(imgs[0], jdev.CoeffImage):
            coeffs, qt = jdev.stack_coeff_images(imgs)
            host, coeff = None, CoeffChunk(geom=imgs[0].geom, coeffs=coeffs, qt=qt)
        else:
            host, coeff = np.stack(imgs), None
        chunk = StreamBatch(
            index=self._chunk_counter, indices=np.asarray(idx, np.int64),
            names=names, host=host, device=self.device, coeff=coeff,
        )
        self._chunk_counter += 1
        attrs = {"coeff_bytes": coeff.nbytes()} if coeff is not None else {}
        # The put span's duration is the backpressure stall: a full ring
        # blocks here.
        with trace.span(
            "ingest.ring_put", cat="ingest", index=chunk.index, images=len(chunk), **attrs
        ):
            ok = self._ring.put(chunk)
        if not ok:
            raise _Cancelled()
        self.stats.batches += 1

    # -- consumer side --------------------------------------------------------

    def _drain(self):
        try:
            while True:
                with trace.span("ingest.ring_get", cat="ingest"):
                    item = self._ring.get(self._thread)
                if item is _Ring._END:
                    break
                # The consume span runs from the consumer receiving the
                # chunk until it asks for the next one: its work on THAT
                # chunk.  Decode spans inside its interval are the overlap.
                with trace.span(
                    "ingest.consume", cat="ingest", index=item.index, images=len(item)
                ):
                    yield item
        finally:
            self._ring.stop()

    def __iter__(self):
        return self

    def __next__(self) -> StreamBatch:
        return next(self._iter)

    def __enter__(self) -> "IngestStream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        """Stop the producer.  Idempotent; called on exhaustion, on a
        consumer exception, and on leaving the ``with`` block."""
        self._ring.stop()
        self._iter.close()

    def join(self, timeout: float = 10.0) -> bool:
        """Wait for the producer and every decode thread; True when none is
        left alive."""
        end = time.monotonic() + timeout
        self._thread.join(max(0.0, end - time.monotonic()))
        for t in list(self._workers):
            t.join(max(0.0, end - time.monotonic()))
        return not (self._thread.is_alive() or any(t.is_alive() for t in self._workers))


def stream_batches(
    path: str,
    batch_size: int,
    *,
    keep: Callable[[str], bool] | None = None,
    config: StreamConfig | None = None,
    device="cuda",
) -> IngestStream:
    """Stream shape-bucketed chunks of ``batch_size`` images from a tar (or
    a directory of tars).  ``keep`` filters member names before decode;
    ``config`` holds the knobs (:class:`StreamConfig` defaults when None);
    ``device`` is where :meth:`StreamBatch.dev` / :meth:`StreamBatch.apply`
    put the pixels.  Use it as a context manager (or iterate to the end) so
    the threads are released, and ``join()`` to assert they exited."""
    return IngestStream(path, batch_size, keep=keep, config=config, device=device)
