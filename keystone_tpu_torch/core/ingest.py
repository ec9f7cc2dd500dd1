"""Streaming ingest (counterpart of keystone_tpu/core/ingest.py).

``stream_batches(path, batch_size)`` turns tar -> decode -> featurize into a
bounded pipeline:

* one **producer thread** reads the tar serially, submits each kept member's
  decode under an in-order FIFO window of ``config.window()`` decodes,
  buckets the results by shape (host pixels) or by
  :class:`~..ops.jpeg_device.JpegGeometry` (coefficients), and puts every
  full bucket as a chunk into a **ring** of ``ring_capacity`` chunks.  A
  full ring blocks the producer, so decode never runs unboundedly ahead.  At
  end of stream the partial buckets are flushed in the order of their first
  image.
* the host decode runs on a **thread pool** (``decode_backend="thread"``)
  or on spawned **worker processes** that return pixels in shared memory
  (``"process"``, ``core.decode_workers``), free of the interpreter lock.
  Both run ``image_loaders.decode_image``, so they give the same pixels.
* under ``decode_mode="device"`` each decode is the host **entropy pass**
  only (:func:`~..ops.jpeg_device.entropy_decode`, always on the thread
  pool); the ring carries int16 coefficient chunks and
  :meth:`StreamBatch.apply` decodes them on the card straight into the
  featurizer.  JPEGs outside the baseline subset are decoded on the host
  instead, counted per reason; damaged scans are counted skips.
* with ``snapshot_dir`` set (``core.snapshot``) the first pass tees its
  chunks to disk and later passes stream the shards at IO speed:
  ``decoded`` shards hold the host pixels, ``device`` shards the same
  pixels padded and dtype-final, copied to the card as they are.  A pass
  that tees a snapshot, or re-decodes after a corrupt shard, decodes on the
  host even under ``decode_mode="device"``; device decode with a *decoded*
  snapshot is refused, counted ``snapshot_mode_unsupported``.  A corrupt
  shard falls back to live decode (``snapshot_fallback``), which re-checks
  the prefix the consumer already received and raises
  :class:`SnapshotFallbackDivergence` rather than scramble ordinals.
* the **consumer** iterates :class:`StreamBatch` chunks in emission order;
  each carries the global image ordinals (``indices``, decode-survival
  order) and member ``names``.  On a CUDA device every chunk leaves the
  ring into pinned host buffers and a ``non_blocking`` copy on the stream's
  own copy stream, two chunks in flight: chunk *i+1* crosses while the
  consumer works on chunk *i*, whose stream waits on the copy's event
  first.  On the CPU the chunk's arrays are used in place.  A producer
  exception re-raises in the consumer, never as a silent end of stream;
  leaving the ``with`` block stops the producer, and ``join()`` proves
  every thread and worker process exited.

Events are counted in ``core.resilience.counters`` under the JAX
package's names (``corrupt_image``, ``decode_worker_respawn``,
``decode_worker_lost``, ``jpeg_corrupt_entropy``, ``device_decode_fallback``
and ``device_decode_fallback_<reason>``, ``snapshot_stale``,
``snapshot_fallback``, ``snapshot_write_failed``,
``snapshot_mode_unsupported``, ``snapshot_fallback_divergence``).  With
tracing on (``core.trace``) the stream records the JAX package's spans:
``ingest.produce``, ``ingest.snapshot_read`` and
``ingest.spawn_decode_procs`` on the producer lane, ``ingest.decode`` /
``ingest.entropy_decode`` per member on the decode lanes,
``snapshot.write_shard`` per teed shard, ``ingest.ring_put`` (its length
is the backpressure stall), ``ingest.ring_get`` and ``ingest.consume`` on
the consumer lane; each chunk boundary publishes the ``ingest_*`` gauges.
With the numerics observatory on, each chunk's featurize output is a probe
site named by its tar members.  The environment knobs are read by
:meth:`StreamConfig.from_env`.

The :class:`StreamConfig` is live: the producer reads the decode window
per member, the backend per member and the ring bound per put, so a
mutation retunes the running stream.  That is the surface of the
closed-loop autotuner (``core.optimize.IngestAutotuner``;
``StreamConfig.autotune`` / ``KEYSTONE_AUTOTUNE=1``, or ``tuner=``), which
reads the stall counters at every chunk boundary.  Retuning changes
concurrency and buffering only: the stream's output is bit-identical at
any knob trajectory.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import logging
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FutureTimeout
from typing import Callable

import numpy as np
import torch

from ..loaders import image_loaders, native_decode
from ..ops import jpeg_device as jdev
from . import numerics as knum
from . import profiler as kprof
from . import snapshot as ksnap
from . import telemetry, trace
from .decode_workers import ProcessDecodePool, ShmArray
from .resilience import counters

_logger = logging.getLogger(__name__)

#: Process-unique sequence of the streams' ``/statusz`` provider names.
_stream_seq = itertools.count()

#: Assembled chunks the ring holds before the producer blocks.
DEFAULT_RING_CAPACITY = 4

#: Chunks whose host-to-device copy is in flight on a CUDA stream: the one
#: the consumer works on and the next, whose copy overlaps that work.
DEVICE_BUFFERS = 2

#: Host decode backends: the thread pool, or spawned worker processes that
#: return pixels in shared memory.
DECODE_BACKENDS = ("thread", "process")

#: Where pixels are born: ``host`` (full decode on the host) or ``device``
#: (entropy pass on the host, the rest on the card).
DECODE_MODES = ("host", "device")

#: Every blocking wait polls at this period, so stop flags are observed and
#: a ``resilience.deadline`` interrupts a hung stream.
_POLL_SECONDS = 0.05

#: How long ``close`` waits for the producer to stop its decode pools (a
#: process pool's shutdown escalates to a kill within a few seconds).
_CLOSE_SECONDS = 30.0


def _env_flag(name: str) -> bool:
    return os.environ.get(name, "").strip() in ("1", "true", "on", "yes")


def ring_capacity() -> int:
    """Ring depth: ``KEYSTONE_RING_CAPACITY`` or the default."""
    return image_loaders.env_int("KEYSTONE_RING_CAPACITY", DEFAULT_RING_CAPACITY, 1)


def decode_backend_env() -> str:
    """``KEYSTONE_DECODE_BACKEND``: ``thread`` (default) or ``process``."""
    raw = os.environ.get("KEYSTONE_DECODE_BACKEND", "").strip() or "thread"
    if raw not in DECODE_BACKENDS:
        raise ValueError(f"KEYSTONE_DECODE_BACKEND={raw!r} must be one of {DECODE_BACKENDS}")
    return raw


def decode_mode_env() -> str:
    """``KEYSTONE_DEVICE_DECODE``: ``1`` (or ``device``) turns on device
    decode; default ``host``."""
    raw = os.environ.get("KEYSTONE_DEVICE_DECODE", "").strip().lower()
    if raw in ("", "0", "off", "false", "host"):
        return "host"
    if raw in ("1", "on", "true", "device", "yes"):
        return "device"
    raise ValueError(f"KEYSTONE_DEVICE_DECODE={raw!r} must be 0/1 (or host/device)")


@dataclasses.dataclass
class StreamConfig:
    """The live knobs of one stream: they change concurrency, buffering and
    where the bytes come from, never the order or content of what the
    stream yields.  The stream reads them at every decision point, so a
    mutation retunes it mid-run.

    ``decode_threads`` is the number of decodes kept in flight (the
    effective pool width); ``max_decode_threads`` caps how far a tuner may
    raise it (the thread pool is created at the cap, 0 resolves to the
    host cores or the width, whichever is larger)."""

    decode_threads: int = dataclasses.field(default_factory=image_loaders.decode_threads)
    decode_ahead: int = dataclasses.field(default_factory=image_loaders.decode_ahead)
    ring_capacity: int = DEFAULT_RING_CAPACITY
    max_decode_threads: int = 0
    #: Attach a ``core.optimize.IngestAutotuner`` to the stream.
    autotune: bool = False
    #: Chunks between the controller's evaluations.
    autotune_interval: int = 4
    #: Host decode backend (:data:`DECODE_BACKENDS`); device decode's
    #: entropy pass runs on the thread pool whatever this says.
    decode_backend: str = "thread"
    #: Process-backend workers; 0 resolves to ``decode_threads``.
    decode_procs: int = 0
    decode_mode: str = "host"
    #: Snapshot root (``core.snapshot``); None turns snapshots off.
    snapshot_dir: str | None = None
    #: ``decoded`` or ``device`` shards in the stream; ``featurized`` is
    #: the workload helpers' (``fv_common.stream_features_snapshot``).
    snapshot_mode: str = "decoded"
    #: Key material for what selects the members (a ``keep`` filter's
    #: label file): a stream with a ``keep`` filter and no extra writes no
    #: snapshot, since different filters would share a key.
    snapshot_extra: str | None = None

    def __post_init__(self):
        if self.decode_threads < 1:
            raise ValueError(f"decode_threads must be >= 1, got {self.decode_threads}")
        if self.decode_ahead < 0:
            raise ValueError(f"decode_ahead must be >= 0, got {self.decode_ahead}")
        if self.ring_capacity < 1:
            raise ValueError(f"ring_capacity must be >= 1, got {self.ring_capacity}")
        if self.autotune_interval < 1:
            raise ValueError(f"autotune_interval must be >= 1, got {self.autotune_interval}")
        if self.decode_backend not in DECODE_BACKENDS:
            raise ValueError(
                f"decode_backend={self.decode_backend!r} must be one of {DECODE_BACKENDS}"
            )
        if self.decode_procs < 0:
            raise ValueError(f"decode_procs must be >= 0, got {self.decode_procs}")
        if self.decode_procs == 0:
            self.decode_procs = self.decode_threads
        if self.decode_mode not in DECODE_MODES:
            raise ValueError(
                f"decode_mode={self.decode_mode!r} must be one of {DECODE_MODES}"
            )
        if self.snapshot_mode not in ksnap.MODES:
            raise ValueError(
                f"snapshot_mode={self.snapshot_mode!r} must be one of {ksnap.MODES}"
            )
        if self.max_decode_threads == 0:
            self.max_decode_threads = max(self.decode_threads, image_loaders.host_cores())
        elif self.max_decode_threads < self.decode_threads:
            # An explicit cap below the width is a contradiction, never
            # silently widened past the caller's bound.
            raise ValueError(
                f"max_decode_threads={self.max_decode_threads} is below "
                f"decode_threads={self.decode_threads}"
            )

    @classmethod
    def from_env(cls, **overrides) -> "StreamConfig":
        """The environment's knobs (``KEYSTONE_DECODE_THREADS``,
        ``KEYSTONE_DECODE_AHEAD``, ``KEYSTONE_RING_CAPACITY``,
        ``KEYSTONE_DECODE_BACKEND``, ``KEYSTONE_DECODE_PROCS``,
        ``KEYSTONE_DEVICE_DECODE``, ``KEYSTONE_SNAPSHOT_DIR``,
        ``KEYSTONE_SNAPSHOT_MODE``, ``KEYSTONE_AUTOTUNE``,
        ``KEYSTONE_AUTOTUNE_INTERVAL``), each overridden by a keyword that
        is not None.  They are only the initial values of a live config."""
        cfg = {
            "decode_threads": image_loaders.decode_threads(),
            "decode_ahead": image_loaders.decode_ahead(),
            "ring_capacity": ring_capacity(),
            "autotune": _env_flag("KEYSTONE_AUTOTUNE"),
            "autotune_interval": image_loaders.env_int("KEYSTONE_AUTOTUNE_INTERVAL", 4, 1),
            "decode_backend": decode_backend_env(),
            "decode_procs": image_loaders.env_int("KEYSTONE_DECODE_PROCS", 0, 0),
            "decode_mode": decode_mode_env(),
            "snapshot_dir": ksnap.snapshot_dir_env(),
            "snapshot_mode": ksnap.snapshot_mode_env(),
        }
        cfg.update({k: v for k, v in overrides.items() if v is not None})
        return cls(**cfg)

    def window(self) -> int:
        """In-flight decode window: pool width + decode-ahead."""
        return max(1, self.decode_threads) + max(0, self.decode_ahead)

    def record(self) -> dict:
        return dataclasses.asdict(self)


class _Cancelled(Exception):
    """Internal: the consumer stopped the stream — unwind the producer."""


class SnapshotFallbackDivergence(RuntimeError):
    """The live re-decode behind a corrupt-shard fallback stopped matching
    the chunks the consumer already received from the snapshot (a counted
    skip in one pass shifted the survivors).  Going on would give the same
    ordinals to different images, so the stream dies typed (and counted,
    ``snapshot_fallback_divergence``)."""


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
    host (``_FallbackPixels``), a damaged scan comes back as
    ``_CorruptEntropy``, and an image under ``MIN_DIM`` as None, the host
    decoder's reject rule."""
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

    def arrays(self) -> tuple:
        return (*self.coeffs, self.qt)


class _PinnedCopier:
    """Host-to-device copies of one CUDA stream's chunks: each host array is
    staged into a pinned buffer and copied ``non_blocking`` on a dedicated
    copy stream, with one event per chunk.

    A pinned buffer is reused only once the event of the copy that last
    read it has completed.  The device tensors are allocated on the copy
    stream; the consumer's stream waits on the chunk's event and records
    itself on each tensor (:meth:`StreamBatch.device_arrays`), so the
    caching allocator hands no block out before the consumer's work on it
    is done."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self._slots: list = []  # [pinned uint8 tensor, event of its last copy]

    def _slot(self, nbytes: int, taken: set) -> list:
        fits = [s for s in self._slots if id(s) not in taken and s[0].numel() >= nbytes]
        for slot in fits:
            if slot[1] is None or slot[1].query():
                return slot
        if fits:  # every buffer that fits is still being read: wait for one
            fits[0][1].synchronize()
            return fits[0]
        slot = [torch.empty(nbytes, dtype=torch.uint8, pin_memory=True), None]
        self._slots.append(slot)
        return slot

    def copy(self, arrays) -> tuple:
        """``(device tensors, event)`` for the host ``arrays``: each copied
        once into a pinned buffer (no cast), then to the card on the copy
        stream."""
        taken: set = set()
        slots, out = [], []
        with torch.cuda.stream(self.stream):
            for a in arrays:
                a = np.ascontiguousarray(a)
                slot = self._slot(a.nbytes, taken)
                taken.add(id(slot))
                slots.append(slot)
                dtype = torch.from_numpy(np.empty(0, a.dtype)).dtype
                host = slot[0][: a.nbytes].view(dtype).view(a.shape)
                host.numpy()[...] = a
                out.append(host.to(self.device, non_blocking=True))
            event = torch.cuda.Event()
            event.record(self.stream)
        for slot in slots:
            slot[1] = event
        return tuple(out), event


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
    #: (device tensors, event or None) once the stream copied the chunk
    staged: tuple | None = None

    @property
    def shape(self) -> tuple:
        """The bucket key: per-image (H, W)."""
        if self.coeff is not None:
            return (self.coeff.geom.height, self.coeff.geom.width)
        return tuple(self.host.shape[1:3])

    def __len__(self) -> int:
        return len(self.names)

    def host_arrays(self) -> tuple:
        """What crosses to the device: the pixels, or the coefficients and
        quant tables."""
        return self.coeff.arrays() if self.coeff is not None else (self.host,)

    def device_arrays(self) -> tuple:
        """:meth:`host_arrays` on :attr:`device`: on a CUDA device the
        stream's copies, once the current stream waited on their event; on
        the CPU the host arrays themselves."""
        if self.staged is not None:
            tensors, event = self.staged
            if event is not None:
                consumer = torch.cuda.current_stream(self.device)
                consumer.wait_event(event)
                for t in tensors:
                    t.record_stream(consumer)
                self.staged = (tensors, None)
            return tensors
        if self.device.type != "cpu":
            raise RuntimeError(
                f"chunk {self.index} was never copied to {self.device}: chunks reach a "
                "card only through the stream's pinned copies"
            )
        arrays = self.host_arrays()
        return tuple(torch.from_numpy(a) for a in arrays)

    def dev(self) -> torch.Tensor:
        """The pixel batch on the stream's device (decoded there for
        coefficient chunks)."""
        arrays = self.device_arrays()
        if self.coeff is not None:
            return jdev.decode_batch(self.coeff.geom, arrays[:-1], arrays[-1], self.device)
        return arrays[0]

    def apply(self, transform):
        """``transform(pixels)`` for this chunk; for coefficient chunks the
        pixels are decoded on the device first, admitted and attributed by
        :func:`~..ops.jpeg_device.fused_apply`.  With the profiler on, a
        pixel chunk's featurize is attributed to the ledger
        (``core.profiler.attributed_call``) with the transform's stated
        cost where it has one (``launch_cost``)."""
        if self.coeff is not None:
            arrays = self.device_arrays()
            out = jdev.fused_apply(
                transform, self.coeff.geom, arrays[:-1], arrays[-1], self.device
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
    ring_capacity: int = 0
    ring_max_depth: int = 0  #: most chunks queued in the ring at once
    producer_stalls: int = 0  #: puts that blocked on a full ring (backpressure)
    consumer_stalls: int = 0  #: gets that found the ring empty (decode-bound)
    #: what decoded the live pass: "thread" or "process" (host pixels) or
    #: "device" (entropy pass on the host); "" when a snapshot served it all
    decoder: str = ""
    #: the host pixel decoder of the live pass: "native" (libjpeg) or "pil"
    host_decoder: str = ""
    snapshot_chunks_read: int = 0  #: chunks served from a snapshot
    snapshot_chunks_written: int = 0  #: chunks teed into a snapshot writer
    worker_respawns: int = 0  #: process-backend workers respawned
    entropy_decoded: int = 0  #: images entropy-decoded (device mode)
    entropy_backend: str = ""  #: scan loop backend ("native"/"python")
    entropy_corrupt: int = 0  #: damaged scans skipped
    device_fallbacks: int = 0  #: JPEGs decoded on the host instead
    coeff_bytes: int = 0  #: int16 coefficient bytes carried by the ring
    snapshot_dma_bytes: int = 0  #: device-format shard bytes served to the copy
    h2d_bytes: int = 0  #: bytes copied to the card from pinned buffers
    decode_seconds: float = 0.0  #: host decode time summed over the pool's workers

    def record(self) -> dict:
        return dataclasses.asdict(self)


class _Ring:
    """Bounded FIFO between the producer thread and the consumer.  Every
    wait polls at ``_POLL_SECONDS``, so the consumer's thread stays
    interruptible and the producer observes :meth:`stop`.  The producer
    ends the stream with :meth:`close` (after :meth:`fail` when it
    raised); the error re-raises on the consumer's next :meth:`get`."""

    _END = object()

    def __init__(self, config: StreamConfig, stats: StreamStats):
        self._q: collections.deque = collections.deque()
        self._cond = threading.Condition()
        self._config = config  # its ring_capacity is read at every put
        self._stats = stats
        self._closed = False
        self._stopped = False
        self._error: BaseException | None = None

    @property
    def stopped(self) -> bool:
        return self._stopped

    def depth(self) -> int:
        with self._cond:
            return len(self._q)

    def put(self, item) -> bool:
        """Blocks while full; False when the consumer stopped the stream."""
        with self._cond:
            stalled = False
            while len(self._q) >= self._config.ring_capacity and not self._stopped:
                if not stalled:
                    self._stats.producer_stalls += 1
                    stalled = True
                self._cond.wait(_POLL_SECONDS)
            if self._stopped:
                return False
            self._q.append(item)
            self._stats.ring_max_depth = max(self._stats.ring_max_depth, len(self._q))
            self._cond.notify_all()
            return True

    def get(self):
        """The next chunk, ``_Ring._END`` at end of stream; re-raises a
        producer failure."""
        with self._cond:
            stalled = False
            while True:
                if self._q:
                    item = self._q.popleft()
                    self._cond.notify_all()
                    return item
                if self._error is not None:
                    err, self._error = self._error, None
                    raise err
                if self._closed or self._stopped:
                    return self._END
                if not stalled:
                    self._stats.consumer_stalls += 1
                    stalled = True
                self._cond.wait(_POLL_SECONDS)

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def fail(self, error: BaseException) -> None:
        with self._cond:
            self._error = error
            self._closed = True
            self._cond.notify_all()

    def stop(self) -> None:
        with self._cond:
            self._stopped = True
            self._cond.notify_all()


class IngestStream:
    """The streaming pipeline: iterate to consume, ``with`` (or ``close``)
    to guarantee shutdown, ``join()`` to assert no thread or process
    leaked."""

    def __init__(
        self,
        path: str,
        batch_size: int,
        *,
        keep: Callable[[str], bool] | None = None,
        config: StreamConfig | None = None,
        device="cuda",
        tuner=None,
        num_threads: int | None = None,
        decode_ahead_slots: int | None = None,
        capacity: int | None = None,
    ):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self._path = path
        self._batch_size = batch_size
        self._keep = keep
        # The config object is shared with the caller and the tuner: a
        # mutation retunes the running stream.  The per-stream keywords
        # override its initial values, under the same validation.
        if config is None:
            config = StreamConfig.from_env(
                decode_threads=num_threads, decode_ahead=decode_ahead_slots,
                ring_capacity=capacity,
            )
        elif (num_threads, decode_ahead_slots, capacity) != (None, None, None):
            if num_threads is not None:
                config.decode_threads = num_threads
                config.max_decode_threads = max(config.max_decode_threads, num_threads)
            if decode_ahead_slots is not None:
                config.decode_ahead = decode_ahead_slots
            if capacity is not None:
                config.ring_capacity = capacity
            config.__post_init__()
        self.config = config
        self.device = torch.device(device)
        self.stats = StreamStats(ring_capacity=self.config.ring_capacity)
        self._ring = _Ring(self.config, self.stats)
        self._copier = _PinnedCopier(self.device) if self.device.type == "cuda" else None
        self._workers: list[threading.Thread] = []
        self._pool: ThreadPoolExecutor | None = None
        self._proc_pool: ProcessDecodePool | None = None
        self._writer = None  #: core.snapshot.SnapshotWriter while teeing
        self._skip_chunks = 0
        #: (names, indices) of each chunk a snapshot served before a corrupt
        #: shard forced the live fallback: what the re-decode must reproduce
        self._served_prefix: list = []
        self._chunk_counter = 0
        self.tuner = tuner
        if self.tuner is None and self.config.autotune:
            # optimize imports this module: the reverse edge resolves only
            # when a stream autotunes.
            from .optimize import IngestAutotuner

            self.tuner = IngestAutotuner()
        if self.tuner is not None:
            self.tuner.attach(self)
        _logger.info(
            "streaming ingest %s: batch=%d threads=%d ahead=%d ring=%d mode=%s backend=%s "
            "snapshot=%s autotune=%s",
            path, batch_size, self.config.decode_threads, self.config.decode_ahead,
            self.config.ring_capacity, self.config.decode_mode, self.config.decode_backend,
            self.config.snapshot_dir and self.config.snapshot_mode, bool(self.tuner),
        )
        # The stream's live state on the /statusz page, one row per stream.
        self._statusz_name = f"stream:{os.path.basename(path)}#{next(_stream_seq)}"
        self._statusz_provider = lambda: {
            "path": path, "batch_size": batch_size, **self.stats.record()}
        telemetry.register_statusz(self._statusz_name, self._statusz_provider)
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
            clean = self._run_producer()
        except BaseException as e:  # noqa: BLE001 — re-raised by the consumer
            self._ring.fail(e)
        finally:
            self._ring.close()
            if self._writer is not None:
                # A no-op after a commit; a cancelled or failed pass leaves
                # no partial snapshot behind.
                self._writer.abort()
            if self._pool is not None:
                self._pool.shutdown(wait=clean, cancel_futures=not clean)
            if self._proc_pool is not None:
                self._proc_pool.shutdown(clean)

    def _snapshot_plan(self):
        """``(root, key, mode)`` when the stream's snapshot tier applies:
        ``decoded`` or ``device`` shards (``featurized`` is the workload
        helpers').  Device decode with a decoded snapshot is refused,
        counted: the cached host pixels are not the pixels a device decode
        gives, so serving them would change the stream's bits."""
        cfg = self.config
        if not cfg.snapshot_dir or cfg.snapshot_mode not in ("decoded", "device"):
            return None
        if cfg.decode_mode == "device" and cfg.snapshot_mode == "decoded":
            counters.record(
                "snapshot_mode_unsupported",
                f"{self._path}: decoded-pixel snapshots do not compose with device decode "
                "(different IDCT rounding) — use snapshot_mode='device' for a DMA-format cache",
            )
            return None
        if self._keep is not None and cfg.snapshot_extra is None:
            _logger.warning(
                "snapshot cache disabled for %s: the stream has a keep filter but no "
                "snapshot_extra key material — an unkeyed filter would alias different "
                "member subsets", self._path,
            )
            return None
        key = ksnap.snapshot_key(
            self._path, batch_size=self._batch_size, mode=cfg.snapshot_mode,
            extra=cfg.snapshot_extra,
        )
        return cfg.snapshot_dir, key, cfg.snapshot_mode

    def _run_producer(self) -> bool:
        """Produce the chunks: from a valid snapshot, else by live decode
        (teeing a fresh snapshot when the tier applies).  True at a clean
        end of stream, False when the consumer cancelled."""
        plan = self._snapshot_plan()
        skip = 0
        if plan is not None:
            root, key, snap_mode = plan
            snap, reason = ksnap.lookup(root, key, tar_path=self._path, mode=snap_mode)
            if reason == "stale":
                counters.record(
                    "snapshot_stale",
                    f"{self._path}: committed snapshot exists under a different key (input "
                    "or decode config moved) — live decode, fresh snapshot written",
                )
            if snap is not None:
                try:
                    emitted = self._emit_from_snapshot(snap)
                except _Cancelled:
                    return False
                if emitted is True:
                    return True
                # A corrupt shard after `emitted` chunks: those were
                # hash-checked, so re-decode from the top, suppress that
                # prefix, and rewrite the snapshot.
                skip = emitted
                counters.record(
                    "snapshot_fallback",
                    f"{snap.path}: corrupt shard after {skip} chunk(s) — falling back to "
                    "live decode (bit-equal), rewriting",
                )
                trace.instant("snapshot_fallback", path=snap.path, emitted=skip)
            try:
                self._writer = ksnap.SnapshotWriter(
                    root, key, mode=snap_mode,
                    meta={"tar": ksnap.tar_identity(self._path), "path": self._path,
                          "batch_size": self._batch_size, "extra": self.config.snapshot_extra},
                )
            except (OSError, ksnap.SnapshotError) as e:
                # An unusable snapshot root never kills a live stream.
                counters.record(
                    "snapshot_write_failed", f"{self._path}: cannot open snapshot writer: {e}"
                )
        try:
            self._produce_live(skip)
        except _Cancelled:
            return False
        if self._writer is not None:
            try:
                self._writer.commit()
            except (OSError, ksnap.SnapshotError) as e:
                # Every chunk reached the consumer: a failed commit loses
                # only the cache.
                counters.record("snapshot_write_failed", f"{self._path}: commit failed: {e}")
                self._writer.abort()
        return True

    def _emit_from_snapshot(self, snap) -> bool | int:
        """Stream a committed snapshot's chunks into the ring.  True when the
        whole snapshot streamed; the count of chunks already emitted when a
        corrupt shard forces the live fallback."""
        emitted = images = 0
        served: list = []
        with trace.span(
            "ingest.snapshot_read", cat="ingest", path=snap.path,
            chunks=len(snap.manifest["chunks"]),
        ) as sp:
            try:
                for _entry, arrays in snap.iter_chunks():
                    if self._ring.stopped:
                        raise _Cancelled()
                    payload = arrays["payload"]
                    if snap.mode == "device":
                        # Dtype-final f32, padded: the valid rows are a view,
                        # copied to the card as they are.
                        self.stats.snapshot_dma_bytes += int(payload.nbytes)
                        valid = int(arrays.get("valid", len(payload)))
                        payload = payload[:valid]
                    chunk = StreamBatch(
                        index=self._chunk_counter,
                        indices=np.asarray(arrays["indices"], np.int64),
                        names=[str(n) for n in arrays["names"].tolist()],
                        host=payload, device=self.device,
                    )
                    self._chunk_counter += 1
                    self._put(chunk)
                    self.stats.decoded += len(chunk)
                    self.stats.snapshot_chunks_read += 1
                    emitted += 1
                    images += len(chunk)
                    served.append((chunk.names, chunk.indices))
            except ksnap.SnapshotCorrupt as e:
                sp.set(fallback_after=emitted, corrupt=str(e)[:200])
                # The fallback re-decodes and re-counts from the top.
                self.stats.decoded -= images
                self._chunk_counter = 0
                self._served_prefix = served
                return emitted
            sp.set(chunks_read=emitted, images=images)
        return True

    def _ensure_thread_pool(self) -> ThreadPoolExecutor:
        # Sized at the retune ceiling: the effective width is the in-flight
        # window (config.decode_threads), read per member, so a tuner
        # widens or narrows decode without rebuilding the pool.
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=self.config.max_decode_threads,
                thread_name_prefix="keystone-decode",
                initializer=self._register_worker,
            )
        return self._pool

    def _ensure_proc_pool(self) -> ProcessDecodePool:
        if self._proc_pool is None:
            with trace.span("ingest.spawn_decode_procs", cat="ingest",
                            procs=self.config.decode_procs):
                self._proc_pool = ProcessDecodePool(
                    self.config.decode_procs, on_respawn=self._count_respawn
                )
            _logger.info("process decode backend: %d spawned worker(s)",
                         self.config.decode_procs)
            self.stats.decoder = "process"
        return self._proc_pool

    def _count_respawn(self) -> None:
        self.stats.worker_respawns += 1

    def _produce_live(self, skip_chunks: int = 0):
        self._skip_chunks = skip_chunks
        # A pass that tees a snapshot, or re-decodes after a corrupt shard,
        # decodes on the host: the writer stores host pixels, and the prefix
        # check compares pixel chunks.
        device_mode = (
            self.config.decode_mode == "device" and self._writer is None and skip_chunks == 0
        )
        if device_mode:
            # Build the native scan loop before the pool spins up, and
            # record which backend this pass runs.
            self.stats.entropy_backend = jdev.entropy_backend()
            task, span_name = _entropy_decode_task, "ingest.entropy_decode"
            self.stats.decoder = "device"
        else:
            self.stats.host_decoder = "native" if native_decode.available() else "pil"
            task, span_name = image_loaders.decode_image, "ingest.decode"
            self.stats.decoder = self.config.decode_backend

        def submit(name, data):
            # The backend is read per member: a tuner may promote a running
            # stream to process decode; both kinds of future drain through
            # the same in-order window.
            if not device_mode and self.config.decode_backend == "process":
                return self._ensure_proc_pool().submit(name, data)
            return self._ensure_thread_pool().submit(_timed, task, data, name, span_name)

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
                # "corrupt_image", or the process backend's
                # "decode_worker_lost" (a member that kept killing workers).
                counters.record(getattr(fut, "skip_reason", None) or "corrupt_image", name)
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
                    window.append((name, submit(name, data)))
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
            # np.stack copies straight out of the process backend's shared
            # memory; each block is released once the chunk owns its pixels.
            host = np.stack([i.arr if isinstance(i, ShmArray) else i for i in imgs])
            for i in imgs:
                if isinstance(i, ShmArray):
                    i.release()
            coeff = None
        chunk = StreamBatch(
            index=self._chunk_counter, indices=np.asarray(idx, np.int64),
            names=names, host=host, device=self.device, coeff=coeff,
        )
        self._chunk_counter += 1
        if self._writer is not None:
            try:
                # pad_to pads device-format shards only.
                self._writer.add_chunk(chunk.index, chunk.indices, chunk.names, chunk.host,
                                       pad_to=self._batch_size)
                self.stats.snapshot_chunks_written += 1
            except (OSError, ksnap.SnapshotError) as e:
                # The cache is an optimisation: a failed shard write drops
                # the writer, counted, and the pass goes on.
                counters.record("snapshot_write_failed", f"{self._path}: {e}")
                self._writer.abort()
                self._writer = None
        if chunk.index < self._skip_chunks:
            # The fallback re-decode of a prefix the snapshot already served:
            # rewritten above, not emitted again, provided it reproduces the
            # served chunk exactly (the consumer scatters rows by ordinal).
            names, indices = self._served_prefix[chunk.index]
            if chunk.names != names or not np.array_equal(chunk.indices, indices):
                counters.record(
                    "snapshot_fallback_divergence",
                    f"{self._path}: live re-decode chunk {chunk.index} != snapshot prefix "
                    "already served",
                )
                raise SnapshotFallbackDivergence(
                    f"{self._path}: chunk {chunk.index} of the fallback re-decode does not "
                    "match the snapshot prefix the consumer already received (survivor "
                    "sequences diverged — see the counted skip that shifted them)"
                )
            return
        self._put(chunk)

    def _put(self, chunk: StreamBatch) -> None:
        attrs = {"coeff_bytes": chunk.coeff.nbytes()} if chunk.coeff is not None else {}
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

    def _publish_metrics(self) -> None:
        """Chunk-boundary gauges of the stream, read by dashboards and
        ``core.telemetry``."""
        m = trace.metrics
        st = self.stats
        m.gauge("ingest_ring_depth", self._ring.depth())
        m.gauge("ingest_decode_threads", self.config.decode_threads)
        m.gauge("ingest_decode_ahead", self.config.decode_ahead)
        m.gauge("ingest_ring_capacity", self.config.ring_capacity)
        m.gauge("ingest_producer_stalls", st.producer_stalls)
        m.gauge("ingest_consumer_stalls", st.consumer_stalls)
        m.gauge("ingest_decoded", st.decoded)
        m.gauge("ingest_snapshot_chunks_read", st.snapshot_chunks_read)
        m.gauge("ingest_worker_respawns", st.worker_respawns)
        m.gauge("ingest_entropy_decoded", st.entropy_decoded)
        m.gauge("ingest_entropy_native", 1 if st.entropy_backend == "native" else 0)
        m.gauge("ingest_coeff_bytes", st.coeff_bytes)
        m.gauge("ingest_device_fallbacks", st.device_fallbacks)
        m.gauge("ingest_snapshot_dma_bytes", st.snapshot_dma_bytes)

    def _drain(self):
        pending: collections.deque = collections.deque()
        try:
            while True:
                with trace.span("ingest.ring_get", cat="ingest"):
                    item = self._ring.get()
                if item is _Ring._END:
                    break
                if self._copier is not None:
                    # The copy starts now, on the copy stream, and overlaps
                    # the consumer's work on the chunk before this one.
                    arrays = item.host_arrays()
                    item.staged = self._copier.copy(arrays)
                    self.stats.h2d_bytes += sum(int(a.nbytes) for a in arrays)
                self._publish_metrics()
                if self.tuner is not None:
                    # Chunk boundary: the controller reads the stall counts
                    # and may retune the config.
                    self.tuner.on_chunk(self)
                pending.append(item)
                if len(pending) >= DEVICE_BUFFERS:
                    yield from self._consume(pending.popleft())
            while pending:
                yield from self._consume(pending.popleft())
        finally:
            self.close()

    @staticmethod
    def _consume(item):
        # The consume span runs from the consumer receiving the chunk until
        # it asks for the next one: its work on THAT chunk.  Decode spans
        # inside its interval are the overlap.
        with trace.span("ingest.consume", cat="ingest", index=item.index, images=len(item)):
            yield item

    def __iter__(self):
        return self

    def __next__(self) -> StreamBatch:
        return next(self._iter)

    def __enter__(self) -> "IngestStream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        """Stop the producer and wait for it to shut its decode pools down,
        so no worker process outlives the stream.  Idempotent; called on a
        consumer exception and on leaving the ``with`` block.  A hung
        decode thread is abandoned, not waited for (``join`` says whether
        every thread exited)."""
        telemetry.unregister_statusz(self._statusz_name, self._statusz_provider)
        self._ring.stop()
        try:
            self._iter.close()
        except ValueError:  # closed from inside the running generator
            pass
        if threading.current_thread() is not self._thread:
            self._thread.join(_CLOSE_SECONDS)

    def join(self, timeout: float = 10.0) -> bool:
        """Wait for the producer, every decode thread and every decode
        worker process; True when none is left alive."""
        end = time.monotonic() + timeout
        self._thread.join(max(0.0, end - time.monotonic()))
        for t in list(self._workers):
            t.join(max(0.0, end - time.monotonic()))
        procs_ok = True
        if self._proc_pool is not None:
            while not self._proc_pool.joined() and time.monotonic() < end:
                time.sleep(_POLL_SECONDS / 5)
            procs_ok = self._proc_pool.joined()
        return procs_ok and not (
            self._thread.is_alive() or any(t.is_alive() for t in self._workers)
        )


def stream_batches(
    path: str,
    batch_size: int,
    *,
    keep: Callable[[str], bool] | None = None,
    config: StreamConfig | None = None,
    device="cuda",
    tuner=None,
    num_threads: int | None = None,
    decode_ahead_slots: int | None = None,
    capacity: int | None = None,
) -> IngestStream:
    """Stream shape-bucketed chunks of ``batch_size`` images from a tar (or
    a directory of tars).  ``keep`` filters member names before decode;
    ``config`` holds the knobs (:meth:`StreamConfig.from_env` when None);
    ``device`` is where :meth:`StreamBatch.dev` / :meth:`StreamBatch.apply`
    put the pixels; ``tuner`` is an explicit controller (anything with
    ``attach(stream)`` and ``on_chunk(stream)``), else one is made when
    ``config.autotune`` is set; ``num_threads``, ``decode_ahead_slots`` and
    ``capacity`` override the config's initial values.  Use it as a
    context manager (or iterate to the end) so the threads and worker
    processes are released, and ``join()`` to assert they exited."""
    return IngestStream(path, batch_size, keep=keep, config=config, device=device,
                        tuner=tuner, num_threads=num_threads,
                        decode_ahead_slots=decode_ahead_slots, capacity=capacity)


def host_shards(paths, rank: int | None = None, world: int | None = None):
    """This process's slice of a tar-shard list: round-robin
    (``paths[rank::world]``) over the SORTED names, so every member of a
    process group derives a disjoint cover of the dataset from the same
    listing with no coordination.  ``rank``/``world`` default from the
    live process group (``parallel.distributed``) and collapse to
    "everything" single-process.  Each process then streams its own shards
    through :func:`stream_batches`; no bytes cross processes at ingest."""
    paths = sorted(str(p) for p in paths)
    if rank is None or world is None:
        from ..parallel import distributed as kdist

        rank = kdist.process_index() if rank is None else rank
        world = kdist.process_count() if world is None else world
    if world <= 1:
        return paths
    if not (0 <= rank < world):
        raise ValueError(f"rank {rank} outside world {world}")
    return paths[rank::world]
