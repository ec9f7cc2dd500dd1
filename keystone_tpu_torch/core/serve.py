"""Low-latency serving (counterpart of keystone_tpu/core/serve.py):
bucketed CUDA-graph inference, dynamic request batching, and online SLO
observability.

The JAX package compiles the fitted apply chain into one AOT executable per
batch bucket.  PyTorch compiles nothing; what it has instead, and what pays
at a served batch where the host's per-launch work outweighs every kernel,
is a CUDA graph.  Three pieces, with the reference's names, knobs, typed
errors, counters, span names and record keys:

* **Bucketed CUDA graphs** (:class:`ServingEngine`) — on the card each
  **batch bucket** is one ``torch.cuda.CUDAGraph``: a static input
  ``[bucket, *example_shape]`` is allocated, the fitted chain is warmed up
  once on the engine's own stream (hand kernels built, cuFFT plans made,
  cuDNN algorithms fixed, host-built constants copied once and kept:
  ``utils.platform.retained_constants``), then ``pipe(static_in)`` is
  captured (``capture_error_mode="thread_local"``, one capture in the
  process at a time, so other engines keep serving).  A micro-batch is
  copied into the static input on the engine's stream, replayed, its
  output copied out before the next replay, and the pad rows sliced off.
  A bucket whose capture fails raises :class:`ServeError`; it is never
  served eagerly instead.  On the CPU (``device="cpu"``) a bucket is the
  eager chain at that batch.  Every bucket still preflights through
  ``core.memory.plan_program`` (``require_analysis=True``); a denied
  bucket above the floor is dropped (``serve_bucket_denied``), and on the
  card the bytes a capture took (the allocator's allocated and reserved
  bytes before and after) are the plan's ``reported`` footprint, which
  ``core.frontend``'s cross-engine admission charges.  ``donate`` is
  recorded and has no effect here.  :func:`load_engine` measures the cold
  start: restore, per-bucket build and capture (``compile_seconds``),
  warmup.
* **Dynamic request batcher** (:class:`Server`) — the reference's: an
  assembler thread collects requests into bucket-sized micro-batches (full
  largest bucket, the oldest request's ``max_wait_ms`` deadline, or an
  idle device pipeline), pads the remainder and copies it to the card
  (staged through pinned memory on the engine's copy stream) while an
  executor thread replays the previous micro-batch; answers go out in
  arrival order, :data:`INFLIGHT_BATCHES` micro-batches in flight.
* **Observability + typed failure** — request ids minted at ``submit``,
  the ``serve.*`` spans and the per-phase latency decomposition
  (``ServeFuture.phases``, :func:`phase_breakdown`), an SLO tracker per
  server (``core.telemetry``), batcher state in ``trace.metrics``; a
  malformed request dies at ``submit`` (:class:`MalformedRequest`,
  counted) and never enters a batch; a runtime ``torch.OutOfMemoryError``
  retires the bucket (``serve_burst_oom``) and re-answers the same rows
  through smaller ones; a dead endpoint answers :class:`ServingUnavailable`.

Bucket parity: a replay runs the same kernels as the eager chain at its
batch, but the eager oracle applies the whole probe at the largest batch,
and a batch-dependent kernel (a matrix product whose cuBLAS kernel changes
with the row count) rounds differently.  :meth:`ServingEngine.warmup`
holds each bucket's probe rows bit for bit to the eager apply and drops
the buckets that differ (``serve_bucket_parity_dropped``); when none
passes, the engine re-anchors on its largest bucket (``parity_ok=False``,
``serve_parity_unverified``).

**Serving on a device mesh** (``mesh=``, a ``parallel.mesh.Mesh`` of slots
in this process): the fitted state is lowered once per distinct device of
the mesh (``parallel.mesh.replicate``, before any capture, so nothing moves
while a graph records).  A bucket that the data axis divides is split into
``ShardedRows`` of views of the static input, each data slot's rows run by
``map_rows`` in data order and joined on the device; a bucket it does not
divide is replicated and computed once per distinct device.  On the card
each bucket is one CUDA graph per distinct device, recording every slot's
work there.  Each bucket is admitted per slot against
``core.memory.min_chip_budget``; a capture's bytes are the whole card's, and
the slot's charge (``reported["slot_charge_bytes"]``) is the card's capture
bytes over the mesh's slots on that card.  The eager oracle is the lowered
chain on slot (0, 0)'s device.  Engines never span processes: a mesh that
does (``parallel.mesh.mesh_spans_processes``) is refused, typed, naming
``host_local_mesh(mesh)``; scale-out across hosts is one engine per host
behind ``core.frontend.HostFleet``.

With the profiler on, the launches a graph records are tallied by name and stated
cost (``core.profiler.graph_tally``) and each synced replay is one ledger
row ``serve:<label>:b<bucket>``; the wrappers' launch counters count no
recorded launch, and :meth:`ServingEngine.graph_launches` counts the
replays' instead.

Env knobs: ``KEYSTONE_SERVE_BUCKETS`` (default ``1,4,16,64``),
``KEYSTONE_SERVE_MAX_BATCH``, ``KEYSTONE_SERVE_MAX_WAIT_MS`` (default
``5``), ``KEYSTONE_SERVE_EAGER_FLUSH`` (``0``: strict full-or-deadline
flushing).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ..parallel import mesh as kmesh
from ..utils.platform import device_scope, resolve_device, retained_constants
from . import memory as kmem
from . import numerics as knum
from . import profiler as kprof
from . import telemetry
from . import trace
from .resilience import counters
from .serve_errors import MalformedRequest, ServeError, ServingUnavailable

_logger = logging.getLogger("keystone_tpu_torch.serve")

BUCKETS_ENV = "KEYSTONE_SERVE_BUCKETS"
MAX_BATCH_ENV = "KEYSTONE_SERVE_MAX_BATCH"
MAX_WAIT_ENV = "KEYSTONE_SERVE_MAX_WAIT_MS"
EAGER_FLUSH_ENV = "KEYSTONE_SERVE_EAGER_FLUSH"

DEFAULT_BUCKETS = (1, 4, 16, 64)
DEFAULT_MAX_WAIT_MS = 5.0

#: Micro-batches in flight between the assembler and the executor — the
#: replayed batch plus the one whose copy to the card overlaps it.
INFLIGHT_BATCHES = 2

#: Every blocking wait polls at this period so stop flags are observed.
_POLL_SECONDS = 0.05

#: One graph capture at a time in the process: a capture synchronizes the
#: card before it begins, and two captures must not overlap that.
_CAPTURE_LOCK = threading.Lock()


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        val = float(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r} is not a number") from None
    if val < 0:
        raise ValueError(f"{name}={raw!r} must be >= 0")
    return val


def _parse_buckets(raw: str) -> tuple[int, ...]:
    try:
        vals = tuple(sorted({int(tok) for tok in raw.split(",") if tok.strip()}))
    except ValueError:
        raise ValueError(
            f"{BUCKETS_ENV}={raw!r}: expected comma-separated integers"
        ) from None
    if not vals or any(v < 1 for v in vals):
        raise ValueError(f"{BUCKETS_ENV}={raw!r}: buckets must be >= 1")
    return vals


@dataclasses.dataclass
class ServeConfig:
    """Knob set of one serving endpoint (env-seeded via :meth:`from_env`)."""

    #: ascending batch-size buckets; one CUDA graph is captured per bucket.
    buckets: tuple = DEFAULT_BUCKETS
    #: deadline-aware flush: a micro-batch goes out when the OLDEST pending
    #: request has waited this long, even if the largest bucket isn't full.
    max_wait_ms: float = DEFAULT_MAX_WAIT_MS
    #: the reference donates the request batch to its executable; a graph
    #: reads a static input, so here it is recorded and has no effect.
    donate: bool = True
    #: opportunistic idle flush: with the device pipeline idle a pending
    #: micro-batch dispatches at once; the deadline then only governs
    #: waiting while the device is busy.
    eager_flush: bool = True

    def __post_init__(self):
        buckets = tuple(sorted({int(b) for b in self.buckets}))
        if not buckets or any(b < 1 for b in buckets):
            raise ValueError(f"buckets must all be >= 1, got {self.buckets}")
        self.buckets = buckets
        if self.max_wait_ms < 0:
            raise ValueError(
                f"max_wait_ms must be >= 0, got {self.max_wait_ms}"
            )

    @property
    def max_batch(self) -> int:
        return self.buckets[-1]

    @classmethod
    def from_env(cls, **overrides) -> "ServeConfig":
        """``KEYSTONE_SERVE_BUCKETS`` / ``KEYSTONE_SERVE_MAX_BATCH`` /
        ``KEYSTONE_SERVE_MAX_WAIT_MS``, any field overridable by keyword."""
        cfg: dict = {}
        raw = os.environ.get(BUCKETS_ENV, "").strip()
        buckets = _parse_buckets(raw) if raw else DEFAULT_BUCKETS
        mb = os.environ.get(MAX_BATCH_ENV, "").strip()
        if mb:
            cap = int(mb)
            if cap < 1:
                raise ValueError(f"{MAX_BATCH_ENV}={mb!r} must be >= 1")
            buckets = tuple(b for b in buckets if b < cap) + (cap,)
        cfg["buckets"] = buckets
        cfg["max_wait_ms"] = _env_float(MAX_WAIT_ENV, DEFAULT_MAX_WAIT_MS)
        cfg["eager_flush"] = (
            os.environ.get(EAGER_FLUSH_ENV, "").strip() != "0"
        )
        cfg.update({k: v for k, v in overrides.items() if v is not None})
        return cls(**cfg)

    def record(self) -> dict:
        return {
            "buckets": list(self.buckets),
            "max_wait_ms": self.max_wait_ms,
            "donate": self.donate,
            "eager_flush": self.eager_flush,
        }


# -- bucketed CUDA-graph inference ----------------------------------------------


class _GraphBucket:
    """One bucket's captured CUDA graph: its static input and output, the
    constants it reads, and the kernels it recorded (name ->
    ``{"launches", "flops", "bytes"}``).  A call copies the micro-batch into
    the static input on the engine's stream, replays, copies the output
    out and waits for the stream, so the static buffers are free again when
    it returns (one call at a time per bucket)."""

    def __init__(self, graph, static_in, static_out, kernels, constants, stream):
        self.graph = graph
        self.static_in = static_in
        self.static_out = static_out
        self.kernels = kernels
        self.constants = constants
        self.stream = stream
        self.replays = 0
        self._lock = threading.Lock()

    def __call__(self, dev_batch):
        with self._lock:
            # The batch may still be in flight on the caller's stream.
            self.stream.wait_stream(torch.cuda.current_stream(self.stream.device))
            with torch.cuda.stream(self.stream):
                self.static_in.copy_(dev_batch)
                self.graph.replay()
                out = self.static_out.clone()
            self.stream.synchronize()
            self.replays += 1
        return out

    def cost(self) -> tuple[float | None, float | None]:
        """The summed stated ``(flops, bytes)`` of the recorded kernels."""
        flops = sum(k["flops"] for k in self.kernels.values())
        nbytes = sum(k["bytes"] for k in self.kernels.values())
        return flops or None, nbytes or None


class _MeshBucket:
    """One bucket of a mesh engine: per distinct device, the rows of the
    data blocks its slots hold and their work there (a :class:`_GraphBucket`
    on the card, the eager function on the CPU).  A call hands each device
    its rows, runs them, and joins each data block's rows, taken from the
    device of its model slot 0, in data order on the engine's device."""

    def __init__(self, parts: list, per: int, answer: list, device):
        #: [(device, data blocks in data order, runner)]
        self.parts = parts
        self.per = per
        #: data block -> index into ``parts`` of the device that answers it
        self.answer = answer
        self.device = device

    def graphs(self) -> list:
        return [run for _dev, _blocks, run in self.parts if isinstance(run, _GraphBucket)]

    def __call__(self, dev_batch):
        per, nblocks = self.per, len(self.answer)
        outs = []
        for dev, blocks, run in self.parts:
            x = dev_batch if len(blocks) == nblocks else torch.cat(
                [dev_batch[i * per:(i + 1) * per] for i in blocks])
            outs.append(run(kmesh.on_slot(x, dev)))
        if len(outs) == 1:
            return outs[0]
        pieces = []
        for i, at in enumerate(self.answer):
            j = self.parts[at][1].index(i)
            pieces.append(kmesh.on_slot(outs[at][j * per:(j + 1) * per], self.device))
        return torch.cat(pieces)


def _graphs(ex) -> list:
    """The CUDA graphs a bucket's executable replays (none on the CPU)."""
    if isinstance(ex, _GraphBucket):
        return [ex]
    return ex.graphs() if isinstance(ex, _MeshBucket) else []


def _merge_kernels(graphs: list) -> dict:
    out: dict = {}
    for g in graphs:
        for name, k in g.kernels.items():
            acc = out.setdefault(name, {"launches": 0, "flops": 0, "bytes": 0})
            for key in acc:
                acc[key] += k[key]
    return out


class ServingEngine:
    """One fitted pipeline served through per-bucket CUDA graphs (eager
    buckets on the CPU).

    ``pipe`` is any fitted Transformer/Pipeline over batches whose tensors
    live on ``device``; ``example`` fixes one request's shape and dtype
    (a numpy array or anything with ``shape`` and a numpy ``dtype``)
    WITHOUT the batch axis.  Every bucket preflights through
    ``core.memory.plan_program``; the plans (admitted or not) are in
    ``memory_plans``, a denied bucket above the floor is never captured
    (``serve_bucket_denied``), and a bucket that hits
    ``torch.OutOfMemoryError`` at runtime is retired (``serve_burst_oom``)
    and its rows re-run through smaller buckets.

    ``mesh`` (a ``parallel.mesh.Mesh``) serves on its slots, as the module
    docstring says; ``device`` is then slot (0, 0)'s.  A mesh that spans
    processes raises :class:`ServeError` naming ``host_local_mesh(mesh)``.
    """

    def __init__(
        self,
        pipe,
        example,
        *,
        config: ServeConfig | None = None,
        label: str = "pipeline",
        warmup: bool = True,
        mesh=None,
        device="cuda",
    ):
        self.mesh = mesh
        #: (device type, index) -> the fitted chain lowered onto that device.
        self._replicas: dict = {}
        if mesh is None:
            self.device = resolve_device(device)
            self._pipe = pipe
        else:
            if not isinstance(mesh, kmesh.Mesh):
                raise ServeError(
                    f"serve:{label}: mesh= takes a parallel.mesh.Mesh, not "
                    f"{type(mesh).__name__}"
                )
            if kmesh.mesh_spans_processes(mesh):
                # Serving never spans hosts: a request answered through a
                # cross-process mesh would need every host per request (one
                # slow peer stalls the fleet, one dead peer fails it).
                raise ServeError(
                    f"serve:{label}: serving mesh {kmesh.mesh_desc(mesh)} spans processes — "
                    "anchor on host_local_mesh(mesh) instead (this host owns "
                    f"{len(mesh.local_slots())} of the mesh's {mesh.size} slots)"
                )
            for dev in mesh.devices.flat:
                if kmesh.device_key(dev) not in self._replicas:
                    self._replicas[kmesh.device_key(dev)] = kmesh.replicate(
                        pipe, resolve_device(dev))
            self.device = resolve_device(mesh.devices[0, 0])
            self._pipe = self._replicas[kmesh.device_key(self.device)]
        #: the eager parity/offline oracle: the object as given, or under a
        #: mesh the lowered whole-tensor chain on slot (0, 0)'s device (a
        #: restored node's layout records cannot run eagerly).
        self._oracle_pipe = self._pipe
        self.label = label
        self.config = config or ServeConfig.from_env()
        self.example_shape = tuple(int(d) for d in example.shape)
        self.example_dtype = np.dtype(example.dtype)
        self._torch_dtype = torch.from_numpy(np.empty(0, self.example_dtype)).dtype
        #: bucket -> MemoryPlan for EVERY configured bucket, dropped ones
        #: included; on the card ``reported`` holds the capture's bytes.
        self.memory_plans: dict[int, kmem.MemoryPlan] = {}
        #: bucket -> seconds of the warmup inference.
        self.warmup_seconds: dict[int, float] = {}
        #: bucket -> seconds of its eager warm run and capture (the card).
        self.capture_seconds: dict[int, float] = {}
        #: bucket -> did its probe rows equal the eager offline apply?
        self.parity: dict[int, bool] = {}
        #: False only when NO bucket passed the parity probe.
        self.parity_ok: bool = True
        self._exec: dict[int, Any] = {}
        self._lock = threading.Lock()
        #: the output-drift monitor, armed by :meth:`arm_drift_baseline`.
        self.drift: knum.DriftMonitor | None = None
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            self._copy_stream = torch.cuda.Stream(self.device)
            #: device key -> the stream its graphs capture and replay on.
            self._streams = {kmesh.device_key(self.device): self._stream}
        self._build()
        if warmup:
            self.warmup()

    # -- construction ---------------------------------------------------------

    def _batch_struct(self, bucket: int) -> torch.Tensor:
        return torch.empty(
            (bucket, *self.example_shape), dtype=self._torch_dtype, device="meta"
        )

    def _h2d(self, padded: np.ndarray, bucket: int) -> torch.Tensor:
        """One micro-batch to the engine's device.  On the card it is staged
        in pinned memory and copied on the engine's copy stream, and the
        copy is complete when this returns (the assembler calls it while
        the executor replays the previous micro-batch)."""
        host = torch.from_numpy(np.ascontiguousarray(padded))
        if self.device.type == "cpu":
            return host
        pinned = host.pin_memory()
        with torch.cuda.stream(self._copy_stream):
            dev = pinned.to(self.device, non_blocking=True)
        self._copy_stream.synchronize()
        return dev

    def _d2h(self, out) -> np.ndarray:
        """A bucket's output rows on the host (the replay is complete)."""
        return out.detach().cpu().numpy()

    def _slot_layout(self, bucket: int) -> tuple[int, int]:
        """``(data blocks, rows per block)`` of a bucket: split over the
        mesh's data axis when it divides the bucket, else one block that
        every device computes whole (meshless: one block)."""
        d = int(self.mesh.shape[kmesh.DATA_AXIS]) if self.mesh is not None else 1
        if d > 1 and bucket % d == 0:
            return d, bucket // d
        return 1, bucket

    def _build(self) -> None:
        # Under a mesh each bucket is admitted per slot: a slot's rows
        # against the smallest slot budget of the mesh.
        budget = {} if self.mesh is None else {"budget": kmem.min_chip_budget(self.mesh)[0]}
        for i, bucket in enumerate(self.config.buckets):
            floor = i == 0
            with trace.span(
                "serve.compile", cat="serve", bucket=bucket, label=self.label
            ):
                # A fitted chain's tensors live on its device, so a meta run
                # of it cannot succeed; on the card the capture measures it.
                plan = kmem.plan_program(
                    self._pipe,
                    self._batch_struct(self._slot_layout(bucket)[1]),
                    label=f"serve:{self.label}:b{bucket}",
                    require_analysis=True,
                    meta_run=False,
                    **budget,
                )
                self.memory_plans[bucket] = plan
                if plan.admitted or floor:
                    self._exec[bucket] = self._compile(bucket, plan)
            if not plan.admitted and not floor:
                counters.record(
                    "serve_bucket_denied",
                    f"serve:{self.label}: bucket {bucket} denied by HBM "
                    f"admission ({plan.reason}) — endpoint serves without it",
                )
            elif not plan.admitted:
                _logger.warning(
                    "serve:%s: floor bucket %d denied by preflight (%s) but "
                    "nothing is below it — serving anyway",
                    self.label, bucket, plan.reason,
                )

    def _compile(self, bucket: int, plan: kmem.MemoryPlan):
        if self.mesh is None and self.device.type == "cpu":
            return self._pipe  # the eager chain at the bucket's batch
        try:
            if self.mesh is not None:
                return self._mesh_bucket(bucket, plan)
            graph, alloc, reserved = self._capture(
                bucket, self.device, self._stream, bucket, self._pipe)
            plan.reported = {"capture_allocated_bytes": alloc,
                             "capture_reserved_bytes": reserved}
            return graph
        except ServeError:
            raise
        except Exception as e:  # noqa: BLE001 — typed, never served eagerly
            raise ServeError(
                f"serve:{self.label}: bucket {bucket} failed to capture — "
                f"{type(e).__name__}: {e}"
            ) from e

    def _mesh_bucket(self, bucket: int, plan: kmem.MemoryPlan) -> _MeshBucket:
        """The bucket over the mesh's slots: per distinct device the data
        blocks its slots hold, run by :meth:`_slot_work` (captured into one
        graph per device on the card).  On the card ``plan.reported`` holds
        the captures' bytes summed over the devices and each slot's charge:
        the largest of a device's capture bytes over the mesh's slots on
        that device."""
        nblocks, per = self._slot_layout(bucket)
        devices, blocks, slots = {}, {}, {}
        for (i, _m), dev in np.ndenumerate(self.mesh.devices):
            key = kmesh.device_key(dev)
            devices.setdefault(key, resolve_device(dev))
            held = blocks.setdefault(key, [])
            if (i if nblocks > 1 else 0) not in held:
                held.append(i if nblocks > 1 else 0)
            slots[key] = slots.get(key, 0) + 1
        keys = list(blocks)
        answer = [keys.index(kmesh.device_key(self.mesh.devices[i, 0])) for i in range(nblocks)]
        parts = []
        alloc = reserved = charge = 0
        for key in keys:
            dev = devices[key]
            work = self._slot_work(key, dev, len(blocks[key]))
            if dev.type == "cuda":
                stream = self._streams.get(key)
                if stream is None:
                    stream = self._streams[key] = torch.cuda.Stream(dev)
                work, a, r = self._capture(bucket, dev, stream, len(blocks[key]) * per, work)
                alloc, reserved = alloc + a, reserved + r
                charge = max(charge, max(a, r) // slots[key])
            parts.append((dev, blocks[key], work))
        if self.device.type == "cuda":
            plan.reported = {"capture_allocated_bytes": alloc,
                             "capture_reserved_bytes": reserved,
                             "slot_charge_bytes": charge}
        return _MeshBucket(parts, per, answer, self.device)

    def _slot_work(self, key, dev: torch.device, nblocks: int):
        """The work of one device's slots on the rows of its ``nblocks``
        data blocks (in data order): each block a view of the input, run
        through the chain lowered onto ``dev`` by ``map_rows`` and joined
        on ``dev``; one block runs the chain on the input itself."""
        replica = self._replicas[key]
        if nblocks == 1:
            def work(x):
                with device_scope(dev):
                    return replica(x)
            return work
        sub = kmesh.make_mesh(nblocks, 1, devices=[dev] * nblocks)
        return lambda x: kmesh.map_rows(replica, kmesh.padded_shard_rows(x, sub)[0]).gather()

    def _capture(self, bucket: int, dev, s, rows: int, work) -> tuple:
        """Warm ``work`` up once on stream ``s`` of ``dev`` at ``rows`` rows,
        then capture it into a CUDA graph on the same stream and thread.
        Returns the graph and the bytes the capture took (allocated,
        reserved)."""
        with _CAPTURE_LOCK:
            t0 = time.perf_counter()
            static_in = torch.zeros(
                (rows, *self.example_shape), dtype=self._torch_dtype, device=dev
            )
            with retained_constants() as constants:
                s.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(s):
                    work(static_in)
                s.synchronize()
                # torch.cuda.graph empties the allocator's cache before it
                # captures; empty it here first, so the reserved bytes below
                # grow by what the graph's private pool holds.
                torch.cuda.empty_cache()
                alloc0 = torch.cuda.memory_allocated(dev)
                reserved0 = torch.cuda.memory_reserved(dev)
                graph = torch.cuda.CUDAGraph()
                with kprof.graph_tally() as kernels:
                    with torch.cuda.graph(
                        graph, stream=s, capture_error_mode="thread_local"
                    ):
                        static_out = work(static_in)
                alloc1 = torch.cuda.memory_allocated(dev)
                reserved1 = torch.cuda.memory_reserved(dev)
            self.capture_seconds[bucket] = (
                self.capture_seconds.get(bucket, 0.0) + time.perf_counter() - t0)
        if not isinstance(static_out, torch.Tensor):
            raise ServeError(
                f"serve:{self.label}: bucket {bucket}: the chain returns "
                f"{type(static_out).__name__}, not one tensor"
            )
        # Other threads allocate and free meanwhile: a delta can come out
        # below zero, and then it says nothing.
        alloc = max(0, int(alloc1 - alloc0 + static_in.numel() * static_in.element_size()))
        return (_GraphBucket(graph, static_in, static_out, kernels, constants, s),
                alloc, max(0, int(reserved1 - reserved0)))

    def _probe_batch(self, rows: int) -> np.ndarray:
        """Deterministic nonzero probe data for the parity check."""
        rng = np.random.default_rng(20260803)
        shape = (rows, *self.example_shape)
        if self.example_dtype.kind in "fc":
            return rng.standard_normal(shape).astype(self.example_dtype)
        info = np.iinfo(self.example_dtype)
        return rng.integers(
            info.min, min(info.max, 255), shape, endpoint=True
        ).astype(self.example_dtype)

    def warmup(self) -> float:
        """Run each live bucket once on a deterministic probe batch and
        VERIFY PARITY: each bucket's probe rows must be bit-identical to the
        eager offline apply of the whole probe.  A bucket that fails is
        dropped (``serve_bucket_parity_dropped``).  If NO bucket passes,
        ``parity_ok=False`` (``serve_parity_unverified``) and parity
        RE-ANCHORS on the largest bucket's own rows: buckets that disagree
        with it are still dropped, so served answers stay deterministic and
        bucket-independent.  Returns total warmup seconds."""
        live = self.buckets()
        if not live:
            return 0.0
        probe = self._probe_batch(live[-1])
        oracle = self.offline(probe)
        total = 0.0
        outs: dict[int, np.ndarray] = {}
        for bucket in live:
            t0 = time.perf_counter()
            with trace.span(
                "serve.warmup", cat="serve", bucket=bucket, label=self.label
            ):
                outs[bucket] = self._d2h(
                    self._execute(bucket, self._h2d(probe[:bucket], bucket))
                )
            dt = time.perf_counter() - t0
            self.warmup_seconds[bucket] = dt
            total += dt
            self.parity[bucket] = bool(
                np.array_equal(outs[bucket][:bucket], oracle[:bucket])
            )
        passing = [b for b in live if self.parity.get(b)]
        reason = "rows differ from the eager apply"
        if not passing:
            self.parity_ok = False
            counters.record(
                "serve_parity_unverified",
                f"serve:{self.label}: no bucket reproduced the eager "
                "oracle bit-for-bit — re-anchoring on the largest bucket "
                "(served answers stay self-consistent, not eager-verified)",
            )
            anchor = outs[live[-1]]
            passing = [
                b for b in live if np.array_equal(outs[b][:b], anchor[:b])
            ]
            reason = "rows differ from the largest bucket's graph apply"
        for bucket in live:
            if bucket in passing:
                continue
            with self._lock:
                self._exec.pop(bucket, None)
            counters.record(
                "serve_bucket_parity_dropped",
                f"serve:{self.label}: bucket {bucket} {reason} "
                "(batch-size-dependent rounding) — dropped so every "
                f"served answer stays deterministic; live {passing}",
            )
        return total

    # -- the inference path ---------------------------------------------------

    def buckets(self) -> tuple[int, ...]:
        """Currently-live buckets, ascending."""
        with self._lock:
            return tuple(sorted(self._exec))

    def bucket_for(self, n: int) -> int:
        """Smallest live bucket holding ``n`` requests (the largest bucket
        when ``n`` exceeds it — the caller chunks)."""
        live = self.buckets()
        if not live:
            raise ServingUnavailable(
                f"serve:{self.label}: every bucket OOMed away — the "
                "endpoint has no graph left"
            )
        for b in live:
            if n <= b:
                return b
        return live[-1]

    def _execute(self, bucket: int, dev_batch):
        """Run one bucket (replay its graph; on the CPU apply the chain).
        On the card the output is complete when this returns.  Separated
        out so tests can inject ``torch.OutOfMemoryError`` here."""
        with self._lock:
            ex = self._exec.get(bucket)
        if ex is None:
            raise ServingUnavailable(
                f"serve:{self.label}: bucket {bucket} was retired"
            )
        return ex(dev_batch)

    def _profile_bucket(self, bucket: int, wall_seconds: float) -> None:
        """Ledger hook (core.profiler): one synced replay attributed under
        ``serve:<label>:b<bucket>`` with its kernels' summed stated cost.
        Caller gates on ``profiler.enabled()``."""
        with self._lock:
            ex = self._exec.get(bucket)
        graphs = _graphs(ex)
        flops = sum(g.cost()[0] or 0 for g in graphs) or None
        nbytes = sum(g.cost()[1] or 0 for g in graphs) or None
        kprof.record_program(
            f"serve:{self.label}:b{bucket}", wall_seconds,
            flops=flops, bytes_accessed=nbytes,
        )

    def graph_kernels(self) -> dict[int, dict]:
        """Live bucket -> the kernels its graphs recorded (empty on the CPU);
        a mesh bucket sums its devices' graphs."""
        with self._lock:
            return {
                b: _merge_kernels(_graphs(ex))
                for b, ex in self._exec.items() if _graphs(ex)
            }

    def graph_launches(self) -> dict[str, int]:
        """Kernel name -> launches made by replays so far: each graph's
        recorded launches times its replays, summed over the live buckets."""
        with self._lock:
            graphs = [g for ex in self._exec.values() for g in _graphs(ex)]
        out: dict[str, int] = {}
        for ex in graphs:
            for name, k in ex.kernels.items():
                out[name] = out.get(name, 0) + k["launches"] * ex.replays
        return out

    def _retire_bucket(self, bucket: int, why: str) -> None:
        with self._lock:
            self._exec.pop(bucket, None)
            remaining = sorted(self._exec)
        trace.metrics.inc("serve_bucket_retired")
        trace.metrics.gauge("serve_live_buckets", len(remaining))
        counters.record(
            "serve_burst_oom",
            f"serve:{self.label}: bucket {bucket} {why} — degraded to "
            f"buckets {remaining}",
        )
        trace.instant(
            "serve_bucket_retired", bucket=bucket, label=self.label,
            remaining=remaining,
        )

    def arm_drift_baseline(self, baseline: dict | None) -> None:
        """Arm output-drift detection against a fit-time reference sketch
        (the checkpoint manifest's ``numerics_baseline``).  None is a
        no-op."""
        if baseline:
            self.drift = knum.DriftMonitor(self.label, baseline)

    def rearm_drift_baseline(self, baseline: dict | None) -> None:
        """Re-arm drift detection on a NEW fit-time baseline (counted
        ``drift_rearmed``); an engine with no monitor yet arms one."""
        if not baseline:
            return
        if self.drift is None:
            self.arm_drift_baseline(baseline)
        else:
            self.drift.rearm(baseline)

    def observe_output(self, host_rows, request_ids=None, bucket=None) -> None:
        """Numerics hook on one bucket's ANSWERED host rows: a tensor-stat
        probe (request ids as the NaN-provenance map) and the drift sketch.
        One flag check when the observatory is off."""
        if not knum.active():
            return
        site = f"serve.{self.label}" + (f".b{bucket}" if bucket else "")
        knum.probe(site, host_rows, request_ids=request_ids)
        if self.drift is not None:
            self.drift.observe(host_rows)

    def _pad(self, host: np.ndarray, bucket: int) -> np.ndarray:
        pad = bucket - host.shape[0]
        if pad <= 0:
            return host
        return np.concatenate(
            [host, np.zeros((pad, *host.shape[1:]), host.dtype)], axis=0
        )

    def infer(self, host_batch: np.ndarray) -> np.ndarray:
        """Answer ``[n, *example_shape]`` host rows through the buckets:
        chunked to the largest live bucket, each chunk padded, copied,
        replayed, sliced back.  An OOM retires the failing bucket and
        re-runs the SAME rows through smaller buckets."""
        host_batch = np.asarray(host_batch)
        n = host_batch.shape[0]
        outs = []
        i = 0
        while i < n:
            bucket = self.bucket_for(n - i)
            chunk = host_batch[i : i + min(bucket, n - i)]
            outs.append(self._infer_chunk(chunk, bucket))
            i += chunk.shape[0]
        return outs[0] if len(outs) == 1 else np.concatenate(outs, axis=0)

    def _infer_chunk(self, chunk: np.ndarray, bucket: int) -> np.ndarray:
        k = chunk.shape[0]
        padded = self._pad(chunk, bucket)
        with trace.io_span(
            "serve.h2d", padded.nbytes, cat="serve", bucket=bucket
        ):
            dev = self._h2d(padded, bucket)
        try:
            t_exec = time.perf_counter()
            with trace.span(
                "serve.execute", cat="serve", bucket=bucket, rows=k
            ):
                out = self._execute(bucket, dev)
            if kprof.enabled():
                self._profile_bucket(bucket, time.perf_counter() - t_exec)
        except Exception as e:  # noqa: BLE001 — only OOM degrades
            # A concurrent caller can retire this bucket between
            # bucket_for() and _execute(): re-route like an own OOM.
            retired_race = (
                isinstance(e, ServingUnavailable)
                and bucket not in self.buckets()
            )
            if not kmem.is_oom_error(e) and not retired_race:
                raise
            if not retired_race:
                self._retire_bucket(bucket, "hit out of memory at runtime")
            kmem.free_buffers(dev)
            if not self.buckets():
                raise ServingUnavailable(
                    f"serve:{self.label}: burst OOM on the last "
                    f"bucket ({bucket}) — nothing to degrade to"
                ) from e
            return self.infer(chunk)
        with trace.io_span(
            "serve.d2h",
            int(out.numel() * out.element_size()), cat="serve", bucket=bucket,
        ):
            host = self._d2h(out)
        self.observe_output(host[:k], bucket=bucket)
        return host[:k]

    def offline(self, host_batch: np.ndarray) -> np.ndarray:
        """The offline oracle: the fitted pipeline applied directly (no
        bucketing, no padding, no graph) — what served answers are held
        bit-equal against."""
        batch = torch.as_tensor(np.ascontiguousarray(host_batch), device=self.device)
        return self._d2h(self._oracle_pipe(batch))

    def record(self) -> dict:
        """JSON-able engine summary for bench records."""
        return {
            "label": self.label,
            "config": self.config.record(),
            "example_shape": list(self.example_shape),
            "example_dtype": str(self.example_dtype),
            "mesh": kmesh.mesh_desc(self.mesh) if self.mesh is not None else None,
            "device": str(self.device),
            "live_buckets": list(self.buckets()),
            "parity_ok": self.parity_ok,
            "parity": {str(k): v for k, v in self.parity.items()},
            "warmup_seconds": {
                str(k): round(v, 4) for k, v in self.warmup_seconds.items()
            },
            "capture_seconds": {
                str(k): round(v, 4) for k, v in self.capture_seconds.items()
            },
            "memory_plans": {
                str(k): {**p.breakdown(), "reported": p.reported}
                for k, p in self.memory_plans.items()
            },
            # What the graphs recorded, and the launches their replays made.
            "graph_kernels": {str(k): v for k, v in self.graph_kernels().items()},
            "graph_launches": self.graph_launches(),
            "drift": self.drift.record() if self.drift is not None else None,
        }


def load_engine(
    path: str,
    example,
    *,
    config: ServeConfig | None = None,
    label: str = "pipeline",
    wrap: Callable[[Any], Any] | None = None,
    device="cuda",
    mesh=None,
) -> tuple[ServingEngine, dict]:
    """Warm-load a fitted pipeline from a ``core.checkpoint`` artifact (the
    port's or the JAX package's) onto ``device`` and stand up its engine,
    measuring the COLD START: restore seconds, the per-bucket build and
    capture (``compile_seconds``), and the warmup inference.  ``wrap``
    turns the loaded object into the servable chain.  ``mesh`` restores
    through ``load_pipeline(mesh=)`` (resharded onto the mesh, whatever
    topology the file recorded) and serves on its slots.  Returns
    ``(engine, cold_start_record)``."""
    from .checkpoint import load_numerics_baseline, load_pipeline

    t0 = time.perf_counter()
    with trace.span("serve.cold_load", cat="serve", path=path):
        pipe = load_pipeline(path, device=device, mesh=mesh)
    t_load = time.perf_counter()
    if wrap is not None:
        pipe = wrap(pipe)
    engine = ServingEngine(
        pipe, example, config=config, label=label, warmup=False, mesh=mesh,
        device=device,
    )
    engine.arm_drift_baseline(load_numerics_baseline(path))
    t_build = time.perf_counter()
    engine.warmup()
    t_warm = time.perf_counter()
    cold = {
        "checkpoint_load_seconds": round(t_load - t0, 4),
        "compile_seconds": round(t_build - t_load, 4),
        "warmup_seconds": round(t_warm - t_build, 4),
        "cold_start_seconds": round(t_warm - t0, 4),
    }
    if mesh is not None:
        cold["mesh"] = kmesh.mesh_desc(mesh)
    trace.instant("serve_cold_start", label=label, **cold)
    return engine, cold


# -- the dynamic request batcher ----------------------------------------------


class ServeFuture:
    """Handle for one submitted request.  ``result()`` blocks until the
    batcher answers (the request's own output row) or fails it typed.
    ``request_id`` is minted at ``Server.submit``; ``phases`` holds the
    per-phase latency decomposition once the request resolves."""

    __slots__ = (
        "_event", "_value", "_error", "t_submit", "t_answer",
        "request_id", "phases",
    )

    def __init__(self, request_id: int = 0):
        self._event = threading.Event()
        self._value = None
        self._error: BaseException | None = None
        self.t_submit = time.perf_counter()
        self.t_answer = 0.0
        self.request_id = request_id
        self.phases: dict | None = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None):
        if not self._event.wait(timeout):
            raise TimeoutError("request not answered within timeout")
        if self._error is not None:
            raise self._error
        return self._value

    def latency_seconds(self) -> float:
        """Submit-to-answer wall time (valid once done)."""
        return self.t_answer - self.t_submit

    def _resolve(self, value=None, error: BaseException | None = None):
        self._value = value
        self._error = error
        self.t_answer = time.perf_counter()
        self._event.set()


@dataclasses.dataclass
class ServerStats:
    """Counters of one server's lifetime (bench/chaos artifact)."""

    requests: int = 0
    answered: int = 0
    failed: int = 0  #: futures resolved with a typed error (close, OOM floor)
    malformed: int = 0
    batches: int = 0
    flush_full: int = 0  #: flushes triggered by a full largest bucket
    flush_deadline: int = 0  #: flushes triggered by max_wait_ms
    flush_idle: int = 0  #: opportunistic flushes (device pipeline idle)
    padded_rows: int = 0  #: zero rows added to reach bucket sizes
    occupancy_sum: float = 0.0  #: Σ rows/bucket per batch (mean = /batches)
    queue_peak: int = 0

    def occupancy(self) -> float:
        return self.occupancy_sum / self.batches if self.batches else 0.0

    def record(self) -> dict:
        out = dataclasses.asdict(self)
        out["mean_occupancy"] = round(self.occupancy(), 4)
        out["postmortems"] = telemetry.postmortem_paths()
        return out


class Server:
    """The warm online endpoint: submit single requests, get futures.

    A background ASSEMBLER thread collects queued requests into
    bucket-sized micro-batches (flush on a full largest bucket OR
    ``max_wait_ms`` from the oldest request OR, with ``eager_flush``, an
    idle device pipeline), pads the remainder to the nearest bucket and
    copies it to the card; a background EXECUTOR thread replays the
    bucket and answers each request with its own row in arrival order.
    :data:`INFLIGHT_BATCHES` micro-batches are in flight.

    Use as a context manager (or call :meth:`close`); pending requests at
    close answer :class:`ServingUnavailable`, never hang.
    """

    def __init__(self, engine: ServingEngine, config: ServeConfig | None = None):
        self.engine = engine
        self.config = config or engine.config
        self.stats = ServerStats()
        #: live SLO surface for this endpoint (core.telemetry).
        self.slo = telemetry.register_slo(engine.label)
        self._next_id = 0
        self._queue: list = []  # pending (row, future), arrival order
        self._cond = threading.Condition()
        self._stopped = False
        # Futures minted but not yet resolved: what drain()/outstanding()
        # wait on.  Every resolution path decrements exactly once.
        self._outstanding = 0
        # assembler -> executor handoff (bounded: INFLIGHT_BATCHES).
        self._inflight: list = []
        self._inflight_cond = threading.Condition()
        # True while the executor is inside a batch — read without the lock
        # by the idle-flush check (a stale read only shifts the trigger).
        self._executing = False
        self._assembler = threading.Thread(
            target=self._assemble_loop, name="keystone-serve-assembler",
            daemon=True,
        )
        self._executor = threading.Thread(
            target=self._execute_loop, name="keystone-serve-executor",
            daemon=True,
        )
        self._assembler.start()
        self._executor.start()

    # -- client surface -------------------------------------------------------

    def submit(self, x) -> ServeFuture:
        """Enqueue one request (shape ``example_shape``).  Malformed
        requests raise :class:`MalformedRequest` HERE, counted, without
        ever entering a batch."""
        arr = self._validate(x)
        with self._cond:
            if self._stopped:
                raise ServingUnavailable("server is closed")
            self._next_id += 1
            fut = ServeFuture(request_id=self._next_id)
            self._queue.append((arr, fut))
            self._outstanding += 1
            self.stats.requests += 1
            self.stats.queue_peak = max(self.stats.queue_peak, len(self._queue))
            trace.metrics.gauge("serve_queue_depth", len(self._queue))
            trace.metrics.gauge("serve_queue_peak", self.stats.queue_peak)
            self._cond.notify_all()
        trace.instant(
            "serve.submit", request_id=fut.request_id, label=self.engine.label
        )
        return fut

    def predict(self, x, timeout: float | None = 30.0):
        """Blocking convenience: ``submit`` + ``result``."""
        return self.submit(x).result(timeout)

    def _reject(self, detail: str, message: str, cause=None):
        with self._cond:
            self.stats.malformed += 1
        counters.record("serve_malformed_request", detail)
        raise MalformedRequest(message) from cause

    def _validate(self, x) -> np.ndarray:
        eng = self.engine
        try:
            arr = np.asarray(x)
        except Exception as e:  # noqa: BLE001 — unarrayable payload
            self._reject(
                f"unarrayable payload: {e}",
                f"request is not array-like: {e}",
                cause=e,
            )
        if tuple(arr.shape) != eng.example_shape:
            self._reject(
                f"shape {tuple(arr.shape)} != {eng.example_shape}",
                f"request shape {tuple(arr.shape)} does not match the "
                f"endpoint's example shape {eng.example_shape}",
            )
        try:
            arr = arr.astype(eng.example_dtype, casting="same_kind", copy=False)
        except TypeError:
            self._reject(
                f"dtype {arr.dtype} not castable to {eng.example_dtype}",
                f"request dtype {arr.dtype} is not same-kind castable to "
                f"{eng.example_dtype}",
            )
        if arr.dtype.kind in "fc" and not np.isfinite(arr).all():
            self._reject(
                "non-finite payload",
                "request payload contains NaN/Inf — refusing to serve a "
                "prediction from a poisoned input",
            )
        return arr

    # -- assembler thread -----------------------------------------------------

    def _pipeline_idle(self) -> bool:
        """No batch in the handoff and none executing."""
        return not self._inflight and not self._executing

    def _collect(self) -> list | None:
        """Block until a micro-batch is due: full largest bucket, the
        oldest request aged past ``max_wait_ms``, or (``eager_flush``) an
        idle device pipeline with requests pending.  None at shutdown."""
        max_batch = self.config.max_batch
        max_wait = self.config.max_wait_ms / 1e3
        with self._cond:
            while True:
                if self._queue:
                    oldest = self._queue[0][1].t_submit
                    if len(self._queue) >= max_batch:
                        self.stats.flush_full += 1
                        reason = "full"
                    elif time.perf_counter() - oldest >= max_wait:
                        self.stats.flush_deadline += 1
                        reason = "deadline"
                    elif self.config.eager_flush and self._pipeline_idle():
                        self.stats.flush_idle += 1
                        reason = "idle"
                    else:
                        reason = None
                    if reason is None:
                        remaining = max_wait - (time.perf_counter() - oldest)
                        self._cond.wait(min(remaining, _POLL_SECONDS))
                        continue
                    batch = self._queue[:max_batch]
                    del self._queue[:max_batch]
                    trace.metrics.gauge("serve_queue_depth", len(self._queue))
                    trace.metrics.inc(f"serve_flush_{reason}")
                    trace.instant(
                        "serve_flush", reason=reason, rows=len(batch),
                        queued=len(self._queue),
                    )
                    return batch
                if self._stopped:
                    return None
                self._cond.wait(_POLL_SECONDS)

    def _assemble_loop(self) -> None:
        try:
            while True:
                batch = self._collect()
                if batch is None:
                    break
                all_rows = np.stack([arr for arr, _ in batch])
                all_futs = [fut for _, fut in batch]
                # Chunk by the CURRENT largest live bucket: after a burst-OOM
                # retirement a collected batch can exceed every survivor.
                stop = False
                i = 0
                while i < all_rows.shape[0] and not stop:
                    bucket = self.engine.bucket_for(all_rows.shape[0] - i)
                    take = min(bucket, all_rows.shape[0] - i)
                    rows = all_rows[i : i + take]
                    futs = all_futs[i : i + take]
                    i += take
                    n = rows.shape[0]
                    t_assembled = time.perf_counter()
                    padded = self.engine._pad(rows, bucket)
                    pad = padded.shape[0] - n
                    self.stats.padded_rows += pad
                    if pad:
                        trace.metrics.inc("serve_padded_rows", pad)
                    # The copy to the card runs NOW, overlapping the
                    # executor's replay of the previous micro-batch.
                    with trace.io_span(
                        "serve.h2d", padded.nbytes, cat="serve", bucket=bucket,
                        req_first=futs[0].request_id,
                        req_last=futs[-1].request_id,
                    ):
                        dev = self.engine._h2d(padded, bucket)
                    t_h2d_done = time.perf_counter()
                    entry = (futs, rows, dev, bucket, t_assembled, t_h2d_done)
                    with self._inflight_cond:
                        while (
                            len(self._inflight) >= INFLIGHT_BATCHES
                            and not self._stopped
                        ):
                            self._inflight_cond.wait(_POLL_SECONDS)
                        if self._stopped:
                            # Close raced a collected batch: fail the chunk
                            # in hand AND the not-yet-chunked rest of it.
                            self._fail_futs(
                                futs + all_futs[i:],
                                ServingUnavailable("server closed mid-batch"),
                            )
                            stop = True
                        else:
                            self._inflight.append(entry)
                            self._inflight_cond.notify_all()
                if stop:
                    break
        except BaseException as e:  # noqa: BLE001 — never die silently
            _logger.exception("serve assembler thread failed")
            self._shutdown(error=e)
        finally:
            with self._inflight_cond:
                self._inflight.append(None)  # end-of-stream for the executor
                self._inflight_cond.notify_all()

    # -- executor thread ------------------------------------------------------

    def _execute_loop(self) -> None:
        while True:
            with self._inflight_cond:
                while not self._inflight:
                    self._inflight_cond.wait(_POLL_SECONDS)
                entry = self._inflight.pop(0)
                self._executing = entry is not None
                self._inflight_cond.notify_all()
            if entry is None:
                break
            try:
                self._run_batch(entry)
            finally:
                self._executing = False
                # The pipeline just went idle — itself a flush trigger.
                with self._cond:
                    self._cond.notify_all()

    def _run_batch(self, entry) -> None:
        futs, rows, dev, bucket, t_assembled, t_h2d_done = entry
        n = len(futs)
        degraded = False
        t_exec_start = time.perf_counter()
        try:
            try:
                with trace.span(
                    "serve.execute", cat="serve", bucket=bucket, rows=n,
                    req_first=futs[0].request_id,
                    req_last=futs[-1].request_id,
                ):
                    out = self.engine._execute(bucket, dev)
                t_exec = time.perf_counter()
                if kprof.enabled():
                    self.engine._profile_bucket(bucket, t_exec - t_exec_start)
                with trace.io_span(
                    "serve.d2h",
                    int(out.numel() * out.element_size()), cat="serve",
                    bucket=bucket,
                ):
                    host = self.engine._d2h(out)
                t_d2h = time.perf_counter()
            except Exception as e:  # noqa: BLE001 — OOM degrades, in-line
                # A batch already in flight when the previous batch's OOM
                # retired its bucket re-routes like the OOM batch's own.
                retired_race = (
                    isinstance(e, ServingUnavailable)
                    and bucket not in self.engine.buckets()
                )
                if not kmem.is_oom_error(e) and not retired_race:
                    raise
                if not retired_race:
                    self.engine._retire_bucket(
                        bucket, "hit out of memory under burst traffic"
                    )
                kmem.free_buffers(dev)
                host = self.engine.infer(rows)
                t_exec = t_d2h = time.perf_counter()
                degraded = True
        except BaseException as e:  # noqa: BLE001 — typed delivery
            counters.record(
                "serve_batch_failed", f"{type(e).__name__}: {e}"
            )
            self._fail_futs(futs, e)
            return
        if not degraded:
            # The degraded path already observed through infer()'s chunks.
            self.engine.observe_output(
                host[:n],
                request_ids=[f.request_id for f in futs],
                bucket=bucket,
            )
        self.stats.batches += 1
        self.stats.answered += n
        self.stats.occupancy_sum += n / bucket
        trace.metrics.inc("serve_batches")
        trace.metrics.observe("serve_batch_occupancy", n / bucket)
        trace.metrics.gauge("serve_mean_occupancy", self.stats.occupancy())
        pad = bucket - n if bucket > n else 0
        execute_ms = (t_exec - t_exec_start) * 1e3
        now = time.perf_counter()
        for i, fut in enumerate(futs):
            # Where this request's latency went: queue-wait, H2D,
            # device-wait (parked behind the previous micro-batch),
            # execute, D2H, answer, and the pad overhead estimate.
            queue_ms = (t_assembled - fut.t_submit) * 1e3
            latency_ms = (now - fut.t_submit) * 1e3
            fut.phases = {
                "request_id": fut.request_id,
                "bucket": bucket,
                "rows": n,
                "pad_rows": pad,
                "queue_wait_ms": round(queue_ms, 3),
                "h2d_ms": round((t_h2d_done - t_assembled) * 1e3, 3),
                "device_wait_ms": round(
                    (t_exec_start - t_h2d_done) * 1e3, 3
                ),
                "execute_ms": round(execute_ms, 3),
                "d2h_ms": round((t_d2h - t_exec) * 1e3, 3),
                "answer_ms": round((now - t_d2h) * 1e3, 3),
                "pad_overhead_ms": round(execute_ms * pad / bucket, 3),
                "latency_ms": round(latency_ms, 3),
            }
            if degraded:
                fut.phases["degraded"] = True
            fut._resolve(value=host[i])
            self.slo.observe(latency_ms, ok=True)
            trace.metrics.observe("serve_latency_ms", latency_ms)
            trace.metrics.observe("serve_queue_wait_ms", queue_ms)
            trace.metrics.observe("serve_device_wait_ms",
                                  fut.phases["device_wait_ms"])
            trace.metrics.observe("serve_execute_ms", execute_ms)
            trace.metrics.inc("serve_requests")
            with trace.span("serve.request", cat="serve") as sp:
                sp.set(**fut.phases)
        with self._cond:
            self._outstanding -= n
            self._cond.notify_all()

    def _fail_futs(self, futs, error: BaseException) -> None:
        now = time.perf_counter()
        resolved = 0
        for fut in futs:
            if not fut.done():
                fut._resolve(error=error)
                resolved += 1
                # A typed failure burns error budget like an SLO miss.
                self.slo.observe((now - fut.t_submit) * 1e3, ok=False)
        if resolved:
            with self._cond:
                self.stats.failed += resolved
                self._outstanding -= resolved
                self._cond.notify_all()

    # -- lifecycle ------------------------------------------------------------

    def _shutdown(self, error: BaseException | None = None) -> None:
        with self._cond:
            self._stopped = True
            pending = list(self._queue)
            self._queue.clear()
            self._cond.notify_all()
        with self._inflight_cond:
            self._inflight_cond.notify_all()
        err = error or ServingUnavailable(
            "server closed with requests still pending"
        )
        self._fail_futs([fut for _, fut in pending], err)

    def outstanding(self) -> int:
        """Futures minted by :meth:`submit` and not yet resolved."""
        with self._cond:
            return self._outstanding

    def drain(self, timeout: float = 30.0) -> bool:
        """Block until every submitted request has been RESOLVED (answered
        or typed-failed) — the graceful-retire primitive.  False on
        timeout."""
        end = time.monotonic() + timeout
        with self._cond:
            while self._outstanding > 0:
                remaining = end - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(min(remaining, _POLL_SECONDS))
        return True

    def close(self) -> None:
        """Stop accepting requests; pending/in-flight requests answer
        :class:`ServingUnavailable`.  Idempotent."""
        self._shutdown()

    def join(self, timeout: float = 10.0) -> bool:
        """Wait for both serving threads to exit.  Call after
        :meth:`close`."""
        end = time.monotonic() + timeout
        self._assembler.join(max(0.0, end - time.monotonic()))
        self._executor.join(max(0.0, end - time.monotonic()))
        return not (self._assembler.is_alive() or self._executor.is_alive())

    def __enter__(self) -> "Server":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
        self.join()


# -- the SLO bench ------------------------------------------------------------


def _percentile(sorted_vals: Sequence[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    return float(sorted_vals[min(len(sorted_vals) - 1, int(q * len(sorted_vals)))])


#: The request-lifecycle phases aggregated by :func:`phase_breakdown`.
PHASE_KEYS = (
    "queue_wait_ms", "h2d_ms", "device_wait_ms", "execute_ms", "d2h_ms",
    "answer_ms", "pad_overhead_ms",
)


def phase_breakdown(phases: Sequence[dict]) -> dict:
    """Aggregate per-request phase decompositions (``ServeFuture.phases``)
    into mean/p99 per phase."""
    out: dict = {"requests": len(phases)}
    for key in PHASE_KEYS:
        vals = sorted(p[key] for p in phases if key in p)
        if not vals:
            continue
        out[key] = {
            "mean": round(sum(vals) / len(vals), 3),
            "p99": round(_percentile(vals, 0.99), 3),
        }
    if phases:
        out["degraded_requests"] = sum(1 for p in phases if p.get("degraded"))
    return out


def serve_bench(
    engine: ServingEngine,
    requests: np.ndarray,
    *,
    clients: int = 4,
    depth: int = 4,
    unbatched_baseline: bool = True,
    timeout: float = 120.0,
) -> dict:
    """Drive ``clients`` concurrent synthetic clients over ``requests``
    (``[N, *example_shape]`` rows, split round-robin; each client keeps
    ``depth`` requests outstanding) and record the online SLOs: p50/p99
    latency, sustained QPS, batcher occupancy, the batched-vs-unbatched QPS
    ratio (the SAME engine behind a flush-per-request server) and
    bit-equality of every served answer against the offline apply."""
    requests = np.asarray(requests)
    offline = engine.offline(requests)
    # With parity unverified the bar is determinism against the engine's
    # own bucketed apply.
    graph_oracle = None if engine.parity_ok else engine.infer(requests)

    def drive(server: Server) -> tuple[float, list, np.ndarray, list]:
        lat: list = []
        phases: list = []
        answers: list = [None] * requests.shape[0]
        errors: list = []

        def client(cid: int):
            pending: list = []

            def resolve(fut, i):
                answers[i] = fut.result(timeout)
                lat.append(fut.latency_seconds())
                if fut.phases is not None:
                    phases.append(fut.phases)

            try:
                for i in range(cid, requests.shape[0], clients):
                    pending.append((server.submit(requests[i]), i))
                    if len(pending) >= max(1, depth):
                        resolve(*pending.pop(0))
                for fut, i in pending:
                    resolve(fut, i)
            except BaseException as e:  # noqa: BLE001 — surfaced below
                errors.append(e)

        threads = [
            threading.Thread(target=client, args=(c,), daemon=True)
            for c in range(clients)
        ]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout)
        wall = time.perf_counter() - t0
        if errors:
            raise errors[0]
        return wall, lat, np.stack(answers), phases

    with Server(engine) as server:
        wall, lat, answers, phases = drive(server)
        stats = server.stats
        slo = server.slo.summary()
    lat_ms = sorted(v * 1e3 for v in lat)
    record = {
        "engine": engine.record(),
        "clients": clients,
        "requests": int(requests.shape[0]),
        "qps": round(requests.shape[0] / wall, 2),
        "p50_latency_ms": round(_percentile(lat_ms, 0.50), 3),
        "p99_latency_ms": round(_percentile(lat_ms, 0.99), 3),
        "max_latency_ms": round(lat_ms[-1], 3) if lat_ms else 0.0,
        "batcher": stats.record(),
        "phase_breakdown": phase_breakdown(phases),
        "slo": slo,
        "predictions_bit_identical": bool(np.array_equal(answers, offline)),
    }
    if engine.drift is not None:
        record["output_drift"] = engine.drift.record()
    if graph_oracle is not None:
        record["parity_unverified"] = True
        record["predictions_deterministic"] = bool(
            np.array_equal(answers, graph_oracle)
        )
    if unbatched_baseline:
        # Batching OFF, everything else identical: the same engine behind a
        # server that flushes every request alone.
        un_cfg = ServeConfig(
            buckets=(1,),
            max_wait_ms=0.0,
            donate=engine.config.donate,
            eager_flush=engine.config.eager_flush,
        )
        with Server(engine, config=un_cfg) as server:
            u_wall, _u_lat, u_answers, _u_phases = drive(server)
        record["unbatched_qps"] = round(requests.shape[0] / u_wall, 2)
        record["batched_vs_unbatched_qps"] = round(
            record["qps"] / max(record["unbatched_qps"], 1e-9), 2
        )
        record["unbatched_bit_identical"] = bool(
            np.array_equal(u_answers, offline)
        )
        if graph_oracle is not None:
            record["unbatched_deterministic"] = bool(
                np.array_equal(u_answers, graph_oracle)
            )
    return record
