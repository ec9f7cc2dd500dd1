"""Pipeline DSL core (counterpart of keystone_tpu/core/pipeline.py:92-548).

The composition algebra — ``then`` / ``then_estimator`` /
``then_label_estimator`` and the closure semantics of ``then_estimator``
(fitting the chained estimator first pushes the data through the upstream
transformer) — is the JAX package's.  Nodes are plain Python classes holding
tensors; PyTorch runs eagerly, so a ``Pipeline`` is plain function
composition.  Fitted node classes are registered by name with their data
and meta fields (:func:`register_node`, the JAX package's names and
fields), the schema ``core.checkpoint`` saves and rebuilds them by.  With
the numerics observatory on (``core.numerics``), every node boundary of
``Pipeline.__call__`` is a tensor-stat probe site (but not while the
stream captures a CUDA graph).

The cost-based optimizer's substrate is here too: :func:`track_reuse`
counts node executions on the fit path, :meth:`Pipeline.profile` measures
each node's time and output bytes into a :class:`PipelineProfile` (the JAX
package's JSON, so either package reads the other's), and the memoizing
:class:`Cacher` lets a pipeline re-applied to the very same input object
resume after its last cached node (``core.optimize`` inserts them).

Row-sharded batches (``parallel.mesh.ShardedRows``) flow through a
``Pipeline`` as they are: a node that computes on tensors runs on them
slot by slot (``parallel.mesh.map_rows``, pad rows zeroed again), while a
``Cacher`` and a nested ``Pipeline`` take the record itself.
"""

from __future__ import annotations

import abc
import contextlib
import dataclasses
import json
import threading
import time
from typing import Any, Callable, Sequence

from . import numerics
from . import trace

#: Class name -> (cls, data_fields, meta_fields) for every node registered
#: via :func:`register_node` / :func:`node` — the schema the checkpoint
#: serializer (core.checkpoint) walks to save and rebuild fitted pipelines
#: by name.
NODE_REGISTRY: dict = {}


def register_node(cls, data_fields: Sequence[str] = (), meta_fields: Sequence[str] = ()):
    """Register a node class for checkpointing.

    ``data_fields`` hold fitted state (tensors, nested nodes); ``meta_fields``
    hold static settings (sizes, flags, dtypes).  Loading rebuilds a node
    without calling ``__init__``, setting exactly these fields, as the JAX
    package's pytree unflatten does; a class whose ``__init__`` derives
    state that no field holds defines ``_restore(self)``, which the loader
    calls once the fields are set."""
    NODE_REGISTRY[cls.__name__] = (cls, tuple(data_fields), tuple(meta_fields))
    return cls


def node(data_fields: Sequence[str] = (), meta_fields: Sequence[str] = ()):
    """Class decorator form of :func:`register_node`."""

    def deco(cls):
        return register_node(cls, data_fields, meta_fields)

    return deco


class Transformer(abc.ABC):
    """A deterministic, chainable function node over batches."""

    @abc.abstractmethod
    def __call__(self, batch):  # pragma: no cover - interface
        ...

    def apply_item(self, item):
        return self(item[None])[0]

    def then(self, nxt: "Transformer") -> "Pipeline":
        return Pipeline([self, nxt])

    def __rshift__(self, nxt):
        if isinstance(nxt, Transformer):
            return self.then(nxt)
        if isinstance(nxt, Estimator):
            return self.then_estimator(nxt)
        if isinstance(nxt, LabelEstimator):
            return self.then_label_estimator(nxt)
        return NotImplemented

    def then_function(self, fn: Callable) -> "Pipeline":
        return self.then(FunctionTransformer(fn))

    def then_estimator(self, est: "Estimator") -> "ChainedEstimator":
        return ChainedEstimator(self, est)

    def then_label_estimator(self, est: "LabelEstimator") -> "ChainedLabelEstimator":
        return ChainedLabelEstimator(self, est)


@node(meta_fields=("fn", "name"))
class FunctionTransformer(Transformer):
    """Wrap a plain function as a Transformer."""

    def __init__(self, fn: Callable, name: str | None = None):
        self.fn = fn
        self.name = name or getattr(fn, "__name__", "fn")

    def __call__(self, batch):
        return self.fn(batch)

    def __repr__(self):
        return f"FunctionTransformer({self.name})"


def transformer(fn: Callable) -> FunctionTransformer:
    return FunctionTransformer(fn)


# -- per-node reuse tracking (the auto-Cacher's fit-path measurement) ---------

_reuse_tls = threading.local()


@contextlib.contextmanager
def track_reuse():
    """Count node executions by object identity while the block runs.

    Yields a dict ``id(node) -> execution count``, filled in as pipelines
    run.  Run a workload's fit pattern under it — ``ChainedEstimator.fit``
    pushes the data through the upstream transformer once, applying the
    fitted pipeline pushes it through again — and a node counted twice is
    an intermediate the fit recomputes: a Cacher candidate.  Per thread;
    nesting is not supported (the inner tracker wins until it exits)."""
    counts: dict = {}
    prev = getattr(_reuse_tls, "counts", None)
    _reuse_tls.counts = counts
    try:
        yield counts
    finally:
        _reuse_tls.counts = prev


def _record_exec(node, counts) -> None:
    counts[id(node)] = counts.get(id(node), 0) + 1


def _output_stats(out) -> tuple[int, str | None, tuple | None, int]:
    """(total_bytes, dtype, shape, leaves) of a node output: a single tensor
    or array reports its own dtype and shape (the JAX package's dtype
    names), a list, tuple or dict sums its tensor leaves."""
    if hasattr(out, "nbytes") and hasattr(out, "shape"):
        return int(out.nbytes), _dtype_name(out.dtype), tuple(out.shape), 1
    leaves = [leaf for leaf in _leaves(out) if hasattr(leaf, "nbytes")]
    return sum(int(leaf.nbytes) for leaf in leaves), None, None, len(leaves)


def _leaves(obj):
    if _is_record(obj):
        # Each slot's tensor (slots of one device share theirs).
        for row in obj.shards:
            yield from row
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _leaves(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _leaves(v)
    elif obj is not None:
        yield obj


def _dtype_name(dtype) -> str:
    """``torch.float32`` -> ``float32``, as numpy and JAX name it."""
    return str(dtype).removeprefix("torch.")


def _synchronize(out) -> None:
    """Wait for the card work behind ``out`` (each CUDA device it lies on)."""
    import torch

    devices = set()
    for leaf in _leaves(out):
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            devices.add(leaf.device)
    for dev in devices:
        torch.cuda.synchronize(dev)


@dataclasses.dataclass
class NodeProfile:
    """Measured profile of one pipeline node on one batch."""

    index: int
    name: str
    seconds: float  #: wall time incl. the card's work (when ``sync=True``)
    output_bytes: int
    dtype: str | None  #: None for multi-leaf outputs
    shape: tuple | None
    leaves: int = 1

    def record(self) -> dict:
        out = dataclasses.asdict(self)
        out["shape"] = list(self.shape) if self.shape is not None else None
        return out


@dataclasses.dataclass
class PipelineProfile:
    """Per-node time and output size of one :meth:`Pipeline.profile` run —
    the two quantities KeystoneML's sampling profiler measured per node to
    decide caching, and what ``core.optimize`` plans from."""

    nodes: list  #: list[NodeProfile], pipeline order
    total_seconds: float
    input_bytes: int
    #: The final output batch (so profiling doubles as an application).
    output: Any = dataclasses.field(default=None, repr=False, compare=False)

    def record(self) -> dict:
        return {
            "total_seconds": round(self.total_seconds, 6),
            "input_bytes": self.input_bytes,
            "nodes": [n.record() for n in self.nodes],
        }

    def to_json(self) -> str:
        """The profile as one JSON document, the JAX package's; round-trips
        through :meth:`from_json` minus the ``output`` batch."""
        return json.dumps(self.record())

    @classmethod
    def from_json(cls, doc: str) -> "PipelineProfile":
        rec = json.loads(doc)
        return cls(
            nodes=[
                NodeProfile(
                    index=n["index"],
                    name=n["name"],
                    seconds=n["seconds"],
                    output_bytes=n["output_bytes"],
                    dtype=n.get("dtype"),
                    shape=tuple(n["shape"]) if n.get("shape") else None,
                    leaves=n.get("leaves", 1),
                )
                for n in rec["nodes"]
            ],
            total_seconds=rec["total_seconds"],
            input_bytes=rec["input_bytes"],
        )

    def summary(self) -> str:
        parts = [
            f"{n.name}: {n.seconds * 1e3:.2f}ms -> {n.output_bytes}B"
            for n in self.nodes
        ]
        return f"profile({self.total_seconds * 1e3:.2f}ms): " + " | ".join(parts)


class Pipeline(Transformer):
    """Composition of transformers; itself a transformer.  Nested pipelines
    flatten, so ``(a >> b) >> c`` and ``a >> (b >> c)`` have the same nodes."""

    def __init__(self, nodes: Sequence[Transformer]):
        flat: list[Transformer] = []
        for n in nodes:
            if isinstance(n, Pipeline):
                flat.extend(n.nodes)
            else:
                flat.append(n)
        self.nodes = tuple(flat)
        # Positions of memoizing Cachers (inserted by core.optimize): empty
        # for almost every pipeline, so __call__ pays one truthiness check.
        self._memo_cachers = tuple(
            i for i, n in enumerate(self.nodes)
            if isinstance(n, Cacher) and getattr(n, "memoize", False)
        )

    def __call__(self, batch):
        counts = getattr(_reuse_tls, "counts", None)
        # One flag check when the observatory is off; a probe never
        # changes the value it reads.  A stream capturing a CUDA graph
        # (core.serve) is not probed: a probe reads its stats on the host,
        # which capture forbids; the engine probes the answered rows.
        probing = numerics.active() and not _capturing()
        cachers = self._memo_cachers
        start = 0
        key = None
        if cachers and not _capturing():
            # Resume after the last memoizing Cacher holding this exact
            # input's intermediate: the nodes before it are not recomputed.
            # Inert while a CUDA graph is captured (the graph owns its
            # buffers), as the JAX memo is under a tracer.
            key = batch
            for pos in reversed(cachers):
                hit, value = self.nodes[pos]._memo_lookup(key)
                if hit:
                    batch = value
                    start = pos + 1
                    break
        for i in range(start, len(self.nodes)):
            n = self.nodes[i]
            if counts is not None:
                _record_exec(n, counts)
            batch = _apply(n, batch)
            if probing:
                numerics.probe(f"pipeline.{_node_label(n)}", batch)
            if key is not None and i in cachers:
                n._memo_store(key, batch)
        return batch

    def apply_item(self, item):
        for n in self.nodes:
            item = n.apply_item(item)
        return item

    def profile(self, batch, sync: bool = True) -> PipelineProfile:
        """Run the pipeline node by node on ``batch``, measuring each node's
        wall time and output bytes, dtype and shape.  ``sync=True`` waits
        for the card after each node (``torch.cuda.synchronize`` on the
        output's device), so a node's time holds its own card work rather
        than leaking into the next node's.  Each node is a ``node:<label>``
        span under ``pipeline.profile`` carrying the same numbers, and,
        with the numerics observatory on, a ``profile.<label>`` probe."""
        profiles = []
        in_bytes, _, _, _ = _output_stats(batch)
        t_start = time.perf_counter()
        with trace.span("pipeline.profile", nodes=len(self.nodes)):
            for i, n in enumerate(self.nodes):
                label = _node_label(n)
                with trace.span(f"node:{label}", index=i) as sp:
                    t0 = time.perf_counter()
                    batch = _apply(n, batch)
                    if sync:
                        _synchronize(batch)
                    dt = time.perf_counter() - t0
                    if numerics.active():
                        numerics.probe(f"profile.{label}", batch)
                    nbytes, dtype, shape, leaves = _output_stats(batch)
                    sp.set(
                        seconds=round(dt, 6),
                        output_bytes=nbytes,
                        dtype=dtype,
                        shape=list(shape) if shape is not None else None,
                    )
                profiles.append(NodeProfile(
                    index=i, name=label, seconds=dt, output_bytes=nbytes,
                    dtype=dtype, shape=shape, leaves=leaves,
                ))
        return PipelineProfile(
            nodes=profiles,
            total_seconds=time.perf_counter() - t_start,
            input_bytes=in_bytes,
            output=batch,
        )

    def __repr__(self):
        return "Pipeline(" + " >> ".join(repr(n) for n in self.nodes) + ")"


def _apply(n: Transformer, batch):
    """``n`` on ``batch``; on row-sharded rows slot by slot
    (``parallel.mesh.map_rows``) unless ``n`` is a ``Cacher`` or a
    ``Pipeline``, which take the record itself."""
    if isinstance(n, (Cacher, Pipeline)) or not _is_record(batch):
        return n(batch)
    from ..parallel.mesh import map_rows

    return map_rows(n, batch)


def _is_record(obj) -> bool:
    """Is ``obj`` a mesh layout record (``ShardedRows``, ``SpecLayout``)?"""
    from ..parallel.mesh import ShardedRows, SpecLayout

    return isinstance(obj, (ShardedRows, SpecLayout))


def _capturing() -> bool:
    import torch

    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def _node_label(n: Transformer) -> str:
    """Stable display name for a pipeline node (FunctionTransformers carry
    their wrapped function's name)."""
    name = getattr(n, "name", None)
    if isinstance(name, str) and name:
        return name
    return type(n).__name__


class Estimator(abc.ABC):
    """Unlabeled fit: data -> fitted Transformer."""

    @abc.abstractmethod
    def fit(self, data) -> Transformer:  # pragma: no cover - interface
        ...


class LabelEstimator(abc.ABC):
    """Labeled fit: (data, labels) -> fitted Transformer."""

    @abc.abstractmethod
    def fit(self, data, labels) -> Transformer:  # pragma: no cover
        ...


class FunctionEstimator(Estimator):
    def __init__(self, fn: Callable[[Any], Transformer]):
        self.fn = fn

    def fit(self, data):
        return self.fn(data)


def _apply_counted(xform: Transformer, data):
    """Apply ``xform`` with reuse tracking for bare transformers too: a
    Pipeline counts its own nodes, a single node applied directly would
    otherwise be invisible to :func:`track_reuse`."""
    counts = getattr(_reuse_tls, "counts", None)
    if counts is not None and not isinstance(xform, Pipeline):
        _record_exec(xform, counts)
    return xform(data)


class ChainedEstimator(Estimator):
    """``xform then_estimator est``: fit maps data through ``xform`` and
    returns ``xform >> est.fit(xform(data))``."""

    def __init__(self, xform: Transformer, est: Estimator):
        self.xform = xform
        self.est = est

    def fit(self, data):
        return self.xform.then(self.est.fit(_apply_counted(self.xform, data)))


class ChainedLabelEstimator(LabelEstimator):
    def __init__(self, xform: Transformer, est: LabelEstimator):
        self.xform = xform
        self.est = est

    def fit(self, data, labels):
        return self.xform.then(self.est.fit(_apply_counted(self.xform, data), labels))


class FunctionNode:
    """A non-item-wise node (e.g. a patch extractor that changes the batch
    size).  Just a named callable."""

    def __call__(self, arg):
        raise NotImplementedError


@node()
class Identity(Transformer):
    def __call__(self, batch):
        return batch

    def __repr__(self):
        return "Identity()"


@node(meta_fields=("name", "sharding", "memoize"))
class Cacher(Transformer):
    """Materialization barrier (reference nodes/util/Cacher.scala:13-23).

    Spark's ``.cache()`` becomes: commit the value to what ``sharding``
    names and, on a card, wait until each device holding it is done.  A
    ``torch.device`` (or its name) moves the value there; a mesh layout
    (``parallel.mesh.SpecSharding``, as ``core.autoshard.spec_sharding``
    lowers a spec) lays it out on the mesh with ``place``, a record already
    in that layout passing through unchanged and any other record gathered
    first; None keeps the value where it is.  The nodes after a mesh
    layout see the record (``Pipeline`` runs them slot by slot).

    ``memoize=True`` (set by ``core.optimize``) makes the barrier also
    remember one materialized value, keyed on the identity of the
    *pipeline input* that produced it: a :class:`Pipeline` holding this
    node skips the nodes before it when re-applied to the very same input
    object, as Spark's second pass read the cached partitions.  Single
    entry by design (the fit path's training batch); a different input
    computes normally and is not stored, so applying the fitted pipeline
    to test data never evicts the training cache.  The memo is runtime
    state: it is never checkpointed, and it is inert while a CUDA graph is
    captured."""

    def __init__(self, name: str | None = None, sharding=None, memoize: bool = False):
        self.name = name
        self.sharding = sharding
        self.memoize = memoize

    def __call__(self, batch):
        import torch

        from ..parallel.mesh import SpecSharding, require_local

        if _capturing():
            return batch  # the graph owns its buffers
        if isinstance(self.sharding, SpecSharding):
            require_local(self.sharding.mesh, f"Cacher {self.name!r}")
            if not self.sharding.holds(batch):
                if _is_record(batch):
                    batch = batch.gather()
                elif not isinstance(batch, torch.Tensor):
                    batch = torch.as_tensor(batch)
                batch = self.sharding.place(batch)
        elif isinstance(self.sharding, (torch.device, str)):
            batch = _to_device(batch, torch.device(self.sharding))
        elif self.sharding is not None:
            raise TypeError(
                f"Cacher sharding {self.sharding!r}: give a torch.device or a "
                "parallel.mesh.SpecSharding"
            )
        _synchronize(batch)
        return batch

    # -- memo plumbing (driven by Pipeline.__call__, keyed on ITS input) ------

    def _memo_lookup(self, key) -> tuple[bool, Any]:
        memo = getattr(self, "_memo", None)
        if memo is not None and memo[0] is key:
            return True, memo[1]
        return False, None

    def _memo_store(self, key, value) -> None:
        # First key wins: the fit path arms the cache with the training
        # batch.  The key is held strongly so its id() cannot be reused
        # while the entry lives.
        if getattr(self, "_memo", None) is None:
            self._memo = (key, value)

    def clear_memo(self) -> None:
        """Release the cached intermediate (and its device memory)."""
        self._memo = None

    def __repr__(self):
        memo = ", memoize" if getattr(self, "memoize", False) else ""
        return f"Cacher({self.name or ''}{memo})"


def _to_device(obj, device):
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_device(v, device) for v in obj)
    if isinstance(obj, dict):
        return {k: _to_device(v, device) for k, v in obj.items()}
    return torch.as_tensor(obj, device=device)
