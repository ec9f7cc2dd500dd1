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
stream captures a CUDA graph).  The profiling,
reuse-tracking and Cacher machinery of the JAX package is not ported.
"""

from __future__ import annotations

import abc
from typing import Any, Callable, Sequence

from . import numerics

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

    def __call__(self, batch):
        # One flag check when the observatory is off; a probe never
        # changes the value it reads.  A stream capturing a CUDA graph
        # (core.serve) is not probed: a probe reads its stats on the host,
        # which capture forbids; the engine probes the answered rows.
        probing = numerics.active() and not _capturing()
        for n in self.nodes:
            batch = n(batch)
            if probing:
                numerics.probe(f"pipeline.{_node_label(n)}", batch)
        return batch

    def apply_item(self, item):
        for n in self.nodes:
            item = n.apply_item(item)
        return item

    def __repr__(self):
        return "Pipeline(" + " >> ".join(repr(n) for n in self.nodes) + ")"


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


class ChainedEstimator(Estimator):
    """``xform then_estimator est``: fit maps data through ``xform`` and
    returns ``xform >> est.fit(xform(data))``."""

    def __init__(self, xform: Transformer, est: Estimator):
        self.xform = xform
        self.est = est

    def fit(self, data):
        return self.xform.then(self.est.fit(self.xform(data)))


class ChainedLabelEstimator(LabelEstimator):
    def __init__(self, xform: Transformer, est: LabelEstimator):
        self.xform = xform
        self.est = est

    def fit(self, data, labels):
        return self.xform.then(self.est.fit(self.xform(data), labels))


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
