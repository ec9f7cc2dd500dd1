"""Checkpoint/restore of fitted pipelines (counterpart of
keystone_tpu/core/checkpoint.py), in the JAX package's on-disk format, so
each package reads the other's files.

Every fitted node class is registered by name with its data and meta fields
(``core.pipeline.register_node``), so any fitted node — or a whole
``a >> b`` pipeline, or a dict/list bundle of them — serializes
generically:

* all tensor leaves land in ONE ``<stem>.npz`` (host numpy arrays;
  dtypes numpy cannot hold, such as bfloat16, ride as raw bytes with the
  true dtype recorded);
* the tree structure goes to a ``<stem>.json`` manifest: a versioned schema
  naming each node class (resolved through ``pipeline.NODE_REGISTRY`` on
  load) plus per-array dtype/shape, validated before any state is touched.

Writes are atomic (tmp file + ``os.replace``), and the manifest carries the
``.npz``'s hash, so a preempted save never leaves a pair a later
``load_or_fit`` would trust.

**Sharding records.**  The manifest records the topology of the save (the
platform, the device count and the ambient ``parallel.mesh.use_mesh``
shape, slots counted as devices) and, per array, the layout it was split
in, in ``core.autoshard``'s spec vocabulary: a leaf that is a
``ShardedRows`` records ``data@dim0``, a ``SpecLayout`` the spec its
``SpecSharding`` was lowered from.  Either is gathered to the host in data
order first, and clears ``all_replicated`` when it is split over more than
one slot.  A plain tensor records as replicated, so the servables the
workloads save (the mesh tiers unshard their models) stay all-replicated.
Each package reads the other's sharded files.

**Loading.**  With ``mesh=None`` a checkpoint holding sharded arrays loads
only on the topology it recorded: elsewhere :class:`CheckpointMismatch`
names both topologies and the ``mesh=`` way out.  With a port ``Mesh``
every array is placed onto that mesh by :class:`_Resharder`: its recorded
spec re-lowered where the dimension still divides the axis, else
replicated, each placement charged per slot against the mesh's slot
budget, and a placement nothing admits a typed :class:`CheckpointError`.

**Restored nodes on a mesh.**  A leaf placed on a mesh is a layout record
(``ShardedRows`` or ``SpecLayout``), not a tensor, and the port's nodes
compute on tensors; a record handed to a PyTorch operator raises
``parallel.mesh.LayoutLeafError``.  A node computes once it is lowered to
a device: ``parallel.mesh.replicate(node, device)`` turns each record into
the whole tensor on that device (one copy per device, bytes moved, nothing
computed) and builds the node's derived state (``_restore``, deferred
until then).  So ``map_rows(node, rows)`` runs a restored node slot by
slot on sharded rows, and ``replicate(node, x.device)(x)`` on a tensor;
either gives the original node's bits.

**Across processes.**  On a mesh that spans processes
(``parallel.mesh.mesh_spans_processes``) each process materialises only
its own slots' windows of every array from the file (counted
``ckpt_reshard_crosshost``), so no process stages the fleet's state on a
device; the topology record of a save in a group of more than one process
carries ``processes``.

Public surface:
  save_pipeline(path, pipe, numerics_baseline) -> writes <stem>.npz + <stem>.json
  load_pipeline(path, device="cuda")           -> rebuilt object, tensors on device
  load_pipeline(path, mesh=M)                  -> leaves laid out on mesh M
  checkpoint_exists(path)                      -> bool (both files present)
  load_numerics_baseline(path)                 -> the fit-time output sketch or None
  load_or_fit(path, est, *a)                   -> load if present, else fit + save
"""

from __future__ import annotations

import hashlib
import importlib
import io
import json
import logging
import os
import tempfile
from typing import Any

import numpy as np
import torch

from ..parallel.mesh import ShardedRows, SpecLayout, holds_record
from ..utils.platform import resolve_device
from .pipeline import NODE_REGISTRY, Pipeline

_logger = logging.getLogger("keystone_tpu_torch.checkpoint")

FORMAT_NAME = "keystone-tpu-checkpoint"
FORMAT_VERSION = 1

#: numpy dtype name <-> torch dtype for every dtype either package writes.
_TORCH_DTYPES = {
    "bool": torch.bool,
    "uint8": torch.uint8,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
    "complex64": torch.complex64,
    "complex128": torch.complex128,
    "float8_e4m3fn": torch.float8_e4m3fn,
    "float8_e5m2": torch.float8_e5m2,
}
_DTYPE_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}
#: dtypes numpy holds natively inside an .npz; anything else is stored as
#: raw bytes and re-viewed on load.
_RAW = frozenset({"bfloat16", "float8_e4m3fn", "float8_e5m2"})

#: Transfer granularity of the reshard loader: an array above it is copied
#: to the mesh window by window from the host (``SpecSharding.place_staged``)
#: instead of in one copy, so no device stages a whole large array.
RESHARD_CHUNK_ENV = "KEYSTONE_RESHARD_CHUNK_BYTES"
_DEFAULT_RESHARD_CHUNK = 64 * 2**20


class CheckpointError(RuntimeError):
    """Unserializable node, missing/corrupt artifact, or schema mismatch."""


class CheckpointMismatch(CheckpointError):
    """The checkpoint was written under a different device/mesh topology
    than the loading process and its arrays were not all replicated:
    restoring them would silently change the placement of a model that was
    solved distributed.  Load it with ``mesh=``, on the recorded topology,
    or re-fit."""


def _current_topology() -> dict:
    """Device fingerprint recorded into every manifest, in the JAX
    package's keys: the platform, the visible device count and the ambient
    ``use_mesh`` shape (its slots counted as devices), if any."""
    from ..parallel.mesh import current_mesh

    from ..parallel import distributed as kdist

    cuda = torch.cuda.is_available()
    mesh = current_mesh()
    topo = {
        "platform": "gpu" if cuda else "cpu",
        "device_count": torch.cuda.device_count() if cuda else 1,
        "mesh": dict(mesh.shape) if mesh is not None else None,
    }
    # A process group of more than one rank fingerprints its world size too
    # (omitted single-process, so earlier checkpoints still compare equal).
    st = kdist.group_state()
    if st is not None and st.process_group and st.world > 1:
        topo["processes"] = st.world
    return topo


def _record_spec(v) -> str:
    """The spec a layout record is split in: ``data@dim0`` for a
    ``ShardedRows`` over more than one data slot, the spec of a
    ``SpecLayout``'s sharding, ``replicated`` when every slot holds the
    whole array."""
    if isinstance(v, ShardedRows):
        return "data@dim0" if v.mesh.shape["data"] > 1 else "replicated"
    return v.sharding.spec_string


def checkpoint_paths(path: str) -> tuple[str, str]:
    """``path`` is a stem (``.npz``/``.json`` suffixes are stripped if
    given); returns (npz_path, manifest_path)."""
    stem, ext = os.path.splitext(path)
    if ext not in (".npz", ".json"):
        stem = path
    return stem + ".npz", stem + ".json"


def checkpoint_exists(path: str) -> bool:
    npz, manifest = checkpoint_paths(path)
    return os.path.exists(npz) and os.path.exists(manifest)


def _atomic_write_bytes(path: str, data: bytes) -> None:
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path) + ".tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            fh.write(data)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _host_array(v) -> tuple[np.ndarray, str]:
    """(host array as written to the .npz, true dtype name)."""
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu().contiguous()
        name = _DTYPE_NAMES.get(t.dtype)
        if name is None:
            raise CheckpointError(f"tensor dtype {t.dtype} has no checkpoint name")
        if name in _RAW:
            return t.reshape(-1).view(torch.uint8).numpy().copy(), name
        return t.numpy(), name
    arr = np.asarray(v)
    return arr, arr.dtype.name


class _Encoder:
    def __init__(self):
        self.arrays: dict[str, np.ndarray] = {}
        self.specs: dict[str, dict] = {}
        self.all_replicated = True
        self._n = 0

    def add_array(self, v) -> str:
        key = f"a{self._n}"
        self._n += 1
        sharding = "replicated"
        if isinstance(v, (ShardedRows, SpecLayout)):
            sharding = _record_spec(v)
            v = v.gather()
        arr, name = _host_array(v)
        shape = list(v.shape)
        spec = {"dtype": name, "shape": shape}
        if sharding != "replicated":
            # Absent means replicated: a reshard load re-lowers this spec.
            spec["sharding"] = sharding
            self.all_replicated = False
        if name in _RAW or arr.dtype.kind not in "biufc":
            # raw-bytes transport for npz-hostile dtypes (e.g. bfloat16)
            spec["raw"] = True
            arr = np.frombuffer(arr.tobytes(), np.uint8)
        self.arrays[key] = arr
        self.specs[key] = spec
        return key

    def encode(self, v, where: str) -> dict:
        if v is None:
            return {"t": "none"}
        if isinstance(v, (bool, int, float, str)):
            return {"t": "py", "v": v}
        if isinstance(v, (torch.Tensor, np.ndarray, np.generic, ShardedRows, SpecLayout)):
            return {"t": "arr", "k": self.add_array(v)}
        if isinstance(v, torch.dtype):
            if v not in _DTYPE_NAMES:
                raise CheckpointError(f"{where}: dtype {v} has no checkpoint name")
            # The JAX package writes its dtype aliases (jnp.bfloat16) the
            # same way: a type-valued dtype, rebuilt there as a numpy type.
            return {"t": "dtype", "v": _DTYPE_NAMES[v], "as_type": True}
        if isinstance(v, np.dtype):
            return {"t": "dtype", "v": v.name, "as_type": False}
        if isinstance(v, (list, tuple)):
            return {
                "t": "tuple" if isinstance(v, tuple) else "list",
                "v": [self.encode(x, f"{where}[{i}]") for i, x in enumerate(v)],
            }
        if isinstance(v, dict):
            if not all(isinstance(k, str) for k in v):
                raise CheckpointError(f"{where}: dict keys must be strings")
            return {
                "t": "dict",
                "v": {k: self.encode(x, f"{where}[{k!r}]") for k, x in v.items()},
            }
        if isinstance(v, Pipeline):
            return {
                "t": "pipeline",
                "nodes": [self.encode(n, f"{where}.nodes[{i}]") for i, n in enumerate(v.nodes)],
            }
        # BlockLinearMapper has its own entry type in the format (the JAX
        # package registers its pytree by hand), looked up by name.
        if type(v).__name__ == "BlockLinearMapper":
            return {
                "t": "blm",
                "xs": self.encode(list(v.xs), f"{where}.xs"),
                "b": self.encode(v.b, f"{where}.b"),
                "scalers": self.encode(list(v.feature_scalers), f"{where}.feature_scalers"),
                "block_size": int(v.block_size),
            }
        entry = NODE_REGISTRY.get(type(v).__name__)
        if entry is not None and type(v) is entry[0]:
            _, data_fields, meta_fields = entry
            return {
                "t": "node",
                "cls": type(v).__name__,
                "data": {f: self.encode(getattr(v, f), f"{where}.{f}") for f in data_fields},
                "meta": {f: self.encode(getattr(v, f), f"{where}.{f}") for f in meta_fields},
            }
        raise CheckpointError(
            f"{where}: cannot serialize {type(v).__name__!r} — not a "
            "registered node (see core.pipeline.register_node) and not a "
            "plain tensor/scalar/container.  Function-valued nodes "
            "(FunctionTransformer) hold live Python objects and are not "
            "checkpointable."
        )


def _tensor(arr: np.ndarray, aspec: dict, where: str, key: str, device) -> torch.Tensor:
    name = aspec["dtype"]
    dtype = _TORCH_DTYPES.get(name)
    if dtype is None:
        raise CheckpointError(f"{where}: array {key!r} has dtype {name!r}, which the port cannot hold")
    shape = [int(d) for d in aspec["shape"]]
    if aspec.get("raw"):
        raw = torch.from_numpy(np.frombuffer(arr.tobytes(), np.uint8).copy())
        if raw.numel() != int(np.prod(shape, dtype=np.int64)) * dtype.itemsize:
            raise CheckpointError(
                f"{where}: array {key!r} holds {raw.numel()} bytes, manifest says "
                f"{name}{shape} — artifact corrupt or schema drift"
            )
        return raw.view(dtype).reshape(shape).to(device)
    if arr.dtype.name != name or list(arr.shape) != shape:
        raise CheckpointError(
            f"{where}: array {key!r} is {arr.dtype.name}{list(arr.shape)}, "
            f"manifest says {name}{shape} — artifact corrupt or schema drift"
        )
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def _decode(spec: dict, arrays, array_specs: dict, where: str, put) -> Any:
    """Rebuild one manifest entry; ``put(arr, aspec, key, where)`` turns
    each array into its leaf (a tensor on the load's device, or a layout
    record on the load's mesh)."""
    t = spec.get("t")
    if t == "none":
        return None
    if t == "py":
        return spec["v"]
    if t == "arr":
        key = spec["k"]
        if key not in arrays:
            raise CheckpointError(f"{where}: array {key!r} missing from .npz")
        aspec = array_specs.get(key)
        if aspec is None:
            raise CheckpointError(f"{where}: array {key!r} missing from manifest")
        return put(arrays[key], aspec, key, where)
    if t == "dtype":
        dt = _TORCH_DTYPES.get(spec["v"])
        if dt is None:
            raise CheckpointError(f"{where}: dtype {spec['v']!r} has no torch counterpart")
        return dt
    if t in ("list", "tuple"):
        vals = [_decode(s, arrays, array_specs, f"{where}[{i}]", put)
                for i, s in enumerate(spec["v"])]
        return tuple(vals) if t == "tuple" else vals
    if t == "dict":
        return {k: _decode(s, arrays, array_specs, f"{where}[{k!r}]", put)
                for k, s in spec["v"].items()}
    if t == "pipeline":
        return Pipeline([_decode(s, arrays, array_specs, f"{where}.nodes[{i}]", put)
                         for i, s in enumerate(spec["nodes"])])
    if t == "blm":
        from ..solvers.block import BlockLinearMapper

        return BlockLinearMapper(
            list(_decode(spec["xs"], arrays, array_specs, f"{where}.xs", put)),
            int(spec["block_size"]),
            _decode(spec["b"], arrays, array_specs, f"{where}.b", put),
            list(_decode(spec["scalers"], arrays, array_specs, f"{where}.scalers", put)),
        )
    if t == "node":
        name = spec["cls"]
        entry = NODE_REGISTRY.get(name)
        if entry is None:
            raise CheckpointError(
                f"{where}: node class {name!r} is not registered in this "
                "process — import the module defining it before loading"
            )
        cls, data_fields, meta_fields = entry
        missing = (set(spec["data"]) ^ set(data_fields)) | (set(spec["meta"]) ^ set(meta_fields))
        if missing:
            raise CheckpointError(
                f"{where}: field schema of {name!r} changed since this "
                f"checkpoint was written (mismatched fields: {sorted(missing)})"
            )
        # Rebuilt as the JAX package unflattens a pytree: no __init__, the
        # registered fields set, then the class's derived state rebuilt.
        obj = object.__new__(cls)
        for group, fields in (("data", data_fields), ("meta", meta_fields)):
            for f in fields:
                object.__setattr__(
                    obj, f, _decode(spec[group][f], arrays, array_specs, f"{where}.{f}", put)
                )
        # Derived state is built from tensors: a node whose leaves landed
        # on a mesh builds it when parallel.mesh.replicate lowers them.
        restore = getattr(obj, "_restore", None)
        if restore is not None and not any(holds_record(getattr(obj, f)) for f in data_fields):
            restore()
        return obj
    raise CheckpointError(f"{where}: unknown manifest entry type {t!r}")


def save_pipeline(path: str, pipe, numerics_baseline: dict | None = None) -> str:
    """Serialize a fitted node / ``Pipeline`` / container of them to
    ``<stem>.npz`` (array leaves) + ``<stem>.json`` (manifest).  Returns
    the stem.  Atomic: a crash mid-save leaves no partial artifact.

    ``numerics_baseline``: an optional fit-time output-distribution sketch
    (``core.numerics.OutputSketch.record()``) persisted in the manifest —
    the reference a serving tier's drift monitor judges live answers
    against.  Pure metadata: it never affects what the pipeline computes."""
    npz_path, manifest_path = checkpoint_paths(path)
    enc = _Encoder()
    root = enc.encode(pipe, "root")
    buf = io.BytesIO()
    np.savez(buf, **enc.arrays)
    npz_bytes = buf.getvalue()
    manifest = {
        "format": FORMAT_NAME,
        "version": FORMAT_VERSION,
        # Ties the pair together: the two files are replaced in separate
        # atomic renames, so the hash check on load rejects a mixed pair.
        "npz_sha256": hashlib.sha256(npz_bytes).hexdigest(),
        "topology": _current_topology(),
        "all_replicated": enc.all_replicated,
        "root": root,
        "arrays": enc.specs,
    }
    if numerics_baseline is not None:
        manifest["numerics_baseline"] = numerics_baseline
    _atomic_write_bytes(npz_path, npz_bytes)
    _atomic_write_bytes(manifest_path, json.dumps(manifest, indent=1).encode("utf-8"))
    _logger.info("saved checkpoint %s (%d arrays, %.1f KiB)", npz_path, len(enc.arrays),
                 len(npz_bytes) / 1024)
    return os.path.splitext(npz_path)[0]


class _Resharder:
    """Places checkpointed host arrays onto a target mesh: the
    ``load_pipeline(mesh=)`` placement engine (the JAX package's, one
    process).

    Per array: the recorded spec (manifest ``"sharding"``) is re-lowered
    onto the mesh (``core.autoshard.spec_sharding``) when its dimension
    still divides the axis there, else the array is replicated.  Every
    placement is charged per slot (``autoshard.spec_chip_bytes``) through
    ``memory.plan_bytes`` against the mesh's slot budget
    (``memory.min_chip_budget``, read once per load).  A replicated
    placement the budget denies falls back to the smallest dividing spec
    (``autoshard.best_spec``), counted ``spec_fallback``; a placement
    nothing admits is a typed ``CheckpointError``, never an out-of-memory
    error halfway through.  An array above ``KEYSTONE_RESHARD_CHUNK_BYTES``
    is copied window by window from the host (``host_staged``); below it,
    in one copy to the first slot's device, which its other slots there
    view.  Both give the same bits.

    On a mesh spanning processes every placement is window by window
    (counted ``crosshost``): each process copies only its own slots'
    windows from the host array, so its transient is bounded by its largest
    window, and the budget is that of its own slots."""

    def __init__(self, mesh):
        from . import memory as kmem
        from ..parallel.mesh import host_local_mesh, mesh_spans_processes

        self.mesh = mesh
        self.crosshost = mesh_spans_processes(mesh)
        self.mesh_shape = dict(mesh.shape)
        raw = os.environ.get(RESHARD_CHUNK_ENV, "").strip()
        self.chunk_bytes = kmem.parse_bytes(raw) if raw else _DEFAULT_RESHARD_CHUNK
        self.budget, _ = kmem.min_chip_budget(host_local_mesh(mesh) if self.crosshost else mesh)
        self.stats = {"arrays": 0, "resharded": 0, "host_staged": 0, "spec_fallback": 0,
                      "crosshost": 0, "bytes": 0}

    def _target_spec(self, t: torch.Tensor, recorded: str) -> str:
        from . import autoshard

        if recorded not in ("replicated", "opaque"):
            try:
                autoshard.spec_pspec(recorded, t.ndim)
                autoshard.spec_chip_bytes(t.shape, t.dtype, recorded, self.mesh_shape)
                return recorded
            except ValueError:
                pass  # the recorded dimension no longer divides: replicate
        return "replicated"

    def put(self, arr: np.ndarray, aspec: dict, key: str, where: str):
        from . import autoshard
        from . import memory as kmem

        t = _tensor(arr, aspec, where, key, "cpu")
        recorded = aspec.get("sharding", "replicated")
        spec = self._target_spec(t, recorded)
        self.stats["arrays"] += 1
        per_slot = autoshard.spec_chip_bytes(t.shape, t.dtype, spec, self.mesh_shape)
        plan = kmem.plan_bytes(f"ckpt_reshard:{key}", output_bytes=per_slot,
                               budget=self.budget)
        if not plan.admitted and spec == "replicated":
            # No slot holds the whole array: split it instead.
            cand = autoshard.best_spec(t, self.mesh_shape)
            if cand["spec"] != "replicated":
                spec, per_slot = cand["spec"], int(cand["per_chip_bytes"])
                self.stats["spec_fallback"] += 1
                plan = kmem.plan_bytes(f"ckpt_reshard:{key}:{spec}", output_bytes=per_slot,
                                       budget=self.budget)
        if not plan.admitted:
            raise CheckpointError(
                f"{where}: array {key!r} ({aspec['dtype']}{list(t.shape)}) does not fit the "
                f"target mesh — {kmem.fmt_bytes(per_slot)}/slot under spec {spec!r} vs "
                f"budget {kmem.fmt_bytes(self.budget or 0)} ({plan.reason})"
            )
        sharding = autoshard.spec_sharding(spec, self.mesh, t.ndim)
        if spec != "replicated" or recorded != "replicated":
            self.stats["resharded"] += 1
        nbytes = t.numel() * t.element_size()
        self.stats["bytes"] += nbytes
        if self.crosshost:
            # Destination-process pull: only this process's windows are
            # copied, whatever the array's size.
            self.stats["crosshost"] += 1
            if nbytes > self.chunk_bytes and t.ndim:
                self.stats["host_staged"] += 1
            return sharding.place_staged(t)
        if nbytes > self.chunk_bytes and t.ndim:
            self.stats["host_staged"] += 1
            return sharding.place_staged(t)
        return sharding.place(t.to(self.mesh.devices[0, 0]))


#: The modules that register the stock node classes.
_STANDARD_MODULES = (
    "ops.stats", "ops.util", "ops.images", "ops.fisher", "ops.sift", "ops.lcs",
    "ops.hog", "ops.daisy", "ops.conv_fused", "solvers.pca", "solvers.gmm",
    "solvers.linear", "solvers.whitening", "solvers.naive_bayes", "solvers.block",
)


def _ensure_standard_registry() -> None:
    """Import the modules that register the stock node classes, so a fresh
    process can load a checkpoint without knowing which modules define its
    nodes."""
    for mod in _STANDARD_MODULES:
        importlib.import_module(f"keystone_tpu_torch.{mod}")


def _read_manifest(manifest_path: str) -> dict:
    try:
        with open(manifest_path) as fh:
            return json.load(fh)
    except (OSError, json.JSONDecodeError) as e:
        raise CheckpointError(f"cannot read manifest {manifest_path}: {e}") from e


def load_pipeline(path: str, device="cuda", mesh=None, report: dict | None = None):
    """Rebuild a fitted node/pipeline saved by :func:`save_pipeline` (or by
    the JAX package's), its tensors on ``device`` (the card unless the
    caller asks for the CPU; ``"cuda"`` without a card raises).  Validates
    the format version, the topology guard and every array's dtype/shape
    against the manifest before constructing anything.

    ``mesh``: ``None`` keeps the strict guard — sharded arrays recorded
    under another topology raise :class:`CheckpointMismatch`.  A port
    ``parallel.mesh.Mesh`` opts in to redistribution: every array leaf is
    laid out on the mesh's slots (``device`` is not read), as
    :class:`_Resharder` says, counted ``ckpt_reshard``; see the module
    docstring for computing with the restored nodes.  On a mesh spanning
    processes only this process's windows are placed (counted
    ``ckpt_reshard_crosshost``).  ``report``, a dict the caller passes,
    receives the mesh load's counts: ``arrays``, ``resharded``,
    ``host_staged``, ``spec_fallback``, ``crosshost`` and ``bytes``."""
    if mesh is None:
        dev = resolve_device(device)
    else:
        for d in {torch.device(mesh.devices[s]) for s in mesh.local_slots()}:
            resolve_device(d)
    _ensure_standard_registry()
    npz_path, manifest_path = checkpoint_paths(path)
    manifest = _read_manifest(manifest_path)
    if manifest.get("format") != FORMAT_NAME:
        raise CheckpointError(f"{manifest_path}: not a {FORMAT_NAME} manifest")
    if manifest.get("version") != FORMAT_VERSION:
        raise CheckpointError(
            f"{manifest_path}: format version {manifest.get('version')} "
            f"(this build reads {FORMAT_VERSION})"
        )
    recorded = manifest.get("topology")
    if mesh is None and recorded is not None and not manifest.get("all_replicated", True):
        current = _current_topology()
        if recorded != current:
            raise CheckpointMismatch(
                f"{manifest_path}: checkpoint holds sharded (non-replicated) "
                f"arrays recorded under topology {recorded} but this process "
                f"is {current} — refusing to silently reshard.  Pass "
                "load_pipeline(..., mesh=<target Mesh>) to redistribute the "
                "state onto the mesh you have, load on the recorded "
                "topology, or re-fit"
            )
    elif mesh is None and recorded is None:
        _logger.warning(
            "%s: no topology recorded (pre-topology-guard checkpoint) — "
            "loading without a placement check", manifest_path,
        )
    try:
        with open(npz_path, "rb") as fh:
            npz_bytes = fh.read()
        want_hash = manifest.get("npz_sha256")
        if want_hash is not None and hashlib.sha256(npz_bytes).hexdigest() != want_hash:
            raise CheckpointError(
                f"{npz_path}: content hash does not match the manifest — "
                "the .npz/.json pair is from two different saves "
                "(preempted overwrite?)"
            )
        with np.load(io.BytesIO(npz_bytes)) as zf:
            arrays = {k: zf[k] for k in zf.files}
    except (OSError, ValueError) as e:
        raise CheckpointError(f"cannot read arrays {npz_path}: {e}") from e
    extra = set(manifest["arrays"]) - set(arrays)
    if extra:
        raise CheckpointError(f"{npz_path}: arrays {sorted(extra)} named in manifest are missing")
    if mesh is None:
        obj = _decode(manifest["root"], arrays, manifest["arrays"], "root",
                      lambda arr, aspec, key, where: _tensor(arr, aspec, where, key, dev))
        _logger.info("loaded checkpoint %s (%d arrays) onto %s", npz_path, len(arrays), dev)
        return obj
    from ..parallel.mesh import mesh_desc
    from .resilience import counters

    resharder = _Resharder(mesh)
    obj = _decode(manifest["root"], arrays, manifest["arrays"], "root", resharder.put)
    st = resharder.stats
    if report is not None:
        report.update(st)
    if st["arrays"]:
        counters.record(
            "ckpt_reshard",
            f"{npz_path}: {st['arrays']} array(s) ({st['bytes']} B) placed onto mesh "
            f"{mesh_desc(mesh)} [{st['resharded']} resharded, {st['host_staged']} "
            f"host-staged, {st['spec_fallback']} spec-fallback]",
        )
    if st["crosshost"]:
        counters.record(
            "ckpt_reshard_crosshost",
            f"{npz_path}: {st['crosshost']} array(s) pulled by destination processes "
            f"across a process-spanning mesh {mesh_desc(mesh)}",
        )
    _logger.info("loaded checkpoint %s resharded onto mesh %s (%d arrays, %d host-staged)",
                 npz_path, mesh_desc(mesh), st["arrays"], st["host_staged"])
    return obj


def load_numerics_baseline(path: str) -> dict | None:
    """The fit-time output-distribution sketch persisted by
    ``save_pipeline(numerics_baseline=...)``, or None (absent entry,
    unreadable manifest).  Advisory metadata — this never raises."""
    _, manifest_path = checkpoint_paths(path)
    try:
        with open(manifest_path) as fh:
            manifest = json.load(fh)
    except (OSError, json.JSONDecodeError) as e:
        _logger.warning("numerics baseline unreadable from %s (%s)", manifest_path, e)
        return None
    baseline = manifest.get("numerics_baseline")
    return dict(baseline) if isinstance(baseline, dict) else None


def load_or_fit(path: str | None, est, *fit_args, save: bool = True, device="cuda",
                **fit_kwargs):
    """Reload the fitted artifact at ``path`` (onto ``device``) if present,
    else fit and (by default) save it there.  ``est`` is an estimator
    (``.fit`` is called with the remaining args) or any callable returning
    the fitted object.  With ``path=None`` this is just the fit."""
    if path and checkpoint_exists(path):
        _logger.info("load_or_fit: restoring fitted state from %s", path)
        return load_pipeline(path, device=device)
    fit = est.fit if hasattr(est, "fit") else est
    fitted = fit(*fit_args, **fit_kwargs)
    if path and save:
        save_pipeline(path, fitted)
    return fitted
