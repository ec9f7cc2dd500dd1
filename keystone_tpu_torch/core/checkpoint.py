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

A port save records one device and only replicated arrays.  Loading a
checkpoint whose arrays the JAX package saved sharded over a mesh raises
:class:`CheckpointMismatch`: the reshard loader is not ported.

Public surface:
  save_pipeline(path, pipe, numerics_baseline) -> writes <stem>.npz + <stem>.json
  load_pipeline(path, device="cuda")           -> rebuilt object, tensors on device
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


class CheckpointError(RuntimeError):
    """Unserializable node, missing/corrupt artifact, or schema mismatch."""


class CheckpointMismatch(CheckpointError):
    """The checkpoint holds arrays that were sharded over a device mesh
    (written by the JAX package under a mesh); restoring them here would
    silently change the placement of a model that was solved distributed.
    Re-load on the recorded topology in the JAX package, or re-fit."""


def _current_topology() -> dict:
    """Device fingerprint recorded into every manifest, in the JAX
    package's keys: the platform, the visible device count, no mesh."""
    cuda = torch.cuda.is_available()
    return {
        "platform": "gpu" if cuda else "cpu",
        "device_count": torch.cuda.device_count() if cuda else 1,
        "mesh": None,
    }


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
        self._n = 0

    def add_array(self, v) -> str:
        key = f"a{self._n}"
        self._n += 1
        arr, name = _host_array(v)
        shape = list(v.shape)
        spec = {"dtype": name, "shape": shape}
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
        if isinstance(v, (torch.Tensor, np.ndarray, np.generic)):
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


def _decode(spec: dict, arrays, array_specs: dict, where: str, device) -> Any:
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
        return _tensor(arrays[key], aspec, where, key, device)
    if t == "dtype":
        dt = _TORCH_DTYPES.get(spec["v"])
        if dt is None:
            raise CheckpointError(f"{where}: dtype {spec['v']!r} has no torch counterpart")
        return dt
    if t in ("list", "tuple"):
        vals = [_decode(s, arrays, array_specs, f"{where}[{i}]", device)
                for i, s in enumerate(spec["v"])]
        return tuple(vals) if t == "tuple" else vals
    if t == "dict":
        return {k: _decode(s, arrays, array_specs, f"{where}[{k!r}]", device)
                for k, s in spec["v"].items()}
    if t == "pipeline":
        return Pipeline([_decode(s, arrays, array_specs, f"{where}.nodes[{i}]", device)
                         for i, s in enumerate(spec["nodes"])])
    if t == "blm":
        from ..solvers.block import BlockLinearMapper

        return BlockLinearMapper(
            list(_decode(spec["xs"], arrays, array_specs, f"{where}.xs", device)),
            int(spec["block_size"]),
            _decode(spec["b"], arrays, array_specs, f"{where}.b", device),
            list(_decode(spec["scalers"], arrays, array_specs, f"{where}.scalers", device)),
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
                    obj, f, _decode(spec[group][f], arrays, array_specs, f"{where}.{f}", device)
                )
        restore = getattr(obj, "_restore", None)
        if restore is not None:
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
        "all_replicated": True,
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


def load_pipeline(path: str, device="cuda"):
    """Rebuild a fitted node/pipeline saved by :func:`save_pipeline` (or by
    the JAX package's), its tensors on ``device`` (the card unless the
    caller asks for the CPU; ``"cuda"`` without a card raises).  Validates
    the format version, the topology guard and every array's dtype/shape
    against the manifest before constructing anything."""
    dev = resolve_device(device)
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
    if not manifest.get("all_replicated", True):
        raise CheckpointMismatch(
            f"{manifest_path}: checkpoint holds sharded (non-replicated) "
            f"arrays recorded under topology {recorded}, and this package "
            f"restores onto one device ({_current_topology()}) — refusing to "
            "silently reshard.  Load it on the recorded topology in the JAX "
            "package, or re-fit"
        )
    if recorded is None:
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
    obj = _decode(manifest["root"], arrays, manifest["arrays"], "root", dev)
    _logger.info("loaded checkpoint %s (%d arrays) onto %s", npz_path, len(arrays), dev)
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
