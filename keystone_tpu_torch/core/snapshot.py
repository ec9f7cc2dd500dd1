"""Snapshot cache: decoded (or featurized, or device-format) stream chunks
on disk, keyed by content, so a repeat epoch or run streams at IO speed
(counterpart of keystone_tpu/core/snapshot.py, in its on-disk format).

The first pass over a tar writes its output to disk, and later passes (or
later runs) read it instead of decoding again.  One root directory
(``KEYSTONE_SNAPSHOT_DIR``) holds any number of snapshots, one
subdirectory each, named by a prefix of the snapshot KEY: a sha256 over
everything that fixes the chunk stream bit for bit:

* **tar identity**: basename, size and mtime_ns of every member tar;
* **decode config**: whether the native libjpeg decoder runs, and the
  ``MIN_DIM`` reject floor;
* **chunk assembly**: the stream batch size;
* **mode**: ``decoded`` (f32 image chunks), ``featurized`` (feature rows;
  the key then also folds in the fitted featurizer's digest,
  :func:`featurizer_digest`) or ``device`` (dtype-final padded pixel
  shards, read straight into the host-to-device copy);
* **extra**: a caller's string for anything else that selects or
  transforms members (keep filters, label-file identity).

:func:`snapshot_key` builds the same JSON document as the JAX package, so
for the same tar and settings both packages compute the same key and each
serves the other's decoded and device snapshots.  A featurizer digest goes
through this package's ``core.checkpoint`` encoder and need not equal the
JAX package's: featurized snapshots are scoped per package.

Each snapshot directory holds ``chunk_NNNNN.npz`` shards (one per stream
chunk: indices, member names, payload) and a ``snapshot.json`` manifest
with the full key and every shard's size and sha256.  Shards land in a
``.tmp-*`` sibling directory, and one ``os.replace`` of the directory,
after the manifest is written, commits it: a directory without a committed
manifest is invisible to readers.

Staleness and corruption are never silent: a committed snapshot of the same
tars under another key is a counted miss (``snapshot_stale``), and every
shard is re-hashed when it is read; a mismatch raises
:class:`SnapshotCorrupt`, which ``core.ingest`` turns into a counted
``snapshot_fallback`` to live decode.  This module imports no torch.
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import logging
import os
import shutil
import tempfile

import numpy as np

from . import trace
from .resilience import counters

_logger = logging.getLogger(__name__)

FORMAT_NAME = "keystone-tpu-snapshot"
FORMAT_VERSION = 1
MANIFEST_NAME = "snapshot.json"
#: ``decoded`` — f32 pixel chunks exactly as the ring carried them;
#: ``featurized`` — [b, D] feature rows keyed by the fitted featurizer's
#: digest; ``device`` — DEVICE-FORMAT pixel shards: dtype-final f32,
#: batch dim padded to an 8-row sharding quantum capped at the stream
#: batch size, never compressed and never compacted — a warm epoch reads a
#: shard and hands the bytes straight to the host-to-device copy with no
#: host transform.
MODES = ("decoded", "featurized", "device")

#: environment knobs (README's ``KEYSTONE_*`` table)
SNAPSHOT_DIR_ENV = "KEYSTONE_SNAPSHOT_DIR"
SNAPSHOT_MODE_ENV = "KEYSTONE_SNAPSHOT_MODE"
SNAPSHOT_COMPRESS_ENV = "KEYSTONE_SNAPSHOT_COMPRESS"


class SnapshotError(RuntimeError):
    """Unusable snapshot root / manifest schema violation."""


class SnapshotCorrupt(SnapshotError):
    """A shard's bytes do not match the manifest (truncated/bit-flipped
    file, torn write) — the reader must FALL BACK, counted, never serve
    the bytes."""


def snapshot_dir_env() -> str | None:
    """Snapshot root: ``KEYSTONE_SNAPSHOT_DIR`` env or None (off)."""
    raw = os.environ.get(SNAPSHOT_DIR_ENV, "").strip()
    return raw or None


def snapshot_mode_env() -> str:
    """``KEYSTONE_SNAPSHOT_MODE``: ``decoded`` (default) or ``featurized``."""
    raw = os.environ.get(SNAPSHOT_MODE_ENV, "").strip() or "decoded"
    if raw not in MODES:
        raise ValueError(
            f"{SNAPSHOT_MODE_ENV}={raw!r} must be one of {MODES}"
        )
    return raw


def snapshot_compress_env() -> bool:
    """``KEYSTONE_SNAPSHOT_COMPRESS``: shard compression on the WRITE path
    (``np.savez_compressed``; default ON — decoded uint8 pixels deflate
    well and the warm path is shard-IO-bound, so smaller shards read
    faster).  ``0`` writes plain ``np.savez``.  A READ-side knob does not
    exist on purpose: ``np.load`` handles both formats transparently, so
    shards written under either setting — including every pre-knob
    snapshot — stay readable forever (the key does not fold compression
    in: the decoded BITS are identical either way)."""
    return os.environ.get(SNAPSHOT_COMPRESS_ENV, "").strip() != "0"


# -- keys ---------------------------------------------------------------------


def file_identity(path: str) -> dict:
    """(basename, size, mtime_ns) of one file — the cheap content proxy
    used for tars and label files.  Content-hashing multi-GB tars per run
    would cost a full read; size+mtime is the tf.data/make-style contract
    (touch the input, invalidate the cache)."""
    st = os.stat(path)
    return {
        "name": os.path.basename(path),
        "bytes": int(st.st_size),
        "mtime_ns": int(st.st_mtime_ns),
    }


def tar_identity(path: str) -> list:
    """Identity rows for the tar (or directory of tars) a stream reads —
    same file set as ``image_loaders._tar_files``."""
    from ..loaders.image_loaders import _tar_files

    return [file_identity(p) for p in _tar_files(path)]


def decode_config_record() -> dict:
    """Everything that changes decode OUTPUT BITS: which decoder runs
    (native libjpeg vs PIL differ in IDCT rounding) and the reject floor."""
    from ..loaders import native_decode
    from ..loaders.image_loaders import MIN_DIM

    return {
        "native_decode": bool(native_decode.available()),
        "min_dim": int(MIN_DIM),
    }


def featurizer_digest(obj) -> str:
    """sha256 of a fitted featurizer's checkpoint encoding — the
    ``core.checkpoint`` serialization (registered nodes / pipelines /
    containers of arrays), so any weight or registered-field change moves
    the digest and therefore the snapshot key.  Raises
    :class:`~.checkpoint.CheckpointError` for unserializable objects (a
    featurized snapshot of an un-checkpointable featurizer would be
    un-keyable — refuse rather than cache silently stale)."""
    from .checkpoint import CheckpointError, _Encoder

    class _DigestEncoder(_Encoder):
        # A digest needs stable key material, not a reconstructible
        # artifact: dtype-likes the checkpoint schema refuses hash by their
        # dtype name; everything else still refuses.
        def encode(self, v, where):
            try:
                return super().encode(v, where)
            except CheckpointError:
                try:
                    return {"t": "py", "v": f"dtype:{np.dtype(v).name}"}
                except TypeError:
                    pass
                raise

    enc = _DigestEncoder()
    root = enc.encode(obj, "featurizer")
    buf = io.BytesIO()
    np.savez(buf, **enc.arrays)
    h = hashlib.sha256()
    h.update(json.dumps(root, sort_keys=True).encode())
    h.update(buf.getvalue())
    return h.hexdigest()


def snapshot_key(
    tar_path: str,
    *,
    batch_size: int,
    mode: str = "decoded",
    extra: str | None = None,
    featurizer: str | None = None,
) -> str:
    """The content hash naming one snapshot.  ``featurizer`` is the
    :func:`featurizer_digest` of the fitted featurizer (required when
    ``mode='featurized'`` — decoded pixels don't depend on any model,
    features do)."""
    if mode not in MODES:
        raise ValueError(f"snapshot mode {mode!r} must be one of {MODES}")
    if mode == "featurized" and featurizer is None:
        raise ValueError(
            "featurized snapshots need featurizer= (the fitted featurizer's "
            "digest) — without it a refit would silently reuse stale features"
        )
    doc = {
        "format": FORMAT_NAME,
        "version": FORMAT_VERSION,
        "tar": tar_identity(tar_path),
        "decode": decode_config_record(),
        "batch_size": int(batch_size),
        "mode": mode,
        "extra": extra,
        "featurizer": featurizer,
    }
    return hashlib.sha256(
        json.dumps(doc, sort_keys=True).encode()
    ).hexdigest()


def _dir_for(root: str, key: str) -> str:
    return os.path.join(root, f"snap-{key[:16]}")


# -- writer -------------------------------------------------------------------


class SnapshotWriter:
    """Accumulate chunk shards, then :meth:`commit` atomically.

    Shards are written into a ``.tmp-*`` sibling of the final directory;
    the manifest (with per-shard size + sha256) is written LAST and the
    whole directory renamed into place in one ``os.replace`` — a crash at
    any earlier point leaves only an uncommitted temp directory that
    readers never see.  :meth:`abort` removes the temp directory (early
    consumer exit must not commit a partial snapshot)."""

    def __init__(
        self,
        root: str,
        key: str,
        *,
        mode: str,
        meta: dict | None = None,
        compress: bool | None = None,
    ):
        if mode not in MODES:
            raise ValueError(f"snapshot mode {mode!r} must be one of {MODES}")
        os.makedirs(root, exist_ok=True)
        self._root = root
        self._key = key
        self._mode = mode
        # device-format shards are NEVER compressed (warm reads must be
        # straight IO into H2D, not an inflate pass) — forced here so the
        # manifest's compress field tells the truth too
        self._compress = mode != "device" and (
            snapshot_compress_env() if compress is None else bool(compress)
        )
        self._meta = dict(meta or {})
        self._final = _dir_for(root, key)
        self._tmp = tempfile.mkdtemp(
            prefix=f".tmp-{key[:16]}-", dir=root
        )
        self._chunks: list[dict] = []
        self._images = 0
        self._done = False

    def add_chunk(
        self, index: int, indices, names, payload, *, pad_to: int | None = None
    ) -> None:
        """Write one stream chunk as a shard.  ``payload`` is the decoded
        [b, H, W, C] host batch (mode=decoded), the [b, D] feature rows
        (mode=featurized), or the dtype-final pixel batch (mode=device —
        ``pad_to`` pads the batch dim to the stream batch size with zero
        rows and records the ``valid`` count, so every warm shard is a
        fixed-shape, sharding-ready buffer)."""
        if self._done:
            raise SnapshotError("snapshot writer already committed/aborted")
        payload = np.asarray(payload)
        extra = {}
        if self._mode == "device":
            # dtype-final: the bytes on disk ARE the bytes the warm epoch
            # copies to the device — no cast, no compaction.  The
            # batch dim pads up to an 8-row sharding quantum (divisible
            # across typical data-parallel axes), CAPPED at the stream
            # batch size — padding a lone remainder chunk all the way to
            # a large batch size would multiply its shard bytes for no
            # layout benefit (the reader slices to ``valid`` anyway).
            payload = np.ascontiguousarray(payload, np.float32)
            valid = int(payload.shape[0])
            target = valid
            if pad_to is not None and pad_to > valid:
                target = min(int(pad_to), -(-valid // 8) * 8)
            if target > valid:
                payload = np.concatenate(
                    [
                        payload,
                        np.zeros(
                            (target - valid,) + payload.shape[1:],
                            payload.dtype,
                        ),
                    ]
                )
            extra["valid"] = np.asarray(valid, np.int64)
        if payload.dtype == np.float32 and self._mode == "decoded":
            # Decoded pixels are integral f32 straight off uint8 JPEG
            # samples — store them as uint8 (4x less shard IO, the whole
            # point of the cache) ONLY when the round trip is bit-exact.
            # Featurized rows are essentially never integral, so the
            # probe (two full passes + a temporary) is skipped by mode
            # rather than paid per chunk on the hot featurize path.
            u8 = payload.astype(np.uint8)
            if np.array_equal(payload, u8.astype(np.float32)):
                extra["payload_cast"] = np.asarray("float32")
                payload = u8
        buf = io.BytesIO()
        # Write-path-only choice: np.load reads both formats transparently,
        # so compressed and plain shards coexist (old snapshots stay
        # readable, and the shard sha256 below covers whichever bytes were
        # written).  Device-format shards are NEVER compressed: a warm
        # epoch's read must be memory-bandwidth IO straight into H2D, not
        # an inflate pass (that would be a host transform).
        save = np.savez_compressed if self._compress else np.savez
        save(
            buf,
            indices=np.asarray(indices, np.int64),
            names=np.asarray(list(names)),
            payload=payload,
            **extra,
        )
        data = buf.getvalue()
        fname = f"chunk_{len(self._chunks):05d}.npz"
        # image count = the VALID rows (== indices), never pad rows
        n_images = int(np.asarray(indices).shape[0])
        with trace.io_span(
            "snapshot.write_shard", len(data), cat="snapshot",
            file=fname, images=n_images,
        ):
            with open(os.path.join(self._tmp, fname), "wb") as fh:
                fh.write(data)
        self._chunks.append(
            {
                "index": int(index),
                "file": fname,
                "bytes": len(data),
                "sha256": hashlib.sha256(data).hexdigest(),
                "images": n_images,
                "shape": list(payload.shape),
                "compressed": self._compress,
                "payload_bytes": int(payload.nbytes),
            }
        )
        self._images += n_images

    def commit(self) -> str:
        """Write the manifest and rename the directory into place.
        Returns the committed snapshot path."""
        if self._done:
            raise SnapshotError("snapshot writer already committed/aborted")
        manifest = {
            "format": FORMAT_NAME,
            "version": FORMAT_VERSION,
            "key": self._key,
            "mode": self._mode,
            "images": self._images,
            "compress": self._compress,
            "chunks": self._chunks,
            "meta": self._meta,
        }
        with open(os.path.join(self._tmp, MANIFEST_NAME), "w") as fh:
            json.dump(manifest, fh, indent=1)
            fh.flush()
            os.fsync(fh.fileno())
        # Replace any previous snapshot under the same key (a corrupt one
        # being rewritten by the fallback pass): remove-then-rename — the
        # reader tolerates the tiny absent window (it falls back to live
        # decode, counted), and the rename itself is atomic.
        if os.path.isdir(self._final):
            shutil.rmtree(self._final, ignore_errors=True)
        os.replace(self._tmp, self._final)
        self._done = True
        _logger.info(
            "snapshot committed: %s (%d chunks, %d images, mode=%s)",
            self._final, len(self._chunks), self._images, self._mode,
        )
        trace.instant(
            "snapshot_commit",
            path=self._final, chunks=len(self._chunks), images=self._images,
        )
        return self._final

    def abort(self) -> None:
        """Drop the uncommitted shards (idempotent)."""
        if not self._done:
            shutil.rmtree(self._tmp, ignore_errors=True)
            self._done = True


# -- reader -------------------------------------------------------------------


@dataclasses.dataclass
class Snapshot:
    """One committed snapshot (validated manifest; shards validated lazily
    per read)."""

    path: str
    manifest: dict

    @property
    def key(self) -> str:
        return self.manifest["key"]

    @property
    def mode(self) -> str:
        return self.manifest["mode"]

    @property
    def images(self) -> int:
        return int(self.manifest.get("images", 0))

    def iter_chunks(self):
        """Yield ``(entry, arrays)`` per shard in write order, verifying
        each shard's size and sha256 over the exact bytes parsed — a
        mismatch raises :class:`SnapshotCorrupt` (the caller counts the
        fallback)."""
        for entry in self.manifest["chunks"]:
            fpath = os.path.join(self.path, entry["file"])
            try:
                with trace.io_span(
                    "snapshot.read_shard", entry["bytes"], cat="snapshot",
                    file=entry["file"],
                ):
                    with open(fpath, "rb") as fh:
                        data = fh.read()
            except OSError as e:
                raise SnapshotCorrupt(
                    f"{fpath}: unreadable shard ({e})"
                ) from e
            if (
                len(data) != entry["bytes"]
                or hashlib.sha256(data).hexdigest() != entry["sha256"]
            ):
                raise SnapshotCorrupt(
                    f"{fpath}: shard bytes do not match the manifest "
                    "(truncated or bit-flipped)"
                )
            try:
                with np.load(io.BytesIO(data), allow_pickle=False) as zf:
                    arrays = {k: zf[k] for k in zf.files}
            except (ValueError, OSError, KeyError) as e:
                raise SnapshotCorrupt(f"{fpath}: unparsable shard ({e})") from e
            if not {"indices", "names", "payload"} <= set(arrays):
                raise SnapshotCorrupt(
                    f"{fpath}: shard missing required arrays "
                    f"(has {sorted(arrays)})"
                )
            cast = arrays.pop("payload_cast", None)
            if cast is not None:
                # Reverse the writer's lossless uint8 compaction.
                arrays["payload"] = arrays["payload"].astype(str(cast))
            yield entry, arrays


def _read_manifest(path: str) -> dict | None:
    try:
        with open(os.path.join(path, MANIFEST_NAME)) as fh:
            manifest = json.load(fh)
    except (OSError, json.JSONDecodeError):
        return None
    if (
        manifest.get("format") != FORMAT_NAME
        or manifest.get("version") != FORMAT_VERSION
        or not isinstance(manifest.get("chunks"), list)
        or not isinstance(manifest.get("key"), str)
    ):
        return None
    return manifest


def lookup(
    root: str, key: str, *, tar_path: str | None = None,
    mode: str = "decoded",
) -> tuple[Snapshot | None, str]:
    """Find the committed snapshot for ``key`` under ``root``.

    Returns ``(snapshot, "hit")``, ``(None, "stale")`` when a committed
    SAME-MODE snapshot for the same tar basenames exists under a
    different key (the input or config moved — the caller counts
    ``snapshot_stale``; a different-mode snapshot was never a candidate
    for this key and must not read as staleness), or ``(None, "miss")``.
    """
    if not os.path.isdir(root):
        return None, "miss"
    path = _dir_for(root, key)
    manifest = _read_manifest(path) if os.path.isdir(path) else None
    if manifest is not None and manifest.get("key") == key:
        return Snapshot(path, manifest), "hit"
    if tar_path is not None:
        # Manifest-only scan: this runs on every cold stream start, so it
        # must not pay list_snapshots' per-shard stat accounting just to
        # classify stale-vs-miss.
        want = sorted(r["name"] for r in tar_identity(tar_path))
        for name in sorted(os.listdir(root)):
            if not name.startswith("snap-"):
                continue
            manifest = _read_manifest(os.path.join(root, name))
            if (
                manifest is not None
                and manifest.get("mode") == mode
                and sorted(
                    r.get("name", "")
                    for r in manifest.get("meta", {}).get("tar", [])
                )
                == want
            ):
                return None, "stale"
    return None, "miss"


def list_snapshots(root: str) -> list:
    """Inventory of everything under a snapshot root — committed snapshots
    (with manifest summary + validity) AND uncommitted ``.tmp-*`` leftovers
    (crash debris the admin tool can reap)."""
    out = []
    if not os.path.isdir(root):
        return out
    for name in sorted(os.listdir(root)):
        path = os.path.join(root, name)
        if not os.path.isdir(path):
            continue
        if name.startswith(".tmp-"):
            out.append(
                {
                    "dir": name,
                    "committed": False,
                    "valid": False,
                    "reason": "uncommitted temp directory (crashed or "
                    "in-progress write)",
                    "bytes": _dir_bytes(path),
                }
            )
            continue
        manifest = _read_manifest(path)
        if manifest is None:
            out.append(
                {
                    "dir": name,
                    "committed": False,
                    "valid": False,
                    "reason": "missing/invalid manifest",
                    "bytes": _dir_bytes(path),
                }
            )
            continue
        rec = {
            "dir": name,
            "committed": True,
            "key": manifest["key"],
            "mode": manifest["mode"],
            "images": manifest.get("images", 0),
            "chunks": len(manifest["chunks"]),
            "bytes": _dir_bytes(path),
            "tar_names": sorted(
                r.get("name", "")
                for r in manifest.get("meta", {}).get("tar", [])
            ),
            # Recorded chunking (the ingest tee writes both): lets the
            # admin tool recompute a snapshot's EXACT key for staleness
            # classification instead of probing guessed batch sizes.
            "batch_size": manifest.get("meta", {}).get("batch_size"),
            "extra": manifest.get("meta", {}).get("extra"),
            "valid": True,
            "reason": "ok",
        }
        out.append(rec)
    return out


def validate(root: str, key_prefix: str) -> list:
    """Full shard validation (size + sha256) of one snapshot — the admin
    ``inspect`` operation.  Returns a list of violations (empty = clean)."""
    matches = [
        d
        for d in os.listdir(root)
        if d.startswith("snap-") and d[5:].startswith(key_prefix[:16])
    ] if os.path.isdir(root) else []
    if not matches:
        return [f"no snapshot directory matching key prefix {key_prefix!r}"]
    problems = []
    for d in matches:
        path = os.path.join(root, d)
        manifest = _read_manifest(path)
        if manifest is None:
            problems.append(f"{d}: missing/invalid manifest")
            continue
        snap = Snapshot(path, manifest)
        try:
            for _entry, _arrays in snap.iter_chunks():
                pass
        except SnapshotCorrupt as e:
            problems.append(str(e))
    return problems


def evict(
    root: str,
    *,
    key_prefix: str | None = None,
    temps: bool = False,
    names: list | None = None,
) -> list:
    """Remove snapshot directories: those matching ``key_prefix`` (>= 4
    chars — a shorter prefix could match everything), uncommitted temp
    leftovers (``temps=True``), and/or exact directory ``names`` (the
    invalid-manifest case, where no key exists to match on).  Returns
    removed names."""
    if key_prefix is not None and len(key_prefix) < 4:
        raise ValueError(
            f"evict key_prefix {key_prefix!r} is shorter than 4 characters "
            "— a near-empty prefix would match every snapshot"
        )
    removed = []
    if not os.path.isdir(root):
        return removed
    wanted = set(names or ())
    for name in sorted(os.listdir(root)):
        path = os.path.join(root, name)
        if not os.path.isdir(path):
            continue
        kill = name in wanted
        if temps and name.startswith(".tmp-"):
            kill = True
        if (
            key_prefix is not None
            and name.startswith("snap-")
            and name[5:].startswith(key_prefix[:16])
        ):
            kill = True
        if kill:
            shutil.rmtree(path, ignore_errors=True)
            removed.append(name)
            counters.record("snapshot_evicted", name)
    return removed


def _dir_bytes(path: str) -> int:
    total = 0
    for entry in os.scandir(path):
        if entry.is_file():
            total += entry.stat().st_size
    return total
