"""Shared machinery of the Fisher-vector workloads (counterpart of
keystone_tpu/workloads/fv_common.py).

Images of one shape are stacked into a bucket and featurized together; the
fixed-width feature rows are scattered back to the original image order.
Under a mesh a bucket's images are row-sharded over the data slots
(:func:`shard_batch`), each slot describes its own rows in its device's
scope, and the descriptors stay a ``parallel.mesh.ShardedRows`` through
the PCA projection and the Fisher features (:func:`per_bucket`, K2 on
every slot); pad images ride through and are dropped by
:func:`scatter_features` and never sampled by :func:`sample_columns`.
:func:`searched_bucket_featurize` chooses that placement with the solvers'
placement search.
The streaming helpers build the same buckets from a ``core.ingest`` stream,
and :func:`stream_features_snapshot` serves a streamed featurize pass from
a featurized snapshot (``core.snapshot``) when one is committed.
:func:`plan_pca_materialization` is the auto-Cacher's decision on the
PCA-projected training descriptors (``--autoCache``).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..core import snapshot as ksnap
from ..core.ingest import StreamConfig, StreamStats, stream_batches
from ..core.pipeline import Pipeline
from ..core.resilience import counters
from ..parallel.mesh import ShardedRows, on_slot, padded_shard_rows
from ..ops.fisher import FisherVector
from ..ops.images import GrayScaler, PixelScaler
from ..ops.stats import NormalizeRows, SignedHellingerMapper
from ..ops.util import MatrixVectorizer
from ..solvers.gmm import GaussianMixtureModel


def bucket_by_shape(images: list) -> dict:
    """Group per-image arrays by (H, W): shape -> (orig_indices, [n,H,W,C])."""
    groups: dict = {}
    for i, img in enumerate(images):
        groups.setdefault(img.shape[:2], []).append(i)
    return {
        shape: (np.asarray(idx), np.stack([images[i] for i in idx]))
        for shape, idx in groups.items()
    }


def chunked(describe, pixels: torch.Tensor, chunk: int) -> torch.Tensor:
    """``describe`` on ``chunk`` images at a time, concatenated: it bounds
    the intermediates of one call; no image's result depends on it."""
    if pixels.shape[0] <= chunk:
        return describe(pixels)
    return torch.cat([describe(pixels[i : i + chunk]) for i in range(0, pixels.shape[0], chunk)])


def describe_buckets(images: list, describe, device, chunk: int, mesh=None) -> dict:
    """Per shape bucket of ``images`` (per-image arrays): (original indices,
    ``describe`` of the bucket's images on ``device``), run ``chunk``
    images at a time into one preallocated tensor.  With ``mesh`` each
    bucket is row-sharded over its data slots (:func:`shard_batch`) and
    described slot by slot: a ``ShardedRows`` per bucket."""
    return _describe_buckets(bucket_by_shape(images), describe, device, chunk, mesh)


def _describe_buckets(raw: dict, describe, device, chunk: int, mesh=None) -> dict:
    """:func:`describe_buckets` over buckets already stacked."""
    out = {}
    for shape, (idx, batch) in raw.items():
        if mesh is not None:
            out[shape] = (idx, shard_batch(batch, mesh).apply(
                lambda rows: _describe(rows, describe, chunk)))
        else:
            out[shape] = (idx, _describe(batch, describe, chunk, device))
    return out


def _describe(batch, describe, chunk: int, device=None) -> torch.Tensor:
    """``describe`` of ``batch``'s images, ``chunk`` at a time, into one
    tensor on ``device`` (the rows' own device when None)."""
    device = batch.device if device is None else device
    descs = None
    for i in range(0, len(batch), chunk):
        part = describe(torch.as_tensor(batch[i : i + chunk]).to(device))
        if descs is None:
            descs = torch.empty((len(batch), *part.shape[1:]), dtype=part.dtype, device=device)
        descs[i : i + part.shape[0]] = part
    return descs


def shard_batch(batch, mesh) -> ShardedRows:
    """One bucket's ``[n, H, W, C]`` pixels row-sharded over the mesh's data
    slots, zero pad images making ``n`` an axis multiple.  The pad images
    ride through the per-image featurizers and are dropped at scatter time
    (:func:`scatter_features`) and at sampling time (:func:`sample_columns`);
    the bucket's featurize is purely data-parallel, so nothing is masked in
    between."""
    return padded_shard_rows(torch.as_tensor(np.asarray(batch)), mesh)[0]


def per_bucket(fn, descs):
    """``fn`` on one bucket's descriptors: on a ``ShardedRows`` slot by
    slot, in each slot's device scope (``ShardedRows.apply``), pad rows
    riding through."""
    return descs.apply(fn) if isinstance(descs, ShardedRows) else fn(descs)


def searched_bucket_featurize(label: str, images: list, describe, device, chunk: int, mesh,
                              *, plan=None) -> tuple[dict, dict | None]:
    """:func:`describe_buckets` with its PLACEMENT chosen by the placement
    search the solvers use (``core.autoshard``): the candidates are
    ``row_sharded[mesh DxM]`` for ``mesh`` (the hand placement, rank 0 on an
    untrained model) and for every other (data, model) factorization of the
    same slots, then the ``single_device`` floor on slot (0, 0)'s device,
    pinned last.  The chosen candidate describes every bucket through the
    ladder's contract, so an out-of-memory error steps down the ranking,
    counted.  Returns ``(buckets, placement record)``; ``mesh=None`` or a
    search that is switched off is the plain hand path, with no record."""
    from ..core import autoshard
    from ..core import memory as kmem
    from ..parallel.mesh import DATA_AXIS, enumerate_meshes, mesh_desc

    raw = bucket_by_shape(images)
    if mesh is None or not autoshard.will_search(plan):
        return _describe_buckets(raw, describe, device, chunk, mesh), None
    total_bytes = sum(int(b.nbytes) for _i, b in raw.values())
    # The featurize computes in float32 whatever the pixels' type: the
    # prior charges that working set.
    f32_bytes = 4 * sum(int(b.size) for _i, b in raw.values())

    def tier(m, prior_rank: int, hand: bool):
        d_sz = m.shape[DATA_AXIS]
        return autoshard.Candidate(
            f"row_sharded[mesh {mesh_desc(m)}]", "featurize_mesh",
            plan=lambda: kmem.plan_bytes(
                f"{label}:row_sharded[{mesh_desc(m)}]",
                argument_bytes=total_bytes // d_sz, temp_bytes=f32_bytes // d_sz,
                budget=kmem.min_chip_budget(m)[0],
            ),
            run=lambda _plan: _describe_buckets(raw, describe, device, chunk, m),
            hints={
                "arg_bytes": total_bytes // d_sz,
                "temp_bytes": f32_bytes // d_sz,
                "h2d_bytes": total_bytes // d_sz,
                "dispatches": len(raw),
            },
            mesh_axes=dict(m.shape), prior_rank=prior_rank, hand=hand,
            specs={"batch": "data@dim0"},
        )

    cands = [tier(mesh, 0, True)]
    for extra in enumerate_meshes(list(mesh.devices.flat)):
        if mesh_desc(extra) != mesh_desc(mesh):
            cands.append(tier(extra, len(cands), False))
    head = mesh.devices[0, 0]
    cands.append(autoshard.Candidate(
        "single_device", "featurize",
        plan=lambda: kmem.plan_bytes(f"{label}:single_device", argument_bytes=total_bytes,
                                     temp_bytes=f32_bytes, budget=kmem.hbm_budget(head)),
        run=lambda _plan: _describe_buckets(raw, describe, head, chunk),
        hints={
            "arg_bytes": total_bytes,
            "temp_bytes": f32_bytes,
            "h2d_bytes": total_bytes,
            "dispatches": len(raw),
        },
        prior_rank=len(cands), floor=True, specs={"batch": "replicated"},
    ))
    slots = list(mesh.devices.flat)
    report = kmem.FitReport(label=label)
    out = autoshard.run_search(
        label, cands, report,
        fingerprint=autoshard.fingerprint(
            label, sorted((shape, len(idx)) for shape, (idx, _b) in raw.items()),
            dict(mesh.shape), autoshard.device_fingerprint(slots),
        ),
        plan=plan, budget=kmem.min_chip_budget(mesh)[0], devices=slots,
    )
    return out, report.placement


def grayscale(batch: torch.Tensor) -> torch.Tensor:
    """PixelScaler then GrayScaler -> [n, H, W] in [0, 1]."""
    return GrayScaler()(PixelScaler()(batch))[..., 0]


def sample_columns(desc_buckets: dict, num_samples: int, seed: int = 42,
                   project=None) -> torch.Tensor:
    """Uniform sample of descriptor columns over per-bucket [n, d, cols]
    arrays -> [d, <= num_samples].  Each bucket gives its proportional quota,
    drawn by ``np.random.default_rng(seed)`` as in the JAX package, so the
    same descriptors give the same columns.  ``project`` (a bucket's
    ``[n, d, cols] -> [n, d', cols]`` projection) samples the projected
    buckets without holding them all: one bucket is projected at a time,
    with the bits of the whole projected set.  Only a bucket's ``len(idx)``
    true images are sampled: a ``ShardedRows``' pad images never are, and
    its picks are copied from the slots that hold them."""
    rng = np.random.default_rng(seed)
    totals = {
        shape: len(idx) * descs.shape[2] for shape, (idx, descs) in desc_buckets.items()
    }
    grand_total = sum(totals.values())
    picks = []
    for shape, (idx_arr, descs) in desc_buckets.items():
        c = descs.shape[2]
        total = totals[shape]
        if grand_total <= num_samples:
            idx = np.arange(total)
        else:
            quota = min(total, max(1, int(num_samples * total / grand_total)))
            idx = np.sort(rng.choice(total, quota, replace=False))
        im, col = np.divmod(idx, c)
        if project is not None:
            descs = per_bucket(project, descs)
        picks.append(_pick_columns(descs, im, col).T)  # [d, quota]
    return torch.cat(picks, dim=1)


def _pick_columns(descs, im: np.ndarray, col: np.ndarray) -> torch.Tensor:
    """``descs[im, :, col]``: ``[len(im), d]``.  From a ``ShardedRows``
    each data slot's picks are copied onto slot (0, 0)'s device, in the
    order asked."""
    if not isinstance(descs, ShardedRows):
        dev = descs.device
        return descs[torch.from_numpy(im).to(dev), :, torch.from_numpy(col).to(dev)]
    blocks = descs.data_blocks()
    head = blocks[0].device
    per = int(blocks[0].shape[0])
    out = torch.empty((len(im), descs.shape[1]), dtype=descs.dtype, device=head)
    for d, block in enumerate(blocks):
        sel = np.nonzero(im // per == d)[0]
        if len(sel):
            part = block[torch.from_numpy(im[sel] - d * per).to(block.device), :,
                         torch.from_numpy(col[sel]).to(block.device)]
            out[torch.from_numpy(sel).to(head)] = on_slot(part, head)
    return out


def fisher_feature_pipeline(gmm: GaussianMixtureModel) -> Pipeline:
    """FisherVector -> vectorize (column-major) -> L2 norm -> signed sqrt ->
    L2 norm: [n, d, cols] descriptors -> [n, 2·d·K] features."""
    return Pipeline([
        FisherVector(gmm), MatrixVectorizer(), NormalizeRows(),
        SignedHellingerMapper(), NormalizeRows(),
    ])


def scatter_features(buckets: dict, transform, n_total: int, feature_dim: int) -> torch.Tensor:
    """Apply ``transform`` ([n, d, cols] -> [n, D]) per bucket
    (:func:`per_bucket`) and scatter the rows back to the original image
    order; a ``ShardedRows``' true rows are gathered to slot (0, 0)'s
    device, its pad rows dropped."""
    out = None
    for _shape, (idx, descs) in buckets.items():
        feats = per_bucket(transform, descs)
        if isinstance(feats, ShardedRows):
            feats = feats.gather()
        if out is None:
            out = torch.zeros((n_total, feature_dim), dtype=feats.dtype, device=feats.device)
        out[torch.from_numpy(np.asarray(idx)).to(feats.device)] = feats[: len(idx)]
    return out


def plan_pca_materialization(desc_buckets: dict, batch_pca, reuse: int, *,
                             label: str = "pca_descriptors", mesh=None):
    """The auto-Cacher's decision (``core.optimize``) on the PCA-projected
    training descriptors, which GMM sampling and the Fisher features both
    consume.  The projection is timed on the smallest bucket, after one
    warm-up call (a first call on the card can hold a kernel's first-use
    build and the BLAS set-up, which the dataset ratio would scale up);
    seconds and bytes scale to the whole set, and the caching inequality
    runs through the card's admission gate (under ``mesh``, each data
    slot's share of row-sharded buckets against the slot budget).

    Returns ``(CachePlan, materialize)``.  ``materialize`` keeps the
    projected set whole between its consumers (the raw buckets dropped
    once projected); otherwise each consumer projects one bucket at a time
    from the raw set — the same products on the same buckets, so the
    samples and features are bit-identical."""
    from ..core import optimize
    from ..core.pipeline import _synchronize

    _shape, (_idx, probe) = min(desc_buckets.items(),
                                key=lambda kv: math.prod(kv[1][1].shape))
    _synchronize(per_bucket(batch_pca, probe))
    t0 = time.perf_counter()
    out = per_bucket(batch_pca, probe)
    _synchronize(out)
    probe_secs = time.perf_counter() - t0
    probe_cols = int(probe.shape[0]) * int(probe.shape[2])
    total_cols = sum(int(d.shape[0]) * int(d.shape[2]) for _, d in desc_buckets.values())
    scale = total_cols / max(1, probe_cols)
    plan = optimize.plan_caches([
        optimize.CacheCandidate(
            index=0, name=label, seconds=probe_secs * scale,
            output_bytes=int(out.nbytes * scale), reuse=reuse,
        )
    ], mesh=mesh)
    return plan, plan.decisions[0].cached


def stream_config_from_flags(
    *, decode_backend: str | None = None, snapshot_dir: str | None = None,
    snapshot_extra: str | None = None, supports_featurized: bool = False,
    device_decode: bool = False, autotune: bool = False,
) -> StreamConfig:
    """The ``StreamConfig`` of a workload's streams: the environment's
    ``KEYSTONE_*`` knobs (:meth:`StreamConfig.from_env`), overridden by the
    workload's ``--decodeBackend`` / ``--snapshotDir`` / ``--deviceDecode``
    / ``--autoTune`` flags (``decode_mode="device"``: the entropy pass on
    the host, the pixels born on the card; ``autotune``: the closed-loop
    ingest autotuner on every stream).  ``snapshot_extra`` keys the stream's member
    selection (keep filters, label files) into the snapshot key.

    ``supports_featurized``: set by callers that wrap the stream in
    :func:`stream_features_snapshot`.  Everywhere else a
    ``KEYSTONE_SNAPSHOT_MODE=featurized`` request caches decoded chunks
    instead, counted ``snapshot_mode_unsupported``."""
    cfg = StreamConfig.from_env(
        decode_backend=decode_backend, snapshot_dir=snapshot_dir,
        snapshot_extra=snapshot_extra, decode_mode="device" if device_decode else None,
        autotune=True if autotune else None,
    )
    if cfg.snapshot_dir and cfg.snapshot_mode == "featurized" and not supports_featurized:
        counters.record(
            "snapshot_mode_unsupported",
            "featurized snapshots are not implemented on this stream — caching decoded "
            "chunks instead",
        )
        cfg.snapshot_mode = "decoded"
    return cfg


def stream_features_snapshot(make_stream, per_batch, *, root=None, key=None,
                             tar_path=None) -> tuple[np.ndarray, list, StreamStats]:
    """A streamed featurize pass served from a featurized snapshot.

    ``per_batch``: ``StreamBatch -> [b, D]`` feature rows (numpy).  With
    ``root`` and ``key`` set and a committed featurized snapshot under the
    key, the features come from its shards: no tar read, no decode, no
    featurize.  ``key`` must fold in the fitted featurizer's digest
    (``core.snapshot.featurizer_digest``), so a refit never replays stale
    features.  Otherwise the live pass runs (``make_stream()``) and its
    feature rows are teed into a fresh snapshot, committed only at a clean
    end.  A corrupt shard is a counted ``snapshot_fallback`` to the live
    pass; a committed featurized snapshot of the same tar under another key
    is counted ``snapshot_stale``.

    Returns ``(features [n, D] f32, names, stats)``: the live stream's
    ``StreamStats``, or one that counts the chunks the snapshot served."""
    if root is not None and key is not None:
        snap, reason = ksnap.lookup(root, key, tar_path=tar_path, mode="featurized")
        if reason == "stale":
            counters.record(
                "snapshot_stale",
                f"{root}: featurized snapshot keyed differently (featurizer or input "
                "moved) — recomputing",
            )
        if snap is not None:
            parts, name_pairs, n = [], [], 0
            stats = StreamStats()
            try:
                for _entry, arrays in snap.iter_chunks():
                    idx = np.asarray(arrays["indices"], np.int64)
                    parts.append((idx, np.asarray(arrays["payload"], np.float32)))
                    name_pairs.extend(zip(idx.tolist(), [str(x) for x in arrays["names"]]))
                    n += len(idx)
                    stats.snapshot_chunks_read += 1
                stats.decoded, stats.batches = n, stats.snapshot_chunks_read
                feats, names = _scatter_parts(parts, name_pairs, n)
                return feats, names, stats
            except ksnap.SnapshotCorrupt as e:
                counters.record("snapshot_fallback", f"{snap.path}: {e} — recomputing features live")

    writer = None
    if root is not None and key is not None:
        # The manifest's tar identity classifies a later lookup under
        # another key as stale rather than a plain miss.
        meta = {"tar": ksnap.tar_identity(tar_path)} if tar_path is not None else {}
        try:
            writer = ksnap.SnapshotWriter(root, key, mode="featurized", meta=meta)
        except (OSError, ksnap.SnapshotError) as e:
            counters.record("snapshot_write_failed",
                            f"cannot open featurized snapshot writer: {e}")
    parts, name_pairs, n = [], [], 0
    try:
        with make_stream() as st:
            for batch in st:
                feats = np.asarray(per_batch(batch), np.float32)[: len(batch)]
                parts.append((batch.indices, feats))
                name_pairs.extend(zip(batch.indices.tolist(), batch.names))
                n += len(batch)
                if writer is not None:
                    try:
                        writer.add_chunk(batch.index, batch.indices, batch.names, feats)
                        st.stats.snapshot_chunks_written += 1
                    except (OSError, ksnap.SnapshotError) as e:
                        # The cache is an optimisation: a failed shard write
                        # drops the writer, counted, never the pass.
                        counters.record("snapshot_write_failed", str(e))
                        writer.abort()
                        writer = None
        if writer is not None:
            try:
                writer.commit()
            except (OSError, ksnap.SnapshotError) as e:
                counters.record("snapshot_write_failed", f"commit failed: {e}")
    finally:
        if writer is not None:
            writer.abort()  # a no-op after the commit; drops partials on error
    feats, names = _scatter_parts(parts, name_pairs, n)
    return feats, names, st.stats


@dataclass
class StreamSource:
    """Streaming stand-in for a loader's labelled images (``core.ingest``):
    each pass decodes the tar(s) at ``data_path`` while the device
    featurizes.  ``keep(name)`` selects the members and ``label(name)``
    labels them.  Every pass over one source must see the same survivors in
    the same order (features of passes are joined row by row), which
    :meth:`record_names` checks; ``labels``, ``filenames`` and ``len`` are
    known after the first pass."""

    data_path: str
    keep: Callable[[str], bool]
    label: Callable[[str], object]
    batch_size: int = 32
    #: ``--deviceDecode``: entropy pass on the host, pixels born on the card
    device_decode: bool = False
    #: ``--decodeBackend``: None defers to ``KEYSTONE_DECODE_BACKEND``
    decode_backend: str | None = None
    #: ``--snapshotDir``: decoded (or device-format) chunks keyed by the tar,
    #: the decode config and ``snapshot_extra``
    snapshot_dir: str | None = None
    #: the snapshot key's record of what ``keep`` selects (the label file)
    snapshot_extra: str | None = None
    #: ``--autoTune``: the closed-loop ingest autotuner on every pass
    autotune: bool = False

    def __post_init__(self):
        self._names: list | None = None
        #: the ``core.ingest.StreamStats`` of every pass, in order
        self.stream_stats: list = []
        #: each tuned pass's ``IngestAutotuner.record()``, in order
        self.autotune_records: list = []

    @property
    def images(self) -> "StreamSource":
        # A workload passes ``data.images`` to its extractor; for a stream
        # source the "images" are the source.
        return self

    def record_names(self, names: list) -> None:
        if self._names is None:
            self._names = names
        elif self._names != names:
            raise RuntimeError(
                "streaming ingest order drifted between passes "
                f"({len(self._names)} vs {len(names)} survivors): features of "
                "different images would be joined"
            )

    @property
    def filenames(self) -> list:
        if self._names is None:
            raise RuntimeError("StreamSource read before its first pass")
        return self._names

    @property
    def labels(self) -> list:
        return [self.label(n) for n in self.filenames]

    def __len__(self) -> int:
        return len(self.filenames)

    def run_pass(self, device: torch.device, consume):
        """One pass: ``consume`` (a ``core.ingest`` stream -> (result,
        names in stream-ordinal order)) over the kept members, decoded for
        ``device``.  Records the names and the pass's stats; returns the
        result."""
        cfg = stream_config_from_flags(
            decode_backend=self.decode_backend, snapshot_dir=self.snapshot_dir,
            snapshot_extra=self.snapshot_extra, device_decode=self.device_decode,
            autotune=self.autotune,
        )
        with stream_batches(self.data_path, self.batch_size, keep=self.keep, config=cfg,
                            device=device) as st:
            out, names = consume(st)
        self.record_names(names)
        self.stream_stats.append(st.stats)
        if st.tuner is not None:
            self.autotune_records.append(st.tuner.record())
        return out


def collect_autotune(train, test) -> dict:
    """The ``results["autotune"]`` section: each streamed split's list of
    autotuner records, one per pass (empty when nothing was tuned)."""
    return {
        split: src.autotune_records
        for split, src in (("train", train), ("test", test))
        if getattr(src, "autotune_records", None)
    }


def _ordered_names(pairs: list, n: int) -> list:
    names = [None] * n
    for i, name in pairs:
        names[i] = name
    return names


def _scatter_parts(parts: list, name_pairs: list, n: int, feature_dim: int | None = None):
    """Scatter accumulated ``(indices, [b, D] features)`` parts back to
    stream-ordinal (decode-survival) order -> (``[n, D]`` f32 numpy, names).
    ``feature_dim`` is inferred from the first part when omitted."""
    if feature_dim is None:
        feature_dim = parts[0][1].shape[1] if parts else 0
    out = np.zeros((n, feature_dim), np.float32)
    for idx, feats in parts:
        out[np.asarray(idx)] = feats[: len(idx)]
    return out, _ordered_names(name_pairs, n)


def stream_descriptor_buckets(stream, per_batch) -> tuple[dict, list]:
    """The ``bucket_by_shape``-shaped descriptor dict built from a
    ``core.ingest`` stream: ``per_batch`` ([b, H, W, C] pixels on the
    device -> per-image descriptors) runs on each chunk while the producer
    decodes the next ones, and the chunks of a shape are concatenated at the
    end.  Returns the buckets and the member names in stream-ordinal order.

    The buckets are ordered by each shape's FIRST image ordinal, as the
    eager ``bucket_by_shape`` orders them: ``sample_columns`` draws from one
    rng bucket after bucket, so emission order (first full chunk first)
    would pick other PCA/GMM samples than the eager path."""
    parts: dict = {}
    name_pairs: list = []
    n = 0
    for batch in stream:
        descs = batch.apply(per_batch)
        parts.setdefault(batch.shape, []).append((batch.indices, descs))
        name_pairs.extend(zip(batch.indices.tolist(), batch.names))
        n += len(batch)
    buckets = {}
    for shape, chunks in sorted(parts.items(), key=lambda kv: kv[1][0][0][0]):
        idx = np.concatenate([c[0] for c in chunks])
        descs = chunks[0][1] if len(chunks) == 1 else torch.cat([c[1] for c in chunks])
        buckets[shape] = (idx, descs)
    return buckets, _ordered_names(name_pairs, n)


def scatter_features_streaming(stream, transform, feature_dim: int) -> tuple[np.ndarray, list]:
    """Streaming :func:`scatter_features`: ``transform`` ([b, H, W, C]
    pixels on the device -> [b, D] features) per chunk of a ``core.ingest``
    stream, rows scattered back to stream-ordinal order.  Returns
    ``(features [n, D] f32 numpy, names)``."""
    parts: list = []
    name_pairs: list = []
    n = 0
    for batch in stream:
        feats = batch.apply(transform)
        parts.append((batch.indices, feats.to(torch.float32).cpu().numpy()))
        name_pairs.extend(zip(batch.indices.tolist(), batch.names))
        n += len(batch)
    return _scatter_parts(parts, name_pairs, n, feature_dim)
