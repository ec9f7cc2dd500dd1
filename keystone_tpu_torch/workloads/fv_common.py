"""Shared machinery of the Fisher-vector workloads (counterpart of
keystone_tpu/workloads/fv_common.py, eager single-device subset).

Images of one shape are stacked into a bucket and featurized together; the
fixed-width feature rows are scattered back to the original image order.
The streaming helpers build the same buckets from a ``core.ingest`` stream.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..core.ingest import StreamConfig, stream_batches
from ..core.pipeline import Pipeline
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


def describe_buckets(images: list, describe, device, chunk: int) -> dict:
    """Per shape bucket of ``images`` (per-image arrays): (original indices,
    ``describe`` of the bucket's images on ``device``), run ``chunk``
    images at a time into one preallocated tensor."""
    out = {}
    for shape, (idx, batch) in bucket_by_shape(images).items():
        descs = None
        for i in range(0, len(idx), chunk):
            part = describe(torch.from_numpy(batch[i : i + chunk]).to(device))
            if descs is None:
                descs = torch.empty((len(idx), *part.shape[1:]), dtype=part.dtype, device=device)
            descs[i : i + part.shape[0]] = part
        out[shape] = (idx, descs)
    return out


def grayscale(batch: torch.Tensor) -> torch.Tensor:
    """PixelScaler then GrayScaler -> [n, H, W] in [0, 1]."""
    return GrayScaler()(PixelScaler()(batch))[..., 0]


def sample_columns(desc_buckets: dict, num_samples: int, seed: int = 42) -> torch.Tensor:
    """Uniform sample of descriptor columns over per-bucket [n, d, cols]
    arrays -> [d, <= num_samples].  Each bucket gives its proportional quota,
    drawn by ``np.random.default_rng(seed)`` as in the JAX package, so the
    same descriptors give the same columns."""
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
        im = torch.from_numpy(im).to(descs.device)
        col = torch.from_numpy(col).to(descs.device)
        picks.append(descs[im, :, col].T)  # [d, quota]
    return torch.cat(picks, dim=1)


def fisher_feature_pipeline(gmm: GaussianMixtureModel) -> Pipeline:
    """FisherVector -> vectorize (column-major) -> L2 norm -> signed sqrt ->
    L2 norm: [n, d, cols] descriptors -> [n, 2·d·K] features."""
    return Pipeline([
        FisherVector(gmm), MatrixVectorizer(), NormalizeRows(),
        SignedHellingerMapper(), NormalizeRows(),
    ])


def scatter_features(buckets: dict, transform, n_total: int, feature_dim: int) -> torch.Tensor:
    """Apply ``transform`` ([n, d, cols] -> [n, D]) per bucket and scatter
    the rows back to the original image order."""
    out = None
    for _shape, (idx, descs) in buckets.items():
        feats = transform(descs)
        if out is None:
            out = torch.zeros((n_total, feature_dim), dtype=feats.dtype, device=feats.device)
        out[torch.from_numpy(np.asarray(idx)).to(feats.device)] = feats[: len(idx)]
    return out


def stream_config_from_flags(*, device_decode: bool = False) -> StreamConfig:
    """The ``StreamConfig`` of a workload's streams: the defaults, with
    ``--deviceDecode`` selecting ``decode_mode="device"`` (the entropy pass
    on the host, the pixels born on the card)."""
    return StreamConfig(decode_mode="device" if device_decode else "host")


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

    def __post_init__(self):
        self._names: list | None = None
        #: the ``core.ingest.StreamStats`` of every pass, in order
        self.stream_stats: list = []

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
        cfg = stream_config_from_flags(device_decode=self.device_decode)
        with stream_batches(self.data_path, self.batch_size, keep=self.keep, config=cfg,
                            device=device) as st:
            out, names = consume(st)
        self.record_names(names)
        self.stream_stats.append(st.stats)
        return out


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
