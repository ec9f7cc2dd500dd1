"""VOC tar loader (counterpart of keystone_tpu/loaders/image_loaders.py,
eager VOC subset).

Images decode on the host with PIL into ``f32[H, W, 3]`` BGR arrays in
[0, 255]; grayscale images are tripled, and images under ``MIN_DIM`` pixels
on a side are rejected.  Members that cannot be read or decoded are skipped
and counted in :data:`skipped`.  Images of differing sizes stay per-image
arrays; the workloads bucket them by shape.
"""

from __future__ import annotations

import collections
import io
import os
import tarfile
from dataclasses import dataclass

import numpy as np

VOC_NUM_CLASSES = 20
MIN_DIM = 36

#: Decodes a stream keeps in flight beyond the pool width: a small constant
#: of finished results buffered behind a slow head-of-line decode.
_DECODE_AHEAD = 8

#: Members skipped by the loaders, by reason.
skipped: collections.Counter = collections.Counter()


def decode_threads() -> int:
    """Decoder pool width: the host cores this process may run on."""
    try:  # affinity-aware (cgroup/container limits), not the raw core count
        return len(os.sched_getaffinity(0)) or 1
    except AttributeError:  # platforms without sched_getaffinity
        return os.cpu_count() or 1


def decode_ahead() -> int:
    """Decode-ahead slots beyond the pool width: in-flight decodes per
    stream = ``decode_threads() + decode_ahead()``."""
    return _DECODE_AHEAD


@dataclass
class MultiLabeledImages:
    images: list  # of f32[H, W, 3] BGR arrays
    labels: list  # of list[int]
    filenames: list

    def __len__(self):
        return len(self.images)


def decode_image(data: bytes) -> np.ndarray | None:
    """JPEG/PNG bytes -> f32[H, W, 3] BGR in [0, 255], or None when the
    image does not decode or is smaller than ``MIN_DIM``."""
    from PIL import Image as PILImage

    try:
        img = PILImage.open(io.BytesIO(data))
        if img.mode not in ("RGB", "L"):
            img = img.convert("RGB")
        arr = np.asarray(img, np.float32)
    except Exception:
        return None
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    if arr.shape[0] < MIN_DIM or arr.shape[1] < MIN_DIM:
        return None
    return arr[:, :, ::-1].copy()  # RGB -> BGR


def _tar_files(path: str) -> list[str]:
    if os.path.isdir(path):
        return sorted(
            os.path.join(path, f)
            for f in os.listdir(path)
            if f.endswith((".tar", ".tar.gz", ".tgz"))
        )
    return [path]


def _iter_tar_members(path: str):
    """Yield (member_name, bytes) for each readable file in the tar(s).  An
    unreadable member is skipped; a corrupt header ends that tar."""
    for tar_path in _tar_files(path):
        with tarfile.open(tar_path) as tf:
            it = iter(tf)
            while True:
                try:
                    member = next(it)
                except StopIteration:
                    break
                except (tarfile.TarError, OSError, EOFError):
                    skipped["tar_stream_error"] += 1
                    break
                if not member.isfile():
                    continue
                try:
                    f = tf.extractfile(member)
                    if f is None:
                        continue
                    data = f.read()
                except (tarfile.TarError, OSError, EOFError):
                    skipped["tar_member_error"] += 1
                    continue
                yield member.name.lstrip("./"), data


def voc_labels_map(labels_path: str) -> dict[str, list[int]]:
    """Parse the VOC labels CSV (columns id, class, classname,
    traintesteval, filename; class ids 1-indexed) into
    filename -> list of 0-indexed class ids."""
    labels_map: dict[str, list[int]] = {}
    with open(labels_path) as fh:
        next(fh, None)  # header
        for line in fh:
            if not line.strip():
                continue
            parts = line.strip().split(",")
            fname = parts[4].replace('"', "")
            labels_map.setdefault(fname, []).append(int(parts[1]) - 1)
    return labels_map


def voc_loader(
    data_path: str, labels_path: str, name_prefix: str = "VOCdevkit/VOC2007/JPEGImages/"
) -> MultiLabeledImages:
    """VOC 2007 loader: the members under ``name_prefix`` that the labels
    CSV names, in tar order."""
    labels_map = voc_labels_map(labels_path)
    images, labels, filenames = [], [], []
    for name, data in _iter_tar_members(data_path):
        if not name.startswith(name_prefix) or name not in labels_map:
            continue
        img = decode_image(data)
        if img is None:
            skipped["corrupt_image"] += 1
            continue
        images.append(img)
        labels.append(labels_map[name])
        filenames.append(name)
    return MultiLabeledImages(images, labels, filenames)
