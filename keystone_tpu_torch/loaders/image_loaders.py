"""VOC and ImageNet tar loaders (counterpart of
keystone_tpu/loaders/image_loaders.py, eager subset).

Images decode on the host into ``f32[H, W, 3]`` BGR arrays in [0, 255]:
JPEGs through the native libjpeg decoder (``loaders.native_decode``), and
with PIL whatever it declines or when it is unavailable.  Grayscale images
are tripled, and images under ``MIN_DIM`` pixels on a side are rejected.
Members that cannot be read or decoded are skipped and counted in
``core.resilience.counters`` (``tar_stream_error``, ``tar_member_error``,
``corrupt_image``); a host with neither decoder raises
:class:`HostDecoderUnavailable` rather than skip.  Images of differing
sizes stay per-image arrays; the workloads bucket them by shape.
"""

from __future__ import annotations

import collections
import io
import os
import tarfile
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

from ..core.resilience import counters, retry
from . import native_decode

VOC_NUM_CLASSES = 20
IMAGENET_NUM_CLASSES = 1000
MIN_DIM = 36

#: Decodes a stream keeps in flight beyond the pool width: a small constant
#: of finished results buffered behind a slow head-of-line decode.
_DECODE_AHEAD = 8


class HostDecoderUnavailable(RuntimeError):
    """Neither host decoder can decode this member: the native libjpeg
    decoder is unavailable (or the bytes are not a JPEG) and PIL is not
    installed.  Raised, never turned into a skip."""


def env_int(name: str, default: int, minimum: int) -> int:
    """Integer environment knob ``name``: ``default`` when unset, else
    validated to be an integer of at least ``minimum``."""
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        val = int(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r} is not an integer") from None
    if val < minimum:
        raise ValueError(f"{name}={raw!r} must be >= {minimum}")
    return val


def host_cores() -> int:
    """The host cores this process may run on."""
    try:  # affinity-aware (cgroup/container limits), not the raw core count
        return len(os.sched_getaffinity(0)) or 1
    except AttributeError:  # platforms without sched_getaffinity
        return os.cpu_count() or 1


def decode_threads() -> int:
    """Decoder pool width: ``KEYSTONE_DECODE_THREADS`` or the host cores."""
    return env_int("KEYSTONE_DECODE_THREADS", host_cores(), 1)


def decode_ahead() -> int:
    """Decode-ahead slots beyond the pool width (``KEYSTONE_DECODE_AHEAD``,
    default :data:`_DECODE_AHEAD`): in-flight decodes per stream =
    ``decode_threads() + decode_ahead()``."""
    return env_int("KEYSTONE_DECODE_AHEAD", _DECODE_AHEAD, 0)


@dataclass
class MultiLabeledImages:
    images: list  # of f32[H, W, 3] BGR arrays
    labels: list  # of list[int]
    filenames: list

    def __len__(self):
        return len(self.images)


@dataclass
class LabeledImages:
    images: list  # of f32[H, W, 3] BGR arrays
    labels: np.ndarray  # [N] int32
    filenames: list

    def __len__(self):
        return len(self.images)


def decode_image(data: bytes) -> np.ndarray | None:
    """JPEG/PNG bytes -> f32[H, W, 3] BGR in [0, 255], or None when the
    image does not decode or is smaller than ``MIN_DIM``.

    A JPEG decodes through the native libjpeg decoder first; PIL (imported
    only then) takes what it declines, and every other format.  A JPEG the
    native decoder rejected on a host without PIL is None (it rejects
    corrupt streams, images under ``MIN_DIM`` and channel counts other than
    1 or 3); with neither decoder, :class:`HostDecoderUnavailable`."""
    is_jpeg = data[:2] == b"\xff\xd8"
    if is_jpeg:
        arr = native_decode.decode_jpeg_native(data)
        if arr is not None:
            return arr
    try:
        from PIL import Image as PILImage
    except ImportError:
        if is_jpeg and native_decode.available():
            return None
        raise HostDecoderUnavailable(
            "no host image decoder: the native libjpeg decoder "
            f"({'unavailable' if is_jpeg else 'JPEG only'}) and PIL (not installed)"
        ) from None
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
    """Yield (member_name, bytes) for each readable file in the tar(s).
    Opening a tar retries transient IO errors with backoff
    (``core.resilience.retry``); an unreadable member is counted
    ``tar_member_error`` and skipped; a corrupt header ends that tar,
    counted ``tar_stream_error``, and the remaining tars still stream."""
    for tar_path in _tar_files(path):
        with retry(tarfile.open, name=f"tarfile.open({tar_path})")(tar_path) as tf:
            it = iter(tf)
            while True:
                try:
                    member = next(it)
                except StopIteration:
                    break
                except (tarfile.TarError, OSError, EOFError) as e:
                    counters.record("tar_stream_error", f"{tar_path}: {e}")
                    break
                if not member.isfile():
                    continue
                try:
                    f = tf.extractfile(member)
                    if f is None:
                        continue
                    data = f.read()
                except (tarfile.TarError, OSError, EOFError) as e:
                    counters.record("tar_member_error", f"{tar_path}:{member.name}: {e}")
                    continue
                yield member.name.lstrip("./"), data


def _iter_tar_images(path: str, num_threads: int | None = None):
    """Yield (member_name, image) for each decodable image in the tar(s),
    in member order.  The tar is read serially; the decode runs on a
    thread pool (both decoders release the GIL) under an in-order
    window of ``num_threads + decode_ahead()`` futures.  An undecodable
    member is counted ``corrupt_image`` and skipped.  The native decoder is
    built before the pool starts, so no worker waits behind the build."""
    num_threads = num_threads or decode_threads()
    native_decode.available()
    if num_threads <= 1:
        for name, data in _iter_tar_members(path):
            img = decode_image(data)
            if img is not None:
                yield name, img
            else:
                counters.record("corrupt_image", name)
        return
    with ThreadPoolExecutor(max_workers=num_threads) as pool:
        window: collections.deque = collections.deque()

        def pop():
            done_name, fut = window.popleft()
            img = fut.result()
            if img is None:
                counters.record("corrupt_image", done_name)
            return done_name, img

        for name, data in _iter_tar_members(path):
            window.append((name, pool.submit(decode_image, data)))
            if len(window) >= num_threads + decode_ahead():
                done_name, img = pop()
                if img is not None:
                    yield done_name, img
        while window:
            done_name, img = pop()
            if img is not None:
                yield done_name, img


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
            counters.record("corrupt_image", name)
            continue
        images.append(img)
        labels.append(labels_map[name])
        filenames.append(name)
    return MultiLabeledImages(images, labels, filenames)


def imagenet_labels_map(labels_path: str) -> dict[str, int]:
    """Parse the space-separated ``synset class-id`` labels file."""
    labels_map: dict[str, int] = {}
    with open(labels_path) as fh:
        for line in fh:
            parts = line.split()
            if len(parts) >= 2:
                labels_map[parts[0]] = int(parts[1])
    return labels_map


def imagenet_loader(data_path: str, labels_path: str) -> LabeledImages:
    """ImageNet loader: each tar (a file, or every tar of a directory in
    name order) holds synset directories; a member is kept when its
    directory is a synset of the labels file, and labelled with its id."""
    labels_map = imagenet_labels_map(labels_path)
    images, labels, filenames = [], [], []
    for name, data in _iter_tar_members(data_path):
        synset = name.split("/")[0]
        if synset not in labels_map:
            continue
        img = decode_image(data)
        if img is None:
            counters.record("corrupt_image", name)
            continue
        images.append(img)
        labels.append(labels_map[synset])
        filenames.append(name)
    return LabeledImages(images, np.asarray(labels, np.int32), filenames)
