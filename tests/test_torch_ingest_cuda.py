"""The ingest stream's copies to the card (``keystone_tpu_torch.core.ingest``):
pinned host buffers, a dedicated copy stream and one event per chunk.

This file imports neither JAX nor the JAX package, so the card tests run on
a machine without them:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_ingest_cuda.py``.
Tests that need the card carry the ``cuda`` marker and skip without one.

The chunks come from snapshots written here (decoded pixels, and padded
device-format shards) and from the device-decode entropy pass, so no host
image decoder is needed.  Tolerance: exact (``torch.equal``): a copy moves
bytes, it computes nothing."""

import io
import tarfile

import numpy as np
import pytest
import torch

from keystone_tpu_torch.core import ingest
from keystone_tpu_torch.core import snapshot as ksnap
from keystone_tpu_torch.testing.jpeg_encode import encode_jpeg


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card to copy chunks to")
    return torch.device("cuda")


def _tar(path, n, seed=0, size=48):
    """``n`` baseline JPEGs of seeded noise, q90 4:2:0; returns the names."""
    rng = np.random.default_rng(seed)
    names = []
    with tarfile.open(path, "w") as tf:
        for i in range(n):
            data = encode_jpeg(rng.uniform(0, 255, (size, size, 3)), 90, "4:2:0")[0]
            info = tarfile.TarInfo(f"{i % 10}/img_{i:05d}.jpg")
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
            names.append(info.name)
    return names


def _snapshot(path, names, batch, mode, seed=1, size=48):
    """A committed snapshot of ``path`` under the key a stream of
    ``batch``-image chunks looks up, holding seeded whole-level pixels.
    Returns the pixels in stream order."""
    rng = np.random.default_rng(seed)
    pixels = rng.integers(0, 256, (len(names), size, size, 3)).astype(np.float32)
    root = str(path) + f".{mode}.snap"
    w = ksnap.SnapshotWriter(root, ksnap.snapshot_key(path, batch_size=batch, mode=mode),
                             mode=mode, meta={"tar": ksnap.tar_identity(path)})
    for c, i in enumerate(range(0, len(names), batch)):
        w.add_chunk(c, np.arange(i, min(i + batch, len(names))), names[i : i + batch],
                    pixels[i : i + batch], pad_to=batch)
    w.commit()
    return root, pixels


def _config(root=None, mode="decoded", **kw):
    return ingest.StreamConfig(snapshot_dir=root, snapshot_mode=mode, **kw)


@pytest.mark.cuda
def test_chunks_cross_from_pinned_buffers_on_the_copy_stream(cuda_device, tmp_path):
    path = str(tmp_path / "c.tar")
    names = _tar(path, 12)
    root, pixels = _snapshot(path, names, 4, "decoded")
    with ingest.stream_batches(path, 4, config=_config(root), device=cuda_device) as st:
        copier = st._copier
        assert copier is not None and copier.stream != torch.cuda.current_stream()
        for b in st:
            tensors, event = b.staged
            assert event is not None and all(t.is_cuda for t in tensors)
            assert torch.equal(b.dev().cpu(), torch.from_numpy(pixels[b.indices]))
            assert b.staged[1] is None  # waited on once, by the consumer's stream
    assert st.join(10.0)
    assert all(slot[0].is_pinned() for slot in copier._slots)
    assert 1 <= len(copier._slots) <= ingest.DEVICE_BUFFERS + 1
    assert st.stats.h2d_bytes == pixels.nbytes and st.stats.snapshot_chunks_read == 3


@pytest.mark.cuda
def test_slow_consumer_sees_every_chunk_intact(cuda_device, tmp_path):
    """50 chunks through a consumer whose stream sleeps before it reads each
    chunk: a pinned buffer reused before its copy finished, or a device
    block handed out before the consumer's work on it, would change the
    bytes.  The card's copies equal the CPU stream's arrays."""
    path = str(tmp_path / "c.tar")
    names = _tar(path, 100, seed=2, size=40)
    root, pixels = _snapshot(path, names, 2, "decoded", seed=3, size=40)
    cfg = _config(root, ring_capacity=2)
    got = []
    with ingest.stream_batches(path, 2, config=cfg, device=cuda_device) as st:
        for b in st:
            x = b.dev()
            torch.cuda._sleep(2_000_000)
            got.append(x.clone())
            del x
    assert st.join(10.0) and st.stats.batches == 50
    with ingest.stream_batches(path, 2, config=cfg, device="cpu") as cpu:
        want = [torch.from_numpy(b.host.copy()) for b in cpu]
    assert cpu.join(10.0)
    assert len(got) == len(want) == 50
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_coefficient_chunks_take_the_same_route(cuda_device, tmp_path):
    path = str(tmp_path / "c.tar")
    _tar(path, 10, seed=4)
    cfg = _config(decode_mode="device")
    with ingest.stream_batches(path, 4, config=cfg, device="cpu") as cpu:
        want = [(b.coeff.coeffs, b.coeff.qt) for b in cpu]
    with ingest.stream_batches(path, 4, config=cfg, device=cuda_device) as st:
        got = []
        for b in st:
            assert b.coeff is not None and b.staged[1] is not None
            arrays = b.device_arrays()
            got.append(([t.cpu() for t in arrays[:-1]], arrays[-1].cpu()))
            assert b.dev().shape == (len(b), 48, 48, 3)
    assert st.join(10.0) and cpu.join(10.0)
    assert st.stats.h2d_bytes == st.stats.coeff_bytes + sum(q.nbytes for _, q in want)
    for (gc, gq), (wc, wq) in zip(got, want):
        assert all(torch.equal(a, torch.from_numpy(b)) for a, b in zip(gc, wc))
        assert torch.equal(gq, torch.from_numpy(wq))


@pytest.mark.cuda
def test_device_shards_copy_without_a_cast(cuda_device, tmp_path):
    path = str(tmp_path / "c.tar")
    names = _tar(path, 10, seed=5)
    root, pixels = _snapshot(path, names, 4, "device")
    cfg = _config(root, "device", decode_mode="device")
    with ingest.stream_batches(path, 4, config=cfg, device=cuda_device) as st:
        got = [(b.indices, b.dev()) for b in st]
    assert st.join(10.0)
    # shards of 4, 4 and 2 rows padded to 8 -> capped at 4: 12 rows of f32
    assert st.stats.snapshot_dma_bytes == 12 * pixels[0].nbytes
    assert st.stats.h2d_bytes == pixels.nbytes and st.stats.entropy_decoded == 0
    for idx, x in got:
        assert x.dtype == torch.float32
        assert torch.equal(x.cpu(), torch.from_numpy(pixels[idx]))
