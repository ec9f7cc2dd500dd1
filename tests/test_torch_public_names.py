"""The last public names of the JAX package, ported beside their twins and
held to them on the same seeded inputs: ``BinaryClassificationMetrics
.specificity``, ``VectorSplitter.split_vector`` / ``num_blocks``,
``StreamStats.record()`` and ``utils.stats.about_eq``.  Each is plain
arithmetic in both packages, so the bar is equality."""

import dataclasses
import io
import tarfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.core import ingest as jingest
from keystone_tpu.evaluation import multiclass as jmulti
from keystone_tpu.ops import util as jutil
from keystone_tpu.utils import stats as jstats
from keystone_tpu_torch.core import ingest
from keystone_tpu_torch.evaluation import multiclass as pmulti
from keystone_tpu_torch.ops import util as putil
from keystone_tpu_torch.utils import stats as pstats

#: StreamStats fields only the port counts (its decoders and its copies).
PORT_ONLY_STATS = {"decoder", "host_decoder", "h2d_bytes", "decode_seconds"}


def test_specificity_matches_jax(rng):
    counts = rng.integers(0, 50, size=(20, 4)).astype(np.float64) + 1.0
    for tp, fp, tn, fn in counts:
        j = jmulti.BinaryClassificationMetrics(tp, fp, tn, fn)
        p = pmulti.BinaryClassificationMetrics(tp, fp, tn, fn)
        assert p.specificity == j.specificity == tn / (fp + tn)
    merged_j = jmulti.BinaryClassificationMetrics(*counts[0]).merge(
        jmulti.BinaryClassificationMetrics(*counts[1]))
    merged_p = pmulti.BinaryClassificationMetrics(*counts[0]).merge(
        pmulti.BinaryClassificationMetrics(*counts[1]))
    assert merged_p.specificity == merged_j.specificity


def test_specificity_per_class_of_a_confusion_matrix(rng):
    cm = rng.integers(0, 30, size=(6, 6))
    j = jmulti.MulticlassMetrics(cm)
    p = pmulti.MulticlassMetrics(cm)
    assert [m.specificity for m in p.class_metrics] == [m.specificity for m in j.class_metrics]


@pytest.mark.parametrize("d,block", [(10, 4), (12, 4), (1, 3), (7, 7), (64, 5)])
def test_split_vector_matches_jax(rng, d, block):
    vec = rng.standard_normal(d).astype(np.float32)
    got = putil.VectorSplitter(block).split_vector(torch.from_numpy(vec))
    want = jutil.VectorSplitter(block).split_vector(jnp.asarray(vec))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("d,block,num_features", [(10, 4, None), (12, 4, None), (1, 3, None),
                                                  (None, 5, 64), (None, 8, 64), (9, 2, 64)])
def test_num_blocks_matches_jax(d, block, num_features):
    got = putil.VectorSplitter(block, num_features).num_blocks(d)
    want = jutil.VectorSplitter(block, num_features).num_blocks(d)
    assert got == want == -(-(d or num_features) // block)


def _apply_counts(stats, steps) -> None:
    for field, value in steps:
        if isinstance(value, str):
            setattr(stats, field, value)
        elif field == "ring_max_depth":
            stats.ring_max_depth = max(stats.ring_max_depth, value)
        else:
            setattr(stats, field, getattr(stats, field) + value)


def test_stream_stats_record_matches_jax(rng):
    """The same stream of counts into both dataclasses: the port's record
    is the JAX record on every JAX key, plus the port's own fields."""
    shared = [f.name for f in dataclasses.fields(jingest.StreamStats)
              if f.type in (int, "int")]
    steps = [(shared[i], int(v)) for i, v in zip(
        rng.integers(0, len(shared), 200), rng.integers(0, 9, 200))]
    steps.append(("entropy_backend", "native"))
    j, p = jingest.StreamStats(), ingest.StreamStats()
    _apply_counts(j, steps)
    _apply_counts(p, steps)
    jrec, prec = j.record(), p.record()
    assert {k: prec[k] for k in jrec} == jrec
    assert set(prec) - set(jrec) == PORT_ONLY_STATS
    assert prec == dataclasses.asdict(p)


def _jpeg(arr) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=90)
    return buf.getvalue()


def test_stream_stats_record_after_a_real_stream(rng, tmp_path):
    """Both packages stream one small tar in device-decode mode: the counts
    they both keep are equal in the two records."""
    path = str(tmp_path / "five.tar")
    with tarfile.open(path, "w") as tf:
        for i in range(5):
            data = _jpeg(rng.integers(0, 256, (40, 48, 3)).astype(np.uint8))
            info = tarfile.TarInfo(f"img{i}.jpg")
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
    cfg = jingest.StreamConfig.from_env(decode_mode="device", snapshot_dir="")
    with jingest.stream_batches(path, 2, config=cfg, transfer=False) as st:
        list(st)
    assert st.join(10.0)
    jrec = st.stats.record()
    with ingest.stream_batches(path, 2, config=ingest.StreamConfig(decode_mode="device"),
                               device="cpu") as st:
        list(st)
    assert st.join(10.0)
    prec = st.stats.record()
    for key in ("decoded", "skipped", "batches", "entropy_decoded", "entropy_corrupt",
                "device_fallbacks", "coeff_bytes"):
        assert prec[key] == jrec[key], key
    assert (prec["decoded"], prec["batches"]) == (5, 3)


@pytest.mark.parametrize("thresh", [1e-8, 1e-4, 1e-2, 1.0])
def test_about_eq_matches_jax(rng, thresh):
    a = rng.standard_normal((7, 5))
    for b in (a, a + 1e-6, a + rng.standard_normal(a.shape) * 1e-3, a + 0.5):
        assert pstats.about_eq(a, b, thresh) == jstats.about_eq(a, b, thresh)
    assert pstats.about_eq(1.0, 1.0 + 1e-9) == jstats.about_eq(1.0, 1.0 + 1e-9) is True


def test_about_eq_shape_mismatch_raises():
    for about_eq in (pstats.about_eq, jstats.about_eq):
        with pytest.raises(ValueError, match="shape mismatch"):
            about_eq(np.zeros(3), np.zeros(4))
