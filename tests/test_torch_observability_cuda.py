"""RandomPatchCifar from a JPEG tar and the observability base on the card.

This file imports neither JAX nor the JAX package, so the card tests run on
a machine without them:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_observability_cuda.py``.
Tests that need the card carry the ``cuda`` marker and skip without one.

Bars: the streamed run with the decode on the card launches the decode
kernel twice per chunk and the fused featurizer once per chunk, never the
unfused entries, and predicts what a run on the same pixels decoded in
memory by ``decode_batch`` predicts; ``tensor_stats`` of a card tensor has
the CPU's count, nonfinite count and extremes exactly and its moments
within rtol 2e-6 (f32 sums in another order); the κ estimate within rtol
1e-4 of the CPU's."""

import dataclasses
import io
import tarfile

import numpy as np
import pytest
import torch

from keystone_tpu_torch.core import numerics, trace
from keystone_tpu_torch.core.resilience import assert_all_finite
from keystone_tpu_torch.loaders.cifar import LabeledImageBatch
from keystone_tpu_torch.ops import jpeg_device as jd
from keystone_tpu_torch.ops import rect_pool as rp
from keystone_tpu_torch.solvers.block import BlockLeastSquaresEstimator
from keystone_tpu_torch.testing.jpeg_encode import encode_jpeg
from keystone_tpu_torch.workloads import cifar_random_patch as pc
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _cifar_tar(path, n, seed):
    """``n`` separable 48 px images in 4 classes as q90 4:2:0 JPEGs."""
    rng = np.random.default_rng(seed)
    palette = np.array([[200, 60, 60], [60, 200, 60], [60, 60, 200], [200, 200, 60]], float)
    labels = rng.integers(0, 4, n)
    members = {}
    with tarfile.open(path, "w") as tf:
        for i, c in enumerate(labels):
            img = np.clip(palette[c] + rng.normal(0, 12, (48, 48, 3)), 0, 255)
            jpeg, _ = encode_jpeg(img, 90, "4:2:0")
            name = f"{int(c)}/img_{i:05d}.jpg"
            info = tarfile.TarInfo(name)
            info.size = len(jpeg)
            tf.addfile(info, io.BytesIO(jpeg))
            members[name] = jpeg
    return members


@pytest.mark.cuda
def test_stream_test_tar_with_device_decode(cuda_device, tmp_path):
    tar = str(tmp_path / "c.tar")
    members = _cifar_tar(tar, 20, 3)
    names = list(members)
    images = [jd.entropy_decode(members[n]) for n in names]
    coeffs, qt = jd.stack_coeff_images(images)
    pixels = jd.decode_batch(images[0].geom, coeffs, qt, "cuda").cpu().numpy()
    labels = np.asarray([pc.cifar_tar_label(n) for n in names], np.int32)
    train = LabeledImageBatch(pixels, labels)
    conf = pc.RandomCifarConfig(num_filters=4, patch_steps=6, whitener_size=64, lam=10.0,
                                num_classes=4, featurize_chunk=8, device="cuda")

    rp.launches = rp.fused_launches = jd.launches = jd.decode_launches = 0
    res = pc.run(dataclasses.replace(conf, stream_test_tar=tar, device_decode=True),
                 train, LabeledImageBatch(pixels[:0], labels[:0]))
    chunks = res["ingest"]["batches"]
    assert chunks == 3 and res["ingest"]["entropy_decoded"] == 20
    assert jd.decode_launches == 2 * chunks and jd.launches == 0
    assert rp.fused_launches >= chunks and rp.launches == 0
    assert res["test_filenames"] == names
    mem = pc.run(conf, train, train)
    np.testing.assert_array_equal(res["test_predictions"], mem["test_predictions"])


@pytest.mark.cuda
def test_tensor_stats_on_card(cuda_device):
    x = np.random.default_rng(1).normal(2.0, 3.0, (300, 77)).astype(np.float32)
    x[5, 5], x[6, 6], x[7, 7] = np.nan, -np.inf, 0.0
    card = numerics.tensor_stats(torch.from_numpy(x).cuda())
    cpu = numerics.tensor_stats(torch.from_numpy(x))
    for key in ("count", "nonfinite", "min", "max", "abs_max"):
        assert card[key] == cpu[key], key
    for key in ("mean", "std", "zero_frac"):
        np.testing.assert_allclose(card[key], cpu[key], rtol=2e-6, err_msg=key)


@pytest.mark.cuda
def test_gram_condition_on_card(cuda_device):
    a = np.random.default_rng(2).normal(size=(500, 40)).astype(np.float32)
    g = torch.from_numpy(a.T @ a)
    card = numerics.estimate_gram_condition(g.cuda(), 0.5, "card")
    cpu = numerics.estimate_gram_condition(g, 0.5, "cpu")
    np.testing.assert_allclose(card["kappa"], cpu["kappa"], rtol=1e-4)


@pytest.mark.cuda
def test_span_sync_and_finite_guard_on_card(cuda_device, tmp_path):
    trace.disable()
    trace.reset()
    trace.enable(str(tmp_path / "t.json"))
    try:
        x = torch.randn(64, 12, device="cuda")
        y = torch.nn.functional.one_hot(torch.arange(64, device="cuda") % 3, 3).float()
        with trace.span("fit") as sp:
            model = BlockLeastSquaresEstimator(4, 1, 0.1).fit(x, y)
            sp.sync(model.xs)
        (span,) = [e for e in trace.events() if e.get("name") == "fit"]
        assert span["args"]["sync_us"] >= 0
    finally:
        trace.disable()
        trace.reset()
    assert assert_all_finite(model, "card model") is model
    model.xs[0][0, 0] = float("nan")
    with pytest.raises(FloatingPointError, match="card model"):
        assert_all_finite(model, "card model")
