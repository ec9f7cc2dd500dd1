"""RandomPatchCifar from JPEG tars in the port (keystone_tpu_torch), against
the JAX package's tar loaders and streaming featurize, and against the
port's own eager path, on the CPU.

The tars hold 48 px images: the loaders reject anything under MIN_DIM =
36 px, so a true 32 px CIFAR JPEG would decode to nothing.

Bars: the loaders' images and labels equal (``np.array_equal``); the
streamed featurize ``torch.equal`` to the port's ``featurize_chunked``, and
within rtol 2e-5, atol 2e-5·max of the JAX package's streamed features in
f32 activations (``test_torch_cifar_random_patch.py``'s bar); predictions
of a streamed run equal the eager run's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.core.ingest import stream_batches as jax_stream_batches
from keystone_tpu.ops.conv_fused import FusedConvFeaturizer as JaxFused
from keystone_tpu.workloads import cifar_random_patch as jc
from keystone_tpu_torch.core import ingest
from keystone_tpu_torch.core.resilience import counters
from keystone_tpu_torch.ops import jpeg_device as jd
from keystone_tpu_torch.ops import rect_pool as rp
from keystone_tpu_torch.ops.conv_fused import FusedConvFeaturizer
from keystone_tpu_torch.workloads import cifar_random_patch as pc
from keystone_tpu_torch.workloads.fv_common import stream_config_from_flags
from test_stream_workloads import _write_cifar_tar
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401

SMALL = dict(num_filters=4, patch_steps=6, lam=10.0, whitener_size=64, num_classes=4)


@pytest.fixture(scope="module")
def tars(tmp_path_factory):
    """A ragged 11-image tar and a 20-image tar of 48 px q95 JPEGs."""
    d = tmp_path_factory.mktemp("cifar_tars")
    rng = np.random.default_rng(42)
    small, big = str(d / "c11.tar"), str(d / "c20.tar")
    _write_cifar_tar(small, 11, rng)
    _write_cifar_tar(big, 20, rng)
    return small, big


def test_tar_loader_equals_jax(tars):
    for tar in tars:
        got, ref = pc.cifar_tar_loader(tar), jc.cifar_tar_loader(tar)
        assert got.images.shape == (len(ref), 48, 48, 3)
        np.testing.assert_array_equal(got.images, ref.images)
        np.testing.assert_array_equal(got.labels, ref.labels)


@pytest.mark.parametrize("batch", [4, 8])
def test_stream_loader_bit_identical_to_eager(tars, batch):
    """11 images in chunks of 4 or 8: a ragged last chunk either way."""
    eager = pc.cifar_tar_loader(tars[0])
    streamed = pc.cifar_tar_stream_loader(tars[0], batch=batch)
    np.testing.assert_array_equal(streamed.images, eager.images)
    np.testing.assert_array_equal(streamed.labels, eager.labels)
    np.testing.assert_array_equal(
        streamed.images, jc.cifar_tar_stream_loader(tars[0], batch=batch).images
    )


def test_stream_loader_pins_host_decode_counted(tars):
    before = counters.get("device_decode_unsupported")
    streamed = pc.cifar_tar_stream_loader(
        tars[0], batch=4, config=stream_config_from_flags(device_decode=True)
    )
    assert counters.get("device_decode_unsupported") - before == 1
    np.testing.assert_array_equal(streamed.images, pc.cifar_tar_loader(tars[0]).images)


def test_featurize_stream_equals_chunked_and_jax(tars):
    tar = tars[0]
    images = pc.cifar_tar_loader(tar).images
    conf = jc.RandomCifarConfig(num_filters=4, patch_steps=6, whitener_size=64, featurize_chunk=4)
    filters, whitener = jc.learn_filters(conf, images)
    filters = np.array(filters).reshape(4, 6, 6, 3)
    means = np.asarray(whitener.means)
    kw = dict(pool_stride=conf.pool_stride, pool_size=conf.pool_size, alpha=conf.alpha)
    port_fn = FusedConvFeaturizer(
        filters, whitener_means=means, activation_dtype=torch.float32, device="cpu", **kw
    )
    jax_fn = jax.jit(JaxFused(
        jnp.asarray(filters), whitener_means=jnp.asarray(means),
        activation_dtype=jnp.float32, **kw,
    ).__call__)

    eager = pc.featurize_chunked(port_fn, images, conf.featurize_chunk, "cpu")
    with ingest.stream_batches(tar, conf.featurize_chunk, device="cpu") as st:
        streamed, names = pc.featurize_stream(port_fn, st, conf.featurize_chunk)
    assert st.join(10.0)
    assert torch.equal(streamed, eager)

    with jax_stream_batches(tar, conf.featurize_chunk) as jst:
        ref, ref_names = jc.featurize_stream(jax_fn, jst, conf.featurize_chunk)
    assert names == ref_names
    got = streamed.numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5 * np.abs(ref).max())
    np.testing.assert_array_equal(
        [pc.cifar_tar_label(n) for n in names], pc.cifar_tar_loader(tar).labels
    )


def test_pad_to_chunk_pads_pixels_after_decode(tars):
    """A ragged coefficient chunk is decoded first, then padded with zero
    pixel rows: the decode sees only JPEG rows."""
    config = ingest.StreamConfig(decode_mode="device")
    with ingest.stream_batches(tars[0], 8, config=config, device="cpu") as st:
        batches = list(st)
    assert [len(b) for b in batches] == [8, 3]
    tail = batches[-1]
    assert tail.host is None and tail.coeff is not None
    padded = pc._pad_to_chunk(tail, 8)
    assert padded.shape == (8, 48, 48, 3)
    assert torch.equal(padded[:3], tail.dev())
    assert not padded[3:].any()
    with pytest.raises(ValueError, match="exceeds the featurize chunk"):
        pc._pad_to_chunk(batches[0], 4)


def test_run_from_streamed_train_matches_eager(tars):
    tar = tars[1]
    conf = pc.RandomCifarConfig(featurize_chunk=8, device="cpu", **SMALL)
    eager = pc.cifar_tar_loader(tar)
    streamed = pc.cifar_tar_stream_loader(tar, batch=8)
    base = pc.run(conf, eager, eager)
    res = pc.run(conf, streamed, eager)
    np.testing.assert_array_equal(res["test_predictions"], base["test_predictions"])


def test_run_with_stream_test_tar_matches_eager(tars):
    tar = tars[1]
    train = pc.cifar_tar_loader(tar)
    conf = pc.RandomCifarConfig(featurize_chunk=8, device="cpu", **SMALL)
    base = pc.run(conf, train, train)
    res = pc.run(dataclasses.replace(conf, stream_test_tar=tar), train, train)
    np.testing.assert_array_equal(res["test_predictions"], base["test_predictions"])
    np.testing.assert_array_equal(res["test_labels"], train.labels)
    assert res["test_error"] == base["test_error"]
    assert res["ingest"]["decoded"] == 20 and res["ingest"]["skipped"] == 0


def test_cli_stream_test_tar_device_decode_on_cpu(tars, monkeypatch):
    """--streamTestTar --deviceDecode --device cpu: the entropy pass on the
    host, then the plain decode (no kernel launch) and the plain pool."""
    tar = tars[1]
    for mod, name in ((jd, "launches"), (jd, "decode_launches"), (rp, "launches"),
                      (rp, "fused_launches")):
        monkeypatch.setattr(mod, name, 0)
    flags = ["--numFilters", "4", "--patchSteps", "6", "--whitenerSize", "64",
             "--lambda", "10", "--device", "cpu"]
    res = pc.main(["--trainLocation", tar, "--streamTestTar", tar, "--deviceDecode", *flags])
    assert (jd.launches, jd.decode_launches, rp.launches, rp.fused_launches) == (0, 0, 0, 0)
    st = res["ingest"]
    assert st["entropy_decoded"] == 20 and st["skipped"] == st["device_fallbacks"] == 0
    host = pc.main(["--trainLocation", tar, "--streamTestTar", tar, *flags])
    assert host["ingest"]["entropy_decoded"] == 0
    # The device-decode pixels are the IDCT's, not libjpeg's: equal answers
    # are expected on this separable set, not required bit for bit.
    assert res["test_error"] == host["test_error"] == 0.0


@pytest.mark.parametrize("argv", [
    ["--streamTestTar", "x.tar"],                               # no train split
    ["--trainLocation", "x.tar"],                               # no test split
    ["--trainLocation", "x.tar", "--testLocation", "y.tar", "--deviceDecode"],
    # --decodeBackend and --snapshotDir need a streamed split
    ["--trainLocation", "x.tar", "--testLocation", "y.tar", "--decodeBackend", "thread"],
    ["--trainLocation", "x.tar", "--testLocation", "y.tar", "--snapshotDir", "s"],
    ["--trainLocation", "x.tar", "--testLocation", "y.tar", "--autoTune"],  # needs the stream
])
def test_cli_usage_errors(argv):
    with pytest.raises(SystemExit):
        pc.main(argv)
