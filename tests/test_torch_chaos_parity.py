"""The port's chaos harness held to the JAX harness (``tests/chaos.py``,
``tests/faults.py``) on the same seeds: the same schedules, the same bytes
of data, the same fault-free MNIST predictions, and the same typed errors
where a healthy system fails typed."""

import dataclasses
import tarfile

import numpy as np
import pytest

import chaos as jchaos
import faults as jfaults
from keystone_tpu_torch.testing import chaos, faults
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401


@pytest.mark.parametrize("seed", jchaos.FULL_SEEDS)
def test_schedule_equals_jax(seed):
    assert chaos.make_schedule(seed).record() == jchaos.make_schedule(seed).record()


def test_constants_equal_jax():
    for name in ("FAMILIES", "SERVE_FAMILIES", "TIER1_SEEDS", "FULL_SEEDS", "_DATA_SEED",
                 "_N_TAR_IMAGES", "_N_STREAM_IMAGES"):
        assert getattr(chaos, name) == getattr(jchaos, name), name
    assert [chaos.expected_outcome(chaos.make_schedule(s)) for s in chaos.FULL_SEEDS] == [
        jchaos.expected_outcome(jchaos.make_schedule(s)) for s in jchaos.FULL_SEEDS]
    assert ({f.name for f in dataclasses.fields(chaos.ChaosResult)}
            == {f.name for f in dataclasses.fields(jchaos.ChaosResult)})
    fault = chaos.make_schedule(0)
    port = chaos.ChaosResult(seed=0, workload="mnist", fault=fault, outcome="typed_error")
    ref = jchaos.ChaosResult(seed=0, workload="mnist", fault=jchaos.make_schedule(0),
                             outcome="typed_error")
    assert port.record() == ref.record()


def test_expected_counters_equal_jax():
    """The port's table of each family's counter is the JAX suite's bar."""
    from test_chaos import EXPECTED_COUNTER

    assert chaos.EXPECTED_COUNTER == EXPECTED_COUNTER
    assert tuple(chaos.EXPECTED_COUNTER) == chaos.FAMILIES


def test_mnist_case_equals_jax():
    for port, ref in zip(chaos._mnist_case(), jchaos._mnist_case()):
        assert port.data.dtype == ref.data.dtype and np.array_equal(port.data, ref.data)
        assert port.labels.dtype == ref.labels.dtype and np.array_equal(port.labels, ref.labels)


def test_synthetic_cifar_bytes_equal_jax(tmp_path):
    for mod, name in ((chaos, "port.bin"), (jchaos, "ref.bin")):
        rng = np.random.default_rng(jchaos._DATA_SEED)
        mod._write_synthetic_cifar(str(tmp_path / name), 9, rng,
                                   base=rng.uniform(40, 215, (4, 3)))
    assert (tmp_path / "port.bin").read_bytes() == (tmp_path / "ref.bin").read_bytes()


@pytest.mark.parametrize("corrupt", [(), (1, 4)])
def test_image_tar_bytes_equal_jax(corrupt, tmp_path):
    names = [mod.make_image_tar(str(tmp_path / f"{tag}.tar"), 6, np.random.default_rng(3),
                                corrupt=corrupt)
             for mod, tag in ((faults, "port"), (jfaults, "ref"))]
    assert names[0] == names[1]

    def members(path):
        with tarfile.open(path) as tf:
            return [(m.name, tf.extractfile(m).read()) for m in tf]

    assert members(tmp_path / "port.tar") == members(tmp_path / "ref.tar")


def test_damaged_jpegs_equal_jax():
    data = faults.make_jpeg_bytes(np.random.default_rng(1))
    assert data == jfaults.make_jpeg_bytes(np.random.default_rng(1))
    assert (faults.corrupt_jpeg(data, np.random.default_rng(2))
            == jfaults.corrupt_jpeg(data, np.random.default_rng(2)))
    for mode in ("truncate", "marker"):
        assert faults.corrupt_jpeg_entropy(data, mode) == jfaults.corrupt_jpeg_entropy(data, mode)
    with pytest.raises(ValueError):
        faults.corrupt_jpeg_entropy(data, "nope")


def test_nan_mask_equals_jax():
    batch = np.random.default_rng(4).normal(size=(20, 8, 8, 3)).astype(np.float32)
    nhwc = batch.transpose(0, 2, 1, 3)  # a non-C layout, as the CIFAR loader's
    for x in (batch, nhwc):
        port = faults.inject_nan(x, np.random.default_rng(5), 0.01)
        ref = jfaults.inject_nan(x, np.random.default_rng(5), 0.01)
        assert np.array_equal(np.isnan(port), np.isnan(ref)) and np.isnan(port).any()


def test_oom_error_is_the_ports():
    import torch

    from keystone_tpu_torch.core.memory import is_oom_error

    e = faults.resource_exhausted_error()
    assert isinstance(e, torch.OutOfMemoryError) and is_oom_error(e)
    assert "CUDA out of memory" in str(e)

    class Target:
        @staticmethod
        def call():
            return "ran"

    with faults.oom_faults(Target, "call", failures=1) as wrapper:
        with pytest.raises(torch.OutOfMemoryError):
            Target.call()
        assert Target.call() == "ran" and wrapper.state["calls"] == 2


@pytest.fixture(scope="module")
def jax_baseline():
    return jchaos.baseline("mnist")


def test_fault_free_mnist_predictions_equal_jax(jax_baseline):
    port = chaos.baseline("mnist", device="cpu")["test_predictions"]
    ref = np.asarray(jax_baseline["test_predictions"])
    assert port.shape == ref.shape and np.array_equal(port, ref)


@pytest.mark.parametrize("kind", ["nan_input", "deadline", "stream_hang"])
def test_typed_seed_equals_jax(kind, jax_baseline, tmp_path):
    """Where a healthy system fails typed, both harnesses name the same
    error type and phase on the same seed."""
    seed = chaos.FAMILIES.index(kind)
    (tmp_path / "port").mkdir()
    (tmp_path / "ref").mkdir()
    port = chaos.run_schedule(seed, "mnist", tmpdir=str(tmp_path / "port"), device="cpu")
    ref = jchaos.run_schedule(seed, "mnist", tmpdir=str(tmp_path / "ref"))
    assert port.outcome == ref.outcome == "typed_error", (port.record(), ref.record())
    assert (port.error_type, port.phase) == (ref.error_type, ref.phase)


def test_entropy_damaged_tar_and_truncated_tail_equal_jax(tmp_path):
    """The device-decode families' tars (``corrupt_fn``, a member name
    format) and a partly transferred archive are the JAX bytes too."""
    paths = []
    for mod, tag in ((faults, "port"), (jfaults, "ref")):
        path = tmp_path / f"{tag}.tar"
        mod.make_image_tar(str(path), 5, np.random.default_rng(6), corrupt=(2,),
                           name_fmt="x/{:02d}.jpg",
                           corrupt_fn=lambda d, m=mod: m.corrupt_jpeg_entropy(d, "marker"))
        mod.truncate_tail(str(path), 700)
        paths.append(path)
    assert paths[0].read_bytes() == paths[1].read_bytes()
