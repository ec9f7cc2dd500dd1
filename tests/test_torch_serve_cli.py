"""``--serve`` and ``--serveBench`` on the port's RandomPatchCifar,
MnistRandomFFT and VOCSIFTFisher CLIs at small size on the CPU.

Each run fits and saves with ``--pipelineFile`` (or restores what it
saved), then serves requests drawn from the eager test split: the
``--serve`` record's answers equal the offline apply (VOC: equal, or with
parity unverified deterministic, the reference's rule), the
``--serveBench`` record carries the reference's keys with both answer
checks true, and the usage rules hold: no ``--pipelineFile`` raises, a
``--serveMesh`` wider than the devices raises the JAX package's
device-count ``ValueError`` (before any data is read), VOC refuses
``--streamIngest``."""

import json

import numpy as np
import pytest

from keystone_tpu_torch.workloads import cifar_random_patch as pt_cifar
from keystone_tpu_torch.workloads import mnist_random_fft as pt_mnist
from keystone_tpu_torch.workloads import voc_sift_fisher as pt_voc
from test_fisher_pipelines import write_voc_tar
from test_torch_cifar_random_patch import FLAGS as CIFAR_FLAGS
from test_torch_cifar_random_patch import _write_cifar
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401

pytestmark = pytest.mark.serve

BENCH_KEYS = {"engine", "clients", "requests", "qps", "p50_latency_ms", "p99_latency_ms",
              "max_latency_ms", "batcher", "phase_breakdown", "slo",
              "predictions_bit_identical", "unbatched_qps", "batched_vs_unbatched_qps",
              "unbatched_bit_identical"}
SERVED_KEYS = {"requests", "qps", "p50_latency_ms", "p99_latency_ms", "batcher",
               "phase_breakdown", "router", "slo", "predictions_bit_identical"}


def _check_served(serving: dict, n: int) -> None:
    json.dumps(serving)
    assert set(serving["cold_start"]) == {"checkpoint_load_seconds", "compile_seconds",
                                          "warmup_seconds", "cold_start_seconds"}
    s = serving["served"]
    assert SERVED_KEYS <= set(s)
    assert s["requests"] == n and s["batcher"]["answered"] == n
    assert s["router"]["stats"]["routes"] == n
    assert s["predictions_bit_identical"] or s.get("predictions_deterministic")


def _check_bench(serving: dict, n: int) -> None:
    json.dumps(serving)
    b = serving["bench"]
    assert BENCH_KEYS <= set(b)
    assert b["requests"] == n
    if b.get("parity_unverified"):
        assert b["predictions_deterministic"] and b["unbatched_deterministic"]
    else:
        assert b["predictions_bit_identical"] and b["unbatched_bit_identical"]


@pytest.fixture(scope="module")
def cifar_files(tmp_path_factory):
    rng = np.random.default_rng(5)
    base = rng.uniform(40, 215, (4, 3))
    d = tmp_path_factory.mktemp("cifar")
    train, test = str(d / "train.bin"), str(d / "test.bin")
    _write_cifar(train, 400, rng, base)
    _write_cifar(test, 150, rng, base)
    return train, test


def test_cifar_serve_then_serve_bench(cifar_files, tmp_path):
    train, test = cifar_files
    stem = str(tmp_path / "cifar")
    flags = ["--testLocation", test, *CIFAR_FLAGS, "--device", "cpu", "--pipelineFile", stem]
    fitted = pt_cifar.main(["--trainLocation", train, *flags, "--serve",
                            "--serveRequests", "40"])
    _check_served(fitted["serving"], 40)
    assert fitted["test_error"] == 0.0
    restored = pt_cifar.main(["--trainLocation", str(tmp_path / "absent.bin"), *flags,
                              "--serveBench", "--serveRequests", "48", "--serveClients", "3"])
    assert restored["restored"] is True
    _check_bench(restored["serving"], 48)
    assert restored["serving"]["bench"]["clients"] == 3


def test_serving_without_a_pipeline_file_raises(cifar_files):
    train, test = cifar_files
    with pytest.raises(ValueError, match="--pipelineFile"):
        pt_cifar.main(["--trainLocation", train, "--testLocation", test, *CIFAR_FLAGS,
                       "--device", "cpu", "--serve"])


@pytest.mark.parametrize("module", [pt_cifar, pt_mnist, pt_voc])
def test_serve_mesh_is_a_usage_error(module, tmp_path):
    """``--serve --serveMesh 2x1`` on the one CPU: the JAX CLIs'
    ``resolve_serve_mesh`` error, raised here before the (absent) data is
    read."""
    argv = ["--trainLocation", "x", "--testLocation", "y", "--device", "cpu", "--serve",
            "--pipelineFile", str(tmp_path / "servable"), "--serveMesh", "2x1"]
    with pytest.raises(ValueError, match="needs 2 devices but this process has 1"):
        module.main([*argv, "--labelPath", "z"] if module is pt_voc else argv)


def test_mnist_serve_and_serve_bench(tmp_path):
    rng = np.random.default_rng(7)
    centers = rng.normal(0, 1.0, (10, 784))

    def make(n):
        labels = rng.integers(1, 11, n)
        return np.column_stack([labels, centers[labels - 1] + 0.3 * rng.normal(size=(n, 784))])

    train, test = str(tmp_path / "train.csv"), str(tmp_path / "test.csv")
    np.savetxt(train, make(400), delimiter=",", fmt="%.5f")
    np.savetxt(test, make(60), delimiter=",", fmt="%.5f")
    flags = ["--trainLocation", train, "--testLocation", test, "--numFFTs", "4",
             "--blockSize", "512", "--lambda", "10", "--device", "cpu",
             "--pipelineFile", str(tmp_path / "mnist")]
    fitted = pt_mnist.main([*flags, "--serve"])
    _check_served(fitted["serving"], 60)
    restored = pt_mnist.main([*flags, "--serveBench", "--serveRequests", "32"])
    assert restored["restored"] is True
    _check_bench(restored["serving"], 32)


def test_voc_serve_and_serve_bench(tmp_path):
    labels = str(tmp_path / "labels.csv")
    open(labels, "w").close()
    tar = str(tmp_path / "voc.tar")
    write_voc_tar(tar, labels, 12, np.random.default_rng(42))
    flags = ["--trainLocation", tar, "--testLocation", tar, "--labelPath", labels,
             "--lambda", "0.05", "--descDim", "16", "--vocabSize", "8", "--numPcaSamples",
             "4000", "--numGmmSamples", "4000", "--scaleStep", "0", "--device", "cpu",
             "--pipelineFile", str(tmp_path / "voc")]
    fitted = pt_voc.main([*flags, "--serve"])
    serving = fitted["serving"]
    n = serving["served"]["requests"]
    _check_served(serving, n)
    assert serving["shape_buckets_total"] >= 1 and len(serving["request_shape"]) == 3
    restored = pt_voc.main([*flags, "--serveBench", "--serveRequests", "6"])
    assert restored["restored"] is True
    _check_bench(restored["serving"], min(6, n))
    with pytest.raises(ValueError, match="streamIngest"):
        pt_voc.main([*flags, "--serve", "--streamIngest"])
