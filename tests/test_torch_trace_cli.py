"""``--trace`` on the port's workload CLIs: the Chrome trace each writes
carries the stage spans (cat ``stage``) of the JAX package's CLI on the same
files, by name and in the same order, and loads with
``tools/trace_view.py``.  Cifar, VOC and MNIST run both CLIs at small
widths; ImageNet's port runs alone (its JAX fit is the slow one) and is
held to the JAX stage names as its source writes them."""

import os
import sys

import numpy as np
import pytest

from keystone_tpu.core import trace as jtrace
from keystone_tpu.workloads import cifar_random_patch as jcifar
from keystone_tpu.workloads import mnist_random_fft as jmnist
from keystone_tpu.workloads import voc_sift_fisher as jvoc
from keystone_tpu_torch.core import trace as ptrace
from keystone_tpu_torch.workloads import cifar_random_patch as pcifar
from keystone_tpu_torch.workloads import imagenet_sift_lcs_fv as pinet
from keystone_tpu_torch.workloads import mnist_random_fft as pmnist
from keystone_tpu_torch.workloads import voc_sift_fisher as pvoc
from test_fisher_pipelines import write_voc_tar
from test_stream_workloads import _write_cifar_tar

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))

import trace_view  # noqa: E402  (tools/trace_view.py)
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401


@pytest.fixture(autouse=True)
def _clean_trace():
    for mod in (ptrace, jtrace):
        mod.disable()
        mod.reset()
    yield
    for mod in (ptrace, jtrace):
        mod.disable()
        mod.reset()


def _stages(path):
    events = [e for e in trace_view.spans(trace_view.load_events(path)) if e["cat"] == "stage"]
    return [e["name"] for e in sorted(events, key=lambda e: e["ts"])]


def _both(tmp_path, port_main, jax_main, argv):
    out = {}
    for name, main, extra in (("port", port_main, ["--device", "cpu"]), ("jax", jax_main, [])):
        path = str(tmp_path / f"{name}.json")
        main([*argv, *extra, "--trace", path])
        out[name] = _stages(path)
    return out["port"], out["jax"]


def test_cifar_stage_spans_equal_jax(tmp_path):
    tar = str(tmp_path / "c.tar")
    _write_cifar_tar(tar, 16, np.random.default_rng(4))
    argv = ["--trainLocation", tar, "--testLocation", tar, "--numFilters", "4",
            "--patchSteps", "6", "--whitenerSize", "64", "--lambda", "10"]
    port, ref = _both(tmp_path, pcifar.main, jcifar.main, argv)
    assert port == ref == ["load", "learn_filters", "featurize", "solve", "eval"]


def test_cifar_stream_test_tar_trace_has_ingest_spans(tmp_path):
    tar = str(tmp_path / "c.tar")
    _write_cifar_tar(tar, 12, np.random.default_rng(4))
    path = str(tmp_path / "t.json")
    pcifar.main(["--trainLocation", tar, "--streamTestTar", tar, "--deviceDecode",
                 "--numFilters", "4", "--patchSteps", "6", "--whitenerSize", "64",
                 "--lambda", "10", "--device", "cpu", "--trace", path])
    events = trace_view.load_events(path)
    names = {e["name"] for e in trace_view.spans(events)}
    assert names >= {"load", "learn_filters", "featurize", "solve", "eval", "ingest.produce",
                     "ingest.entropy_decode", "ingest.ring_put", "ingest.ring_get",
                     "ingest.consume"}
    assert trace_view.overlap_from_spans(events)["decode_spans"] == 12


def test_voc_stage_spans_equal_jax(tmp_path):
    labels = str(tmp_path / "labels.csv")
    open(labels, "w").close()
    tar = str(tmp_path / "voc.tar")
    write_voc_tar(tar, labels, 12, np.random.default_rng(42))
    argv = ["--trainLocation", tar, "--testLocation", tar, "--labelPath", labels,
            "--lambda", "0.05", "--descDim", "8", "--vocabSize", "4",
            "--numPcaSamples", "2000", "--numGmmSamples", "2000"]
    port, ref = _both(tmp_path, pvoc.main, jvoc.main, argv)
    assert port == ref == ["sift", "pca", "gmm", "fisher_features", "solve", "eval"]


def test_mnist_stage_spans_equal_jax(tmp_path):
    rng = np.random.default_rng(7)
    centers = rng.normal(0, 1.0, (4, 64))
    paths = []
    for name, n in (("train", 80), ("test", 40)):
        labels = rng.integers(1, 5, n)
        rows = np.column_stack([labels, centers[labels - 1] + 0.3 * rng.normal(size=(n, 64))])
        paths.append(str(tmp_path / f"{name}.csv"))
        np.savetxt(paths[-1], rows, delimiter=",", fmt="%.5f")
    argv = ["--trainLocation", paths[0], "--testLocation", paths[1], "--numFFTs", "2",
            "--blockSize", "512", "--lambda", "10"]
    port, ref = _both(tmp_path, pmnist.main, jmnist.main, argv)
    assert port == ref == ["load", "featurize", "solve", "eval"]


def test_imagenet_stage_spans(tmp_path):
    from test_torch_imagenet import NUM_CLASSES, SMALL, _write_split

    rng = np.random.default_rng(8)
    _write_split(tmp_path, "train", 2, rng)
    _write_split(tmp_path, "test", 1, rng)
    labels = tmp_path / "labels.txt"
    labels.write_text("".join(f"syn{c:03d} {c}\n" for c in range(NUM_CLASSES)))
    path = str(tmp_path / "t.jsonl")
    pinet.main(["--trainLocation", str(tmp_path / "train"), "--testLocation",
                str(tmp_path / "test"), "--labelPath", str(labels), *SMALL,
                "--device", "cpu", "--trace", path])
    # the JAX CLI's stage_timer names (keystone_tpu/workloads/imagenet_sift_lcs_fv.py)
    assert _stages(path) == ["sift_branch", "lcs_branch", "solve", "eval"]
