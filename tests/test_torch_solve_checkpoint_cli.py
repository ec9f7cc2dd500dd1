"""The resumable block solve through the port's CLIs: MnistRandomFFT's
``--solveCheckpoint`` / ``--resumeFrom`` and VOCSIFTFisher's
``--solveCheckpoint`` (resume when the state exists, remove it after a
completed fit), each after a fit killed between two blocks, on the CPU.

A kill is the state writer raising once it has written a given block's
state (``solvers.block.bcd_checkpoint_writer`` is wrapped for the killed
run).  Bars: the resumed run's predictions (MNIST) and test scores and
MAP (VOC) equal an uninterrupted run's."""

import os

import numpy as np
import pytest

from keystone_tpu_torch.solvers import block as block_mod
from keystone_tpu_torch.workloads import mnist_random_fft as pmnist
from keystone_tpu_torch.workloads import voc_sift_fisher as pvoc
from test_fisher_pipelines import write_voc_tar
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401

# VOC at 6,144 Fisher features (PCA to 32, 96 Gaussians): two blocks of the
# workload's 4,096-wide solve, so a kill after block 0 leaves one to resume.
VOC_FLAGS = ["--lambda", "0.05", "--descDim", "32", "--vocabSize", "96",
             "--numPcaSamples", "6000", "--numGmmSamples", "6000", "--scaleStep", "0",
             "--device", "cpu"]


class _Killed(RuntimeError):
    """The simulated preemption between two blocks."""


class _Writers:
    """Wraps ``bcd_checkpoint_writer`` for one run: records the (epoch,
    block) of every state written and raises after ``kill_after`` of
    them."""

    def __init__(self, monkeypatch, kill_after: int | None = None):
        self.written = []
        real = block_mod.bcd_checkpoint_writer

        def writer(path):
            write = real(path)

            def cb(state):
                write(state)
                self.written.append((state["epoch"], state["block"]))
                if kill_after is not None and len(self.written) == kill_after:
                    raise _Killed(f"killed after block {state['block']}")

            return cb

        monkeypatch.setattr(block_mod, "bcd_checkpoint_writer", writer)


@pytest.fixture(scope="module")
def mnist_csvs(tmp_path_factory):
    """784-pixel rows of 10 classes, centres shared by 300 train and 100
    test rows, 1-indexed labels in column 0."""
    rng = np.random.default_rng(11)
    centers = rng.normal(0, 1.0, (10, 784))

    def make(n):
        labels = rng.integers(1, 11, n)
        return np.column_stack([labels, centers[labels - 1] + 0.3 * rng.normal(size=(n, 784))])

    d = tmp_path_factory.mktemp("mnist")
    train, test = str(d / "train.csv"), str(d / "test.csv")
    np.savetxt(train, make(300), delimiter=",", fmt="%.5f")
    np.savetxt(test, make(100), delimiter=",", fmt="%.5f")
    return ["--trainLocation", train, "--testLocation", test, "--numFFTs", "4",
            "--blockSize", "512", "--lambda", "10", "--device", "cpu"]


@pytest.fixture(scope="module")
def voc_tar(tmp_path_factory):
    d = tmp_path_factory.mktemp("voc")
    labels = str(d / "labels.csv")
    open(labels, "w").close()
    write_voc_tar(str(d / "voc.tar"), labels, 24, np.random.default_rng(42))
    return ["--trainLocation", str(d / "voc.tar"), "--testLocation", str(d / "voc.tar"),
            "--labelPath", labels]


def test_mnist_killed_fit_resumes_to_the_uninterrupted_predictions(mnist_csvs, tmp_path,
                                                                     monkeypatch):
    whole = pmnist.main(mnist_csvs)
    state = str(tmp_path / "bcd")
    killed = _Writers(monkeypatch, kill_after=2)
    with pytest.raises(_Killed):
        pmnist.main([*mnist_csvs, "--solveCheckpoint", state])
    assert killed.written == [(0, 0), (0, 1)]
    resumed = _Writers(monkeypatch)
    res = pmnist.main([*mnist_csvs, "--solveCheckpoint", state, "--resumeFrom", state])
    # 4 FFT groups of one 512-wide block each: the resumed fit starts at block 2
    assert resumed.written == [(0, 2), (0, 3)]
    assert res["fit_report"]["chosen_tier"] == "stepwise[checkpoint]"
    np.testing.assert_array_equal(res["test_predictions"], whole["test_predictions"])
    assert res["test_error"] == whole["test_error"]


def test_voc_solve_checkpoint_resumes_and_removes_its_state(voc_tar, tmp_path, monkeypatch):
    whole = pvoc.main([*voc_tar, *VOC_FLAGS])
    state = str(tmp_path / "voc_bcd")
    killed = _Writers(monkeypatch, kill_after=1)
    with pytest.raises(_Killed):
        pvoc.main([*voc_tar, *VOC_FLAGS, "--solveCheckpoint", state])
    assert killed.written == [(0, 0)] and os.path.exists(state + ".npz")
    resumed = _Writers(monkeypatch)
    res = pvoc.main([*voc_tar, *VOC_FLAGS, "--solveCheckpoint", state])
    assert resumed.written == [(0, 1)]
    assert not os.path.exists(state + ".npz")
    np.testing.assert_array_equal(res["test_scores"], whole["test_scores"])
    assert res["map"] == whole["map"]


@pytest.mark.parametrize("flags", [["--mesh", "8"], ["--autoShard", "--mesh", "8"]])
@pytest.mark.parametrize("cli", ["mnist", "voc"])
def test_mesh_and_autoshard_stay_usage_errors(cli, flags, mnist_csvs, voc_tar):
    """MnistRandomFFT and VOCSIFTFisher take ``--mesh``, with or without
    ``--autoShard``, and refuse a mesh of more slots than they have
    devices, as the JAX package does."""
    argv = [*mnist_csvs, *flags] if cli == "mnist" else [*voc_tar, *VOC_FLAGS, *flags]
    main = pmnist.main if cli == "mnist" else pvoc.main
    with pytest.raises(ValueError, match="mesh 8x1 needs 8 devices, have 1"):
        main(argv)


@pytest.mark.parametrize("cli", ["mnist", "voc"])
def test_auto_shard_records_the_placement(cli, mnist_csvs, voc_tar, monkeypatch):
    """``--autoShard`` forces the placement search of the block solve: the
    results carry its table, and the predictions are the hand ladder's."""
    main, argv, key = (pmnist.main, mnist_csvs, "test_predictions") if cli == "mnist" else (
        pvoc.main, [*voc_tar, *VOC_FLAGS], "test_scores")
    searched = main([*argv, "--autoShard"])
    placement = searched["placement"]
    assert placement["ranking"] == ["fused", "stepwise", "host_staged"]
    assert placement["chosen"] == searched["fit_report"]["chosen_tier"] == "fused"
    assert placement["measured_seconds"] is not None
    monkeypatch.setenv("KEYSTONE_AUTOSHARD", "0")
    hand = main(argv)
    assert "placement" not in hand
    np.testing.assert_array_equal(searched[key], hand[key])
