"""The port's launcher, ``python -m keystone_tpu_torch <Workload> [flags]``,
against ``bin/run-pipeline`` (read, never run): every alias of the script
resolves to the port's module of the same name, the usage lists the same
workloads, an unknown workload exits 2 and none exits 1, the script's two
environment variables map onto the port's device settings, and a workload
run through the launcher gives the errors of an in-process ``main`` on the
same files."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import keystone_tpu_torch.__main__ as launcher
from keystone_tpu_torch.workloads import mnist_random_fft as pt_mnist
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
SCRIPT = (ROOT / "bin" / "run-pipeline").read_text()
WORKLOADS = ROOT / "keystone_tpu_torch" / "workloads"


def _case_lines() -> dict:
    """``bin/run-pipeline``'s case arms: alias -> module."""
    arms = re.findall(r"^\s*([A-Za-z_|]+)\) MOD=(\w+) ;;$", SCRIPT, re.M)
    return {alias: mod for names, mod in arms for alias in names.split("|")}


def _launch(*args, env=None) -> subprocess.CompletedProcess:
    import os

    full = {k: v for k, v in os.environ.items()
            if k not in ("PYTHONPATH", launcher.PLATFORM_ENV, launcher.NUM_DEVICES_ENV)}
    full["PYTHONPATH"] = str(ROOT)
    full.update(env or {})
    return subprocess.run([sys.executable, "-m", "keystone_tpu_torch", *args], cwd=ROOT,
                          env=full, capture_output=True, text=True, timeout=300)


def test_every_alias_resolves_to_the_port_module():
    cases = _case_lines()
    assert len(cases) == 18 and len(set(cases.values())) == 9
    for alias, mod in cases.items():
        assert launcher.resolve(alias) == mod, alias
        assert (WORKLOADS / f"{mod}.py").is_file()
    for mod in set(cases.values()):
        module = __import__(f"keystone_tpu_torch.workloads.{mod}", fromlist=["main"])
        assert callable(module.main), mod
        # run as __main__, its log lines must still reach the package's handler
        assert module._log.name == f"keystone_tpu_torch.workloads.{mod}"
    assert launcher.resolve("mnist") is None and launcher.resolve("") is None


def test_usage_lists_the_scripts_workloads():
    header = re.findall(r"^#\s{3}(\w+\s+\| \w+)$", SCRIPT, re.M)
    assert len(header) == 9
    for line in header:
        assert f"  {line}" in launcher.USAGE.splitlines()


def test_no_workload_prints_the_usage_and_exits_1():
    out = _launch()
    assert out.returncode == 1
    assert out.stdout.strip() == launcher.USAGE.strip()


@pytest.mark.parametrize("name", ["Nope", "mnist", "bin/run-pipeline"])
def test_unknown_workload_exits_2(name):
    out = _launch(name, "--device", "cpu")
    assert out.returncode == 2
    assert out.stderr.strip() == f"unknown workload: {name}"


def test_host_only_workloads_are_those_without_a_device_flag():
    for path in sorted(WORKLOADS.glob("*.py")):
        if path.stem in _case_lines().values():
            takes_device = '"--device"' in path.read_text()
            assert takes_device is (path.stem not in launcher.HOST_ONLY), path.stem


@pytest.mark.parametrize("env,flags", [
    ({}, []),
    ({"KEYSTONE_PLATFORM": "cpu"}, ["--device", "cpu"]),
    ({"KEYSTONE_PLATFORM": "tpu"}, []),
    ({"KEYSTONE_NUM_DEVICES": "1"}, ["--device", "cpu"]),
])
def test_environment_maps_onto_the_device_flag(env, flags):
    for mod in set(_case_lines().values()):
        want = [] if mod in launcher.HOST_ONLY else flags
        assert launcher.device_flags(mod, env) == want, mod


@pytest.mark.parametrize("raw", ["4", "8", "0", "two"])
def test_num_devices_the_port_cannot_give_is_refused(raw):
    with pytest.raises(launcher.LaunchError, match="KEYSTONE_NUM_DEVICES"):
        launcher.device_flags("mnist_random_fft", {"KEYSTONE_NUM_DEVICES": raw})


def test_num_devices_4_exits_2_naming_the_gap():
    out = _launch("MnistRandomFFT", "--trainLocation", "x", "--testLocation", "y",
                  env={"KEYSTONE_NUM_DEVICES": "4"})
    assert out.returncode == 2
    assert "KEYSTONE_NUM_DEVICES=4" in out.stderr and "parse_mesh" in out.stderr


@pytest.fixture(scope="module")
def noisy_csvs(tmp_path_factory):
    """MNIST-shaped CSVs noisy enough that both errors are well above 0."""
    rng = np.random.default_rng(11)
    centers = rng.normal(0, 1.0, (10, 784))

    def make(n):
        labels = rng.integers(1, 11, n)
        return np.column_stack([labels, centers[labels - 1] + 2.5 * rng.normal(size=(n, 784))])

    d = tmp_path_factory.mktemp("launcher_mnist")
    train, test = str(d / "train.csv"), str(d / "test.csv")
    np.savetxt(train, make(300), delimiter=",", fmt="%.5f")
    np.savetxt(test, make(120), delimiter=",", fmt="%.5f")
    return train, test


def _logged_error(stderr: str, label: str) -> str:
    return re.findall(rf"{label} Error is (\S+)%$", stderr, re.M)[-1]


def test_mnist_through_the_launcher_matches_main(noisy_csvs):
    train, test = noisy_csvs
    flags = ["--trainLocation", train, "--testLocation", test, "--numFFTs", "2",
             "--blockSize", "512", "--lambda", "1"]
    out = _launch("MnistRandomFFT", *flags, env={"KEYSTONE_PLATFORM": "cpu"})
    assert out.returncode == 0, out.stderr
    res = pt_mnist.main([*flags, "--device", "cpu"])
    assert 0 < res["test_error"] < 90
    assert _logged_error(out.stderr, "Train") == str(res["train_error"])
    assert _logged_error(out.stderr, "TEST") == str(res["test_error"])
