"""keystone_tpu_torch stands alone: importing every module of the port and
``chip_smoke`` pulls in neither ``jax`` nor any module of the JAX package
(``keystone_tpu`` / ``keystone_tpu.*`` — ``keystone_tpu_torch`` shares the
prefix, so the check is by exact name and dotted prefix), and
``import keystone_tpu_torch`` alone imports no torch.  Each check runs in a
fresh interpreter, since this test process already holds both packages."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent

_IMPORT_ALL = """
import importlib, json, pkgutil, sys
import keystone_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    keystone_tpu_torch.__path__, "keystone_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
print(json.dumps({"imported": names, "modules": sorted(sys.modules)}))
"""

_IMPORT_PACKAGE = """
import json, sys
import keystone_tpu_torch
print(json.dumps({"modules": sorted(sys.modules)}))
"""


_IMPORT_OBSERVABILITY = """
import importlib, json, sys
for name in %r:
    importlib.import_module("keystone_tpu_torch." + name)
print(json.dumps({"modules": sorted(sys.modules)}))
"""

#: The observability base and the fleet plane above it: no torch at import
#: (numerics and logging import it inside the functions that reduce or time
#: on a device).
OBSERVABILITY = ("core.trace", "core.telemetry", "core.resilience", "core.logging",
                 "core.numerics", "core.fleetobs")
#: The wire client's half, the client tool a bench spawns, and the launcher:
#: no torch at import (a client process on a card's host creates no CUDA
#: context; the launcher leaves torch to the workload it runs).
CLIENT = ("core.serve_errors", "core.wire", "tools.serve_client", "__main__")
#: The chaos tool and the fault injectors: no torch at import (a decode
#: worker that the harness spawns re-imports the tool as its main module).
CHAOS_TOOLS = ("tools.chaos_run", "testing.faults")
#: The chaos harness and the port's tools that had a JAX-only counterpart.
CHAOS = ("testing.chaos", "testing.faults", "tools.chaos_run", "tools.voc_leave2out_cv")


def _run(code: str) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def _jax_package(name: str) -> bool:
    return name == "keystone_tpu" or name.startswith("keystone_tpu.")


def test_port_and_smoke_import_no_jax():
    rec = _run(_IMPORT_ALL)
    for name in ("workloads.cifar_random_patch", "ops.rect_pool", "workloads.voc_sift_fisher",
                 "ops.fv_stats", "ops.sift", "solvers.gmm", "loaders.image_loaders",
                 "ops.jpeg_device", "ops.native_entropy", "core.ingest",
                 "testing.jpeg_encode", "ops.lcs", "solvers.weighted",
                 "workloads.imagenet_sift_lcs_fv", "core.serve", "core.frontend",
                 "core.wire", "workloads.serve_common", "parallel.distributed",
                 "parallel.mesh", "workloads.multihost", "tools.serve_bench", *OBSERVABILITY,
                 *CLIENT, *CHAOS):
        assert f"keystone_tpu_torch.{name}" in rec["imported"]
    mods = rec["modules"]
    assert not [m for m in mods if m == "jax" or m.startswith("jax.")]
    assert not [m for m in mods if _jax_package(m)]


_RUN_WORKER = """
import atexit, json, runpy, sys
atexit.register(lambda: print(json.dumps({"modules": sorted(sys.modules)})))
sys.argv = ["multihost", "fit-serve", "--shards-dir", %r, "--out", %r, "--device", "cpu"]
runpy.run_module("keystone_tpu_torch.workloads.multihost", run_name="__main__")
"""


def test_spawned_worker_imports_no_jax(tmp_path):
    """A multi-process worker, run as ``python -m
    keystone_tpu_torch.workloads.multihost fit-serve`` runs it (ingest,
    fit, checkpoint-free serve), ends with no jax and no JAX-package module
    in its ``sys.modules``."""
    from keystone_tpu_torch.workloads import multihost

    shards = str(tmp_path / "shards")
    multihost.make_shard_tars(shards, 1, 2)
    out = str(tmp_path / "rec.json")
    mods = _run(_RUN_WORKER % (shards, out))["modules"]
    assert json.loads(Path(out).read_text())["n_images"] == 2
    assert "keystone_tpu_torch.core.serve" in mods and "torch" in mods
    assert not [m for m in mods if m == "jax" or m.startswith("jax.") or _jax_package(m)]


def test_package_import_is_cheap():
    mods = _run(_IMPORT_PACKAGE)["modules"]
    assert "keystone_tpu_torch" in mods
    assert "torch" not in mods
    assert not [m for m in mods if m == "jax" or _jax_package(m)]


@pytest.mark.parametrize(
    "name,expect", [("keystone_tpu", True), ("keystone_tpu.ops", True),
                    ("keystone_tpu_torch", False), ("keystone_tpu_torch.ops", False)]
)
def test_prefix_rule(name, expect):
    assert _jax_package(name) is expect


def test_observability_imports_no_torch():
    mods = _run(_IMPORT_OBSERVABILITY % (OBSERVABILITY,))["modules"]
    for name in OBSERVABILITY:
        assert f"keystone_tpu_torch.{name}" in mods
    assert "torch" not in mods
    assert not [m for m in mods if m == "jax" or _jax_package(m)]


def test_client_and_launcher_import_no_torch():
    mods = _run(_IMPORT_OBSERVABILITY % (CLIENT,))["modules"]
    for name in CLIENT:
        assert f"keystone_tpu_torch.{name}" in mods
    assert not [m for m in mods if m == "torch" or m.startswith("torch.")]
    assert not [m for m in mods if m == "jax" or _jax_package(m)]


def test_chaos_tool_imports_no_torch():
    mods = _run(_IMPORT_OBSERVABILITY % (CHAOS_TOOLS,))["modules"]
    for name in CHAOS_TOOLS:
        assert f"keystone_tpu_torch.{name}" in mods
    assert not [m for m in mods if m == "torch" or m.startswith("torch.")]
    assert not [m for m in mods if m == "jax" or _jax_package(m)]


_RUN_CHAOS = """
import atexit, json, runpy, sys
atexit.register(lambda: print(json.dumps({"modules": sorted(sys.modules)})))
sys.argv = ["chaos_run", "--device", "cpu", "--seed", "3"]
runpy.run_module("keystone_tpu_torch.tools.chaos_run", run_name="__main__")
"""


def test_chaos_run_imports_no_jax():
    """A chaos schedule run as ``python -m keystone_tpu_torch.tools.chaos_run``
    (the harness, the workload, the ingest path) ends with no jax and no
    JAX-package module loaded."""
    mods = _run(_RUN_CHAOS)["modules"]
    assert "keystone_tpu_torch.testing.chaos" in mods and "torch" in mods
    assert not [m for m in mods if m == "jax" or m.startswith("jax.") or _jax_package(m)]
