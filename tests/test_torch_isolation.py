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
                 "workloads.imagenet_sift_lcs_fv"):
        assert f"keystone_tpu_torch.{name}" in rec["imported"]
    mods = rec["modules"]
    assert not [m for m in mods if m == "jax" or m.startswith("jax.")]
    assert not [m for m in mods if _jax_package(m)]


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
