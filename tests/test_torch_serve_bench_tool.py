"""The port's serving tools (``keystone_tpu_torch.tools.serve_bench`` and
``serve_client``) against the JAX package's ``tools/serve_bench.py`` and
``tools/serve_client.py`` on the CPU.

* The toy engines of the two tools give bit-equal answers on the same
  requests (``max(x * w, b)`` with ``w`` and ``b`` from the same seeded
  generator; f32 multiply and max are exact).
* Every mode's record has every key the JAX tool's record of that mode
  has: the in-process, ``--numerics``, ``--kill-device`` (4 CPU slots) and
  ``--drift-refit`` modes run both tools here; the ``--wire``, ``--shift``
  and ``--hosts`` modes spawn processes, so the JAX keys are pinned (read
  from the JAX tool's records).  Each port mode exits 0 with no request
  lost.
* ``--hosts 2 --kill-host 1 --collect`` loses no request and carries a
  ``fleet_obs`` section, never the no-spawn record.
* Across packages over localhost: the two ``WireClient``s against the
  other package's ``WireServer`` give equal answers; the JAX tool's client
  process drives the port's server, and the port's client process drives
  the JAX server and ends with no torch, no jax and no JAX-package module
  in its ``sys.modules``."""

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from keystone_tpu.core import frontend as jfrontend
from keystone_tpu.core import wire as jwire
from keystone_tpu_torch.core import frontend as kfrontend
from keystone_tpu_torch.core import wire
from keystone_tpu_torch.tools import serve_bench as pbench
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
import serve_bench as jbench  # noqa: E402  (tools/serve_bench.py)

#: The sections of a record whose own keys are compared.
SECTIONS = ("bench", "shift", "reshard", "drill", "fleet_obs", "router",
            "router_route_overhead_us", "wire_server")

_CLIENT_KEYS = ["dtype", "host", "max_ms", "metric", "p50_ms", "p99_ms", "ping_ms", "port",
                "qps", "requests", "retry_after", "seed", "shape", "wall_seconds", "window"]
_WIRE_TOP = ["bench", "engine_build_seconds", "metric", "ok", "requests_per_client", "router",
             "router_route_overhead_us", "seconds", "shapes", "wire", "wire_p99_ms",
             "wire_server"]
_ROUTER = ["admissions", "config", "engines", "label", "last_reanchor", "mesh", "stats"]
_WIRE_SECTIONS = {
    "bench": ["client_processes", "clients", "errors", "per_shape", "requests",
              "retry_after_total", "wire_p50_ms", "wire_p99_ms"],
    "router": _ROUTER,
    "router_route_overhead_us": ["mean", "p50", "p99"],
    "wire_server": ["active_connections", "host", "label", "max_inflight", "port", "stats"],
}
#: The JAX tool's record keys of the modes that spawn processes, read from
#: its records (``tools/serve_bench.py`` ``run_wire``, ``run_shift``,
#: ``run_hosts``).
JAX_KEYS = {
    "wire": ({"": _WIRE_TOP, **_WIRE_SECTIONS}, _CLIENT_KEYS),
    "shift": ({"": [*_WIRE_TOP, "shift"], **_WIRE_SECTIONS,
               "shift": ["client", "lost_requests", "new_shape", "new_shape_live", "retires",
                         "warm_adds"]}, _CLIENT_KEYS),
    "hosts": ({"": ["bench", "bringup_seconds", "clients", "dropped_requests", "fleet",
                    "fleet_obs", "hosts", "killed_at_answered", "killed_host", "metric", "ok",
                    "reanchor_wall_s", "requests_per_client", "seconds", "survivor_counters",
                    "worker_rcs"],
               "bench": ["errors", "p50_ms", "p99_ms", "requests"],
               "fleet_obs": ["alive", "fleet_p99_ms", "lost", "obs_member_lost",
                             "pooled_metric", "statusz"]}, None),
}
MODES = {
    "inproc": [],
    "numerics": ["--numerics"],
    "kill_device": ["--kill-device", "1"],
    "drift_refit": ["--drift-refit"],
    "wire": ["--wire", "--clients", "2"],
    "shift": ["--wire", "--shift"],
}


def _record(main, argv) -> tuple[int, dict]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, json.loads(buf.getvalue().splitlines()[0])


def _keys(rec: dict) -> dict:
    out = {"": sorted(rec)}
    for name in SECTIONS:
        if isinstance(rec.get(name), dict):
            out[name] = sorted(rec[name])
    return out


def _assert_superset(port: dict, jax_keys: dict) -> None:
    got = _keys(port)
    for section, keys in jax_keys.items():
        missing = set(keys) - set(got.get(section, ()))
        assert not missing, f"{section or 'top level'} lacks the JAX keys {sorted(missing)}"


@pytest.mark.parametrize("shape", [(16,), (3, 5)])
def test_toy_engines_are_bit_equal(rng, shape):
    reqs = rng.standard_normal((9, *shape)).astype(np.float32)
    port = pbench.toy_engine(shape, device="cpu")
    ref = jbench.toy_engine(shape)
    want = np.asarray(ref.offline(reqs))
    assert np.array_equal(port.offline(reqs), want)
    with kfrontend.ShapeRouter(label="toy_parity") as router:
        router.add_engine(port)
        served = np.stack([router.submit(r).result(30.0) for r in reqs])
    assert np.array_equal(served, want)
    with jfrontend.ShapeRouter(label="toy_parity") as router:
        router.add_engine(ref)
        assert np.array_equal(np.stack([router.submit(r).result(30.0) for r in reqs]), want)


@pytest.mark.parametrize("mode", ["inproc", "numerics", "kill_device", "drift_refit"])
def test_mode_has_the_jax_records_keys(mode, monkeypatch):
    argv = ["--requests", "8", *MODES[mode]]
    if mode == "kill_device":  # four mesh slots of the CPU: default_devices()
        monkeypatch.setenv("KEYSTONE_DIST_DEVICE", "cpu")
        monkeypatch.setenv("KEYSTONE_DIST_LOCAL_SLOTS", "4")
    rc, port = _record(pbench.main, [*argv, "--device", "cpu"])
    assert rc == 0 and port["ok"], port
    jrc, ref = _record(jbench.main, argv)
    assert jrc == 0
    _assert_superset(port, _keys(ref))
    if mode == "drift_refit":
        assert set(port["drill"]) >= set(ref["drill"])
        assert set(port["drill"]["cycle"]) >= set(ref["drill"]["cycle"])
        assert port["dropped_requests"] == 0 and port["drill"]["post_swap_bit_equal"]
    else:
        assert port["bench"]["requests"] == 4 * 8
    if mode == "kill_device":
        assert port["mesh"] == "4x1" and port["reshard"]["surviving_mesh"] == "3x1"
        assert port["reanchor_dropped_requests"] == 0 and not port["reshard"]["failed"]


@pytest.mark.parametrize("mode", ["wire", "shift"])
def test_wire_mode_has_the_jax_records_keys(mode):
    rc, port = _record(pbench.main, ["--requests", "8", *MODES[mode], "--device", "cpu"])
    assert rc == 0 and port["ok"], port
    jax_keys, client_keys = JAX_KEYS[mode]
    _assert_superset(port, jax_keys)
    procs = port["bench"]["client_processes"]
    assert len(procs) == 2 and port["bench"]["requests"] == 2 * 8
    for proc in procs:
        assert set(proc["pid_record"]) >= set(client_keys)
    assert all(0 < s < 60 for s in port["bench"]["client_startup_s"])
    if mode == "shift":
        shift = port["shift"]
        assert set(shift["client"]) >= set(client_keys)
        assert shift["lost_requests"] == 0 and shift["warm_adds"] >= 1 and shift["retires"] >= 1


def test_hosts_kill_host_collect_loses_nothing():
    rc, port = _record(pbench.main, ["--hosts", "2", "--kill-host", "1", "--collect",
                                     "--requests", "8", "--device", "cpu", "--timeout", "90"])
    assert "multihost_unavailable" not in port
    assert rc == 0 and port["ok"], port
    _assert_superset(port, JAX_KEYS["hosts"][0])
    assert port["dropped_requests"] == 0 and port["bench"]["requests"] == 4 * 8
    assert port["fleet_obs"]["obs_member_lost"] >= 1
    assert port["worker_rcs"][0] == 0


@pytest.fixture(scope="module")
def servers():
    """A port and a JAX ``WireServer``, each over its package's toy engine
    for shape 16 on the CPU."""
    with contextlib.ExitStack() as stack:
        prouter = stack.enter_context(kfrontend.ShapeRouter(label="cross_port"))
        prouter.add_engine(pbench.toy_engine((16,), device="cpu"))
        jrouter = stack.enter_context(jfrontend.ShapeRouter(label="cross_jax"))
        jrouter.add_engine(jbench.toy_engine((16,)))
        port_ws = stack.enter_context(wire.WireServer(prouter, port=0, label="cross_port"))
        jax_ws = stack.enter_context(jwire.WireServer(jrouter, port=0, label="cross_jax"))
        yield port_ws, jax_ws


def test_clients_and_servers_interoperate(rng, servers):
    port_ws, jax_ws = servers
    reqs = list(rng.standard_normal((12, 16)).astype(np.float32))
    want = pbench.toy_engine((16,), device="cpu").offline(np.stack(reqs))
    with jwire.WireClient(port=port_ws.port) as client:
        jax_to_port = np.stack(client.predict_many(reqs))
    with wire.WireClient(port=jax_ws.port) as client:
        port_to_jax = np.stack(client.predict_many(reqs))
    assert np.array_equal(jax_to_port, want) and np.array_equal(port_to_jax, want)


def _env() -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_jax_tool_client_drives_the_port_server(servers):
    port_ws, _ = servers
    out = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "serve_client.py"), "--port", str(port_ws.port),
         "--shape", "16", "--requests", "16", "--seed", "3"],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    rec = json.loads(out.stdout.splitlines()[0])
    assert rec["requests"] == 16 and rec["shape"] == [16]


_RUN_CLIENT = """
import atexit, json, runpy, sys
atexit.register(lambda: print(json.dumps({"modules": sorted(sys.modules)})))
sys.argv = ["serve_client", "--port", %r, "--shape", "16", "--requests", "16", "--seed", "4"]
runpy.run_module("keystone_tpu_torch.tools.serve_client", run_name="__main__")
"""


def test_port_client_process_imports_no_torch(servers):
    """The port's client process, as ``serve_bench --wire`` spawns it, drives
    the JAX server and never imports torch (no CUDA context on a card's
    host), jax or the JAX package."""
    _, jax_ws = servers
    out = subprocess.run(
        [sys.executable, "-c", _RUN_CLIENT % str(jax_ws.port)],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    rec = json.loads(lines[0])
    assert rec["requests"] == 16 and rec["metric"] == "serve_client"
    mods = json.loads(lines[-1])["modules"]
    assert "keystone_tpu_torch.core.wire" in mods
    assert not [m for m in mods if m == "torch" or m.startswith("torch.")]
    assert not [m for m in mods if m == "jax" or m.startswith("jax.")
                or m == "keystone_tpu" or m.startswith("keystone_tpu.")]
