"""``python -m keystone_tpu_torch.tools.chaos_run`` against the JAX tool
(``tools/chaos_run.py``): the same flags, seed selection, record keys and
exit codes, plus ``--device``.  The JAX tool runs in this process (under the
conftest JAX runs on the CPU); the port's tool runs as a process of its own
where its exit code and output are what is held."""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import chaos as jchaos
from keystone_tpu_torch.testing import chaos
from keystone_tpu_torch.tools import chaos_run
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent


def _jax_tool():
    spec = importlib.util.spec_from_file_location("jax_chaos_run", ROOT / "tools" / "chaos_run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_tool(*args, timeout=120):
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "KEYSTONE_TRACE")}
    env["PYTHONPATH"] = str(ROOT)
    return subprocess.run([sys.executable, "-m", "keystone_tpu_torch.tools.chaos_run", *args],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout)


def test_one_schedule_has_the_jax_record(tmp_path, capsys):
    out = _port_tool("--device", "cpu", "--seed", "0", "--trace", str(tmp_path / "port"))
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    port = json.loads(lines[0])
    assert lines[-1] == "# chaos: 1/1 schedules honored the invariant"
    assert lines[1].startswith("# ok  seed=0 solver_oom: completed_equal [")

    assert _jax_tool().main(["--seed", "0", "--trace", str(tmp_path / "ref")]) == 0
    ref = json.loads(capsys.readouterr().out.splitlines()[0])
    assert list(port) == list(ref) == ["metric", "workload", "seeds", "ok", "outcomes",
                                       "results", "trace"]
    for key in ("metric", "workload", "seeds", "ok", "outcomes"):
        assert port[key] == ref[key], key
    [p], [r] = port["results"], ref["results"]
    assert list(p) == list(r)
    for key in ("seed", "workload", "fault", "outcome", "error_type", "phase"):
        assert p[key] == r[key], key
    assert p["counters_delta"]["solver_oom_retry"] == r["counters_delta"]["solver_oom_retry"] == 1
    assert list(port["trace"]) == list(ref["trace"]) and port["trace"]["violations"] == {}
    assert Path(p["trace_path"]).is_file()


def test_hosts_below_two_is_a_usage_error(capsys):
    assert chaos_run.main(["--hosts", "1"]) == _jax_tool().main(["--hosts", "1"]) == 2
    assert "--hosts must be >= 2" in capsys.readouterr().err


@pytest.mark.parametrize("flags", [
    [], ["--full"], ["--stream"], ["--serve"], ["--stream", "--serve"], ["--stream", "--full"],
    ["--seed", "8", "--stream"], ["--seed", "13", "--serve"], ["--seed", "0", "--stream"],
])
def test_seed_selection_equals_jax(flags, monkeypatch, capsys):
    """Each tool's ``run_suite`` is stubbed to record the seeds it was given;
    the selection, the printed record and the exit code must agree."""
    got = {}

    def stub(key):
        def run_suite(seeds, **kw):
            got[key] = list(seeds)
            return []
        return run_suite

    jax_tool = _jax_tool()
    monkeypatch.setattr(jchaos, "run_suite", stub("jax"))
    monkeypatch.setattr(chaos, "run_suite", stub("port"))
    rc_ref = jax_tool.main(flags)
    ref_out = capsys.readouterr().out
    rc_port = chaos_run.main([*flags, "--device", "cpu"])
    port_out = capsys.readouterr().out
    assert rc_port == rc_ref
    assert got.get("port") == got.get("jax")
    assert port_out == ref_out
    want = chaos_run.select_seeds(jchaos, int(flags[1]) if flags[:1] == ["--seed"] else None,
                                  "--full" in flags, "--stream" in flags, "--serve" in flags)
    assert tuple(got.get("port", ())) == want
    if flags == ["--seed", "0", "--stream"]:
        assert rc_port == 1 and "no matching schedules" in port_out


def test_cuda_without_a_card_names_it(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    out = _port_tool("--seed", "0")
    assert out.returncode != 0
    assert "no CUDA card" in out.stderr and not out.stdout
