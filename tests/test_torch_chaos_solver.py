"""The solver families of the chaos harness (``tests/chaos.py``) on the
port: ``solver_oom``, ``oom_cascade``, ``preempt_resume``, ``deadline`` and
``plan_mispredict``, each on the port's MnistRandomFFT and RandomPatchCifar at the harness's case
sizes (``chaos._mnist_case`` and ``chaos._run_cifar``'s files and
settings), with the harness's fault parameters (``chaos.make_schedule``).

The harness's invariant: every faulted run either completes with
predictions equal to the fault-free run's, or fails with a typed error
that the fault ledger counted.  The injection points are the port's:
``solvers.block._fused_bcd_impl`` for the fused tier, and
``_bcd_block_solve``, every tier's block update, whose first call once the
fused tier has failed is the stepwise tier's.  An injected out-of-memory
error is ``torch.OutOfMemoryError``.  ``plan_mispredict`` kills the
placement search's top-ranked plan (the fused tier) and holds the run to
the harness's step-down oracle (``chaos._stepdown_oracle``): the fit chose
the next-ranked plan, counted ``autoshard_stepdown``.  ``spec_mispredict``
runs both workloads on a 4x2 mesh of CPU slots that this file builds: a
spec candidate on the head mesh of the fault-free mesh run's placement is
forced to the top through ``conf.solve_plan``, its mesh tier
(``solvers.block._execute_fused_bcd_mesh``) dies out of memory, and the run
must step down to the default layout, counted, with predictions equal to
the fault-free mesh run's."""

import contextlib
import os
import time

import numpy as np
import pytest
import torch

import chaos
from keystone_tpu_torch.core.resilience import DeadlineExceeded, counters, deadline
from keystone_tpu_torch.loaders.cifar import cifar_loader
from keystone_tpu_torch.loaders.csv_loader import LabeledData
from keystone_tpu_torch.parallel.mesh import make_mesh
from keystone_tpu_torch.solvers import block as block_mod
from keystone_tpu_torch.workloads import cifar_random_patch as pcifar
from keystone_tpu_torch.workloads import mnist_random_fft as pmnist
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401

FAMILIES = ("solver_oom", "oom_cascade", "preempt_resume", "deadline", "plan_mispredict",
            "spec_mispredict")


def _schedule(kind: str) -> chaos.Fault:
    """The harness's fault of family ``kind`` (its first seed)."""
    return chaos.make_schedule(chaos.FAMILIES.index(kind))


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """The harness's MNIST split and Cifar files, and a runner per
    workload at the harness's settings, on the CPU."""
    train, test = chaos._mnist_case()
    mnist = [LabeledData(labels=s.labels, data=s.data) for s in (train, test)]
    root = tmp_path_factory.mktemp("chaos_cifar")
    rng = np.random.default_rng(chaos._DATA_SEED)
    palette = rng.uniform(40, 215, (4, 3))
    chaos._write_synthetic_cifar(root / "train.bin", 72, rng, base=palette)
    chaos._write_synthetic_cifar(root / "test.bin", 36, rng, base=palette)
    cifar = [cifar_loader(str(root / name)) for name in ("train.bin", "test.bin")]

    def run_mnist(mesh=None, **kw):
        conf = pmnist.MnistRandomFFTConfig(num_ffts=2, block_size=512, lam=1e-2,
                                           mnist_image_size=64, num_classes=5,
                                           device="cpu", **kw)
        return pmnist.run(conf, *mnist, mesh=mesh)

    def run_cifar(mesh=None, **kw):
        conf = pcifar.RandomCifarConfig(num_filters=8, patch_size=6, patch_steps=4, lam=10.0,
                                        whitener_size=300, featurize_chunk=36,
                                        num_classes=4, device="cpu", **kw)
        return pcifar.run(conf, *cifar, mesh=mesh)

    runners = {"mnist": run_mnist, "cifar": run_cifar}
    return runners, {name: run()["test_predictions"] for name, run in runners.items()}


#: The mesh ``spec_mispredict`` runs under: eight CPU slots as (data 4,
#: model 2), so the head's mesh has spec candidates (the harness's
#: ``chaos._spec_mesh`` builds the JAX one).
SPEC_MESH = make_mesh(4, 2, devices=[torch.device("cpu")] * 8)


@pytest.fixture(scope="module")
def mesh_baselines(cases):
    """The fault-free mesh run of each workload: its predictions are the
    ``spec_mispredict`` oracle and its placement names the spec to force."""
    runners, _ = cases
    return {name: run(mesh=SPEC_MESH) for name, run in runners.items()}


class _OomFaults:
    """Replace ``block_mod.<name>`` by a wrapper whose first ``failures``
    calls raise ``torch.OutOfMemoryError``."""

    def __init__(self, name: str, failures: int):
        self.name, self.failures, self.calls = name, failures, 0

    def __enter__(self):
        self.real = getattr(block_mod, self.name)

        def faulty(*args, **kw):
            self.calls += 1
            if self.calls <= self.failures:
                raise torch.OutOfMemoryError("CUDA out of memory (injected)")
            return self.real(*args, **kw)

        setattr(block_mod, self.name, faulty)
        return self

    def __exit__(self, *exc):
        setattr(block_mod, self.name, self.real)


@contextlib.contextmanager
def _patched(obj, name, value):
    real = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, real)


class _Preempted(RuntimeError):
    """The injected preemption between two BCD blocks."""


def _forced_spec(placement: dict) -> list[str]:
    """The first spec candidate on the head's mesh that the search did not
    prune, as ``tests/chaos.py`` picks it for ``spec_mispredict``."""
    head = next(c for c in placement["candidates"] if c["name"] == placement["ranking"][0])
    return next([c["name"]] for c in placement["candidates"]
                if c.get("specs") and not c["pruned"] and c["mesh"] == head["mesh"])


def _faulted(kind: str, run, tmp_path, mesh_base=None):
    """One schedule of the family ``kind``; returns the run's results or
    raises its error."""
    fault = _schedule(kind)
    if kind == "spec_mispredict":
        before = counters.get("autoshard_stepdown")
        with _OomFaults("_execute_fused_bcd_mesh", fault.params["failures"]):
            res = run(mesh=SPEC_MESH, solve_plan=_forced_spec(mesh_base["placement"]))
        chaos._stepdown_oracle(res, counters.get("autoshard_stepdown") - before,
                               require_specs=True, require_mesh=True)
        return res
    if kind == "solver_oom":
        with _OomFaults("_fused_bcd_impl", fault.params["failures"]):
            return run()
    if kind == "oom_cascade":
        # Fused dies, then the stepwise tier's first block update: the ladder must walk
        # fused -> stepwise -> host_staged.
        with _OomFaults("_fused_bcd_impl", 1), _OomFaults("_bcd_block_solve", 1):
            return run()
    if kind == "plan_mispredict":
        before = counters.get("autoshard_stepdown")
        with _OomFaults("_fused_bcd_impl", fault.params["failures"]):
            res = run()
        chaos._stepdown_oracle(res, counters.get("autoshard_stepdown") - before)
        return res
    if kind == "preempt_resume":
        path = str(tmp_path / "bcd_state")
        write = block_mod.bcd_checkpoint_writer(path)
        calls = {"n": 0}

        def preempting(state):
            write(state)
            calls["n"] += 1
            if calls["n"] >= fault.params["preempt_after_blocks"]:
                raise _Preempted(f"preempted after block {state['block']}")

        with pytest.raises(_Preempted):
            run(solve_checkpoint=preempting)
        return run(solve_checkpoint=path, solve_resume=path)
    assert kind == "deadline"
    real = block_mod._fused_bcd_impl

    def hang(*args, **kw):
        time.sleep(600.0)  # interrupted by the deadline watchdog
        return real(*args, **kw)

    with contextlib.ExitStack() as stack:
        stack.enter_context(_patched(block_mod, "_fused_bcd_impl", hang))
        stack.enter_context(deadline(fault.params["seconds"], phase="solve"))
        return run()


@pytest.mark.parametrize("workload", ["mnist", "cifar"])
@pytest.mark.parametrize("kind", FAMILIES)
def test_faulted_run_is_equal_or_typed(kind, workload, cases, tmp_path, request):
    runners, baseline = cases
    mesh_base = None
    if kind == "spec_mispredict":
        mesh_base = request.getfixturevalue("mesh_baselines")[workload]
        baseline = {workload: mesh_base["test_predictions"]}
    before = counters.snapshot()
    t0 = time.monotonic()
    try:
        res = _faulted(kind, runners[workload], tmp_path, mesh_base)
    except DeadlineExceeded as e:
        outcome, counted = "typed_error", counters.get("deadline_exceeded") - before.get(
            "deadline_exceeded", 0)
        assert e.phase == "solve" and counted == 1
    else:
        outcome = ("completed_equal" if np.array_equal(res["test_predictions"], baseline[workload])
                   else "SILENT_WRONG_MODEL")
    assert outcome == chaos.expected_outcome(_schedule(kind)), outcome
    assert time.monotonic() - t0 < 60.0
    delta = {k: v - before.get(k, 0) for k, v in counters.snapshot().items()
             if v != before.get(k, 0)}
    if kind == "spec_mispredict":
        assert delta.get("autoshard_stepdown") == delta.get("solver_oom_retry") == 1, delta
        placement = res["placement"]
        assert placement["chosen"] == placement["ranking"][1] == "fused[mesh 4x2]"
        assert placement["ranking"][0] == _forced_spec(mesh_base["placement"])[0]
        assert res["fit_report"]["chosen_tier"] == "fused[mesh 4x2]"
    if kind in ("solver_oom", "oom_cascade", "plan_mispredict"):
        assert delta.get("solver_oom_retry") == (1 if kind != "oom_cascade" else 2), delta
        assert res["fit_report"]["chosen_tier"] == (
            "host_staged" if kind == "oom_cascade" else "stepwise")
        # plan=None searches, so every ranked plan that died is a counted
        # step-down of the searched ranking, as in the JAX package.
        assert delta.get("autoshard_stepdown") == delta["solver_oom_retry"], delta
        assert res["placement"]["chosen"] == res["fit_report"]["chosen_tier"]
    if kind == "preempt_resume":
        assert os.path.exists(str(tmp_path / "bcd_state.npz"))
        assert res["fit_report"]["chosen_tier"] == "stepwise[checkpoint]"
