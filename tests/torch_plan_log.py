"""A fresh, empty plan-outcome log for every port test module that fits, and
for each of its tests.

Fits search by default and log their outcomes
(``keystone_tpu_torch.core.autoshard``).  The conftest gives each test
process ONE log, which the JAX package's tests share, and the JAX package's
cross-program model fits on every row of it, whatever device wrote it; a
port test's rows would then calibrate the rankings of a JAX test that runs
later in the same process, and the JAX tests' rows the port's.  A port test
module that imports the solvers, the workloads or the lifecycle imports both
fixtures, which are then autouse for that module
(``tests/test_torch_autoshard.py`` checks that every such module does):

    from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401

The module's own fixtures that fit log to the module's file; each test logs
to its own file under ``tmp_path`` and reads no other test's outcomes; a
subprocess inherits the file.  The card test files run with
``--noconftest`` and import them too, so they never touch the host's
``~/.keystone_plans.jsonl``.  The environment is restored after each test
and after the module.  The log reads are cached per path, so a fresh path
needs no cache reset.

This module imports neither JAX nor the JAX package.
"""

import pytest

from keystone_tpu_torch.core import autoshard


@pytest.fixture(scope="module", autouse=True)
def hermetic_plan_log_module(tmp_path_factory):
    """Module-scoped fixtures run before any function-scoped one, so a
    module fixture that fits needs a log of the module's own."""
    with pytest.MonkeyPatch.context() as mp:
        path = str(tmp_path_factory.mktemp("plans") / "plans.jsonl")
        mp.setenv(autoshard.PLAN_LOG_ENV, path)
        yield path


@pytest.fixture(autouse=True)
def hermetic_plan_log(hermetic_plan_log_module, tmp_path, monkeypatch):
    path = str(tmp_path / "plans.jsonl")
    monkeypatch.setenv(autoshard.PLAN_LOG_ENV, path)
    return path
