"""The port's ``core.resilience`` against the JAX package's, on the CPU:
``retry`` (attempt counts and what it retries), ``FaultCounters`` (a
record is a ``fault`` trace instant; snapshot-and-reset is atomic), the
loaders' skip-and-count through the one fault ledger,
``assert_all_finite`` on tensors, arrays and fitted nodes, and
``deadline``.  Backoff is shortened through ``monkeypatch``."""

import threading
import time

import numpy as np
import pytest
import torch

from keystone_tpu.core import resilience as jres
from keystone_tpu_torch.core import resilience as pres
from keystone_tpu_torch.core import trace
from keystone_tpu_torch.loaders import image_loaders as pil
from keystone_tpu_torch.solvers.block import BlockLeastSquaresEstimator
from faults import flaky, make_image_tar, transient_faults
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401


@pytest.fixture(autouse=True)
def _fast_backoff(monkeypatch):
    monkeypatch.setenv("KEYSTONE_IO_BACKOFF", "0.001")


def _calls(mod, failures, exc=OSError, **kw):
    fn = flaky(lambda: "ok", failures=failures, exc=exc)
    try:
        out = mod.retry(fn, backoff=0.001, **kw)()
    except BaseException as e:  # noqa: BLE001 — the outcome is compared
        out = type(e).__name__
    return out, fn.state["calls"]


@pytest.mark.parametrize("failures,exc,kw", [
    (2, OSError, {"attempts": 3}),
    (5, OSError, {"attempts": 3}),
    (5, ValueError, {"attempts": 5}),
    (3, FileNotFoundError, {"attempts": 5}),
    (1, EOFError, {}),
])
def test_retry_matches_jax(failures, exc, kw):
    assert _calls(pres, failures, exc, **kw) == _calls(jres, failures, exc, **kw)


def test_retry_counts_io_retry_and_respects_budget():
    before = pres.counters.get("io_retry")
    assert _calls(pres, 2, attempts=3) == ("ok", 3)
    assert pres.counters.get("io_retry") - before == 2
    fn = flaky(lambda: "ok", failures=99)
    t0 = time.monotonic()
    with pytest.raises(OSError):
        pres.retry(fn, attempts=50, backoff=0.05, timeout=0.2)()
    assert time.monotonic() - t0 < 2.0 and fn.state["calls"] < 50


def test_fault_record_is_a_trace_instant(tmp_path):
    trace.disable()
    trace.reset()
    trace.enable(str(tmp_path / "t.json"))
    try:
        c = pres.FaultCounters()
        assert c.record("corrupt_image", "a.jpg") == 1
        assert c.record("corrupt_image", "b.jpg") == 2
        faults = [e for e in trace.events() if e.get("name") == "fault"]
        assert [f["args"]["total"] for f in faults] == [1, 2]
        assert faults[0]["args"] == {"kind": "corrupt_image", "total": 1, "detail": "a.jpg"}
        assert c.snapshot(reset=True) == {"corrupt_image": 2}
        assert c.counts() == {}
    finally:
        trace.disable()
        trace.reset()
    assert trace.metrics.snapshot()["faults"] == pres.counters.snapshot()


def test_loader_faults_counted_in_the_ledger(tmp_path):
    rng = np.random.default_rng(1)
    tar = str(tmp_path / "imgs.tar")
    make_image_tar(tar, 8, rng, corrupt=(0, 5))
    before = pres.counters.snapshot()
    for threads in (1, 4):
        assert len(list(pil._iter_tar_images(tar, num_threads=threads))) == 6
    assert pres.counters.get("corrupt_image") - before.get("corrupt_image", 0) == 4
    with transient_faults(pil.tarfile, "open", failures=2):
        assert len(list(pil._iter_tar_images(tar, num_threads=1))) == 6
    assert pres.counters.get("io_retry") - before.get("io_retry", 0) == 2
    with transient_faults(pil.tarfile, "open", failures=99):
        with pytest.raises(OSError):
            list(pil._iter_tar_images(tar, num_threads=1))


def test_assert_all_finite_on_tensors_arrays_and_fitted_nodes():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(64, 12, generator=gen)
    y = torch.nn.functional.one_hot(torch.arange(64) % 3, 3).float()
    model = BlockLeastSquaresEstimator(4, 1, 0.1).fit(x, y)
    assert pres.assert_all_finite(model, "clean") is model
    tree = {"w": np.ones(3, np.float32), "ints": np.array([1, 2]), "t": [torch.ones(2)]}
    assert pres.assert_all_finite(tree) is tree

    before = pres.counters.get("nonfinite_model")
    model.xs[1][0, 0] = float("nan")
    with pytest.raises(FloatingPointError, match="broken fit contains non-finite values in 1 leaf"):
        pres.assert_all_finite(model, "broken fit")
    assert pres.counters.get("nonfinite_model") - before == 1
    with pytest.raises(FloatingPointError):
        pres.assert_all_finite([np.array([1.0, np.inf])])
    # integer leaves are not checked, as in the JAX package
    assert pres.assert_all_finite([torch.tensor([1, 2])]) is not None
    jres.assert_all_finite([np.ones(2)])  # the reference accepts the same clean tree
    with pytest.raises(FloatingPointError):
        jres.assert_all_finite([np.array([1.0, np.inf])])


def test_numerics_guard_is_always_on(monkeypatch):
    monkeypatch.setenv("KEYSTONE_NUMERICS_GUARD", "0")
    assert pres.numerics_guard_enabled() is True
    assert jres.numerics_guard_enabled() is False


def test_deadline_interrupts_a_hang_and_counts():
    before = pres.counters.get("deadline_exceeded")
    t0 = time.monotonic()
    with pytest.raises(pres.DeadlineExceeded) as exc:
        with pres.deadline(0.2, phase="ingest"):
            time.sleep(30.0)
    assert time.monotonic() - t0 < 5.0
    assert exc.value.phase == "ingest" and exc.value.seconds == pytest.approx(0.2)
    assert pres.counters.get("deadline_exceeded") == before + 1
    with pres.deadline(30.0, phase="quick"):
        pass
    with pytest.raises(ValueError, match="positive"):
        with pres.deadline(0.0):
            pass


def test_deadline_nesting_and_off_main_thread():
    with pytest.raises(pres.DeadlineExceeded) as exc:
        with pres.deadline(0.3, phase="outer"):
            with pres.deadline(600.0, phase="inner"):
                time.sleep(30.0)
    assert exc.value.phase == "inner"
    assert exc.value.seconds == pytest.approx(0.3, abs=0.1)
    result = {}

    def work():
        try:
            with pres.deadline(0.05, phase="bg"):
                time.sleep(0.2)
            result["outcome"] = "no_error"
        except pres.DeadlineExceeded as e:
            result["outcome"] = e.phase

    t = threading.Thread(target=work)
    t.start()
    t.join(10.0)
    assert not t.is_alive() and result == {"outcome": "bg"}


def test_is_addr_in_use():
    import errno

    for mod in (pres, jres):
        assert mod.is_addr_in_use(OSError(errno.EADDRINUSE, "busy"))
        assert mod.is_addr_in_use(RuntimeError("bind: Address already in use"))
        assert not mod.is_addr_in_use(OSError(errno.ENOENT, "missing"))
