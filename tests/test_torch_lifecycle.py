"""The closed model lifecycle of the port (``keystone_tpu_torch.core.lifecycle``)
held to every bar of ``tests/test_lifecycle.py`` on the CPU: the warm refit
reads the featurized snapshot with zero featurizer calls and is
``torch.equal`` to the cold fit; the controller swaps only validated
candidates, debounces under cooldown, and forces a cold featurize pass the
moment the featurizer digest moves.

One case crosses packages: on the same seeded world, the engine the port's
controller swaps in answers within the block solver's cross-package bar
(rtol 1e-3, atol 1e-4·max, ``tests/test_torch_solver_ladder.py``) of the
engine the JAX package's controller swaps in."""

import io
import tarfile
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.core import frontend as jfrontend
from keystone_tpu.core import lifecycle as jlifecycle
from keystone_tpu.core import serve as jserve
from keystone_tpu.ops.stats import StandardScalerModel as JaxScaler
from keystone_tpu.solvers.block import BlockLeastSquaresEstimator as JaxBLS
from keystone_tpu_torch.core import frontend as kfrontend
from keystone_tpu_torch.core import lifecycle
from keystone_tpu_torch.core import numerics as knum
from keystone_tpu_torch.core import serve as kserve
from keystone_tpu_torch.core import telemetry
from keystone_tpu_torch.core.resilience import counters
from keystone_tpu_torch.ops.stats import StandardScalerModel
from keystone_tpu_torch.solvers.block import BlockLeastSquaresEstimator
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401

pytestmark = pytest.mark.serve


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _tiny_tar(path) -> str:
    """The snapshot key folds in the input tar's identity: the refit
    stream stand-in only needs to exist and be stable."""
    data = b"keystone refit stream stand-in"
    with tarfile.open(path, "w") as tf:
        info = tarfile.TarInfo("member_0000.bin")
        info.size = len(data)
        tf.addfile(info, io.BytesIO(data))
    return str(path)


def _world(seed=20260806, d=16, k=4, rows=128):
    """One linear world: requests x, truth ``(x - mean) @ t``."""
    rng = np.random.default_rng(seed)
    mean = rng.normal(size=(d,)).astype(np.float32)
    t = rng.normal(size=(d, k)).astype(np.float32)
    x = rng.normal(size=(rows, d)).astype(np.float32)
    feats = x - mean
    return {
        "rng": rng, "mean": mean, "t": t, "x": x,
        "feats": feats, "labels": feats @ t,
        "featurizer": StandardScalerModel(torch.from_numpy(mean), None),
    }


def _fit(feats, labels, checkpoint=None):
    est = BlockLeastSquaresEstimator(block_size=16, num_iter=1, lam=0.0)
    return est.fit(torch.as_tensor(feats), torch.as_tensor(labels), checkpoint=checkpoint)


class TestFeaturizedTrainingSet:
    def test_warm_refit_reuses_featurized_snapshot(self, tmp_path):
        """An unchanged featurizer streams features from the committed
        snapshot: ``compute`` never runs again, ``snapshot_stale`` stays 0,
        the warm pass is cheaper, and the model fit from the snapshot is
        ``torch.equal`` to the one fit from the live pass."""
        w = _world()
        tar = _tiny_tar(tmp_path / "stream.tar")
        root = str(tmp_path / "snaps")
        calls = {"n": 0}

        def compute():
            calls["n"] += 1
            time.sleep(0.1)  # stand-in for the real featurize pass
            return w["feats"], w["labels"]

        stale_before = counters.get("snapshot_stale")
        t0 = time.perf_counter()
        f1, l1, info1 = lifecycle.featurized_training_set(
            root, tar_path=tar, featurizer=w["featurizer"], compute=compute
        )
        cold_wall = time.perf_counter() - t0
        assert info1["source"] == "computed"
        assert calls["n"] == 1

        t0 = time.perf_counter()
        f2, l2, info2 = lifecycle.featurized_training_set(
            root, tar_path=tar, featurizer=w["featurizer"], compute=compute
        )
        warm_wall = time.perf_counter() - t0
        assert info2["source"] == "snapshot"
        assert info2["key"] == info1["key"]
        assert calls["n"] == 1  # zero featurizer recompute
        assert counters.get("snapshot_stale") - stale_before == 0
        assert not info2["stale"]
        assert warm_wall < cold_wall

        # Bit-equal data in, bit-equal model out: the warm (stepwise,
        # checkpoint=) fit matches the cold searched fit exactly.
        assert np.array_equal(f1, f2)
        assert np.array_equal(l1, l2)
        probe = torch.from_numpy(w["rng"].normal(size=(8, 16)).astype(np.float32))
        warm = _fit(f2, l2, checkpoint=str(tmp_path / "bcd"))
        cold = _fit(f1, l1)
        assert torch.equal(warm(probe), cold(probe))

    def test_changed_featurizer_moves_key_and_counts_stale(self, tmp_path):
        """A changed featurizer never silently reuses stale features: the
        digest moves the key, the old snapshot is STALE (counted), and the
        cold pass runs."""
        w = _world()
        tar = _tiny_tar(tmp_path / "stream.tar")
        root = str(tmp_path / "snaps")
        calls = {"n": 0}

        def compute():
            calls["n"] += 1
            return w["feats"], w["labels"]

        _, _, info1 = lifecycle.featurized_training_set(
            root, tar_path=tar, featurizer=w["featurizer"], compute=compute
        )
        moved = StandardScalerModel(torch.from_numpy(w["mean"] + 1.0), None)
        stale_before = counters.get("snapshot_stale")
        _, _, info2 = lifecycle.featurized_training_set(
            root, tar_path=tar, featurizer=moved, compute=compute
        )
        assert info2["digest"] != info1["digest"]
        assert info2["key"] != info1["key"]
        assert info2["source"] == "computed"
        assert info2["stale"]
        assert calls["n"] == 2
        assert counters.get("snapshot_stale") - stale_before == 1


def _deploy(tmp_path, *, featurizer=None, fetch=None, quality_margin=0.0,
            cooldown_s=0.0, clock=None, label="lifetest"):
    """One served deployment behind a router and its controller, on the
    CPU: the incumbent fit on the world's truth, a fresh-data fetch
    defaulting to the same world."""
    w = _world()
    pipe_inc = w["featurizer"].then(_fit(w["feats"], w["labels"]))
    cfg = kserve.ServeConfig(buckets=(1, 2, 4), max_wait_ms=2.0)
    engine = kserve.ServingEngine(
        pipe_inc, np.zeros(16, np.float32), config=cfg, label=f"{label}_inc", device="cpu"
    )
    router = kfrontend.ShapeRouter(
        label=f"{label}_router",
        config=kfrontend.RouterConfig(warm_threshold=1, retire_after_s=300.0),
    )
    router.add_engine(engine)
    hx = w["rng"].normal(size=(64, 16)).astype(np.float32)
    hy = (hx - w["mean"]) @ w["t"]

    def default_fetch(digest):
        return w["feats"], w["labels"]

    def quality(predict, x, y):
        return -float(np.mean((np.asarray(predict(x)) - y) ** 2))

    ctl = lifecycle.LifecycleController(
        router,
        workdir=str(tmp_path / f"{label}_wd"),
        featurizer=featurizer if featurizer is not None else w["featurizer"],
        fetch=fetch or default_fetch,
        estimator=lambda: BlockLeastSquaresEstimator(block_size=16, num_iter=1, lam=0.0),
        assemble=lambda model: w["featurizer"].then(model),
        holdout=lambda: (hx, hy),
        quality=quality,
        example=np.zeros(16, np.float32),
        label=label,
        serve_config=cfg,
        config=lifecycle.LifecycleConfig(cooldown_s=cooldown_s, quality_margin=quality_margin),
        clock=clock or time.monotonic,
    )
    return w, router, engine, ctl


class TestLifecycleController:
    def test_clean_cycle_swaps_and_rearms(self, tmp_path, rng):
        w, router, engine, ctl = _deploy(tmp_path, label="lc_swap")
        before = {k: counters.get(k) for k in ("lifecycle_refit", "drift_rearmed")}
        try:
            with ctl:
                rec = ctl.run_refit(reason="operator")
                assert rec["outcome"] == "swapped", rec
                assert rec["generation"] == 1
                assert not rec["cold_fit"]
                entry_label = router.engines()[(16,)]
                assert entry_label == rec["engine_label"]
                assert entry_label != engine.label
                new_engine = router.server_for((16,)).engine
                assert new_engine.device.type == "cpu"  # the incumbent's device
                reqs = rng.normal(size=(4, 16)).astype(np.float32)
                ans = np.stack([router.submit(r).result(30.0) for r in reqs])
                assert np.array_equal(ans, new_engine.offline(reqs))
                assert counters.get("lifecycle_refit") - before["lifecycle_refit"] == 1
                assert counters.get("drift_rearmed") - before["drift_rearmed"] == 1
                mon = knum.drift_monitors().get(entry_label)
                assert mon is not None and not mon["drifted"]
                doc = telemetry.statusz_snapshot()
                sect = doc["providers"]["lifecycle:lc_swap"]
                assert sect["state"] in lifecycle.STATES
                assert sect["generation"] == 1
                assert sect["last_cycle"]["outcome"] == "swapped"
        finally:
            router.close()

    def test_rejected_candidate_never_swapped(self, tmp_path):
        """A candidate refit over garbage labels loses the holdout gate, is
        counted ``refit_rejected``, and the routing table is untouched."""
        w = _world()
        noise = w["rng"].normal(size=w["labels"].shape).astype(np.float32) * 50.0
        _, router, engine, ctl = _deploy(
            tmp_path, fetch=lambda digest: (w["feats"], noise), label="lc_rej"
        )
        before = counters.get("refit_rejected")
        try:
            with ctl:
                rec = ctl.run_refit(reason="operator")
                assert rec["outcome"] == "rejected", rec
                assert rec["quality"]["candidate"] < rec["quality"]["incumbent"]
                assert counters.get("refit_rejected") - before == 1
                assert router.server_for((16,)).engine is engine
                assert router.stats.replaces == 0
        finally:
            router.close()

    def test_cooldown_suppresses_then_decays(self, tmp_path):
        """A trip inside the cooldown is a counted suppression, and the
        window decays on the injected clock."""
        clock = FakeClock()
        _, router, _, ctl = _deploy(tmp_path, cooldown_s=100.0, clock=clock, label="lc_cool")
        before = counters.get("refit_suppressed")
        try:
            with ctl:
                rec1 = ctl.run_refit(reason="operator")
                assert rec1["outcome"] == "swapped", rec1
                assert ctl.state == "COOLDOWN"
                rec2 = ctl.run_refit(reason="operator")
                assert rec2["outcome"] == "suppressed"
                assert rec2["why"] == "cooldown"
                assert counters.get("refit_suppressed") - before == 1
                assert ctl.generation == 1  # no cycle ran
                clock.advance(200.0)
                assert ctl.state == "IDLE"  # lazy decay
                rec3 = ctl.run_refit(reason="operator")
                assert rec3["outcome"] == "swapped"
                assert ctl.generation == 2
        finally:
            router.close()

    def test_changed_featurizer_counts_cold_fit(self, tmp_path):
        """A featurizer change between cycles moves the digest: the next
        refit is a COLD fit, counted ``refit_cold_fit``."""
        w = _world()
        cell = {"mean": w["mean"]}

        def provider():
            return StandardScalerModel(torch.from_numpy(cell["mean"]), None)

        def fetch(digest):
            feats = w["x"] - cell["mean"]
            return feats, feats @ w["t"]

        _, router, _, ctl = _deploy(
            tmp_path, featurizer=provider, fetch=fetch, quality_margin=1e-3, label="lc_cold",
        )
        before = counters.get("refit_cold_fit")
        try:
            with ctl:
                rec1 = ctl.run_refit(reason="operator")
                assert rec1["outcome"] == "swapped", rec1
                assert not rec1["cold_fit"]
                cell["mean"] = w["mean"] + 0.5  # the featurizer moves
                rec2 = ctl.run_refit(reason="operator")
                assert rec2["cold_fit"]
                assert counters.get("refit_cold_fit") - before == 1
        finally:
            router.close()

    def test_check_signals_sees_drift_counter(self, tmp_path):
        """The watcher's poll trips on a ``serve_output_drift`` delta
        exactly once."""
        _, router, _, ctl = _deploy(tmp_path, label="lc_sig")
        try:
            with ctl:
                assert ctl.check_signals() is None
                counters.record("serve_output_drift", "test: synthetic drift breach")
                assert ctl.check_signals() == "serve_output_drift"
                assert ctl.check_signals() is None  # re-based, no re-trip
                ctl.request_refit("operator")
                # with no watcher thread the cycle ran synchronously
                assert ctl._last_cycle is not None
        finally:
            router.close()

    def test_watcher_thread_runs_a_requested_cycle(self, tmp_path):
        """With the watcher started, ``request_refit`` returns None and the
        next poll runs the cycle."""
        _, router, _, ctl = _deploy(tmp_path, label="lc_watch")
        ctl.config.poll_interval_s = 0.01
        try:
            with ctl:
                ctl.start()
                assert ctl.request_refit("operator") is None
                deadline = time.monotonic() + 30.0
                while ctl._last_cycle is None and time.monotonic() < deadline:
                    time.sleep(0.01)
                assert ctl._last_cycle is not None
                assert ctl._last_cycle["outcome"] == "swapped", ctl._last_cycle
                assert ctl.record()["watching"]
            assert not ctl._watcher.is_alive()
        finally:
            router.close()

    def test_no_incumbent_refits_on_the_device_argument(self, tmp_path):
        """With nothing routed the refit runs on ``device=``; the default
        ``"cuda"`` raises without a card and the cycle degrades typed."""
        w = _world()
        router = kfrontend.ShapeRouter(label="lc_dev_router")
        common = dict(
            featurizer=w["featurizer"], fetch=lambda d: (w["feats"], w["labels"]),
            estimator=lambda: BlockLeastSquaresEstimator(16, 1, 0.0),
            assemble=lambda model: w["featurizer"].then(model),
            holdout=lambda: (w["x"][:8], w["labels"][:8]),
            quality=lambda predict, x, y: -float(np.mean((predict(x) - y) ** 2)),
            example=np.zeros(16, np.float32),
            serve_config=kserve.ServeConfig(buckets=(1, 2), max_wait_ms=2.0),
            config=lifecycle.LifecycleConfig(cooldown_s=0.0),
        )
        try:
            with lifecycle.LifecycleController(
                router, workdir=str(tmp_path / "cpu"), label="lc_dev_cpu", device="cpu", **common
            ) as ctl:
                rec = ctl.run_refit()
                assert rec["outcome"] == "swapped", rec
                assert router.server_for((16,)).engine.device.type == "cpu"
            if not torch.cuda.is_available():
                router2 = kfrontend.ShapeRouter(label="lc_dev_router2")
                try:
                    with lifecycle.LifecycleController(
                        router2, workdir=str(tmp_path / "cuda"), label="lc_dev_cuda", **common
                    ) as ctl:
                        rec = ctl.run_refit()
                        assert rec["outcome"] == "refit_failed" and rec["phase"] == "refit"
                        assert "no CUDA card" in rec["error"]
                        assert router2.engines() == {}
                finally:
                    router2.close()
        finally:
            router.close()


class TestDriftRearm:
    def test_rearm_resets_latch_and_window(self):
        """``DriftMonitor.rearm``: new baseline in, live window and latch
        out, counted ``drift_rearmed``."""
        rng = np.random.default_rng(7)
        base_a = knum.OutputSketch.for_outputs(
            rng.normal(size=(200, 4)).astype(np.float32)
        ).record()
        mon = knum.DriftMonitor("rearm_test_torch", base_a, tol=0.25)
        before = counters.get("drift_rearmed")
        try:
            shifted = rng.normal(size=(200, 4)).astype(np.float32) + 100.0
            mon.observe(shifted)
            assert mon.latched
            assert mon.breaches == 1
            base_b = knum.OutputSketch.for_outputs(shifted).record()
            mon.rearm(base_b)
            assert not mon.latched
            assert mon.live.observed == 0
            assert mon.last_divergence is None
            assert mon.breaches == 1  # lifetime ledger survives the re-arm
            assert counters.get("drift_rearmed") - before == 1
            mon.observe(rng.normal(size=(200, 4)).astype(np.float32) + 100.0)
            assert not mon.latched
        finally:
            knum.unregister_drift("rearm_test_torch")


def test_swapped_engine_matches_the_jax_controllers(tmp_path):
    """Both packages' controllers refit the same seeded world and swap; the
    two swapped engines answer the same requests within the block solver's
    cross-package bar."""
    w = _world()
    hx = w["rng"].normal(size=(64, 16)).astype(np.float32)
    hy = (hx - w["mean"]) @ w["t"]
    reqs = w["rng"].normal(size=(6, 16)).astype(np.float32)
    # A different incumbent world: the refit has something to fix.
    stale = w["feats"] @ (w["t"] * 0.5)

    def quality(predict, x, y):
        return -float(np.mean((np.asarray(predict(x)) - y) ** 2))

    def answers(router):
        return np.stack([np.asarray(router.submit(r).result(30.0)) for r in reqs])

    # The port.
    pscaler = w["featurizer"]
    pcfg = kserve.ServeConfig(buckets=(1, 2, 4), max_wait_ms=2.0)
    prouter = kfrontend.ShapeRouter(label="lc_x_torch")
    prouter.add_engine(kserve.ServingEngine(
        pscaler.then(_fit(w["feats"], stale)), np.zeros(16, np.float32), config=pcfg,
        label="lc_x_torch_inc", device="cpu"))
    # The JAX package.
    jscaler = JaxScaler(jnp.asarray(w["mean"]), None)

    def jfit(feats, labels, checkpoint=None):
        return JaxBLS(block_size=16, num_iter=1, lam=0.0).fit(
            jnp.asarray(feats), jnp.asarray(labels), checkpoint=checkpoint)

    jcfg = jserve.ServeConfig(buckets=(1, 2, 4), max_wait_ms=2.0)
    jrouter = jfrontend.ShapeRouter(label="lc_x_jax")
    jrouter.add_engine(jserve.ServingEngine(
        jscaler.then(jfit(w["feats"], stale)), np.zeros(16, np.float32), config=jcfg,
        label="lc_x_jax_inc"))
    try:
        with lifecycle.LifecycleController(
            prouter, workdir=str(tmp_path / "torch_wd"), featurizer=pscaler,
            fetch=lambda d: (w["feats"], w["labels"]),
            estimator=lambda: BlockLeastSquaresEstimator(16, 1, 0.0),
            assemble=lambda model: pscaler.then(model), holdout=lambda: (hx, hy),
            quality=quality, example=np.zeros(16, np.float32), label="lc_x_torch",
            serve_config=pcfg, config=lifecycle.LifecycleConfig(cooldown_s=0.0),
        ) as pctl, jlifecycle.LifecycleController(
            jrouter, workdir=str(tmp_path / "jax_wd"), featurizer=jscaler,
            fetch=lambda d: (w["feats"], w["labels"]),
            estimator=lambda: JaxBLS(block_size=16, num_iter=1, lam=0.0),
            assemble=lambda model: jscaler.then(model), holdout=lambda: (hx, hy),
            quality=quality, example=np.zeros(16, np.float32), label="lc_x_jax",
            serve_config=jcfg, config=jlifecycle.LifecycleConfig(cooldown_s=0.0),
        ) as jctl:
            prec, jrec = pctl.run_refit(), jctl.run_refit()
            assert prec["outcome"] == jrec["outcome"] == "swapped", (prec, jrec)
            got, want = answers(prouter), answers(jrouter)
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4 * np.abs(want).max())
        np.testing.assert_allclose(prec["quality"]["candidate"], jrec["quality"]["candidate"],
                                   rtol=1e-3, atol=1e-6)
    finally:
        prouter.close()
        jrouter.close()
