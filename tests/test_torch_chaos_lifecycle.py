"""The ``drift_refit`` family of the chaos harness (``tests/chaos.py``) on
the port's closed lifecycle (``keystone_tpu_torch.core.lifecycle``), with
the harness's fault parameters (``chaos.make_schedule``) and its
equal-or-typed oracle.

One deployment, the harness's legs in sequence: (0) a shifted request mix
trips the armed drift monitor and the controller sees the trip; (A) a refit
that runs out of memory fetching fresh features degrades typed and counted
(``refit_failed``) to the incumbent; (B) a candidate refit over garbage
labels is rejected by the holdout gate (``refit_rejected``), never swapped;
(C) a mid-swap kill degrades typed and counted to the incumbent; (D) the
clean cycle lands with requests in flight across the swap: counted
``lifecycle_refit``, a postmortem dumped, drift re-armed, zero dropped,
pre-swap answers equal to the incumbent's offline apply and post-swap
answers equal to an offline refit on the same data; (E) a trip inside the
fresh cooldown is a counted suppression.  Any breach raises
``chaos.ChaosOracleError``.  Then, as in the harness, the workload runs and
must complete with predictions equal to the fault-free run's.  The injected
out-of-memory error is ``torch.OutOfMemoryError``."""

import glob
import os
import time

import numpy as np
import pytest
import torch

import chaos
from keystone_tpu_torch.core import frontend as kfrontend
from keystone_tpu_torch.core import numerics as knum
from keystone_tpu_torch.core import serve as kserve
from keystone_tpu_torch.core import telemetry as ktelemetry
from keystone_tpu_torch.core.lifecycle import LifecycleConfig, LifecycleController
from keystone_tpu_torch.core.resilience import counters
from keystone_tpu_torch.loaders.csv_loader import LabeledData
from keystone_tpu_torch.ops.stats import StandardScalerModel
from keystone_tpu_torch.solvers.block import BlockLeastSquaresEstimator
from keystone_tpu_torch.workloads import mnist_random_fft as pmnist
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401

KIND = "drift_refit"
#: The family's schedule in the tier-1 seeds and in the full schedule.
SEEDS = (chaos.FAMILIES.index(KIND), chaos.FAMILIES.index(KIND) + len(chaos.FAMILIES))


@pytest.fixture(scope="module")
def mnist_case():
    """The harness's MNIST split at its settings, on the CPU, and the
    fault-free run's predictions."""
    train, test = chaos._mnist_case()
    split = [LabeledData(labels=s.labels, data=s.data) for s in (train, test)]

    def run():
        conf = pmnist.MnistRandomFFTConfig(num_ffts=2, block_size=512, lam=1e-2,
                                           mnist_image_size=64, num_classes=5, device="cpu")
        return pmnist.run(conf, *split)

    return run, run()["test_predictions"]


def _fit_model(feats, labels, checkpoint=None):
    est = BlockLeastSquaresEstimator(block_size=16, num_iter=1, lam=0.0)
    return est.fit(torch.as_tensor(feats), torch.as_tensor(labels), checkpoint=checkpoint)


def _drift_refit_phase(fault: chaos.Fault, tmpdir: str, seed: int) -> dict:
    """The harness's ``_drift_refit_phase`` on the port's modules.  Returns
    the landed cycle's record."""
    Oracle = chaos.ChaosOracleError
    rng = np.random.default_rng(seed)
    n_ref = int(fault.params["reference"])
    n_shift = int(fault.params["shifted"])
    scale = float(fault.params["shift_scale"])
    n_rows = int(fault.params["rows"])
    n_req = int(fault.params["requests"])
    hold = float(fault.params["hold_seconds"])

    # Two worlds: before the drift the truth is (x - mean0) @ T1, after the
    # mix shifts it is (x - mean0) @ T2.
    wrng = np.random.default_rng(chaos._DATA_SEED)
    mean0 = wrng.normal(size=(16,)).astype(np.float32)
    t1 = wrng.normal(size=(16, 4)).astype(np.float32)
    t2 = wrng.normal(size=(16, 4)).astype(np.float32)
    featurizer = StandardScalerModel(torch.from_numpy(mean0), None)
    shift = np.zeros(16, np.float32)
    shift[int(np.argmax(np.abs(t1).sum(axis=1)))] = scale

    xa = chaos._serve_requests(rng, n_rows)
    feats_a = xa - mean0
    pipe_inc = featurizer.then(_fit_model(feats_a, feats_a @ t1))
    cfg = kserve.ServeConfig(buckets=(1, 2, 4), max_wait_ms=2.0)
    engine_inc = kserve.ServingEngine(pipe_inc, np.zeros(16, np.float32), config=cfg,
                                      label=f"chaos_refit_inc_{seed}", device="cpu")
    ref = chaos._serve_requests(rng, n_ref)
    baseline = knum.OutputSketch.for_outputs(engine_inc.offline(ref)).record()

    xb = chaos._serve_requests(rng, n_rows) + shift
    feats_b = xb - mean0
    labels_b = feats_b @ t2
    labels_noise = rng.normal(size=labels_b.shape).astype(np.float32) * 50.0
    hx = chaos._serve_requests(rng, 64) + shift
    hy = (hx - mean0) @ t2
    shifted = chaos._serve_requests(rng, n_shift) + shift
    reqs_mid = chaos._serve_requests(rng, n_req) + shift
    reqs_post = chaos._serve_requests(rng, n_req) + shift

    # The OFFLINE refit oracle on the same fresh data.
    pipe_offline = featurizer.then(_fit_model(feats_b, labels_b))
    offline_refit = pipe_offline(torch.from_numpy(reqs_post)).numpy()

    mode = {"fetch": "good"}

    def fetch(digest):
        if mode["fetch"] == "oom":
            raise torch.OutOfMemoryError("CUDA out of memory (injected)")
        if mode["fetch"] == "noise":
            return feats_b, labels_noise
        return feats_b, labels_b

    def quality(predict, x, y):
        return -float(np.mean((np.asarray(predict(x)) - y) ** 2))

    pm_dir = os.path.join(tmpdir, f"chaos_refit_{seed}_pm")
    with ktelemetry._pm_lock:
        ktelemetry._pm_counts.pop("serve_output_drift", None)
        ktelemetry._pm_counts.pop("lifecycle_refit", None)
    before = {k: counters.get(k) for k in (
        "serve_output_drift", "refit_failed", "refit_rejected", "lifecycle_refit",
        "drift_rearmed", "refit_suppressed")}

    def delta(kind):
        return counters.get(kind) - before[kind]

    router = kfrontend.ShapeRouter(
        label=f"chaos_refit_{seed}",
        config=kfrontend.RouterConfig(warm_threshold=1, retire_after_s=300.0),
    )
    saved_pm = os.environ.get(ktelemetry.POSTMORTEM_DIR_ENV)
    os.environ[ktelemetry.POSTMORTEM_DIR_ENV] = pm_dir
    ctl = None
    try:
        router.add_engine(engine_inc)
        ctl = LifecycleController(
            router,
            workdir=os.path.join(tmpdir, f"chaos_refit_{seed}_wd"),
            featurizer=featurizer,
            fetch=fetch,
            estimator=lambda: BlockLeastSquaresEstimator(block_size=16, num_iter=1, lam=0.0),
            assemble=lambda model: featurizer.then(model),
            holdout=lambda: (hx, hy),
            quality=quality,
            example=np.zeros(16, np.float32),
            label=f"chaos_refit_{seed}",
            serve_config=cfg,
            config=LifecycleConfig(cooldown_s=0.0, poll_interval_s=0.05),
        )
        with knum.monitored(True):
            engine_inc.arm_drift_baseline(baseline)
            # -- leg 0: the shifted mix trips the armed monitor ---------------
            futs = [router.submit(r) for r in shifted]
            mon = np.stack([np.asarray(f.result(30.0)) for f in futs])
            if not np.array_equal(mon, engine_inc.offline(shifted)):
                raise Oracle("served answers under drift detection differ from the "
                             "incumbent's offline apply")
            if delta("serve_output_drift") < 1:
                raise Oracle("shifted request mix produced no counted serve_output_drift")
            reason = ctl.check_signals()
            if reason != "serve_output_drift":
                raise Oracle(f"the lifecycle watcher did not see the drift trip ({reason!r})")

            def incumbent_still_serving(leg):
                table = router.engines()
                if table.get((16,)) != engine_inc.label:
                    raise Oracle(f"{leg}: the failed cycle touched the routing table "
                                 f"({table}) — a half-swapped model is serving")
                probe = chaos._serve_requests(rng, 3) + shift
                got = np.stack([np.asarray(f.result(30.0))
                                for f in [router.submit(r) for r in probe]])
                if not np.array_equal(got, engine_inc.offline(probe)):
                    raise Oracle(f"{leg}: post-fault answers differ from the incumbent's "
                                 "offline apply — silent wrong answers")

            # -- leg A: refit OOM degrades typed + counted --------------------
            mode["fetch"] = "oom"
            rec = ctl.run_refit(reason=reason)
            if rec["outcome"] != "refit_failed" or delta("refit_failed") < 1:
                raise Oracle(f"injected refit OOM was not a counted typed degradation: {rec}")
            incumbent_still_serving("refit OOM")

            # -- leg B: a WORSE candidate is rejected, never swapped ----------
            mode["fetch"] = "noise"
            rec = ctl.run_refit(reason="operator")
            if rec["outcome"] != "rejected" or delta("refit_rejected") < 1:
                raise Oracle(f"a candidate worse than the incumbent was not rejected: {rec}")
            incumbent_still_serving("validation rejection")

            # -- leg C: a mid-swap kill degrades typed + counted --------------
            mode["fetch"] = "good"
            real_replace = router.replace_engine
            failed_before = delta("refit_failed")
            try:
                def killed_replace(engine, **kw):
                    raise kserve.ServingUnavailable("injected mid-swap kill")

                router.replace_engine = killed_replace
                rec = ctl.run_refit(reason="operator")
            finally:
                router.replace_engine = real_replace
            if (rec["outcome"] != "refit_failed" or rec.get("phase") != "swap"
                    or delta("refit_failed") <= failed_before):
                raise Oracle(f"a mid-swap kill was not a counted typed degradation: {rec}")
            incumbent_still_serving("mid-swap kill")

            # -- leg D: the clean cycle lands, requests in flight -------------
            ctl.config.cooldown_s = 300.0  # leg E exercises the storm guard
            inflight_mid = []
            real_execute = engine_inc._execute

            def slow_execute(bucket, dev_batch):
                time.sleep(hold)  # the swap straddles live requests
                return real_execute(bucket, dev_batch)

            def replace_with_traffic(engine, **kw):
                inflight_mid.extend(router.submit(r) for r in reqs_mid)
                return real_replace(engine, **kw)

            try:
                engine_inc._execute = slow_execute
                router.replace_engine = replace_with_traffic
                landed = ctl.run_refit(reason=reason)
            finally:
                engine_inc._execute = real_execute
                router.replace_engine = real_replace
            if landed["outcome"] != "swapped" or delta("lifecycle_refit") < 1:
                raise Oracle(f"the clean drift->refit->swap cycle did not land: {landed}")
            if delta("drift_rearmed") < 1:
                raise Oracle("the swap landed but the drift monitor was not re-armed")
            dropped, mid_answers = 0, []
            for f in inflight_mid:
                try:
                    mid_answers.append(np.asarray(f.result(60.0)))
                except Exception:  # noqa: BLE001 — counted as a drop
                    dropped += 1
            if dropped:
                raise Oracle(f"{dropped} request(s) in flight across the hot-swap dropped")
            if not np.array_equal(np.stack(mid_answers), engine_inc.offline(reqs_mid)):
                raise Oracle("in-flight answers across the swap differ from the incumbent's")
            if router.server_for((16,)).engine is engine_inc:
                raise Oracle("the swap left the incumbent routed")
            post = np.stack([np.asarray(f.result(30.0))
                             for f in [router.submit(r) for r in reqs_post]])
            if not np.array_equal(post, offline_refit):
                raise Oracle("post-swap answers differ from the offline refit")
            if not glob.glob(os.path.join(pm_dir, "postmortem_lifecycle_refit_*.json")):
                raise Oracle("lifecycle_refit was counted but no postmortem was dumped")

            # -- leg E: the cooldown storm guard ------------------------------
            rec = ctl.run_refit(reason="operator")
            if rec["outcome"] != "suppressed" or delta("refit_suppressed") < 1:
                raise Oracle(f"a trip inside the cooldown was not a counted suppression: {rec}")
        return {**landed, "requests_in_flight": len(inflight_mid)}
    finally:
        if ctl is not None:
            ctl.close()
        router.close()
        if saved_pm is None:
            os.environ.pop(ktelemetry.POSTMORTEM_DIR_ENV, None)
        else:
            os.environ[ktelemetry.POSTMORTEM_DIR_ENV] = saved_pm
        knum.reset_state()


@pytest.mark.parametrize("seed", SEEDS)
def test_drift_refit_is_equal_or_typed(seed, mnist_case, tmp_path):
    fault = chaos.make_schedule(seed)
    assert fault.kind == KIND
    run, baseline = mnist_case
    t0 = time.monotonic()
    landed = _drift_refit_phase(fault, str(tmp_path), seed)
    assert landed["outcome"] == "swapped" and landed["requests_in_flight"] == int(
        fault.params["requests"])
    assert not landed["cold_fit"]
    outcome = ("completed_equal" if np.array_equal(run()["test_predictions"], baseline)
               else "SILENT_WRONG_MODEL")
    assert outcome == chaos.expected_outcome(fault), outcome
    assert time.monotonic() - t0 < 60.0
