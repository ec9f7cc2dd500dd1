"""The port's serving engine and batcher (``keystone_tpu_torch.core.serve``)
against ``keystone_tpu.core.serve`` on the CPU.

The toy chain is the reference tests' fusion-invariant ``max(x * w, b)``
(``tests/test_serve.py``), its weights drawn with numpy from a seed and
handed to both packages: one exactly rounded multiply and one max, so the
two packages' answers are bit-equal, and every bucket equals the eager
apply.  Bars: answers ``np.array_equal`` to the offline apply and to the
JAX engine's; ``ServeConfig`` parsing equal on the same environment; the
records carry the reference's keys.  Across packages, small RandomPatchCifar
and MnistRandomFFT fits saved by the JAX package are served by the port's
``load_engine`` with predictions equal to the JAX engine's; a JAX
VOCSIFTFisher bundle served by the port answers within 1e-4·max of the
port's offline apply (the served-batch bar of
``tests/test_torch_voc_sift_fisher.py``) and within 1e-2·max of the JAX
engine's scores (that file's bar for f32 Fisher scores, each chain against
f64)."""

import json
import os
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.core import pipeline as jpipe
from keystone_tpu.core import serve as jserve
from keystone_tpu.workloads import cifar_random_patch as jax_cifar
from keystone_tpu.workloads import mnist_random_fft as jax_mnist
from keystone_tpu.workloads import voc_sift_fisher as jax_voc
from keystone_tpu_torch.core import serve as kserve
from keystone_tpu_torch.core import trace
from keystone_tpu_torch.core.checkpoint import save_pipeline
from keystone_tpu_torch.core.pipeline import FunctionTransformer, Pipeline
from keystone_tpu_torch.core.resilience import counters
from keystone_tpu_torch.workloads import voc_sift_fisher as pt_voc

sys.path.insert(0, os.path.dirname(__file__))
from test_fisher_pipelines import write_voc_tar  # noqa: E402
from test_torch_cifar_random_patch import FLAGS as CIFAR_FLAGS  # noqa: E402
from test_torch_cifar_random_patch import _write_cifar  # noqa: E402
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401

pytestmark = pytest.mark.serve


def _toy_weights(rng, d=16):
    return (rng.normal(size=(d,)).astype(np.float32),
            rng.normal(size=(d,)).astype(np.float32))


def _toy_pipe(w, b):
    wt, bt = torch.from_numpy(w), torch.from_numpy(b)
    return FunctionTransformer(lambda x: torch.maximum(x * wt, bt), name="toy")


def _jax_toy_pipe(w, b):
    wj, bj = jnp.asarray(w), jnp.asarray(b)
    return jpipe.FunctionTransformer(lambda x: jnp.maximum(x * wj, bj), name="toy")


def _engine(w, b, buckets=(1, 2, 4), label="test", **cfg):
    cfg = kserve.ServeConfig(buckets=buckets, max_wait_ms=cfg.pop("max_wait_ms", 2.0), **cfg)
    return kserve.ServingEngine(
        _toy_pipe(w, b), np.zeros(16, np.float32), config=cfg, label=label, device="cpu"
    )


@pytest.fixture
def weights(rng):
    return _toy_weights(rng)


@pytest.fixture
def engine(weights):
    return _engine(*weights)


def _requests(rng, n):
    return rng.normal(size=(n, 16)).astype(np.float32)


# -- config -------------------------------------------------------------------


@pytest.mark.parametrize("env", [
    {kserve.BUCKETS_ENV: "8,2,2,32", kserve.MAX_WAIT_ENV: "7.5"},
    {kserve.BUCKETS_ENV: "1,4,16,64", kserve.MAX_BATCH_ENV: "8"},
    {kserve.BUCKETS_ENV: "1,4,16,64", kserve.MAX_BATCH_ENV: "128"},
    {kserve.EAGER_FLUSH_ENV: "0"},
    {},
])
def test_config_parses_as_the_reference(env, monkeypatch):
    for name in (kserve.BUCKETS_ENV, kserve.MAX_BATCH_ENV, kserve.MAX_WAIT_ENV,
                 kserve.EAGER_FLUSH_ENV):
        monkeypatch.delenv(name, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert kserve.ServeConfig.from_env().record() == jserve.ServeConfig.from_env().record()


@pytest.mark.parametrize("name,raw,match", [
    (kserve.BUCKETS_ENV, "1,banana", "comma-separated"),
    (kserve.BUCKETS_ENV, "0,4", ">= 1"),
    (kserve.MAX_WAIT_ENV, "-2", ">= 0"),
])
def test_invalid_env_is_typed_as_the_reference(name, raw, match, monkeypatch):
    monkeypatch.setenv(name, raw)
    for mod in (kserve, jserve):
        with pytest.raises(ValueError, match=match):
            mod.ServeConfig.from_env()


def test_bad_buckets_rejected():
    with pytest.raises(ValueError):
        kserve.ServeConfig(buckets=())
    with pytest.raises(ValueError):
        kserve.ServeConfig(buckets=(0, 2))


# -- the engine -----------------------------------------------------------------


class TestServingEngine:
    def test_infer_equals_offline_and_the_jax_engine_at_every_size(self, weights, rng):
        eng = _engine(*weights)
        jeng = jserve.ServingEngine(
            _jax_toy_pipe(*weights), np.zeros(16, np.float32),
            config=jserve.ServeConfig(buckets=(1, 2, 4), max_wait_ms=2.0), label="jax",
        )
        for n in (1, 2, 3, 4, 5, 7, 9, 12):
            reqs = _requests(rng, n)
            got = eng.infer(reqs)
            assert np.array_equal(got, eng.offline(reqs)), n
            assert np.array_equal(got, jeng.infer(reqs)), n

    def test_every_bucket_planned_and_recorded(self, engine):
        assert sorted(engine.memory_plans) == [1, 2, 4]
        rec = engine.record()
        json.dumps(rec)
        assert rec["live_buckets"] == [1, 2, 4]
        assert rec["parity_ok"] is True
        assert set(rec["memory_plans"]) == {"1", "2", "4"}
        assert all(p.analyzed for p in engine.memory_plans.values())
        # the reference's record keys, all present
        ref = {"label", "config", "example_shape", "example_dtype", "mesh", "live_buckets",
               "parity_ok", "parity", "warmup_seconds", "memory_plans", "drift"}
        assert ref <= set(rec)
        assert engine.graph_launches() == {} and engine.graph_kernels() == {}

    def test_cuda_without_a_card_raises(self, weights, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA card"):
            kserve.ServingEngine(_toy_pipe(*weights), np.zeros(16, np.float32))

    def test_mesh_is_refused_typed(self, weights):
        """A mesh that is not the port's single-process ``Mesh`` is refused
        typed (the JAX engine refuses one spanning processes)."""
        with pytest.raises(kserve.ServeError, match="mesh"):
            kserve.ServingEngine(_toy_pipe(*weights), np.zeros(16, np.float32),
                                 device="cpu", mesh=object())

    def test_warmup_drops_bucket_that_breaks_parity(self, weights, rng):
        eng = kserve.ServingEngine(
            _toy_pipe(*weights), np.zeros(16, np.float32),
            config=kserve.ServeConfig(buckets=(1, 2, 4), max_wait_ms=2.0),
            label="parity", warmup=False, device="cpu",
        )
        real = eng._exec[1]
        eng._exec[1] = lambda batch: real(batch) + torch.tensor(1e-7, dtype=torch.float32)
        before = counters.get("serve_bucket_parity_dropped")
        eng.warmup()
        assert eng.parity_ok is True
        assert eng.buckets() == (2, 4)
        assert counters.get("serve_bucket_parity_dropped") == before + 1
        reqs = _requests(rng, 1)
        assert np.array_equal(eng.infer(reqs), eng.offline(reqs))

    def test_all_buckets_failing_parity_reanchors_self_consistent(self, weights):
        eng = kserve.ServingEngine(
            _toy_pipe(*weights), np.zeros(16, np.float32),
            config=kserve.ServeConfig(buckets=(1, 2), max_wait_ms=2.0),
            label="noparity", warmup=False, device="cpu",
        )
        execs = dict(eng._exec)

        def skew(b):
            return lambda batch: execs[b](batch) + torch.tensor(2e-7, dtype=torch.float32)

        eng._exec[1] = skew(1)
        eng._exec[2] = skew(2)
        before = counters.get("serve_parity_unverified")
        eng.warmup()
        assert eng.parity_ok is False
        assert counters.get("serve_parity_unverified") == before + 1
        assert eng.buckets() == (1, 2)

    def test_runtime_oom_retires_bucket_and_reanswers(self, engine, rng):
        real = engine._execute
        state = {"n": 0}

        def failing(bucket, dev):
            if bucket == 4 and state["n"] < 1:
                state["n"] += 1
                raise torch.OutOfMemoryError("CUDA out of memory (injected)")
            return real(bucket, dev)

        engine._execute = failing
        before = counters.get("serve_burst_oom")
        reqs = _requests(rng, 6)
        try:
            out = engine.infer(reqs)
        finally:
            engine._execute = real
        assert np.array_equal(out, engine.offline(reqs))
        assert engine.buckets() == (1, 2)
        assert counters.get("serve_burst_oom") == before + 1

    def test_oom_on_last_bucket_is_typed(self, weights, rng):
        eng = _engine(*weights, buckets=(2,), max_wait_ms=1.0, label="solo")

        def oom(bucket, dev):
            raise torch.OutOfMemoryError("CUDA out of memory (injected)")

        eng._execute = oom
        with pytest.raises(kserve.ServingUnavailable):
            eng.infer(_requests(rng, 2))

    def test_output_drift_observed_when_numerics_on(self, engine, rng):
        from keystone_tpu_torch.core import numerics as knum

        baseline = knum.OutputSketch.for_outputs(engine.offline(_requests(rng, 64))).record()
        engine.arm_drift_baseline(baseline)
        try:
            with knum.monitored(True):
                engine.infer(_requests(rng, 40))
            assert engine.drift.record()["observed"] == 40
        finally:
            knum.unregister_drift(engine.label)


# -- the batcher ------------------------------------------------------------------


class TestServer:
    def test_concurrent_clients_bit_equal_in_order(self, engine, rng):
        reqs = _requests(rng, 40)
        offline = engine.offline(reqs)
        answers = [None] * len(reqs)
        errors = []

        def client(cid, stride=4):
            try:
                futs = [(i, server.submit(reqs[i])) for i in range(cid, len(reqs), stride)]
                for i, f in futs:
                    answers[i] = f.result(30.0)
            except BaseException as e:  # noqa: BLE001
                errors.append(e)

        with kserve.Server(engine) as server:
            ts = [threading.Thread(target=client, args=(c,)) for c in range(4)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(30.0)
            stats = server.stats
        assert not errors, errors
        assert np.array_equal(np.stack(answers), offline)
        assert stats.answered == len(reqs) and stats.batches >= 1
        assert server.join(5.0), "server threads leaked"

    def test_malformed_requests_typed_counted_never_poison(self, engine, rng):
        good = _requests(rng, 6)
        before = counters.get("serve_malformed_request")
        with kserve.Server(engine) as server:
            with pytest.raises(kserve.MalformedRequest, match="shape"):
                server.submit(np.zeros(7, np.float32))
            nan = good[0].copy()
            nan[3] = np.nan
            with pytest.raises(kserve.MalformedRequest, match="NaN"):
                server.submit(nan)
            with pytest.raises(kserve.MalformedRequest, match="castable"):
                server.submit(np.array(["x"] * 16, dtype=object))
            futs = [server.submit(r) for r in good]
            answers = np.stack([f.result(30.0) for f in futs])
            assert server.stats.malformed == 3
        assert counters.get("serve_malformed_request") == before + 3
        assert np.array_equal(answers, engine.offline(good))

    def test_burst_oom_degrades_never_wrong(self, engine, rng):
        real = engine._execute
        state = {"n": 0}

        def failing(bucket, dev):
            if bucket == 4 and state["n"] < 1:
                state["n"] += 1
                raise torch.OutOfMemoryError("CUDA out of memory (injected)")
            return real(bucket, dev)

        engine._execute = failing
        reqs = _requests(rng, 12)
        try:
            with kserve.Server(engine) as server:
                futs = [server.submit(r) for r in reqs]
                answers = np.stack([f.result(30.0) for f in futs])
        finally:
            engine._execute = real
        assert np.array_equal(answers, engine.offline(reqs))
        assert 4 not in engine.buckets()

    def test_deadline_flush_answers_partial_buckets(self, weights, rng):
        eng = _engine(*weights, max_wait_ms=20.0, eager_flush=False, label="ddl")
        req = _requests(rng, 1)[0]
        with kserve.Server(eng) as server:
            t0 = time.perf_counter()
            out = server.predict(req, timeout=30.0)
            dt = time.perf_counter() - t0
            assert server.stats.flush_deadline >= 1
            assert server.stats.flush_idle == 0
        assert np.array_equal(out, eng.offline(req[None])[0])
        assert dt < 5.0

    def test_close_answers_pending_typed_and_joins(self, engine, rng):
        real = engine._execute

        def slow(bucket, dev):
            time.sleep(0.2)
            return real(bucket, dev)

        engine._execute = slow
        reqs = _requests(rng, 12)
        try:
            server = kserve.Server(engine)
            futs = [server.submit(r) for r in reqs]
            server.close()
            assert server.join(10.0), "server threads leaked after close"
        finally:
            engine._execute = real
        resolved = 0
        for f in futs:
            try:
                f.result(5.0)
                resolved += 1
            except kserve.ServingUnavailable:
                pass
        assert resolved < len(futs)
        with pytest.raises(kserve.ServingUnavailable):
            server.submit(reqs[0])

    def test_future_timeout_is_typed(self):
        with pytest.raises(TimeoutError):
            kserve.ServeFuture().result(0.01)

    def test_close_racing_submit_resolves_every_future(self, engine, rng):
        real = engine._execute

        def slow(bucket, dev):
            time.sleep(0.05)
            return real(bucket, dev)

        engine._execute = slow
        try:
            for round_ in range(2):
                server = kserve.Server(engine)
                futs: list = []
                stop = threading.Event()

                def submitter():
                    for r in _requests(rng, 48):
                        if stop.is_set():
                            return
                        try:
                            futs.append(server.submit(r))
                        except kserve.ServingUnavailable:
                            return

                threads = [threading.Thread(target=submitter) for _ in range(2)]
                for t in threads:
                    t.start()
                time.sleep(0.02 * (round_ + 1))
                server.close()
                assert server.join(10.0)
                stop.set()
                for t in threads:
                    t.join(10.0)
                for f in futs:
                    try:
                        f.result(5.0)
                    except kserve.ServingUnavailable:
                        pass
                assert server.outstanding() == 0
                st = server.stats
                assert st.answered + st.failed == st.requests == len(futs)
        finally:
            engine._execute = real

    def test_drain_waits_for_all_outstanding(self, engine, rng):
        with kserve.Server(engine) as server:
            futs = [server.submit(r) for r in _requests(rng, 16)]
            assert server.drain(30.0)
            assert server.outstanding() == 0
            assert all(f.done() for f in futs)
            assert server.stats.answered == 16


# -- bench, spans, cold start ---------------------------------------------------


class TestServeBench:
    def test_record_has_the_reference_keys_and_equal_answers(self, weights, rng):
        reqs = _requests(rng, 32)
        rec = kserve.serve_bench(_engine(*weights), reqs, clients=3, depth=4)
        jeng = jserve.ServingEngine(
            _jax_toy_pipe(*weights), np.zeros(16, np.float32),
            config=jserve.ServeConfig(buckets=(1, 2, 4), max_wait_ms=2.0), label="jaxbench",
        )
        jrec = jserve.serve_bench(jeng, reqs, clients=3, depth=4)
        json.dumps(rec)
        assert set(jrec) <= set(rec)
        assert set(jrec["batcher"]) == set(rec["batcher"])
        assert set(jrec["phase_breakdown"]) <= set(rec["phase_breakdown"])
        assert rec["requests"] == 32
        assert rec["predictions_bit_identical"] is True
        assert rec["unbatched_bit_identical"] is True
        assert rec["qps"] > 0 and rec["unbatched_qps"] > 0
        assert rec["p99_latency_ms"] >= rec["p50_latency_ms"] > 0
        assert 0 < rec["batcher"]["mean_occupancy"] <= 1

    def test_request_spans_and_metrics_land(self, engine, rng, tmp_path):
        trace.reset()
        trace.enable(str(tmp_path / "serve.json"))
        try:
            with kserve.Server(engine) as server:
                for f in [server.submit(r) for r in _requests(rng, 8)]:
                    f.result(30.0)
        finally:
            trace.disable()
        evs = trace.events()
        trace.reset()
        req_spans = [e for e in evs if e.get("name") == "serve.request"]
        assert len(req_spans) == 8
        for sp in req_spans:
            assert {"bucket", "queue_wait_ms", "execute_ms", "d2h_ms", "latency_ms"} <= set(
                sp["args"])
        assert any(e.get("name") == "serve.execute" for e in evs)
        assert any(e.get("name") == "serve.h2d" for e in evs)
        hist = trace.metrics.snapshot()["histograms"]
        assert hist.get("serve_latency_ms", {}).get("count", 0) >= 8


def _fitted_servable(rng):
    from keystone_tpu_torch.ops.stats import StandardScaler
    from keystone_tpu_torch.ops.util import ClassLabelIndicatorsFromIntLabels, MaxClassifier
    from keystone_tpu_torch.solvers.block import BlockLeastSquaresEstimator

    x = torch.from_numpy(rng.normal(size=(48, 12)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 3, 48))
    scaler = StandardScaler().fit(x)
    model = BlockLeastSquaresEstimator(12, 1, 0.1).fit(
        scaler(x), ClassLabelIndicatorsFromIntLabels(3)(y)
    )
    return Pipeline([scaler, model, MaxClassifier()]), x.numpy()


def test_load_engine_measures_the_reference_cold_start(tmp_path, rng):
    pipe, x = _fitted_servable(rng)
    stem = str(tmp_path / "servable")
    save_pipeline(stem, pipe)
    engine, cold = kserve.load_engine(
        stem, np.empty(12, np.float32),
        config=kserve.ServeConfig(buckets=(1, 4), max_wait_ms=2.0), label="cold", device="cpu",
    )
    assert set(cold) == {"checkpoint_load_seconds", "compile_seconds", "warmup_seconds",
                         "cold_start_seconds"}
    assert cold["cold_start_seconds"] > 0
    reqs = x[:6]
    assert np.array_equal(engine.infer(reqs), pipe(torch.from_numpy(reqs)).numpy())
    with kserve.Server(engine) as server:
        assert server.predict(x[0], timeout=30.0) == pipe(torch.from_numpy(x[:1])).numpy()[0]


# -- across packages: JAX checkpoints served by the port --------------------------


def _jax_and_port_answers(stem, example_shape, requests, wrap_jax=None, wrap_port=None):
    cfg = dict(buckets=(1, 4), max_wait_ms=2.0)
    jeng, _ = jserve.load_engine(
        stem, jax.ShapeDtypeStruct(example_shape, np.float32),
        config=jserve.ServeConfig(**cfg), label="jax", wrap=wrap_jax,
    )
    peng, cold = kserve.load_engine(
        stem, np.empty(example_shape, np.float32),
        config=kserve.ServeConfig(**cfg), label="port", wrap=wrap_port, device="cpu",
    )
    with kserve.Server(peng) as server:
        served = np.stack([f.result(60.0) for f in [server.submit(r) for r in requests]])
    return jeng.infer(requests), peng.infer(requests), served, peng


def test_jax_cifar_fit_served_by_the_port(tmp_path):
    rng = np.random.default_rng(5)
    base = rng.uniform(40, 215, (4, 3))
    train, test = str(tmp_path / "train.bin"), str(tmp_path / "test.bin")
    _write_cifar(train, 200, rng, base)
    _write_cifar(test, 24, rng, base)
    jres = jax_cifar.main(["--trainLocation", train, "--testLocation", test, *CIFAR_FLAGS,
                           "--pipelineFile", str(tmp_path / "jax")])
    from keystone_tpu_torch.loaders.cifar import cifar_loader

    requests = np.asarray(cifar_loader(test).images[:12], np.float32)
    jans, pans, served, peng = _jax_and_port_answers(str(tmp_path / "jax"), (32, 32, 3), requests)
    assert np.array_equal(pans, jans)
    assert np.array_equal(served, jans)
    assert np.array_equal(jans, jres["test_predictions"][:12])


def test_jax_mnist_fit_served_by_the_port(tmp_path):
    rng = np.random.default_rng(7)
    centers = rng.normal(0, 1.0, (10, 784))

    def make(n):
        labels = rng.integers(1, 11, n)
        return np.column_stack([labels, centers[labels - 1] + 0.3 * rng.normal(size=(n, 784))])

    train, test = str(tmp_path / "train.csv"), str(tmp_path / "test.csv")
    np.savetxt(train, make(300), delimiter=",", fmt="%.5f")
    rows = make(12)
    np.savetxt(test, rows, delimiter=",", fmt="%.5f")
    jax_mnist.main(["--trainLocation", train, "--testLocation", test, "--numFFTs", "4",
                    "--blockSize", "512", "--lambda", "10", "--pipelineFile", str(tmp_path / "jax")])
    requests = np.loadtxt(test, delimiter=",")[:, 1:].astype(np.float32)
    jans, pans, served, _ = _jax_and_port_answers(str(tmp_path / "jax"), (784,), requests)
    assert np.array_equal(pans, jans)
    assert np.array_equal(served, jans)


def test_jax_voc_bundle_served_by_the_port(tmp_path):
    labels = str(tmp_path / "labels.csv")
    open(labels, "w").close()
    tar = str(tmp_path / "voc.tar")
    write_voc_tar(tar, labels, 12, np.random.default_rng(42))
    flags = ["--lambda", "0.05", "--descDim", "16", "--vocabSize", "8", "--numPcaSamples",
             "4000", "--numGmmSamples", "4000", "--scaleStep", "0"]
    jax_voc.main(["--trainLocation", tar, "--testLocation", tar, "--labelPath", labels, *flags,
                  "--pipelineFile", str(tmp_path / "jax")])
    from keystone_tpu.workloads.fv_common import bucket_by_shape
    from keystone_tpu_torch.loaders.image_loaders import voc_loader

    images = voc_loader(tar, labels).images
    _, (_, batch) = max(bucket_by_shape(images).items(), key=lambda kv: len(kv[1][0]))
    requests = np.asarray(batch, np.float32)[:5]
    jconf = jax_voc.SIFTFisherConfig(desc_dim=16, vocab_size=8, scale_step=0)
    pconf = pt_voc.SIFTFisherConfig(desc_dim=16, vocab_size=8, scale_step=0, device="cpu")
    jans, pans, served, peng = _jax_and_port_answers(
        str(tmp_path / "jax"), requests.shape[1:], requests,
        wrap_jax=lambda b: jax_voc.servable_pipeline(jconf, b),
        wrap_port=lambda b: pt_voc.servable_pipeline(pconf, b),
    )
    # Served against offline inside the port: the served-batch bar of
    # test_torch_voc_sift_fisher.py (the CPU's BLAS rounds by batch size).
    offline = peng.offline(requests)
    for got in (pans, served):
        np.testing.assert_allclose(got, offline, rtol=0, atol=1e-4 * np.abs(offline).max())
    # Across packages the assembled f32 scores are each within 1e-2·max of
    # an f64 evaluation (that file's docstring; 1.5e-4·max apart here).
    np.testing.assert_allclose(pans, jans, rtol=0, atol=1e-2 * np.abs(jans).max())
