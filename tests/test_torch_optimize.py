"""The cost-based optimizer of the port (``keystone_tpu_torch.core.optimize``,
the pipeline profiles, reuse tracking and the memoizing ``Cacher`` of
``core.pipeline``, ``core.memory.plan_cache_bytes`` and the live
``StreamConfig`` of ``core.ingest``), case for case against
``tests/test_optimize.py``, and held against the JAX package on the CPU:
the same candidate rows give JSON-equal decision tables, each package reads
the other's ``PipelineProfile``, and ``--autoCache`` on the Cifar, MNIST and
VOC CLIs gives the predictions of the run without it and the JAX run's
errors.  The quiet-stream autotuner case runs through the tuner's ``_now``
seam instead of wall time, and the ``autotune_thrash`` chaos family of
``tests/chaos.py`` runs on the port's stream."""

import io
import json
import tarfile
import time
import types

import numpy as np
import pytest
import torch

import chaos
import faults
from keystone_tpu.core import optimize as joptimize
from keystone_tpu.core import pipeline as jpipeline
from keystone_tpu.workloads import cifar_random_patch as jax_cifar
from keystone_tpu.workloads import mnist_random_fft as jax_mnist
from keystone_tpu.workloads import voc_sift_fisher as jax_voc
from keystone_tpu_torch.core import ingest, optimize, trace
from keystone_tpu_torch.core import memory as kmem
from keystone_tpu_torch.core import pipeline as ppipeline
from keystone_tpu_torch.core.pipeline import (
    Cacher,
    Estimator,
    FunctionTransformer,
    Pipeline,
    PipelineProfile,
    track_reuse,
)
from keystone_tpu_torch.core.resilience import counters
from keystone_tpu_torch.loaders import image_loaders
from keystone_tpu_torch.workloads import cifar_random_patch as pt_cifar
from keystone_tpu_torch.workloads import mnist_random_fft as pt_mnist
from keystone_tpu_torch.workloads import voc_sift_fisher as pt_voc
from keystone_tpu_torch.workloads.fv_common import scatter_features_streaming
from test_fisher_pipelines import write_voc_tar
from test_stream_workloads import _write_cifar_tar
from test_torch_cifar_random_patch import FLAGS as CIFAR_FLAGS
from test_torch_cifar_random_patch import _write_cifar
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401


def cand(name, seconds, nbytes, reuse, index=0, mod=optimize):
    return mod.CacheCandidate(
        index=index, name=name, seconds=seconds, output_bytes=nbytes, reuse=reuse,
    )


@pytest.fixture
def no_budget(monkeypatch):
    monkeypatch.delenv(kmem.HBM_BUDGET_ENV, raising=False)


# -- decision table on synthetic profiles -------------------------------------


class TestPlanCaches:
    def test_reuse_one_never_cached(self, no_budget):
        plan = optimize.plan_caches([cand("expensive", 100.0, 1024, reuse=1)])
        d = plan.decisions[0]
        assert not d.cached
        assert "reuse" in d.reason
        assert plan.cached_bytes == 0

    def test_cache_no_cache_boundary(self, no_budget):
        gib = 2**30
        plan = optimize.plan_caches(
            [
                cand("worth_it", seconds=2.0, nbytes=gib, reuse=2, index=0),
                cand("not_worth_it", seconds=0.5, nbytes=gib, reuse=2, index=1),
            ],
            gbps=1.0,
        )
        worth, not_worth = plan.decisions
        assert worth.cached and worth.win_seconds == pytest.approx(2.0)
        assert not not_worth.cached
        assert "amortized" in not_worth.reason

    def test_budget_denied_drops_cheapest_win_first(self, monkeypatch):
        monkeypatch.setenv(kmem.HBM_BUDGET_ENV, str(3 * 2**20))
        mb = 2**20
        plan = optimize.plan_caches(
            [
                cand("small_win", seconds=10.0, nbytes=mb, reuse=2, index=0),
                cand("big_win", seconds=100.0, nbytes=mb, reuse=2, index=1),
            ],
            gbps=1.0,
        )
        by_name = {d.name: d for d in plan.decisions}
        assert by_name["big_win"].cached
        assert not by_name["small_win"].cached
        assert plan.dropped == ["small_win"]
        assert plan.denials == ["small_win"]
        assert plan.cached_bytes == mb

    def test_oversized_win_does_not_abandon_smaller_fits(self, monkeypatch):
        monkeypatch.setenv(kmem.HBM_BUDGET_ENV, str(4 * 2**20))
        plan = optimize.plan_caches(
            [
                cand("small_fits", seconds=10.0, nbytes=2**20, reuse=2, index=0),
                cand("huge_win", seconds=1000.0, nbytes=2**30, reuse=2, index=1),
            ],
            gbps=1000.0,
        )
        by_name = {d.name: d for d in plan.decisions}
        assert not by_name["huge_win"].cached
        assert by_name["small_fits"].cached
        assert plan.dropped == ["huge_win"]
        assert plan.cached_bytes == 2**20

    def test_budget_denial_is_counted(self, monkeypatch):
        monkeypatch.setenv(kmem.HBM_BUDGET_ENV, "1K")
        before = counters.get("cache_admission_denied")
        plan = optimize.plan_caches([cand("x", 100.0, 2**20, reuse=3)])
        assert not plan.decisions[0].cached
        assert counters.get("cache_admission_denied") == before + 1

    def test_no_budget_admits_eligible(self, no_budget):
        plan = optimize.plan_caches([cand("x", 100.0, 2**20, reuse=3)])
        assert plan.decisions[0].cached
        assert plan.cached_bytes == 2**20

    def test_reuse_scales_the_win(self, no_budget):
        p2 = optimize.plan_caches([cand("x", 1.0, 0, reuse=2)])
        p3 = optimize.plan_caches([cand("x", 1.0, 0, reuse=3)])
        assert p3.decisions[0].win_seconds == pytest.approx(2 * p2.decisions[0].win_seconds)

    def test_to_json_round_trips(self, no_budget):
        plan = optimize.plan_caches(
            [cand("a", 5.0, 1024, reuse=2), cand("b", 0.0, 9, reuse=1)],
            dataset_rows=1000,
            sample_rows=10,
        )
        doc = json.loads(plan.to_json())
        assert doc["cached"] == ["a"]
        assert doc["dataset_rows"] == 1000
        assert len(doc["decisions"]) == 2
        assert all("reason" in d for d in doc["decisions"])

    def test_a_mesh_waits_for_distribution(self, no_budget):
        """A mesh is planned for, not refused: a row-sharded cache charges
        each data slot its share, so 4 data slots admit what one device's
        budget denies (``tests/test_torch_cacher_mesh.py`` holds the table
        to the JAX package's)."""
        from keystone_tpu_torch.parallel.mesh import make_mesh

        rows = [cand("x", 100.0, 4 * 2**20, reuse=2)]
        budget = 4 * 2**20  # half of it at the default headroom
        assert optimize.plan_caches(rows, budget=budget).dropped == ["x"]
        mesh = make_mesh(4, 2, devices=[torch.device("cpu")] * 8)
        plan = optimize.plan_caches(rows, budget=budget, mesh=mesh)
        assert [d.name for d in plan.cached()] == ["x"]
        assert "per-chip cached 1.00MB" in plan.decisions[0].reason


ROWS = {
    "boundary": ([("worth_it", 2.0, 2**30, 2), ("not_worth_it", 0.5, 2**30, 2)], None, 1.0),
    "budget_drop": ([("small_win", 10.0, 2**20, 2), ("big_win", 100.0, 2**20, 2)],
                    str(3 * 2**20), 1.0),
    "knapsack": ([("small_fits", 10.0, 2**20, 2), ("huge_win", 1000.0, 2**30, 2)],
                 str(4 * 2**20), 1000.0),
    "mixed": ([("a", 5.0, 1024, 2), ("b", 0.0, 9, 1), ("c", 3.0, 5 * 2**20, 4),
               ("d", 1e-6, 2**20, 3)], "16M", None),
    "denied": ([("x", 100.0, 2**20, 3)], "1K", None),
}


@pytest.mark.parametrize("case", sorted(ROWS))
def test_decision_tables_equal_jax(case, monkeypatch):
    """The same candidate rows under the same budget give JSON-equal
    decision tables in both packages."""
    rows, budget, gbps = ROWS[case]
    if budget is None:
        monkeypatch.delenv(kmem.HBM_BUDGET_ENV, raising=False)
    else:
        monkeypatch.setenv(kmem.HBM_BUDGET_ENV, budget)
    plans = [
        mod.plan_caches(
            [cand(n, s, b, r, index=i, mod=mod) for i, (n, s, b, r) in enumerate(rows)],
            gbps=gbps, dataset_rows=100, sample_rows=10,
        )
        for mod in (optimize, joptimize)
    ]
    assert json.loads(plans[0].to_json()) == json.loads(plans[1].to_json())
    assert plans[0].summary() == plans[1].summary()


def test_pipeline_profile_to_json_round_trips():
    pipe = Pipeline([
        FunctionTransformer(lambda x: x * 2, name="double"),
        FunctionTransformer(lambda x: x + 1, name="inc"),
    ])
    prof = pipe.profile(torch.ones((4, 3), dtype=torch.float32))
    back = PipelineProfile.from_json(prof.to_json())
    assert [n.name for n in back.nodes] == ["double", "inc"]
    assert back.nodes[0].output_bytes == prof.nodes[0].output_bytes == 48
    assert back.input_bytes == prof.input_bytes
    assert json.loads(prof.to_json())["nodes"][1]["name"] == "inc"
    np.testing.assert_array_equal(prof.output.numpy(), np.full((4, 3), 3.0, np.float32))


def test_profiles_cross_read_between_packages():
    """Each package reads the other's profile JSON, node for node."""
    import jax.numpy as jnp

    def nodes(mod, wrap):
        return mod.Pipeline([
            mod.FunctionTransformer(lambda x: x * 2, name="double"),
            mod.FunctionTransformer(lambda x: [x, x[:1]], name="split"),
        ]).profile(wrap(np.ones((4, 3), np.float32)))

    port = nodes(ppipeline, torch.from_numpy)
    jax_prof = nodes(jpipeline, jnp.asarray)
    for doc, reader in ((port.to_json(), jpipeline.PipelineProfile),
                        (jax_prof.to_json(), PipelineProfile)):
        back = reader.from_json(doc)
        assert [(n.index, n.name, n.output_bytes, n.dtype, n.shape, n.leaves)
                for n in back.nodes] == [
            (0, "double", 48, "float32", (4, 3), 1), (1, "split", 60, None, None, 2)]
    assert port.input_bytes == jax_prof.input_bytes == 48


def test_profile_span_and_sync_on_the_card_path(monkeypatch, tmp_path):
    """Each node is a ``node:<label>`` span under ``pipeline.profile``, and
    ``sync=True`` waits for the card after each node (here counted)."""
    synced = []
    monkeypatch.setattr(ppipeline, "_synchronize", lambda out: synced.append(out))
    trace.reset()
    trace.enable(str(tmp_path / "profile.json"))
    try:
        Pipeline([FunctionTransformer(lambda x: x + 1, name="inc")]).profile(torch.zeros(2))
        names = [e["name"] for e in trace.events()]
    finally:
        trace.disable()
        trace.reset()
    assert "pipeline.profile" in names and "node:inc" in names
    assert len(synced) == 1


# -- reuse tracking and the memoizing Cacher ----------------------------------


class _MeanCenter(Estimator):
    def fit(self, data):
        m = float(torch.as_tensor(data).mean())
        return FunctionTransformer(lambda x, m=m: x - m, name="center")


def _counting_node(calls, name="expensive"):
    def fn(x):
        calls[name] = calls.get(name, 0) + 1
        return x * 2.0

    return FunctionTransformer(fn, name=name)


class TestReuseAndMemo:
    def test_track_reuse_counts_chained_fit_pattern(self):
        calls = {}
        node = _counting_node(calls)
        chain = node.then_estimator(_MeanCenter())
        x = torch.ones((8, 4))
        with track_reuse() as counts:
            fitted = chain.fit(x)
            fitted(x)
        assert counts[id(node)] == 2

    def test_measure_chain_reuse(self):
        calls = {}
        chain = _counting_node(calls).then_estimator(_MeanCenter())
        assert optimize.measure_chain_reuse(chain, torch.ones((4, 2))) == {0: 2}

    def test_memoizing_cacher_saves_the_recompute(self):
        calls = {}
        pipe = Pipeline([
            _counting_node(calls),
            Cacher(name="auto", memoize=True),
            FunctionTransformer(lambda x: x + 1.0, name="inc"),
        ])
        x = torch.ones((4, 2))
        out1 = pipe(x)
        out2 = pipe(x)
        assert calls["expensive"] == 1
        assert torch.equal(out1, out2)

    def test_memo_is_keyed_on_input_identity(self):
        calls = {}
        pipe = Pipeline([_counting_node(calls), Cacher(name="auto", memoize=True)])
        a = torch.ones((4, 2))
        b = torch.ones((4, 2))
        out_a = pipe(a)
        out_b = pipe(b)
        assert calls["expensive"] == 2
        assert torch.equal(out_a, out_b)
        pipe(a)
        assert calls["expensive"] == 2

    def test_clear_memo_releases_the_entry(self):
        calls = {}
        pipe = Pipeline([_counting_node(calls), Cacher(name="auto", memoize=True)])
        x = torch.ones((2, 2))
        pipe(x)
        optimize.release_caches(pipe)
        pipe(x)
        assert calls["expensive"] == 2

    def test_memoizing_cacher_is_inert_under_capture(self, monkeypatch):
        """While a CUDA graph is captured the memo neither replays nor
        stores, and the Cacher is the identity (the JAX twin: under jit)."""
        calls = {}
        cacher = Cacher(name="auto", memoize=True)
        pipe = Pipeline([_counting_node(calls), cacher])
        monkeypatch.setattr(ppipeline, "_capturing", lambda: True)
        x = torch.ones((2, 2))
        assert torch.equal(pipe(x), torch.full((2, 2), 2.0))
        pipe(x)
        assert calls["expensive"] == 2
        assert getattr(cacher, "_memo", None) is None

    def test_non_memoizing_cacher_unchanged(self):
        pipe = Pipeline([FunctionTransformer(lambda x: x + 1, name="inc"), Cacher()])
        x = torch.ones((2, 2))
        assert torch.equal(pipe(x), torch.full((2, 2), 2.0))
        assert pipe._memo_cachers == ()


def test_cacher_sharding_path():
    """The counterpart of ``tests/test_pipeline_core.py``'s Cacher case: a
    ``torch.device`` sharding commits the value there, downstream nodes see
    it, a capture leaves it alone, and anything but a device or a mesh
    layout (``tests/test_torch_cacher_mesh.py``) raises."""
    x = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    cached = Cacher(name="feats", sharding=torch.device("cpu"))(x)
    assert cached.device == torch.device("cpu")
    assert torch.equal(cached, x)
    assert torch.equal(Cacher(sharding="cpu")(x.numpy()), x)
    pipe = Pipeline([Cacher(sharding=torch.device("cpu")),
                     FunctionTransformer(lambda y: y + 1.0)])
    assert torch.equal(pipe(x), x + 1.0)
    with pytest.raises(TypeError, match="SpecSharding"):
        Cacher(sharding=("data", None))(x)


def test_cacher_round_trips_through_a_checkpoint(tmp_path):
    from keystone_tpu_torch.core.checkpoint import load_pipeline, save_pipeline

    pipe = Pipeline([Cacher(name="auto:x", memoize=True)])
    save_pipeline(str(tmp_path / "c"), pipe)
    back = load_pipeline(str(tmp_path / "c"), device="cpu")
    (node,) = back.nodes
    assert isinstance(node, Cacher) and node.name == "auto:x" and node.memoize


class TestAutoCacheChain:
    def test_cached_chain_computes_once_and_matches(self, no_budget):
        calls = {}
        chain = _counting_node(calls).then_estimator(_MeanCenter())
        x = torch.arange(64, dtype=torch.float32).reshape(16, 4)
        out_u = chain.fit(x)(x)
        assert calls["expensive"] == 2

        calls.clear()
        opt, plan = optimize.auto_cache_chain(
            _counting_node(calls).then_estimator(_MeanCenter()), x[:4], dataset_rows=16,
        )
        assert [d.name for d in plan.cached()] == ["expensive"]
        calls.clear()
        fitted_c = opt.fit(x)
        out_c = fitted_c(x)
        assert calls["expensive"] == 1
        assert torch.equal(out_u, out_c)
        calls.clear()
        fitted_c(x + 1.0)
        assert calls["expensive"] == 1

    def test_budget_denied_chain_is_uncached_but_equal(self, monkeypatch):
        calls = {}
        x = torch.arange(64, dtype=torch.float32).reshape(16, 4)
        out_u = _counting_node(calls).then_estimator(_MeanCenter()).fit(x)(x)
        monkeypatch.setenv(kmem.HBM_BUDGET_ENV, "1")
        calls.clear()
        opt, plan = optimize.auto_cache_chain(
            _counting_node(calls).then_estimator(_MeanCenter()), x[:4], dataset_rows=16,
        )
        assert plan.cached() == [] and plan.dropped == ["expensive"]
        assert len(opt.xform.nodes) == 1
        calls.clear()
        out_c = opt.fit(x)(x)
        assert calls["expensive"] == 2
        assert torch.equal(out_u, out_c)


def test_cost_model_rates_are_the_ports():
    from keystone_tpu_torch.core import profiler

    h100 = optimize.CostModel.for_devices(["NVIDIA H100 80GB HBM3"])
    assert h100.peak_flops == profiler.DEVICE_RATES["NVIDIA H100 80GB HBM3"]["peak_flops"]
    assert h100.ici_gbps == 5.0  # the JAX record's default, kept
    cpu = optimize.CostModel.for_devices([torch.device("cpu")])
    assert cpu.peak_flops == profiler.DEFAULT_RATES["peak_flops"]
    hints = {"arg_bytes": 2**30, "flops": 1e12, "dispatches": 2}
    assert cpu.predict_seconds(hints) == pytest.approx(joptimize.CostModel().predict_seconds(hints))


def test_calibration_model_matches_jax():
    rows = [(f"fp{i % 3}", {"arg_bytes": float(i), "kind": "fused" if i % 2 else "stepwise"},
             1.0 + 0.1 * i) for i in range(10)]
    port, ref = (mod.CalibrationModel.fit_rows(rows) for mod in (optimize, joptimize))
    assert port.record() == ref.record()
    feats = {"arg_bytes": 4.0, "kind": "fused"}
    assert port.predict_factor(feats) == pytest.approx(ref.predict_factor(feats))


# -- StreamConfig -------------------------------------------------------------


class TestStreamConfig:
    def test_from_env_seeds_the_initial_values(self, monkeypatch):
        monkeypatch.setenv("KEYSTONE_DECODE_THREADS", "3")
        monkeypatch.setenv("KEYSTONE_DECODE_AHEAD", "5")
        monkeypatch.setenv("KEYSTONE_RING_CAPACITY", "7")
        monkeypatch.setenv("KEYSTONE_AUTOTUNE", "1")
        monkeypatch.setenv("KEYSTONE_AUTOTUNE_INTERVAL", "9")
        cfg = ingest.StreamConfig.from_env()
        assert (cfg.decode_threads, cfg.decode_ahead, cfg.ring_capacity) == (3, 5, 7)
        assert cfg.autotune and cfg.autotune_interval == 9
        assert cfg.max_decode_threads >= cfg.decode_threads

    def test_overrides_beat_env(self, monkeypatch):
        monkeypatch.setenv("KEYSTONE_DECODE_THREADS", "3")
        cfg = ingest.StreamConfig.from_env(decode_threads=2, ring_capacity=1)
        assert cfg.decode_threads == 2 and cfg.ring_capacity == 1

    def test_validation(self):
        with pytest.raises(ValueError):
            ingest.StreamConfig(decode_threads=0, decode_ahead=0, ring_capacity=1)
        with pytest.raises(ValueError):
            ingest.StreamConfig(decode_threads=1, decode_ahead=-1, ring_capacity=1)
        with pytest.raises(ValueError):
            ingest.StreamConfig(decode_threads=1, decode_ahead=0, ring_capacity=0)
        with pytest.raises(ValueError):
            ingest.StreamConfig(decode_threads=1, decode_ahead=0, ring_capacity=1,
                                autotune_interval=0)
        with pytest.raises(ValueError, match="max_decode_threads"):
            ingest.StreamConfig(decode_threads=4, decode_ahead=0, ring_capacity=1,
                                max_decode_threads=2)

    def test_legacy_kwargs_are_validated(self, tmp_path, rng):
        path = str(tmp_path / "v.tar")
        _small_tar(path, 2, rng)
        cfg = ingest.StreamConfig(decode_threads=2, decode_ahead=0, ring_capacity=2)
        with pytest.raises(ValueError):
            ingest.stream_batches(path, 2, config=cfg, num_threads=0, device="cpu")

    def test_legacy_kwargs_override_config(self, tmp_path, rng):
        path = str(tmp_path / "t.tar")
        _small_tar(path, 4, rng)
        cfg = ingest.StreamConfig(decode_threads=4, decode_ahead=4, ring_capacity=4)
        with ingest.stream_batches(path, 2, config=cfg, num_threads=1, capacity=2,
                                   device="cpu") as st:
            list(st)
        assert st.config is cfg
        assert cfg.decode_threads == 1 and cfg.ring_capacity == 2
        assert st.join(10.0)

    def test_record_matches_the_jax_keys(self):
        from keystone_tpu.core import ingest as jingest

        port = ingest.StreamConfig(decode_threads=2, decode_ahead=1, ring_capacity=3)
        ref = jingest.StreamConfig(decode_threads=2, decode_ahead=1, ring_capacity=3)
        assert set(ref.record()) <= set(port.record())
        assert {k: port.record()[k] for k in ref.record()} == ref.record()


def _small_tar(path, n, rng, size=48):
    with tarfile.open(path, "w") as tf:
        for i in range(n):
            data = faults.make_jpeg_bytes(rng, size, size)
            info = tarfile.TarInfo(f"img_{i:04d}.jpg")
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))


def _collect(path, batch, config=None, tuner=None):
    with ingest.stream_batches(path, batch, config=config, tuner=tuner, device="cpu") as st:
        out = [(b.indices.copy(), b.host.copy(), list(b.names)) for b in st]
    assert st.join(10.0)
    return out, st


def _streams_equal(a, b):
    return len(a) == len(b) and all(
        np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1]) and x[2] == y[2]
        for x, y in zip(a, b)
    )


def _slow_decode(monkeypatch):
    real = image_loaders.decode_image

    def slow(data):
        time.sleep(0.01)  # the injected stall: decode-bound by fiat
        return real(data)

    monkeypatch.setattr(image_loaders, "decode_image", slow)


# -- the closed-loop autotuner ------------------------------------------------


class TestIngestAutotuner:
    def test_converges_on_a_stall_injected_stream(self, tmp_path, rng, monkeypatch):
        path = str(tmp_path / "stall.tar")
        _small_tar(path, 24, rng)
        _slow_decode(monkeypatch)
        static_cfg = ingest.StreamConfig(decode_threads=1, decode_ahead=0, ring_capacity=2,
                                         max_decode_threads=8)
        static, _ = _collect(path, 4, config=static_cfg)
        tuned_cfg = ingest.StreamConfig(decode_threads=1, decode_ahead=0, ring_capacity=2,
                                        max_decode_threads=8, autotune=True,
                                        autotune_interval=2)
        tuned, st = _collect(path, 4, config=tuned_cfg)
        rec = st.tuner.record()
        assert rec["retunes"] >= 1, rec
        assert tuned_cfg.decode_threads > 1, rec
        assert _streams_equal(static, tuned)

    def test_quiet_stream_is_left_alone(self):
        """No consumer stall -> no decode-bound escalation, driven through
        the ``_now`` seam: producer-blocked intervals only, at a fixed
        rate, may deepen the ring and narrow decode, never widen it."""
        cfg = ingest.StreamConfig(decode_threads=2, decode_ahead=2, ring_capacity=4,
                                  autotune=True, autotune_interval=1)
        tuner, tick = _tuner_on(cfg, optimize.IngestAutotuner())
        for _ in range(6):
            tick(0.02, consumer_stalls=0, producer_stalls=1)
        assert cfg.decode_threads <= 2
        assert cfg.ring_capacity > 4
        assert all("decode_backend" not in e["changes"] for e in tuner.trajectory)
        assert cfg.decode_backend == "thread"

    def test_manual_mid_stream_retune_is_bit_equal(self, tmp_path, rng):
        path = str(tmp_path / "manual.tar")
        _small_tar(path, 12, rng)
        baseline, _ = _collect(path, 3)
        cfg = ingest.StreamConfig(decode_threads=1, decode_ahead=0, ring_capacity=1,
                                  max_decode_threads=4)
        got = []
        with ingest.stream_batches(path, 3, config=cfg, device="cpu") as st:
            for i, b in enumerate(st):
                got.append((b.indices.copy(), b.host.copy(), list(b.names)))
                if i == 1:
                    cfg.decode_threads = 4
                    cfg.decode_ahead = 6
                    cfg.ring_capacity = 8
        assert st.join(10.0)
        assert _streams_equal(baseline, got)

    def test_retunes_land_in_metrics_and_trajectory(self, tmp_path, rng, monkeypatch):
        path = str(tmp_path / "metrics.tar")
        _small_tar(path, 16, rng)
        _slow_decode(monkeypatch)
        cfg = ingest.StreamConfig(decode_threads=1, decode_ahead=0, ring_capacity=2,
                                  max_decode_threads=4, autotune=True, autotune_interval=1)
        before = trace.metrics.get("ingest_retunes")
        _, st = _collect(path, 4, config=cfg)
        rec = st.tuner.record()
        assert trace.metrics.get("ingest_retunes") - before == rec["retunes"]
        for entry in rec["trajectory"]:
            assert set(entry) == {"chunk", "producer_stalls_delta", "consumer_stalls_delta",
                                  "changes"}
            for knob, (old, new) in entry["changes"].items():
                assert knob in ("decode_threads", "decode_ahead", "ring_capacity",
                                "decode_backend", "decode_procs")
                assert old != new
        assert rec["final_config"] == cfg.record()


def _tuner_on(cfg, tuner):
    stats = ingest.StreamStats()
    stream = types.SimpleNamespace(config=cfg, stats=stats)
    tuner.attach(stream)
    clock = {"t": 0.0}
    tuner._now = lambda: clock["t"]

    def tick(dt, consumer_stalls=1, producer_stalls=0):
        stats.consumer_stalls += consumer_stalls
        stats.producer_stalls += producer_stalls
        clock["t"] += dt
        tuner.on_chunk(stream)

    return tuner, tick


class TestBackendPromotion:
    def _cfg(self, threads=2):
        return ingest.StreamConfig(decode_threads=threads, decode_ahead=0, ring_capacity=2,
                                   max_decode_threads=8)

    def test_flat_scaling_promotes_to_process(self):
        cfg = self._cfg()
        tuner, tick = _tuner_on(cfg, optimize.IngestAutotuner(interval=1))
        tick(1.0)
        tick(1.0)
        assert cfg.decode_threads == 4 and cfg.decode_backend == "thread"
        tick(0.9)
        assert cfg.decode_backend == "process"
        assert cfg.decode_procs == cfg.decode_threads == 4
        assert any("decode_backend" in e["changes"] for e in tuner.trajectory)

    def test_capped_widen_scales_the_promotion_floor(self):
        cfg = self._cfg(threads=7)
        _, tick = _tuner_on(cfg, optimize.IngestAutotuner(interval=1))
        tick(1.0)
        tick(1.0)
        assert cfg.decode_threads == 8 and cfg.decode_backend == "thread"
        tick(0.875)
        assert cfg.decode_backend == "thread"

    def test_real_scaling_keeps_widening_threads(self):
        cfg = self._cfg()
        _, tick = _tuner_on(cfg, optimize.IngestAutotuner(interval=1))
        tick(1.0)
        tick(1.0)
        tick(0.4)
        assert cfg.decode_backend == "thread"
        assert cfg.decode_threads == 8

    def test_promotion_can_be_disallowed(self):
        cfg = self._cfg()
        _, tick = _tuner_on(cfg, optimize.IngestAutotuner(interval=1,
                                                          allow_backend_switch=False))
        for dt in (1.0, 1.0, 0.9, 0.9, 0.9):
            tick(dt)
        assert cfg.decode_backend == "thread"

    def test_consumer_bound_interval_resets_the_evidence(self):
        cfg = self._cfg()
        _, tick = _tuner_on(cfg, optimize.IngestAutotuner(interval=1))
        tick(1.0)
        tick(1.0)
        tick(1.0, consumer_stalls=0, producer_stalls=1)
        tick(0.9)
        assert cfg.decode_backend == "thread"


@pytest.mark.parametrize("ticks", [
    [(1.0, 1, 0), (1.0, 1, 0), (0.9, 1, 0)],
    [(1.0, 1, 0), (1.0, 1, 0), (0.4, 1, 0), (0.3, 1, 0)],
    [(1.0, 0, 1), (1.0, 0, 1), (1.0, 1, 1), (0.5, 1, 0), (0.5, 1, 0)],
])
def test_trajectories_equal_jax(ticks):
    """The same stall and clock sequence moves both packages' controllers
    through the same knob trajectory."""
    from keystone_tpu.core import ingest as jingest

    tuners = []
    for ing, opt in ((ingest, optimize), (jingest, joptimize)):
        cfg = ing.StreamConfig(decode_threads=2, decode_ahead=0, ring_capacity=2,
                               max_decode_threads=8)
        stats = ing.StreamStats()
        stream = types.SimpleNamespace(config=cfg, stats=stats)
        tuner = opt.IngestAutotuner(interval=1)
        tuner.attach(stream)
        clock = {"t": 0.0}
        tuner._now = lambda clock=clock: clock["t"]
        for dt, c, p in ticks:
            stats.consumer_stalls += c
            stats.producer_stalls += p
            clock["t"] += dt
            tuner.on_chunk(stream)
        tuners.append(tuner)
    assert tuners[0].trajectory == tuners[1].trajectory
    port, ref = (t.record()["final_config"] for t in tuners)
    assert {k: port[k] for k in ref} == ref


def test_autotune_thrash_on_the_port_stream(tmp_path):
    """The ``autotune_thrash`` chaos family on the port's stream: the
    harness's oscillating tuner at its schedule's batch and period leaves
    the features bit-equal to a static-knob stream, with every retune
    observed and every thread joined."""
    fault = chaos.make_schedule(chaos.FAMILIES.index("autotune_thrash"))
    batch, period = int(fault.params["batch"]), int(fault.params["period"])
    path = str(tmp_path / "thrash.tar")
    faults.make_image_tar(path, chaos._N_STREAM_IMAGES, np.random.default_rng(0))

    def featurize(x):
        return torch.stack([x.mean(dim=(1, 2, 3)), x.amax(dim=(1, 2, 3))], dim=1)

    def run(config=None, tuner=None):
        with ingest.stream_batches(path, batch, config=config, tuner=tuner, device="cpu") as st:
            feats, names = scatter_features_streaming(st, featurize, 2)
        assert st.join(10.0)
        return feats, names

    static_feats, static_names = run()
    tuner = chaos._ThrashTuner(period)
    cfg = ingest.StreamConfig(decode_threads=1, decode_ahead=0, ring_capacity=1,
                              max_decode_threads=4)
    feats, names = run(config=cfg, tuner=tuner)
    assert tuner.retunes >= 1
    assert names == static_names
    assert np.array_equal(feats, static_feats)


class TestSnapshotAdvisor:
    def test_repeat_epochs_with_cheap_io_advise(self):
        adv = optimize.advise_snapshot(images=1000, bytes_per_image=1000,
                                       decode_images_per_sec=100.0, epochs=5, gbps=1.0)
        assert adv.advise
        assert adv.live_seconds == pytest.approx(50.0)
        assert adv.snapshot_seconds < adv.live_seconds

    def test_single_epoch_never_advises(self):
        adv = optimize.advise_snapshot(images=1000, bytes_per_image=1000,
                                       decode_images_per_sec=100.0, epochs=1, gbps=1.0)
        assert not adv.advise and "single pass" in adv.reason

    def test_slow_disk_declines(self):
        adv = optimize.advise_snapshot(images=1000, bytes_per_image=10**6,
                                       decode_images_per_sec=10**6, epochs=5, gbps=0.001)
        assert not adv.advise

    def test_record_is_jsonable(self):
        adv = optimize.advise_snapshot(images=10, bytes_per_image=10,
                                       decode_images_per_sec=1.0, epochs=2)
        assert json.loads(json.dumps(adv.record()))["epochs"] == 2
        ref = joptimize.advise_snapshot(images=10, bytes_per_image=10,
                                        decode_images_per_sec=1.0, epochs=2)
        assert adv.record() == ref.record()

    def test_validation(self):
        with pytest.raises(ValueError):
            optimize.advise_snapshot(images=1, bytes_per_image=1,
                                     decode_images_per_sec=0.0, epochs=2)


# -- --autoCache on the CLIs --------------------------------------------------


@pytest.fixture(scope="module")
def cifar_files(tmp_path_factory):
    rng = np.random.default_rng(5)
    base = rng.uniform(40, 215, (4, 3))
    d = tmp_path_factory.mktemp("cifar_autocache")
    train, test = str(d / "train.bin"), str(d / "test.bin")
    _write_cifar(train, 400, rng, base)
    _write_cifar(test, 150, rng, base)
    return train, test


def test_cifar_auto_cache_featurizes_once_and_matches(cifar_files, monkeypatch):
    """The cached conv features replay for the fitted application: the
    training split goes through the featurizer once on the fit path (the
    plain path's count), and the predictions equal the plain run's; the
    JAX run with the flag reaches the same errors."""
    monkeypatch.delenv(kmem.HBM_BUDGET_ENV, raising=False)
    train, test = cifar_files
    argv = ["--trainLocation", train, "--testLocation", test, *CIFAR_FLAGS]
    # Featurize calls on the loaded training images themselves (the
    # optimizer's sample passes are calls on a slice of them).
    calls, loaded = {"n": 0}, []
    real_featurize, real_load = pt_cifar.featurize_chunked, pt_cifar._load_split

    def load(location):
        loaded.append(real_load(location))
        return loaded[-1]

    def counted(fn, images, chunk, device, mesh=None):
        calls["n"] += images is loaded[0].images
        return real_featurize(fn, images, chunk, device, mesh=mesh)

    monkeypatch.setattr(pt_cifar, "_load_split", load)
    monkeypatch.setattr(pt_cifar, "featurize_chunked", counted)
    plain = pt_cifar.main([*argv, "--device", "cpu"])
    plain_calls, calls["n"] = calls["n"], 0
    loaded.clear()
    cached = pt_cifar.main([*argv, "--device", "cpu", "--autoCache"])
    assert plain_calls == calls["n"] == 1
    np.testing.assert_array_equal(cached["test_predictions"], plain["test_predictions"])
    plan = cached["cache_plan"]
    assert plan["cached"] == ["conv_featurize"]
    assert plan["dataset_rows"] == 400
    (dec,) = plan["decisions"]
    assert dec["reuse"] == 2
    ref = jax_cifar.main([*argv, "--autoCache"])
    assert ref["cache_plan"]["cached"] == ["conv_featurize"]
    assert cached["test_error"] == plain["test_error"] == ref["test_error"] == 0.0
    assert cached["train_error"] == ref["train_error"]


def test_cifar_auto_cache_denied_is_equal(cifar_files, monkeypatch):
    monkeypatch.setenv(kmem.HBM_BUDGET_ENV, "1K")
    train, test = cifar_files
    argv = ["--trainLocation", train, "--testLocation", test, *CIFAR_FLAGS, "--device", "cpu"]
    denied = pt_cifar.main([*argv, "--autoCache"])
    monkeypatch.delenv(kmem.HBM_BUDGET_ENV)
    plain = pt_cifar.main(argv)
    assert denied["cache_plan"]["cached"] == []
    assert denied["cache_plan"]["dropped"] == ["conv_featurize"]
    np.testing.assert_array_equal(denied["test_predictions"], plain["test_predictions"])


#: Both packages weigh a node's measured recompute seconds against its bytes
#: at ``KEYSTONE_CACHE_GBPS``.  At the default rate these small runs sit near
#: the line, so the decision would follow the host's load; at this rate the
#: residency costs next to nothing and a reused node is cached unless the
#: budget denies it, in either package.
_FREE_RESIDENCY_GBPS = "1000000"


@pytest.fixture(scope="module")
def mnist_csvs(tmp_path_factory):
    rng = np.random.default_rng(7)
    centers = rng.normal(0, 1.0, (10, 784))

    def make(n):
        labels = rng.integers(1, 11, n)
        return np.column_stack([labels, centers[labels - 1] + 0.3 * rng.normal(size=(n, 784))])

    d = tmp_path_factory.mktemp("mnist_autocache")
    train, test = str(d / "train.csv"), str(d / "test.csv")
    np.savetxt(train, make(300), delimiter=",", fmt="%.5f")
    np.savetxt(test, make(80), delimiter=",", fmt="%.5f")
    return train, test


@pytest.mark.parametrize("budget", [None, "1K"])
def test_mnist_auto_cache_matches(mnist_csvs, budget, monkeypatch):
    """Kept or rebuilt for the train-split eval, the featurized batches give
    the plain run's predictions; the JAX run with the flag decides alike
    and reaches the same errors."""
    if budget is None:
        monkeypatch.delenv(kmem.HBM_BUDGET_ENV, raising=False)
    else:
        monkeypatch.setenv(kmem.HBM_BUDGET_ENV, budget)
    monkeypatch.setenv(optimize.CACHE_GBPS_ENV, _FREE_RESIDENCY_GBPS)
    train, test = mnist_csvs
    argv = ["--trainLocation", train, "--testLocation", test, "--numFFTs", "4",
            "--blockSize", "512", "--lambda", "10"]
    cached = pt_mnist.main([*argv, "--device", "cpu", "--autoCache"])
    plain = pt_mnist.main([*argv, "--device", "cpu"])
    np.testing.assert_array_equal(cached["test_predictions"], plain["test_predictions"])
    assert cached["train_error"] == plain["train_error"]
    ref = jax_mnist.main([*argv, "--autoCache"])
    assert cached["cache_plan"]["cached"] == ref["cache_plan"]["cached"]
    assert cached["cache_plan"]["cached"] == ([] if budget else ["fft_features"])
    assert cached["test_error"] == ref["test_error"] == 0.0
    assert cached["train_error"] == ref["train_error"]


@pytest.fixture(scope="module")
def voc_tar(tmp_path_factory):
    d = tmp_path_factory.mktemp("voc_autocache")
    labels = str(d / "labels.csv")
    open(labels, "w").close()
    tar = str(d / "voc.tar")
    write_voc_tar(tar, labels, 24, np.random.default_rng(42))
    return tar, labels


@pytest.mark.parametrize("budget", [None, "1K"])
def test_voc_auto_cache_matches(voc_tar, budget, monkeypatch):
    """Materialized or re-projected per consumer, the projected descriptors
    give the plain run's scores bit for bit; the JAX run with the flag
    gives the same APs on the present classes."""
    if budget is None:
        monkeypatch.delenv(kmem.HBM_BUDGET_ENV, raising=False)
    else:
        monkeypatch.setenv(kmem.HBM_BUDGET_ENV, budget)
    monkeypatch.setenv(optimize.CACHE_GBPS_ENV, _FREE_RESIDENCY_GBPS)
    tar, labels = voc_tar
    argv = ["--trainLocation", tar, "--testLocation", tar, "--labelPath", labels,
            "--lambda", "0.05", "--descDim", "16", "--vocabSize", "8",
            "--numPcaSamples", "6000", "--numGmmSamples", "6000"]
    cached = pt_voc.main([*argv, "--device", "cpu", "--autoCache"])
    monkeypatch.delenv(kmem.HBM_BUDGET_ENV, raising=False)
    plain = pt_voc.main([*argv, "--device", "cpu"])
    np.testing.assert_array_equal(cached["test_scores"], plain["test_scores"])
    plan = cached["cache_plan"]
    assert [d["name"] for d in plan["decisions"]] == ["voc_pca_descriptors"]
    assert plan["cached"] == ([] if budget else ["voc_pca_descriptors"])
    if budget:
        monkeypatch.setenv(kmem.HBM_BUDGET_ENV, budget)
    ref = jax_voc.main([*argv, "--autoCache"])
    assert ref["cache_plan"]["cached"] == plan["cached"]
    np.testing.assert_array_equal(cached["aps"][:4], ref["aps"][:4])


# -- --autoTune on the streamed CLIs ------------------------------------------


def test_cifar_auto_tune_stream_matches(tmp_path, monkeypatch):
    """RandomPatchCifar's streamed test split under the autotuner, which
    evaluates every chunk: the record rides the results and the
    predictions equal the untuned stream's."""
    monkeypatch.setenv("KEYSTONE_AUTOTUNE_INTERVAL", "1")
    tar = str(tmp_path / "c48.tar")
    _write_cifar_tar(tar, 20, np.random.default_rng(3))
    argv = ["--trainLocation", tar, "--streamTestTar", tar, "--numFilters", "4",
            "--patchSteps", "6", "--whitenerSize", "64", "--lambda", "10", "--device", "cpu"]
    plain = pt_cifar.main(argv)
    tuned = pt_cifar.main([*argv, "--autoTune"])
    np.testing.assert_array_equal(tuned["test_predictions"], plain["test_predictions"])
    assert "autotune" not in plain
    rec = tuned["autotune"]
    assert set(rec) == {"retunes", "trajectory", "final_config"}
    assert rec["final_config"]["autotune"] is True


def test_voc_auto_tune_stream_matches(voc_tar, monkeypatch):
    monkeypatch.setenv("KEYSTONE_AUTOTUNE_INTERVAL", "1")
    tar, labels = voc_tar
    argv = ["--trainLocation", tar, "--testLocation", tar, "--labelPath", labels,
            "--lambda", "0.05", "--descDim", "16", "--vocabSize", "8",
            "--numPcaSamples", "6000", "--numGmmSamples", "6000", "--device", "cpu",
            "--streamIngest", "--streamBatchSize", "5"]
    plain = pt_voc.main(argv)
    tuned = pt_voc.main([*argv, "--autoTune"])
    np.testing.assert_array_equal(tuned["test_scores"], plain["test_scores"])
    assert "autotune" not in plain
    assert [len(tuned["autotune"][s]) for s in ("train", "test")] == [1, 1]
