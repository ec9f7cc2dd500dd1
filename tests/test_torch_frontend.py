"""The port's shape-routed front-end (``keystone_tpu_torch.core.frontend``):
the ShapeRouter cases of ``tests/test_frontend.py`` on the port's engines
(CPU): routing by shape, typed ``RetryLater`` backpressure, warm add and
idle retire under a fake clock with zero request loss, ``max_engines``
eviction, cross-engine admission denial, atomic ``replace_engine``, and
the ``KEYSTONE_ROUTER_*`` knobs (parsed as the JAX package parses them).
Bar: every answer ``np.array_equal`` to its engine's offline apply."""

import json
import threading
import time

import numpy as np
import pytest
import torch

from keystone_tpu.core import frontend as jfrontend
from keystone_tpu_torch.core import frontend, telemetry, trace
from keystone_tpu_torch.core import serve as kserve
from keystone_tpu_torch.core.pipeline import FunctionTransformer
from keystone_tpu_torch.core.resilience import counters

pytestmark = pytest.mark.serve


class FakeClock:
    """Injectable monotonic clock: the mix window and retire aging advance
    only when the test says so."""

    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _toy(shape, seed, name="toy"):
    srng = np.random.default_rng(seed)
    w = torch.from_numpy(srng.normal(size=shape).astype(np.float32))
    b = torch.from_numpy(srng.normal(size=shape).astype(np.float32))
    return FunctionTransformer(lambda x: torch.maximum(x * w, b), name=name)


def _make_engine(shape, dtype=np.dtype(np.float32), label="frontend"):
    """Deterministic per-shape toy engine (the reference tests' mul+max,
    weights seeded by the shape)."""
    shape = tuple(int(d) for d in shape)
    cfg = kserve.ServeConfig(buckets=(1, 2, 4), max_wait_ms=2.0)
    return kserve.ServingEngine(
        _toy(shape, 7000 + int(np.prod(shape))), np.zeros(shape, np.float32),
        config=cfg, label=frontend.shape_label(label, shape), device="cpu",
    )


def _reqs(rng, n, shape):
    return rng.normal(size=(n, *shape)).astype(np.float32)


def _router(clock=None, factory=None, **cfg_kw):
    cfg = frontend.RouterConfig(
        warm_threshold=cfg_kw.pop("warm_threshold", 3),
        mix_window_s=cfg_kw.pop("mix_window_s", 5.0),
        retire_after_s=cfg_kw.pop("retire_after_s", 30.0),
        **cfg_kw,
    )
    return frontend.ShapeRouter(
        factory, label="testrouter", config=cfg,
        clock=clock or time.monotonic,
    )


class TestRouting:
    def test_routes_by_shape_bit_equal(self, rng):
        e16, e8 = _make_engine((16,)), _make_engine((8,))
        with _router() as router:
            router.add_engine(e16)
            router.add_engine(e8)
            r16, r8 = _reqs(rng, 9, (16,)), _reqs(rng, 7, (8,))
            futs = [router.submit(r) for r in r16]
            futs8 = [router.submit(r) for r in r8]
            a16 = np.stack([f.result(30.0) for f in futs])
            a8 = np.stack([f.result(30.0) for f in futs8])
            assert np.array_equal(a16, e16.offline(r16))
            assert np.array_equal(a8, e8.offline(r8))
            assert router.stats.routes == 16
            assert router.stats.misses == 0
            rec = router.record()
            json.dumps(rec)
            assert set(rec["engines"]) == {"16", "8"}
        # route overhead is a registry histogram (the bench regresses on it)
        snap = trace.metrics.snapshot()
        assert snap["histograms"]["router_route_overhead_us"]["count"] >= 16

    def test_duplicate_shape_rejected(self):
        with _router() as router:
            router.add_engine(_make_engine((16,)))
            with pytest.raises(ValueError, match="already has a live engine"):
                router.add_engine(_make_engine((16,)))

    def test_no_factory_unserved_shape_is_typed(self, rng):
        with _router() as router:
            router.add_engine(_make_engine((16,)))
            with pytest.raises(frontend.NoRouteForShape):
                router.submit(np.zeros(5, np.float32))
            assert router.stats.no_route == 1

    def test_cold_shape_gets_retry_later_backpressure(self, rng):
        with _router(factory=_make_engine, warm_threshold=5) as router:
            router.add_engine(_make_engine((16,)))
            with pytest.raises(frontend.RetryLater) as ei:
                router.submit(np.zeros(8, np.float32))
            assert ei.value.retry_after_s > 0
            assert router.stats.rejected == 1
            assert router.stats.misses == 1

    def test_closed_router_is_typed(self):
        router = _router()
        router.add_engine(_make_engine((16,)))
        router.close()
        with pytest.raises(kserve.ServingUnavailable):
            router.submit(np.zeros(16, np.float32))

    def test_malformed_payload_propagates_typed(self, rng):
        with _router() as router:
            router.add_engine(_make_engine((16,)))
            bad = _reqs(rng, 1, (16,))[0]
            bad[3] = np.nan
            with pytest.raises(kserve.MalformedRequest):
                router.submit(bad)


class TestClosedLoop:
    def test_shape_mix_replay_retire_and_warm_add_zero_loss(self, rng):
        """The acceptance replay: a deterministic shape-mix shift
        (traffic moves from width 16 to width 8) must trigger exactly one
        warm engine add and one engine retire, with the registry gauges
        proving both and EVERY submitted request resolving bit-equal —
        zero request loss across the swap."""
        clock = FakeClock()
        e16 = _make_engine((16,))
        router = _router(
            clock=clock, factory=_make_engine,
            warm_threshold=3, mix_window_s=5.0, retire_after_s=10.0,
        )
        retired_before = trace.metrics.get("router_engine_retired")
        try:
            router.add_engine(e16)
            # Phase 1: the old shape earns traffic.
            r16 = _reqs(rng, 8, (16,))
            futs16 = [router.submit(r) for r in r16]

            # Phase 2: the mix shifts — width-8 requests arrive.  Below
            # the warm threshold they answer typed backpressure; at the
            # threshold the router warms an engine and serves.
            r8 = _reqs(rng, 6, (8,))
            futs8 = []
            rejected = 0
            for r in r8:
                while True:
                    try:
                        futs8.append(router.submit(r))
                        break
                    except frontend.RetryLater:
                        rejected += 1
                        clock.advance(0.1)  # an honest client retries
            assert rejected >= 2  # the first warm_threshold-1 pushed back
            assert router.stats.warm_adds == 1
            assert set(router.engines()) == {(16,), (8,)}
            assert trace.metrics.gauge_value("router_engines") == 2

            # Phase 3: width 16 stops earning traffic; the sweep retires
            # it.  The outstanding width-16 futures were submitted BEFORE
            # the retire — drain-before-close means they all resolve.
            clock.advance(11.0)
            actions = router.adapt()
            assert actions["retired"] == [[16]]
            assert router.stats.retires == 1
            assert set(router.engines()) == {(8,)}
            assert trace.metrics.gauge_value("router_engines") == 1
            assert (
                trace.metrics.get("router_engine_retired")
                == retired_before + 1
            )
            # The retired shape's SLO tracker left the live surface; the
            # survivor's remains.
            slos = telemetry.slo_summaries()
            assert frontend.shape_label("frontend", (16,)) not in slos
            assert frontend.shape_label("frontend", (8,)) in slos

            # Zero loss: every future from both phases resolved bit-equal.
            a16 = np.stack([f.result(30.0) for f in futs16])
            a8 = np.stack([f.result(30.0) for f in futs8])
            assert np.array_equal(a16, e16.offline(r16))
            e8_label = frontend.shape_label("frontend", (8,))
            e8 = next(
                e.engine
                for e in router._engines.values()
                if e.engine.label == e8_label
            )
            assert np.array_equal(a8, e8.offline(r8))
            assert router.stats.routes == len(futs16) + len(futs8)
        finally:
            router.close()

    def test_retire_respects_min_engines_floor(self, rng):
        clock = FakeClock()
        router = _router(clock=clock, retire_after_s=1.0, min_engines=1)
        try:
            router.add_engine(_make_engine((16,)))
            clock.advance(100.0)
            assert router.adapt() == {"retired": []}
            assert set(router.engines()) == {(16,)}
        finally:
            router.close()

    def test_max_engines_evicts_idlest_for_hotter_shape(self, rng):
        clock = FakeClock()
        router = _router(
            clock=clock, factory=_make_engine, warm_threshold=1,
            mix_window_s=2.0, max_engines=1, min_engines=0,
        )
        try:
            router.add_engine(_make_engine((16,)))
            clock.advance(3.0)  # the resident engine goes idle
            fut = router.submit(np.ones(8, np.float32))
            fut.result(30.0)
            assert set(router.engines()) == {(8,)}
            assert router.stats.retires == 1
            assert router.stats.warm_adds == 1
        finally:
            router.close()

    def test_predict_absorbs_backpressure(self, rng):
        with _router(factory=_make_engine, warm_threshold=2) as router:
            req = _reqs(rng, 1, (8,))[0]
            out = router.predict(req, timeout=60.0)
            e8_label = frontend.shape_label("frontend", (8,))
            e8 = next(
                e.engine
                for e in router._engines.values()
                if e.engine.label == e8_label
            )
            assert np.array_equal(out, e8.offline(req[None])[0])
            assert router.stats.warm_adds == 1


class TestCrossAdmission:
    def test_denied_warm_add_is_counted_backpressure(self, rng, monkeypatch):
        """A warm add that would overrun the shared budget answers
        RetryLater (counted router_admission_denied); retiring the
        resident engine frees the headroom and the retry succeeds."""
        clock = FakeClock()
        router = _router(
            clock=clock, factory=_make_engine, warm_threshold=1,
            retire_after_s=5.0, min_engines=0,
        )
        # A budget that fits ONE width-8 engine but not the width-16
        # resident PLUS it makes the cross-engine sum the decider (probe
        # engine measures the real planned peak — same shapes, same plans
        # as the factory will build).
        probe = _make_engine((8,))
        need = router._engine_peak_bytes(probe)
        assert need > 0
        monkeypatch.setattr(
            frontend.kmem, "hbm_budget", lambda device=None: need + 16
        )
        before = counters.get("router_admission_denied")
        try:
            router.add_engine(_make_engine((16,)))
            with pytest.raises(frontend.RetryLater, match="no HBM headroom"):
                router.submit(np.ones(8, np.float32))
            assert router.stats.admission_denied == 1
            assert counters.get("router_admission_denied") == before + 1
            assert router.admissions[-1]["admitted"] is False

            clock.advance(6.0)
            router.adapt()  # the idle resident retires -> headroom frees
            assert set(router.engines()) == set()
            fut = router.submit(np.ones(8, np.float32))
            assert fut.result(30.0) is not None
            assert router.stats.warm_adds == 1
            assert router.admissions[-1]["admitted"] is True
        finally:
            router.close()


class TestConcurrency:
    def test_concurrent_mixed_shape_clients_bit_equal(self, rng):
        e16, e8 = _make_engine((16,)), _make_engine((8,))
        r16, r8 = _reqs(rng, 24, (16,)), _reqs(rng, 24, (8,))
        answers: dict = {}
        errors: list = []
        with _router() as router:
            router.add_engine(e16)
            router.add_engine(e8)

            def client(cid, reqs):
                try:
                    futs = [router.submit(r) for r in reqs]
                    answers[cid] = np.stack(
                        [f.result(30.0) for f in futs]
                    )
                except BaseException as e:  # noqa: BLE001 — surfaced below
                    errors.append(e)

            threads = [
                threading.Thread(target=client, args=(0, r16)),
                threading.Thread(target=client, args=(1, r8)),
                threading.Thread(target=client, args=(2, r16[::-1])),
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60.0)
        assert not errors, errors
        assert np.array_equal(answers[0], e16.offline(r16))
        assert np.array_equal(answers[1], e8.offline(r8))
        assert np.array_equal(answers[2], e16.offline(r16[::-1]))


class TestConfig:
    def test_env_seeding(self, monkeypatch):
        monkeypatch.setenv(frontend.WARM_THRESHOLD_ENV, "7")
        monkeypatch.setenv(frontend.MIX_WINDOW_ENV, "2.5")
        monkeypatch.setenv(frontend.RETIRE_AFTER_ENV, "12")
        monkeypatch.setenv(frontend.MAX_ENGINES_ENV, "3")
        cfg = frontend.RouterConfig.from_env()
        assert cfg.record() == jfrontend.RouterConfig.from_env().record()
        assert cfg.warm_threshold == 7
        assert cfg.mix_window_s == 2.5
        assert cfg.retire_after_s == 12.0
        assert cfg.max_engines == 3

    def test_invalid_env_is_typed(self, monkeypatch):
        monkeypatch.setenv(frontend.WARM_THRESHOLD_ENV, "0")
        with pytest.raises(ValueError, match=">= 1"):
            frontend.RouterConfig.from_env()
        monkeypatch.delenv(frontend.WARM_THRESHOLD_ENV)
        monkeypatch.setenv(frontend.MIX_WINDOW_ENV, "banana")
        with pytest.raises(ValueError, match="not a number"):
            frontend.RouterConfig.from_env()

    def test_invalid_config_rejected(self):
        with pytest.raises(ValueError):
            frontend.RouterConfig(warm_threshold=0)
        with pytest.raises(ValueError):
            frontend.RouterConfig(mix_window_s=0)

class TestReplaceEngine:
    """Atomic per-shape engine replacement: the swap
    is add-then-retire under ONE routing-table update, so a continuously
    servable shape never answers a transient ``RetryLater`` and no
    in-flight request is lost."""

    @staticmethod
    def _successor(shape, seed, label="frontend"):
        """A replacement engine with DISTINCT weights (so old/new answers
        are distinguishable) under the SAME shape label as
        :func:`_make_engine` — exercising the same-label rename guard."""
        shape = tuple(int(d) for d in shape)
        cfg = kserve.ServeConfig(buckets=(1, 2, 4), max_wait_ms=2.0)
        return kserve.ServingEngine(
            _toy(shape, seed, name="toy2"), np.zeros(shape, np.float32), config=cfg,
            label=frontend.shape_label(label, shape), device="cpu",
        )

    def test_swap_is_atomic_with_zero_request_loss(self, rng):
        e_old = _make_engine((16,))
        e_new = self._successor((16,), seed=99)
        reqs = _reqs(rng, 6, (16,))
        with _router() as router:
            router.add_engine(e_old)
            # Stretch the incumbent's batches so the swap genuinely
            # straddles in-flight work.
            real_exec = e_old._execute
            def slow_execute(bucket, dev):
                time.sleep(0.05)
                return real_exec(bucket, dev)
            e_old._execute = slow_execute
            inflight = [router.submit(r) for r in reqs]
            # Probe the routing table at the most hostile instant: from
            # INSIDE the incumbent's retirement (table already flipped to
            # the successor, drain not yet finished).  The probe must
            # route — a retire-then-add sequence would RetryLater here.
            mid = {}
            real_retire = router._retire_entry
            def retire_probe(entry, why):
                mid["fut"] = router.submit(reqs[0])
                real_retire(entry, why=why)
            router._retire_entry = retire_probe
            try:
                key = router.replace_engine(e_new, why="test swap")
            finally:
                router._retire_entry = real_retire
                e_old._execute = real_exec
            assert key == (16,)
            # Every pre-swap future resolved on the OLD engine, bit-equal
            # (drained, not dropped).
            old_ans = np.stack([f.result(30.0) for f in inflight])
            assert np.array_equal(old_ans, e_old.offline(reqs))
            # The mid-retirement probe answered on the NEW engine.
            probe = np.asarray(mid["fut"].result(30.0))
            assert np.array_equal(probe, e_new.offline(reqs[:1])[0])
            # Post-swap traffic routes to the successor.
            post = np.stack([router.submit(r).result(30.0) for r in reqs])
            assert np.array_equal(post, e_new.offline(reqs))
            assert router.stats.replaces == 1
            assert router.stats.retires == 1
            # No backpressure / miss for a shape that never stopped being
            # servable.
            assert router.stats.rejected == 0
            assert router.stats.no_route == 0
            assert router.stats.misses == 0

    def test_same_label_successor_is_renamed(self):
        """SLO trackers and drift monitors unregister BY LABEL at
        retirement: a same-label successor must be renamed before its
        server registers, or the incumbent's retirement would strip the
        successor's telemetry."""
        e_old = _make_engine((8,))
        e_new = self._successor((8,), seed=41)
        assert e_new.label == e_old.label
        with _router() as router:
            router.add_engine(e_old)
            router.replace_engine(e_new, why="same-label swap")
            assert e_new.label == f"{e_old.label}@swap"
            assert router.engines()[(8,)] == e_new.label
            # The successor's SLO tracker survived the incumbent's
            # label-keyed unregistration.
            assert e_new.label in telemetry.slo_summaries()

    def test_mix_accounting_carries_over(self, rng):
        """``routes``/``last_routed`` carry across the swap so the
        idle-retire clock does not restart on a replacement."""
        clock = FakeClock()
        e_old = _make_engine((16,))
        e_new = self._successor((16,), seed=77)
        with _router(clock=clock) as router:
            router.add_engine(e_old)
            for r in _reqs(rng, 5, (16,)):
                router.submit(r).result(30.0)
            with router._lock:
                before = router._engines[(16,)].routes
            assert before == 5
            router.replace_engine(e_new, why="carry-over check")
            with router._lock:
                entry = router._engines[(16,)]
                assert entry.routes == before
                assert entry.engine is e_new

    def test_replace_without_incumbent_degrades_to_add(self, rng):
        e = _make_engine((16,))
        with _router() as router:
            key = router.replace_engine(e, why="first deploy")
            assert key == (16,)
            assert router.stats.replaces == 0
            assert router.stats.retires == 0
            r = _reqs(rng, 3, (16,))
            ans = np.stack([router.submit(x).result(30.0) for x in r])
            assert np.array_equal(ans, e.offline(r))

    def test_replace_on_closed_router_is_typed(self):
        router = _router()
        router.add_engine(_make_engine((16,)))
        router.close()
        with pytest.raises(kserve.ServingUnavailable):
            router.replace_engine(self._successor((16,), seed=5))

    def test_duplicate_add_still_rejected_after_replace(self):
        """replace_engine is the ONLY path that overwrites a live shape —
        add_engine keeps its collision guard."""
        with _router() as router:
            router.add_engine(_make_engine((16,)))
            router.replace_engine(self._successor((16,), seed=13))
            with pytest.raises(ValueError, match="already has a live engine"):
                router.add_engine(_make_engine((16,)))
