"""Multiple processes and multihost in the port
(``keystone_tpu_torch.parallel.distributed``, the process-spanning mesh of
``parallel.mesh``, the cross-process ``_Resharder`` of ``core.checkpoint``,
``core.frontend.HostFleet``, ``core.ingest.host_shards`` and
``workloads.multihost``), held to ``tests/test_multihost.py`` and to the JAX
package's functions:

* with no group configured every entry point answers solo and touches no
  ``torch.distributed``;
* ``host_shards`` equals the JAX function for several ``(n, rank, world)``;
  ``fit_from_moments`` is the JAX function's bits on the same packed
  moments (a degenerate std included); ``moments_for_shards`` on the same
  tars is the JAX package's within rtol 1e-6 on the sums (per-image
  reductions in another order), with ``n`` equal;
* bring-up faults are typed and counted: ``EADDRINUSE`` retried on rank 0
  only (torch's real message matched), a missing peer and a dead
  coordinator raise ``DeadlineExceeded`` within 30 s in a real process,
  and a world-1 group leaks no thread;
* a REAL two-process ``gloo`` fit+serve on CPU slots is bit-identical to its
  single-process emulation, its mesh spans the processes and its
  cross-process reshard hands each rank exactly the fit's windows;
* ``HostFleet`` fails over, refuses when every host is gone and passes a
  remote error through; the in-process host-loss drill answers every
  request equal to the oracle; a re-anchor under full wire windows drops
  nothing;
* a spanning mesh built from explicit ranks refuses every consumer that
  would compute on another process's slot, typed, ``ServingEngine``
  included; the ``_Resharder`` on it materialises exactly this process's
  windows of a scaler the JAX package saved ``data@dim0``;
* a port ``serve-host`` serves the JAX drill's checkpoint with the JAX
  ``StandardScalerModel``'s answers.

Multi-process tests carry the ``dist`` marker, and every spawned process
has a timeout.
"""

import json
import os
import subprocess
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.core.ingest import host_shards as jax_host_shards
from keystone_tpu.workloads import multihost as jmh
from keystone_tpu_torch.core import autoshard
from keystone_tpu_torch.core import frontend as kfrontend
from keystone_tpu_torch.core import serve as kserve
from keystone_tpu_torch.core import telemetry as ktelemetry
from keystone_tpu_torch.core import wire
from keystone_tpu_torch.core.checkpoint import load_pipeline
from keystone_tpu_torch.core.ingest import host_shards
from keystone_tpu_torch.core.pipeline import Cacher
from keystone_tpu_torch.core.resilience import DeadlineExceeded, counters
from keystone_tpu_torch.ops.stats import StandardScalerModel
from keystone_tpu_torch.parallel import distributed as kdist
from keystone_tpu_torch.parallel import mesh as kmesh
from keystone_tpu_torch.solvers.block import BlockLeastSquaresEstimator
from keystone_tpu_torch.workloads import multihost
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture
def clean_group():
    """Tests that form a (membership-only) group must never leak it into
    the rest of the suite."""
    assert not kdist.is_initialized(), "a prior test leaked a process group"
    yield
    kdist.shutdown_process_group()


@pytest.fixture
def postmortem_room():
    """The postmortem cap is per kind and per process: earlier tests of this
    process may have used it up, so the drill's own dumps get room."""
    with ktelemetry._pm_lock:
        for kind in ("host_reanchor", "fleet_host_lost", "mesh_reanchor"):
            ktelemetry._pm_counts.pop(kind, None)


def _run_script(script: str, timeout: float = 120.0) -> dict:
    env = dict(os.environ, PYTHONPATH=_REPO)
    res = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=timeout, env=env, cwd=_REPO)
    assert res.returncode == 0, (res.stdout + res.stderr)[-2000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


# -- inert single-process discipline ------------------------------------------


class TestInertWithoutAGroup:
    def test_process_count_and_index_answer_solo(self):
        assert not kdist.is_initialized()
        assert kdist.process_count() == 1
        assert kdist.process_index() == 0

    def test_shutdown_is_idempotent_noop(self):
        assert kdist.shutdown_process_group() == []

    def test_init_with_nothing_configured_is_inert(self, clean_group):
        st = kdist.init_process_group()
        assert (st.world, st.rank, st.process_group) == (1, 0, False)

    def test_inert_path_touches_no_torch_distributed(self):
        """Without ``KEYSTONE_DIST_*`` nothing imports torch at all, so no
        ``torch.distributed`` can be touched; the module imports no jax."""
        env_off = "".join(f"os.environ.pop({k!r}, None)\n" for k in (
            kdist.COORD_ENV, kdist.PROCS_ENV, kdist.RANK_ENV, kdist.LOCAL_SLOTS_ENV))
        rec = _run_script(
            "import json, os, sys\n" + env_off +
            "import numpy as np\n"
            "from keystone_tpu_torch.parallel import distributed as d\n"
            "st = d.init_process_group()\n"
            "x = np.arange(3, dtype=np.float32)\n"
            "out = d.deterministic_allreduce(x)\n"
            "d.barrier('inert')\n"
            "print(json.dumps({'world': d.process_count(), 'rank': d.process_index(),\n"
            "    'same': bool((out == x).all()),\n"
            "    'gather': d.all_gather_object(7), 'leaked': d.shutdown_process_group(),\n"
            "    'mods': [m for m in sys.modules if m == 'torch' or m.startswith('torch.')\n"
            "             or m == 'jax' or m.startswith('jax.')]}))\n")
        assert (rec["world"], rec["rank"], rec["same"]) == (1, 0, True)
        assert rec["gather"] == [7] and rec["leaked"] == []
        assert rec["mods"] == []


# -- shard partitioning and the fit math --------------------------------------


class TestHostShards:
    @pytest.mark.parametrize("n,rank,world", [(7, 0, 3), (7, 1, 3), (7, 2, 3), (4, 1, 2),
                                              (3, 0, 1), (2, 1, 4)])
    def test_equals_the_jax_function(self, n, rank, world):
        paths = [f"/data/shard_{i:03d}.tar" for i in range(n)][::-1]
        assert host_shards(paths, rank, world) == jax_host_shards(paths, rank, world)

    def test_partition_is_disjoint_and_covers(self):
        paths = [f"/data/shard_{i:03d}.tar" for i in range(7)]
        got = [host_shards(paths, r, 3) for r in range(3)]
        assert sorted(p for g in got for p in g) == sorted(paths)
        assert [len(g) for g in got] == [3, 2, 2]

    def test_world_one_returns_all_sorted(self):
        assert host_shards(["b.tar", "a.tar"]) == ["a.tar", "b.tar"]

    def test_rank_out_of_world_is_typed(self):
        with pytest.raises(ValueError, match="outside world"):
            host_shards(["a.tar"], 3, 2)


def _packed(feats):
    return np.concatenate([feats.sum(axis=0, dtype=np.float32),
                           (feats * feats).sum(axis=0, dtype=np.float32),
                           [np.float32(len(feats))]])


@pytest.mark.parametrize("case", ["random", "degenerate"])
def test_fit_from_moments_is_the_jax_functions_bits(case):
    rng = np.random.default_rng(42)
    feats = rng.normal(size=(40, multihost.FEAT_DIM)).astype(np.float32)
    if case == "degenerate":
        feats[:, 3] = 12.0  # a constant column: the std guard gives 1.0
    packed = _packed(feats)
    mean, std = multihost.fit_from_moments(packed)
    jmean, jstd = jmh.fit_from_moments(packed)
    assert mean.dtype == std.dtype == np.float32
    assert np.array_equal(mean, jmean) and np.array_equal(std, jstd)
    np.testing.assert_allclose(mean, feats.mean(axis=0), rtol=1e-5, atol=1e-6)
    if case == "degenerate":
        assert std[3] == 1.0
    else:
        np.testing.assert_allclose(std, feats.std(axis=0, ddof=1), rtol=1e-3)


def test_moments_for_shards_match_the_jax_package(tmp_path):
    """The same tars through both packages' ingest and features: sums
    within rtol 1e-6 (per-image means reduce in another order), counts
    equal."""
    paths = multihost.make_shard_tars(str(tmp_path), 2, 5, seed=3)
    jpaths = jmh.make_shard_tars(str(tmp_path / "jax"), 2, 5, seed=3)
    for a, b in zip(paths, jpaths, strict=True):  # the JAX package's bytes
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
    got = multihost.moments_for_shards(paths, batch=4, device="cpu")
    want = jmh.moments_for_shards(paths, batch=4)
    assert got[-1] == want[-1] == 10
    np.testing.assert_allclose(got[:-1], want[:-1], rtol=1e-6)


# -- fleet membership (reform_group) ------------------------------------------


class TestReformGroup:
    def test_reform_reduces_world_and_counts(self, clean_group):
        kdist.init_process_group(coordinator="controller", world=3, rank=1, use_torch=False)
        before = counters.get("dist_reform")
        new = kdist.reform_group([0, 1])
        assert (new.world, new.rank, new.epoch) == (2, 1, 1)
        assert new.lost == (2,)
        assert not new.process_group
        assert counters.get("dist_reform") - before == 1
        assert kdist.process_count() == 2

    def test_survivor_set_must_contain_self(self, clean_group):
        kdist.init_process_group(coordinator="controller", world=2, rank=1, use_torch=False)
        with pytest.raises(ValueError, match="not among survivors"):
            kdist.reform_group([0])

    def test_reform_without_group_is_typed(self):
        with pytest.raises(RuntimeError, match="no process group"):
            kdist.reform_group([0])


# -- bring-up hardening (typed faults, counted) -------------------------------


class TestBringUpHardening:
    def test_eaddrinuse_retries_then_succeeds_counted(self, clean_group, monkeypatch):
        calls = {"n": 0}

        def flaky_join(coordinator, world, rank, timeout_s):
            calls["n"] += 1
            if calls["n"] <= 2:
                # torch's own wording (DistNetworkError) for a taken port
                raise RuntimeError(
                    "The server socket has failed to listen on any local network "
                    "address. port: 1, useIpv6: false, code: -98, name: EADDRINUSE, "
                    "message: address already in use")

        monkeypatch.setattr(kdist, "_join", flaky_join)
        before = counters.get("dist_port_retry")
        st = kdist.init_process_group(coordinator="127.0.0.1:1", world=2, rank=0,
                                      join_timeout_s=5.0, port_retries=4)
        assert st.process_group and calls["n"] == 3
        assert counters.get("dist_port_retry") - before == 2

    def test_eaddrinuse_on_nonzero_rank_propagates(self, clean_group, monkeypatch):
        """Only the coordinator owns the port; a joiner seeing the error
        must not spin on it."""

        def always_in_use(coordinator, world, rank, timeout_s):
            raise RuntimeError("Address already in use")

        monkeypatch.setattr(kdist, "_join", always_in_use)
        with pytest.raises(RuntimeError, match="already in use"):
            kdist.init_process_group(coordinator="127.0.0.1:1", world=2, rank=1,
                                     join_timeout_s=5.0, port_retries=4)

    def test_join_timeout_is_typed_and_counted(self, clean_group, monkeypatch):
        def never_joins(coordinator, world, rank, timeout_s):
            raise RuntimeError("Timed out after 7 seconds waiting for clients. 1/2 clients joined.")

        monkeypatch.setattr(kdist, "_join", never_joins)
        before = counters.get("dist_join_timeout")
        with pytest.raises(DeadlineExceeded) as ei:
            kdist.init_process_group(coordinator="127.0.0.1:1", world=2, rank=1,
                                     join_timeout_s=2.0)
        assert "dist_join[1/2]" in str(ei.value)
        assert counters.get("dist_join_timeout") - before == 1
        assert not kdist.is_initialized()

    @pytest.mark.dist
    def test_real_eaddrinuse_message_is_matched_and_retried(self):
        """A coordinator port held by another socket: torch's real bind
        error is matched by ``is_addr_in_use``, retried on rank 0 and
        counted, then raised as itself."""
        rec = _run_script(
            "import json, socket\n"
            "from keystone_tpu_torch.core.resilience import counters, is_addr_in_use\n"
            "from keystone_tpu_torch.parallel import distributed as kdist\n"
            "s = socket.socket(); s.bind(('127.0.0.1', 0)); s.listen()\n"
            "coord = '127.0.0.1:%d' % s.getsockname()[1]\n"
            "try:\n"
            "    kdist.init_process_group(coord, 2, 0, join_timeout_s=20.0, port_retries=2)\n"
            "    out = {'raised': False}\n"
            "except Exception as e:\n"
            "    out = {'raised': True, 'matched': is_addr_in_use(e), 'msg': str(e)[:300],\n"
            "           'retries': counters.get('dist_port_retry')}\n"
            "print(json.dumps(out))\n")
        assert rec["raised"] and rec["matched"], rec
        assert rec["retries"] == 2

    @pytest.mark.dist
    @pytest.mark.parametrize("rank", [0, 1], ids=["missing_peer", "dead_coordinator"])
    def test_join_deadline_is_typed_in_a_real_process(self, rank):
        """Rank 0 whose peer never arrives blocks in the TCP store waiting
        for it; rank 1 whose coordinator is dead blocks connecting.  Both
        must come back typed and counted within the budget, never torch's
        own (later) timeout."""
        rec = _run_script(
            "import json, sys, time\n"
            "from keystone_tpu_torch.core.resilience import DeadlineExceeded, counters\n"
            "from keystone_tpu_torch.parallel import distributed as kdist\n"
            "t0 = time.monotonic()\n"
            "try:\n"
            f"    kdist.init_process_group(kdist.pick_coordinator(), 2, {rank}, "
            "join_timeout_s=2.0)\n"
            "except DeadlineExceeded as e:\n"
            "    print(json.dumps({'typed': True, 'phase': str(e), "
            "'wall_s': time.monotonic() - t0, 'counted': counters.get('dist_join_timeout')}))\n"
            "    sys.exit(0)\n"
            "sys.exit(3)\n",
            timeout=60.0)
        assert rec["typed"] and rec["counted"] >= 1
        assert f"dist_join[{rank}/2]" in rec["phase"]
        assert rec["wall_s"] < 30.0, "the deadline did not bound the join"

    @pytest.mark.dist
    def test_shutdown_leaks_no_threads(self):
        """A real world-1 ``gloo`` group, destroyed: no thread it started
        is left alive."""
        rec = _run_script(
            "import json\n"
            "from keystone_tpu_torch.parallel import distributed as kdist\n"
            "st = kdist.init_process_group(kdist.pick_coordinator(), 1, 0, join_timeout_s=30.0)\n"
            "import torch.distributed as dist\n"
            "assert st.process_group and dist.get_world_size() == 1\n"
            "print(json.dumps({'leaked': kdist.shutdown_process_group(),\n"
            "                  'after': dist.is_initialized()}))\n")
        assert rec["leaked"] == [] and rec["after"] is False


# -- the tentpole: 2-process fit+serve, bit-identical -------------------------


@pytest.mark.dist
def test_two_process_fit_serve_bit_identical_to_single(tmp_path):
    """A REAL 2-process ``gloo`` fit+serve on CPU slots (per-process tar
    shards through core.ingest, rank-ordered aggregation, cross-process
    checkpoint reshard) gives the single-process run's bits."""
    j = multihost.run_two_process_fit_serve(str(tmp_path), device="cpu", timeout_s=240.0)
    assert j["bit_identical"], {k: j["records"][k].get("mean") for k in ("ref", 0, 1)}
    assert j["mesh_spans"], "the global mesh never spanned processes"
    assert j["crosshost_reshard"] >= 1, "load_pipeline(mesh=) never pulled per process"
    assert j["crosshost_bit_equal"], "a resharded window's bytes differ from the fit's"
    assert j["leaked_threads"] == []
    assert j["parity_ok"]
    assert j["n_images"] == 24  # both fits saw every shard exactly once
    r0, r1 = j["records"][0], j["records"][1]
    assert r0["global_mesh"] == r1["global_mesh"] == "4x1"
    assert r0["crosshost_windows"] == r1["crosshost_windows"] == 4  # mean + std, 2 slots
    assert sorted(r0["my_shards"] + r1["my_shards"]) == [f"shard_{i:03d}.tar" for i in range(4)]
    # Each process counts its own launches; on CPU tensors no wrapper
    # launches a kernel.
    assert j["kernel_launches"] == {"conv_rect_pool": 0, "fv_stats": 0, "decode_pixels": 0}
    assert all("kernel_launches" in r for r in j["records"].values())


# -- host fleet front-end ------------------------------------------------------


class _Ready:
    """Already-resolved future (the wire server awaits ``result``)."""

    def __init__(self, value):
        self._value = value

    def result(self, timeout=None):
        return self._value


class _Doubler:
    def submit(self, arr):
        return _Ready(np.asarray(arr) * 2.0)

    def record(self):
        return {}


class TestHostFleet:
    def test_failover_reissues_and_counts(self):
        s0 = wire.WireServer(_Doubler(), port=0, label="fleet_a")
        s1 = wire.WireServer(_Doubler(), port=0, label="fleet_b")
        try:
            with kfrontend.HostFleet([("127.0.0.1", s0.port), f"127.0.0.1:{s1.port}"],
                                     label="t_fleet") as fleet:
                rows = [np.full(4, float(i), np.float32) for i in range(6)]
                for r in rows[:2]:
                    np.testing.assert_array_equal(np.asarray(fleet.predict(r)), r * 2.0)
                before = counters.get("fleet_host_lost")
                s1.close()  # abrupt: sockets die under the clients
                for r in rows[2:]:
                    np.testing.assert_array_equal(np.asarray(fleet.predict(r)), r * 2.0)
                assert counters.get("fleet_host_lost") - before == 1
                rec = fleet.record()
                assert len(fleet.alive_hosts()) == 1 and rec["lost_hosts"] == 1
                assert sum(h["reissued"] for h in rec["hosts"]) >= 1
                # A restarted member is re-admitted and serves again.
                s2 = wire.WireServer(_Doubler(), port=0, label="fleet_c")
                try:
                    fleet.reattach(("127.0.0.1", s2.port))
                    assert len(fleet.alive_hosts()) == 2
                    for r in rows:
                        np.testing.assert_array_equal(np.asarray(fleet.predict(r)), r * 2.0)
                finally:
                    s2.close()
        finally:
            s0.close()
            s1.close()

    def test_all_hosts_down_is_typed(self):
        s0 = wire.WireServer(_Doubler(), port=0, label="fleet_solo")
        with kfrontend.HostFleet([("127.0.0.1", s0.port)], label="t_fleet_down") as fleet:
            s0.close()
            with pytest.raises(kfrontend.ServingUnavailable):
                fleet.predict(np.zeros(4, np.float32))

    def test_remote_typed_errors_pass_through_not_failover(self):
        """A typed remote answer (the server computed and refused) reaches
        the caller — it is an answer, not a host death."""

        class Refuser:
            def submit(self, arr):
                raise ValueError("typed refusal from the engine")

            def record(self):
                return {}

        s0 = wire.WireServer(Refuser(), port=0, label="fleet_refuse")
        try:
            with kfrontend.HostFleet([("127.0.0.1", s0.port)],
                                     label="t_fleet_refuse") as fleet:
                with pytest.raises(wire.WireRemoteError, match="ValueError"):
                    fleet.predict(np.zeros(4, np.float32))
                assert len(fleet.alive_hosts()) == 1  # NOT marked lost
        finally:
            s0.close()


# -- host-loss drill (the in-process face; the chaos family drives both) ------


def test_host_loss_drill_inprocess_zero_loss_bit_equal(tmp_path, clean_group, postmortem_room):
    rec = multihost.run_host_loss_drill(str(tmp_path), subprocess_mode=False, requests=16,
                                        device="cpu", timeout_s=120.0)
    assert rec["dropped_requests"] == 0
    assert rec["mismatches"] == 0
    assert rec["errors"] == []
    sc = rec["survivor_counters"][0]
    assert sc.get("fleet_host_lost", 0) >= 1
    assert sc.get("dist_reform", 0) >= 1
    assert sc.get("host_reanchor", 0) >= 1
    assert any("host_reanchor" in p for p in rec["postmortems"])


def test_host_loss_drill_inprocess_counts_its_own_and_keeps_callers_group(
        tmp_path, clean_group, postmortem_room):
    """Run twice in one process, under a group the caller formed: each
    survivor's counts are what that drill added (one re-form, its own
    re-anchor), and the caller's group outlives the drill."""
    kdist.init_process_group(coordinator="controller", world=2, rank=0, use_torch=False)
    for attempt in range(2):
        rec = multihost.run_host_loss_drill(str(tmp_path / str(attempt)), subprocess_mode=False,
                                            requests=8, device="cpu", timeout_s=120.0)
        assert rec["dropped_requests"] == 0 and rec["mismatches"] == 0
        sc = rec["survivor_counters"][0]
        assert sc["dist_reform"] == 1 and sc["host_reanchor"] == 1, sc
        assert sc["mesh_reanchor"] == 1, sc
        assert rec["kernel_launches"] == {"conv_rect_pool": 0, "fv_stats": 0,
                                          "decode_pixels": 0}
        assert kdist.is_initialized(), "the drill shut down the caller's group"


# -- reanchor under live wire traffic, windows full ---------------------------


def test_reanchor_under_live_wire_traffic_full_windows():
    """The swap happens while wire clients keep the server's per-client
    in-flight window FULL: backpressure answers RETRY_AFTER (clients
    absorb and resubmit), the re-anchor swaps engines underneath, and every
    request is answered equal to the offline apply — zero dropped."""
    rng = np.random.default_rng(42)
    model = StandardScalerModel(
        torch.from_numpy(rng.normal(size=8).astype(np.float32)),
        torch.from_numpy((np.abs(rng.normal(size=8)) + 0.5).astype(np.float32)))
    full = kmesh.make_mesh(2, 1, devices=[CPU] * 2)
    surviving = kmesh.make_mesh(2, 1, devices=[CPU] * 2)

    def build(shape, dtype, mesh):
        return kserve.ServingEngine(
            model, np.zeros(shape, dtype),
            config=kserve.ServeConfig(buckets=(1, 2, 4), max_wait_ms=2.0),
            label="wire_swap", mesh=mesh, device="cpu")

    factory = kfrontend.MeshEngineFactory(build, mesh=full)
    router = kfrontend.ShapeRouter(factory, label="wire_swap")
    router.add_engine(factory((8,), np.float32))
    n_clients, per_client = 3, 20
    rows = np.asarray(rng.normal(size=(n_clients * per_client, 8)), np.float32)
    expected = model(torch.from_numpy(rows)).numpy()
    answers: dict = {}
    errors: list = []
    server = wire.WireServer(router, port=0, max_inflight=2, retry_after_s=0.005,
                             label="wire_swap")
    try:
        def client(c):
            idx = list(range(c * per_client, (c + 1) * per_client))
            try:
                cl = wire.WireClient("127.0.0.1", server.port)
                try:
                    # window 8 >> max_inflight 2: RETRY_AFTER is the steady state.
                    got = cl.predict_many([rows[i] for i in idx], window=8, timeout=60.0)
                finally:
                    cl.close()
                for i, g in zip(idx, got):
                    answers[i] = np.asarray(g)
            except Exception as e:  # noqa: BLE001 — judged below
                errors.append(f"client{c}: {type(e).__name__}: {e}")

        threads = [threading.Thread(target=client, args=(c,), daemon=True)
                   for c in range(n_clients)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 30.0
        while server.stats.requests < n_clients * 2:
            assert time.monotonic() < deadline, "traffic never started"
            time.sleep(0.002)
        rec = router.reanchor(surviving, why="test: swap under full windows")
        for t in threads:
            t.join(60.0)
        assert not any(t.is_alive() for t in threads)
    finally:
        server.close()
        router.close()
    assert errors == []
    assert len(answers) == len(rows), f"dropped {len(rows) - len(answers)} request(s)"
    got = np.stack([answers[i] for i in range(len(rows))])
    np.testing.assert_array_equal(got, expected)
    assert rec["failed"] == [] and len(rec["swapped"]) == 1
    assert server.stats.retry_after >= 1, "the in-flight window never filled"


# -- the process-spanning mesh, built from explicit ranks ---------------------


def _spanning(me: int = 1):
    """4 CPU slots, two per process; this process is rank ``me``."""
    return kmesh.make_mesh(4, 1, devices=[CPU] * 4, ranks=[0, 0, 1, 1], me=me)


def test_spanning_mesh_from_explicit_ranks():
    g = _spanning(1)
    assert kmesh.mesh_spans_processes(g) and g.local_slots() == [(2, 0), (3, 0)]
    local = kmesh.host_local_mesh(g)
    assert kmesh.mesh_desc(local) == "2x1" and not kmesh.mesh_spans_processes(local)
    assert not kmesh.mesh_spans_processes(kmesh.make_mesh(4, 1, devices=[CPU] * 4))
    mine = kmesh.make_mesh(2, 1, devices=[CPU] * 2, ranks=[1, 1], me=1)
    assert not kmesh.mesh_spans_processes(mine)
    with pytest.raises(ValueError, match="no slots on process 5"):
        kmesh.host_local_mesh(_spanning(5))
    rows = autoshard.spec_sharding("data@dim0", g, 2).place(torch.arange(16.0).reshape(8, 2))
    assert rows.shape == (8, 2) and rows.shards[0] == [None] and rows.shards[1] == [None]
    wins = [(slot, idx[0].start, idx[0].stop, t.tolist()) for slot, idx, t in
            rows.addressable_shards()]
    assert wins == [((2, 0), 4, 6, [[8.0, 9.0], [10.0, 11.0]]),
                    ((3, 0), 6, 8, [[12.0, 13.0], [14.0, 15.0]])]
    assert kmesh.slot_nbytes(rows).tolist() == [[0], [0], [16], [16]]


def _consumers():
    g = _spanning(1)
    t = torch.arange(8.0).reshape(4, 2)
    rows = autoshard.spec_sharding("data@dim0", g, 2).place(t)
    layout = autoshard.spec_sharding("replicated", g, 2).place(t)
    node = StandardScalerModel(autoshard.spec_sharding("data@dim0", g, 1).place(t[:, 0]), None)
    return {
        "gather": lambda: rows.gather(),
        "apply": lambda: rows.apply(lambda x: x + 1),
        "map_rows": lambda: kmesh.map_rows(lambda x: x + 1, rows),
        "unshard": lambda: kmesh.unshard(rows),
        "replicate": lambda: kmesh.replicate(node, CPU),
        "window": lambda: layout.gather(),
        "padded_shard_rows": lambda: kmesh.padded_shard_rows(t, g),
        "bcd_mesh_tier": lambda: BlockLeastSquaresEstimator(2, 1, 0.1, mesh=g).fit(
            t, torch.ones(4, 2)),
        "cacher": lambda: Cacher(sharding=autoshard.spec_sharding("data@dim0", g, 2))(t),
    }


@pytest.mark.parametrize("consumer", list(_consumers()))
def test_spanning_mesh_consumers_refuse_typed(consumer):
    with pytest.raises(kmesh.SpanningMeshError, match="mesh 4x1 spans processes"):
        _consumers()[consumer]()


def test_serving_engine_refuses_a_spanning_mesh():
    model = StandardScalerModel(torch.zeros(8), torch.ones(8))
    with pytest.raises(kserve.ServeError, match=r"host_local_mesh\(mesh\).*owns 2 of"):
        kserve.ServingEngine(model, np.zeros(8, np.float32), label="span",
                             mesh=_spanning(0), device="cpu")


def test_resharder_materialises_this_process_windows_of_a_jax_checkpoint(tmp_path):
    """The JAX package's drill checkpoint (mean ``data@dim0`` over 4
    devices) onto a spanning mesh where this process owns slots 2 and 3:
    exactly those windows are placed, bit-equal to the array's windows,
    counted ``ckpt_reshard_crosshost``."""
    mean, std, _ = jmh._drill_model(0)
    stem = jmh._drill_ckpt(str(tmp_path), 0, mean, std)
    before = counters.get("ckpt_reshard_crosshost")
    stats: dict = {}
    resumed = load_pipeline(stem, mesh=_spanning(1), report=stats)
    assert counters.get("ckpt_reshard_crosshost") - before == 1
    assert stats["crosshost"] == stats["arrays"] == 2
    assert resumed.mean.shards[0] == [None] and resumed.mean.shards[1] == [None]
    shards = resumed.mean.addressable_shards()
    assert [(s, i[0].start, i[0].stop) for s, i, _ in shards] == [((2, 0), 4, 6),
                                                                   ((3, 0), 6, 8)]
    for _slot, idx, t in shards:
        assert np.array_equal(t.numpy(), np.asarray(mean)[idx])
    for _slot, idx, t in resumed.std.addressable_shards():
        assert np.array_equal(t.numpy(), np.asarray(std)[idx])


@pytest.mark.dist
def test_port_serve_host_serves_the_jax_drill_checkpoint(tmp_path):
    """A port ``serve-host`` worker restores the JAX drill's checkpoint onto
    its host-local mesh and answers over the wire exactly what the JAX
    ``StandardScalerModel`` computes on the same rows."""
    mean, std, jmodel = jmh._drill_model(0)
    stem = jmh._drill_ckpt(str(tmp_path), 0, mean, std)
    rows = np.asarray(np.random.default_rng(5).normal(size=(6, 8)), np.float32)
    want = np.asarray(jmodel(jnp.asarray(rows)))
    env = multihost._hermetic_env(kdist.worker_env(0, 1, "controller", device="cpu"),
                                  str(tmp_path), "jax_ckpt")
    w = multihost._WorkerIO(
        multihost._worker_cmd("serve-host", ["--ckpt", stem, "--device", "cpu"]), env,
        str(tmp_path / "host.err"))
    try:
        port = w.expect("port", 60.0)["port"]
        cl = wire.WireClient("127.0.0.1", port)
        try:
            got = np.stack([np.asarray(cl.predict(r, timeout=30.0)) for r in rows])
        finally:
            cl.close()
        w.send("quit")
        final = w.expect("final", 30.0)["final"]
    finally:
        rc = w.finish()
    assert rc == 0
    assert final["counters"].get("ckpt_reshard", 0) >= 1
    np.testing.assert_array_equal(got, want)
