"""The ``mesh_shrink`` family of the chaos harness (``tests/chaos.py``) on the
port's serving tier, with the harness's fault parameters
(``chaos.make_schedule``) and its oracle (``chaos.ChaosOracleError``).

Leg 1, the live re-anchor: a router anchored on 4 CPU slots has requests
in flight (each batch of the doomed engine held ``hold_seconds``) when the
mesh shrinks to the schedule's survivors; ``ShapeRouter.reanchor`` must
swap the engine onto the surviving slots with every answer equal to the
offline apply, none lost, counted ``mesh_reanchor``.  Leg 2, the reshard
resume (``core.checkpoint.load_pipeline(mesh=)``): a scaler saved with its
mean split ``data@dim0`` over the 4 slots refuses the plain load with a
``CheckpointMismatch`` naming ``mesh=``, then loads onto the survivors,
counted ``ckpt_reshard``, and answers equal to the fault-free scaler.  Then,
as in the harness, the MNIST workload runs and must complete with the
fault-free run's predictions."""

import time

import numpy as np
import pytest
import torch

import chaos
from keystone_tpu_torch.core import autoshard
from keystone_tpu_torch.core import frontend as kfrontend
from keystone_tpu_torch.core import serve as kserve
from keystone_tpu_torch.core.checkpoint import CheckpointMismatch, load_pipeline, save_pipeline
from keystone_tpu_torch.core.pipeline import FunctionTransformer
from keystone_tpu_torch.core.resilience import counters
from keystone_tpu_torch.loaders.csv_loader import LabeledData
from keystone_tpu_torch.ops.stats import StandardScalerModel
from keystone_tpu_torch.parallel.mesh import make_mesh, replicate, use_mesh
from keystone_tpu_torch.workloads import mnist_random_fft as pmnist
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401

KIND = "mesh_shrink"
#: The family's schedule in the tier-1 seeds and in the full schedule.
SEEDS = (chaos.FAMILIES.index(KIND), chaos.FAMILIES.index(KIND) + len(chaos.FAMILIES))
CPU = torch.device("cpu")


def slots(data: int):
    return make_mesh(data, 1, devices=[CPU] * data)


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


def _mesh_shrink_phase(fault: chaos.Fault, tmpdir: str, seed: int) -> dict:
    """The harness's ``_mesh_shrink_phase`` on the port's modules.  Returns
    the re-anchor's record."""
    Oracle = chaos.ChaosOracleError
    rng = np.random.default_rng(seed)
    n = int(fault.params["requests"])
    survivors = int(fault.params["survivors"])
    hold = float(fault.params["hold_seconds"])
    full, surviving = slots(4), slots(survivors)

    # -- leg 1: live re-anchor with requests in flight --------------------
    wrng = np.random.default_rng(chaos._DATA_SEED)
    w = torch.from_numpy(wrng.normal(size=(16,)).astype(np.float32))
    b = torch.from_numpy(wrng.normal(size=(16,)).astype(np.float32))
    pipe = FunctionTransformer(lambda x: torch.maximum(x * w, b), name="chaos_mesh_shrink")

    def build(shape, dtype, mesh):
        cfg = kserve.ServeConfig(buckets=(1, 2, 4), max_wait_ms=2.0)
        return kserve.ServingEngine(pipe, np.zeros(shape, dtype), config=cfg,
                                    label=f"chaos_shrink_{seed}", mesh=mesh, device="cpu")

    reqs = chaos._serve_requests(rng, 2 * n)
    factory = kfrontend.MeshEngineFactory(build, mesh=full)
    router = kfrontend.ShapeRouter(
        factory, label=f"chaos_shrink_{seed}",
        config=kfrontend.RouterConfig(warm_threshold=1, retire_after_s=300.0))
    before = counters.get("mesh_reanchor")
    try:
        engine = factory((16,), np.float32)
        router.add_engine(engine)
        offline = engine.offline(reqs)
        real_execute = engine._execute

        def slow_execute(bucket, dev_batch):
            # Stretch the doomed mesh's batches so the loss lands while
            # requests are in flight.
            time.sleep(hold)
            return real_execute(bucket, dev_batch)

        engine._execute = slow_execute
        try:
            futs = [router.submit(r) for r in reqs[:n]]
            in_flight = sum(not f.done() for f in futs)
            rec = router.reanchor(surviving, why=f"chaos seed {seed}: device loss")
        finally:
            engine._execute = real_execute
        futs += [router.submit(r) for r in reqs[n:]]
        answers = np.stack([np.asarray(f.result(60.0)) for f in futs])
        mesh_after = router.record()["mesh"]
    finally:
        router.close()
    if rec["failed"]:
        raise Oracle(f"re-anchor left shapes on the dead mesh: {rec['failed']}")
    if counters.get("mesh_reanchor") - before < 1:
        raise Oracle("engines re-anchored onto the surviving mesh but no mesh_reanchor "
                     "was counted")
    if not np.array_equal(answers, offline):
        raise Oracle("answers across the re-anchor differ from the offline apply — the "
                     "surviving mesh changed RESULTS, not just placement")

    # -- leg 2: checkpoint on the full mesh, resume on the survivors ------
    mean = torch.from_numpy(wrng.normal(size=(16,)).astype(np.float32))
    std = torch.from_numpy(np.abs(wrng.normal(size=(16,)).astype(np.float32)) + 1.0)
    scaler = StandardScalerModel(autoshard.spec_sharding("data@dim0", full, 1).place(mean), std)
    test_rows = torch.from_numpy(chaos._serve_requests(rng, n))
    fault_free = StandardScalerModel(mean, std)(test_rows)
    with use_mesh(full):
        stem = save_pipeline(f"{tmpdir}/chaos_shrink_{seed}_ckpt", scaler)
    try:
        load_pipeline(stem, device="cpu")
    except CheckpointMismatch as e:
        if "mesh=" not in str(e):
            raise Oracle(f"the topology refusal does not name the mesh= reshard path: {e}")
    else:
        raise Oracle("a checkpoint holding full-mesh-sharded arrays loaded silently onto "
                     "a different topology")
    before_rs = counters.get("ckpt_reshard")
    resumed = load_pipeline(stem, mesh=surviving)
    if counters.get("ckpt_reshard") - before_rs < 1:
        raise Oracle("the checkpoint resumed on the surviving mesh but no ckpt_reshard "
                     "was counted")
    if not torch.equal(replicate(resumed, CPU)(test_rows), fault_free):
        raise Oracle("predictions resumed on the surviving mesh differ from the fault-free "
                     "full-mesh run")
    return {**rec, "in_flight": in_flight, "router_mesh": mesh_after}


@pytest.mark.parametrize("seed", SEEDS)
def test_mesh_shrink_is_equal_or_typed(seed, mnist_case, tmp_path):
    fault = chaos.make_schedule(seed)
    assert fault.kind == KIND
    run, baseline = mnist_case
    t0 = time.monotonic()
    rec = _mesh_shrink_phase(fault, str(tmp_path), seed)
    survivors = int(fault.params["survivors"])
    assert rec["mesh"] == rec["router_mesh"] == f"{survivors}x1"
    assert len(rec["swapped"]) == 1 and rec["in_flight"] > 0
    outcome = ("completed_equal" if np.array_equal(run()["test_predictions"], baseline)
               else "SILENT_WRONG_MODEL")
    assert outcome == chaos.expected_outcome(fault), outcome
    assert time.monotonic() - t0 < 60.0
