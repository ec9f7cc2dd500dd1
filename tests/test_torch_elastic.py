"""Serving on a mesh of slots in the port (``keystone_tpu_torch.core.serve``
``ServingEngine(mesh=)`` and ``load_engine(mesh=)``, ``core.frontend``
``MeshEngineFactory``, ``ShapeRouter(mesh=)`` and ``ShapeRouter.reanchor``),
held to the serving half of ``tests/test_elastic.py`` and to the JAX
package's engines:

* a StandardScaler fitted by the JAX package under a 4-device mesh, its mean
  anchored ``data@dim0``, resumes through ``load_engine(mesh=)`` onto 2 and
  1 CPU slots and serves (``infer`` and a ``Server``) answers
  ``np.array_equal`` to the JAX engine's on 2 and 1 of the conftest's
  devices;
* a router anchored on 4 slots re-anchors onto 2 with requests in flight:
  every answer equal to the JAX engine's, the label swapped to
  ``elastic@2x1``, the record's mesh and ``reshard_wall_s``;
* the factory steps down, counted ``router_mesh_stepdown``, when every mesh
  bucket is denied per slot;
* after a re-anchor the cross-engine admission consults ``min_chip_budget``
  of the surviving mesh and denies at a 64-byte budget;
* ``--serveMesh`` resolves over the one CPU, or raises the JAX function's
  ``ValueError``.

The three router cases serve the same ``max(x * 1.5, 0.25)`` pipe in both
packages; inputs are seeded numpy.  The port's slots are entries of
``make_mesh(d, m, devices=[cpu] * (d * m))``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from keystone_tpu.core import checkpoint as jck
from keystone_tpu.core import serve as jserve
from keystone_tpu.core.pipeline import FunctionTransformer as JaxFunction
from keystone_tpu.ops.stats import StandardScaler as JaxScaler
from keystone_tpu.parallel import mesh as jmesh
from keystone_tpu_torch.core import frontend as kfrontend
from keystone_tpu_torch.core import memory as kmem
from keystone_tpu_torch.core import serve as kserve
from keystone_tpu_torch.core.pipeline import FunctionTransformer
from keystone_tpu_torch.core.resilience import counters
from keystone_tpu_torch.parallel.mesh import make_mesh, mesh_desc
from keystone_tpu_torch.workloads import serve_common
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401

CPU = torch.device("cpu")
WIDTH = 16
BUCKETS = (1, 2, 4)


def slots(data: int, model: int = 1):
    return make_mesh(data, model, devices=[CPU] * (data * model))


def _config():
    return kserve.ServeConfig(buckets=BUCKETS, max_wait_ms=2.0)


def _jax_stem(tmp_path, rng, devices):
    """``tests/test_elastic.py``'s fit: a JAX StandardScaler fitted on 32
    rows sharded over 4 devices, its mean anchored ``data@dim0``.  Returns
    (stem, the 12 test rows)."""
    x = jnp.asarray(rng.normal(size=(32, WIDTH)), jnp.float32)
    full = jmesh.make_mesh(data=4, model=1, devices=devices[:4])
    with jmesh.use_mesh(full):
        model = JaxScaler().fit(jax.device_put(x, jmesh.row_sharding(full)))
        model.mean = jax.device_put(model.mean, NamedSharding(full, PartitionSpec("data")))
        stem = jck.save_pipeline(str(tmp_path / "elastic"), model)
    return stem, np.asarray(rng.normal(size=(12, WIDTH)), np.float32)


@pytest.mark.parametrize("survivors", (2, 1))
def test_resume_and_serve_on_smaller_mesh_bit_equal(tmp_path, rng, devices, survivors):
    stem, test_rows = _jax_stem(tmp_path, rng, devices)
    jax_engine, _ = jserve.load_engine(
        stem, np.zeros(WIDTH, np.float32),
        config=jserve.ServeConfig(buckets=BUCKETS, max_wait_ms=2.0),
        label=f"jax_elastic_{survivors}",
        mesh=jmesh.make_mesh(data=survivors, model=1, devices=devices[:survivors]))
    want = np.asarray(jax_engine.infer(test_rows))

    before = counters.get("ckpt_reshard")
    engine, cold = kserve.load_engine(
        stem, np.zeros(WIDTH, np.float32), config=_config(),
        label=f"elastic_{survivors}", mesh=slots(survivors))
    assert counters.get("ckpt_reshard") - before >= 1
    assert cold["mesh"] == engine.record()["mesh"] == f"{survivors}x1"
    assert engine.parity_ok and engine.buckets() == BUCKETS, engine.parity
    np.testing.assert_array_equal(engine.offline(test_rows), want)
    np.testing.assert_array_equal(engine.infer(test_rows), want)
    with kserve.Server(engine) as server:
        served = np.stack([f.result(30.0) for f in [server.submit(r) for r in test_rows]])
    np.testing.assert_array_equal(served, want)


def _relu_build():
    pipe = FunctionTransformer(lambda x: torch.maximum(x * 1.5, torch.tensor(0.25)),
                               name="elastic")

    def build(shape, dtype, mesh):
        return kserve.ServingEngine(pipe, np.zeros(shape, dtype), config=_config(),
                                    label="elastic", mesh=mesh, device="cpu")

    return build


def _jax_relu_answers(devices, reqs: np.ndarray) -> np.ndarray:
    """The JAX engine's answers on 4 of the conftest's devices."""
    pipe = JaxFunction(lambda x: jnp.maximum(x * 1.5, 0.25), name="elastic")
    engine = jserve.ServingEngine(
        pipe, np.zeros(WIDTH, np.float32),
        config=jserve.ServeConfig(buckets=BUCKETS, max_wait_ms=2.0), label="jax_elastic",
        mesh=jmesh.make_mesh(data=4, model=1, devices=devices[:4]))
    return np.asarray(engine.infer(reqs))


def test_reanchor_swaps_labels_and_keeps_answers(devices, rng):
    full, surviving = slots(4), slots(2)
    factory = kfrontend.MeshEngineFactory(_relu_build(), mesh=full)
    router = kfrontend.ShapeRouter(
        factory, label="elastic_swap",
        config=kfrontend.RouterConfig(warm_threshold=1, retire_after_s=300.0))
    reqs = np.asarray(rng.normal(size=(8, WIDTH)), np.float32)
    want = _jax_relu_answers(devices, reqs)
    before = counters.get("mesh_reanchor")
    try:
        assert router.record()["mesh"] == "4x1"
        engine = factory((WIDTH,), np.float32)
        assert engine.mesh is full
        router.add_engine(engine)
        futs = [router.submit(r) for r in reqs[:4]]
        rec = router.reanchor(surviving, why="test shrink")
        futs += [router.submit(r) for r in reqs[4:]]
        got = np.stack([np.asarray(f.result(30.0)) for f in futs])
        np.testing.assert_array_equal(got, want)
        assert rec["failed"] == [] and len(rec["swapped"]) == 1
        assert router.engines()[(WIDTH,)] == f"elastic@{mesh_desc(surviving)}"
        r = router.record()
        assert r["mesh"] == mesh_desc(surviving) == "2x1"
        assert r["last_reanchor"]["reshard_wall_s"] > 0
        assert counters.get("mesh_reanchor") - before == 1
    finally:
        router.close()


def test_factory_walks_the_ladder_on_denial(monkeypatch):
    """Every mesh-tier bucket denied per slot (a 1-byte slot budget): the
    factory steps down, counted, to the meshless floor, which plans against
    ``hbm_budget`` (none here) and builds."""
    monkeypatch.setattr(kmem, "min_chip_budget", lambda m: (1, None))
    monkeypatch.setattr(kmem, "hbm_budget", lambda device=None: None)
    before = counters.get("router_mesh_stepdown")
    factory = kfrontend.MeshEngineFactory(_relu_build(), mesh=slots(2))
    engine = factory((WIDTH,), np.float32)
    assert engine.mesh is None  # landed on the floor
    assert counters.get("router_mesh_stepdown") - before >= 1


def test_cross_admission_pins_surviving_mesh_budget(monkeypatch):
    surviving = slots(2)
    factory = kfrontend.MeshEngineFactory(_relu_build(), mesh=slots(4))
    router = kfrontend.ShapeRouter(
        factory, label="elastic_admission",
        config=kfrontend.RouterConfig(warm_threshold=1, retire_after_s=300.0))
    try:
        router.add_engine(factory((WIDTH,), np.float32))
        router.reanchor(surviving, why="test shrink")
        seen = []

        def spy_min_chip_budget(m):
            seen.append(m)
            return (64, None)  # a tiny slot budget: must deny

        monkeypatch.setattr(kmem, "min_chip_budget", spy_min_chip_budget)
        # The wrong budget source, the meshless global, would admit.
        monkeypatch.setattr(kmem, "hbm_budget", lambda device=None: None)
        with pytest.raises(kfrontend.RetryLater):
            router.submit(np.zeros(8, np.float32))  # a new shape: a warm add
        assert surviving in seen, "cross-engine admission never read the surviving mesh's budget"
        assert router.stats.admission_denied >= 1
        denied = router.admissions[-1]
        assert denied["admitted"] is False and denied["budget_bytes"] == 64
    finally:
        router.close()


@pytest.mark.parametrize("spec, error", [
    ("1x1", None),
    ("2x1", "needs 2 devices but this process has 1"),
    ("0x1", "expected DxM"), ("2", "expected DxM"), ("axb", "expected DxM"),
])
def test_resolve_serve_mesh_on_the_cpu(spec, error):
    """``--serveMesh`` over the one CPU, with the JAX function's messages."""
    if error is None:
        assert mesh_desc(serve_common.resolve_serve_mesh(spec, "cpu")) == spec
    else:
        with pytest.raises(ValueError, match=error):
            serve_common.resolve_serve_mesh(spec, "cpu")
