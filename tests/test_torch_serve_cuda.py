"""The serving engine's CUDA graphs on the card (``core.serve``).

This file imports neither JAX nor the JAX package, so the card tests run on
a machine without them:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_serve_cuda.py``.
Tests that need the card carry the ``cuda`` marker and skip without one.

Bars: every bucket is a captured graph that recorded its chain's hand
kernels; a replay is ``torch.equal`` to the eager chain at that batch on
the same input, for a K1 chain (``FusedConvFeaturizer`` ->
``conv_rect_pool``) and a K2 chain (SIFT -> PCA -> Fisher features through
``fv_stats``); capture works with the profiler and the numerics
observatory on; a second engine is captured and warmed while another one
answers traffic, with no request lost; a chain that cannot be captured
raises ``ServeError`` naming the bucket."""

import threading

import numpy as np
import pytest
import torch

from keystone_tpu_torch.core import frontend
from keystone_tpu_torch.core import numerics as knum
from keystone_tpu_torch.core import profiler as kprof
from keystone_tpu_torch.core import serve as kserve
from keystone_tpu_torch.core.pipeline import FunctionTransformer, Pipeline
from keystone_tpu_torch.ops import fv_stats as fs
from keystone_tpu_torch.ops import rect_pool as rp
from keystone_tpu_torch.ops.conv_fused import FusedConvFeaturizer
from keystone_tpu_torch.ops.stats import StandardScaler
from keystone_tpu_torch.ops.util import MaxClassifier
from keystone_tpu_torch.solvers.gmm import GaussianMixtureModel
from keystone_tpu_torch.solvers.linear import LinearMapper
from keystone_tpu_torch.solvers.pca import BatchPCATransformer
from keystone_tpu_torch.utils.platform import resolve_device
from keystone_tpu_torch.workloads import voc_sift_fisher as pt_voc
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401


BUCKETS = (1, 4, 16)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc) to build, capture and replay the kernels")
    kprof.reset_state()
    yield resolve_device("cuda")
    kprof.reset_state()


def _cifar_chain(device, seed=0, filters=16):
    rng = np.random.default_rng(seed)
    feat = FusedConvFeaturizer(
        rng.normal(size=(filters, 108)).astype(np.float32), rng.normal(size=108).astype(np.float32),
        pool_stride=13, pool_size=14, alpha=0.25, img_channels=3, device=device,
    )
    images = torch.from_numpy(rng.uniform(0, 255, (64, 32, 32, 3)).astype(np.float32)).to(device)
    feats = feat(images)
    scaler = StandardScaler().fit(feats)
    w = torch.from_numpy(rng.normal(size=(feats.shape[1], 10)).astype(np.float32)).to(device)
    return Pipeline([feat, scaler, LinearMapper(w), MaxClassifier()]), (32, 32, 3)


def _voc_chain(device, seed=1, hw=(48, 64), d=16, k=8):
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    bundle = {
        "pca": BatchPCATransformer(t(rng.normal(size=(128, d)) / 10)),
        "gmm": GaussianMixtureModel(t(rng.normal(size=(d, k)) * 5), t(rng.uniform(20, 40, (d, k))),
                                    t(rng.dirichlet(np.ones(k)))),
        "model": LinearMapper(t(rng.normal(size=(2 * d * k, 20)))),
    }
    conf = pt_voc.SIFTFisherConfig(desc_dim=d, vocab_size=k, scale_step=0)
    return pt_voc.servable_pipeline(conf, bundle), (*hw, 3)


def _engine(pipe, shape, device, label, buckets=BUCKETS, warmup=True):
    return kserve.ServingEngine(
        pipe, np.empty(shape, np.float32), label=label, device=device, warmup=warmup,
        config=kserve.ServeConfig(buckets=buckets, max_wait_ms=2.0),
    )


def _pixels(n, shape, seed):
    return np.random.default_rng(seed).uniform(0, 255, (n, *shape)).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("chain,kernel", [(_cifar_chain, "conv_rect_pool"),
                                          (_voc_chain, "fv_stats")])
def test_every_bucket_is_a_graph_that_replays_equal_to_eager(chain, kernel, cuda_device):
    pipe, shape = chain(cuda_device)
    rp.fused_launches = fs.launches = 0
    eng = _engine(pipe, shape, cuda_device, f"graphs_{kernel}", warmup=False)
    kernels = eng.graph_kernels()
    assert sorted(kernels) == list(BUCKETS)
    for bucket, recorded in kernels.items():
        assert recorded[kernel]["launches"] >= 1, (bucket, recorded)
        assert eng.memory_plans[bucket].reported["capture_reserved_bytes"] > 0
    # The one warm run per bucket launched; the captures did not count.
    warm = rp.fused_launches if kernel == "conv_rect_pool" else fs.launches
    assert warm == sum(k[kernel]["launches"] for k in kernels.values())
    for bucket in BUCKETS:
        x = torch.from_numpy(_pixels(bucket, shape, bucket)).to(cuda_device)
        eager = pipe(x)
        replay = eng._execute(bucket, x)
        torch.cuda.synchronize()
        assert torch.equal(replay, eager), bucket
    launches = eng.graph_launches()
    assert launches[kernel] == sum(k[kernel]["launches"] for k in kernels.values())
    eng.warmup()
    reqs = _pixels(21, shape, 99)
    with kserve.Server(eng) as server:
        answers = np.stack([f.result(60.0) for f in [server.submit(r) for r in reqs]])
    # Served answers are deterministic: the surviving buckets' own apply.
    assert np.array_equal(answers, eng.infer(reqs))
    if kernel == "conv_rect_pool":
        # The K1 chain is batch-invariant: every bucket keeps parity, and the
        # answers equal the eager apply of all 21 rows at once.
        assert eng.parity_ok and eng.buckets() == BUCKETS
        assert np.array_equal(answers, eng.offline(reqs))


@pytest.mark.cuda
def test_capture_with_profiler_and_numerics_on(cuda_device):
    pipe, shape = _cifar_chain(cuda_device, seed=3)
    with kprof.profiled(True), knum.monitored(True):
        eng = _engine(pipe, shape, cuda_device, "profiled")
        reqs = _pixels(6, shape, 5)
        assert np.array_equal(eng.infer(reqs), eng.offline(reqs))
        ledger = kprof.ledger()
        sites = knum.site_stats()
    assert any(label.startswith("serve:profiled:b") for label in ledger), sorted(ledger)
    row = next(v for k, v in ledger.items() if k.startswith("serve:profiled:b"))
    assert row["flops"] and row["bytes_accessed"]
    assert any(site.startswith("serve.profiled") for site in sites), sorted(sites)


@pytest.mark.cuda
def test_warm_add_while_another_engine_serves(cuda_device):
    pipe_a, shape_a = _cifar_chain(cuda_device, seed=4)
    pipe_b, shape_b = _voc_chain(cuda_device, seed=5)
    engine_a = _engine(pipe_a, shape_a, cuda_device, "live")

    def factory(shape, dtype):
        assert tuple(shape) == shape_b
        return _engine(pipe_b, shape_b, cuda_device, "warmed")

    reqs_a = _pixels(200, shape_a, 6)
    answers: list = []
    errors: list = []
    cfg = frontend.RouterConfig(warm_threshold=1)
    with frontend.ShapeRouter(factory, label="warmadd", config=cfg) as router:
        router.add_engine(engine_a)
        stop = threading.Event()

        def traffic():
            try:
                i = 0
                while not stop.is_set() or i < 40:
                    answers.append((i % 200, router.submit(reqs_a[i % 200]).result(60.0)))
                    i += 1
            except BaseException as e:  # noqa: BLE001 — surfaced below
                errors.append(e)

        t = threading.Thread(target=traffic)
        t.start()
        out_b = router.predict(_pixels(1, shape_b, 7)[0], timeout=300.0)
        stop.set()
        t.join(120.0)
        assert router.stats.warm_adds == 1
    assert not errors, errors
    assert out_b.shape == (20,)
    offline = engine_a.offline(reqs_a)
    assert all(np.array_equal(a, offline[i]) for i, a in answers)


@pytest.mark.cuda
def test_a_bucket_that_cannot_be_captured_raises(cuda_device):
    w = torch.ones(8, device=cuda_device)

    def host_read(x):
        # a host read of a device value: legal eagerly, illegal in capture
        return x * w * float(x.sum())

    with pytest.raises(kserve.ServeError, match="bucket 1 failed to capture"):
        _engine(FunctionTransformer(host_read), (8,), cuda_device, "uncapturable", buckets=(1, 2))
