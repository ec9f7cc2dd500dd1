"""The profiler, memory admission and checkpoints of the port on the card.

This file imports neither JAX nor the JAX package, so the card tests run on
a machine without them:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_profiler_cuda.py``.
Tests that need the card carry the ``cuda`` marker and skip without one.

Bars: a phase's HBM watermark holds a known allocation to within 1 MiB; a
real ``torch.OutOfMemoryError`` is recognised and steps the ladder down one
tier; a checkpoint saved from the card and loaded back onto it gives equal
tensors and equal outputs; a capture window on the card writes a trace
naming the kernel launch."""

import os

import numpy as np
import pytest
import torch

from keystone_tpu_torch.core import memory as kmem
from keystone_tpu_torch.core import profiler as kprof
from keystone_tpu_torch.core.checkpoint import load_pipeline, save_pipeline
from keystone_tpu_torch.core.pipeline import Pipeline
from keystone_tpu_torch.ops import rect_pool as rp
from keystone_tpu_torch.ops.conv_fused import FusedConvFeaturizer
from keystone_tpu_torch.ops.stats import StandardScaler
from keystone_tpu_torch.ops.util import MaxClassifier
from keystone_tpu_torch.solvers.block import BlockLeastSquaresEstimator
from keystone_tpu_torch.utils.platform import resolve_device
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    kprof.reset_state()
    yield resolve_device("cuda")
    kprof.reset_state()


@pytest.mark.cuda
def test_phase_watermark_holds_a_known_allocation(cuda_device):
    nbytes = 256 * 2**20
    with kprof.profiled(True, interval_ms=10_000.0):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        with kprof.phase("alloc"):
            block = torch.empty(nbytes, dtype=torch.uint8, device=cuda_device)
            block.fill_(1)
            torch.cuda.synchronize()
        wm = kprof.watermark("alloc")
        del block
    assert before + nbytes <= wm <= before + nbytes + 2**20, (before, wm)


@pytest.mark.cuda
def test_real_oom_steps_the_ladder_down(cuda_device):
    free, total = torch.cuda.mem_get_info()

    def too_big(plan):
        return torch.empty(2 * total, dtype=torch.uint8, device=cuda_device)

    with pytest.raises(torch.OutOfMemoryError) as info:
        too_big(None)
    assert kmem.is_oom_error(info.value)
    report = kmem.FitReport()
    out = kmem.run_ladder("probe", [
        kmem.Tier("huge", lambda: kmem.plan_bytes("huge", budget=None), too_big),
        kmem.Tier("small", lambda: kmem.plan_bytes("small", budget=None),
                  lambda plan: torch.ones(4, device=cuda_device)),
    ], report)
    assert report.oom_retries == ["huge"] and report.chosen == "small"
    assert torch.equal(out.cpu(), torch.ones(4))
    assert kmem.hbm_budget() > 0


@pytest.mark.cuda
def test_card_save_and_load_give_equal_tensors(cuda_device, tmp_path):
    rng = np.random.default_rng(0)
    feat = FusedConvFeaturizer(
        rng.normal(size=(16, 108)).astype(np.float32), rng.normal(size=108).astype(np.float32),
        pool_stride=13, pool_size=14, alpha=0.25, img_channels=3, device=cuda_device,
    )
    images = torch.from_numpy(rng.uniform(0, 255, (64, 32, 32, 3)).astype(np.float32)).cuda()
    feats = feat(images)
    scaler = StandardScaler().fit(feats)
    labels = 2.0 * torch.eye(4, device=cuda_device)[torch.arange(64, device=cuda_device) % 4] - 1.0
    model = BlockLeastSquaresEstimator(4096, 1, 10.0).fit(scaler(feats), labels)
    pipe = Pipeline([feat, scaler, model, MaxClassifier()])
    stem = save_pipeline(str(tmp_path / "card"), pipe)
    loaded = load_pipeline(stem, device="cuda")
    pairs = [
        (feat.conv.filters, loaded.nodes[0].conv.filters),
        (feat.conv.filter_means_dot, loaded.nodes[0].conv.filter_means_dot),
        (scaler.mean, loaded.nodes[1].mean), (scaler.std, loaded.nodes[1].std),
        *zip(model.xs, loaded.nodes[2].xs), (model.b, loaded.nodes[2].b),
    ]
    for a, b in pairs:
        assert b.device.type == "cuda" and torch.equal(a, b)
    assert loaded.nodes[0].activation_dtype == torch.bfloat16
    before = rp.fused_launches
    assert torch.equal(loaded(images), pipe(images))
    assert rp.fused_launches == before + 2  # the fused kernel, both times


@pytest.mark.cuda
def test_capture_window_names_the_kernel(cuda_device, tmp_path, monkeypatch):
    monkeypatch.setenv(kprof.XPROF_DIR_ENV, str(tmp_path))
    monkeypatch.setenv(kprof.XPROF_WINDOW_ENV, "60")
    rng = np.random.default_rng(1)
    feat = FusedConvFeaturizer(
        rng.normal(size=(8, 108)).astype(np.float32), None, pool_stride=13, pool_size=14,
        img_channels=3, device=cuda_device,
    )
    images = torch.from_numpy(rng.uniform(0, 255, (16, 32, 32, 3)).astype(np.float32)).cuda()
    path = kprof.maybe_capture("probe")
    assert path is not None
    feat(images)
    kprof.close_capture()
    with open(os.path.join(path, kprof.CAPTURE_TRACE_NAME)) as fh:
        text = fh.read()
    assert "conv_rect_pool" in text and "pool_kernel" in text
