"""The port's chaos harness on the card: the out-of-memory step-down of the
fused BCD tier, a damaged entropy-coded scan under device decode (the
``decode_pixels`` kernel), and malformed requests against a served engine
whose buckets are CUDA graphs, each on ``cuda`` and held to the harness's
bar: the healthy outcome, its family's fault counted.

This file imports neither JAX nor the JAX package, so it runs on a machine
without them:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_chaos_cuda.py``.
Tests that need the card carry the ``cuda`` marker and skip without one."""

import pytest
import torch

from keystone_tpu_torch.ops import jpeg_device as jd
from keystone_tpu_torch.testing import chaos
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401

#: The families run here; each must bump ``chaos.EXPECTED_COUNTER[kind]``.
KINDS = ("jpeg_corrupt_entropy", "malformed_request", "solver_oom")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_schedule_on_the_card(kind, cuda, tmp_path, monkeypatch):
    monkeypatch.setattr(jd, "decode_launches", 0)
    seed = chaos.FAMILIES.index(kind)
    trace_path = str(tmp_path / f"chaos_seed{seed}.json")
    r = chaos.run_schedule(seed, "mnist", tmpdir=str(tmp_path), trace_path=trace_path,
                           device="cuda")
    assert r.ok() and r.outcome == chaos.expected_outcome(r.fault), r.record()
    assert r.counters_delta.get(chaos.EXPECTED_COUNTER[kind], 0) >= 1, r.record()
    assert chaos.verify_trace(trace_path, r) == []
    if kind == "jpeg_corrupt_entropy":
        assert jd.decode_launches >= 2  # the survivors decoded on the card
