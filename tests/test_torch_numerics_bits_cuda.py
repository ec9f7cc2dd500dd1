"""The bits of ``tests/test_torch_numerics_bits.py`` on the card: the f32
square root of ``utils.stats.sqrt_rn`` (``torch.sqrt`` on a CUDA tensor,
IEEE-rounded there) equals the CPU's correctly rounded root, the
square-root nodes give the CPU's bits, and the served products keep each
row's bits at row counts 1, 4, 6, 16 and 64 and at shifted positions.
``matmul_rows`` is elementwise products and adds in a fixed order, so its
card rows also equal the CPU's.

This file imports neither JAX nor the JAX package, so it runs on a machine
without them:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_numerics_bits_cuda.py``.
Tests that need the card carry the ``cuda`` marker and skip without one."""

import pytest
import torch

from keystone_tpu_torch.ops import stats
from keystone_tpu_torch.ops.fisher import _fv_from_stats
from keystone_tpu_torch.ops.images import GrayScaler
from keystone_tpu_torch.solvers.block import BlockLinearMapper
from keystone_tpu_torch.solvers.pca import BatchPCATransformer, PCATransformer
from keystone_tpu_torch.utils.stats import matmul_rows, sqrt_rn
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401


ROW_COUNTS = (1, 4, 6, 16, 64)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_sqrt_rn_on_the_card_equals_the_cpu(cuda_device):
    g = torch.Generator().manual_seed(0)
    x = torch.rand(1 << 20, generator=g) * 100.0 + 1e-6
    cpu = sqrt_rn(x)
    assert torch.equal(cpu, torch.sqrt(x.double()).float())
    assert torch.equal(sqrt_rn(x.to(cuda_device)).cpu(), cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("node", ["SignedHellingerMapper", "fv_from_stats", "GrayScaler"])
def test_square_root_nodes_card_equal_cpu(cuda_device, node):
    """Elementwise nodes around a root: the card's bits are the CPU's (a
    node that also reduces, as StandardScaler's sums, rounds its sums in
    each device's own order)."""
    g = torch.Generator().manual_seed(1)
    if node == "SignedHellingerMapper":
        x = torch.randn(64, 4096, generator=g)
        run = stats.SignedHellingerMapper()
    elif node == "fv_from_stats":
        d, k = 80, 256
        x = torch.cat([torch.rand(3, 1, k, generator=g) * 9, torch.randn(3, d, k, generator=g),
                       torch.rand(3, d, k, generator=g) * 4], dim=1)
        gmm = [torch.randn(d, k, generator=g), torch.rand(d, k, generator=g) + 0.1,
               torch.rand(k, generator=g) + 0.05]

        def run(t):
            m, v, w = (p.to(t.device) for p in gmm)
            n = torch.full((t.shape[0],), 9.0, device=t.device)
            return _fv_from_stats(t[:, 0], t[:, 1 : d + 1], t[:, d + 1 :], m, v, w, n)
    else:
        x = torch.rand(4, 37, 41, 2, generator=g) * 255.0
        run = GrayScaler()
    assert torch.equal(run(x.to(cuda_device)).cpu(), run(x))


def _case(name, device):
    g = torch.Generator().manual_seed(2)
    if name == "BlockLinearMapper":
        xs = [torch.randn(4096, 20, generator=g), torch.randn(1024, 20, generator=g)]
        node = BlockLinearMapper([x.to(device) for x in xs], 4096,
                                 b=torch.randn(20, generator=g).to(device))
        return node, torch.randn(64, 5120, generator=g).to(device)
    if name == "PCATransformer":
        return (PCATransformer(torch.randn(128, 80, generator=g).to(device)),
                torch.randn(64, 128, generator=g).to(device))
    if name == "NormalizeRows":
        return stats.NormalizeRows(), torch.randn(64, 40960, generator=g).to(device)
    return (BatchPCATransformer(torch.randn(128, 80, generator=g).to(device)),
            torch.randn(64, 128, 733, generator=g).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", ROW_COUNTS)
@pytest.mark.parametrize("name", ["BlockLinearMapper", "PCATransformer", "BatchPCATransformer",
                                  "NormalizeRows"])
def test_products_keep_their_bits_on_the_card(cuda_device, name, rows):
    node, x = _case(name, cuda_device)
    whole = node(x)
    for start in sorted({0, (64 - rows) // 2, 64 - rows}):
        part = node(x[start : start + rows].clone())
        assert torch.equal(part, whole[start : start + rows]), (name, rows, start)


@pytest.mark.cuda
def test_normalize_rows_card_equals_cpu(cuda_device):
    x = torch.randn(5, 40960, generator=torch.Generator().manual_seed(4))
    node = stats.NormalizeRows()
    assert torch.equal(node(x.to(cuda_device)).cpu(), node(x))


@pytest.mark.cuda
def test_matmul_rows_card_equals_cpu(cuda_device):
    g = torch.Generator().manual_seed(3)
    x, w = torch.randn(70, 4096, generator=g), torch.randn(4096, 20, generator=g)
    assert torch.equal(matmul_rows(x.to(cuda_device), w.to(cuda_device)).cpu(),
                       matmul_rows(x, w))
