"""keystone_tpu_torch's random-FFT feature nodes, feature-vector utilities
and CSV loader against the JAX package's, on the same numpy inputs (CPU,
f32): ``PaddedFFT``, ``RandomSignNode`` (the JAX signs carried across; the
port's own ``create`` draws other bits), ``LinearRectifier``,
``ZipVectors``, ``GroupConcatFeaturizer``, ``VectorSplitter``,
``csv_data_loader`` and ``LabeledData.from_rows``.

Tolerances: the FFT and everything downstream of it atol 1e-5·max|out|,
rtol 1e-5 (JAX's and torch's CPU FFTs round differently, about 1e-7 of a
row's norm); sign masks, rectifiers, concatenations, splits and the loader
exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.core.pipeline import Pipeline as JaxPipeline
from keystone_tpu.loaders.csv_loader import LabeledData as JaxLabeledData
from keystone_tpu.loaders.csv_loader import csv_data_loader as jax_csv_loader
from keystone_tpu.ops.stats import (
    LinearRectifier as JaxRectifier,
    PaddedFFT as JaxFFT,
    RandomSignNode as JaxSign,
)
from keystone_tpu.ops.util import (
    GroupConcatFeaturizer as JaxGroupConcat,
    VectorSplitter as JaxSplitter,
    ZipVectors as JaxZip,
)
from keystone_tpu_torch.core.pipeline import Pipeline
from keystone_tpu_torch.loaders.csv_loader import LabeledData, csv_data_loader
from keystone_tpu_torch.ops.stats import (
    LinearRectifier,
    PaddedFFT,
    RandomSignNode,
    next_power_of_two,
)
from keystone_tpu_torch.ops.util import GroupConcatFeaturizer, VectorSplitter, ZipVectors


def _fft_close(got: torch.Tensor, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("i,want", [(1, 1), (2, 2), (3, 4), (512, 512), (513, 1024), (784, 1024)])
def test_next_power_of_two(i, want):
    assert next_power_of_two(i) == want


@pytest.mark.parametrize("d", [64, 784, 512])
def test_padded_fft_matches(rng, d):
    x = rng.uniform(0, 255, (9, d)).astype(np.float32)
    got = PaddedFFT()(torch.from_numpy(x))
    assert tuple(got.shape) == (9, next_power_of_two(d) // 2)
    _fft_close(got, JaxFFT()(jnp.asarray(x)))


def test_random_sign_node_carries_jax_signs(rng):
    ref = JaxSign.create(784, jax.random.PRNGKey(3))
    got = RandomSignNode(torch.from_numpy(np.array(ref.signs)))
    x = rng.normal(size=(5, 784)).astype(np.float32)
    np.testing.assert_array_equal(got(torch.from_numpy(x)).numpy(), np.asarray(ref(jnp.asarray(x))))


def test_random_sign_node_create_is_seeded_and_fair():
    a = RandomSignNode.create(1000, torch.Generator().manual_seed(7), device="cpu")
    b = RandomSignNode.create(1000, torch.Generator().manual_seed(7), device="cpu")
    c = RandomSignNode.create(1000, torch.Generator().manual_seed(8), device="cpu")
    assert torch.equal(a.signs, b.signs) and not torch.equal(a.signs, c.signs)
    assert a.signs.dtype == torch.float32 and a.signs.device.type == "cpu"
    assert set(a.signs.unique().tolist()) == {-1.0, 1.0}
    assert 400 < int((a.signs > 0).sum()) < 600
    # one generator feeds successive nodes with fresh draws
    gen = torch.Generator().manual_seed(7)
    first, second = (RandomSignNode.create(1000, gen, device="cpu") for _ in range(2))
    assert torch.equal(first.signs, a.signs) and not torch.equal(second.signs, a.signs)


def test_random_sign_node_create_defaults_to_the_card():
    """An entry point runs on the card unless the caller asks for the CPU:
    without one the default raises rather than fall back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default places the signs on it")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        RandomSignNode.create(8, torch.Generator().manual_seed(7))


@pytest.mark.parametrize("max_val,alpha", [(0.0, 0.0), (0.0, 1.0), (0.5, 0.25), (-1.0, 0.0)])
def test_linear_rectifier_matches(rng, max_val, alpha):
    x = rng.normal(size=(20, 30)).astype(np.float32)
    np.testing.assert_array_equal(
        LinearRectifier(max_val, alpha)(torch.from_numpy(x)).numpy(),
        np.asarray(JaxRectifier(max_val, alpha)(jnp.asarray(x))),
    )


def _chains(rng, d, num_groups, per_group):
    """The same sign -> FFT -> rectifier chains in both packages."""
    signs = [[np.where(rng.random(d) < 0.5, -1.0, 1.0).astype(np.float32)
              for _ in range(per_group)] for _ in range(num_groups)]
    port = [[Pipeline([RandomSignNode(torch.from_numpy(s)), PaddedFFT(), LinearRectifier(0.0)])
             for s in group] for group in signs]
    jax_ = [[JaxPipeline([JaxSign(jnp.asarray(s)), JaxFFT(), JaxRectifier(0.0)])
             for s in group] for group in signs]
    return port, jax_


def test_zip_vectors_matches(rng):
    parts = [rng.normal(size=(6, w)).astype(np.float32) for w in (3, 5, 2)]
    got = ZipVectors.apply([torch.from_numpy(p) for p in parts])
    want = np.asarray(JaxZip.apply([jnp.asarray(p) for p in parts]))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ZipVectors()([torch.from_numpy(p) for p in parts]).numpy(), want)


def test_group_concat_featurizer_matches(rng):
    port, jax_ = _chains(rng, 64, num_groups=3, per_group=2)
    x = rng.uniform(0, 255, (7, 64)).astype(np.float32)
    got = GroupConcatFeaturizer(port)(torch.from_numpy(x))
    assert tuple(got.shape) == (7, 3 * 2 * 32)
    _fft_close(got, JaxGroupConcat(jax_)(jnp.asarray(x)))
    assert repr(GroupConcatFeaturizer(port)) == "GroupConcatFeaturizer(3 groups x 2 chains)"


@pytest.mark.parametrize("d,block_size,num_features", [(20, 8, None), (24, 8, None), (20, 8, 17)])
def test_vector_splitter_matches(rng, d, block_size, num_features):
    x = rng.normal(size=(4, d)).astype(np.float32)
    got = VectorSplitter(block_size, num_features)(torch.from_numpy(x))
    want = JaxSplitter(block_size, num_features)(jnp.asarray(x))
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_csv_loader_matches(tmp_path, rng):
    rows = np.column_stack([rng.integers(1, 11, 25), rng.integers(0, 256, (25, 12))])
    path = tmp_path / "mnist.csv"
    np.savetxt(path, rows, delimiter=",", fmt="%d")
    got = csv_data_loader(str(path))
    want = jax_csv_loader(str(path))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    for one_indexed in (True, False):
        a = LabeledData.from_rows(got, one_indexed=one_indexed)
        b = JaxLabeledData.from_rows(want, one_indexed=one_indexed)
        np.testing.assert_array_equal(a.labels, b.labels)
        np.testing.assert_array_equal(a.data, b.data)
        assert a.labels.dtype == np.int32 and a.data.shape == (25, 12)
    assert LabeledData.from_rows(got, one_indexed=True).labels.min() >= 0
