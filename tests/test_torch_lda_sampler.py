"""keystone_tpu_torch ``LinearDiscriminantAnalysis`` and ``ColumnSampler``
(CPU).

LDA: the projection against the JAX package's and against a numpy
``eig(inv(S_W) S_B)`` transcription of the reference, per direction up to
its sign, within 1e-2 (the JAX package's own bar) in f64 and 1e-3 against
JAX in f32; the classes separate after projection; a singular S_W raises.
``ColumnSampler`` draws from its own seeded generator (not
``jax.random.choice``): the shapes, the no-replacement property, that
every drawn column is a column of the input, and determinism per seed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.solvers.pca import LinearDiscriminantAnalysis as JaxLDA
from keystone_tpu_torch.ops.stats import ColumnSampler
from keystone_tpu_torch.solvers.linear import LinearMapper
from keystone_tpu_torch.solvers.pca import LinearDiscriminantAnalysis


def naive_lda(data, labels, k):
    """Direct eig(inv(Sw) Sb) per the reference, via numpy."""
    classes = np.unique(labels)
    mu = data.mean(axis=0)
    d = data.shape[1]
    sw = np.zeros((d, d))
    sb = np.zeros((d, d))
    for c in classes:
        xc = data[labels == c]
        mc = xc.mean(axis=0)
        xm = xc - mc
        sw += xm.T @ xm
        dm = (mc - mu)[:, None]
        sb += len(xc) * dm @ dm.T
    vals, vecs = np.linalg.eig(np.linalg.inv(sw) @ sb)
    order = np.argsort(-np.abs(vals))[:k]
    w = np.real(vecs[:, order])
    return w / np.linalg.norm(w, axis=0, keepdims=True)


def _classes(rng, n_per, d, c, scale, dtype):
    means = rng.normal(scale=scale, size=(c, d))
    data = np.concatenate([means[i] + rng.normal(size=(n_per, d)) for i in range(c)])
    return data.astype(dtype), np.repeat(np.arange(c), n_per)


def _same_up_to_sign(got, want, tol):
    for j in range(want.shape[1]):
        err = min(np.abs(got[:, j] - want[:, j]).max(), np.abs(got[:, j] + want[:, j]).max())
        assert err <= tol, (j, got[:, j], want[:, j])


@pytest.mark.parametrize("n_per,d,c,k", [(80, 5, 3, 2), (60, 7, 5, 3)])
def test_lda_matches_the_transcription_in_f64(rng, n_per, d, c, k):
    data, labels = _classes(rng, n_per, d, c, 3.0, np.float64)
    lm = LinearDiscriminantAnalysis(k).fit(torch.from_numpy(data), torch.from_numpy(labels))
    assert isinstance(lm, LinearMapper) and lm.x.dtype == torch.float64
    _same_up_to_sign(lm.x.numpy(), naive_lda(data, labels, k), 1e-2)


def test_lda_matches_jax_in_f32(rng):
    data, labels = _classes(rng, 100, 6, 4, 4.0, np.float32)
    got = LinearDiscriminantAnalysis(3).fit(torch.from_numpy(data), labels).x.numpy()
    ref = np.asarray(JaxLDA(3).fit(jnp.asarray(data), jnp.asarray(labels)).x)
    assert got.dtype == np.float32
    _same_up_to_sign(got, ref, 1e-3)


def test_lda_separates_classes(rng):
    data, labels = _classes(rng, 100, 6, 4, 4.0, np.float32)
    lm = LinearDiscriminantAnalysis(3).fit(torch.from_numpy(data), torch.from_numpy(labels))
    proj = lm(torch.from_numpy(data)).numpy()
    centroids = np.stack([proj[labels == c].mean(axis=0) for c in range(4)])
    within = np.mean([proj[labels == c].std(axis=0).mean() for c in range(4)])
    assert np.std(centroids, axis=0).mean() > 3.0 * within


def test_lda_singular_within_class_scatter_raises(rng):
    data = rng.normal(size=(4, 6))  # fewer samples than features
    with pytest.raises(ValueError, match="singular"):
        LinearDiscriminantAnalysis(1).fit(torch.from_numpy(data), torch.tensor([0, 0, 1, 1]))


def test_column_sampler_draws_distinct_input_columns(rng):
    mats = torch.from_numpy(rng.normal(size=(3, 5, 40)).astype(np.float32))
    out = ColumnSampler(50, seed=7)(mats)
    assert out.shape == (5, 50)
    cols = mats.permute(1, 0, 2).reshape(5, -1).T.numpy()
    hits = [np.flatnonzero((cols == col).all(axis=1)) for col in out.T.numpy()]
    assert all(len(h) == 1 for h in hits)
    assert len({int(h[0]) for h in hits}) == 50  # without replacement
    assert torch.equal(ColumnSampler(50, seed=7)(mats), out)
    assert not torch.equal(ColumnSampler(50, seed=8)(mats), out)


def test_column_sampler_lists_and_small_inputs(rng):
    mats = [torch.from_numpy(rng.normal(size=(4, n)).astype(np.float32)) for n in (3, 6)]
    everything = ColumnSampler(100)(mats)
    assert torch.equal(everything, torch.cat(mats, dim=1))
    assert ColumnSampler(5)(mats).shape == (4, 5)
