"""The port's multi-epoch block least squares (TimitPipeline's solve)
against the JAX package's, on lists of uneven feature blocks (CPU, f32).

The blocks share latent factors, so later epochs still move the model.
Tolerances, those of ``tests/test_torch_solvers.py`` for the block solver:
weights and scores rtol 1e-3, atol 1e-4·max (f32 Cholesky in another BLAS);
the intercept and the block means rtol 1e-5, atol 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.solvers.block import BlockLeastSquaresEstimator as JaxBLS
from keystone_tpu_torch.solvers.block import BlockLeastSquaresEstimator

WIDTHS = (128, 128, 70)


def _blocks(rng, n=400, k=5):
    latent = rng.normal(size=(n, 24))
    blocks = [
        (latent @ rng.normal(size=(24, w)) + 0.7 * rng.normal(size=(n, w)) + 0.5).astype(
            np.float32
        )
        for w in WIDTHS
    ]
    labels = np.concatenate(blocks, axis=1) @ rng.normal(size=(sum(WIDTHS), k)) / 30.0
    return blocks, (labels + 0.1 * rng.normal(size=(n, k))).astype(np.float32)


@pytest.mark.parametrize("num_iter", [1, 2, 5])
@pytest.mark.parametrize("lam", [0.0, 5.0])
def test_block_least_squares_epochs_match_jax(rng, num_iter, lam):
    blocks, labels = _blocks(rng)
    ref = JaxBLS(256, num_iter, lam).fit([jnp.asarray(b) for b in blocks], jnp.asarray(labels))
    got = BlockLeastSquaresEstimator(256, num_iter, lam).fit(
        [torch.from_numpy(b) for b in blocks], torch.from_numpy(labels)
    )
    assert [tuple(x.shape) for x in got.xs] == [(w, 5) for w in WIDTHS]
    for a, b in zip(got.xs, ref.xs):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-3, atol=1e-4 * np.abs(b).max())
    np.testing.assert_allclose(got.b.numpy(), np.asarray(ref.b), rtol=1e-5, atol=1e-6)
    for s, r in zip(got.feature_scalers, ref.feature_scalers):
        np.testing.assert_allclose(s.mean.numpy(), np.asarray(r.mean), rtol=1e-5, atol=1e-6)
    scores_ref = np.asarray(ref([jnp.asarray(b) for b in blocks]))
    scores = got([torch.from_numpy(b) for b in blocks]).numpy()
    np.testing.assert_allclose(scores, scores_ref, rtol=1e-3, atol=1e-4 * np.abs(scores_ref).max())
