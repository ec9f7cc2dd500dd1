"""keystone_tpu_torch statistics, whitening, label, evaluation and block
least-squares nodes against the JAX package's, on the same numpy inputs
(CPU, f32).

Tolerances: elementwise nodes rtol 1e-5; the scaler's one-pass moments rtol
1e-4 (f32 sums in another order); the ZCA matrix rtol 1e-4, atol 1e-5·max
(two f32 SVDs); the block solver's weights and scores rtol 1e-3, atol
1e-4·max (f32 Cholesky in another BLAS)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.evaluation.multiclass import MulticlassClassifierEvaluator as JaxEval
from keystone_tpu.ops.stats import StandardScaler as JaxScaler
from keystone_tpu.ops.util import (
    ClassLabelIndicatorsFromIntLabels as JaxLabels,
    MaxClassifier as JaxMax,
)
from keystone_tpu.solvers.block import BlockLeastSquaresEstimator as JaxBLS
from keystone_tpu.solvers.whitening import ZCAWhitenerEstimator as JaxZCA
from keystone_tpu.utils.stats import normalize_rows as jax_normalize_rows
from keystone_tpu_torch.evaluation.multiclass import MulticlassClassifierEvaluator
from keystone_tpu_torch.ops.stats import Sampler, StandardScaler
from keystone_tpu_torch.ops.util import ClassLabelIndicatorsFromIntLabels, MaxClassifier
from keystone_tpu_torch.solvers.block import (
    BlockLeastSquaresEstimator,
    _blocked_design_matrix,
)
from keystone_tpu_torch.solvers.normal_equations import cho_factor
from keystone_tpu_torch.solvers.whitening import ZCAWhitenerEstimator
from keystone_tpu_torch.utils.stats import classification_error, normalize_rows
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401


def test_standard_scaler_matches(rng):
    x = (rng.normal(size=(300, 40)) * 3 + 5).astype(np.float32)
    x[:, 7] = 2.0  # zero variance -> std 1.0
    ref = JaxScaler().fit(jnp.asarray(x))
    got = StandardScaler().fit(torch.from_numpy(x))
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(ref.mean), rtol=1e-4)
    np.testing.assert_allclose(got.std.numpy(), np.asarray(ref.std), rtol=1e-4)
    assert got.std[7].item() == 1.0
    np.testing.assert_allclose(
        got(torch.from_numpy(x)).numpy(), np.asarray(ref(jnp.asarray(x))),
        rtol=1e-4, atol=1e-4,
    )


@pytest.mark.parametrize("normalize", [True, False])
def test_standard_scaler_pad_rows_and_mean_only(rng, normalize):
    x = (rng.normal(size=(50, 6)) * 2 + 1).astype(np.float32)
    xp = np.concatenate([x, np.zeros((14, 6), np.float32)])
    ref = JaxScaler(normalize_std_dev=normalize).fit(jnp.asarray(xp), nvalid=50)
    got = StandardScaler(normalize_std_dev=normalize).fit(torch.from_numpy(xp), nvalid=50)
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(ref.mean), rtol=1e-4)
    assert (got.std is None) == (ref.std is None) == (not normalize)
    np.testing.assert_allclose(
        got(torch.from_numpy(x)).numpy(), np.asarray(ref(jnp.asarray(x))), rtol=1e-4, atol=1e-4
    )


@pytest.mark.parametrize("alpha", [1.0, 10.0])
def test_normalize_rows_matches(rng, alpha):
    x = rng.uniform(0, 255, (50, 108)).astype(np.float32)
    np.testing.assert_allclose(
        normalize_rows(torch.from_numpy(x), alpha).numpy(),
        np.asarray(jax_normalize_rows(jnp.asarray(x), alpha)),
        rtol=1e-5, atol=1e-5,
    )


@pytest.mark.parametrize("n,d", [(400, 27), (20, 48)])  # n < d: full V^T
def test_zca_matches(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32) @ rng.normal(size=(d, d)).astype(np.float32)
    ref = JaxZCA().fit_single(jnp.asarray(x))
    got = ZCAWhitenerEstimator().fit_single(torch.from_numpy(x))
    w_ref = np.asarray(ref.whitener)
    np.testing.assert_allclose(got.whitener.numpy(), w_ref, rtol=1e-4, atol=1e-5 * np.abs(w_ref).max())
    np.testing.assert_allclose(got.means.numpy(), np.asarray(ref.means), rtol=1e-5, atol=1e-6)
    out_ref = np.asarray(ref(jnp.asarray(x)))
    np.testing.assert_allclose(
        got(torch.from_numpy(x)).numpy(), out_ref, rtol=1e-4, atol=1e-4 * np.abs(out_ref).max()
    )


def test_sampler_is_seeded_without_replacement(rng):
    x = torch.arange(100, dtype=torch.float32)[:, None]
    a = Sampler(30, seed=3)(x)
    b = Sampler(30, seed=3)(x)
    assert torch.equal(a, b)
    assert len(set(a[:, 0].tolist())) == 30
    assert Sampler(200)(x) is x


def test_label_indicators_and_max_classifier(rng):
    labels = rng.integers(0, 5, 40).astype(np.int32)
    np.testing.assert_array_equal(
        ClassLabelIndicatorsFromIntLabels(5)(torch.from_numpy(labels)).numpy(),
        np.asarray(JaxLabels(5)(jnp.asarray(labels))),
    )
    scores = rng.integers(0, 3, (60, 4)).astype(np.float32)  # many ties
    np.testing.assert_array_equal(
        MaxClassifier()(torch.from_numpy(scores)).numpy(),
        np.asarray(JaxMax()(jnp.asarray(scores))),
    )
    with pytest.raises(ValueError):
        ClassLabelIndicatorsFromIntLabels(1)


def test_evaluator_matches(rng):
    pred = rng.integers(0, 4, 100)
    actual = rng.integers(0, 4, 100)
    got = MulticlassClassifierEvaluator(torch.from_numpy(pred), actual, 4)
    ref = JaxEval(jnp.asarray(pred), jnp.asarray(actual), 4)
    np.testing.assert_array_equal(got.confusion_matrix, ref.confusion_matrix)
    assert got.total_error == pytest.approx(ref.total_error)
    assert got.macro_f_score() == pytest.approx(ref.macro_f_score())
    assert classification_error(pred, actual) == pytest.approx(ref.total_error)


@pytest.mark.parametrize("num_iter", [1, 3])
@pytest.mark.parametrize("lam", [0.0, 10.0])
@pytest.mark.parametrize("d,block_size", [(48, 16), (50, 16), (30, 64)])
def test_block_least_squares_matches(rng, num_iter, lam, d, block_size):
    n, k = 200, 4
    x = rng.normal(size=(n, d)).astype(np.float32) + 0.5
    w = rng.normal(size=(d, k)).astype(np.float32)
    y = (x @ w + 0.1 * rng.normal(size=(n, k))).astype(np.float32)
    ref = JaxBLS(block_size, num_iter, lam).fit(jnp.asarray(x), jnp.asarray(y))
    got = BlockLeastSquaresEstimator(block_size, num_iter, lam).fit(
        torch.from_numpy(x), torch.from_numpy(y)
    )
    assert [tuple(a.shape) for a in got.xs] == [tuple(a.shape) for a in ref.xs]
    for a, b in zip(got.xs, ref.xs):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-3, atol=1e-4 * np.abs(b).max())
    np.testing.assert_allclose(got.b.numpy(), np.asarray(ref.b), rtol=1e-5, atol=1e-6)
    for s, r in zip(got.feature_scalers, ref.feature_scalers):
        np.testing.assert_allclose(s.mean.numpy(), np.asarray(r.mean), rtol=1e-5, atol=1e-6)
    scores_ref = np.asarray(ref(jnp.asarray(x)))
    np.testing.assert_allclose(
        got(torch.from_numpy(x)).numpy(), scores_ref,
        rtol=1e-3, atol=1e-4 * np.abs(scores_ref).max(),
    )


def test_block_least_squares_masks_pad_rows(rng):
    x = rng.normal(size=(64, 10)).astype(np.float32)
    y = rng.normal(size=(64, 3)).astype(np.float32)
    xp = np.concatenate([x, np.zeros((16, 10), np.float32)])
    yp = np.concatenate([y, np.zeros((16, 3), np.float32)])
    est = BlockLeastSquaresEstimator(8, 2, 1.0)
    whole = est.fit(torch.from_numpy(x), torch.from_numpy(y))
    padded = est.fit(torch.from_numpy(xp), torch.from_numpy(yp), nvalid=64)
    for a, b in zip(whole.xs, padded.xs):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_blocked_design_matrix_width_contract():
    feats = torch.zeros(4, 10)
    with pytest.raises(ValueError, match="num_features"):
        _blocked_design_matrix(feats, 4, num_features=12)
    x, widths = _blocked_design_matrix(feats, 4)
    assert widths == (4, 4, 2) and tuple(x.shape) == (4, 12)
    x, widths = _blocked_design_matrix([torch.ones(4, 3), torch.ones(4, 5)], 4)
    assert widths == (3, 5) and tuple(x.shape) == (4, 10)


def test_cho_factor_nan_on_indefinite():
    bad = torch.tensor([[1.0, 2.0], [2.0, 1.0]])
    assert torch.isnan(cho_factor(bad)).all()
    good = torch.tensor([[4.0, 2.0], [2.0, 3.0]])
    torch.testing.assert_close(cho_factor(good) @ cho_factor(good).T, good)
