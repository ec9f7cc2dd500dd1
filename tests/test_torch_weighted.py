"""keystone_tpu_torch's class-weighted block least squares against the JAX
package's ``BlockWeightedLeastSquaresEstimator`` and against a numpy f64
transcription of the reference's ``trainWithL2`` (CPU).

Cases: balanced and imbalanced classes, uneven block widths, one and two
passes, a ``class_chunk`` that does not divide the class count, unsorted
rows against sorted ones, the missing-class error, and a factorisation
that fails.  Tolerance: rtol 1e-4, atol
1e-5·max for the weights and the intercept (the port solves by Cholesky,
the JAX package by LU, the transcription in f64)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.solvers.weighted import BlockWeightedLeastSquaresEstimator as JaxBWLS
from keystone_tpu_torch.solvers.block import BlockLinearMapper
from keystone_tpu_torch.solvers.weighted import BlockWeightedLeastSquaresEstimator
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401


def naive_bwls(feats, labels, block_size, num_iter, lam, w):
    """Direct numpy transcription of reference trainWithL2 (:106-312), with
    one 'partition' per class."""
    n, num_classes = labels.shape
    ci = np.argmax(labels, 1)
    order = np.argsort(ci, kind="stable")
    feats, labels, ci = feats[order], labels[order], ci[order]
    xc = [feats[ci == c] for c in range(num_classes)]
    yc = [labels[ci == c] for c in range(num_classes)]
    counts = np.array([len(x) for x in xc])
    jlm = 2 * w + 2 * (1 - w) * counts / n - 1
    d = feats.shape[1]
    blocks = [slice(i, min(i + block_size, d)) for i in range(0, d, block_size)]
    models = [np.zeros((b.stop - b.start, num_classes)) for b in blocks]
    resid = [yc[c] - jlm for c in range(num_classes)]
    rmean = sum(r.mean(0) for r in resid) / num_classes
    stats = [None] * len(blocks)
    for _ in range(num_iter):
        for bi, bsl in enumerate(blocks):
            xb = [x[:, bsl] for x in xc]
            if stats[bi] is None:
                xall = np.concatenate(xb)
                pop_mean = xall.mean(0)
                ata = sum(x.T @ x for x in xb)
                pop_cov = ata / n - np.outer(pop_mean, pop_mean)
                jm = np.stack([x.mean(0) * w + pop_mean * (1 - w) for x in xb])
                stats[bi] = (pop_cov, pop_mean, jm)
            pop_cov, pop_mean, jm = stats[bi]
            pop_xtr = sum(x.T @ r for x, r in zip(xb, resid)) / n
            dws = []
            for c in range(num_classes):
                x, rl, nc = xb[c], resid[c][:, c], counts[c]
                cm = x.mean(0)
                zm = x - cm
                ccov = zm.T @ zm / nc
                cxtr = x.T @ rl / nc
                md = cm - pop_mean
                jxtx = pop_cov * (1 - w) + ccov * w + np.outer(md, md) * (1 - w) * w
                mmw = rmean[c] * (1 - w) + w * rl.mean()
                jxtr = pop_xtr[:, c] * (1 - w) + cxtr * w - jm[c] * mmw
                db = jxtx.shape[0]
                dws.append(
                    np.linalg.solve(
                        jxtx + lam * np.eye(db), jxtr - models[bi][:, c] * lam
                    )
                )
            dw = np.stack(dws, 1)
            models[bi] += dw
            resid = [resid[c] - xb[c] @ dw for c in range(num_classes)]
            rmean = sum(r.mean(0) for r in resid) / num_classes
    w_full = np.concatenate(models)
    jmc = np.concatenate([s[2] for s in stats], axis=1)
    b = jlm - np.einsum("cd,dc->c", jmc, w_full)
    return w_full, b


def make_problem(rng, sizes, d):
    """Class-separated Gaussian rows, ``sizes[c]`` of class c, shuffled;
    ±1 indicator labels."""
    means = rng.normal(scale=2.0, size=(len(sizes), d))
    class_idx = rng.permutation(np.repeat(np.arange(len(sizes)), sizes))
    feats = (means[class_idx] + rng.normal(size=(len(class_idx), d))).astype(np.float32)
    labels = (2.0 * np.eye(len(sizes))[class_idx] - 1.0).astype(np.float32)
    return feats, labels


def port_fit(feats, labels, block_size, num_iter, lam, w, chunk=16):
    model = BlockWeightedLeastSquaresEstimator(block_size, num_iter, lam, w, class_chunk=chunk).fit(
        torch.from_numpy(feats), torch.from_numpy(labels)
    )
    assert isinstance(model, BlockLinearMapper)
    return torch.cat(model.xs).numpy(), model.b.numpy(), model


def jax_fit(feats, labels, block_size, num_iter, lam, w, chunk=16):
    model = JaxBWLS(block_size, num_iter, lam, w, class_chunk=chunk).fit(
        jnp.asarray(feats), jnp.asarray(labels)
    )
    return np.concatenate([np.asarray(x) for x in model.xs]), np.asarray(model.b)


def assert_close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


CASES = {
    # name: (class sizes, d, block_size, num_iter, class_chunk)
    "balanced": ([30, 30, 30], 8, 4, 1, 16),
    "balanced_two_passes": ([30, 30, 30], 8, 4, 2, 16),
    "imbalanced": ([5, 40, 17], 6, 6, 1, 16),
    "imbalanced_two_passes": ([5, 40, 17], 6, 6, 2, 16),
    "uneven_blocks": ([20, 25, 15, 30, 30], 13, 5, 2, 16),  # blocks of 5, 5, 3
    "chunk_not_dividing": ([12, 9, 15, 11, 8, 14, 10], 9, 4, 1, 3),  # 7 classes, chunks of 3
    "one_example_classes": ([1, 1, 20, 1], 5, 5, 1, 2),
    # 12 imbalanced classes in chunks of 5, blocks of 4, 4, 2, two passes
    "many_classes_two_passes": ([6, 9, 7, 8, 10, 5, 11, 6, 9, 7, 8, 12], 10, 4, 2, 5),
}


@pytest.mark.parametrize("case", list(CASES))
def test_matches_jax_and_the_transcription(rng, case):
    sizes, d, bs, iters, chunk = CASES[case]
    feats, labels = make_problem(rng, sizes, d)
    x, b, _ = port_fit(feats, labels, bs, iters, 0.1, 0.3, chunk)
    xj, bj = jax_fit(feats, labels, bs, iters, 0.1, 0.3, chunk)
    assert_close(x, xj)
    assert_close(b, bj)
    xn, bn = naive_bwls(feats.astype(np.float64), labels.astype(np.float64), bs, iters, 0.1, 0.3)
    assert_close(x, xn)
    assert_close(b, bn)


def test_unsorted_rows_equal_sorted(rng):
    feats, labels = make_problem(rng, [30, 25, 35], 8)
    x1, b1, _ = port_fit(feats, labels, 4, 2, 0.1, 0.3)
    by_class = np.argsort(np.argmax(labels, 1), kind="stable")
    x2, b2, _ = port_fit(feats[by_class], labels[by_class], 4, 2, 0.1, 0.3)
    assert_close(x1, x2)
    assert_close(b1, b2)


def test_model_scores_with_the_intercept(rng):
    feats, labels = make_problem(rng, [20, 20, 20], 10)
    x, b, model = port_fit(feats, labels, 4, 1, 0.1, 0.3)
    scores = model(torch.from_numpy(feats)).numpy()
    np.testing.assert_allclose(scores, feats @ x + b, rtol=1e-5, atol=1e-5 * np.abs(scores).max())
    assert np.mean(scores.argmax(1) == labels.argmax(1)) > 0.9


def test_missing_class_raises(rng):
    feats = rng.normal(size=(10, 4)).astype(np.float32)
    labels = np.tile(2.0 * np.eye(3)[0] - 1.0, (10, 1)).astype(np.float32)
    with pytest.raises(ValueError, match="no examples"):
        port_fit(feats, labels, 4, 1, 0.1, 0.3)


def test_failed_factorisation_raises(rng):
    # Zero features at lambda 0: every class's system is all zeros.
    feats = np.zeros((12, 4), np.float32)
    labels = (2.0 * np.eye(3)[np.arange(12) % 3] - 1.0).astype(np.float32)
    with pytest.raises(FloatingPointError, match="not positive definite"):
        port_fit(feats, labels, 4, 1, 0.0, 0.3)
