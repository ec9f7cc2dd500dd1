"""keystone_tpu_torch PCA, GMM and column sampling against the JAX
package's (CPU).

- ``compute_pca``: components within atol 1e-4 (unit vectors; a sample with
  a distinct spectrum, so each component is defined up to the sign the
  MATLAB convention fixes).
- GMM EM from the same samples and seed, a fixed number of iterations:
  means, variances and weights within rtol 1e-3.
- ``sample_columns`` and ``bucket_by_shape``: the same columns, exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.solvers import gmm as jgmm
from keystone_tpu.solvers import pca as jpca
from keystone_tpu.workloads import fv_common as jfv
from keystone_tpu_torch.solvers import gmm as pgmm
from keystone_tpu_torch.solvers import pca as ppca
from keystone_tpu_torch.workloads import fv_common as pfv
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401


def _spectral_sample(rng, n, d):
    """Samples with a distinct spectrum: a random rotation of axes with
    standard deviations d, d-1, ..., 1, plus an offset."""
    q, _ = np.linalg.qr(rng.normal(size=(d, d)))
    z = rng.normal(size=(n, d)) * np.arange(d, 0, -1)
    return (z @ q.T + rng.normal(size=d) * 5).astype(np.float32)


@pytest.mark.parametrize("n,d,dims", [(600, 12, 5), (8, 12, 4)])  # n < d: full_matrices
def test_compute_pca_matches_jax(rng, n, d, dims):
    data = _spectral_sample(rng, n, d)
    ref = np.asarray(jpca.compute_pca(jnp.asarray(data), dims))
    got = ppca.compute_pca(torch.from_numpy(data), dims).numpy()
    assert got.shape == (d, dims)
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_pca_transformers_match_jax(rng):
    mat = rng.normal(size=(10, 4)).astype(np.float32)
    rows = rng.normal(size=(7, 10)).astype(np.float32)
    descs = rng.normal(size=(3, 10, 25)).astype(np.float32)
    np.testing.assert_allclose(
        ppca.PCATransformer(torch.from_numpy(mat))(torch.from_numpy(rows)).numpy(),
        np.asarray(jpca.PCATransformer(jnp.asarray(mat))(jnp.asarray(rows))), rtol=1e-5, atol=1e-6,
    )
    np.testing.assert_allclose(
        ppca.BatchPCATransformer(torch.from_numpy(mat))(torch.from_numpy(descs)).numpy(),
        np.asarray(jpca.BatchPCATransformer(jnp.asarray(mat))(jnp.asarray(descs))),
        rtol=1e-5, atol=1e-6,
    )
    est = ppca.PCAEstimator(3).fit(torch.from_numpy(_spectral_sample(rng, 200, 10)))
    assert est.pca_mat.shape == (10, 3)


def _mixture(rng, n=3000, d=4, k=3):
    centers = rng.normal(scale=4.0, size=(k, d))
    comp = rng.integers(0, k, n)
    return (centers[comp] + rng.normal(size=(n, d))).astype(np.float32)


@pytest.mark.parametrize("chunk", [1 << 18, 700])  # one chunk; a ragged chunked E-step
def test_em_matches_jax(rng, chunk):
    x = _mixture(rng)
    kw = dict(max_iter=10, tol=1e-30, seed=42, chunk=chunk)
    jest = jgmm.GaussianMixtureModelEstimator(3, **kw)
    ref = jest.fit(jnp.asarray(x))
    pest = pgmm.GaussianMixtureModelEstimator(3, **kw)
    got = pest.fit(torch.from_numpy(x))
    assert pest.last_iterations == int(jest.last_iterations) == 10
    for name in ("means", "variances", "weights"):
        np.testing.assert_allclose(
            getattr(got, name).numpy(), np.asarray(getattr(ref, name)), rtol=1e-3, atol=1e-5
        )


def test_em_convergence_test_matches_jax(rng):
    # Default tol: both stop after the same number of iterations.  tol = 0:
    # the first test is inf >= 0 * inf = NaN, false in both, so neither
    # runs an iteration and both return the initialisation.
    x = _mixture(rng, n=2000)
    for tol in (1e-4, 0.0):
        jest = jgmm.GaussianMixtureModelEstimator(3, tol=tol)
        ref = jest.fit(jnp.asarray(x))
        pest = pgmm.GaussianMixtureModelEstimator(3, tol=tol)
        got = pest.fit(torch.from_numpy(x))
        assert pest.last_iterations == int(jest.last_iterations)
        np.testing.assert_allclose(got.means.numpy(), np.asarray(ref.means), rtol=1e-3, atol=1e-4)
    assert pest.last_iterations == 0


def test_log_resp_and_posteriors_match_jax(rng):
    d, k = 5, 4
    means = rng.normal(size=(d, k)).astype(np.float32)
    variances = rng.uniform(0.5, 2.0, (d, k)).astype(np.float32)
    weights = rng.dirichlet(np.ones(k)).astype(np.float32)
    x = rng.normal(size=(30, d)).astype(np.float32)
    ref = np.asarray(jgmm._log_resp(jnp.asarray(x), means, variances, weights))
    model = pgmm.GaussianMixtureModel(*(torch.from_numpy(a) for a in (means, variances, weights)))
    np.testing.assert_allclose(model.log_responsibilities(torch.from_numpy(x)).numpy(), ref, rtol=1e-5)
    q = model(torch.from_numpy(x))
    np.testing.assert_allclose(q.sum(dim=1).numpy(), 1.0, atol=1e-5)


def test_gmm_load_and_shape_checks(tmp_path):
    means = np.array([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]])  # d=3, k=2
    np.savetxt(tmp_path / "m.csv", means, delimiter=",")
    np.savetxt(tmp_path / "v.csv", np.ones((3, 2)), delimiter=",")
    np.savetxt(tmp_path / "w.csv", np.array([[0.4, 0.6]]), delimiter=",")
    files = [str(tmp_path / f) for f in ("m.csv", "v.csv", "w.csv")]
    got = pgmm.GaussianMixtureModel.load(*files, device="cpu")
    ref = jgmm.GaussianMixtureModel.load(*files)
    assert (got.dim, got.k) == (ref.dim, ref.k) == (3, 2)
    np.testing.assert_allclose(got.means.numpy(), np.asarray(ref.means))
    with pytest.raises(ValueError, match="same size"):
        pgmm.GaussianMixtureModel(torch.ones(3, 2), torch.ones(3, 3), torch.ones(2))
    with pytest.raises(ValueError, match="weight"):
        pgmm.GaussianMixtureModel(torch.ones(3, 2), torch.ones(3, 2), torch.ones(3))
    with pytest.raises(ValueError, match="at least k"):
        pgmm.GaussianMixtureModelEstimator(5).fit(torch.ones(3, 2))


def _desc_buckets(rng):
    images = [np.zeros((h, w, 3), np.float32) for h, w in [(8, 9), (9, 8), (8, 9), (8, 9), (9, 8)]]
    descs = {(8, 9): rng.normal(size=(3, 6, 40)), (9, 8): rng.normal(size=(2, 6, 33))}
    return images, {s: d.astype(np.float32) for s, d in descs.items()}


@pytest.mark.parametrize("num_samples", [50, 500])  # sampled; every column
def test_sample_columns_picks_the_same_columns(rng, num_samples):
    images, descs = _desc_buckets(rng)
    jb, pb = jfv.bucket_by_shape(images), pfv.bucket_by_shape(images)
    assert list(jb) == list(pb)
    for shape in jb:
        np.testing.assert_array_equal(jb[shape][0], pb[shape][0])
    jbuckets = {s: (jb[s][0], jnp.asarray(descs[s])) for s in jb}
    pbuckets = {s: (pb[s][0], torch.from_numpy(descs[s])) for s in pb}
    ref = np.asarray(jfv.sample_columns(jbuckets, num_samples, seed=7))
    got = pfv.sample_columns(pbuckets, num_samples, seed=7).numpy()
    np.testing.assert_array_equal(got, ref)
