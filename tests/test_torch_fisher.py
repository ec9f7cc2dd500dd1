"""keystone_tpu_torch Fisher vectors against the JAX package's (CPU).

- ``fv_stats_reference`` (the kernel's plain version) against the Pallas
  kernel ``fv_stats_pallas`` run in interpret mode, with ragged counts and
  with a descriptor count that is not a multiple of the chunk: rtol 2e-4,
  atol 2e-5 on the assembled Fisher vectors (tests/test_gmm_fisher.py's bar).
- ``fisher_vector`` and ``FisherVector`` against JAX's, the same bar.
- On the CPU the wrapper runs the plain version and launches nothing; a
  masked ``FisherVector`` takes the plain path on any device."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.ops import fisher as jfisher
from keystone_tpu.ops.fv_pallas import fv_stats_pallas
from keystone_tpu.solvers.gmm import GaussianMixtureModel as JaxGMM
from keystone_tpu_torch.ops import fisher as pfisher
from keystone_tpu_torch.ops import fv_stats as fs
from keystone_tpu_torch.solvers.gmm import GaussianMixtureModel
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401

TOL = dict(rtol=2e-4, atol=2e-5)


def _gmm(rng, d, k):
    means = rng.normal(size=(d, k)).astype(np.float32)
    variances = rng.uniform(0.5, 2.0, (d, k)).astype(np.float32)
    weights = rng.dirichlet(np.ones(k)).astype(np.float32)
    return means, variances, weights


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize(
    "n,cols,d,k,ragged,chunk",
    [(3, 700, 24, 8, True, 256), (3, 333, 24, 8, False, 128), (2, 150, 16, 5, True, 128)],
)
def test_reference_matches_pallas_interpret(rng, n, cols, d, k, ragged, chunk):
    x = rng.normal(size=(n, d, cols)).astype(np.float32)  # descriptors as columns
    gmm = _gmm(rng, d, k)
    counts = rng.integers(cols // 2, cols + 1, size=n).astype(np.int32) if ragged else None
    n_valid = (counts if ragged else np.full(n, cols)).astype(np.float32)
    js = fv_stats_pallas(
        jnp.asarray(x), None if counts is None else jnp.asarray(counts), *gmm,
        chunk=chunk, interpret=True,
    )
    want = np.asarray(jfisher._fv_from_stats(*js, *gmm, jnp.asarray(n_valid)))
    ps = fs.fv_stats_reference(
        torch.from_numpy(x), None if counts is None else torch.from_numpy(counts), *_t(*gmm)
    )
    got = pfisher._fv_from_stats(*ps, *_t(*gmm), torch.from_numpy(n_valid)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    for p, j in zip(ps, js):  # the statistics themselves, before assembly
        np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("masked", [False, True])
def test_fisher_vector_matches_jax(rng, masked):
    d, k, cols = 6, 4, 40
    gmm = _gmm(rng, d, k)
    x = rng.normal(size=(cols, d)).astype(np.float32)
    mask = (np.arange(cols) < 27).astype(np.float32) if masked else None
    want = np.asarray(jfisher.fisher_vector(
        jnp.asarray(x), *gmm, None if mask is None else jnp.asarray(mask)
    ))
    got = pfisher.fisher_vector(
        torch.from_numpy(x), *_t(*gmm), None if mask is None else torch.from_numpy(mask)
    ).numpy()
    assert got.shape == (d, 2 * k)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_fisher_vector_node_matches_jax_and_launches_nothing(rng, masked, monkeypatch):
    monkeypatch.setattr(fs, "launches", 0)
    d, k, cols, n = 5, 3, 50, 4
    gmm = _gmm(rng, d, k)
    batch = rng.normal(size=(n, d, cols)).astype(np.float32)
    mask = (np.arange(cols)[None] < rng.integers(20, cols + 1, (n, 1))).astype(np.float32)
    jfv = jfisher.FisherVector(JaxGMM(*gmm))
    pfv = pfisher.FisherVector(GaussianMixtureModel(*_t(*gmm)))
    if masked:
        want = np.asarray(jfv(jnp.asarray(batch), jnp.asarray(mask)))
        got = pfv(torch.from_numpy(batch), torch.from_numpy(mask)).numpy()
    else:
        want = np.asarray(jfv(jnp.asarray(batch)))
        got = pfv(torch.from_numpy(batch)).numpy()
    assert got.shape == (n, d, 2 * k) and pfv.num_features == d * k * 2
    np.testing.assert_allclose(got, want, **TOL)
    assert fs.launches == 0  # the CPU takes the plain version


def test_masked_fisher_vector_on_cuda_raises(monkeypatch):
    # The name is historical: a masked call off the CPU no longer raises.  As
    # in the JAX package it takes the plain per-image path on any device; a
    # tensor off the CPU (here on "meta") stands in for a CUDA one, and no
    # kernel is launched.
    monkeypatch.setattr(fs, "launches", 0)
    p = torch.ones((4, 3), device="meta")
    fv = pfisher.FisherVector(GaussianMixtureModel(p, p, torch.ones(3, device="meta")))
    out = fv(torch.empty((2, 4, 10), device="meta"), torch.ones((2, 10), device="meta"))
    assert out.device.type == "meta" and out.shape == (2, 4, 6)
    assert fs.launches == 0


def test_gmm_load_on_cuda_without_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("m", "v"):
        np.savetxt(tmp_path / f"{name}.csv", np.ones((3, 2)), delimiter=",")
    np.savetxt(tmp_path / "w.csv", np.array([[0.5, 0.5]]), delimiter=",")
    files = [str(tmp_path / f"{n}.csv") for n in ("m", "v", "w")]
    with pytest.raises(RuntimeError, match="no CUDA card"):
        GaussianMixtureModel.load(*files)
    assert GaussianMixtureModel.load(*files, device="cpu").k == 2


def test_stats_of_gmm_samples_give_small_fv(rng):
    # Descriptors drawn from the model itself encode to nearly zero.
    d, k = 4, 2
    means = np.array([[0.0, 5.0]] * d, np.float32)
    comp = rng.integers(0, k, 4000)
    x = (means[:, comp] + rng.normal(size=(d, 4000))).astype(np.float32)
    gmm = GaussianMixtureModel(*_t(means, np.ones((d, k), np.float32), np.full(k, 0.5, np.float32)))
    out = pfisher.FisherVector(gmm)(torch.from_numpy(x[None]))
    assert out.abs().max().item() < 0.1
