"""The NewsgroupsPipeline slice (CPU): the text ops, the sparse feature
spaces and the naive-Bayes fit and scores against the JAX package's on the
same inputs, the CSR scoring's batch invariance, the whole run, the fitted
state through ``keystone_tpu_torch.convert``, and the CLI.

The corpus is ``keystone_tpu_torch.testing.corpus``'s synthetic 20-class
tree at 24 / 12 documents per class, where the JAX run errs on a few per
cent of the test documents.  Tolerances: text ops, vocabularies
and CSR features identical; ``pi`` and ``theta`` within 1e-6 (both are the
f32 rounding of one f64 computation); scores atol 1e-5·max (f32 sums in
another order); predictions and confusion matrices identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.loaders.newsgroups import newsgroups_loader as jax_loader
from keystone_tpu.ops import nlp as jax_nlp
from keystone_tpu.ops import sparse as jax_sparse
from keystone_tpu.solvers.naive_bayes import NaiveBayesEstimator as JaxNB
from keystone_tpu.workloads import newsgroups as jax_ng
from keystone_tpu_torch import convert
from keystone_tpu_torch.loaders.newsgroups import CLASSES, newsgroups_loader
from keystone_tpu_torch.ops import nlp, sparse
from keystone_tpu_torch.solvers.naive_bayes import NaiveBayesEstimator
from keystone_tpu_torch.testing.corpus import write_newsgroups_tree
from keystone_tpu_torch.workloads import newsgroups as pt_ng
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401

COMMON = 3000


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("newsgroups")
    rng = np.random.default_rng(11)
    for split, count in (("train", 24), ("test", 12)):
        write_newsgroups_tree(root / split, CLASSES, [count] * len(CLASSES), rng,
                              vocab_size=4000, theme_share=0.15, doc_tokens=(60, 200))
    return str(root / "train"), str(root / "test")


@pytest.fixture(scope="module")
def corpus(tree):
    return newsgroups_loader(tree[0]), newsgroups_loader(tree[1])


def test_loader_matches_jax(tree, corpus):
    for path, got in zip(tree, corpus):
        want = jax_loader(path)
        assert got.data == want.data
        np.testing.assert_array_equal(got.labels, want.labels)
    assert len(corpus[0].data) == 24 * len(CLASSES)


def test_text_ops_match_jax(corpus):
    docs = corpus[0].data[:40] + [",Leading sep", "trailing sep,  ", "", "a_b c"]
    pipe = [nlp.Trim(), nlp.LowerCase(), nlp.Tokenizer(), nlp.NGramsFeaturizer([1, 2, 3]),
            nlp.TermFrequency(lambda x: x * 10)]
    jax_pipe = [jax_nlp.Trim(), jax_nlp.LowerCase(), jax_nlp.Tokenizer(),
                jax_nlp.NGramsFeaturizer([1, 2, 3]), jax_nlp.TermFrequency(lambda x: x * 10)]
    got, want = docs, docs
    for node, jax_node in zip(pipe, jax_pipe):
        got, want = node(got), jax_node(want)
        assert got == want, type(node).__name__
    with pytest.raises(ValueError, match="consecutive"):
        nlp.NGramsFeaturizer([1, 3])
    tokens = nlp.Tokenizer()(nlp.LowerCase()(docs))
    enc = nlp.fit_word_frequency_encoder(tokens)
    jax_enc = jax_nlp.fit_word_frequency_encoder(tokens)
    assert list(enc.word_index.items()) == list(jax_enc.word_index.items())
    assert enc.unigram_counts == jax_enc.unigram_counts
    assert enc(tokens[:5] + [["zzzz"]]) == jax_enc(tokens[:5] + [["zzzz"]])


@pytest.fixture(scope="module")
def terms(corpus):
    return [pt_ng.text_pipeline(2)(split.data) for split in corpus]


@pytest.mark.parametrize("k", [COMMON, 500])
def test_common_sparse_features_match_jax_with_ties(terms, k):
    train, test = terms
    got = sparse.CommonSparseFeatures(k).fit(train)
    want = jax_sparse.CommonSparseFeatures(k).fit(train)
    # Insertion order is the feature index: equal lists, ties included.
    assert list(got.feature_space.items()) == list(want.feature_space.items())
    counts = {}
    for doc in train:
        for t, _ in doc:
            counts[t] = counts.get(t, 0) + 1
    last = counts[next(reversed(got.feature_space))]
    assert sum(c == last for c in counts.values()) > 1  # the cut falls in a tie
    for a, b in zip(vars(got(test)).values(), vars(want(test)).values()):
        np.testing.assert_array_equal(a, b)


def test_all_sparse_features_match_jax(terms):
    got = sparse.AllSparseFeatures().fit(terms[0])
    want = jax_sparse.AllSparseFeatures().fit(terms[0])
    assert list(got.feature_space.items()) == list(want.feature_space.items())
    csr = got(terms[1][:5])
    np.testing.assert_array_equal(csr.to_dense(), want(terms[1][:5]).to_dense())


def _jax_csr(csr):
    return jax_sparse.CSRFeatures(csr.values, csr.indices, csr.indptr, csr.num_features)


@pytest.fixture(scope="module")
def fitted(corpus, terms):
    vec = sparse.CommonSparseFeatures(COMMON).fit(terms[0])
    train_csr, test_csr = vec(terms[0]), vec(terms[1])
    labels = corpus[0].labels
    return dict(
        model=NaiveBayesEstimator(len(CLASSES), device="cpu").fit(train_csr, labels),
        jax_model=JaxNB(len(CLASSES)).fit(_jax_csr(train_csr), labels),
        vec=vec, test_csr=test_csr,
    )


def test_naive_bayes_fit_matches_jax(fitted):
    model, ref = fitted["model"], fitted["jax_model"]
    np.testing.assert_allclose(model.pi.numpy(), np.asarray(ref.pi), rtol=0, atol=1e-6)
    np.testing.assert_allclose(model.theta.numpy(), np.asarray(ref.theta), rtol=0, atol=1e-6)


def test_naive_bayes_dense_fit_matches_jax(rng):
    x = rng.poisson(1.0, (60, 30)).astype(np.float32)
    labels = rng.integers(0, 4, 60)
    got = NaiveBayesEstimator(4, lam=0.5, device="cpu").fit(x, labels)
    ref = JaxNB(4, lam=0.5).fit(x, labels)
    np.testing.assert_allclose(got.theta.numpy(), np.asarray(ref.theta), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.pi.numpy(), np.asarray(ref.pi), rtol=0, atol=1e-6)


def test_csr_and_dense_scores_match_jax(fitted):
    model, ref, csr = fitted["model"], fitted["jax_model"], fitted["test_csr"]
    want = np.asarray(ref(_jax_csr(csr)))
    scale = np.abs(want).max()
    np.testing.assert_allclose(model(csr).numpy(), want, rtol=0, atol=1e-5 * scale)
    dense = csr.to_dense()
    want_dense = np.asarray(ref(jnp.asarray(dense)))
    np.testing.assert_allclose(model(torch.from_numpy(dense)).numpy(), want_dense, rtol=0,
                               atol=1e-5 * scale)


def test_csr_scores_do_not_depend_on_the_batch(fitted):
    model, csr = fitted["model"], fitted["test_csr"]
    whole = model(csr)
    for lo, hi in ((0, 1), (3, 7), (5, 69), (100, len(csr))):
        rows = sparse.CSRFeatures(
            csr.values[csr.indptr[lo] : csr.indptr[hi]],
            csr.indices[csr.indptr[lo] : csr.indptr[hi]],
            csr.indptr[lo : hi + 1] - csr.indptr[lo], csr.num_features,
        )
        assert torch.equal(model(rows), whole[lo:hi])
    # A document with no nonzeros between two others scores pi; its
    # neighbours keep their bits.
    lo, hi = csr.indptr[0], csr.indptr[2]
    gap = sparse.CSRFeatures(csr.values[lo:hi], csr.indices[lo:hi],
                             np.array([0, csr.indptr[1], csr.indptr[1], hi]), csr.num_features)
    scores = model(gap)
    assert torch.equal(scores[[0, 2]], whole[:2]) and torch.equal(scores[1], model.pi)
    empty = sparse.CSRFeatures(np.zeros(0, np.float32), np.zeros(0, np.int32),
                               np.zeros(1, np.int64), csr.num_features)
    assert tuple(model(empty).shape) == (0, len(CLASSES))


@pytest.fixture(scope="module")
def runs(corpus):
    conf = dict(n_grams=2, common_features=COMMON)
    return (jax_ng.run(jax_ng.NewsgroupsConfig(**conf), *corpus),
            pt_ng.run(pt_ng.NewsgroupsConfig(**conf, device="cpu"), *corpus))


def test_run_matches_jax(corpus, fitted, runs):
    jax_res, res = runs
    np.testing.assert_array_equal(res["evaluator"].confusion_matrix,
                                  jax_res["evaluator"].confusion_matrix)
    assert res["test_error"] == jax_res["test_error"]
    assert res["test_error"] < 20.0  # chance is 95 %
    want = np.argmax(np.asarray(fitted["jax_model"](_jax_csr(fitted["test_csr"]))), axis=1)
    np.testing.assert_array_equal(res["test_predictions"], want)
    assert res["num_features"] == COMMON
    assert res["text_seconds"] > 0 and res["score_seconds"] > 0
    summary = res["evaluator"].summary(list(CLASSES))
    assert summary == jax_res["evaluator"].summary(list(CLASSES))


@pytest.mark.parametrize("batch", [1, 5, 64])
def test_servable_and_converted_state(corpus, fitted, runs, batch):
    _, res = runs
    docs = corpus[1].data[:64]
    served = np.concatenate([res["servable"](docs[i : i + batch]).numpy()
                             for i in range(0, 64, batch)])
    np.testing.assert_array_equal(served, res["test_predictions"][:64])
    ref = fitted["jax_model"]
    state = convert.newsgroups_from_arrays(
        vocabulary=list(fitted["vec"].feature_space), pi=np.asarray(ref.pi),
        theta=np.asarray(ref.theta), n_grams=2, device="cpu",
    )
    np.testing.assert_array_equal(state.servable(docs[:batch]).numpy(),
                                  res["test_predictions"][:batch])


def test_cli_on_a_tree(tree):
    res = pt_ng.main(["--trainLocation", tree[0], "--testLocation", tree[1], "--nGrams", "1",
                      "--commonFeatures", "2000", "--device", "cpu"])
    assert res["test_error"] < 20.0 and res["num_features"] == 2000


def test_cli_needs_a_card_by_default(tree, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        pt_ng.main(["--trainLocation", tree[0], "--testLocation", tree[1]])
