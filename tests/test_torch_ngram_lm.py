"""keystone_tpu_torch's n-gram language model against the JAX package's
(host Python in both): the indexers, the counts, Stupid Backoff's scores,
the initial-bigram shard function and the sharded scoring path.

Tolerance: none.  Everything here is integer and Python float arithmetic
over dicts in the same order, so counts, shard sizes and scores must be
equal, not close."""

import numpy as np
import pytest

from keystone_tpu.ops import ngram_lm as jl
from keystone_tpu.ops import nlp as jnlp
from keystone_tpu_torch.ops import ngram_lm as pl
from keystone_tpu_torch.ops import nlp as pnlp
from keystone_tpu_torch.testing.corpus import write_newsgroups_tree

DATA = ["Winter is coming", "Finals are coming", "Summer is coming really soon"]
NGRAMS = [[1], [1, 1], [1, 1, 1], [7, 42, 99], [0, 5], [(1 << 20) - 1, 3, 0]]


def counts(nlp, lm, lines, orders, mode):
    toks = nlp.Tokenizer()(lines)
    return lm.NGramsCounts(mode)(nlp.NGramsFeaturizer(orders)(toks))


def fit(nlp, lm, lines):
    ngrams = counts(nlp, lm, lines, range(2, 6), "noAdd")
    unigrams = {k[0]: v for k, v in counts(nlp, lm, lines, [1], "default")}
    return lm.StupidBackoffEstimator(unigrams).fit(ngrams)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A seeded corpus of 240 lines, one synthetic document each."""
    root = tmp_path_factory.mktemp("lm_corpus")
    classes = ["comp.a", "comp.b", "rec.a", "sci.a"]
    write_newsgroups_tree(root, classes, [60] * 4, np.random.default_rng(10),
                          vocab_size=3000, doc_tokens=(20, 80))
    return [p.read_text().strip() for c in classes for p in sorted((root / c).iterdir())]


@pytest.fixture(scope="module")
def encoded(corpus):
    """Each package's own text pipeline on the corpus: (unigram counts,
    encoded lines)."""
    out = {}
    for name, nlp in (("jax", jnlp), ("port", pnlp)):
        text = nlp.Tokenizer()(corpus)
        enc = nlp.fit_word_frequency_encoder(text)
        out[name] = (enc.unigram_counts, enc(text))
    return out


@pytest.mark.parametrize("ngram", NGRAMS)
def test_bit_pack_indexer_matches_jax(ngram):
    port, ref = pl.NaiveBitPackIndexer, jl.NaiveBitPackIndexer
    packed = port.pack(ngram)
    assert packed == ref.pack(ngram)
    assert port.ngram_order(packed) == ref.ngram_order(packed) == len(ngram)
    assert [port.unpack(packed, p) for p in range(len(ngram))] == list(ngram)
    if len(ngram) > 1:
        for op in ("remove_farthest_word", "remove_current_word"):
            assert getattr(port, op)(packed) == getattr(ref, op)(packed)
        assert port.remove_farthest_word(packed) == port.pack(ngram[1:])
        assert port.remove_current_word(packed) == port.pack(ngram[:-1])


def test_bit_pack_exact_values_and_guards():
    ix = pl.NaiveBitPackIndexer
    assert ix.pack([1]) == 2**40
    assert ix.pack([1, 1]) == 2**40 + 2**20 + 2**60
    assert ix.pack([1, 1, 1]) == 1 + 2**40 + 2**20 + 2**61
    for mod in (pl, jl):
        with pytest.raises(ValueError, match="2\\^20"):
            mod.NaiveBitPackIndexer.pack([1 << 20])
        with pytest.raises(ValueError, match="order need"):
            mod.NaiveBitPackIndexer.pack([1, 2, 3, 4])
        with pytest.raises(ValueError, match="control bits"):
            mod.NaiveBitPackIndexer.ngram_order(3 << 60)
        with pytest.raises(ValueError, match="position"):
            mod.NaiveBitPackIndexer.unpack(0, 3)
        with pytest.raises(ValueError, match="not supported"):
            mod.NaiveBitPackIndexer.remove_farthest_word(mod.NaiveBitPackIndexer.pack([4]))
    assert pl.MAX_WORD == jl.MAX_WORD == 1 << 20


@pytest.mark.parametrize("ngram", [tuple(g) for g in NGRAMS] + [("a", "b", "c", "d", "e")])
def test_tuple_indexer_matches_jax(ngram):
    port, ref = pl.NGramIndexerImpl(), jl.NGramIndexerImpl()
    assert port.pack(list(ngram)) == ref.pack(list(ngram)) == ngram
    assert port.ngram_order(ngram) == ref.ngram_order(ngram)
    assert port.remove_farthest_word(ngram) == ref.remove_farthest_word(ngram)
    assert port.remove_current_word(ngram) == ref.remove_current_word(ngram)
    assert [port.unpack(ngram, p) for p in range(len(ngram))] == list(ngram)


def test_hand_computed_scores():
    # StupidBackoffSuite "calculates correct scores" (:60-76)
    lm = fit(pnlp, pl, DATA)
    assert lm.score(("is", "coming")) == 2.0 / 2.0
    assert lm.score(("is", "coming", "really")) == 1.0 / 2.0
    assert lm.score(("is", "unseen-coming")) == 0.0
    assert lm.score(("is-unseen", "coming")) == lm.alpha * 3.0 / lm.num_tokens
    assert lm.scores() == fit(jnlp, jl, DATA).scores()


@pytest.mark.parametrize("mode", ["default", "noAdd"])
def test_counts_match_jax(corpus, mode):
    got = counts(pnlp, pl, corpus, range(1, 4), mode)
    assert got == counts(jnlp, jl, corpus, range(1, 4), mode)
    assert len(got) > 1000
    if mode == "default":
        assert all(a[1] >= b[1] for a, b in zip(got, got[1:]))
    with pytest.raises(ValueError, match="mode"):
        pl.NGramsCounts("sorted")


@pytest.mark.parametrize("num_shards", [1, 3, 16])
def test_scores_and_sharded_scores_equal_jax(encoded, num_shards):
    models = {}
    for name, nlp, lm in (("jax", jnlp, jl), ("port", pnlp, pl)):
        unigrams, enc = encoded[name]
        grams = lm.NGramsCounts("noAdd")(nlp.NGramsFeaturizer(range(2, 4))(enc))
        models[name] = lm.StupidBackoffEstimator(unigrams).fit(grams)
    port, ref = models["port"], models["jax"]
    assert port.ngram_counts == ref.ngram_counts
    assert port.num_tokens == ref.num_tokens
    want = ref.scores()
    assert port.scores() == want
    got, sizes = pl.sharded_scores(port.ngram_counts, port.unigram_counts, num_shards,
                                   alpha=port.alpha)
    ref_got, ref_sizes = jl.sharded_scores(ref.ngram_counts, ref.unigram_counts, num_shards,
                                           alpha=ref.alpha)
    assert got == ref_got == want
    assert sizes == ref_sizes
    assert sum(sizes.values()) == len(port.ngram_counts)
    assert set(sizes) <= set(range(num_shards))
    if num_shards == 16:
        assert len(sizes) == 16


def test_jax_counted_tables_fit_the_same_model(encoded):
    # the fitted state of this slice is plain dicts: the JAX package's
    # counted tables go straight into the port's estimator
    unigrams, enc = encoded["jax"]
    grams = jl.NGramsCounts("noAdd")(jnlp.NGramsFeaturizer(range(2, 4))(enc))
    ref = jl.StupidBackoffEstimator(unigrams).fit(grams)
    port = pl.StupidBackoffEstimator(unigrams).fit(grams)
    assert port.num_tokens == ref.num_tokens
    assert port.scores() == ref.scores()


def test_shard_function_matches_jax(encoded):
    unigrams, enc = encoded["port"]
    grams = pl.NGramsCounts("noAdd")(pnlp.NGramsFeaturizer(range(1, 4))(enc))
    for ngram, _ in grams[:2000]:
        for shards in (1, 3, 7, 16):
            assert pl.shard_by_initial_bigram(ngram, shards) == jl.shard_by_initial_bigram(
                ngram, shards)
    assert pl.shard_by_initial_bigram((5,), 16) == 0


def test_sharded_scores_route_cross_shard_backoffs(encoded):
    lm = fit(pnlp, pl, DATA)
    unseen = [
        ("is-unseen", "coming"),  # -> unigram "coming"
        ("summer", "finals", "coming"),  # -> ("finals", "coming") -> unigram
        ("winter", "is", "soon"),  # -> ("is", "soon") -> unigram
        ("coming",),  # a direct unigram query reads the ngram table
    ]
    got, _ = pl.sharded_scores(lm.ngram_counts, lm.unigram_counts, 8, alpha=lm.alpha,
                               queries=unseen)
    ref = fit(jnlp, jl, DATA)
    ref_got, _ = jl.sharded_scores(ref.ngram_counts, ref.unigram_counts, 8, alpha=ref.alpha,
                                   queries=unseen)
    assert got == ref_got
    for q in unseen:
        assert got[q] == lm.score(q), q
    assert got[("is-unseen", "coming")] > 0.0
    # and on the corpus: unseen trigrams of seen words back off across shards
    unigrams, enc = encoded["port"]
    grams = pl.NGramsCounts("noAdd")(pnlp.NGramsFeaturizer(range(2, 4))(enc))
    model = pl.StupidBackoffEstimator(unigrams).fit(grams)
    queries = [(a, b, c) for a, b, c in zip(range(0, 60), range(60, 120), range(120, 180))]
    queries = [q for q in queries if q not in model.ngram_counts]
    got, _ = pl.sharded_scores(model.ngram_counts, unigrams, 16, queries=queries)
    assert got == {q: model.score(q) for q in queries}


def test_zero_context_and_unit_interval_raise_in_both():
    for lm in (pl, jl):
        model = lm.StupidBackoffModel({("a", "b", "c"): 1}, {"a": 1, "b": 1, "c": 1}, 3)
        with pytest.raises(ValueError, match="zero count"):
            model.score(("a", "b", "c"))
        model = lm.StupidBackoffModel({("a", "b"): 5}, {"a": 2, "b": 5}, 7)
        with pytest.raises(AssertionError, match="not in \\[0,1\\]"):
            model.scores()


def test_context_colocation_invariant():
    lm = fit(pnlp, pl, DATA)
    ix = pl.NGramIndexerImpl()
    for ngram in lm.ngram_counts:
        curr = ngram
        while ix.ngram_order(curr) > 2:
            ctx = ix.remove_current_word(curr)
            assert pl.shard_by_initial_bigram(curr, 4) == pl.shard_by_initial_bigram(ctx, 4)
            curr = ctx
