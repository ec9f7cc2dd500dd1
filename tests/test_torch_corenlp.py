"""keystone_tpu_torch's CoreNLP-equivalent featurizer against the JAX
package's (host Python in both): the reference suite's cases, the open-
vocabulary rules, the copied tables, and a seeded batch of synthetic
documents through both packages' ``CoreNLPFeatureExtractor((1, 2, 3))``.

Tolerance: none; the output lists must be equal."""

import numpy as np
import pytest

from keystone_tpu.ops import corenlp as jc
from keystone_tpu_torch.ops import corenlp as pc
from keystone_tpu_torch.testing.corpus import pseudo_words

TABLES = ("_IRREGULAR", "_NO_STRIP", "_OE_PLURALS", "_PERSON_NAMES", "_LOCATIONS",
          "_ORG_SUFFIXES", "_ORG_NAMES", "_VOWELS")
PATTERNS = ("_SENT_SPLIT", "_TOKEN", "_NON_ALNUM", "_NUMERIC")

LEMMAS = {
    "making": "make", "hopped": "hop", "cities": "city", "churches": "church",
    "ran": "run", "mice": "mouse", "ring": "ring", "glasses": "glass",
    "computers": "computer", "testing": "test", "walked": "walk", "dropped": "drop",
    "flipping": "flip", "baking": "bake", "encoded": "encode", "compilers": "compiler",
    "benchmarks": "benchmark", "boxes": "box", "berries": "berry", "carried": "carry",
    "studied": "study", "heroes": "hero", "echoes": "echo", "potatoes": "potato",
    "shoes": "shoe", "toes": "toe", "throes": "throe", "floes": "floe", "goes": "go",
    "bling": "bling", "zings": "zing",
}


def both(orders, doc):
    got = pc.CoreNLPFeatureExtractor(orders).apply_item(doc)
    assert got == jc.CoreNLPFeatureExtractor(orders).apply_item(doc)
    return got


def test_tables_and_patterns_are_the_jax_packages():
    for name in TABLES:
        assert getattr(pc, name) == getattr(jc, name), name
    for name in PATTERNS:
        assert getattr(pc, name).pattern == getattr(jc, name).pattern, name


@pytest.mark.parametrize("word,lemma", sorted(LEMMAS.items()))
def test_lemmatize_matches_jax(word, lemma):
    assert pc.lemmatize(word) == jc.lemmatize(word) == lemma
    assert pc.lemmatize(lemma) == lemma  # a fixed point
    assert pc.normalize(word.upper() + "!?") == jc.normalize(word.upper() + "!?") == word


def test_reference_lemmatization_case():
    tokens = set(both(range(1, 4), "jumping snakes lakes oceans hunted"))
    assert {"jump", "snake", "lake", "ocean", "hunt"} <= tokens
    assert not {"jumping", "snakes", "lakes", "oceans", "hunted"} & tokens


@pytest.mark.parametrize("doc,orders,present,absent", [
    ("John likes cake and he lives in Florida", (1, 2, 3), {"PERSON", "LOCATION"},
     {"John", "john", "Florida", "florida"}),
    ("Acme Corp hired 300 people from Google", (1,), {"ORGANIZATION", "NUMBER"}, set()),
    ("a b c d", (1, 2, 3), {"a", "b", "c", "d", "a b", "b c", "c d", "a b c", "b c d"}, set()),
    ("a b. c d", (2,), {"a b", "c d"}, {"b c"}),
    ("Zorblax visited Quuxington yesterday", (1,), {"zorblax", "quuxington"},
     {"PERSON", "LOCATION"}),
    ("a 3d scene from the 90s in 4k", (1,), {"3d", "90s", "4k"}, {"NUMBER"}),
    ("In 2026,Google announced", (1,), {"NUMBER", "ORGANIZATION"}, set()),
])
def test_reference_cases_match_jax(doc, orders, present, absent):
    tokens = set(both(orders, doc))
    assert present <= tokens
    assert not absent & tokens


def test_counts_and_batch_form():
    assert both((1,), "Frobnicatex Corp announced a merger with Zyqqly University").count(
        "ORGANIZATION") >= 2
    assert both((1,), "raised 4,200 units worth 3.14 each in 2026").count("NUMBER") == 3
    docs = ["a b", "c", "", "...!?.", "xX9__zz!! 123,456 @@@ ~~~", "élève straße 中文 words",
            "a" * 300 + " ''' don't"]
    got = pc.CoreNLPFeatureExtractor([1, 2])(docs)
    assert got == jc.CoreNLPFeatureExtractor([1, 2])(docs)
    assert got[:4] == [["a", "b", "a b"], ["c"], [], []]


def synthetic_documents(rng, count):
    """Sentences over the gazetteers, the lemma tables, inflected
    pseudo-words, numbers and digit-led tokens, capitalised at random, with
    punctuation after some words."""
    vocab = sorted(pc._PERSON_NAMES | pc._LOCATIONS | pc._ORG_NAMES | pc._ORG_SUFFIXES
                   | set(pc._IRREGULAR) | pc._NO_STRIP | pc._OE_PLURALS | set(LEMMAS))
    base = list(pseudo_words(400))
    suffixes = ["", "s", "es", "ies", "ed", "ied", "ing", "oes", "ches", "er"]
    numbers = ["3", "42", "4,200", "3.14", "2026", "90s", "3d", "4k", "1,000,000"]
    marks = [""] * 8 + [".", ",", "?", "!", "'s", ";"]
    docs = []
    for _ in range(count):
        words = []
        for _ in range(int(rng.integers(5, 60))):
            kind = rng.random()
            if kind < 0.45:
                w = vocab[int(rng.integers(len(vocab)))]
            elif kind < 0.9:
                w = base[int(rng.integers(len(base)))] + suffixes[int(rng.integers(len(suffixes)))]
            else:
                w = numbers[int(rng.integers(len(numbers)))]
            if rng.random() < 0.3:
                w = w.capitalize()
            words.append(w + marks[int(rng.integers(len(marks)))])
        docs.append(" ".join(words))
    return docs


def test_synthetic_documents_match_jax():
    docs = synthetic_documents(np.random.default_rng(11), 300)
    got = pc.CoreNLPFeatureExtractor((1, 2, 3))(docs)
    assert got == jc.CoreNLPFeatureExtractor((1, 2, 3))(docs)
    flat = [g for grams in got for g in grams]
    assert len(flat) > 10_000
    for tag in ("PERSON", "LOCATION", "ORGANIZATION", "NUMBER"):
        assert tag in flat, tag
