"""String and n-gram nodes (counterpart of keystone_tpu/ops/nlp.py).

Host-side Python: batches are lists of strings or token lists, and nothing
here touches a device.  The card takes over once the sparse features are
vectorized (``ops/sparse.py``) and scored (``solvers/naive_bayes.py``).
"""

from __future__ import annotations

import re
from collections import defaultdict
from typing import Callable, Sequence

from ..core.pipeline import Transformer


class Tokenizer(Transformer):
    """Split on a regex, by default runs of punctuation and whitespace.
    Like Scala's ``String.split``: leading empty strings are kept, trailing
    ones removed."""

    def __init__(self, sep: str = r"[^\w]+" "|_"):
        self.sep = sep
        self._re = re.compile(sep)

    def __call__(self, batch: Sequence[str]):
        out = []
        for line in batch:
            toks = self._re.split(line)
            while toks and toks[-1] == "":
                toks.pop()
            out.append(toks)
        return out


class Trim(Transformer):
    """Strip leading and trailing whitespace."""

    def __call__(self, batch: Sequence[str]):
        return [s.strip() for s in batch]


class LowerCase(Transformer):
    """Lowercase."""

    def __call__(self, batch: Sequence[str]):
        return [s.lower() for s in batch]


class NGramsFeaturizer(Transformer):
    """All n-grams of the consecutive orders [min..max], as tuples, in the
    reference's order: at each position the min-order gram, then its
    extensions up to the max order."""

    def __init__(self, orders: Sequence[int]):
        orders = list(orders)
        if min(orders) < 1:
            raise ValueError(f"minimum order is not >= 1, found {min(orders)}")
        for a, b in zip(orders, orders[1:]):
            if b != a + 1:
                raise ValueError(f"orders are not consecutive; contains {a} and {b}")
        self.min_order = orders[0]
        self.max_order = orders[-1]

    def __call__(self, batch):
        out = []
        for tokens in batch:
            grams = []
            n = len(tokens)
            for i in range(n - self.min_order + 1):
                for order in range(self.min_order, min(self.max_order, n - i) + 1):
                    grams.append(tuple(tokens[i : i + order]))
            out.append(grams)
        return out


class TermFrequency(Transformer):
    """Term counts in first-seen order, each count mapped by ``fn`` (for
    example ``lambda x: 1`` for presence, the identity for raw counts)."""

    def __init__(self, fn: Callable = lambda x: x):
        self.fn = fn

    def __call__(self, batch):
        out = []
        for terms in batch:
            counts: dict = defaultdict(int)
            for t in terms:
                counts[t] += 1
            out.append([(t, self.fn(c)) for t, c in counts.items()])
        return out


class WordFrequencyEncoder(Transformer):
    """Maps each word to its corpus frequency rank (0 = most frequent);
    unseen words map to -1.  Fitted by :func:`fit_word_frequency_encoder`."""

    def __init__(self, word_index: dict, unigram_counts: dict):
        self.word_index = word_index
        self.unigram_counts = unigram_counts

    def __call__(self, batch):
        wi = self.word_index
        return [[wi.get(tok, -1) for tok in tokens] for tokens in batch]


def fit_word_frequency_encoder(corpus) -> WordFrequencyEncoder:
    """Rank the corpus's words by frequency; ties keep first-seen order."""
    counts: dict = defaultdict(int)
    for tokens in corpus:
        for t in tokens:
            counts[t] += 1
    ranked = sorted(counts.items(), key=lambda kv: -kv[1])
    word_index = {w: i for i, (w, _) in enumerate(ranked)}
    unigram_counts = {word_index[w]: c for w, c in counts.items()}
    return WordFrequencyEncoder(word_index, unigram_counts)
