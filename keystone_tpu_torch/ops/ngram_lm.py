"""N-gram language modelling: indexers, counts and Stupid Backoff
(counterpart of keystone_tpu/ops/ngram_lm.py; reference
src/main/scala/nodes/nlp/indexers.scala:5-135, ngrams.scala:98-183,
StupidBackoff.scala:25-182).

Host Python over dicts, as in the JAX package and the reference: nothing
here touches a device.  N-grams are plain tuples.  The whole count table
lives in one host dict; :func:`shard_by_initial_bigram` is the reference's
``InitialBigramPartitioner`` (every ngram lands on the shard of its backoff
context), and :func:`sharded_scores` scores through that layout.  The
shard function hashes with ``zlib.crc32``, so shard sizes equal the JAX
package's and agree across processes.
"""

from __future__ import annotations

import zlib
from collections import defaultdict
from typing import Sequence

from ..core.pipeline import Estimator, FunctionNode

MAX_WORD = 1 << 20


class NGramIndexerImpl:
    """Tuple-backed indexer (reference indexers.scala:113-135)."""

    min_ngram_order = 1
    max_ngram_order = 5

    def pack(self, ngram: Sequence) -> tuple:
        return tuple(ngram)

    def unpack(self, ngram: tuple, pos: int):
        return ngram[pos]

    def remove_farthest_word(self, ngram: tuple) -> tuple:
        return ngram[1:]

    def remove_current_word(self, ngram: tuple) -> tuple:
        return ngram[:-1]

    def ngram_order(self, ngram: tuple) -> int:
        return len(ngram)


class NaiveBitPackIndexer:
    """Pack <=3 word ids (each < 2^20) into one 64-bit int
    (reference indexers.scala:42-111).  Layout, most significant first:
    [4 control bits][farthest word][middle][current]; left-aligned.
    Control bits: 0=unigram, 1=bigram, 2=trigram."""

    min_ngram_order = 1
    max_ngram_order = 3

    @staticmethod
    def pack(ngram: Sequence[int]) -> int:
        for w in ngram:
            if w >= MAX_WORD:
                raise ValueError(f"word id {w} >= 2^20")
        n = len(ngram)
        if n == 1:
            return ngram[0] << 40
        if n == 2:
            return (ngram[1] << 20) | (ngram[0] << 40) | (1 << 60)
        if n == 3:
            return ngram[2] | (ngram[1] << 20) | (ngram[0] << 40) | (1 << 61)
        raise ValueError("ngram order need to be in { 1, 2, 3 } for now")

    @staticmethod
    def unpack(ngram: int, pos: int) -> int:
        if pos == 0:
            return (ngram >> 40) & (MAX_WORD - 1)
        if pos == 1:
            return (ngram >> 20) & (MAX_WORD - 1)
        if pos == 2:
            return ngram & (MAX_WORD - 1)
        raise ValueError("position must be in { 0, 1, 2 }")

    @classmethod
    def ngram_order(cls, ngram: int) -> int:
        order = (ngram >> 60) & 0xF
        if not (cls.min_ngram_order <= order + 1 <= cls.max_ngram_order):
            raise ValueError(f"raw control bits {order} are invalid")
        return order + 1

    @classmethod
    def remove_farthest_word(cls, ngram: int) -> int:
        order = cls.ngram_order(ngram)
        if order == 2:
            return (ngram & ((1 << 40) - 1)) << 20
        if order == 3:
            return ((ngram & ((1 << 40) - 1)) << 20) | (1 << 60)
        raise ValueError(f"ngram order is either invalid or not supported: {order}")

    @classmethod
    def remove_current_word(cls, ngram: int) -> int:
        order = cls.ngram_order(ngram)
        if order == 2:
            return ngram & ~((1 << 40) - 1) & ~(0xF << 60)
        if order == 3:
            return (ngram & ~((1 << 20) - 1) & ~(0xF << 60)) | (1 << 60)
        raise ValueError(f"ngram order is either invalid or not supported: {order}")


class NGramsCounts(FunctionNode):
    """Count ngram tuples over a corpus of per-line ngram lists
    (reference ngrams.scala:140-183).  'Default' mode returns counts sorted
    by frequency descending; 'noAdd' returns the unsorted dict."""

    def __init__(self, mode: str = "default"):
        if mode not in ("default", "noAdd"):
            raise ValueError("`mode` must be `default` or `noAdd`")
        self.mode = mode

    def __call__(self, lines):
        counts: dict = defaultdict(int)
        for line in lines:
            for gram in line:
                counts[tuple(gram)] += 1
        if self.mode == "default":
            return sorted(counts.items(), key=lambda kv: -kv[1])
        return list(counts.items())


def shard_by_initial_bigram(ngram: tuple, num_shards: int, indexer=None) -> int:
    """The InitialBigramPartitioner function (reference StupidBackoff.scala:25-58):
    ngrams sharing their first two context words land on the same shard, so
    backoff scoring is shard-local."""
    indexer = indexer or NGramIndexerImpl()
    if indexer.ngram_order(ngram) > 1:
        first = indexer.unpack(ngram, 0)
        second = indexer.unpack(ngram, 1)
        # stable across processes (builtin hash() is salted per process —
        # a multi-host layout needs every host to agree on the shard)
        key = repr((first, second)).encode()
        return zlib.crc32(key) % num_shards
    return 0


class StupidBackoffModel:
    """Stupid Backoff LM scores (Brants et al. 2007; reference
    StupidBackoff.scala:97-127).

    S(w | context) = freq(ngram)/freq(context) when seen, else
    α·S(w | shorter context);  S(w) = freq(w)/N.
    """

    def __init__(
        self,
        ngram_counts: dict,
        unigram_counts: dict,
        num_tokens: int,
        alpha: float = 0.4,
        indexer: NGramIndexerImpl | None = None,
    ):
        self.ngram_counts = ngram_counts
        self.unigram_counts = unigram_counts
        self.num_tokens = num_tokens
        self.alpha = alpha
        self.indexer = indexer or NGramIndexerImpl()

    def _count(self, ngram: tuple) -> int:
        return self.ngram_counts.get(ngram, 0)

    def score(self, ngram: Sequence) -> float:
        """Recursive backoff scoring (reference scoreLocally :63-95)."""
        ngram = tuple(ngram)
        ix = self.indexer
        accum = 1.0
        freq = self._count(ngram)
        while True:
            order = ix.ngram_order(ngram)
            if order == 1:
                return accum * freq / self.num_tokens
            if freq != 0:
                context = ix.remove_current_word(ngram)
                if order != 2:
                    context_freq = self._count(context)
                else:
                    context_freq = self.unigram_counts.get(ix.unpack(context, 0), 0)
                if context_freq == 0:
                    raise ValueError(
                        f"ngram {ngram} has count {freq} but its context "
                        f"{context} has zero count — fit with consecutive "
                        "orders (including the context order)"
                    )
                return accum * freq / context_freq
            # out-of-corpus ngram: back off
            ngram = ix.remove_farthest_word(ngram)
            order = ix.ngram_order(ngram)
            if order != 1:
                freq = self._count(ngram)
            else:
                freq = self.unigram_counts.get(ix.unpack(ngram, 0), 0)
            accum *= self.alpha

    def scores(self) -> dict:
        """Score every counted ngram (the reference's scoresRDD)."""
        out = {}
        for ngram, _freq in self.ngram_counts.items():
            s = self.score(ngram)
            if not (0.0 <= s <= 1.0):
                raise AssertionError(f"score = {s:.4f} not in [0,1], ngram = {ngram}")
            out[ngram] = s
        return out


def sharded_scores(
    ngram_counts: dict,
    unigram_counts: dict,
    num_shards: int,
    alpha: float = 0.4,
    indexer: NGramIndexerImpl | None = None,
    queries=None,
) -> tuple[dict, dict]:
    """Score every counted ngram through the SHARDED path the reference's
    InitialBigramPartitioner implies (StupidBackoff.scala:25-58): the count
    table is partitioned by :func:`shard_by_initial_bigram`, each shard
    scores its ngrams against ONLY its local counts (plus the broadcast
    unigram table, which the reference also replicates), and an ngram whose
    backoff shortens past its shard's key — removing the farthest word
    changes the first two words, i.e. the shard — is re-routed to the
    owning shard for the next round with its accumulated alpha, exactly the
    shuffle a multi-host run would perform.  At most ``max_order - 1``
    rounds.

    ``queries``: the ngrams to score — default every counted ngram (the
    reference's scoresRDD).  Counted ngrams score shard-locally in one
    round; UNSEEN queries exercise the backoff re-route.

    Returns ``(scores, shard_sizes)``; the scores are identical to the
    single-table :meth:`StupidBackoffModel.score` (asserted by the
    workload), because each lookup happens on the shard that owns the
    ngram — the co-location invariant made executable."""
    ix = indexer or NGramIndexerImpl()
    num_tokens = sum(unigram_counts.values())
    shards: dict[int, dict] = defaultdict(dict)
    for ngram, cnt in ngram_counts.items():
        shards[shard_by_initial_bigram(ngram, num_shards, ix)][ngram] = cnt
    shard_sizes = {s: len(tab) for s, tab in shards.items()}

    scores: dict = {}
    # Work item: (original ngram, current backoff form, accumulated alpha,
    # backed_off), grouped by the shard owning the CURRENT form.
    work: dict[int, list] = defaultdict(list)
    for ngram in (queries if queries is not None else ngram_counts):
        ngram = ix.pack(ngram) if isinstance(ngram, (list, tuple)) else ngram
        work[shard_by_initial_bigram(ngram, num_shards, ix)].append(
            (ngram, ngram, 1.0, False)
        )
    while work:
        next_work: dict[int, list] = defaultdict(list)
        for shard_id, items in work.items():
            local = shards.get(shard_id, {})
            for orig, ngram, accum, backed_off in items:
                order = ix.ngram_order(ngram)
                if order == 1:
                    # Parity with StupidBackoffModel.score: a DIRECT
                    # order-1 query reads the ngram table (orders 2..n, so
                    # usually 0); only a BACKED-OFF unigram reads the
                    # broadcast unigram table.
                    freq = (
                        unigram_counts.get(ix.unpack(ngram, 0), 0)
                        if backed_off
                        else local.get(ngram, 0)
                    )
                    scores[orig] = accum * freq / num_tokens
                    continue
                freq = local.get(ngram, 0)
                if freq != 0:
                    context = ix.remove_current_word(ngram)
                    if order != 2:
                        # same first two words as the ngram: SHARD-LOCAL by
                        # the co-location invariant
                        context_freq = local.get(context, 0)
                    else:
                        context_freq = unigram_counts.get(
                            ix.unpack(context, 0), 0
                        )
                    if context_freq == 0:
                        raise ValueError(
                            f"ngram {ngram} has count {freq} but its "
                            f"context {context} has zero count on shard "
                            f"{shard_id} — fit with consecutive orders"
                        )
                    scores[orig] = accum * freq / context_freq
                    continue
                # Back off: the shortened form may live on another shard —
                # the re-route is the multi-host shuffle.
                shorter = ix.remove_farthest_word(ngram)
                next_work[
                    shard_by_initial_bigram(shorter, num_shards, ix)
                ].append((orig, shorter, accum * alpha, True))
        work = next_work
    return scores, shard_sizes


class StupidBackoffEstimator(Estimator):
    """Fit from (ngram, count) pairs (reference StupidBackoffEstimator:149-182)."""

    def __init__(self, unigram_counts: dict, alpha: float = 0.4):
        self.unigram_counts = unigram_counts
        self.alpha = alpha

    def fit(self, data) -> StupidBackoffModel:
        counts: dict = defaultdict(int)
        for ngram, cnt in data:
            counts[tuple(ngram)] += cnt
        num_tokens = sum(self.unigram_counts.values())
        return StupidBackoffModel(
            dict(counts), self.unigram_counts, num_tokens, self.alpha
        )
