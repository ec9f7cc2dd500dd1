"""StupidBackoffPipeline — n-gram language model training (counterpart of
keystone_tpu/workloads/stupid_backoff.py; reference
src/main/scala/pipelines/nlp/StupidBackoffPipeline.scala:9-59).

Flow: text lines -> Tokenizer -> WordFrequencyEncoder fit + encode ->
NGramsFeaturizer(2..n) -> NGramsCounts(noAdd) -> StupidBackoffEstimator ->
scores.  Logs the corpus statistics and the first 100 trained scores as
the reference does (:45-53).

``--numParts`` drives the reference's InitialBigramPartitioner layout
(StupidBackoff.scala:25-58) as an executable scoring path
(``ops.ngram_lm.sharded_scores``): each shard scores its ngrams against
its own counts and the broadcast unigram table, and backoffs that leave a
shard are re-routed between rounds.  The run raises unless the sharded
scores equal the single-table model's exactly.

Everything runs on the host, as in the JAX package and the reference, so
the CLI takes no ``--device``.  Run: ``python -m
keystone_tpu_torch.workloads.stupid_backoff --trainData lines.txt
[--numParts 16] [--n 3]``.
"""

from __future__ import annotations

import argparse
import logging
import time
from collections import Counter
from dataclasses import dataclass

from ..core.logging import configure_logging
from ..ops.ngram_lm import NGramsCounts, StupidBackoffEstimator, sharded_scores
from ..ops.nlp import NGramsFeaturizer, Tokenizer, fit_word_frequency_encoder

# Named: under ``python -m`` __name__ is __main__, outside the package's log handler.
_log = logging.getLogger("keystone_tpu_torch.workloads.stupid_backoff")


@dataclass
class StupidBackoffConfig:
    """Flag-parity with the reference scopt config (:13-21)."""

    train_data: str = ""
    num_parts: int = 16
    n: int = 3


def run(conf: StupidBackoffConfig, lines: list) -> dict:
    t0 = time.perf_counter()
    text = Tokenizer()(lines)

    # Vocab generation step (:33-35)
    frequency_encode = fit_word_frequency_encoder(text)
    unigram_counts = frequency_encode.unigram_counts

    # NGram (n >= 2) generation step (:37-42)
    encoded = frequency_encode(text)
    ngrams = NGramsFeaturizer(range(2, conf.n + 1))(encoded)
    ngram_counts = NGramsCounts("noAdd")(ngrams)

    # Stupid backoff scoring step (:44-46)
    language_model = StupidBackoffEstimator(unigram_counts).fit(ngram_counts)
    scores = language_model.scores()

    shard_scores, shard_sizes = sharded_scores(
        language_model.ngram_counts,
        unigram_counts,
        conf.num_parts,
        alpha=language_model.alpha,
    )
    if shard_scores != scores:
        diff = {k for k in scores if shard_scores.get(k) != scores[k]}
        raise ValueError(
            f"sharded scoring diverged from the single-table model on "
            f"{len(diff)} ngram(s) (e.g. {sorted(diff)[:3]}) — the "
            "co-location invariant is broken"
        )

    results = {
        "num_tokens": language_model.num_tokens,
        "vocab_size": len(unigram_counts),
        "num_ngrams": len(scores),
        "shard_sizes": dict(Counter(shard_sizes)),
        "sharded_scoring_equal": True,
        "seconds": time.perf_counter() - t0,
    }
    _log.info(
        "number of tokens: %s\nsize of vocabulary: %s\nnumber of ngrams: %s",
        results["num_tokens"],
        results["vocab_size"],
        results["num_ngrams"],
    )
    _log.info("trained scores of 100 ngrams in the corpus:")
    for ngram, score in list(scores.items())[:100]:
        _log.info("%s -> %.6f", ngram, score)
    return results


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("StupidBackoffPipeline")
    p.add_argument("--trainData", required=True, help="a text file, one line per sentence")
    p.add_argument("--numParts", type=int, default=16)
    p.add_argument("--n", type=int, default=3)
    a = p.parse_args(argv)
    configure_logging()
    conf = StupidBackoffConfig(train_data=a.trainData, num_parts=a.numParts, n=a.n)
    with open(conf.train_data, encoding="utf-8") as fh:
        lines = [ln.rstrip("\n") for ln in fh if ln.strip()]
    return run(conf, lines)


if __name__ == "__main__":
    main()
