"""Synthetic 20 Newsgroups-shaped corpus (test scaffolding; no entry point
imports it).

20 Newsgroups is not on the machines that run the port, so the tests and
``chip_smoke.py`` write their own ``dir/<class>/<doc>`` trees.  A document
is a few hundred tokens drawn from a Zipf vocabulary of pseudo-words, with
a small share drawn from its class's theme words instead; related classes
(the ``comp.*`` groups, the ``rec.*`` groups, ...) share part of their
themes, so the classes overlap.  Sentences start with a capital and end in
punctuation, so Trim, LowerCase and the Tokenizer all have work to do.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

_LETTERS = np.array(list("etaoinshrdlucmfwypvbgkjqxz"))


def pseudo_words(n: int) -> np.ndarray:
    """``n`` distinct lowercase pseudo-words, shorter for lower ranks."""
    words = []
    for i in range(n):
        digits = []
        i += 26  # at least two letters
        while i:
            digits.append(_LETTERS[i % 26])
            i //= 26
        words.append("".join(digits))
    return np.array(words)


def write_newsgroups_tree(
    root: Path,
    classes,
    docs_per_class,
    rng: np.random.Generator,
    *,
    vocab_size: int = 60_000,
    theme_words: int = 40,
    theme_share: float = 0.05,
    doc_tokens: tuple[int, int] = (120, 480),
) -> int:
    """Write ``docs_per_class[c]`` documents of class ``classes[c]`` under
    ``root/<class>/``; the themes come from a generator of their own, so
    every split written with the same ``vocab_size`` and classes shares
    them.  Returns the number of tokens written."""
    words = pseudo_words(vocab_size)
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    zipf = 1.0 / (ranks + 2.7) ** 1.07
    zipf /= zipf.sum()
    # rng.choice(vocab_size, n, p=zipf) builds this CDF on every call and
    # then draws exactly rng.random(n); built once, the draws are the same.
    cdf = zipf.cumsum()
    cdf /= cdf[-1]
    theme_rng = np.random.default_rng(vocab_size)
    # A theme mixes words of the class's family (the part before the first
    # dot, e.g. "comp") with words of its own, all of middling frequency.
    middling = np.arange(vocab_size // 300, vocab_size // 3)
    families = sorted({c.split(".")[0] for c in classes})
    family_words = {f: theme_rng.choice(middling, theme_words, replace=False) for f in families}
    themes = [
        np.concatenate([family_words[c.split(".")[0]][: theme_words // 2],
                        theme_rng.choice(middling, theme_words, replace=False)])
        for c in classes
    ]
    total = 0
    for c, (cls, count) in enumerate(zip(classes, docs_per_class)):
        cls_dir = Path(root) / cls
        cls_dir.mkdir(parents=True, exist_ok=True)
        for i in range(count):
            n = int(rng.integers(*doc_tokens))
            ids = cdf.searchsorted(rng.random(n), side="right")
            themed = rng.random(n) < theme_share
            ids[themed] = rng.choice(themes[c], int(themed.sum()))
            tokens = words[ids].astype(object)
            starts = np.flatnonzero(rng.random(n) < 0.07)
            tokens[starts] = [t.capitalize() for t in tokens[starts]]
            ends = starts[starts > 0] - 1
            tokens[ends] += rng.choice([".", ",", "?", "!"], len(ends))
            (cls_dir / f"{i:05d}").write_text("  " + " ".join(tokens) + ".\n")
            total += n
    return total
