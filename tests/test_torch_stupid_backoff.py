"""keystone_tpu_torch's StupidBackoffPipeline against the JAX package's
(host Python in both): ``run`` on the same lines, and ``main`` through a
``--trainData`` file.

Tolerance: none; the corpus statistics and shard sizes are integers and
must be equal."""

import numpy as np
import pytest

from keystone_tpu.workloads import stupid_backoff as jsb
from keystone_tpu_torch.testing.corpus import write_newsgroups_tree
from keystone_tpu_torch.workloads import stupid_backoff as psb
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401

KEYS = ("num_tokens", "vocab_size", "num_ngrams", "shard_sizes", "sharded_scoring_equal")


@pytest.fixture(scope="module")
def lines(tmp_path_factory):
    root = tmp_path_factory.mktemp("sb_corpus")
    classes = ["alt.a", "comp.a", "sci.a"]
    write_newsgroups_tree(root, classes, [40] * 3, np.random.default_rng(3),
                          vocab_size=2000, doc_tokens=(20, 60))
    return [p.read_text().strip() for c in classes for p in sorted((root / c).iterdir())]


@pytest.mark.parametrize("num_parts,n", [(16, 3), (3, 4), (1, 2)])
def test_run_matches_jax(lines, num_parts, n):
    got = psb.run(psb.StupidBackoffConfig(num_parts=num_parts, n=n), lines)
    ref = jsb.run(jsb.StupidBackoffConfig(num_parts=num_parts, n=n), lines)
    assert {k: got[k] for k in KEYS} == {k: ref[k] for k in KEYS}
    assert got["sharded_scoring_equal"] is True
    assert got["num_ngrams"] > 1000
    assert got["seconds"] > 0


def test_main_reads_the_train_file(lines, tmp_path):
    path = tmp_path / "lines.txt"
    path.write_text("\n".join(lines[:60]) + "\n\n")  # a blank line is skipped
    argv = ["--trainData", str(path), "--numParts", "8", "--n", "3"]
    got, ref = psb.main(argv), jsb.main(argv)
    assert {k: got[k] for k in KEYS} == {k: ref[k] for k in KEYS}
    assert psb.StupidBackoffConfig() == psb.StupidBackoffConfig("", 16, 3)
    with pytest.raises(SystemExit):
        psb.main(["--numParts", "8"])  # --trainData is required
    with pytest.raises(SystemExit):
        psb.main(["--trainData", str(path), "--device", "cpu"])  # runs on the host only


def test_run_raises_when_sharded_scores_diverge(lines, monkeypatch):
    real = psb.sharded_scores

    def off_by_one_ulp(*args, **kwargs):
        scores, sizes = real(*args, **kwargs)
        first = next(iter(scores))
        scores[first] = np.nextafter(scores[first], 2.0)
        return scores, sizes

    monkeypatch.setattr(psb, "sharded_scores", off_by_one_ulp)
    with pytest.raises(ValueError, match="diverged"):
        psb.run(psb.StupidBackoffConfig(num_parts=4), lines[:20])
