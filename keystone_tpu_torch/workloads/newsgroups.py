"""NewsgroupsPipeline on PyTorch/CUDA (counterpart of
keystone_tpu/workloads/newsgroups.py, single device): 20 Newsgroups text
classification.

Flow: Trim -> LowerCase -> Tokenizer -> NGrams(1..n) -> TermFrequency(x => 1)
-> CommonSparseFeatures(k) -> NaiveBayes -> MaxClassifier ->
MulticlassClassifierEvaluator with its per-class summary.  The text
featurization, the feature space and the naive-Bayes counts are host-side,
as in the JAX package; the scoring of the test documents runs on the
device.  The fitted chain ``[text pipeline, vectorizer, model,
MaxClassifier]`` is the servable pipeline.

With ``--mesh`` (``run(mesh=)``) the test documents are scored
data-parallel over the mesh's data slots (``NaiveBayesModel`` under
``parallel.mesh.use_mesh``), with the same scores bit for bit.

Run: ``python -m keystone_tpu_torch.workloads.newsgroups --trainLocation
train_dir --testLocation test_dir [--mesh 8] [--device cpu]``.
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import time
from dataclasses import dataclass

import torch

from ..core.logging import configure_logging
from ..core.pipeline import Pipeline
from ..evaluation.multiclass import MulticlassClassifierEvaluator
from ..loaders.newsgroups import CLASSES, NewsgroupsData, newsgroups_loader
from ..ops.nlp import LowerCase, NGramsFeaturizer, TermFrequency, Tokenizer, Trim
from ..ops.sparse import CommonSparseFeatures
from ..ops.util import MaxClassifier
from ..parallel.mesh import add_mesh_flag, parse_mesh, use_mesh
from ..solvers.naive_bayes import NaiveBayesEstimator
from ..utils.platform import resolve_device, synchronize

# Named: under ``python -m`` __name__ is __main__, outside the package's log handler.
_log = logging.getLogger("keystone_tpu_torch.workloads.newsgroups")


@dataclass
class NewsgroupsConfig:
    train_location: str = ""
    test_location: str = ""
    n_grams: int = 2
    common_features: int = 100000
    classes: tuple = tuple(CLASSES)
    device: str = "cuda"


def text_pipeline(n_grams: int) -> Pipeline:
    return Pipeline([
        Trim(), LowerCase(), Tokenizer(), NGramsFeaturizer(range(1, n_grams + 1)),
        TermFrequency(lambda x: 1),
    ])


def run(conf: NewsgroupsConfig, train: NewsgroupsData, test: NewsgroupsData,
        mesh=None) -> dict:
    """Fit on ``train``, score ``test``.  ``text_seconds`` is the host's text
    featurization and naive-Bayes fit; ``score_seconds`` the device's
    scoring of the test split (a host clock ending in a synchronize).  With
    ``mesh`` the scoring runs over its data slots."""
    dev = resolve_device(conf.device)
    t0 = time.perf_counter()
    num_classes = len(conf.classes)

    _log.info("Training classifier")
    text_pipe = text_pipeline(conf.n_grams)
    train_terms = text_pipe(train.data)
    vectorizer = CommonSparseFeatures(conf.common_features).fit(train_terms)
    model = NaiveBayesEstimator(num_classes, device=dev).fit(
        vectorizer(train_terms), train.labels
    )
    test_feats = vectorizer(text_pipe(test.data))
    text_secs = time.perf_counter() - t0

    _log.info("Evaluating classifier")
    synchronize(dev)
    t_score = time.perf_counter()
    with use_mesh(mesh) if mesh is not None else contextlib.nullcontext():
        scores = model(test_feats)
    predictions = MaxClassifier()(scores)
    synchronize(dev)
    score_secs = time.perf_counter() - t_score
    ev = MulticlassClassifierEvaluator(
        predictions, torch.from_numpy(test.labels).to(dev), num_classes
    )
    results = {
        "test_error": 100.0 * ev.total_error,
        "seconds": time.perf_counter() - t0,
        "text_seconds": text_secs,
        "score_seconds": score_secs,
        "num_features": len(vectorizer.feature_space),
        "test_nnz": len(test_feats.values),
        "test_scores": scores.cpu().numpy(),
        "test_predictions": predictions.cpu().numpy(),
        "evaluator": ev,
        "servable": Pipeline([text_pipe, vectorizer, model, MaxClassifier()]),
    }
    _log.info("\n%s", ev.summary(list(conf.classes)))
    return results


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("NewsgroupsPipeline")
    p.add_argument("--trainLocation", required=True, help="dir/<class>/<doc> tree")
    p.add_argument("--testLocation", required=True, help="dir/<class>/<doc> tree")
    p.add_argument("--nGrams", type=int, default=2)
    p.add_argument("--commonFeatures", type=int, default=100000)
    p.add_argument(
        "--device", default="cuda", help="'cuda' (default; raises without a card) or 'cpu'"
    )
    add_mesh_flag(p)
    a = p.parse_args(argv)
    configure_logging()
    conf = NewsgroupsConfig(
        train_location=a.trainLocation,
        test_location=a.testLocation,
        n_grams=a.nGrams,
        common_features=a.commonFeatures,
        device=a.device,
    )
    resolve_device(conf.device)
    mesh = parse_mesh(a.mesh, a.device)
    train = newsgroups_loader(conf.train_location)
    test = newsgroups_loader(conf.test_location)
    return run(conf, train, test, mesh=mesh)


if __name__ == "__main__":
    main()
