"""LinearPixels on PyTorch/CUDA (counterpart of
keystone_tpu/workloads/linear_pixels.py, single device): grayscale pixels
straight into a linear solver.

Flow: CIFAR load -> GrayScaler -> ImageVectorizer -> LinearMapEstimator
(normal equations, no ridge) -> MaxClassifier ->
MulticlassClassifierEvaluator; logs the total train and test accuracy, as
the reference does.

Run: ``python -m keystone_tpu_torch.workloads.linear_pixels
--trainLocation train.bin --testLocation test.bin [--device cpu]``.
"""

from __future__ import annotations

import argparse
import logging
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..core.pipeline import Pipeline
from ..evaluation.multiclass import MulticlassClassifierEvaluator
from ..loaders.cifar import LabeledImageBatch, cifar_loader
from ..ops.images import GrayScaler, ImageVectorizer
from ..ops.util import ClassLabelIndicatorsFromIntLabels, MaxClassifier
from ..solvers.linear import LinearMapEstimator
from ..utils.platform import resolve_device, synchronize

_log = logging.getLogger(__name__)


@dataclass
class LinearPixelsConfig:
    train_location: str = ""
    test_location: str = ""
    num_classes: int = 10
    device: str = "cuda"


def run(conf: LinearPixelsConfig, train: LabeledImageBatch, test: LabeledImageBatch) -> dict:
    """Fit on ``train``, score ``train`` and ``test``.  The results carry
    the test predictions and the fitted chain under ``"servable"``."""
    dev = resolve_device(conf.device)
    t0 = time.perf_counter()

    def images(split):
        return torch.from_numpy(np.ascontiguousarray(split.images, np.float32)).to(dev)

    def labels(split):
        return torch.from_numpy(np.asarray(split.labels)).to(dev)

    featurizer = Pipeline([GrayScaler(), ImageVectorizer()])
    train_images = images(train)
    indicators = ClassLabelIndicatorsFromIntLabels(conf.num_classes)(labels(train))
    model = LinearMapEstimator().fit(featurizer(train_images), indicators)
    prediction = Pipeline([featurizer, model, MaxClassifier()])

    train_eval = MulticlassClassifierEvaluator(
        prediction(train_images), labels(train), conf.num_classes
    )
    test_pred = prediction(images(test))
    test_eval = MulticlassClassifierEvaluator(test_pred, labels(test), conf.num_classes)
    synchronize(dev)

    results = {
        "train_accuracy": train_eval.total_accuracy,
        "test_accuracy": test_eval.total_accuracy,
        "test_predictions": test_pred.cpu().numpy(),
        "seconds": time.perf_counter() - t0,
        "servable": prediction,
    }
    _log.info("Training accuracy: \n%s", results["train_accuracy"])
    _log.info("Test accuracy: \n%s", results["test_accuracy"])
    return results


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("LinearPixels")
    p.add_argument("--trainLocation", required=True, help="CIFAR binary")
    p.add_argument("--testLocation", required=True, help="CIFAR binary")
    p.add_argument(
        "--device", default="cuda", help="'cuda' (default; raises without a card) or 'cpu'"
    )
    a = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")
    conf = LinearPixelsConfig(
        train_location=a.trainLocation, test_location=a.testLocation, device=a.device
    )
    resolve_device(conf.device)
    train = cifar_loader(conf.train_location)
    test = cifar_loader(conf.test_location)
    return run(conf, train, test)


if __name__ == "__main__":
    main()
