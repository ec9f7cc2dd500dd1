"""MnistRandomFFT on PyTorch/CUDA (counterpart of
keystone_tpu/workloads/mnist_random_fft.py, eager single-device path).

Flow: CSV load (labels 1-indexed in column 0) -> per FFT group,
blockSize/512 chains of RandomSignNode -> PaddedFFT -> LinearRectifier(0)
(cuFFT on the card) -> ZipVectors within the group ->
BlockLeastSquares(blockSize, 1 pass, lambda) on the list of group batches
-> streaming evaluation after every block on the train split, then on the
test split (the last call sees the full model) -> MaxClassifier ->
MulticlassClassifierEvaluator.  The fitted chain
``GroupConcatFeaturizer(groups) >> model >> MaxClassifier`` is the
servable pipeline.

Run: ``python -m keystone_tpu_torch.workloads.mnist_random_fft
--trainLocation train.csv --testLocation test.csv [--device cpu]``.
"""

from __future__ import annotations

import argparse
import logging
import math
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..core.pipeline import Pipeline
from ..evaluation.multiclass import MulticlassClassifierEvaluator
from ..loaders.csv_loader import LabeledData, csv_data_loader
from ..ops.stats import LinearRectifier, PaddedFFT, RandomSignNode
from ..ops.util import (
    ClassLabelIndicatorsFromIntLabels,
    GroupConcatFeaturizer,
    MaxClassifier,
    ZipVectors,
)
from ..solvers.block import BlockLeastSquaresEstimator, BlockLinearMapper
from ..utils.platform import resolve_device, synchronize
from ..utils.stats import check_finite

_log = logging.getLogger(__name__)


@dataclass
class MnistRandomFFTConfig:
    train_location: str = ""
    test_location: str = ""
    num_ffts: int = 200
    block_size: int = 2048
    lam: float | None = None
    seed: int = 0
    mnist_image_size: int = 784
    num_classes: int = 10
    device: str = "cuda"


def fft_chain(signs) -> Pipeline:
    """One random-FFT feature chain with the given ±1 signs."""
    return Pipeline([RandomSignNode(signs), PaddedFFT(), LinearRectifier(0.0)])


def build_featurizer_batches(conf: MnistRandomFFTConfig, device) -> list[list[Pipeline]]:
    """The FFT groups: ceil(numFFTs / (blockSize/512)) groups of
    blockSize/512 chains on ``device``, signs drawn from one generator
    seeded with ``conf.seed``."""
    dev = resolve_device(device)
    ffts_per_batch = conf.block_size // 512
    num_fft_batches = math.ceil(conf.num_ffts / ffts_per_batch)
    gen = torch.Generator().manual_seed(conf.seed)
    return [
        [
            fft_chain(RandomSignNode.create(conf.mnist_image_size, gen, dev).signs)
            for _ in range(ffts_per_batch)
        ]
        for _ in range(num_fft_batches)
    ]


def featurize_groups(groups, data: torch.Tensor) -> list[torch.Tensor]:
    """One [n, group width] feature batch per group."""
    return [ZipVectors.apply([chain(data) for chain in chains]) for chains in groups]


def servable_pipeline(groups, model: BlockLinearMapper) -> Pipeline:
    return Pipeline([GroupConcatFeaturizer(groups), model, MaxClassifier()])


def run(conf: MnistRandomFFTConfig, train: LabeledData, test: LabeledData) -> dict:
    """Fit on ``train``, evaluate on ``train`` and ``test`` block by block.
    The results carry the fitted servable pipeline under ``"servable"``."""
    dev = resolve_device(conf.device)
    t0 = time.perf_counter()
    groups = build_featurizer_batches(conf, dev)
    train_labels = torch.from_numpy(np.asarray(train.labels)).to(dev)
    test_labels = torch.from_numpy(np.asarray(test.labels)).to(dev)
    labels = ClassLabelIndicatorsFromIntLabels(conf.num_classes)(train_labels)
    train_data = torch.from_numpy(np.ascontiguousarray(train.data, np.float32)).to(dev)
    test_data = torch.from_numpy(np.ascontiguousarray(test.data, np.float32)).to(dev)
    # One group on the whole split first, so the clock below reads steady
    # state: cuFFT plans its transform for each batch size on first use.
    featurize_groups(groups[:1], train_data)
    synchronize(dev)

    t_feat = time.perf_counter()
    training_batches = featurize_groups(groups, train_data)
    synchronize(dev)
    feat_secs = time.perf_counter() - t_feat

    t_solve = time.perf_counter()
    model = BlockLeastSquaresEstimator(conf.block_size, 1, conf.lam or 0.0).fit(
        training_batches, labels
    )
    check_finite("mnist random-fft model", *model.xs, model.b)
    solve_secs = time.perf_counter() - t_solve

    results: dict = {}

    def train_eval(pred):
        metrics = MulticlassClassifierEvaluator(
            MaxClassifier()(pred), train_labels, conf.num_classes
        )
        results["train_error"] = 100.0 * metrics.total_error

    def test_eval(pred):
        predicted = MaxClassifier()(pred)
        metrics = MulticlassClassifierEvaluator(predicted, test_labels, conf.num_classes)
        results["test_error"] = 100.0 * metrics.total_error
        results["test_predictions"] = predicted

    # Streaming evaluation after each block; the last call sees the full model.
    t_eval = time.perf_counter()
    model.apply_and_evaluate(training_batches, train_eval)
    _log.info("Train Error is %s%%", results["train_error"])
    del training_batches
    test_batches = featurize_groups(groups, test_data)
    model.apply_and_evaluate(test_batches, test_eval)
    _log.info("TEST Error is %s%%", results["test_error"])
    synchronize(dev)
    eval_secs = time.perf_counter() - t_eval

    results["test_predictions"] = results["test_predictions"].cpu().numpy()
    results["seconds"] = time.perf_counter() - t0
    results.update(
        featurize_seconds=feat_secs,
        featurize_examples_per_sec=len(train.labels) / feat_secs,
        solve_seconds=solve_secs,
        eval_seconds=eval_secs,
        servable=servable_pipeline(groups, model),
    )
    _log.info("Pipeline took %.3f s", results["seconds"])
    return results


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("MnistRandomFFT")
    p.add_argument("--trainLocation", required=True, help="CSV, 1-indexed label in column 0")
    p.add_argument("--testLocation", required=True, help="CSV, 1-indexed label in column 0")
    p.add_argument("--numFFTs", type=int, default=200)
    p.add_argument("--blockSize", type=int, default=2048)
    p.add_argument("--lambda", dest="lam", type=float, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--device", default="cuda", help="'cuda' (default; raises without a card) or 'cpu'"
    )
    a = p.parse_args(argv)
    if a.blockSize <= 0 or a.blockSize % 512 != 0:
        p.error("--blockSize must be a positive multiple of 512")
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")
    conf = MnistRandomFFTConfig(
        train_location=a.trainLocation,
        test_location=a.testLocation,
        num_ffts=a.numFFTs,
        block_size=a.blockSize,
        lam=a.lam,
        seed=a.seed,
        device=a.device,
    )
    resolve_device(conf.device)
    t_load = time.perf_counter()
    train = LabeledData.from_rows(csv_data_loader(conf.train_location), one_indexed=True)
    test = LabeledData.from_rows(csv_data_loader(conf.test_location), one_indexed=True)
    load_secs = time.perf_counter() - t_load
    # The reference fixes 784 pixels; the width comes from the data here,
    # as in the JAX package, so any pixel count runs.
    conf.mnist_image_size = train.data.shape[1]
    results = run(conf, train, test)
    results["load_seconds"] = load_secs
    return results


if __name__ == "__main__":
    main()
