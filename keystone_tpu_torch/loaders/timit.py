"""Pre-featurized TIMIT loader (counterpart of keystone_tpu/loaders/timit.py).

Features: a CSV of numbers, one frame per row; labels: sparse
``"row label"`` lines, both 1-indexed.  The reference builds the *train*
labels from the test labels' path (TimitFeaturesDataLoader.scala:64), a
copy-paste bug that the JAX package fixes and the port does not reproduce
either.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

TIMIT_DIMENSION = 440
TIMIT_NUM_CLASSES = 147


@dataclass
class TimitSplit:
    data: np.ndarray  # [N, 440] f32
    labels: np.ndarray  # [N] int32, 0-indexed


@dataclass
class TimitFeaturesData:
    train: TimitSplit
    test: TimitSplit


def _parse_sparse_labels(path: str) -> dict[int, int]:
    out: dict[int, int] = {}
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if len(parts) >= 2:
                out[int(parts[0]) - 1] = int(parts[1])
    return out


def _load_split(data_path: str, labels_path: str) -> TimitSplit:
    data = np.loadtxt(data_path, delimiter=",", ndmin=2).astype(np.float32)
    labels_map = _parse_sparse_labels(labels_path)
    labels = np.asarray([labels_map[i] - 1 for i in range(data.shape[0])], np.int32)
    return TimitSplit(data, labels)


def timit_features_loader(
    train_data: str, train_labels: str, test_data: str, test_labels: str
) -> TimitFeaturesData:
    return TimitFeaturesData(
        train=_load_split(train_data, train_labels),
        test=_load_split(test_data, test_labels),
    )
