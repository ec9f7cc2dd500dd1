"""CSV loading (counterpart of keystone_tpu/loaders/csv_loader.py): the
host loads numeric rows into numpy; callers move them to the device."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class LabeledData:
    """(labels, data) pair."""

    labels: np.ndarray
    data: np.ndarray

    @staticmethod
    def from_rows(rows: np.ndarray, label_col: int = 0, one_indexed: bool = False):
        labels = rows[:, label_col].astype(np.int32)
        if one_indexed:
            labels = labels - 1
        data = np.delete(rows, label_col, axis=1)
        return LabeledData(labels=labels, data=data)


def csv_data_loader(path: str, dtype=np.float32) -> np.ndarray:
    """Load a comma-separated numeric file into [N, d]."""
    return np.loadtxt(path, delimiter=",", dtype=dtype, ndmin=2)
