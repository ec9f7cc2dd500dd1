"""Utility nodes (counterpart of keystone_tpu/ops/util.py)."""

from __future__ import annotations

import numpy as np
import torch

from ..core.pipeline import Transformer


class ClassLabelIndicatorsFromIntLabels(Transformer):
    """Int label -> ±1 indicator vector: -1 everywhere, +1 at the class."""

    def __init__(self, num_classes: int):
        if num_classes < 2:
            raise ValueError("Must have at least two classes")
        self.num_classes = num_classes

    def __call__(self, labels):
        labels = torch.as_tensor(labels, dtype=torch.long)
        eye = torch.eye(self.num_classes, dtype=torch.float32, device=labels.device)
        return 2.0 * eye[labels] - 1.0


class ClassLabelIndicatorsFromIntArrayLabels(Transformer):
    """Multi-label variant: a ±1 multi-hot from per-example label lists (or
    a padded [N, max_labels] int array, pad = -1)."""

    def __init__(self, num_classes: int):
        if num_classes < 2:
            raise ValueError("Must have at least two classes")
        self.num_classes = num_classes

    def __call__(self, label_arrays):
        out = np.full((len(label_arrays), self.num_classes), -1.0, np.float32)
        for i, labels in enumerate(label_arrays):
            for label in np.asarray(labels).ravel():
                if label >= 0:
                    out[i, int(label)] = 1.0
        return torch.from_numpy(out)


class MatrixVectorizer(Transformer):
    """Flatten each per-example matrix to a vector in column-major order."""

    def __call__(self, batch):
        return batch.transpose(-1, -2).reshape(batch.shape[0], -1)


class MaxClassifier(Transformer):
    """argmax over the score vector (first index on ties)."""

    def __call__(self, batch):
        return torch.argmax(batch, dim=-1)
