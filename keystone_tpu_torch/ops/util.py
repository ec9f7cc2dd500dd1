"""Utility nodes (counterpart of keystone_tpu/ops/util.py)."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..core.pipeline import FunctionNode, Transformer


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


class TopKClassifier(Transformer):
    """Top-k class indices, best first (``torch.topk``, sorted).  Equal
    scores may come out in another order than ``jax.lax.top_k``'s."""

    def __init__(self, k: int):
        self.k = k

    def __call__(self, batch):
        return torch.topk(batch, self.k, dim=-1, sorted=True).indices


class Cast(Transformer):
    """dtype cast (the reference's FloatToDouble, generalised)."""

    def __init__(self, dtype: torch.dtype):
        self.dtype = dtype

    def __call__(self, batch):
        return batch.to(self.dtype)


FloatToDouble = Cast  # alias; pass torch.float64


class ZipVectors(FunctionNode):
    """Concatenate a sequence of feature batches along the feature axis."""

    def __call__(self, batches: Sequence):
        return self.apply(batches)

    @staticmethod
    def apply(batches):
        return torch.cat(list(batches), dim=-1)


class GroupConcatFeaturizer(Transformer):
    """The MnistRandomFFT featurize phase as one chainable node: each group
    of per-FFT chains runs on the same input batch, ZipVectors concatenates
    within the group, and the groups concatenate along the feature axis,
    ``[n, d] -> [n, G * group_width]``.  The fitted block model cuts that
    back into exactly the per-group blocks, so the servable chain
    ``GroupConcatFeaturizer >> model >> MaxClassifier`` scores as the fit
    path's per-group apply does."""

    def __init__(self, groups: Sequence[Sequence[Transformer]]):
        self.groups = tuple(tuple(g) for g in groups)

    def __call__(self, batch):
        return torch.cat(
            [ZipVectors.apply([chain(batch) for chain in group]) for group in self.groups],
            dim=-1,
        )

    def __repr__(self):
        return (
            f"GroupConcatFeaturizer({len(self.groups)} groups x "
            f"{len(self.groups[0]) if self.groups else 0} chains)"
        )


class VectorSplitter(FunctionNode):
    """Split [N, d] features into ⌈d/block_size⌉ feature blocks (views); the
    last block may be short."""

    def __init__(self, block_size: int, num_features: int | None = None):
        self.block_size = block_size
        self.num_features = num_features

    def __call__(self, data):
        d = self.num_features or data.shape[-1]
        return [
            data[..., i : min(i + self.block_size, d)]
            for i in range(0, d, self.block_size)
        ]
