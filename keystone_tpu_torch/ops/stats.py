"""Statistical feature nodes (counterpart of keystone_tpu/ops/stats.py)."""

from __future__ import annotations

import torch

from ..core.pipeline import Estimator, Transformer


class StandardScalerModel(Transformer):
    """Subtract column means, optionally divide by column std."""

    def __init__(self, mean, std=None):
        self.mean = mean
        self.std = std

    def __call__(self, batch):
        out = batch - self.mean
        if self.std is not None:
            out = out / self.std
        return out


class StandardScaler(Estimator):
    """Column mean/std from one pass of (sum x, sum x^2).  Sample (n-1)
    variance; any std that is NaN, Inf or below ``eps`` becomes 1.0."""

    def __init__(self, normalize_std_dev: bool = True, eps: float = 1e-12):
        self.normalize_std_dev = normalize_std_dev
        self.eps = eps

    def fit(self, data, nvalid: int | None = None) -> StandardScalerModel:
        cnt = float(nvalid if nvalid is not None else data.shape[0])
        mean = data.sum(dim=0) / cnt
        if not self.normalize_std_dev:
            return StandardScalerModel(mean, None)
        var = ((data * data).sum(dim=0) - cnt * mean * mean) / (cnt - 1.0)
        std = torch.sqrt(var)
        bad = torch.isnan(std) | torch.isinf(std) | (torch.abs(std) < self.eps)
        std = torch.where(bad, torch.ones_like(std), std)
        return StandardScalerModel(mean, std)


class Sampler:
    """``takeSample``-style row sampler without replacement.

    Draws from its own ``torch.Generator`` seeded with ``seed``; it does not
    reproduce the JAX package's ``jax.random.choice`` rows."""

    def __init__(self, size: int, seed: int = 42):
        self.size = size
        self.seed = seed

    def __call__(self, data):
        n = data.shape[0]
        if n <= self.size:
            return data
        gen = torch.Generator().manual_seed(self.seed)
        idx = torch.randperm(n, generator=gen)[: self.size]
        return data[idx.to(data.device)]


class NormalizeRows(Transformer):
    """L2-normalise each row, the norm floored at 2.2e-16."""

    def __call__(self, batch):
        norm = torch.linalg.vector_norm(batch, dim=-1, keepdim=True)
        return batch / torch.clamp_min(norm, 2.2e-16)


class SignedHellingerMapper(Transformer):
    """Signed square root ``sign(x) * sqrt(|x|)``, elementwise."""

    def __call__(self, batch):
        return torch.sign(batch) * torch.sqrt(torch.abs(batch))
