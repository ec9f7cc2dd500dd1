"""Statistical feature nodes (counterpart of keystone_tpu/ops/stats.py)."""

from __future__ import annotations

import torch

from ..core.pipeline import Estimator, Transformer, node
from ..parallel.collectives import sharded_moments
from ..parallel.mesh import ShardedRows
from ..utils.platform import resolve_device
from ..utils.stats import sqrt_rn, sum_rows


@node(data_fields=("mean", "std"))
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
    variance; any std that is NaN, Inf or below ``eps`` becomes 1.0.  On
    row-sharded data (``parallel.mesh.ShardedRows``) the sums are
    ``parallel.collectives.sharded_moments``: each data block's, added in
    data order."""

    def __init__(self, normalize_std_dev: bool = True, eps: float = 1e-12):
        self.normalize_std_dev = normalize_std_dev
        self.eps = eps

    def fit(self, data, nvalid: int | None = None) -> StandardScalerModel:
        if isinstance(data, ShardedRows):
            _, s, sq = sharded_moments(data)
            nvalid = data.nvalid if nvalid is None else nvalid
        else:
            s, sq = data.sum(dim=0), None
        cnt = float(nvalid if nvalid is not None else data.shape[0])
        mean = s / cnt
        if not self.normalize_std_dev:
            return StandardScalerModel(mean, None)
        if sq is None:
            sq = (data * data).sum(dim=0)
        var = (sq - cnt * mean * mean) / (cnt - 1.0)
        std = sqrt_rn(var)
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


class ColumnSampler:
    """Sample columns without replacement from descriptor matrices:
    ``[N, d, cols]`` or a list of ``[d, cols_i]`` -> ``[d, num_samples]``
    (all columns when there are no more than ``num_samples``).

    Draws from its own ``torch.Generator`` seeded with ``seed``; it does not
    reproduce the JAX package's ``jax.random.choice`` columns."""

    def __init__(self, num_samples: int, seed: int = 42):
        self.num_samples = num_samples
        self.seed = seed

    def __call__(self, mats):
        if isinstance(mats, (list, tuple)):
            cols = torch.cat(list(mats), dim=1)
        else:
            n, d, c = mats.shape
            cols = mats.permute(1, 0, 2).reshape(d, n * c)
        total = cols.shape[1]
        if total <= self.num_samples:
            return cols
        gen = torch.Generator().manual_seed(self.seed)
        idx = torch.randperm(total, generator=gen)[: self.num_samples]
        return cols[:, idx.to(cols.device)]


@node()
class NormalizeRows(Transformer):
    """L2-normalise each row, the norm floored at 2.2e-16.  The squares are
    summed pairwise in a fixed order and rooted correctly rounded
    (``utils.stats.sum_rows``, ``sqrt_rn``): a served row's bits do not
    depend on how many rows share its batch, nor on the device."""

    def __call__(self, batch):
        norm = sqrt_rn(sum_rows(batch * batch))[..., None]
        return batch / torch.clamp_min(norm, 2.2e-16)


@node()
class SignedHellingerMapper(Transformer):
    """Signed square root ``sign(x) * sqrt(|x|)``, elementwise."""

    def __call__(self, batch):
        return torch.sign(batch) * sqrt_rn(torch.abs(batch))


@node(data_fields=("W", "b"))
class CosineRandomFeatures(Transformer):
    """Random Fourier features ``cos(x Wᵀ + b)``: ``W`` [D, d], ``b`` [D].
    The product is one ``torch.matmul`` (cuBLAS on the card, f32 with TF32
    off)."""

    def __init__(self, W, b):
        if b.shape[0] != W.shape[0]:
            raise ValueError("# rows of W must match size of b")
        self.W = W
        self.b = b

    def __call__(self, batch):
        return torch.cos(batch @ self.W.T + self.b)

    @staticmethod
    def create(
        num_input_features: int,
        num_output_features: int,
        gamma: float,
        generator: torch.Generator,
        w_dist: str = "gaussian",
        device="cpu",
    ) -> "CosineRandomFeatures":
        """``W`` normal (an RBF kernel) or Cauchy (a Laplacian kernel) times
        ``gamma``, ``b`` uniform in [0, 2π), drawn in f32 from ``generator``
        (a CPU generator, so the draws do not depend on the device).  They do
        not reproduce the JAX package's ``jax.random`` draws."""
        shape = (num_output_features, num_input_features)
        if w_dist == "gaussian":
            W = torch.randn(shape, generator=generator)
        elif w_dist == "cauchy":
            W = torch.empty(shape).cauchy_(generator=generator)
        else:
            raise ValueError(f"unknown w_dist {w_dist!r}")
        b = torch.rand((num_output_features,), generator=generator) * (2.0 * torch.pi)
        return CosineRandomFeatures((W * gamma).to(device), b.to(device))


def next_power_of_two(i: int) -> int:
    return 1 << (i - 1).bit_length()


@node()
class PaddedFFT(Transformer):
    """Zero-pad to the next power of two and keep the real part of the
    first half of the FFT: d -> next_pow2(d)/2 (cuFFT on the card)."""

    def __call__(self, batch):
        padded = next_power_of_two(batch.shape[-1])
        return torch.fft.rfft(batch, n=padded, dim=-1).real[..., : padded // 2]


@node(data_fields=("signs",))
class RandomSignNode(Transformer):
    """Elementwise random ±1 mask."""

    def __init__(self, signs):
        self.signs = signs

    def __call__(self, batch):
        return batch * self.signs

    @staticmethod
    def create(size: int, generator: torch.Generator, device="cuda") -> "RandomSignNode":
        """Fair ±1 signs drawn from ``generator`` (a CPU generator, so the
        signs do not depend on the device), on ``device`` (the card unless
        the caller asks for the CPU; ``cuda`` without a card raises).  They
        do not reproduce the JAX package's ``jax.random.bernoulli`` bits."""
        dev = resolve_device(device)
        draws = torch.randint(0, 2, (size,), generator=generator, dtype=torch.int64)
        return RandomSignNode((2.0 * draws - 1.0).to(torch.float32).to(dev))


@node(meta_fields=("max_val", "alpha"))
class LinearRectifier(Transformer):
    """``max(max_val, x - alpha)``."""

    def __init__(self, max_val: float = 0.0, alpha: float = 0.0):
        self.max_val = max_val
        self.alpha = alpha

    def __call__(self, batch):
        return torch.clamp_min(batch - self.alpha, self.max_val)
