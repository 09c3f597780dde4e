"""Coordinate-wise update-forging attacks (counterpart of the ALIE / IPM /
Adaptive subset of ``blades_tpu/adversaries/update_attacks.py``).

Each reads the benign rows' statistics and writes one forged row into the
malicious lanes.  The Adaptive attack's per-coordinate uniforms are an
input (``noise``), drawn by the caller from its generator, never inside a
kernel.
"""

from __future__ import annotations

import dataclasses
from statistics import NormalDist

import torch

from blades_tpu_torch.adversaries.base import Adversary, benign_mean_std


@dataclasses.dataclass(frozen=True)
class ALIEAdversary(Adversary):
    """"A Little Is Enough": forged = benign mean + z_max * benign std, with
    z_max the inverse normal CDF at ``(n - f - s) / (n - f)``,
    ``s = n // 2 + 1 - f``."""

    num_clients: int = 60
    num_byzantine: int = 0

    @property
    def z_max(self) -> float:
        n, f = self.num_clients, self.num_byzantine
        s = n // 2 + 1 - f
        cdf = (n - f - s) / max(n - f, 1)
        return NormalDist().inv_cdf(min(max(cdf, 1e-9), 1.0 - 1e-9))

    def on_updates_ready(self, updates, malicious, *, noise=None,
                         generator=None, aggregator=None):
        del noise, generator, aggregator
        mean, std = benign_mean_std(updates, malicious)
        return self.scatter_forged(updates, mean + std * self.z_max,
                                   malicious)


@dataclasses.dataclass(frozen=True)
class IPMAdversary(Adversary):
    """Inner-product manipulation: forged = -scale * benign mean."""

    scale: float = 1.0

    def on_updates_ready(self, updates, malicious, *, noise=None,
                         generator=None, aggregator=None):
        del noise, generator, aggregator
        mean, _ = benign_mean_std(updates, malicious)
        return self.scatter_forged(updates, -self.scale * mean, malicious)


@dataclasses.dataclass(frozen=True)
class AdaptiveAdversary(Adversary):
    """Fang's full-knowledge attack on median / trimmed mean: per
    coordinate, a uniform draw just beyond the benign max (mean < 0) or
    below the benign min (mean > 0), with the four sign cases of the
    reference.  ``noise`` is the ``(d,)`` uniforms; without it they are
    drawn from ``generator``."""

    b: float = 2.0

    def on_updates_ready(self, updates, malicious, *, noise=None,
                         generator=None, aggregator=None):
        del aggregator
        mean, _ = benign_mean_std(updates, malicious)
        benign = (~malicious)[:, None]
        inf = torch.full_like(updates, float("inf"))
        mx = torch.where(benign, updates, -inf).max(0).values
        mn = torch.where(benign, updates, inf).min(0).values
        r = noise if noise is not None else torch.rand(
            mean.shape, generator=generator, device=mean.device)
        b = self.b
        neg_pos = r * ((b - 1.0) * mx) + mx
        neg_neg = r * ((1.0 / b - 1.0) * mx) + mx
        pos_pos = r * ((1.0 - 1.0 / b) * mn) + mn / b
        pos_neg = r * ((1.0 - b) * mn) + mn * b
        forged = torch.where(
            mean < 0, torch.where(mx > 0, neg_pos, neg_neg),
            torch.where(mean > 0, torch.where(mn > 0, pos_pos, pos_neg),
                        mean))
        return self.scatter_forged(updates, forged, malicious)
