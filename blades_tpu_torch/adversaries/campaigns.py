"""Campaign adversaries: attacks that adapt over virtual time (counterpart
of ``blades_tpu/adversaries/campaigns.py``).

Attack strength and attacker population change on a schedule over the
async engine's virtual tick clock.  Each malicious lane decides from its
own arrival tick (``ticks=``, the per-event column the cycle passes when
the adversary declares ``wants_ticks``), so a cycle straddling a
schedule boundary forges each event against the regime it arrived
under.  Campaigns declare ``requires_virtual_time``; the config pins them
to ``execution='async'``.
"""

from __future__ import annotations

import dataclasses
from statistics import NormalDist
from typing import Tuple

import torch

from blades_tpu_torch.adversaries.base import Adversary, benign_mean_std
from blades_tpu_torch.adversaries.update_attacks import _negate_first_half
from blades_tpu_torch.ops.aggregators import Signguard


def _normalize_schedule(schedule) -> Tuple[Tuple[int, float], ...]:
    """A piecewise-constant ``((tick, value), ...)`` schedule: absolute
    ticks, strictly increasing, starting at 0."""
    out = tuple((int(t), float(v)) for t, v in schedule)
    if not out:
        raise ValueError("campaign schedule must be non-empty")
    if out[0][0] != 0:
        raise ValueError(
            f"campaign schedule must start at tick 0, got {out[0][0]} "
            "(absolute virtual ticks, like arrivals' rate_schedule)")
    ticks = [t for t, _ in out]
    if any(b <= a for a, b in zip(ticks, ticks[1:])):
        raise ValueError(
            f"campaign schedule ticks must be strictly increasing, got "
            f"{ticks}")
    return out


def _schedule_at(schedule, ticks: torch.Tensor) -> torch.Tensor:
    """Piecewise-constant f32 lookup: segment i covers [tick_i,
    tick_{i+1})."""
    bounds = torch.tensor([t for t, _ in schedule[1:]], dtype=torch.int64,
                          device=ticks.device)
    values = torch.tensor([v for _, v in schedule], dtype=torch.float32,
                          device=ticks.device)
    return values[torch.searchsorted(bounds, ticks.to(torch.int64),
                                     right=True)]


def _ticks(ticks, updates):
    if ticks is None:
        return torch.zeros((updates.shape[0],), dtype=torch.int64,
                           device=updates.device)
    return torch.as_tensor(ticks).to(updates.device)


@dataclasses.dataclass(frozen=True)
class DiurnalALIECampaign(Adversary):
    """ALIE with diurnally scheduled strength (registered ``DiurnalALIE``):
    for ``duty * period`` ticks of every ``period``-tick day the forged
    deviation runs at ``high`` x ALIE's ``z_max``, off-peak at ``low`` x
    (``low=0`` ships the benign mean).  SignGuard-aware like ALIE (the
    deviation's first half negated)."""

    num_clients: int = 60
    num_byzantine: int = 0
    period: int = 64
    duty: float = 0.5
    low: float = 0.0
    high: float = 1.0
    phase: int = 0

    def __post_init__(self):
        if self.period < 2:
            raise ValueError("DiurnalALIE period must be >= 2 ticks")
        if not (0.0 < self.duty < 1.0):
            raise ValueError("DiurnalALIE duty must be in (0, 1)")

    @property
    def wants_ticks(self) -> bool:
        """The async cycle passes the per-event arrival ticks."""
        return True

    @property
    def requires_virtual_time(self) -> bool:
        return True

    @property
    def z_max(self) -> float:
        n, f = self.num_clients, self.num_byzantine
        s = n // 2 + 1 - f
        cdf = (n - f - s) / max(n - f, 1)
        return NormalDist().inv_cdf(min(max(cdf, 1e-9), 1.0 - 1e-9))

    def on_updates_ready(self, updates, malicious, *, noise=None,
                         generator=None, aggregator=None, shard=None,
                         ticks=None):
        del noise, generator
        mean, std = benign_mean_std(updates, malicious)
        if isinstance(aggregator, Signguard):
            std = _negate_first_half(std, shard)
        ticks = _ticks(ticks, updates)
        in_peak = torch.remainder(ticks + self.phase, self.period) \
            < int(self.duty * self.period)
        mult = torch.where(
            in_peak, torch.tensor(self.high, dtype=torch.float32),
            torch.tensor(self.low, dtype=torch.float32)).to(updates.dtype)
        forged = mean[None, :] + (mult * self.z_max)[:, None] * std[None, :]
        return torch.where(malicious[:, None], forged, updates)


@dataclasses.dataclass(frozen=True)
class LazyRampCampaign(Adversary):
    """Lazy free-riders activating on a ramp (registered ``LazyRamp``):
    ``ramp`` is a piecewise-constant ``((tick, fraction), ...)`` of the
    active share of the malicious population; lane ``i`` (a prefix lane)
    is active iff its prefix rank is below ``floor(fraction * f)`` at its
    own arrival tick.  Active lanes send ``copy_scale`` x the benign mean
    plus Gaussian camouflage of std ``noise_std`` (``noise``: ``(K, c)``
    standard normals, drawn from ``generator`` when absent); inactive
    lanes ship their honest rows."""

    num_clients: int = 60
    num_byzantine: int = 0
    ramp: Tuple[Tuple[int, float], ...] = ((0, 0.0),)
    copy_scale: float = 1.0
    noise_std: float = 1e-3

    def __post_init__(self):
        ramp = _normalize_schedule(self.ramp)
        for t, frac in ramp:
            if not (0.0 <= frac <= 1.0):
                raise ValueError(
                    f"LazyRamp fraction at tick {t} must be in [0, 1], "
                    f"got {frac}")
        object.__setattr__(self, "ramp", ramp)

    @property
    def wants_ticks(self) -> bool:
        return True

    @property
    def requires_virtual_time(self) -> bool:
        return True

    def on_updates_ready(self, updates, malicious, *, noise=None,
                         generator=None, aggregator=None, shard=None,
                         ticks=None):
        del aggregator, shard
        frac = _schedule_at(self.ramp, _ticks(ticks, updates))
        active_count = torch.floor(
            frac * float(self.num_byzantine) + 1e-6).to(torch.int64)
        rank = torch.cumsum(malicious.to(torch.int64), 0) - 1
        active = malicious & (rank < active_count)
        z = noise if noise is not None else torch.randn(
            updates.shape, generator=generator, device=updates.device)
        camo = self.noise_std * z.to(device=updates.device,
                                     dtype=updates.dtype)
        mean, _ = benign_mean_std(updates, malicious)
        forged = self.copy_scale * mean[None, :] + camo
        return torch.where(active[:, None], forged, updates)
