"""Deterministic discrete-time Poisson arrival process (counterpart of
``blades_tpu/arrivals/process.py``).

Time is a virtual integer tick.  At each tick every client independently
arrives with Bernoulli probability ``rate`` (geometric inter-arrival
times); ``rate_schedule`` overrides the rate piecewise from listed ticks
on, and ``slow_fraction`` / ``slow_factor`` slow the LAST
``floor(slow_fraction * n)`` lanes (a static suffix, as the malicious
lanes are a prefix).

Realizations are pure in ``(seed, tick)``: a CPU ``torch.Generator``
seeded from ``(seed, 0x0A51, tick)`` alone, independent of the training
stream, so a retried or resumed trial replays identical traffic.  The
JAX package draws from its own PRNG; the engine takes a realization
handed in (``AsyncEngine(..., arrival_realization=)``), which is how the
port is held against it.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from blades_tpu_torch.utils.seeds import generator_of

#: Salt separating the arrival stream from the fault stream when the two
#: processes share a seed.
_ARRIVAL_STREAM = 0x0A51


@dataclasses.dataclass(frozen=True)
class ArrivalProcess:
    """Static arrival config; realizations are pure in ``(seed, tick)``.

    Attributes:
        seed: arrival-process seed, independent of the training seed.
        rate: per-client per-tick Bernoulli arrival probability.
        rate_schedule: optional ``((tick, rate), ...)``: from each listed
            tick on, arrivals run at that rate (``rate`` before the first).
        slow_fraction: fraction of clients (a lane suffix) whose rate is
            multiplied by ``slow_factor``.
        slow_factor: rate multiplier of the slow cohort.
    """

    seed: int = 0
    rate: float = 0.25
    rate_schedule: Optional[Tuple[Tuple[int, float], ...]] = None
    slow_fraction: float = 0.0
    slow_factor: float = 0.25

    def __post_init__(self):
        if not 0.0 < self.rate <= 1.0:
            raise ValueError(
                f"rate must be in (0, 1], got {self.rate} (0 would mean "
                "no client ever arrives)")
        if not 0.0 <= self.slow_fraction <= 1.0:
            raise ValueError(
                f"slow_fraction must be in [0, 1], got {self.slow_fraction}")
        if not 0.0 < self.slow_factor <= 1.0:
            raise ValueError(
                f"slow_factor must be in (0, 1], got {self.slow_factor} "
                "(slow clients arrive less often, never more)")
        if self.rate_schedule is not None:
            sched = tuple(sorted(
                (int(t), float(v)) for t, v in self.rate_schedule))
            for t, v in sched:
                if t < 0 or not 0.0 < v <= 1.0:
                    raise ValueError(
                        f"rate_schedule entries must be (tick >= 0, rate "
                        f"in (0, 1]), got ({t}, {v})")
            object.__setattr__(self, "rate_schedule", sched)

    def rate_at(self, tick: int) -> float:
        """The piecewise-constant arrival rate at ``tick``, in f32."""
        if not self.rate_schedule:
            return float(np.float32(self.rate))
        bounds = [t for t, _ in self.rate_schedule]
        rates = [self.rate] + [v for _, v in self.rate_schedule]
        return float(np.float32(rates[bisect.bisect_right(bounds, tick)]))

    def client_rates(self, tick: int, num_clients: int) -> torch.Tensor:
        """Per-lane f32 arrival rates at ``tick`` (the slow suffix
        multiplied by ``slow_factor``)."""
        r = torch.tensor(self.rate_at(tick), dtype=torch.float32)
        rates = torch.full((num_clients,), float(r), dtype=torch.float32)
        num_slow = int(self.slow_fraction * num_clients)
        if num_slow:
            rates[num_clients - num_slow:] = r * torch.tensor(
                self.slow_factor, dtype=torch.float32)
        return rates

    def arrivals_at(self, tick: int, num_clients: int) -> torch.Tensor:
        """One tick's ``(n,)`` bool realization: client ``i`` delivered
        an update at ``tick``."""
        gen = generator_of(self.seed, _ARRIVAL_STREAM, tick)
        u = torch.rand((num_clients,), generator=gen)
        return u < self.client_rates(tick, num_clients)

    def arrivals_window(self, tick0: int, num_ticks: int,
                        num_clients: int) -> torch.Tensor:
        """``(num_ticks, n)`` bool: ticks ``tick0 .. tick0 + num_ticks -
        1``, each as :meth:`arrivals_at` realizes it."""
        return torch.stack([self.arrivals_at(tick0 + w, num_clients)
                            for w in range(num_ticks)])
