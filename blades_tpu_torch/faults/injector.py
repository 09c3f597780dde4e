"""Deterministic, seed-driven fault injection in the dense round
(counterpart of ``blades_tpu/faults/injector.py``).

Three composable processes act on the ``(n, d)`` update matrix as it
arrives at the server:

- **dropout**: a per-round Bernoulli participation mask (or a
  schedule-driven rate); an all-dropped draw degrades to full
  participation;
- **stragglers**: ``num_stragglers`` participating lanes deliver the update
  they computed ``staleness`` rounds ago, from a ``(staleness, n, d)`` ring
  buffer carried in ``RoundState.stale``;
- **corruption**: participating lanes overwritten with NaN, Inf or a
  near-overflow value.

Realizations are a pure function of ``(seed, round)``: a CPU
``torch.Generator`` seeded from both (:meth:`FaultInjector.realize`),
independent of the round's training stream, so a retried or resumed trial
meets identical failures.  The JAX package's realizations come from its
own PRNG; ``inject(..., realization=(participation, straggled,
corrupted))`` applies given masks instead, which is how the port is held
against it.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

_CORRUPT_FILL = {
    "nan": float("nan"),
    "inf": float("inf"),
    # Near-f32-max: finite on arrival, overflows to inf in the first
    # squared norm an aggregator takes (the health check passes it).
    "overflow": 3.0e38,
}

# Salt of the fault generator's seed: the round generator is seeded from
# (seed, round) too, and the fault stream must not be it.
_FAULT_STREAM = 0xFA17


@dataclasses.dataclass(frozen=True)
class FaultInjector:
    """Static chaos config; realizations are pure in ``(seed, round)``.

    Attributes:
        seed: fault-process seed, independent of the training stream.
        dropout_rate: per-round probability a client drops out.
        dropout_schedule: optional ``((round, rate), ...)``: from each
            listed round on, dropout runs at that rate (``dropout_rate``
            before the first entry).
        num_stragglers: participating lanes per round that deliver the
            update they computed ``staleness`` rounds ago (zeros until the
            ring fills).
        staleness: age in rounds of a straggler's update.
        corrupt_rate: per-round probability a participating lane is
            overwritten with ``corrupt_mode`` garbage.
        corrupt_mode: ``"nan" | "inf" | "overflow"``.
    """

    seed: int = 0
    dropout_rate: float = 0.0
    dropout_schedule: Optional[Tuple[Tuple[int, float], ...]] = None
    num_stragglers: int = 0
    staleness: int = 1
    corrupt_rate: float = 0.0
    corrupt_mode: str = "nan"

    def __post_init__(self):
        if not 0.0 <= self.dropout_rate < 1.0:
            raise ValueError(
                f"dropout_rate must be in [0, 1), got {self.dropout_rate} "
                "(1.0 would drop every client every round)")
        if not 0.0 <= self.corrupt_rate <= 1.0:
            raise ValueError(
                f"corrupt_rate must be in [0, 1], got {self.corrupt_rate}")
        if self.corrupt_mode not in _CORRUPT_FILL:
            raise ValueError(
                f"corrupt_mode must be one of {sorted(_CORRUPT_FILL)}, "
                f"got {self.corrupt_mode!r}")
        if self.num_stragglers < 0:
            raise ValueError(
                f"num_stragglers must be >= 0, got {self.num_stragglers}")
        if self.staleness < 1:
            raise ValueError(f"staleness must be >= 1, got {self.staleness}")
        if self.dropout_schedule is not None:
            # A hashable, sorted tuple of (int, float) (YAML hands lists).
            sched = tuple(sorted((int(r), float(v))
                                 for r, v in self.dropout_schedule))
            for r, v in sched:
                if r < 0 or not 0.0 <= v < 1.0:
                    raise ValueError(
                        f"dropout_schedule entries must be (round >= 0, "
                        f"rate in [0, 1)), got ({r}, {v})")
            object.__setattr__(self, "dropout_schedule", sched)

    @property
    def needs_stale_buffer(self) -> bool:
        """Whether the round state carries the stale-update ring."""
        return self.num_stragglers > 0

    def dropout_rate_at(self, round_idx: int) -> float:
        """The piecewise-constant dropout rate at ``round_idx``."""
        if not self.dropout_schedule:
            return float(self.dropout_rate)
        rates = [self.dropout_rate] + [v for _, v in self.dropout_schedule]
        bounds = [r for r, _ in self.dropout_schedule]
        return float(rates[bisect.bisect_right(bounds, int(round_idx))])

    def init_stale_buffer(self, num_clients: int, num_params: int,
                          device=None):
        """Zeros ``(staleness, n, d)`` ring (row ``-1`` the oldest), or
        None without stragglers."""
        if not self.needs_stale_buffer:
            return None
        return torch.zeros((self.staleness, num_clients, num_params),
                           dtype=torch.float32, device=device)

    def realize(self, n: int, round_idx: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Round ``round_idx``'s ``(participation, straggled, corrupted)``
        ``(n,)`` bool masks on the CPU.  Every round draws its dropout,
        straggler and corruption uniforms in that order, whatever the
        config, so each process's realization is independent of the
        others' settings.  The draws come from a CPU generator seeded from
        ``(seed, round)`` alone."""
        ss = np.random.SeedSequence([int(self.seed), int(round_idx),
                                     _FAULT_STREAM])
        gen = torch.Generator().manual_seed(
            int(ss.generate_state(1, dtype=np.uint64)[0] >> 1))
        u_drop, u_strag, u_corr = (torch.rand((n,), generator=gen)
                                   for _ in range(3))
        participation = u_drop >= self.dropout_rate_at(round_idx)
        if not bool(participation.any()):
            participation = torch.ones_like(participation)
        straggled = torch.zeros((n,), dtype=torch.bool)
        if self.needs_stale_buffer:
            # The num_stragglers lowest-scoring participants.
            scores = torch.where(participation, u_strag,
                                 torch.full_like(u_strag, float("inf")))
            rank = torch.argsort(torch.argsort(scores, stable=True),
                                 stable=True)
            straggled = (rank < self.num_stragglers) & participation
        corrupted = torch.zeros((n,), dtype=torch.bool)
        if self.corrupt_rate > 0.0:
            corrupted = (u_corr < self.corrupt_rate) & participation
        return participation, straggled, corrupted

    def inject(self, updates: torch.Tensor, stale, round_idx: int, *,
               realization=None):
        """Apply one round's failures to ``updates`` (n, d).

        ``stale`` is the ``(staleness, n, d)`` ring (None without
        stragglers); ``realization`` the masks to apply (default
        :meth:`realize`).  Returns ``(updates, stale, participation,
        straggled, corrupted)``: the faulted matrix, the advanced ring
        (this round's fresh updates in row 0) and the ``(n,)`` masks on
        ``updates``' device."""
        dev = updates.device
        masks = (realization if realization is not None
                 else self.realize(updates.shape[0], round_idx))
        participation, straggled, corrupted = (
            torch.as_tensor(m, dtype=torch.bool).to(dev) for m in masks)
        if self.needs_stale_buffer:
            fresh = updates
            updates = torch.where(straggled[:, None], stale[-1], updates)
            stale = torch.cat([fresh[None], stale[:-1]])
        if self.corrupt_rate > 0.0:
            fill = torch.full((), _CORRUPT_FILL[self.corrupt_mode],
                              dtype=updates.dtype, device=dev)
            updates = torch.where(corrupted[:, None], fill, updates)
        return updates, stale, participation, straggled, corrupted
