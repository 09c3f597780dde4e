"""Coordinate-wise aggregators (counterpart of the ``Mean`` / ``Median`` /
``Trimmedmean`` subset of ``blades_tpu/ops/aggregators.py``).

``Median`` and ``Trimmedmean`` reduce through
:mod:`blades_tpu_torch.ops.column_select`: the CUDA kernel on a CUDA
tensor, the plain version on a CPU tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from blades_tpu_torch.ops.column_select import column_median, column_trimmed_mean


@dataclasses.dataclass(frozen=True)
class Aggregator:
    """Stateless, keyless aggregators override :meth:`aggregate`."""

    def init(self, num_params: int, num_clients: int):
        del num_params, num_clients
        return ()

    def aggregate(self, updates: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def __call__(self, updates: torch.Tensor, state=(), *, generator=None):
        del generator
        return self.aggregate(updates), state


@dataclasses.dataclass(frozen=True)
class Mean(Aggregator):
    """Plain FedAvg mean."""

    def aggregate(self, updates):
        return updates.mean(0)


@dataclasses.dataclass(frozen=True)
class Median(Aggregator):
    """Coordinate-wise median (midpoint of the two middle values)."""

    def aggregate(self, updates):
        return column_median(updates)


@dataclasses.dataclass(frozen=True)
class Trimmedmean(Aggregator):
    """Coordinate-wise trimmed mean: drops the ``k`` largest and smallest
    values per coordinate, ``k = filter_frac * num_byzantine`` rounded up
    to an even integer, then means the rest."""

    num_byzantine: int
    filter_frac: float = 1.0

    @property
    def num_excluded(self) -> int:
        k = int(self.filter_frac * self.num_byzantine)
        return k if k % 2 == 0 else k + 1

    def aggregate(self, updates):
        n, k = updates.shape[0], self.num_excluded
        if n <= 2 * k:
            raise ValueError(
                f"Trimmedmean needs > 2*num_excluded={2 * k} clients, got {n}")
        return column_trimmed_mean(updates, k)


AGGREGATORS = {"Mean": Mean, "Median": Median, "Trimmedmean": Trimmedmean}
_NEEDS_NUM_BYZANTINE = {"Trimmedmean"}
_LATER = {"GeoMed", "DnC", "Multikrum", "Centeredclipping", "Signguard",
          "Clippedclustering", "FLTrust"}


def get_aggregator(spec, num_byzantine: Optional[int] = None) -> Aggregator:
    """Resolve a name, ``{"type": ..., **kwargs}`` dict or instance,
    injecting ``num_byzantine`` where the aggregator needs it."""
    if isinstance(spec, Aggregator):
        return spec
    if isinstance(spec, str):
        spec = {"type": spec}
    spec = dict(spec)
    name = spec.pop("type")
    if name in _LATER:
        raise NotImplementedError(
            f"{name} is not in the port yet: the row-geometry aggregators "
            "come with a later slice")
    if name not in AGGREGATORS:
        raise KeyError(f"unknown aggregator {name!r}; known: "
                       f"{sorted(AGGREGATORS)}")
    if name in _NEEDS_NUM_BYZANTINE and "num_byzantine" not in spec:
        if num_byzantine is None:
            raise ValueError(f"{name} requires num_byzantine")
        spec["num_byzantine"] = int(num_byzantine)
    return AGGREGATORS[name](**spec)
