"""Staleness weight schedules for buffered-async aggregation (counterpart
of ``blades_tpu/arrivals/weights.py``).

A buffered row's staleness ``k = server_version - version the update was
computed against`` (0 = computed against the current model).  Every
schedule maps ``(K,)`` integer staleness to ``(K,)`` f32 weights; rows
are then scaled by the mean-normalized weight (:func:`normalized_row_scale`)
before the robust aggregator runs, so Mean returns exactly the
staleness-weighted average ``sum(w_i u_i) / sum(w_i)`` and every other
defense sees stale rows discounted toward the origin.

==============  ==========================================================
``constant``    ``w(k) = 1`` (staleness ignored)
``polynomial``  ``w(k) = (1 + k)^-power`` (FedBuff's ``1/sqrt(1+k)`` at
                ``power = 0.5``)
``inverse``     ``w(k) = 1 / (1 + k)``
``cutoff``      ``w(k) = 1 if k <= cutoff else 0``
==============  ==========================================================
"""

from __future__ import annotations

import torch

STALENESS_SCHEDULES = ("constant", "polynomial", "inverse", "cutoff")


def staleness_weights(schedule: str, staleness, *, power: float = 0.5,
                      cutoff: int = 16) -> torch.Tensor:
    """``(K,)`` staleness ints -> ``(K,)`` f32 weights."""
    k = torch.as_tensor(staleness).to(torch.float32)
    if schedule == "constant":
        return torch.ones_like(k)
    if schedule == "polynomial":
        return (1.0 + k) ** float(-power)
    if schedule == "inverse":
        return 1.0 / (1.0 + k)
    if schedule == "cutoff":
        return (k <= float(cutoff)).to(torch.float32)
    raise ValueError(
        f"unknown staleness weight schedule {schedule!r}; known: "
        f"{STALENESS_SCHEDULES}")


def normalized_row_scale(weights: torch.Tensor) -> torch.Tensor:
    """Mean-normalized per-row scale ``w_i / mean(w)``: an all-equal
    weight vector is exactly ones (no schedule => bit-identical rows); an
    all-zero one (a ``cutoff`` cycle whose every row is over-stale) scales
    every row to zero, and the server takes a zero step."""
    return weights / weights.mean().clamp(min=1e-12)
