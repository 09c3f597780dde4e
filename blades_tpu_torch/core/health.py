"""Failure detection and recovery (counterpart of
``blades_tpu/core/health.py``): a client lane is unhealthy iff its update
row holds a non-finite value, and is zeroed; a round is bad iff its
aggregate is non-finite, and then keeps the old server state (the round
counter still advances)."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from blades_tpu_torch.core.server import ServerState


def sanitize_updates(updates: torch.Tensor, participation=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(clean, healthy)``: rows with any non-finite value zeroed, and the
    ``(n,)`` lane-health mask (a non-participating lane reports healthy)."""
    finite = torch.isfinite(updates).all(-1)
    healthy = finite if participation is None else finite | ~participation
    return torch.where(finite[:, None], updates,
                       torch.zeros_like(updates)), healthy


def guard_server_state(ok: torch.Tensor, new: ServerState,
                       old: ServerState) -> ServerState:
    """``new`` when ``ok``, else ``old`` with ``new``'s round counter (the
    round happened; its update is discarded).  Reads ``ok`` on the host."""
    if bool(ok):
        return new
    return dataclasses.replace(old, round=new.round)
