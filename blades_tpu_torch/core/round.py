"""Round state and static round config (counterpart of the fields of
``blades_tpu/core/round.py`` that the streamed round reads).

The dense ``FedRound.step`` comes with a later slice; this slice's round
is :func:`blades_tpu_torch.parallel.streamed.streamed_step`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from blades_tpu_torch.core.server import Server, ServerState
from blades_tpu_torch.core.task import Task
from blades_tpu_torch.device import resolve_device


@dataclasses.dataclass
class RoundState:
    """Training state: the server's state and the per-client optimizer
    state (``None`` under plain local SGD, which keeps none)."""

    server: ServerState
    client_opt: Any = None


@dataclasses.dataclass(frozen=True)
class FedRound:
    """Static round config binding task, server and (optional) adversary."""

    task: Task
    server: Server
    adversary: Any = None
    batch_size: int = 32
    num_batches_per_round: int = 1
    # True federation size; None means every data row is a client.
    num_clients: Optional[int] = None
    # Zero non-finite client rows before aggregation and keep the old
    # server state when the aggregate is non-finite; adds num_unhealthy
    # and round_ok to the metrics.
    health_check: bool = False

    def init(self, seed: int, num_clients: int, device=None) -> RoundState:
        """Fresh parameters from ``seed`` and the server's initial state on
        ``device`` (``None`` = the card)."""
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        params = self.task.init_params(gen, dev)
        return RoundState(server=self.server.init(params, num_clients))
