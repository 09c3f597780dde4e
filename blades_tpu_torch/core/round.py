"""Round state and static round config (counterpart of the fields of
``blades_tpu/core/round.py`` that the streamed round reads, and of
``FedRound.compute_trusted_update``).

The dense ``FedRound.step`` comes with a later slice; the port's round is
:func:`blades_tpu_torch.parallel.streamed.streamed_step`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

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
    # Server root dataset (x (m, H, W, C), y (m,)) for trust-bootstrapped
    # aggregators (FLTrust): each round the server runs its own local round
    # on it and the result is the trusted reference update.
    trusted_data: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    def init(self, seed: int, num_clients: int, device=None) -> RoundState:
        """Fresh parameters from ``seed`` and the server's initial state on
        ``device`` (``None`` = the card)."""
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        params = self.task.init_params(gen, dev)
        return RoundState(server=self.server.init(params, num_clients))

    def compute_trusted_update(self, global_params, generator):
        """The server's local round on its root data (FLTrust's trusted
        reference), its batches drawn from ``generator``; None when the
        aggregator takes none."""
        if self.trusted_data is None or not getattr(
                self.server.aggregator, "expects_trusted_row", False):
            return None
        tx, ty = self.trusted_data
        idx = torch.randint(
            0, tx.shape[0], (self.num_batches_per_round, self.batch_size),
            generator=generator, device=generator.device).to(tx.device)
        dev = next(iter(global_params.values())).device
        update, _ = self.task.local_round(global_params, tx[idx].to(dev),
                                          ty[idx].to(dev), generator=generator)
        return update
