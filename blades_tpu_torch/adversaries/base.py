"""Adversary base class and benign statistics (counterpart of
``blades_tpu/adversaries/base.py``)."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


def make_malicious_mask(num_clients: int, num_byzantine: int,
                        device=None) -> torch.Tensor:
    """The first ``num_byzantine`` lanes are malicious."""
    return torch.arange(num_clients, device=device) < num_byzantine


def benign_mean_std(updates: torch.Tensor, malicious: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean and unbiased (ddof=1) std over benign rows.  Select-masked, so
    a non-finite malicious row cannot reach the benign statistics.  The
    benign count stays on the device (no host sync).  One ``updates``-sized
    temporary at a time."""
    w = (~malicious).to(updates.dtype)
    nb = w.sum().clamp(min=1.0)
    mal = malicious[:, None]
    mean = updates.masked_fill(mal, 0.0).sum(0) / nb
    dev = (updates - mean).pow_(2).masked_fill_(mal, 0.0)
    var = dev.sum(0) / (nb - 1.0).clamp(min=1.0)
    del dev
    return mean, torch.sqrt(var)


@dataclasses.dataclass(frozen=True)
class Adversary:
    """Base adversary: every hook is the identity.  Training-corruption
    attacks override :meth:`data_hook` / :meth:`grad_hook`, which act on a
    whole client block (``malicious`` is the block's ``(G,)`` mask);
    update-forging attacks override :meth:`on_updates_ready`."""

    def data_hook(self, x, y, malicious):
        del malicious
        return x, y

    def grad_hook(self, grads, malicious):
        del malicious
        return grads

    def on_updates_ready(self, updates, malicious, *, noise=None,
                         generator=None, aggregator=None, shard=None):
        del malicious, noise, generator, aggregator, shard
        return updates

    @staticmethod
    def scatter_forged(updates, forged, malicious):
        """Overwrite the malicious rows with ``forged`` ((d,) or (n, d))."""
        if forged.dim() == 1:
            forged = forged[None, :].expand_as(updates)
        return torch.where(malicious[:, None], forged, updates)


def forges(adv) -> bool:
    """Whether ``adv`` rewrites the update matrix."""
    return (adv is not None
            and type(adv).on_updates_ready is not Adversary.on_updates_ready)


def trains_corrupted(adv) -> bool:
    """Whether ``adv`` hooks into local training."""
    return adv is not None and (
        type(adv).data_hook is not Adversary.data_hook
        or type(adv).grad_hook is not Adversary.grad_hook)
