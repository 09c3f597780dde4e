"""Training-corruption attacks (counterpart of
``blades_tpu/adversaries/training_attacks.py``): hooks inside local
training, branchless over a client block -- ``torch.where`` on the block's
``(G,)`` malicious mask picks the attacked lanes."""

from __future__ import annotations

import dataclasses

import torch

from blades_tpu_torch.adversaries.base import Adversary


def _lanes(mask: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """The ``(G,)`` mask broadcast over ``t (G, ...)``."""
    return mask.reshape((-1,) + (1,) * (t.dim() - 1))


@dataclasses.dataclass(frozen=True)
class LabelFlipAdversary(Adversary):
    """Targets become ``num_classes - 1 - target`` on malicious lanes;
    local training stays on."""

    num_classes: int = 10

    def data_hook(self, x, y, malicious):
        flipped = self.num_classes - 1 - y
        return x, torch.where(_lanes(malicious, y), flipped, y)


@dataclasses.dataclass(frozen=True)
class SignFlipAdversary(Adversary):
    """Every gradient leaf negated on malicious lanes after the
    backward."""

    def grad_hook(self, grads, malicious):
        return {k: torch.where(_lanes(malicious, g), -g, g)
                for k, g in grads.items()}
