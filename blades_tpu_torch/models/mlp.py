"""MNIST MLP (counterpart of ``blades_tpu/models/mlp.py``): in-128-256-10
with dropout between the hidden layers.

Dropout takes its keep-masks as an argument (``dropout_masks``, one
``(B, features)`` bool tensor per dropout layer), drawn by the caller from
an explicit generator, so that a client block runs as one ``vmap`` with
each client's own masks (:func:`~blades_tpu_torch.models.layers.
keyed_dropout`).  :class:`PackedMLP` is P clients' MLPs in one lane.
"""

from __future__ import annotations

import torch
from torch import nn

from blades_tpu_torch.models.layers import (
    PackedDense,
    keyed_dropout,
    packed_keyed_dropout,
)


class MLP(nn.Module):
    def __init__(self, in_features: int = 784, hidden1: int = 128,
                 hidden2: int = 256, num_classes: int = 10,
                 dropout_rate: float = 0.2):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.dropout_widths = (hidden1, hidden2)
        self.Dense_0 = nn.Linear(in_features, hidden1)
        self.Dense_1 = nn.Linear(hidden1, hidden2)
        self.Dense_2 = nn.Linear(hidden2, num_classes)

    def dropout_sites(self, batch: int):
        """``(shape, rate)`` of each dropout layer's keep-mask for one
        client's step on a batch of ``batch``."""
        if not self.dropout_rate:
            return ()
        return tuple(((batch, w), self.dropout_rate)
                     for w in self.dropout_widths)

    def forward(self, x, dropout_masks=None):
        rate = self.dropout_rate
        x = x.reshape(x.shape[0], -1)
        x = keyed_dropout(torch.relu(self.Dense_0(x)), rate, dropout_masks, 0)
        x = keyed_dropout(torch.relu(self.Dense_1(x)), rate, dropout_masks, 1)
        return self.Dense_2(x)


class PackedMLP(nn.Module):
    """P clients' MLPs in one lane (counterpart of the JAX package's
    ``PackedMLP``): every ``Dense_i`` is a
    :class:`~blades_tpu_torch.models.layers.PackedDense` over ``(B, P,
    features)`` activations, named as in :class:`MLP`, so the packed
    parameters are the pack transform of P clients'
    (:mod:`blades_tpu_torch.parallel.packed`).  ``dropout_masks`` holds
    one ``(P, B, features)`` keep-mask per site, client ``g``'s at
    ``[g]``."""

    def __init__(self, pack: int, in_features: int = 784, hidden1: int = 128,
                 hidden2: int = 256, num_classes: int = 10,
                 dropout_rate: float = 0.2):
        super().__init__()
        self.pack = pack
        self.dropout_rate = dropout_rate
        self.Dense_0 = PackedDense(pack, in_features, hidden1)
        self.Dense_1 = PackedDense(pack, hidden1, hidden2)
        self.Dense_2 = PackedDense(pack, hidden2, num_classes)

    @staticmethod
    def pack_inputs(x):
        """``(P, B, ...) -> (B, P, features)``: each client's inputs
        flattened, the client axis becomes the pack axis."""
        return x.reshape(x.shape[0], x.shape[1], -1).transpose(0, 1)

    def forward(self, x, dropout_masks=None):
        rate = self.dropout_rate
        x = torch.relu(self.Dense_0(x))
        x = packed_keyed_dropout(x, rate, dropout_masks, 0)
        x = torch.relu(self.Dense_1(x))
        x = packed_keyed_dropout(x, rate, dropout_masks, 1)
        return self.Dense_2(x)
