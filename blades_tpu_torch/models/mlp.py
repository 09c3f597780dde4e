"""MNIST MLP (counterpart of ``blades_tpu/models/mlp.py``): in-128-256-10
with dropout between the hidden layers.

Dropout takes its keep-masks as an argument (``dropout_masks``, one
``(B, features)`` bool tensor per dropout layer), drawn by the caller from
an explicit generator, so that a client block runs as one ``vmap`` with
each client's own masks.
"""

from __future__ import annotations

import torch
from torch import nn


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

    def _drop(self, x, masks, i):
        if masks is None or self.dropout_rate == 0.0:
            return x
        keep = 1.0 - self.dropout_rate
        return torch.where(masks[i], x / keep, torch.zeros_like(x))

    def forward(self, x, dropout_masks=None):
        x = x.reshape(x.shape[0], -1)
        x = self._drop(torch.relu(self.Dense_0(x)), dropout_masks, 0)
        x = self._drop(torch.relu(self.Dense_1(x)), dropout_masks, 1)
        return self.Dense_2(x)
