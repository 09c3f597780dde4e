"""Fashion-MNIST CNN (counterpart of ``blades_tpu/models/cnn.py``).

conv(3x3, pad 1) -> relu -> maxpool, conv(3x3, VALID) -> relu -> maxpool
(28 -> 14 -> 12 -> 6 spatial, so ``Dense_0`` sees 64*6*6 features), then
dense 600 -> dropout(0.25) -> dense 120 -> dense 10 with no nonlinearity
between the dense layers.  The public input is NHWC; the convolutions run
in NCHW and the features are flattened in NHWC order, as flax flattens
them, so ``Dense_0``'s weight carries across unchanged.

Dropout takes its keep-mask as an argument (``dropout_masks``, one
``(B, 600)`` bool tensor), drawn by the caller from an explicit generator,
as the MLP does.  :class:`PackedFashionCNN` is P clients' CNNs in one
lane.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from blades_tpu_torch.models.layers import (
    PackedDense,
    keyed_dropout,
    packed_keyed_dropout,
)


class FashionCNN(nn.Module):
    def __init__(self, num_classes: int = 10, in_channels: int = 1,
                 input_hw=(28, 28)):
        super().__init__()
        self.dropout_rate = 0.25
        self.dropout_widths = (600,)
        self.input_hw = tuple(input_hw)
        h, w = input_hw
        h, w = (h // 2 - 2) // 2, (w // 2 - 2) // 2
        self.Conv_0 = nn.Conv2d(in_channels, 32, 3, padding=1)
        self.Conv_1 = nn.Conv2d(32, 64, 3)
        self.Dense_0 = nn.Linear(64 * h * w, 600)
        self.Dense_1 = nn.Linear(600, 120)
        self.Dense_2 = nn.Linear(120, num_classes)

    def dropout_sites(self, batch: int):
        """``(shape, rate)`` of the dropout layer's keep-mask for one
        client's step on a batch of ``batch``."""
        return (((batch, 600), self.dropout_rate),)

    def forward(self, x, dropout_masks=None):
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        x = F.max_pool2d(torch.relu(self.Conv_0(x)), 2, 2)
        x = F.max_pool2d(torch.relu(self.Conv_1(x)), 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flax's order
        x = keyed_dropout(self.Dense_0(x), self.dropout_rate, dropout_masks,
                          0)
        return self.Dense_2(self.Dense_1(x))


class PackedFashionCNN(nn.Module):
    """P clients' CNNs in one lane (counterpart of the JAX package's
    ``PackedFashionCNN``).  The convolutions run with ``groups=P`` on
    channel-concatenated activations (client ``g`` owns channels ``[g*C,
    (g+1)*C)``): a grouped convolution computes output block ``g`` from
    input block ``g`` with weight rows ``[g*C_out, (g+1)*C_out)``, the
    clients' own convolutions.  The flatten takes each client's features
    in flax's ``(h, w, c)`` order into the pack axis of the
    :class:`~blades_tpu_torch.models.layers.PackedDense` stack.  Names
    match :class:`FashionCNN`'s.  The input is the NHWC ``(B, H, W,
    P*C)`` of :meth:`pack_inputs`; ``dropout_masks`` is one ``(P, B,
    600)`` keep-mask."""

    def __init__(self, pack: int, num_classes: int = 10,
                 in_channels: int = 1, input_hw=(28, 28)):
        super().__init__()
        self.pack = pack
        self.dropout_rate = 0.25
        h, w = input_hw
        h, w = (h // 2 - 2) // 2, (w // 2 - 2) // 2
        self.Conv_0 = nn.Conv2d(in_channels * pack, 32 * pack, 3, padding=1,
                                groups=pack)
        self.Conv_1 = nn.Conv2d(32 * pack, 64 * pack, 3, groups=pack)
        self.Dense_0 = PackedDense(pack, 64 * h * w, 600)
        self.Dense_1 = PackedDense(pack, 600, 120)
        self.Dense_2 = PackedDense(pack, 120, num_classes)

    @staticmethod
    def pack_inputs(x):
        """``(P, B, H, W, C) -> (B, H, W, P*C)`` channel concatenation."""
        p, b, h, w, c = x.shape
        return x.permute(1, 2, 3, 0, 4).reshape(b, h, w, p * c)

    def forward(self, x, dropout_masks=None):
        p = self.pack
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        x = F.max_pool2d(torch.relu(self.Conv_0(x)), 2, 2)
        x = F.max_pool2d(torch.relu(self.Conv_1(x)), 2, 2)
        b, c, h, w = x.shape
        x = x.reshape(b, p, c // p, h, w).permute(0, 1, 3, 4, 2)
        x = x.reshape(b, p, h * w * (c // p))
        x = packed_keyed_dropout(self.Dense_0(x), self.dropout_rate,
                                 dropout_masks, 0)
        return self.Dense_2(self.Dense_1(x))
