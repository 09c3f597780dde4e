"""Fashion-MNIST CNN (counterpart of ``blades_tpu/models/cnn.py``).

conv(3x3, pad 1) -> relu -> maxpool, conv(3x3, VALID) -> relu -> maxpool
(28 -> 14 -> 12 -> 6 spatial, so ``Dense_0`` sees 64*6*6 features), then
dense 600 -> dropout(0.25) -> dense 120 -> dense 10 with no nonlinearity
between the dense layers.  The public input is NHWC; the convolutions run
in NCHW and the features are flattened in NHWC order, as flax flattens
them, so ``Dense_0``'s weight carries across unchanged.

Dropout takes its keep-mask as an argument (``dropout_masks``, one
``(B, 600)`` bool tensor), drawn by the caller from an explicit generator,
as the MLP does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class FashionCNN(nn.Module):
    def __init__(self, num_classes: int = 10, in_channels: int = 1,
                 input_hw=(28, 28)):
        super().__init__()
        self.dropout_rate = 0.25
        self.dropout_widths = (600,)
        h, w = input_hw
        h, w = (h // 2 - 2) // 2, (w // 2 - 2) // 2
        self.Conv_0 = nn.Conv2d(in_channels, 32, 3, padding=1)
        self.Conv_1 = nn.Conv2d(32, 64, 3)
        self.Dense_0 = nn.Linear(64 * h * w, 600)
        self.Dense_1 = nn.Linear(600, 120)
        self.Dense_2 = nn.Linear(120, num_classes)

    def forward(self, x, dropout_masks=None):
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        x = F.max_pool2d(torch.relu(self.Conv_0(x)), 2, 2)
        x = F.max_pool2d(torch.relu(self.Conv_1(x)), 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flax's order
        x = self.Dense_0(x)
        if dropout_masks is not None:
            keep = 1.0 - self.dropout_rate
            x = torch.where(dropout_masks[0], x / keep, torch.zeros_like(x))
        return self.Dense_2(self.Dense_1(x))
