"""CIFAR ResNet-10/18 (counterpart of ``blades_tpu/models/resnet.py``).

BasicBlock stages, the CIFAR stem (3x3 conv, no max-pool), and
:class:`~blades_tpu_torch.models.layers.BatchStatsNorm` everywhere.  Padding
follows flax's: explicit ``padding=1`` on the 3x3 convs, and the 1x1
stride-2 shortcut's ``'SAME'``, which is no padding.  The public input is
NHWC as in the reference; the model permutes it to NCHW inside.  Submodule
names equal flax's auto-names, which fixes the flat layout.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from blades_tpu_torch.models.layers import BatchStatsNorm


class BasicBlock(nn.Module):
    def __init__(self, in_ch: int, filters: int, stride: int = 1):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_ch, filters, 3, stride, padding=1,
                                bias=False)
        self.BatchStatsNorm_0 = BatchStatsNorm(filters)
        self.Conv_1 = nn.Conv2d(filters, filters, 3, 1, padding=1, bias=False)
        self.BatchStatsNorm_1 = BatchStatsNorm(filters)
        self.shortcut = stride != 1 or in_ch != filters
        if self.shortcut:
            self.Conv_2 = nn.Conv2d(in_ch, filters, 1, stride, bias=False)
            self.BatchStatsNorm_2 = BatchStatsNorm(filters)

    def forward(self, x):
        y = torch.relu(self.BatchStatsNorm_0(self.Conv_0(x)))
        y = self.BatchStatsNorm_1(self.Conv_1(y))
        res = self.BatchStatsNorm_2(self.Conv_2(x)) if self.shortcut else x
        return torch.relu(y + res)


class ResNet(nn.Module):
    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 10,
                 in_channels: int = 3):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_channels, 64, 3, 1, padding=1, bias=False)
        self.BatchStatsNorm_0 = BatchStatsNorm(64)
        idx, ch = 0, 64
        for i, num_blocks in enumerate(stage_sizes):
            filters = 64 * 2 ** i
            for j in range(num_blocks):
                stride = 2 if i > 0 and j == 0 else 1
                self.add_module(f"BasicBlock_{idx}",
                                BasicBlock(ch, filters, stride))
                idx, ch = idx + 1, filters
        self.num_blocks = idx
        self.Dense_0 = nn.Linear(ch, num_classes)

    def forward(self, x, dropout_masks=None):
        del dropout_masks  # no dropout
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        x = torch.relu(self.BatchStatsNorm_0(self.Conv_0(x)))
        for i in range(self.num_blocks):
            x = getattr(self, f"BasicBlock_{i}")(x)
        return self.Dense_0(x.mean(dim=(2, 3)))


def ResNet10(num_classes: int = 10, in_channels: int = 3) -> ResNet:
    return ResNet((1, 1, 1, 1), num_classes, in_channels)


def ResNet18(num_classes: int = 10, in_channels: int = 3) -> ResNet:
    return ResNet((2, 2, 2, 2), num_classes, in_channels)
