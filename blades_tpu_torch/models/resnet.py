"""CIFAR ResNets (counterpart of ``blades_tpu/models/resnet.py``).

ResNet-10/18/34 stack BasicBlocks, ResNet-50/101/152 Bottlenecks
(expansion 4: a 1x1 reduce, a 3x3 that carries the stride, a 1x1
expand); the CIFAR stem (3x3 conv, no max-pool), and
:class:`~blades_tpu_torch.models.layers.BatchStatsNorm` everywhere.  A
block takes a projection shortcut (1x1 conv + norm) when its stride or
width changes.  Padding follows flax's: explicit ``padding=1`` on the 3x3
convs, and the 1x1 convs' ``'SAME'``, which is no padding.  The public
input is NHWC as in the reference; the model permutes it to NCHW inside.
Submodule names equal flax's auto-names (``BasicBlock_i`` or
``Bottleneck_i``, ``Conv_j``, ``BatchStatsNorm_j`` in call order), which
fixes the flat layout: :class:`~blades_tpu_torch.utils.tree.FlatLayout`
sorts the names as strings, as JAX's flatten sorts dict keys
(``BasicBlock_10`` before ``BasicBlock_2``).  :class:`PackedResNet` is P
clients' BasicBlock ResNets in one lane.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from blades_tpu_torch.models.layers import BatchStatsNorm, PackedDense


class BasicBlock(nn.Module):
    expansion = 1

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


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_ch: int, filters: int, stride: int = 1):
        super().__init__()
        out = filters * self.expansion
        self.Conv_0 = nn.Conv2d(in_ch, filters, 1, bias=False)
        self.BatchStatsNorm_0 = BatchStatsNorm(filters)
        self.Conv_1 = nn.Conv2d(filters, filters, 3, stride, padding=1,
                                bias=False)
        self.BatchStatsNorm_1 = BatchStatsNorm(filters)
        self.Conv_2 = nn.Conv2d(filters, out, 1, bias=False)
        self.BatchStatsNorm_2 = BatchStatsNorm(out)
        self.shortcut = stride != 1 or in_ch != out
        if self.shortcut:
            self.Conv_3 = nn.Conv2d(in_ch, out, 1, stride, bias=False)
            self.BatchStatsNorm_3 = BatchStatsNorm(out)

    def forward(self, x):
        y = torch.relu(self.BatchStatsNorm_0(self.Conv_0(x)))
        y = torch.relu(self.BatchStatsNorm_1(self.Conv_1(y)))
        y = self.BatchStatsNorm_2(self.Conv_2(y))
        res = self.BatchStatsNorm_3(self.Conv_3(x)) if self.shortcut else x
        return torch.relu(y + res)


class ResNet(nn.Module):
    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 10,
                 in_channels: int = 3, block=BasicBlock):
        super().__init__()
        self.stage_sizes, self.block = tuple(stage_sizes), block
        self.Conv_0 = nn.Conv2d(in_channels, 64, 3, 1, padding=1, bias=False)
        self.BatchStatsNorm_0 = BatchStatsNorm(64)
        idx, ch = 0, 64
        for i, num_blocks in enumerate(stage_sizes):
            filters = 64 * 2 ** i
            for j in range(num_blocks):
                stride = 2 if i > 0 and j == 0 else 1
                self.add_module(f"{block.__name__}_{idx}",
                                block(ch, filters, stride))
                idx, ch = idx + 1, filters * block.expansion
        self.block_names = [f"{block.__name__}_{i}" for i in range(idx)]
        self.Dense_0 = nn.Linear(ch, num_classes)

    def forward(self, x, dropout_masks=None):
        del dropout_masks  # no dropout
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        x = torch.relu(self.BatchStatsNorm_0(self.Conv_0(x)))
        for name in self.block_names:
            x = getattr(self, name)(x)
        return self.Dense_0(x.mean(dim=(2, 3)))


class PackedBasicBlock(nn.Module):
    """P clients' :class:`BasicBlock`\\ s: ``groups=P`` convolutions on
    channel-concatenated activations, and :class:`BatchStatsNorm` over the
    ``P * filters`` channels, whose statistics are per channel and so per
    client.  Names match the unpacked block's."""

    def __init__(self, in_ch: int, filters: int, stride: int = 1,
                 pack: int = 2):
        super().__init__()
        p = pack
        self.Conv_0 = nn.Conv2d(in_ch * p, filters * p, 3, stride, padding=1,
                                bias=False, groups=p)
        self.BatchStatsNorm_0 = BatchStatsNorm(filters * p)
        self.Conv_1 = nn.Conv2d(filters * p, filters * p, 3, 1, padding=1,
                                bias=False, groups=p)
        self.BatchStatsNorm_1 = BatchStatsNorm(filters * p)
        self.shortcut = stride != 1 or in_ch != filters
        if self.shortcut:
            self.Conv_2 = nn.Conv2d(in_ch * p, filters * p, 1, stride,
                                    bias=False, groups=p)
            self.BatchStatsNorm_2 = BatchStatsNorm(filters * p)

    forward = BasicBlock.forward


class PackedResNet(nn.Module):
    """P clients' BasicBlock ResNets in one lane (counterpart of the JAX
    package's ``PackedResNet``; Bottleneck stages have no packed form).
    The input is the NHWC ``(B, H, W, P*C)`` of :meth:`pack_inputs`; the
    global average pool is per channel, and the head takes the channels
    into the pack axis of a
    :class:`~blades_tpu_torch.models.layers.PackedDense`."""

    def __init__(self, pack: int, stage_sizes: Sequence[int],
                 num_classes: int = 10, in_channels: int = 3):
        super().__init__()
        self.pack = p = pack
        self.Conv_0 = nn.Conv2d(in_channels * p, 64 * p, 3, 1, padding=1,
                                bias=False, groups=p)
        self.BatchStatsNorm_0 = BatchStatsNorm(64 * p)
        idx, ch = 0, 64
        for i, num_blocks in enumerate(stage_sizes):
            filters = 64 * 2 ** i
            for j in range(num_blocks):
                stride = 2 if i > 0 and j == 0 else 1
                self.add_module(f"BasicBlock_{idx}",
                                PackedBasicBlock(ch, filters, stride, p))
                idx, ch = idx + 1, filters
        self.block_names = [f"BasicBlock_{i}" for i in range(idx)]
        self.Dense_0 = PackedDense(p, ch, num_classes)

    @staticmethod
    def pack_inputs(x):
        """``(P, B, H, W, C) -> (B, H, W, P*C)`` channel concatenation."""
        p, b, h, w, c = x.shape
        return x.permute(1, 2, 3, 0, 4).reshape(b, h, w, p * c)

    def forward(self, x, dropout_masks=None):
        del dropout_masks  # no dropout
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        x = torch.relu(self.BatchStatsNorm_0(self.Conv_0(x)))
        for name in self.block_names:
            x = getattr(self, name)(x)
        x = x.mean(dim=(2, 3))  # (B, P*C), per channel
        return self.Dense_0(x.reshape(x.shape[0], self.pack, -1))


def ResNet10(num_classes: int = 10, in_channels: int = 3) -> ResNet:
    return ResNet((1, 1, 1, 1), num_classes, in_channels)


def ResNet18(num_classes: int = 10, in_channels: int = 3) -> ResNet:
    return ResNet((2, 2, 2, 2), num_classes, in_channels)


def ResNet34(num_classes: int = 10, in_channels: int = 3) -> ResNet:
    return ResNet((3, 4, 6, 3), num_classes, in_channels)


def ResNet50(num_classes: int = 10, in_channels: int = 3) -> ResNet:
    return ResNet((3, 4, 6, 3), num_classes, in_channels, Bottleneck)


def ResNet101(num_classes: int = 10, in_channels: int = 3) -> ResNet:
    return ResNet((3, 4, 23, 3), num_classes, in_channels, Bottleneck)


def ResNet152(num_classes: int = 10, in_channels: int = 3) -> ResNet:
    return ResNet((3, 8, 36, 3), num_classes, in_channels, Bottleneck)
