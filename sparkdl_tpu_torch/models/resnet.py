"""Bottleneck ResNet (ResNet50/101/152), port of the JAX package's
``models/resnet.py``.

The geometry is ResNet v1 as keras builds it, the same as the flax
module's, layer for layer:

- the stem: a 7x7 stride-2 conv padded by 3, BatchNorm, ReLU, and a 3x3
  stride-2 max-pool padded by 1;
- stage ``i`` (filters 64·2^i, stride 2 from the second stage on) opens
  with a block that has a projection shortcut, stage 1 included; the
  stride sits on each block's 1x1 ``conv1`` and on the projection, not on
  the 3x3 (torchvision's v1.5 puts it on the 3x3);
- 3x3 convs pad by 1; convs have no bias; BatchNorm eps is 1e-5;
- global average pooling, then a biased ``head`` for the logits.

Layout is NCHW; on the card the module and its input are kept in
``channels_last`` memory format, which cuDNN's convolutions take as they
are. Precision is the image models' policy (``models/layers.py``).

Module names match the flax module's (``conv_init``, ``bn_init``,
``stage{i}_block{j}``, ``conv1``..``conv3``, ``conv_proj``, ``bn1``..,
``head``), so ``models/convert.py`` carries flax weights across by name.
The flax module's ``scan_blocks`` layout (stacked identity blocks) is not
ported; the converter rejects it.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from sparkdl_tpu_torch.models.layers import BatchNorm, ImageCNN, global_mean


def _conv(cin: int, cout: int, k: int, stride: int = 1, pad: int = 0) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=pad, bias=False)


class BottleneckBlock(nn.Module):
    def __init__(self, in_channels: int, filters: int, stride: int = 1,
                 projection: bool = False):
        super().__init__()
        self.conv1 = _conv(in_channels, filters, 1, stride)
        self.bn1 = BatchNorm(filters)
        self.conv2 = _conv(filters, filters, 3, pad=1)
        self.bn2 = BatchNorm(filters)
        self.conv3 = _conv(filters, filters * 4, 1)
        self.bn3 = BatchNorm(filters * 4)
        self.projection = projection
        if projection:
            self.conv_proj = _conv(in_channels, filters * 4, 1, stride)
            self.bn_proj = BatchNorm(filters * 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = self.bn_proj(self.conv_proj(x)) if self.projection else x
        return F.relu(y + residual)


class ResNet(ImageCNN):
    """Bottleneck ResNet; ``stage_sizes`` gives the blocks per stage. The
    pooled features are 2048-d for ResNet50."""

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000,
                 dtype: torch.dtype = torch.float32):
        super().__init__(dtype)
        self.conv_init = _conv(3, 64, 7, stride=2, pad=3)
        self.bn_init = BatchNorm(64)
        self.block_names: List[str] = []
        channels = 64
        for i, block_count in enumerate(stage_sizes):
            filters = 64 * 2**i
            for j in range(block_count):
                name = f"stage{i + 1}_block{j + 1}"
                first = j == 0
                self.add_module(name, BottleneckBlock(
                    channels, filters,
                    stride=2 if first and i > 0 else 1,
                    projection=first,
                ))
                self.block_names.append(name)
                channels = filters * 4
        self.head = nn.Linear(channels, num_classes)

    def _forward(self, x: torch.Tensor, features_only: bool) -> torch.Tensor:
        x = F.relu(self.bn_init(self.conv_init(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for name in self.block_names:
            x = getattr(self, name)(x)
        x = global_mean(x)
        return x if features_only else self.head(x)


def ResNet50(dtype: torch.dtype = torch.float32, num_classes: int = 1000) -> ResNet:
    return ResNet([3, 4, 6, 3], num_classes=num_classes, dtype=dtype)


def ResNet101(dtype: torch.dtype = torch.float32, num_classes: int = 1000) -> ResNet:
    return ResNet([3, 4, 23, 3], num_classes=num_classes, dtype=dtype)


def ResNet152(dtype: torch.dtype = torch.float32, num_classes: int = 1000) -> ResNet:
    return ResNet([3, 8, 36, 3], num_classes=num_classes, dtype=dtype)
