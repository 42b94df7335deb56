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
are. Precision follows flax: with ``dtype=bfloat16`` the convs and the
head run in bf16 (their weights are stored in bf16 by
:meth:`ResNet.cast_compute`); BatchNorm keeps float32 statistics and
parameters, computes in float32 and rounds to bf16; global average
pooling sums in float32 and rounds to bf16; the output is float32. With
``dtype=float32`` the forward turns TF32 off for its own convs and head
(:func:`~sparkdl_tpu_torch.runtime.device.exact_float32`): cuDNN would
otherwise round their inputs to TF32 by PyTorch's default.

Module names match the flax module's (``conv_init``, ``bn_init``,
``stage{i}_block{j}``, ``conv1``..``conv3``, ``conv_proj``, ``bn1``..,
``head``), so ``models/convert.py`` carries flax weights across by name.
The flax module's ``scan_blocks`` layout (stacked identity blocks) is not
ported; the converter rejects it.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from sparkdl_tpu_torch.runtime.device import exact_float32


class BatchNorm(nn.Module):
    """Inference-mode BatchNorm over NCHW channels with float32 scale, bias
    and running statistics, whatever the input's dtype."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(
            x, self.running_mean, self.running_var, self.weight, self.bias,
            training=False, momentum=0.0, eps=self.eps,
        )


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


class ResNet(nn.Module):
    """Bottleneck ResNet; ``stage_sizes`` gives the blocks per stage.

    ``forward(x)`` returns float32 logits; ``forward(x, features_only=True)``
    the float32 pooled features (2048-d for ResNet50), the
    DeepImageFeaturizer output. ``x`` is an NCHW float batch of
    preprocessed RGB images; it is cast to ``dtype`` first.
    """

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
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

    def cast_compute(self) -> "ResNet":
        """Store the conv and head weights (and the head bias) in the
        compute dtype; BatchNorm stays float32."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                m.to(self.dtype)
        return self

    def forward(self, x: torch.Tensor, features_only: bool = False) -> torch.Tensor:
        if self.dtype == torch.float32:
            with exact_float32():
                return self._forward(x, features_only)
        return self._forward(x, features_only)

    def _forward(self, x: torch.Tensor, features_only: bool) -> torch.Tensor:
        x = x.to(self.dtype)
        x = F.relu(self.bn_init(self.conv_init(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for name in self.block_names:
            x = getattr(self, name)(x)
        # global average pool: float32 sum, rounded to the compute dtype
        x = torch.mean(x, dim=(2, 3), dtype=torch.float32).to(self.dtype)
        if features_only:
            return x.float()
        return self.head(x).float()


def ResNet50(dtype: torch.dtype = torch.float32, num_classes: int = 1000) -> ResNet:
    return ResNet([3, 4, 6, 3], num_classes=num_classes, dtype=dtype)


def ResNet101(dtype: torch.dtype = torch.float32, num_classes: int = 1000) -> ResNet:
    return ResNet([3, 4, 23, 3], num_classes=num_classes, dtype=dtype)


def ResNet152(dtype: torch.dtype = torch.float32, num_classes: int = 1000) -> ResNet:
    return ResNet([3, 8, 36, 3], num_classes=num_classes, dtype=dtype)


def _lecun_normal_(weight: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    """flax's ``lecun_normal``: a normal truncated at two standard
    deviations, scaled so the variance is 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std, generator=gen)


@torch.no_grad()
def init_resnet_params(module: ResNet, gen: torch.Generator) -> None:
    """Seeded init with flax's distributions: lecun-normal conv and dense
    weights, zero head bias, BatchNorm scale 1, bias 0, mean 0, var 1.
    Draws in module order from ``gen`` (a CPU generator gives the same
    weights wherever the module then goes)."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            _lecun_normal_(m.weight, m.weight[0].numel(), gen)
        elif isinstance(m, nn.Linear):
            _lecun_normal_(m.weight, m.in_features, gen)
            m.bias.zero_()
        elif isinstance(m, BatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
