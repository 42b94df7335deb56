"""MobileNetV2 (width multiplier 1.0, the registry's; the flax module's
other widths are not ported), port of the JAX package's
``models/mobilenet.py``: 224x224 input, 'tf' preprocessing, 1280-d pooled
features, a 1000-way ``classifier``.

The geometry is the flax module's, layer for layer:

- BatchNorm eps 1e-3; ReLU6;
- the stride-2 stem conv and the stride-2 depthwise convs pad (0, 1) on
  each axis, as keras' ``ZeroPadding2D(correct_pad)`` + VALID does, at any
  input size; the stride-1 depthwise convs pad (1, 1);
- an inverted residual block ``block_{idx}`` is ``expand`` (1x1, left out
  when the expansion is 1), ``depthwise`` (3x3, one group per channel),
  ``project`` (1x1), each with its ``_bn``; it adds its input only when its
  stride is 1 and its channel count is unchanged;
- ``stem``, ``head`` (the 1x1 conv to 1280 channels) and the dense
  ``classifier``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from sparkdl_tpu_torch.models.layers import BatchNorm, ImageCNN, global_mean


def _make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:  # never round down by more than 10%
        new_v += divisor
    return new_v


#: (expand, out_channels, repeats, first_stride) per stage: the V2 paper's
#: table 2
_V2_CONFIG: Sequence[Tuple[int, int, int, int]] = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)


def _bn(channels: int) -> BatchNorm:
    return BatchNorm(channels, eps=1e-3)


def _pad_stride2(x: torch.Tensor) -> torch.Tensor:
    """keras' (0, 1) zero pad on H and W before a 3x3 stride-2 conv."""
    return F.pad(x, (0, 1, 0, 1))


class InvertedResidual(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, stride: int, expand: int):
        super().__init__()
        hidden = in_ch * expand
        self.expanded = expand != 1
        if self.expanded:
            self.expand = nn.Conv2d(in_ch, hidden, 1, bias=False)
            self.expand_bn = _bn(hidden)
        self.stride = stride
        self.depthwise = nn.Conv2d(
            hidden, hidden, 3, stride=stride, padding=1 if stride == 1 else 0,
            groups=hidden, bias=False,
        )
        self.depthwise_bn = _bn(hidden)
        self.project = nn.Conv2d(hidden, out_ch, 1, bias=False)
        self.project_bn = _bn(out_ch)
        self.residual = stride == 1 and in_ch == out_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu6(self.expand_bn(self.expand(x))) if self.expanded else x
        if self.stride == 2:
            y = _pad_stride2(y)
        y = F.relu6(self.depthwise_bn(self.depthwise(y)))
        y = self.project_bn(self.project(y))
        return y + x if self.residual else y


class MobileNetV2(ImageCNN):
    """MobileNetV2 (Sandler et al. 2018) at the flax module's geometry."""

    def __init__(self, num_classes: int = 1000, dtype: torch.dtype = torch.float32):
        super().__init__(dtype)
        ch = _make_divisible(32)
        self.stem = nn.Conv2d(3, ch, 3, stride=2, bias=False)
        self.stem_bn = _bn(ch)
        self.num_blocks = 0
        for expand, c, repeats, stride in _V2_CONFIG:
            out_ch = _make_divisible(c)
            for r in range(repeats):
                self.add_module(f"block_{self.num_blocks}", InvertedResidual(
                    ch, out_ch, stride if r == 0 else 1, expand
                ))
                self.num_blocks += 1
                ch = out_ch
        head_ch = _make_divisible(1280)
        self.head = nn.Conv2d(ch, head_ch, 1, bias=False)
        self.head_bn = _bn(head_ch)
        self.classifier = nn.Linear(head_ch, num_classes)

    def _forward(self, x: torch.Tensor, features_only: bool) -> torch.Tensor:
        x = F.relu6(self.stem_bn(self.stem(_pad_stride2(x))))
        for i in range(self.num_blocks):
            x = getattr(self, f"block_{i}")(x)
        x = global_mean(F.relu6(self.head_bn(self.head(x))))
        return x if features_only else self.classifier(x)
