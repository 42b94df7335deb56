"""Xception, port of the JAX package's ``models/xception.py``: 299x299
input, 'tf' preprocessing, 2048-d pooled features, a 1000-way ``head``.

The geometry is the flax module's, layer for layer:

- BatchNorm with scale, eps 1e-3;
- a separable conv ``{name}`` is a depthwise 3x3 (``{name}_dw``, one group
  per channel, stride 1, padded by 1) then a pointwise 1x1
  (``{name}_pw``), both bias-free;
- the entry flow's two stem convs are VALID; blocks 2-4 and 13 add a
  projection shortcut ``res{i}_conv``/``res{i}_bn`` (1x1, stride 2, no pad:
  "SAME" pads nothing for a 1x1 kernel) to a 3x3 stride-2 "SAME" max-pool.
  That pool pads (0, 1) where its input is even, as in block 3 at 299
  (299 -> 149 -> 147 -> 74 -> 37), and (1, 1) where it is odd; torch's
  ``max_pool2d(3, 2, padding=1)`` gives the same output size with windows
  shifted by one, so the pad is explicit (``-inf``);
- block 2 applies no ReLU before its first separable conv; the middle flow
  (blocks 5-12) is pre-activation; block 14 is post-activation.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from sparkdl_tpu_torch.models.layers import (
    BatchNorm,
    ImageCNN,
    global_mean,
    pad_same,
)

#: (block, filters) of the entry flow's residual blocks
ENTRY_BLOCKS = ((2, 128), (3, 256), (4, 728))
MIDDLE_BLOCKS = range(5, 13)


def _bn(channels: int) -> BatchNorm:
    return BatchNorm(channels, eps=1e-3)


class Xception(ImageCNN):
    """Xception (Chollet 2016) at the flax module's geometry."""

    def __init__(self, num_classes: int = 1000, dtype: torch.dtype = torch.float32):
        super().__init__(dtype)
        self.block1_conv1 = nn.Conv2d(3, 32, 3, stride=2, bias=False)
        self.block1_conv1_bn = _bn(32)
        self.block1_conv2 = nn.Conv2d(32, 64, 3, bias=False)
        self.block1_conv2_bn = _bn(64)
        channels = 64
        for i, filters in ENTRY_BLOCKS:
            self._proj(f"res{i}", channels, filters)
            self._sep(f"block{i}_sepconv1", channels, filters)
            self._sep(f"block{i}_sepconv2", filters, filters)
            channels = filters
        for i in MIDDLE_BLOCKS:
            for j in (1, 2, 3):
                self._sep(f"block{i}_sepconv{j}", 728, 728)
        self._proj("res13", 728, 1024)
        self._sep("block13_sepconv1", 728, 728)
        self._sep("block13_sepconv2", 728, 1024)
        self._sep("block14_sepconv1", 1024, 1536)
        self._sep("block14_sepconv2", 1536, 2048)
        self.head = nn.Linear(2048, num_classes)

    def _proj(self, name: str, cin: int, cout: int) -> None:
        self.add_module(f"{name}_conv", nn.Conv2d(cin, cout, 1, stride=2, bias=False))
        self.add_module(f"{name}_bn", _bn(cout))

    def _sep(self, name: str, cin: int, cout: int) -> None:
        self.add_module(f"{name}_dw", nn.Conv2d(cin, cin, 3, padding=1, groups=cin, bias=False))
        self.add_module(f"{name}_pw", nn.Conv2d(cin, cout, 1, bias=False))
        self.add_module(f"{name}_bn", _bn(cout))

    def _sep_bn(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """Separable conv ``name`` then its BatchNorm."""
        x = getattr(self, f"{name}_pw")(getattr(self, f"{name}_dw")(x))
        return getattr(self, f"{name}_bn")(x)

    def _res(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return getattr(self, f"{name}_bn")(getattr(self, f"{name}_conv")(x))

    @staticmethod
    def _pool(x: torch.Tensor) -> torch.Tensor:
        return F.max_pool2d(pad_same(x, 3, 2, value=float("-inf")), 3, stride=2)

    def _forward(self, x: torch.Tensor, features_only: bool) -> torch.Tensor:
        x = F.relu(self.block1_conv1_bn(self.block1_conv1(x)))
        x = F.relu(self.block1_conv2_bn(self.block1_conv2(x)))
        for i, _ in ENTRY_BLOCKS:
            residual = self._res(f"res{i}", x)
            if i > 2:
                x = F.relu(x)
            x = self._sep_bn(f"block{i}_sepconv1", x)
            x = self._sep_bn(f"block{i}_sepconv2", F.relu(x))
            x = self._pool(x) + residual
        for i in MIDDLE_BLOCKS:
            residual = x
            for j in (1, 2, 3):
                x = self._sep_bn(f"block{i}_sepconv{j}", F.relu(x))
            x = x + residual
        residual = self._res("res13", x)
        x = self._sep_bn("block13_sepconv1", F.relu(x))
        x = self._sep_bn("block13_sepconv2", F.relu(x))
        x = self._pool(x) + residual
        x = F.relu(self._sep_bn("block14_sepconv1", x))
        x = F.relu(self._sep_bn("block14_sepconv2", x))
        x = global_mean(x)
        return x if features_only else self.head(x)
