"""VGG16 and VGG19, ports of the JAX package's ``models/vgg.py``: 224x224
input, 'caffe' preprocessing, 512-d features, the classic
``fc1``/``fc2`` (4096) + ``head`` classifier for the logits.

The geometry is the flax module's, layer for layer:

- 3x3 convs ``block{b}_conv{j}`` padded by 1, **with** biases, ReLU; a 2x2
  stride-2 max-pool closes each of the five blocks; no BatchNorm;
- the features are the spatial **mean** of block 5, not its flatten;
- the logits flatten block 5 in NHWC row-major order, as keras'
  channels-last ``Flatten`` does, so ``fc1``'s rows carry across from the
  flax kernel unchanged. ``fc1``'s width follows the input geometry
  (7·7·512 = 25,088 at 224x224), so the module takes the input size.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from sparkdl_tpu_torch.models.layers import ImageCNN, global_mean

FILTERS = (64, 128, 256, 512, 512)


class VGG(ImageCNN):
    """``block_convs``: convs per block; ``input_size``: the (H, W) the
    classifier is built for."""

    def __init__(self, block_convs: Sequence[int], num_classes: int = 1000,
                 dtype: torch.dtype = torch.float32,
                 input_size: Tuple[int, int] = (224, 224)):
        super().__init__(dtype)
        self.conv_names = []
        cin = 3
        for b, (n_convs, ch) in enumerate(zip(block_convs, FILTERS), start=1):
            for j in range(1, n_convs + 1):
                name = f"block{b}_conv{j}"
                self.add_module(name, nn.Conv2d(cin, ch, 3, padding=1))
                self.conv_names.append(name)
                cin = ch
        self.block_ends = {f"block{b}_conv{n}" for b, n in enumerate(block_convs, start=1)}
        h, w = (s // 2 ** len(block_convs) for s in input_size)
        self.fc1 = nn.Linear(h * w * cin, 4096)
        self.fc2 = nn.Linear(4096, 4096)
        self.head = nn.Linear(4096, num_classes)

    def _forward(self, x: torch.Tensor, features_only: bool) -> torch.Tensor:
        for name in self.conv_names:
            x = F.relu(getattr(self, name)(x))
            if name in self.block_ends:
                x = F.max_pool2d(x, 2, stride=2)
        if features_only:
            return global_mean(x)
        # NHWC row-major flatten (free for a channels_last tensor)
        x = x.permute(0, 2, 3, 1).flatten(1)
        x = F.relu(self.fc1(x))
        x = F.relu(self.fc2(x))
        return self.head(x)


def VGG16(dtype: torch.dtype = torch.float32, num_classes: int = 1000,
          input_size: Tuple[int, int] = (224, 224)) -> VGG:
    return VGG((2, 2, 3, 3, 3), num_classes=num_classes, dtype=dtype, input_size=input_size)


def VGG19(dtype: torch.dtype = torch.float32, num_classes: int = 1000,
          input_size: Tuple[int, int] = (224, 224)) -> VGG:
    return VGG((2, 2, 4, 4, 4), num_classes=num_classes, dtype=dtype, input_size=input_size)
