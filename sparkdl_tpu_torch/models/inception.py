"""InceptionV3, port of the JAX package's ``models/inception.py``: 299x299
input, 'tf' preprocessing, 2048-d pooled features, a 1000-way ``head``.

The graph is written once, in :func:`_inception_v3`, over four operations;
``__init__`` runs it over channel counts to create the layers and
``_forward`` runs it over tensors. Both walk the convs in the same order,
the creation order of the flax module, which names its conv/BN pairs
``conv_{i}``/``bn_{i}`` (94 pairs): that order is the weight map.

What differs from a torchvision-style InceptionV3:

- ``cbr``: a bias-free conv, then BatchNorm without scale (eps 1e-3), then
  ReLU;
- the stride-2 convs and the 3x3 stride-2 max-pools are VALID (no pad);
  every "SAME" conv has stride 1 and an odd kernel, so its pad is
  symmetric per axis (the 1x7/7x1 pairs pad (0, 3)/(3, 0));
- the pool branches' 3x3 stride-1 average pool is "SAME" and leaves the
  padding out of the count (``count_include_pad=False``);
- branches are concatenated on the channel axis.
"""

from __future__ import annotations

from typing import Callable, List

import torch
import torch.nn.functional as F
from torch import nn

from sparkdl_tpu_torch.models.layers import BatchNorm, ImageCNN, global_mean

#: conv/BN pairs: stem 5, 3 x 7 inception-A, 4 reduction-A, 4 x 10
#: inception-B, 6 reduction-B, 2 x 9 inception-C
NUM_CONV_BN = 94


def _inception_v3(x, cbr: Callable, avg3: Callable, max3: Callable, cat: Callable):
    """The InceptionV3 graph up to the pooled features. ``cbr(y, filters,
    kh, kw, stride=1, same=True)`` is conv + BN + ReLU."""
    # stem: 299 -> 35x35x192
    x = cbr(x, 32, 3, 3, stride=2, same=False)
    x = cbr(x, 32, 3, 3, same=False)
    x = cbr(x, 64, 3, 3)
    x = max3(x)
    x = cbr(x, 80, 1, 1, same=False)
    x = cbr(x, 192, 3, 3, same=False)
    x = max3(x)
    # mixed 0-2 (inception-A, 35x35)
    for pool_filters in (32, 64, 64):
        b1 = cbr(x, 64, 1, 1)
        b5 = cbr(cbr(x, 48, 1, 1), 64, 5, 5)
        b3d = cbr(cbr(cbr(x, 64, 1, 1), 96, 3, 3), 96, 3, 3)
        bp = cbr(avg3(x), pool_filters, 1, 1)
        x = cat([b1, b5, b3d, bp])
    # mixed 3 (reduction-A -> 17x17x768)
    b3 = cbr(x, 384, 3, 3, stride=2, same=False)
    b3d = cbr(cbr(cbr(x, 64, 1, 1), 96, 3, 3), 96, 3, 3, stride=2, same=False)
    x = cat([b3, b3d, max3(x)])
    # mixed 4-7 (inception-B, 17x17, factorized 7x7)
    for width in (128, 160, 160, 192):
        b1 = cbr(x, 192, 1, 1)
        b7 = cbr(cbr(cbr(x, width, 1, 1), width, 1, 7), 192, 7, 1)
        b7d = cbr(x, width, 1, 1)
        b7d = cbr(cbr(b7d, width, 7, 1), width, 1, 7)
        b7d = cbr(cbr(b7d, width, 7, 1), 192, 1, 7)
        bp = cbr(avg3(x), 192, 1, 1)
        x = cat([b1, b7, b7d, bp])
    # mixed 8 (reduction-B -> 8x8x1280)
    b3 = cbr(cbr(x, 192, 1, 1), 320, 3, 3, stride=2, same=False)
    b7x3 = cbr(cbr(cbr(x, 192, 1, 1), 192, 1, 7), 192, 7, 1)
    b7x3 = cbr(b7x3, 192, 3, 3, stride=2, same=False)
    x = cat([b3, b7x3, max3(x)])
    # mixed 9-10 (inception-C, 8x8 -> 2048, split 1x3/3x1 branches)
    for _ in range(2):
        b1 = cbr(x, 320, 1, 1)
        b3 = cbr(x, 384, 1, 1)
        b3 = cat([cbr(b3, 384, 1, 3), cbr(b3, 384, 3, 1)])
        b3d = cbr(cbr(x, 448, 1, 1), 384, 3, 3)
        b3d = cat([cbr(b3d, 384, 1, 3), cbr(b3d, 384, 3, 1)])
        bp = cbr(avg3(x), 192, 1, 1)
        x = cat([b1, b3, b3d, bp])
    return x


class InceptionV3(ImageCNN):
    """InceptionV3 (Szegedy et al. 2015) at the flax module's geometry."""

    def __init__(self, num_classes: int = 1000, dtype: torch.dtype = torch.float32):
        super().__init__(dtype)
        count = 0

        def make(cin, filters, kh, kw, stride=1, same=True):
            nonlocal count
            pad = (kh // 2, kw // 2) if same else 0
            self.add_module(f"conv_{count}", nn.Conv2d(
                cin, filters, (kh, kw), stride=stride, padding=pad, bias=False
            ))
            self.add_module(f"bn_{count}", BatchNorm(filters, eps=1e-3, use_scale=False))
            count += 1
            return filters

        channels = _inception_v3(3, make, lambda c: c, lambda c: c, sum)
        self.num_conv_bn = count
        self.head = nn.Linear(channels, num_classes)

    def _forward(self, x: torch.Tensor, features_only: bool) -> torch.Tensor:
        layers = iter(range(self.num_conv_bn))

        def cbr(y, *_, **__):
            i = next(layers)
            return F.relu(getattr(self, f"bn_{i}")(getattr(self, f"conv_{i}")(y)))

        def avg3(y):
            return F.avg_pool2d(y, 3, stride=1, padding=1, count_include_pad=False)

        def max3(y):
            return F.max_pool2d(y, 3, stride=2)

        def cat(parts: List[torch.Tensor]) -> torch.Tensor:
            return torch.cat(parts, dim=1)

        x = global_mean(_inception_v3(x, cbr, avg3, max3, cat))
        return x if features_only else self.head(x)
