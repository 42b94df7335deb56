"""What the port's image models share: inference BatchNorm, XLA's "SAME"
padding, the precision policy of their forward, and flax's seeded init.

Precision follows the JAX package's flax modules: with ``dtype=bfloat16``
the convs and dense layers store bf16 weights (:meth:`ImageCNN.cast_compute`)
and compute in bf16; BatchNorm keeps float32 statistics and parameters
(bf16 on the serving rung), computes in float32 and rounds to bf16; global pools sum in float32; the
output is float32. With ``dtype=float32`` the forward turns TF32 off for
its own convs and dense layers
(:func:`~sparkdl_tpu_torch.runtime.device.exact_float32`): cuDNN would
otherwise round their inputs to TF32 by PyTorch's default.
"""

from __future__ import annotations

import math
from contextlib import nullcontext
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from sparkdl_tpu_torch.runtime.device import exact_float32


class BatchNorm(nn.Module):
    """Inference-mode BatchNorm over NCHW channels, ``use_running_average``
    as flax's, computed in float32 whatever the input's dtype. Scale, bias
    and running statistics are float32, except on the bf16 serving rung,
    which stores them in bfloat16 as the JAX rung does: the forward
    upcasts them. ``use_scale=False`` (InceptionV3's, as keras'
    ``scale=False``) has no ``weight``, as the flax module has no ``scale``
    leaf.

    Statistics that require grad (the trainer differentiates them, as
    ``jax.value_and_grad`` does the flax ``batch_stats``; ``F.batch_norm``
    refuses them) take flax's own formula,
    ``(x - mean) * (scale * rsqrt(var + eps)) + bias``, with ``mul`` in the
    statistics' dtype and the rest promoted, as flax promotes it."""

    def __init__(self, channels: int, eps: float = 1e-5, use_scale: bool = True):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels)) if use_scale else None
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.running_mean.requires_grad or self.running_var.requires_grad:
            return self._flax_formula(x)
        weight = None if self.weight is None else self.weight.float()
        return F.batch_norm(
            x, self.running_mean.float(), self.running_var.float(), weight,
            self.bias.float(), training=False, momentum=0.0, eps=self.eps,
        )

    def _flax_formula(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(self.running_var + self.eps)
        if self.weight is not None:
            mul = mul * self.weight
        y = (x - self.running_mean.view(shape)) * mul.view(shape)
        return (y + self.bias.view(shape)).to(x.dtype)


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's "SAME" padding of one axis of ``size``: ``(before, after)``,
    the odd unit after. Torch's symmetric ``padding=`` equals it only where
    the total is even, as it always is for an odd kernel at stride 1."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, k: int, stride: int, value: float = 0.0) -> torch.Tensor:
    """Pad an NCHW tensor's H and W as XLA's "SAME" does for a ``k``x``k``
    window at ``stride``: with 0 before a conv, ``-inf`` before a max-pool."""
    top, bottom = same_pads(x.shape[2], k, stride)
    left, right = same_pads(x.shape[3], k, stride)
    return F.pad(x, (left, right, top, bottom), value=value)


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """Global average pool over H and W: a float32 sum, rounded to ``x``'s
    dtype as ``jnp.mean`` rounds it."""
    return torch.mean(x, dim=(2, 3), dtype=torch.float32).to(x.dtype)


class ImageCNN(nn.Module):
    """An image model of the registry: ``forward(x)`` returns float32
    logits, ``forward(x, features_only=True)`` the float32 pooled features.
    ``x`` is an NCHW float batch of preprocessed RGB images; it is cast to
    ``dtype`` first. Subclasses define ``_forward(x, features_only)``."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype

    def cast_compute(self) -> "ImageCNN":
        """Store the conv and dense weights (and their biases) in the
        compute dtype; BatchNorm stays float32."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                m.to(self.dtype)
        return self

    def forward(self, x: torch.Tensor, features_only: bool = False) -> torch.Tensor:
        with exact_float32() if self.dtype == torch.float32 else nullcontext():
            return self._forward(x.to(self.dtype), features_only).float()

    def _forward(self, x: torch.Tensor, features_only: bool) -> torch.Tensor:
        raise NotImplementedError


def _lecun_normal_(weight: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    """flax's ``lecun_normal``: a normal truncated at two standard
    deviations, scaled so the variance is 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std, generator=gen)


@torch.no_grad()
def init_cnn_params(module: nn.Module, gen: torch.Generator) -> None:
    """Seeded init with flax's distributions: lecun-normal conv and dense
    weights (a grouped conv's fan-in is its kernel over one group), zero
    biases, BatchNorm scale 1, bias 0, mean 0, var 1. Draws in module
    order from ``gen`` (a CPU generator gives the same weights wherever
    the module then goes)."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            # weight [out, in / groups, kh, kw] or [out, in]
            _lecun_normal_(m.weight, m.weight[0].numel(), gen)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, BatchNorm):
            if m.weight is not None:
                m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
