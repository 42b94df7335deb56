"""Keras 3 models translated into torch modules.

The JAX package runs a Keras model through ``model.stateless_call``
(its ``graph/ingest.py``, ``from_keras``). The port never imports keras:
it reads a model's config (``model.get_config()``, plain JSON, Functional
or Sequential, nested models included) and each layer's weights
(``model.get_layer(name).get_weights()``, numpy arrays), and builds an
``nn.Module`` that computes what the Keras model computes at inference.

Training: the module trains as Keras's ``fit`` does
(``estimators/keras_fit.py``). A layer's kernels, biases, gamma and beta
are ``nn.Parameter``s that require grad where Keras trains them (the
layer and every model around it ``trainable``); the moving statistics are
buffers. In ``train()`` mode a trainable BatchNormalization normalizes
with the batch's mean and biased variance and moves its statistics as
Keras does (``moving = moving * momentum + batch * (1 - momentum)``, the
config's momentum, 0.99 by default; ``F.batch_norm`` would move the
variance by the unbiased estimate); a frozen one uses its moving
statistics. Dropout drops with the module's ``torch.Generator``
(:meth:`KerasModule.seed_dropout`). :func:`spec_from_module` writes the
weights back into a :class:`KerasModelSpec`.

Layout: Keras is NHWC. Inside the module every rank-4 tensor is NCHW
(cuDNN's layout; on the card in ``channels_last`` memory format, as the
image converter of ``graph/pieces.py`` emits it). A rank-4 model input is
taken as NCHW, and rank-4 outputs are handed back as NHWC, so flattening
an output row gives Keras's order. Every Keras axis argument is mapped
onto that layout (``_torch_dim``). The forward runs under
``runtime/device.exact_float32``: float32 stays float32 on the card.

The layer table (``_BUILDERS``) covers what every ``keras.applications``
family uses: ResNet50/101/152 and their V2, MobileNet, MobileNetV2 and
MobileNetV3, InceptionV3, InceptionResNetV2, Xception, VGG16/19,
DenseNet, NASNet, EfficientNet, EfficientNetV2 and ConvNeXt, and the
common head layers. Two classes come from ``keras.applications``' own
modules (ConvNeXt's ``LayerScale``, InceptionResNetV2's
``CustomScaleLayer``). A Functional model may also hold op nodes: a
``keras.src.ops.numpy`` ``Add``, ``Multiply``, ``Subtract``, ``Divide``
or ``TrueDivide`` (``x + 3.0`` in a Keras model's code), whose arguments are tensors or
Python numbers (``_OPS``). The sequence layers (``SEQUENCE_CLASSES``:
Embedding, Conv1D, the recurrent layers, MultiHeadAttention, ...) are
built by ``graph/keras_seq.py``, whose docstring has the rules of the
Keras masks the graph carries beside the values; a model whose ``Input``
is of an integer dtype takes token ids. Another layer class or op, a dtype policy
other than float32, a ``channels_first`` layer, a model with more than
one input, ``Normalization(invert=True)`` or
``LayerNormalization(rms_scaling=True)`` raises NotImplementedError
naming ROADMAP Queue A item 9.

:class:`KerasModelSpec` is a Keras model held as data (its config and its
weights by layer path) that offers the same four members a Keras model
does (``get_config``, ``get_layer(name).get_weights()``, ``name``,
``input_shape``): what ``graph/keras_file.py`` reads a model file into,
and what a saved stage loads back.
"""

from __future__ import annotations

import functools
import math
import operator
import re
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sparkdl_tpu_torch.runtime.device import exact_float32

ROADMAP_ITEM = "ROADMAP Queue A item 9"

#: Keras classes whose config nests a whole model
MODEL_CLASSES = ("Functional", "Sequential")


def _unsupported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not translated from Keras to torch ({ROADMAP_ITEM})"
    )


def is_functional(config: dict) -> bool:
    """A Functional model's config names its inputs and outputs; a
    Sequential one lists its layers in order."""
    return "input_layers" in config


# -- config fields ------------------------------------------------------------


def _check_policy(class_name: str, cfg: dict) -> None:
    dtype = cfg.get("dtype") or "float32"
    if isinstance(dtype, dict):
        dtype = (dtype.get("config") or {}).get("name", "float32")
    if dtype != "float32":
        raise _unsupported(f"{class_name} {cfg.get('name')!r} with dtype policy {dtype!r}")
    if cfg.get("data_format", "channels_last") != "channels_last":
        raise _unsupported(f"{class_name} {cfg.get('name')!r} in {cfg['data_format']}")


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, int):
        return v, v
    return int(v[0]), int(v[1])


def _torch_dim(axis: int, rank: int) -> int:
    """A Keras (NHWC) axis of a rank-``rank`` tensor -> the dim of the
    module's layout (rank 4 is NCHW; other ranks, a sequence's ``[B, T,
    C]`` among them, are as in Keras)."""
    axis = axis % rank
    return (0, 2, 3, 1)[axis] if rank == 4 else axis


def _keras_shape(x: torch.Tensor) -> Tuple[int, ...]:
    """The shape Keras sees (NHWC for rank 4)."""
    return (x.shape[0], x.shape[2], x.shape[3], x.shape[1]) if x.dim() == 4 else tuple(x.shape)


def _keras_broadcast(v: torch.Tensor, x: torch.Tensor, axes) -> torch.Tensor:
    """A Keras weight over the Keras axes ``axes`` of ``x`` (in that order,
    as Keras reshapes it to its broadcast shape) -> broadcastable against
    ``x`` in the module's layout."""
    shape = _keras_shape(x)
    keep = {a % x.dim() for a in axes}
    target = [n if d in keep else 1 for d, n in enumerate(shape)]
    v = v.reshape(target) if v.numel() == math.prod(target) else torch.broadcast_to(v, target)
    return v.permute(0, 3, 1, 2) if x.dim() == 4 else v


def _keras_softmax(x: torch.Tensor) -> torch.Tensor:
    return torch.softmax(x, dim=_torch_dim(-1, x.dim()))


def _hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """keras.activations.hard_sigmoid (jax.nn's): relu6(x + 3) / 6."""
    return F.relu6(x + 3.0) / 6.0


def _hard_silu(x: torch.Tensor) -> torch.Tensor:
    """keras.activations.hard_silu, alias hard_swish: x * hard_sigmoid(x)."""
    return x * _hard_sigmoid(x)


#: the activations of keras.applications' models and of common heads
_ACTIVATIONS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "linear": lambda x: x,
    "relu": F.relu,
    "relu6": F.relu6,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softmax": _keras_softmax,
    "swish": F.silu,
    "silu": F.silu,
    "gelu": F.gelu,
    "hard_sigmoid": _hard_sigmoid,
    "hard_silu": _hard_silu,
    "hard_swish": _hard_silu,
}


def _activation(name, where: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name is None:
        return _ACTIVATIONS["linear"]
    if not isinstance(name, str) or name not in _ACTIVATIONS:
        raise _unsupported(f"activation {name!r} of {where}")
    return _ACTIVATIONS[name]


def _same_pads(size: int, k: int, stride: int, dilation: int = 1) -> Tuple[int, int]:
    """TF's "same" padding of one spatial dim: the odd unit goes at the
    end."""
    span = (k - 1) * dilation + 1
    total = max((-(-size // stride) - 1) * stride + span - size, 0)
    return total // 2, total - total // 2


def _spatial_pads(x: torch.Tensor, padding: str, k, stride, dilation=(1, 1)):
    """(top, bottom, left, right) for "valid" or "same" over NCHW ``x``."""
    if padding == "valid":
        return 0, 0, 0, 0
    if padding != "same":
        raise _unsupported(f"padding {padding!r}")
    top, bottom = _same_pads(x.shape[2], k[0], stride[0], dilation[0])
    left, right = _same_pads(x.shape[3], k[1], stride[1], dilation[1])
    return top, bottom, left, right


# -- layers -------------------------------------------------------------------


class _Identity(nn.Module):
    mask_rule = "keep"

    def forward(self, x):
        return x


def _param(t: Optional[torch.Tensor]) -> Optional[nn.Parameter]:
    return None if t is None else nn.Parameter(t)


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A weight as numpy: float32 and float64 as they are, other dtypes
    (bfloat16) as float32."""
    t = t.detach()
    if t.dtype not in (torch.float32, torch.float64):
        t = t.float()
    return t.cpu().numpy()


class _Conv(nn.Module):
    """Conv2D, DepthwiseConv2D and SeparableConv2D (a depthwise conv,
    then a 1x1 conv, then the bias), each then its activation.
    ``depthwise``: the depth multiplier of a depthwise kernel (None for
    Conv2D), which :meth:`keras_weights` needs to give Keras's layout
    back."""

    def __init__(self, weight, bias, stride, dilation, groups, padding, act, pointwise=None,
                 depthwise: Optional[int] = None):
        super().__init__()
        self.weight = _param(weight)
        self.pointwise = _param(pointwise)
        self.bias = _param(bias)
        self.stride, self.dilation, self.groups = stride, dilation, groups
        self.padding, self.act, self.depthwise = padding, act, depthwise

    def keras_weights(self) -> List[np.ndarray]:
        """The weights in Keras's layout and order."""
        if self.depthwise is None:
            out = [_numpy(self.weight.permute(2, 3, 1, 0))]  # OIHW -> HWIO
        else:
            out = [_keras_depthwise(_numpy(self.weight), self.depthwise)]
        if self.pointwise is not None:
            out.append(_numpy(self.pointwise.permute(2, 3, 1, 0)))
        if self.bias is not None:
            out.append(_numpy(self.bias))
        return out

    def forward(self, x):
        k = self.weight.shape[2:]
        top, bottom, left, right = _spatial_pads(x, self.padding, k, self.stride, self.dilation)
        pad = (0, 0)
        if (top, left) == (bottom, right):
            pad = (top, left)
        else:
            x = F.pad(x, (left, right, top, bottom))
        last_bias = self.bias if self.pointwise is None else None
        y = F.conv2d(x, self.weight, last_bias, self.stride, pad, self.dilation, self.groups)
        if self.pointwise is not None:
            y = F.conv2d(y, self.pointwise, self.bias)
        return self.act(y)


class _BatchNorm(nn.Module):
    """BatchNormalization over the channel axis (NCHW dim 1, the last axis
    below rank 4: a sequence's ``[B, T, C]`` features). In ``train()`` mode, when ``trainable``, Keras's
    training arithmetic: the batch's mean and biased variance,
    ``x * inv + (beta - mean * inv)`` with ``inv = gamma / sqrt(var +
    eps)``, and the moving statistics moved by ``momentum``."""

    mask_rule = "keep"
    mask_arg = True  # Keras's call takes a mask (which inference leaves unread)

    def __init__(self, gamma, beta, mean, var, eps, axis, momentum: float = 0.99):
        super().__init__()
        self.axis = axis
        self.weight = _param(gamma)
        self.bias = _param(beta)
        self.register_buffer("running_mean", mean)
        self.register_buffer("running_var", var)
        self.eps, self.momentum = eps, momentum
        self.trainable = True

    def forward(self, x):
        if x.dim() == 3 and self.axis % 3 == 2:  # a sequence's features: [B, T, C] as [B, C, T]
            return self._normalize(x.transpose(1, 2)).transpose(1, 2)
        if x.dim() > 1 and _torch_dim(self.axis, x.dim()) != 1:
            raise _unsupported(f"BatchNormalization over Keras axis {self.axis} of a rank-{x.dim()} tensor")
        return self._normalize(x)

    def _normalize(self, x):
        """Over dim 1."""
        if not (self.training and self.trainable):
            return F.batch_norm(
                x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, self.eps
            )
        dims = [d for d in range(x.dim()) if d != 1]
        mean = x.mean(dim=dims)
        var = x.var(dim=dims, unbiased=False)
        with torch.no_grad():
            self.running_mean.copy_(self.running_mean * self.momentum + mean.detach() * (1.0 - self.momentum))
            self.running_var.copy_(self.running_var * self.momentum + var.detach() * (1.0 - self.momentum))
        shape = [1] * x.dim()
        shape[1] = -1
        inv = torch.rsqrt(var + self.eps)
        if self.weight is not None:
            inv = inv * self.weight
        shift = -mean * inv
        if self.bias is not None:
            shift = shift + self.bias
        return x * inv.view(shape) + shift.view(shape)

    def keras_weights(self) -> List[np.ndarray]:
        out = [_numpy(t) for t in (self.weight, self.bias) if t is not None]
        return out + [_numpy(self.running_mean), _numpy(self.running_var)]


class _Dense(nn.Module):
    """Dense over the last Keras axis (channels of a rank-4 tensor)."""

    mask_rule = "keep"

    def __init__(self, weight, bias, act):
        super().__init__()
        self.weight = _param(weight)
        self.bias = _param(bias)
        self.act = act

    def keras_weights(self) -> List[np.ndarray]:
        return [_numpy(self.weight.t())] + ([] if self.bias is None else [_numpy(self.bias)])

    def forward(self, x):
        if x.dim() == 4:
            return self.act(F.linear(x.movedim(1, -1), self.weight, self.bias).movedim(-1, 1))
        return self.act(F.linear(x, self.weight, self.bias))


class _Dropout(nn.Module):
    """Keras Dropout: in ``train()`` mode, each element kept with
    probability ``1 - rate`` and scaled by its inverse, the draws from
    ``generator`` (set by :meth:`KerasModule.seed_dropout`); the identity
    otherwise, and at rate 0. ``noise_shape`` (Keras's, each entry None or
    1) draws one keep-draw per entry of that shape (EfficientNet's
    ``(None, 1, 1, 1)``: one per row) and broadcasts it."""

    mask_rule = "keep"

    def __init__(self, rate: float, noise_shape: Optional[tuple] = None):
        super().__init__()
        self.rate, self.noise_shape = rate, noise_shape
        self.generator: Optional[torch.Generator] = None

    def _draw_shape(self, x) -> Tuple[int, ...]:
        if self.noise_shape is None:
            return tuple(x.shape)
        if len(self.noise_shape) != x.dim():
            raise ValueError(f"Dropout noise_shape {self.noise_shape} against a rank-{x.dim()} input")
        shape = [n if d is None else d for d, n in zip(self.noise_shape, _keras_shape(x))]
        return (shape[0], shape[3], shape[1], shape[2]) if x.dim() == 4 else tuple(shape)

    def forward(self, x):
        if not self.training or self.rate <= 0:
            return x
        if self.generator is None:
            raise RuntimeError("a training Dropout needs its generator: call KerasModule.seed_dropout first")
        keep = 1.0 - self.rate
        mask = torch.rand(self._draw_shape(x), generator=self.generator, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


class _Pool(nn.Module):
    """MaxPooling2D / AveragePooling2D. "same" pads max pooling with
    -inf, and average pooling leaves the padding out of each count."""

    def __init__(self, kind: str, k, stride, padding: str):
        super().__init__()
        self.kind, self.k, self.stride, self.padding = kind, k, stride, padding

    def forward(self, x):
        top, bottom, left, right = _spatial_pads(x, self.padding, self.k, self.stride)
        symmetric = (top, left) == (bottom, right)
        if self.kind == "max":
            if symmetric:
                return F.max_pool2d(x, self.k, self.stride, (top, left))
            x = F.pad(x, (left, right, top, bottom), value=float("-inf"))
            return F.max_pool2d(x, self.k, self.stride)
        if symmetric:
            return F.avg_pool2d(x, self.k, self.stride, (top, left), count_include_pad=False)
        # a sum over the window, over the count of input cells in it
        pads = (left, right, top, bottom)
        total = F.avg_pool2d(F.pad(x, pads), self.k, self.stride, divisor_override=1)
        ones = F.pad(torch.ones_like(x[:1, :1]), pads)
        return total / F.avg_pool2d(ones, self.k, self.stride, divisor_override=1)


class _GlobalPool(nn.Module):
    def __init__(self, kind: str, keepdims: bool):
        super().__init__()
        self.kind, self.keepdims = kind, keepdims

    def forward(self, x):
        if self.kind == "max":
            return x.amax(dim=(2, 3), keepdim=self.keepdims)
        return x.mean(dim=(2, 3), keepdim=self.keepdims)


class _Flatten(nn.Module):
    def forward(self, x):
        if x.dim() == 4:
            x = x.permute(0, 2, 3, 1)  # Keras flattens NHWC rows
        return x.reshape(x.shape[0], -1)


class _ZeroPad(nn.Module):
    def __init__(self, pads):
        super().__init__()
        self.pads = pads  # (left, right, top, bottom)

    def forward(self, x):
        return F.pad(x, self.pads)


class _Act(nn.Module):
    mask_rule = "keep"

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


class _ReLU(nn.Module):
    """keras.activations.relu with ``negative_slope``, ``max_value`` and
    ``threshold``, in Keras's own order of operations."""

    mask_rule = "keep"

    def __init__(self, negative_slope: float, max_value: Optional[float], threshold: float):
        super().__init__()
        self.slope, self.max_value, self.threshold = negative_slope, max_value, threshold

    def forward(self, x):
        slope, max_value, threshold = self.slope, self.max_value, self.threshold
        if slope != 0 and max_value is None and threshold == 0:
            return F.leaky_relu(x, slope)
        negative = F.relu(threshold - x) if threshold != 0 else F.relu(-x)
        clip = max_value is not None
        if threshold != 0:
            y = x * (x > threshold).to(x.dtype)
        elif max_value == 6:
            y, clip = F.relu6(x), False
        else:
            y = F.relu(x)
        if clip:
            y = y.clamp(0.0, max_value)
        if slope != 0:
            y = y - slope * negative
        return y


def _or_masks(masks) -> Optional[torch.Tensor]:
    """Keras's merge mask: the OR of the inputs' masks when each has one,
    else none."""
    if masks is None or any(m is None for m in masks):
        return None
    return functools.reduce(torch.logical_or, masks)


class _Add(nn.Module):
    mask_rule = "own"

    def forward(self, xs, masks=None):
        return functools.reduce(torch.add, xs)

    def output_mask(self, xs, masks):
        return _or_masks(masks)


class _Multiply(nn.Module):
    """Keras Multiply: the product of its inputs, broadcast (an SE gate
    ``[B, C, 1, 1]`` times ``[B, C, H, W]``). Under masks, as Keras's
    ``_merge_function``: a masked step of an input counts as 1, and when
    every input has a mask the product is 0 where none keeps the step."""

    mask_rule = "own"

    def forward(self, xs, masks=None):
        if masks is None or all(m is None for m in masks):
            return functools.reduce(torch.mul, xs)
        xs = [x if m is None else torch.where(m[..., None], x, torch.ones_like(x)) for x, m in zip(xs, masks)]
        y = functools.reduce(torch.mul, xs)
        keep = self.output_mask(xs, masks)
        return y if keep is None else torch.where(keep[..., None], y, torch.zeros_like(y))

    def output_mask(self, xs, masks):
        return _or_masks(masks)


class _OpNode(nn.Module):
    """A ``keras.src.ops.numpy`` op node: ``fn`` over its positional
    arguments, tensors and Python numbers."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, args):
        return self.fn(*args)


class _Rescale(nn.Module):
    """Rescaling: ``x * scale + offset``, each a number or a list over the
    last Keras axis (a buffer)."""

    mask_rule = "keep"

    def __init__(self, scale, offset):
        super().__init__()
        for name, v in (("scale", scale), ("offset", offset)):
            if isinstance(v, (list, tuple)):
                self.register_buffer(name, torch.tensor(v, dtype=torch.float32))
            else:
                setattr(self, name, float(v))

    def forward(self, x):
        scale, offset = (v if isinstance(v, float) else _keras_broadcast(v, x, [-1])
                         for v in (self.scale, self.offset))
        return x * scale + offset


class _Normalize(nn.Module):
    """Normalization: ``(x - mean) / max(sqrt(variance), 1e-7)`` over the
    kept Keras ``axes``; ``mean`` and ``variance`` are Keras's (over the
    kept axes, or broadcast from the config's values), buffers that
    training leaves alone. ``count``: an adapted layer's third weight, kept
    to write back."""

    mask_rule = "keep"

    def __init__(self, mean, variance, axes, count: Optional[np.ndarray] = None):
        super().__init__()
        self.axes, self.count = tuple(axes), count
        self.register_buffer("mean", mean)
        self.register_buffer("variance", variance)

    def forward(self, x):
        mean = _keras_broadcast(self.mean, x, self.axes)
        std = torch.sqrt(_keras_broadcast(self.variance, x, self.axes))
        return (x - mean) / torch.clamp_min(std, 1e-7)

    def keras_weights(self) -> List[np.ndarray]:
        return [_numpy(self.mean), _numpy(self.variance), np.array(self.count)]


class _LayerNorm(nn.Module):
    """LayerNormalization over the Keras ``axes``, in Keras's arithmetic:
    the biased variance, ``x * inv + (beta - mean * inv)`` with ``inv =
    gamma / sqrt(var + eps)``."""

    mask_rule = "keep"

    def __init__(self, gamma, beta, axes, eps: float):
        super().__init__()
        self.weight, self.bias = _param(gamma), _param(beta)
        self.axes, self.eps = tuple(axes), eps

    def forward(self, x):
        dims = sorted({_torch_dim(a, x.dim()) for a in self.axes})
        mean = x.mean(dim=dims, keepdim=True)
        var = x.var(dim=dims, unbiased=False, keepdim=True)
        inv = torch.rsqrt(var + self.eps)
        if self.weight is not None:
            inv = inv * _keras_broadcast(self.weight, x, self.axes)
        shift = -mean * inv
        if self.bias is not None:
            shift = shift + _keras_broadcast(self.bias, x, self.axes)
        return x * inv + shift

    def keras_weights(self) -> List[np.ndarray]:
        return [_numpy(t) for t in (self.weight, self.bias) if t is not None]


class _LayerScale(nn.Module):
    """ConvNeXt's LayerScale: ``x * gamma`` over the last Keras axis."""

    def __init__(self, gamma):
        super().__init__()
        self.weight = _param(gamma)

    def forward(self, x):
        return x * _keras_broadcast(self.weight, x, [-1])

    def keras_weights(self) -> List[np.ndarray]:
        return [_numpy(self.weight)]


class _CustomScale(nn.Module):
    """InceptionResNetV2's CustomScaleLayer: ``inputs[0] + inputs[1] *
    scale``."""

    def __init__(self, scale: float):
        super().__init__()
        self.scale = scale

    def forward(self, xs):
        return xs[0] + xs[1] * self.scale


class _Reshape(nn.Module):
    """Reshape to Keras's ``target_shape`` (NHWC order): a rank-4 input is
    taken back to NHWC first, and a rank-4 result goes back to NCHW."""

    def __init__(self, target):
        super().__init__()
        self.target = tuple(int(d) for d in target)

    def forward(self, x):
        if x.dim() == 4:
            x = x.permute(0, 2, 3, 1)
        y = x.reshape(x.shape[0], *self.target)
        return y.permute(0, 3, 1, 2) if y.dim() == 4 else y


class _Crop(nn.Module):
    def __init__(self, crops):
        super().__init__()
        self.crops = crops  # (top, bottom, left, right)

    def forward(self, x):
        top, bottom, left, right = self.crops
        return x[:, :, top:x.shape[2] - bottom, left:x.shape[3] - right]


class _Concat(nn.Module):
    """Concatenate; its mask, as Keras's ``compute_mask``: each input's
    mask (all True where it has none) broadcast over the input's last
    axis, concatenated along the axis, then any over the last axis."""

    mask_rule = "own"

    def __init__(self, axis: int):
        super().__init__()
        self.axis = axis

    def forward(self, xs, masks=None):
        return torch.cat(list(xs), dim=_torch_dim(self.axis, xs[0].dim()))

    def output_mask(self, xs, masks):
        if masks is None or all(m is None for m in masks):
            return None
        full = [torch.ones_like(x, dtype=torch.bool) if m is None else m[..., None].expand(x.shape)
                for x, m in zip(xs, masks)]
        return torch.cat(full, dim=self.axis % xs[0].dim()).any(dim=-1)


# -- weights ------------------------------------------------------------------


def _weights(source, name: str, count: int) -> List[torch.Tensor]:
    arrays = source.get_layer(name).get_weights()
    if len(arrays) != count:
        raise ValueError(
            f"Keras layer {name!r} holds {len(arrays)} weight arrays, the "
            f"translator expects {count} from its config"
        )
    return [torch.from_numpy(np.array(a, dtype=np.float32)) for a in arrays]


def _conv_common(cfg: dict):
    return (
        _pair(cfg.get("strides", 1)),
        _pair(cfg.get("dilation_rate", 1)),
        cfg.get("padding", "valid"),
        _activation(cfg.get("activation"), cfg["name"]),
    )


def _build_conv2d(cfg, source):
    use_bias = cfg.get("use_bias", True)
    ws = _weights(source, cfg["name"], 2 if use_bias else 1)
    stride, dilation, padding, act = _conv_common(cfg)
    weight = ws[0].permute(3, 2, 0, 1).contiguous()  # HWIO -> OIHW
    return _Conv(weight, ws[1] if use_bias else None, stride, dilation,
                 int(cfg.get("groups", 1)), padding, act)


def _depthwise(kernel: torch.Tensor) -> torch.Tensor:
    """(kh, kw, in, mult) -> (in * mult, 1, kh, kw): output channel
    ``c * mult + m``, as Keras orders a depthwise conv's outputs."""
    kh, kw, cin, mult = kernel.shape
    return kernel.reshape(kh, kw, cin * mult).permute(2, 0, 1).unsqueeze(1).contiguous()


def _keras_depthwise(weight: np.ndarray, mult: int) -> np.ndarray:
    """The inverse of :func:`_depthwise`."""
    channels, _, kh, kw = weight.shape
    return np.ascontiguousarray(weight[:, 0].transpose(1, 2, 0).reshape(kh, kw, channels // mult, mult))


def _build_depthwise(cfg, source):
    use_bias = cfg.get("use_bias", True)
    ws = _weights(source, cfg["name"], 2 if use_bias else 1)
    stride, dilation, padding, act = _conv_common(cfg)
    return _Conv(_depthwise(ws[0]), ws[1] if use_bias else None, stride, dilation,
                 ws[0].shape[2], padding, act, depthwise=ws[0].shape[3])


def _build_separable(cfg, source):
    use_bias = cfg.get("use_bias", True)
    ws = _weights(source, cfg["name"], 3 if use_bias else 2)
    stride, dilation, padding, act = _conv_common(cfg)
    pointwise = ws[1].permute(3, 2, 0, 1).contiguous()
    return _Conv(_depthwise(ws[0]), ws[2] if use_bias else None, stride, dilation,
                 ws[0].shape[2], padding, act, pointwise=pointwise, depthwise=ws[0].shape[3])


def _build_batchnorm(cfg, source):
    axis = cfg.get("axis", -1)
    if isinstance(axis, (list, tuple)):
        if len(axis) != 1:
            raise _unsupported(f"BatchNormalization {cfg['name']!r} over axes {axis}")
        axis = axis[0]
    scale, center = cfg.get("scale", True), cfg.get("center", True)
    ws = _weights(source, cfg["name"], 2 + scale + center)
    gamma = ws.pop(0) if scale else None
    beta = ws.pop(0) if center else None
    return _BatchNorm(gamma, beta, ws[0], ws[1], float(cfg.get("epsilon", 1e-3)), int(axis),
                      momentum=float(cfg.get("momentum", 0.99)))


def _build_dense(cfg, source):
    use_bias = cfg.get("use_bias", True)
    ws = _weights(source, cfg["name"], 2 if use_bias else 1)
    return _Dense(ws[0].t().contiguous(), ws[1] if use_bias else None,
                  _activation(cfg.get("activation"), cfg["name"]))


def _build_pool(kind):
    def build(cfg, source):
        k = _pair(cfg.get("pool_size", 2))
        stride = cfg.get("strides")
        return _Pool(kind, k, k if stride is None else _pair(stride), cfg.get("padding", "valid"))

    return build


def _build_global(kind):
    return lambda cfg, source: _GlobalPool(kind, bool(cfg.get("keepdims", False)))


def _build_zero_padding(cfg, source):
    p = cfg.get("padding", 1)
    if isinstance(p, int):
        (top, bottom), (left, right) = (p, p), (p, p)
    elif isinstance(p[0], int):
        (top, bottom), (left, right) = (p[0], p[0]), (p[1], p[1])
    else:
        (top, bottom), (left, right) = p
    return _ZeroPad((int(left), int(right), int(top), int(bottom)))


def _build_relu(cfg, source):
    max_value = cfg.get("max_value")
    return _ReLU(
        float(cfg.get("negative_slope", 0.0)),
        None if max_value is None else float(max_value),
        float(cfg.get("threshold", 0.0)),
    )


def _build_dropout(cfg, source):
    noise = cfg.get("noise_shape")
    if noise is not None:
        if any(d not in (None, 1) for d in noise):
            raise _unsupported(f"Dropout {cfg['name']!r} with noise_shape {list(noise)}")
        noise = tuple(noise)
    return _Dropout(float(cfg.get("rate", 0.0)), noise)


def _axes(cfg, default) -> list:
    axis = cfg.get("axis", default)
    return list(axis) if isinstance(axis, (list, tuple)) else ([] if axis is None else [int(axis)])


def _build_rescaling(cfg, source):
    return _Rescale(cfg.get("scale", 1.0), cfg.get("offset", 0.0))


def _build_normalization(cfg, source):
    if cfg.get("invert", False):
        raise _unsupported(f"Normalization {cfg['name']!r} with invert=True")
    axes = _axes(cfg, -1)
    if cfg.get("mean") is None:  # adapted: mean, variance, count
        arrays = source.get_layer(cfg["name"]).get_weights()
        if len(arrays) != 3:
            raise ValueError(f"Keras layer {cfg['name']!r} holds {len(arrays)} weight arrays, an adapted "
                             "Normalization 3")
        mean, var = (torch.from_numpy(np.array(a, dtype=np.float32)) for a in arrays[:2])
        return _Normalize(mean, var, axes, count=np.asarray(arrays[2]))
    mean, var = (torch.tensor(cfg[k], dtype=torch.float32) for k in ("mean", "variance"))
    return _Normalize(mean, var, axes)


def _build_layer_norm(cfg, source):
    if cfg.get("rms_scaling", False):
        raise _unsupported(f"LayerNormalization {cfg['name']!r} with rms_scaling=True")
    scale, center = cfg.get("scale", True), cfg.get("center", True)
    ws = _weights(source, cfg["name"], scale + center)
    gamma = ws.pop(0) if scale else None
    beta = ws.pop(0) if center else None
    return _LayerNorm(gamma, beta, _axes(cfg, -1), float(cfg.get("epsilon", 1e-3)))


def _build_cropping(cfg, source):
    c = cfg.get("cropping", ((0, 0), (0, 0)))
    if isinstance(c, int):
        (top, bottom), (left, right) = (c, c), (c, c)
    elif isinstance(c[0], int):
        (top, bottom), (left, right) = (c[0], c[0]), (c[1], c[1])
    else:
        (top, bottom), (left, right) = c
    return _Crop((int(top), int(bottom), int(left), int(right)))


_BUILDERS: Dict[str, Callable[[dict, Any], nn.Module]] = {
    "InputLayer": lambda cfg, source: _Identity(),
    "Conv2D": _build_conv2d,
    "DepthwiseConv2D": _build_depthwise,
    "SeparableConv2D": _build_separable,
    "BatchNormalization": _build_batchnorm,
    "Activation": lambda cfg, source: _Act(_activation(cfg.get("activation"), cfg["name"])),
    "ReLU": _build_relu,
    "ZeroPadding2D": _build_zero_padding,
    "MaxPooling2D": _build_pool("max"),
    "AveragePooling2D": _build_pool("avg"),
    "GlobalAveragePooling2D": _build_global("avg"),
    "GlobalMaxPooling2D": _build_global("max"),
    "Add": lambda cfg, source: _Add(),
    "Concatenate": lambda cfg, source: _Concat(int(cfg.get("axis", -1))),
    "Dense": _build_dense,
    "Flatten": lambda cfg, source: _Flatten(),
    "Dropout": _build_dropout,
    "Rescaling": _build_rescaling,
    "Normalization": _build_normalization,
    "Reshape": lambda cfg, source: _Reshape(cfg["target_shape"]),
    "Multiply": lambda cfg, source: _Multiply(),
    "LayerNormalization": _build_layer_norm,
    "LayerScale": lambda cfg, source: _LayerScale(_weights(source, cfg["name"], 1)[0]),
    "Cropping2D": _build_cropping,
    "CustomScaleLayer": lambda cfg, source: _CustomScale(float(cfg["scale"])),
}

#: the sequence layers, built by ``graph/keras_seq.py`` (which imports
#: this module's helpers, so it is imported when a model needs it)
SEQUENCE_CLASSES = ("AveragePooling1D", "Bidirectional", "Conv1D", "Embedding", "GRU", "GlobalAveragePooling1D",
                    "GlobalMaxPooling1D", "LSTM", "Masking", "MaxPooling1D", "MultiHeadAttention", "SimpleRNN",
                    "SpatialDropout1D")

#: the Keras layer classes the translator builds (nested models aside)
LAYER_CLASSES = tuple(sorted(_BUILDERS) + sorted(SEQUENCE_CLASSES))

#: classes that keras.applications defines in its own modules, by module:
#: another module's class of the same name is not translated
_APP_MODULES = {
    "LayerScale": "keras.src.applications.convnext",
    "CustomScaleLayer": "keras.src.applications.inception_resnet_v2",
}

#: a Functional model's op nodes: the module Keras records for them, and
#: the ops translated
_OP_MODULE = "keras.src.ops.numpy"
_OPS = {"Add": operator.add, "Multiply": operator.mul, "Subtract": operator.sub, "Divide": operator.truediv,
        "TrueDivide": operator.truediv}


def _is_op_node(layer: dict) -> bool:
    """A ``keras.src.ops.numpy`` op in a Functional config (``x + 3.0``),
    not the ``keras.layers`` class of the same name: its ``module`` says
    so, or, in a legacy ``.h5`` file's config, which drops ``module``, a
    config holding nothing but the name (a layer's always holds its
    ``trainable`` and ``dtype``)."""
    module = layer.get("module")
    if module is not None:
        return module == _OP_MODULE
    return layer["class_name"] in _OPS and set(layer.get("config") or {}) <= {"name"}


def _build_layer(layer: dict, source, trainable: bool) -> nn.Module:
    """One layer's module. ``trainable``: whether every model around the
    layer trains; the layer's own flag is read here. A frozen layer's
    parameters do not require grad, and a frozen BatchNormalization keeps
    its moving statistics in training."""
    class_name = layer["class_name"]
    cfg = layer.get("config") or {}
    on = trainable and cfg.get("trainable", True)
    if class_name in MODEL_CLASSES:
        return KerasGraph(cfg, source.get_layer(cfg["name"]), trainable=on)
    if _is_op_node(layer):
        if class_name not in _OPS:
            raise _unsupported(f"Keras op {class_name!r} (node {cfg.get('name')!r})")
        return _OpNode(_OPS[class_name])
    if class_name in SEQUENCE_CLASSES:
        from sparkdl_tpu_torch.graph.keras_seq import SEQUENCE_MODULES as table
    elif class_name in _BUILDERS:
        table = _BUILDERS
    else:
        raise _unsupported(f"Keras layer class {class_name!r} (layer {cfg.get('name')!r})")
    module_name = layer.get("module")
    if class_name in _APP_MODULES and module_name not in (None, _APP_MODULES[class_name]):
        raise _unsupported(f"Keras layer class {class_name!r} of {module_name!r} (layer {cfg.get('name')!r})")
    _check_policy(class_name, cfg)
    module = table[class_name](cfg, source)
    module.requires_grad_(on)
    if isinstance(module, _BatchNorm):
        module.trainable = on
    return module


# -- graphs -------------------------------------------------------------------

def _refs(obj) -> Any:
    """A node's argument with each Keras tensor replaced by its
    ``keras_history`` (layer, node, tensor) triple."""
    if isinstance(obj, dict) and obj.get("class_name") == "__keras_tensor__":
        layer, node, index = obj["config"]["keras_history"]
        return (str(layer), int(node), int(index))
    if isinstance(obj, (list, tuple)):
        return [_refs(o) for o in obj]
    raise _unsupported(f"a layer call argument {obj!r}")


def _op_args(args: list, name: str) -> list:
    """An op node's positional arguments: each a Keras tensor's ref or a
    Python number, passed through as it is."""
    out = []
    for a in args:
        if isinstance(a, (int, float)) and not isinstance(a, bool):
            out.append(a)
        elif isinstance(a, dict) and a.get("class_name") == "__keras_tensor__":
            out.append(_refs(a))
        else:
            raise _unsupported(f"an argument {a!r} of op {name!r} (neither a tensor nor a number)")
    return out


def _is_tensor(v) -> bool:
    return isinstance(v, dict) and v.get("class_name") == "__keras_tensor__"


def _tensor_refs(obj) -> list:
    """The refs of every Keras tensor in a node's arguments, at any
    depth."""
    if _is_tensor(obj):
        return [_refs(obj)]
    if isinstance(obj, (list, tuple)):
        return [r for o in obj for r in _tensor_refs(o)]
    return []


def _io_refs(spec) -> list:
    """``input_layers``/``output_layers`` of a Functional config -> a list
    of refs (a single ``[name, node, index]`` is one ref)."""
    if isinstance(spec, dict):
        raise _unsupported("a model with named (dict) inputs or outputs")
    if spec and isinstance(spec[0], str):
        return [tuple(spec)]
    return [tuple(s) for s in spec]


def _ref_keys(arg) -> List[Tuple[str, int]]:
    if isinstance(arg, tuple):
        return [arg[:2]]
    if isinstance(arg, list):
        return [k for a in arg for k in _ref_keys(a)]
    return []  # an op node's number


def _resolve(arg, values: dict):
    if isinstance(arg, tuple):
        out = values[arg[:2]]
        if isinstance(out, (list, tuple)):
            return out[arg[2]]
        if arg[2] != 0:
            raise ValueError(f"layer {arg[0]!r} has one output, not {arg[2] + 1}")
        return out
    if isinstance(arg, list):
        return [_resolve(a, values) for a in arg]
    return arg


def _resolve_mask(arg, masks: dict):
    """The masks of :func:`_resolve`'s values (None where a value has
    none)."""
    if isinstance(arg, tuple):
        out = masks.get(arg[:2])
        return out[arg[2]] if isinstance(out, (list, tuple)) else out
    if isinstance(arg, list):
        return [_resolve_mask(a, masks) for a in arg]
    return None


def _has_mask(mask) -> bool:
    if isinstance(mask, (list, tuple)):
        return any(_has_mask(m) for m in mask)
    return mask is not None


def _module_key(name: str) -> str:
    return name.replace(".", "_")


#: call keywords a node may carry that the translation reads or may pass
#: over: ``mask`` is what Keras recorded of the mask it carried (the
#: translator carries the masks itself), ``training`` is False at inference
_PASSED_KWARGS = ("mask", "training")


def _layer_call(layer: dict, name: str, args: list, kwargs: dict):
    """A layer node's argument (a ref, or a list of refs) and its call
    options."""
    if layer["class_name"] == "MultiHeadAttention":
        return _attention_call(name, args, kwargs)
    if len(args) != 1:
        raise _unsupported(f"a call of {name!r} with {len(args)} positional arguments")
    for k, v in kwargs.items():
        if _is_tensor(v) and k not in _PASSED_KWARGS:
            raise _unsupported(f"a tensor keyword argument of {name!r}")
    return _refs(args[0]), {}


def _attention_call(name: str, args: list, kwargs: dict):
    """A MultiHeadAttention node: ``[query, value, key]`` refs (key None
    when it is the value) and ``causal``/``self_attention`` options."""
    kwargs = dict(kwargs)
    names = ("query", "value", "key")
    if len(args) > 3:
        raise _unsupported(f"a call of {name!r} with {len(args)} positional arguments")
    refs = dict(zip(names, args))
    for k in names:
        if k in kwargs:
            refs[k] = kwargs.pop(k)
    for k in ("attention_mask", "query_mask", "value_mask", "key_mask", "return_attention_scores"):
        if kwargs.get(k) not in (None, False):
            raise _unsupported(f"MultiHeadAttention {name!r} called with {k}")
    kwargs.pop("training", None)
    causal = bool(kwargs.pop("use_causal_mask", False))
    if kwargs:
        raise _unsupported(f"MultiHeadAttention {name!r} called with {sorted(kwargs)}")
    query, value = _refs(refs["query"]), _refs(refs["value"])
    key = None if refs.get("key") is None else _refs(refs["key"])
    self_attention = query == value and key in (None, value)
    return [query, value, key], {"causal": causal, "self_attention": self_attention}


class KerasGraph(nn.Module):
    """One Keras Functional or Sequential model in the module's layout
    (rank-4 tensors NCHW), inputs and outputs included: nested models are
    KerasGraphs called by their parent.

    Built once from ``config`` and ``source`` (an object whose
    ``get_layer(name)`` gives a layer with ``get_weights()``, or, for a
    nested model, another such object). The forward runs a plan made at
    build time: each (layer, node) of the graph in an order where its
    inputs exist, and each intermediate value is dropped after its last
    use.

    Masks (``graph/keras_seq.py``'s docstring has the rules) ride beside
    the values, by each module's ``mask_rule``; a graph where no layer
    makes one runs as it would without them. A Functional config records
    the masks Keras carried as op nodes (``NotEqual``, ``Any``,
    ``LogicalOr``, ...) that feed the ``mask`` keywords of later calls; the
    plan leaves out the op nodes that feed nothing else."""

    mask_rule = "graph"
    mask_arg = True

    def __init__(self, config: dict, source, trainable: bool = True):
        super().__init__()
        self.mods = nn.ModuleDict()
        self._trainable = trainable
        layers = config.get("layers") or []
        if is_functional(config):
            self._plan_functional(config, layers, source)
        else:
            self._plan_sequential(layers, source)

    def _add(self, layer: dict, source) -> str:
        key = _module_key(layer.get("name") or layer["config"]["name"])
        self.mods[key] = _build_layer(layer, source, self._trainable)
        return key

    def _plan_sequential(self, layers, source) -> None:
        steps, prev = [], ("__input__", 0)
        for i, layer in enumerate(layers):
            if layer["class_name"] == "InputLayer":
                continue
            key = self._add(layer, source)
            steps.append((key, (key, i), (*prev, 0), {}))
            prev = (key, i)
        self._inputs = [("__input__", 0)]
        self._outputs: Any = (*prev, 0)
        self._finish(steps)

    def _plan_functional(self, config, layers, source) -> None:
        inputs = _io_refs(config["input_layers"])
        if len(inputs) != 1:
            raise _unsupported(f"a model with {len(inputs)} inputs ({config.get('name')!r})")
        self._inputs = [inputs[0][:2]]
        spec = config["output_layers"]
        single = isinstance(spec, list) and bool(spec) and isinstance(spec[0], str)
        self._outputs = tuple(spec) if single else _io_refs(spec)
        nodes = []  # (layer, node key, argument, options)
        for layer in layers:
            name = layer.get("name") or layer["config"]["name"]
            if layer["class_name"] == "InputLayer":
                continue
            for n, node in enumerate(layer.get("inbound_nodes") or []):
                if not isinstance(node, dict):
                    raise _unsupported(f"a Keras 2 config (layer {name!r})")
                args = node.get("args") or []
                kwargs = node.get("kwargs") or {}
                if _is_op_node(layer):  # its arguments are read if the plan keeps it
                    nodes.append((layer, (name, n), _tensor_refs(args), {"args": args, "kwargs": kwargs}))
                else:
                    nodes.append((layer, (name, n), *_layer_call(layer, name, args, kwargs)))
        # the op nodes the outputs and the layers read, through other op
        # nodes: the others only computed Keras's mask keywords
        ops = {key: arg for layer, key, arg, _ in nodes if _is_op_node(layer)}
        wanted = _ref_keys(self._outputs) + [k for layer, _, arg, _ in nodes if not _is_op_node(layer)
                                             for k in _ref_keys(arg)]
        needed = set()
        while wanted:
            k = wanted.pop()
            if k in ops and k not in needed:
                needed.add(k)
                wanted += _ref_keys(ops[k])
        built = {}
        for layer in layers:
            name = layer.get("name") or layer["config"]["name"]
            if layer["class_name"] != "InputLayer" and (
                    not _is_op_node(layer) or any((name, n) in needed for n in range(len(layer["inbound_nodes"])))):
                built[name] = self._add(layer, source)
        pending = []
        for layer, key, arg, opts in nodes:
            if key[0] not in built or (_is_op_node(layer) and key not in needed):
                continue
            mod = built[key[0]]
            if _is_op_node(layer):
                if opts["kwargs"]:
                    raise _unsupported(f"keyword arguments {sorted(opts['kwargs'])} of op {key[0]!r}")
                arg, opts = _op_args(opts["args"], key[0]), {}
            if layer["class_name"] == "MultiHeadAttention":
                flash = opts.pop("self_attention") and not opts["causal"] and self.mods[mod].flash_ok
                opts["route"] = "flash" if flash else "plain"
            pending.append((mod, key, arg, opts))
        # order the nodes so that each runs after the nodes it reads
        steps, have = [], set(self._inputs)
        while pending:
            ready = [p for p in pending if all(k in have for k in _ref_keys(p[2]))]
            if not ready:
                raise ValueError(f"Keras model {config.get('name')!r}: a node reads a tensor no node makes")
            for p in ready:
                steps.append(p)
                have.add(p[1])
            pending = [p for p in pending if p[1] not in have]
        self._finish(steps)

    def _finish(self, steps) -> None:
        """Record the plan, with the values each step may drop."""
        keep = set(_ref_keys(self._outputs))
        last = {}
        for i, (_, _, arg, _) in enumerate(steps):
            for k in _ref_keys(arg):
                last[k] = i
        self._plan = [
            (mod, out, arg, opts, [k for k in set(_ref_keys(arg)) if last[k] == i and k not in keep])
            for i, (mod, out, arg, opts) in enumerate(steps)
        ]

    def attention_routes(self) -> Dict[str, int]:
        """MultiHeadAttention call sites by route (``flash``, ``plain``),
        nested models included."""
        out = {"flash": 0, "plain": 0}
        for mod, _, _, opts, _ in self._plan:
            if "route" in opts:
                out[opts["route"]] += 1
            elif isinstance(self.mods[mod], KerasGraph):
                for route, n in self.mods[mod].attention_routes().items():
                    out[route] += n
        return out

    def run(self, x, mask=None):
        """The outputs, and their masks (None where an output has none),
        of input ``x`` with mask ``mask``. Two sets of masks ride beside
        the values, as in Keras: the masks a Functional model recorded when
        it was built (``flow``), which a layer with a ``mask`` argument
        (``mask_arg``) is given, and the masks its tensors carry when it
        runs (``live``), which the other layers read; they differ after a
        MultiHeadAttention, which takes the masks off its inputs
        (``clears_input_masks``) for the layers that run after it."""
        values = {self._inputs[0]: x}
        live = {} if mask is None else {self._inputs[0]: mask}
        flow = dict(live)
        for key, out, arg, opts, drop in self._plan:
            mod = self.mods[key]
            inputs = _resolve(arg, values)
            m_flow = _resolve_mask(arg, flow) if flow else None
            m = m_flow if getattr(mod, "mask_arg", False) else _resolve_mask(arg, live) if live else None
            rule = mod.mask_rule if hasattr(mod, "mask_rule") else None
            if rule == "graph":
                y, m_out = mod.run(inputs, m)
                flow_out = m_out
            elif rule == "own":
                y = mod(inputs, m, **opts)
                m_out = mod.output_mask(inputs, m)
                flow_out = m_out if m is m_flow else mod.output_mask(inputs, m_flow)
            else:
                y = mod(inputs)
                m_out, flow_out = (m, m_flow) if rule == "keep" else (None, None)
            if getattr(mod, "clears_input_masks", False):
                for k in _ref_keys(arg):
                    live.pop(k, None)
            values[out] = y
            for masks, m_new in ((live, m_out), (flow, flow_out)):
                if _has_mask(m_new):
                    masks[out] = m_new
            for k in drop:
                del values[k]
                live.pop(k, None)
                flow.pop(k, None)
        return _resolve(self._outputs, values), _resolve_mask(self._outputs, live)

    def forward(self, x):
        return self.run(x)[0]


def _to_keras_layout(y):
    if isinstance(y, (list, tuple)):
        return [_to_keras_layout(v) for v in y]
    return y.permute(0, 2, 3, 1).contiguous() if y.dim() == 4 else y


class KerasModule(nn.Module):
    """A Keras model as a torch module: a rank-4 input NCHW, outputs in
    Keras's layout and structure (a tensor, or a list of them); the
    forward runs under ``exact_float32``. A model whose ``Input`` is of an
    integer dtype takes integer batches as they are and casts a float one
    as Keras does (truncating). ``config`` is kept for
    :func:`spec_from_module`."""

    def __init__(self, config: dict, source):
        super().__init__()
        self.config = config
        self.integer_input = config_input_dtype(config).startswith(("int", "uint"))
        self.graph = KerasGraph(config, source)

    def forward(self, x):
        if self.integer_input and x.is_floating_point():
            x = x.long()
        with exact_float32():
            return _to_keras_layout(self.graph(x))

    def attention_routes(self) -> Dict[str, int]:
        """The model's MultiHeadAttention call sites by route."""
        return self.graph.attention_routes()

    def seed_dropout(self, seed: int) -> None:
        """Give every Dropout one ``torch.Generator`` on the module's
        device, seeded with ``seed``."""
        device = next((t.device for t in self.parameters()), torch.device("cpu"))
        generator = torch.Generator(device=device).manual_seed(int(seed))
        for m in self.modules():
            if isinstance(m, _Dropout):
                m.generator = generator


def layer_module(module: KerasModule, path: str) -> nn.Module:
    """The torch module of the layer at ``path`` (:func:`walk_layers`'
    layer names joined by '/')."""
    node: nn.Module = module.graph
    for name in path.split("/"):
        node = node.mods[_module_key(name)]
    return node


def spec_from_module(module: KerasModule) -> "KerasModelSpec":
    """A translated (and perhaps trained) module's config and current
    weights as a :class:`KerasModelSpec`: each weighted layer's arrays in
    Keras's layout and order, as ``get_weights()`` gives them."""
    weights = {
        path: layer_module(module, path).keras_weights()
        for path, _, _, _ in walk_layers(module.config)
    }
    return KerasModelSpec(module.config, weights)


# -- a Keras model held as data --------------------------------------------------


def _snake(name: str) -> str:
    """keras.src.utils.naming.to_snake_case."""
    name = re.sub(r"\W+", "", name)
    name = re.sub("(.)([A-Z][a-z]+)", r"\1_\2", name)
    return re.sub("([a-z])([A-Z])", r"\1_\2", name).lower()


def walk_layers(config: dict, prefix: str = "", trainable: bool = True):
    """Every layer of ``config`` that holds weights, nested models
    included, in Keras's order: ``(path, object_path, layer, trainable)``.
    ``path`` joins the layer names with '/' (``base/conv1``);
    ``object_path`` is where a ``.keras`` archive keeps the layer's
    variables (``layers/functional/layers/conv2d``: by class name and
    order within each model's layer list, from which Sequential models
    leave their InputLayer out and Functional models their op nodes);
    ``trainable`` is False where the layer or a model around it is
    frozen."""
    yield from _walk(config, prefix, "", trainable)


def _walk(config: dict, prefix: str, obj_prefix: str, trainable: bool):
    used: Dict[str, int] = {}
    functional = is_functional(config)
    for layer in config.get("layers") or []:
        cls = layer["class_name"]
        if (cls == "InputLayer" and not functional) or _is_op_node(layer):
            continue
        snake = _snake(cls)
        used[snake] = used.get(snake, -1) + 1
        obj = snake if used[snake] == 0 else f"{snake}_{used[snake]}"
        cfg = layer.get("config") or {}
        path, obj_path = f"{prefix}{cfg.get('name') or layer.get('name')}", f"{obj_prefix}layers/{obj}"
        on = trainable and cfg.get("trainable", True)
        if cls in MODEL_CLASSES:
            yield from _walk(cfg, path + "/", obj_path + "/", on)
        elif cls in _WEIGHTED and not (cls == "Normalization" and cfg.get("mean") is not None):
            yield path, obj_path, layer, on


#: the classes that hold weights; a Normalization only when adapted (its
#: mean and variance are weights, not config values)
_WEIGHTED = ("Conv2D", "DepthwiseConv2D", "SeparableConv2D", "BatchNormalization", "Dense",
             "LayerNormalization", "LayerScale", "Normalization", "Embedding", "Conv1D", "SimpleRNN", "LSTM",
             "GRU", "Bidirectional", "MultiHeadAttention")


def weight_groups(class_name: str) -> Tuple[str, ...]:
    """Where a ``.keras`` archive keeps a weighted layer's variables below
    its object path, in ``get_weights()``'s order: a recurrent layer's
    under its cell, a Bidirectional's under its two layers' cells, a
    MultiHeadAttention's under its four EinsumDense sublayers."""
    if class_name in ("SimpleRNN", "LSTM", "GRU"):
        return ("cell/",)
    if class_name == "Bidirectional":
        return ("forward_layer/cell/", "backward_layer/cell/")
    if class_name == "MultiHeadAttention":
        return ("query_dense/", "key_dense/", "value_dense/", "output_dense/")
    return ("",)


def collect_weights(model) -> Dict[str, List[np.ndarray]]:
    """``{layer path: weight arrays}`` of every weighted layer of a Keras
    model (or any object with its ``get_config``/``get_layer``)."""
    out = {}
    for path, _, _, _ in walk_layers(model.get_config()):
        layer = model
        for name in path.split("/"):
            layer = layer.get_layer(name)
        out[path] = [np.asarray(a) for a in layer.get_weights()]
    return out


def config_input_shape(config: dict) -> Optional[tuple]:
    """The batch shape ``(None, ...)`` a model config declares, if any."""
    for layer in config.get("layers") or []:
        cfg = layer.get("config") or {}
        if layer["class_name"] == "InputLayer":
            shape = cfg.get("batch_shape") or cfg.get("batch_input_shape")
            return tuple(shape) if shape else None
        if layer["class_name"] in MODEL_CLASSES:
            return config_input_shape(cfg)
        break
    shape = config.get("build_input_shape")
    return tuple(shape) if shape else None


def config_input_dtype(config: dict) -> str:
    """The dtype of the model's ``Input`` ("float32" where the config
    names none)."""
    for layer in config.get("layers") or []:
        cfg = layer.get("config") or {}
        if layer["class_name"] == "InputLayer":
            dtype = cfg.get("dtype") or "float32"
            return dtype if isinstance(dtype, str) else (dtype.get("config") or {}).get("name", "float32")
        if layer["class_name"] in MODEL_CLASSES:
            return config_input_dtype(cfg)
        break
    return "float32"


class _LayerWeights:
    def __init__(self, weights: dict, path: str):
        self._weights, self._path = weights, path

    def get_weights(self) -> List[np.ndarray]:
        return list(self._weights.get(self._path, []))

    def get_layer(self, name: str) -> "_LayerWeights":
        return _LayerWeights(self._weights, f"{self._path}/{name}")


class KerasModelSpec:
    """A Keras model as data: its config and ``{layer path: weight
    arrays}`` (:func:`collect_weights`' keys), offering the members of a
    Keras model that the translator reads."""

    def __init__(self, config: dict, weights: Dict[str, List[np.ndarray]]):
        self._config = config
        self._weights = weights

    @property
    def name(self) -> str:
        return self._config.get("name", "keras_model")

    @property
    def input_shape(self) -> Optional[tuple]:
        return config_input_shape(self._config)

    def get_config(self) -> dict:
        return self._config

    def get_layer(self, name: str) -> _LayerWeights:
        return _LayerWeights(self._weights, name)
