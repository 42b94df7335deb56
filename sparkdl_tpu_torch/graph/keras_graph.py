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

The layer table (``_BUILDERS``) covers what ``keras.applications``'
ResNet50, MobileNetV2, InceptionV3, Xception and VGG16/19 use, and the
common head layers. Another layer class, a dtype policy other than
float32, a ``channels_first`` layer or a model with more than one input
raises NotImplementedError naming ROADMAP Queue A item 9.

:class:`KerasModelSpec` is a Keras model held as data (its config and its
weights by layer path) that offers the same four members a Keras model
does (``get_config``, ``get_layer(name).get_weights()``, ``name``,
``input_shape``): what ``graph/keras_file.py`` reads a model file into,
and what a saved stage loads back.
"""

from __future__ import annotations

import functools
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
    module's layout (rank 4 is NCHW; other ranks are as in Keras)."""
    axis = axis % rank
    return (0, 2, 3, 1)[axis] if rank == 4 else axis


def _keras_softmax(x: torch.Tensor) -> torch.Tensor:
    return torch.softmax(x, dim=_torch_dim(-1, x.dim()))


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
    """BatchNormalization over the channel axis (NCHW dim 1, or the last
    axis below rank 4). In ``train()`` mode, when ``trainable``, Keras's
    training arithmetic: the batch's mean and biased variance,
    ``x * inv + (beta - mean * inv)`` with ``inv = gamma / sqrt(var +
    eps)``, and the moving statistics moved by ``momentum``."""

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
        if x.dim() > 1 and _torch_dim(self.axis, x.dim()) != 1:
            raise _unsupported(f"BatchNormalization over Keras axis {self.axis} of a rank-{x.dim()} tensor")
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
    otherwise, and at rate 0."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None

    def forward(self, x):
        if not self.training or self.rate <= 0:
            return x
        if self.generator is None:
            raise RuntimeError("a training Dropout needs its generator: call KerasModule.seed_dropout first")
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, generator=self.generator, device=x.device) < keep
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
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


class _ReLU(nn.Module):
    """keras.activations.relu with ``negative_slope``, ``max_value`` and
    ``threshold``, in Keras's own order of operations."""

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


class _Add(nn.Module):
    def forward(self, xs):
        return functools.reduce(torch.add, xs)


class _Concat(nn.Module):
    def __init__(self, axis: int):
        super().__init__()
        self.axis = axis

    def forward(self, xs):
        return torch.cat(list(xs), dim=_torch_dim(self.axis, xs[0].dim()))


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
    if cfg.get("noise_shape") is not None:
        raise _unsupported(f"Dropout {cfg['name']!r} with a noise_shape")
    return _Dropout(float(cfg.get("rate", 0.0)))


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
}

#: the Keras layer classes the translator builds (nested models aside)
LAYER_CLASSES = tuple(sorted(_BUILDERS))


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
    if class_name not in _BUILDERS:
        raise _unsupported(f"Keras layer class {class_name!r} (layer {cfg.get('name')!r})")
    _check_policy(class_name, cfg)
    module = _BUILDERS[class_name](cfg, source)
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
    return [k for a in arg for k in _ref_keys(a)]


def _resolve(arg, values: dict):
    if isinstance(arg, tuple):
        out = values[arg[:2]]
        if isinstance(out, (list, tuple)):
            return out[arg[2]]
        if arg[2] != 0:
            raise ValueError(f"layer {arg[0]!r} has one output, not {arg[2] + 1}")
        return out
    return [_resolve(a, values) for a in arg]


def _module_key(name: str) -> str:
    return name.replace(".", "_")


class KerasGraph(nn.Module):
    """One Keras Functional or Sequential model in the module's layout
    (rank-4 tensors NCHW), inputs and outputs included: nested models are
    KerasGraphs called by their parent.

    Built once from ``config`` and ``source`` (an object whose
    ``get_layer(name)`` gives a layer with ``get_weights()``, or, for a
    nested model, another such object). The forward runs a plan made at
    build time: each (layer, node) of the graph in an order where its
    inputs exist, and each intermediate value is dropped after its last
    use."""

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
            steps.append((key, (key, i), (*prev, 0)))
            prev = (key, i)
        self._inputs = [("__input__", 0)]
        self._outputs: Any = (*prev, 0)
        self._finish(steps)

    def _plan_functional(self, config, layers, source) -> None:
        inputs = _io_refs(config["input_layers"])
        if len(inputs) != 1:
            raise _unsupported(f"a model with {len(inputs)} inputs ({config.get('name')!r})")
        self._inputs = [inputs[0][:2]]
        pending = []
        for layer in layers:
            name = layer.get("name") or layer["config"]["name"]
            if layer["class_name"] == "InputLayer":
                continue
            key = self._add(layer, source)
            for n, node in enumerate(layer.get("inbound_nodes") or []):
                if not isinstance(node, dict):
                    raise _unsupported(f"a Keras 2 config (layer {name!r})")
                args = node.get("args") or []
                if len(args) != 1:
                    raise _unsupported(f"a call of {name!r} with {len(args)} positional arguments")
                for v in (node.get("kwargs") or {}).values():
                    if isinstance(v, dict) and v.get("class_name") == "__keras_tensor__":
                        raise _unsupported(f"a tensor keyword argument of {name!r}")
                pending.append((key, (name, n), _refs(args[0])))
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
        spec = config["output_layers"]
        single = isinstance(spec, list) and bool(spec) and isinstance(spec[0], str)
        self._outputs = tuple(spec) if single else _io_refs(spec)
        self._finish(steps)

    def _finish(self, steps) -> None:
        """Record the plan, with the values each step may drop."""
        keep = set(_ref_keys(self._outputs))
        last = {}
        for i, (_, _, arg) in enumerate(steps):
            for k in _ref_keys(arg):
                last[k] = i
        self._plan = [
            (mod, out, arg, [k for k in set(_ref_keys(arg)) if last[k] == i and k not in keep])
            for i, (mod, out, arg) in enumerate(steps)
        ]

    def forward(self, x):
        values = {self._inputs[0]: x}
        for mod, out, arg, drop in self._plan:
            values[out] = self.mods[mod](_resolve(arg, values))
            for k in drop:
                del values[k]
        return _resolve(self._outputs, values)


def _to_keras_layout(y):
    if isinstance(y, (list, tuple)):
        return [_to_keras_layout(v) for v in y]
    return y.permute(0, 2, 3, 1).contiguous() if y.dim() == 4 else y


class KerasModule(nn.Module):
    """A Keras model as a torch module: a rank-4 input NCHW, outputs in
    Keras's layout and structure (a tensor, or a list of them); the
    forward runs under ``exact_float32``. ``config`` is kept for
    :func:`spec_from_module`."""

    def __init__(self, config: dict, source):
        super().__init__()
        self.config = config
        self.graph = KerasGraph(config, source)

    def forward(self, x):
        with exact_float32():
            return _to_keras_layout(self.graph(x))

    def seed_dropout(self, seed: int) -> None:
        """Give every Dropout one ``torch.Generator`` on the module's
        device, seeded with ``seed``."""
        device = next((t.device for t in self.parameters()), torch.device("cpu"))
        generator = torch.Generator(device=device).manual_seed(int(seed))
        for m in self.modules():
            if isinstance(m, _Dropout):
                m.generator = generator


def _layer_module(module: KerasModule, path: str) -> nn.Module:
    node: nn.Module = module.graph
    for name in path.split("/"):
        node = node.mods[_module_key(name)]
    return node


def spec_from_module(module: KerasModule) -> "KerasModelSpec":
    """A translated (and perhaps trained) module's config and current
    weights as a :class:`KerasModelSpec`: each weighted layer's arrays in
    Keras's layout and order, as ``get_weights()`` gives them."""
    weights = {
        path: _layer_module(module, path).keras_weights()
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
    leave their InputLayer out); ``trainable`` is False where the layer or
    a model around it is frozen."""
    yield from _walk(config, prefix, "", trainable)


def _walk(config: dict, prefix: str, obj_prefix: str, trainable: bool):
    used: Dict[str, int] = {}
    functional = is_functional(config)
    for layer in config.get("layers") or []:
        cls = layer["class_name"]
        if cls == "InputLayer" and not functional:
            continue
        snake = _snake(cls)
        used[snake] = used.get(snake, -1) + 1
        obj = snake if used[snake] == 0 else f"{snake}_{used[snake]}"
        cfg = layer.get("config") or {}
        path, obj_path = f"{prefix}{cfg.get('name') or layer.get('name')}", f"{obj_prefix}layers/{obj}"
        on = trainable and cfg.get("trainable", True)
        if cls in MODEL_CLASSES:
            yield from _walk(cfg, path + "/", obj_path + "/", on)
        elif cls in _WEIGHTED:
            yield path, obj_path, layer, on


_WEIGHTED = ("Conv2D", "DepthwiseConv2D", "SeparableConv2D", "BatchNormalization", "Dense")


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
