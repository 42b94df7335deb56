"""Precision rungs: compute dtype as a serving latency/cost dial.

The port of the JAX package's ``graph/precision.py``, three rungs:

- ``f32``: the loaded ModelFunction untouched (an f32 image model turns
  TF32 off in its own forward, so f32 means f32);
- ``bf16``: the module's floating parameters in bfloat16 and the JAX
  module's edge casts: floating inputs cast to bfloat16 on the way in
  (integer inputs such as token ids stay as they are), floating outputs
  back to float32, so the serving API's answer dtype never changes with
  the rung. Every floating parameter and buffer is stored in bfloat16,
  as the JAX rung casts every floating leaf; LayerNorm and BatchNorm
  upcast theirs and compute in float32. The default serving loader builds
  the registry's bf16 module natively, casts the rest of it and adds the
  edge casts (:func:`edge_casts`); a custom loader's module is cast as a
  whole by :func:`apply_precision`;
- ``int8-dynamic``: weight-only int8 with one symmetric per-tensor scale
  (:func:`int8_rung`). Every floating leaf of the JAX model function's
  variable tree with 256 or more elements is stored as ``{int8 q, f32
  s}``; the rest stay float32. A leaf is a torch parameter or buffer
  (BatchNorm statistics included, as flax's ``batch_stats``), except
  that a ResNet in the flax ``scan_blocks`` layout stacks each stage's
  identity blocks into one leaf, so they share one scale
  (:func:`leaf_groups`). The scale is ``max|w| / 127`` in float32 and
  ``q = clip(round(w / s), -127, 127)``, bit for bit the JAX package's
  ``_quantize_params``. Weights are dequantized at use, one layer at a
  time (``q.float() * s`` when the layer reads its weight; an embedding
  gathers its int8 rows, then scales them), so no float32 copy of the
  whole model is ever held. Inputs are not cast; floating outputs are
  cast to float32.

Selection is per SLA class, as in the JAX package:
``SPARKDL_SERVE_PRECISION`` sets every class,
``SPARKDL_SERVE_PRECISION_<CLASS>`` overrides one, default ``f32``. The
rung rides the residency key, the router's grouping key and the
function's name (``<name>@<rung>``).
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sparkdl_tpu_torch.graph.function import ModelFunction
from sparkdl_tpu_torch.runtime import knobs

#: Supported rungs, baseline first.
PRECISIONS = ("f32", "bf16", "int8-dynamic")

#: Floating leaves below this many elements stay float32 on the int8
#: rung (biases, norms, small heads), as in the JAX package.
_QUANT_MIN_ELEMS = 256


def serve_precision(priority: Optional[str] = None) -> str:
    """The precision rung for one SLA class (or the global default when
    ``priority`` is None): the per-class knob, then the global knob, then
    ``f32``. Unknown values raise, naming the knob: a typo'd rung must not
    silently serve f32."""
    raw = None
    name = "SPARKDL_SERVE_PRECISION"
    if priority:
        per_cls = f"SPARKDL_SERVE_PRECISION_{priority.upper()}"
        raw = knobs.get_str(per_cls)
        if raw:
            name = per_cls
    if not raw:
        raw = knobs.get_str("SPARKDL_SERVE_PRECISION") or "f32"
    if raw not in PRECISIONS:
        raise ValueError(f"{name}={raw!r}: expected one of {PRECISIONS}")
    return raw


def precision_active() -> bool:
    """Whether any precision knob is explicitly set: the gate for the
    per-rung ``serve.precision.<rung>.*`` metrics."""
    if knobs.get_raw("SPARKDL_SERVE_PRECISION") is not None:
        return True
    return any(
        knobs.get_raw(f"SPARKDL_SERVE_PRECISION_{cls}") is not None
        for cls in ("INTERACTIVE", "BATCH", "BACKGROUND")
    )


def _cast_floating(x: Any, dtype: torch.dtype) -> Any:
    """Cast floating tensors (alone or in a tuple/list) to ``dtype``;
    integer tensors pass through."""
    if isinstance(x, (tuple, list)):
        return type(x)(_cast_floating(v, dtype) for v in x)
    if isinstance(x, torch.Tensor) and x.is_floating_point():
        return x.to(dtype)
    return x


def edge_casts(mf: ModelFunction, precision: str = "bf16") -> ModelFunction:
    """``mf`` with the bf16 rung's edge casts (floating inputs to
    bfloat16, floating outputs to float32) around its fn, tagged with the
    rung. The module is shared, not copied."""
    inner = mf.fn

    def fn(module, x):
        return _cast_floating(inner(module, _cast_floating(x, torch.bfloat16)), torch.float32)

    return ModelFunction(
        fn,
        mf.module,
        mf.device,
        name=f"{mf.name}@{precision}",
        vocab_size=mf.vocab_size,
        input_shape=mf.input_shape,
        input_dtype=mf.input_dtype,
        precision=precision,
    )


def bf16_rung(mf: ModelFunction) -> ModelFunction:
    """The bf16 rung of a module built natively in bfloat16 (the registry's
    bf16 build): every floating parameter and buffer that is still float32
    (norms, embeddings) is cast to bfloat16 in place, then
    :func:`edge_casts` wraps the fn."""
    mf.module.to(torch.bfloat16)
    return edge_casts(mf, "bf16")


def apply_precision(mf: ModelFunction, precision: str) -> ModelFunction:
    """The ``precision`` rung of a ModelFunction. ``f32``, or a function
    already built at the rung (``mf.precision``), comes back unchanged;
    ``bf16`` and ``int8-dynamic`` give a NEW ModelFunction over a copy of
    the module (the caller's module is not touched): :func:`edge_casts`
    over a bfloat16 copy, or :func:`int8_rung` over a float32 one."""
    if precision not in PRECISIONS:
        raise ValueError(
            f"unknown precision rung {precision!r}; expected one of {PRECISIONS}"
        )
    if precision == "f32" or mf.precision == precision:
        return mf
    module = copy.deepcopy(mf.module)
    if precision == "int8-dynamic":
        return int8_rung(ModelFunction(
            mf.fn, module, mf.device, name=mf.name, vocab_size=mf.vocab_size,
            input_shape=mf.input_shape, input_dtype=mf.input_dtype,
            takes_nhwc=mf.takes_nhwc,
        ))
    return edge_casts(
        ModelFunction(
            mf.fn, module.to(torch.bfloat16), mf.device, name=mf.name,
            vocab_size=mf.vocab_size, input_shape=mf.input_shape,
            input_dtype=mf.input_dtype,
        ),
        precision,
    )


# -- the int8-dynamic rung ---------------------------------------------------


def _floating_tensors(module: nn.Module) -> Dict[str, torch.Tensor]:
    named = list(module.named_parameters()) + list(module.named_buffers())
    return {n: t for n, t in named if t.is_floating_point()}


def leaf_groups(module: nn.Module, scan_blocks: bool = False) -> List[List[str]]:
    """The leaves of the JAX model function's variable tree, each as the
    names of the module's floating tensors it holds: one tensor per leaf
    (a BERT encoder's tree and an image model's unrolled variables map one
    to one onto the state_dict, ``models/convert.py``), except under
    ``scan_blocks``, where ``convert.stack_blocks`` stacks a ResNet
    stage's identity blocks into one leaf."""
    if not scan_blocks:
        return [[name] for name in _floating_tensors(module)]
    from sparkdl_tpu_torch.models.convert import (
        _LEAF, _STATS, _flax_view, _leaves, stack_blocks,
    )

    names: List[str] = []
    tree: Dict[str, Dict[str, Any]] = {"params": {}, "batch_stats": {}}
    for collection, parts, leaf, _ in _flax_view(module):
        node = tree[collection]
        for part in parts:
            node = node.setdefault(part, {})
        # each leaf holds its tensor's index: stacking gathers the indices
        node[leaf] = np.array([len(names)])
        attr = (_LEAF if collection == "params" else _STATS)[leaf]
        names.append(".".join(parts + [attr]))
    return [
        [names[i] for i in np.ravel(ids)]
        for sub in tree.values()
        for _, ids in _leaves(stack_blocks(sub))
    ]


def quantize_group(tensors: List[torch.Tensor]) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """One leaf's int8 values and its scale, as the JAX package's
    ``_quantize_params`` computes them: ``s = max|w| / 127`` in float32
    (1.0 for an all-zero leaf), ``q = clip(round(w / s), -127, 127)`` with
    a float32 division and round-half-to-even. ``s`` is a 0-d float32
    tensor on the tensors' device (a CUDA tensor divided by a host scalar
    is multiplied by its reciprocal, which is not the same rounding)."""
    amax = max(float(t.detach().abs().max()) for t in tensors)
    scale = float(np.float32(amax) / 127.0) or 1.0
    s = torch.tensor(scale, dtype=torch.float32, device=tensors[0].device)
    qs = [
        torch.div(t.detach().float(), s).round_().clamp_(-127, 127).to(torch.int8)
        for t in tensors
    ]
    return qs, s


def dequantize(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``q.float() * s`` in float32 (one float32 copy of ``q``)."""
    return q.to(torch.float32).mul_(s)


class _Int8Held(nn.Module):
    """Mixin of a module that holds some of its tensors in int8: reading
    one of them (``module.weight``) dequantizes it then, so the float32
    view lives only as long as the op that reads it."""

    def __getattr__(self, name: str):
        held = self.__dict__.get("_int8_held")
        if held is not None and name in held:
            return dequantize(self._buffers[f"{name}_int8"], self._buffers[f"{name}_scale"])
        return super().__getattr__(name)


class _Int8Embedding(_Int8Held):
    """An embedding whose table is int8: the ids gather int8 rows, which are
    then scaled (the same float32 values as dequantizing the whole table
    first, at the bytes of the rows)."""

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        if "weight" not in self._int8_held:
            return super().forward(input)
        rows = F.embedding(input, self._buffers["weight_int8"], self.padding_idx)
        return dequantize(rows, self._buffers["weight_scale"])


_INT8_CLASSES: Dict[type, type] = {}


def _int8_class(cls: type) -> type:
    sub = _INT8_CLASSES.get(cls)
    if sub is None:
        mixin = _Int8Embedding if issubclass(cls, nn.Embedding) else _Int8Held
        sub = _INT8_CLASSES[cls] = type(f"Int8{cls.__name__}", (mixin, cls), {})
    return sub


def quantize_module(module: nn.Module, scan_blocks: bool = False) -> nn.Module:
    """Store ``module``'s leaves of :data:`_QUANT_MIN_ELEMS` elements or
    more in int8, in place: each tensor ``<attr>`` of an owning submodule
    becomes the buffers ``<attr>_int8`` and ``<attr>_scale`` (one scale
    tensor shared by a leaf's tensors), and the owner dequantizes it when
    its forward reads it. Returns ``module``."""
    tensors = _floating_tensors(module)
    for group in leaf_groups(module, scan_blocks):
        if sum(tensors[n].numel() for n in group) < _QUANT_MIN_ELEMS:
            continue
        qs, s = quantize_group([tensors[n] for n in group])
        for name, q in zip(group, qs):
            owner_name, _, attr = name.rpartition(".")
            owner = module.get_submodule(owner_name)
            owner._parameters.pop(attr, None)
            owner._buffers.pop(attr, None)
            owner.register_buffer(f"{attr}_int8", q)
            owner.register_buffer(f"{attr}_scale", s)
            owner.__dict__.setdefault("_int8_held", set()).add(attr)
            if not isinstance(owner, _Int8Held):
                owner.__class__ = _int8_class(type(owner))
        del qs
    return module


def int8_rung(mf: ModelFunction, scan_blocks: bool = False) -> ModelFunction:
    """The int8-dynamic rung over ``mf``'s own module (quantized in place:
    :func:`quantize_module`), with float32 outputs, tagged with the rung.
    ``scan_blocks`` groups a ResNet's leaves as the flax ``scan_blocks``
    layout does."""
    quantize_module(mf.module, scan_blocks)
    inner = mf.fn

    def fn(module, x):
        return _cast_floating(inner(module, x), torch.float32)

    return ModelFunction(
        fn,
        mf.module,
        mf.device,
        name=f"{mf.name}@int8-dynamic",
        vocab_size=mf.vocab_size,
        input_shape=mf.input_shape,
        input_dtype=mf.input_dtype,
        precision="int8-dynamic",
        takes_nhwc=mf.takes_nhwc,
    )


__all__ = [
    "PRECISIONS",
    "apply_precision",
    "bf16_rung",
    "dequantize",
    "edge_casts",
    "int8_rung",
    "leaf_groups",
    "quantize_group",
    "quantize_module",
    "precision_active",
    "serve_precision",
]
