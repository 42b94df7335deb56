"""Precision rungs: compute dtype as a serving latency/cost dial.

The port of the JAX package's ``graph/precision.py`` for its ``f32`` and
``bf16`` rungs:

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
  whole by :func:`apply_precision`.

Selection is per SLA class, as in the JAX package:
``SPARKDL_SERVE_PRECISION`` sets every class,
``SPARKDL_SERVE_PRECISION_<CLASS>`` overrides one, default ``f32``. The
rung rides the residency key and the router's grouping key. The
``int8-dynamic`` rung (weight-only int8) is not ported yet.
"""

from __future__ import annotations

import copy
from typing import Any, Optional

import torch

from sparkdl_tpu_torch.graph.function import ModelFunction
from sparkdl_tpu_torch.runtime import knobs

#: Supported rungs, baseline first.
PRECISIONS = ("f32", "bf16")
#: Rungs of the JAX package that the port does not run yet.
NOT_PORTED = ("int8-dynamic",)


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
    if raw in NOT_PORTED:
        raise ValueError(f"{name}={raw!r}: not ported yet; expected one of {PRECISIONS}")
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
    ``bf16`` gives a NEW ModelFunction over a bfloat16 copy of the module
    (the caller's module is not touched) with :func:`edge_casts`."""
    if precision not in PRECISIONS:
        raise ValueError(
            f"unknown precision rung {precision!r}; expected one of {PRECISIONS}"
        )
    if precision == "f32" or mf.precision == precision:
        return mf
    module = copy.deepcopy(mf.module).to(torch.bfloat16)
    return edge_casts(
        ModelFunction(
            mf.fn, module, mf.device, name=mf.name, vocab_size=mf.vocab_size,
            input_shape=mf.input_shape, input_dtype=mf.input_dtype,
        ),
        precision,
    )


__all__ = [
    "NOT_PORTED",
    "PRECISIONS",
    "apply_precision",
    "bf16_rung",
    "edge_casts",
    "precision_active",
    "serve_precision",
]
