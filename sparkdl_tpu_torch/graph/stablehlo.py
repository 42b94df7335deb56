"""A StableHLO interpreter on torch: runs what ``graph/mlir_bytecode.py``
reads, without JAX.

The JAX package runs a keras-3/jax2tf ``XlaCallModule`` and its own
``program.stablehlo`` through ``jax.export``, which compiles the module
with XLA. The port compiles the module once into a :class:`Program`: per
function, a list of closures (a plan) over a flat list of value slots,
each op reading its operands' slots and writing its results', with every
slot freed after its last reader. ``Program(module, device)(*args)`` runs
``@main`` on torch tensors on ``device``.

Design:

- **Host values.** StableHLO carries shape arithmetic as tensors: the
  ``get_dimension_size`` of a polymorphic batch, ``i32`` constants, the
  ``concatenate``/``reshape`` of shape vectors that feed
  ``dynamic_broadcast_in_dim``, ``dynamic_reshape``,
  ``real_dynamic_slice`` and ``dynamic_iota``. Whether a value lives on
  the host is decided when the plan is built: a constant, or an op whose
  operands are all on the host, with a static shape of at most
  ``HOST_ELEMENTS`` elements and a numpy implementation, runs on the
  host as numpy. So a ResNet50 forward never reads the card back (the
  keras-3 export has 175 ``dynamic_broadcast_in_dim``).
- **Values kept between calls.** Each plan splits into steps whose values
  hold while its key holds (the weights' identities and versions, the
  host arguments' values, the other arguments' shapes: a BatchNorm's
  scale and shift, every shape op, a bias broadcast to the batch) and
  the steps that read the data; the first run once per key, and what the
  others read of theirs is kept. A ResNet50 batch then dispatches its
  convolutions and elementwise ops and little else. A host value that
  meets the device goes through pinned memory without a stream wait, and
  a reduction's host ``init`` as a Python scalar.
- **Regions.** ``reduce`` and ``reduce_window`` run their torch reduction
  where the body is one ``add``/``maximum``/``minimum``/``multiply``/
  ``and``/``or`` of the two block arguments, and ``select_and_scatter``
  (a pooling gradient) where its select body is one ``GE`` or ``LE``
  compare and its scatter body one ``add``; any other body is refused,
  naming it.
- **Convolution.** Any ``dimension_numbers``, strides, padding,
  dilations and ``feature_group_count`` become views into ``N, C,
  spatial`` and ``F.conv1d/2d/3d`` (on the card an NHWC input is a
  ``channels_last`` view, which cuDNN reads without a copy). A kernel
  argument's ``O, I, spatial`` copy is kept per tensor and version, so a
  graph's lifted weights are laid out once. That stays a library call:
  XLA emits these convolutions outside any Pallas kernel.
- **dot_general** is ``torch.einsum`` over the batch, contracting and
  free dimensions, in StableHLO's result order.
- **Custom calls.** ``shape_assertion`` evaluates its predicate on the
  host and raises its message with the dims filled in, as JAX does;
  ``mhlo.erf`` is ``torch.special.erf``. Any other target
  (``tpu_custom_call``, the Mosaic payload of an export made on a TPU,
  among them) is refused by name when the plan is built.
- **Float32.** A call runs under ``runtime/device.exact_float32``, as the
  port's other float32 graphs do.

Everything outside this (``while``, ``case``, ``sort``, ``scatter``,
``batch_group_count`` > 1, an operand-batching gather) raises
:class:`UnsupportedStableHLOError`, a ``NotImplementedError`` that names
it and ROADMAP item 13.
"""

from __future__ import annotations

import string
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sparkdl_tpu_torch.graph.mlir_bytecode import ITEM, Func, Module, NP_DTYPES, Op, Region, TensorType, Value
from sparkdl_tpu_torch.runtime.device import exact_float32

#: a host value holds at most this many elements
HOST_ELEMENTS = 64

TORCH_DTYPES = {
    "i1": torch.bool, "i8": torch.int8, "i16": torch.int16, "i32": torch.int32, "i64": torch.int64,
    "ui8": torch.uint8, "ui16": torch.uint16, "ui32": torch.uint32, "ui64": torch.uint64,
    "bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32, "f64": torch.float64,
    "index": torch.int64,
}
_HOST_DTYPES = {"i1", "i8", "i16", "i32", "i64", "ui8", "ui16", "ui32", "ui64", "index", "f32", "f64"}


class UnsupportedStableHLOError(NotImplementedError):
    """Raised when a module holds what the interpreter does not run."""

    def __init__(self, what: str):
        super().__init__(f"StableHLO: {what} is not supported ({ITEM})")


class ShapeAssertionError(ValueError):
    """A module's ``shape_assertion`` failed: the message is the module's."""


def _np_dtype(t: TensorType):
    return np.dtype(NP_DTYPES[t.dtype])


def _ints(a) -> List[int]:
    if isinstance(a, torch.Tensor):  # a shape computed on the device: read back
        return [int(v) for v in a.reshape(-1).tolist()]
    return [int(v) for v in np.asarray(a).reshape(-1)]


def _is_host(x) -> bool:
    return isinstance(x, np.ndarray)


# -- elementwise ----------------------------------------------------------------


def _trunc_div_np(a, b):
    if a.dtype.kind in "iu":
        q = np.abs(a) // np.where(b == 0, 1, np.abs(b))
        return (np.sign(a) * np.sign(b) * q).astype(a.dtype)
    return a / b


def _div_torch(a, b):
    if isinstance(a, torch.Tensor) and not a.is_floating_point() and a.dtype != torch.bool:
        return torch.div(a, b, rounding_mode="trunc")
    return a / b


def _logical(tfn_bool, tfn_int):
    def run(a, b):
        return tfn_bool(a, b) if a.dtype == torch.bool else tfn_int(a, b)
    return run


def _not_torch(a):
    return torch.logical_not(a) if a.dtype == torch.bool else torch.bitwise_not(a)


def _not_np(a):
    return np.logical_not(a) if a.dtype == np.bool_ else np.invert(a)


def _cbrt(a):
    return torch.sign(a) * torch.abs(a).pow(1.0 / 3.0)


def _round_afz(a):
    return torch.sign(a) * torch.floor(torch.abs(a) + 0.5)


def _is_finite(a):
    return torch.isfinite(a)


def _sign(a):
    return torch.sign(a) if a.dtype != torch.bool else a


UNARY: Dict[str, Callable] = {
    "abs": torch.abs, "negate": torch.neg, "exponential": torch.exp, "exponential_minus_one": torch.expm1,
    "log": torch.log, "log_plus_one": torch.log1p, "logistic": torch.sigmoid, "sqrt": torch.sqrt,
    "rsqrt": torch.rsqrt, "sine": torch.sin, "cosine": torch.cos, "tan": torch.tan, "tanh": torch.tanh,
    "cbrt": _cbrt, "floor": torch.floor, "ceil": torch.ceil, "round_nearest_even": torch.round,
    "round_nearest_afz": _round_afz, "sign": _sign, "not": _not_torch, "is_finite": _is_finite,
}
BINARY: Dict[str, Callable] = {
    "add": torch.add, "subtract": torch.sub, "multiply": torch.mul, "divide": _div_torch,
    "remainder": torch.fmod, "maximum": torch.maximum, "minimum": torch.minimum, "power": torch.pow,
    "atan2": torch.atan2,
    "and": _logical(torch.logical_and, torch.bitwise_and), "or": _logical(torch.logical_or, torch.bitwise_or),
    "xor": _logical(torch.logical_xor, torch.bitwise_xor),
    "shift_left": torch.bitwise_left_shift, "shift_right_arithmetic": torch.bitwise_right_shift,
}
UNARY_NP: Dict[str, Callable] = {
    "abs": np.abs, "negate": np.negative, "sign": np.sign, "not": _not_np, "floor": np.floor, "ceil": np.ceil,
}
BINARY_NP: Dict[str, Callable] = {
    "add": np.add, "subtract": np.subtract, "multiply": np.multiply, "divide": _trunc_div_np,
    "remainder": np.fmod, "maximum": np.maximum, "minimum": np.minimum,
    "and": lambda a, b: np.logical_and(a, b) if a.dtype == np.bool_ else np.bitwise_and(a, b),
    "or": lambda a, b: np.logical_or(a, b) if a.dtype == np.bool_ else np.bitwise_or(a, b),
    "xor": lambda a, b: np.logical_xor(a, b) if a.dtype == np.bool_ else np.bitwise_xor(a, b),
}
_COMPARE = {"EQ": "eq", "NE": "ne", "GE": "ge", "GT": "gt", "LE": "le", "LT": "lt"}
_COMPARE_NP = {"EQ": np.equal, "NE": np.not_equal, "GE": np.greater_equal, "GT": np.greater,
               "LE": np.less_equal, "LT": np.less}

#: a region body's single op -> (torch reduction over dims, the elementwise op)
_REDUCERS = {
    "stablehlo.add": (lambda x, d: torch.sum(x, d), torch.add),
    "stablehlo.multiply": (lambda x, d: torch.prod(x, d[0]) if len(d) == 1 else _prod_dims(x, d), torch.mul),
    "stablehlo.maximum": (lambda x, d: torch.amax(x, d), torch.maximum),
    "stablehlo.minimum": (lambda x, d: torch.amin(x, d), torch.minimum),
    "stablehlo.and": (lambda x, d: _all_dims(x, d), torch.logical_and),
    "stablehlo.or": (lambda x, d: _any_dims(x, d), torch.logical_or),
}


def _prod_dims(x, dims):
    for d in sorted(dims, reverse=True):
        x = torch.prod(x, d)
    return x


def _all_dims(x, dims):
    for d in sorted(dims, reverse=True):
        x = torch.all(x, d)
    return x


def _any_dims(x, dims):
    for d in sorted(dims, reverse=True):
        x = torch.any(x, d)
    return x


def region_reducer(op: Op) -> str:
    """The single elementwise op of ``op``'s region body (``reduce``,
    ``reduce_window``), or raise naming the body."""
    region = op.regions[0]
    body = region.blocks[0] if len(region.blocks) == 1 else None
    names = [o.name for o in body.ops] if body else ["<several blocks>"]
    if (
        body is None
        or len(body.args) != 2
        or len(body.ops) != 2
        or body.ops[0].name not in _REDUCERS
        or body.ops[1].name != "stablehlo.return"
        or list(body.ops[0].operands) not in (body.args, body.args[::-1])
        or body.ops[1].operands != body.ops[0].results
    ):
        raise UnsupportedStableHLOError(f"a {op.name} body of ({', '.join(names)})")
    return body.ops[0].name


# -- shapes ----------------------------------------------------------------------


def _broadcast_in_dim(x, dims: Sequence[int], shape: Sequence[int]):
    view = [1] * len(shape)
    for i, d in enumerate(dims):
        view[d] = x.shape[i]
    if _is_host(x):
        return np.broadcast_to(x.reshape(view), tuple(shape)).copy()
    return x.reshape(view).expand(*shape)


def _reshape_dims(t: TensorType) -> List[int]:
    """A result type's shape, its one dynamic dim (if any) as -1."""
    dims = [(-1 if d is None else d) for d in t.shape]
    if dims.count(-1) > 1:
        raise UnsupportedStableHLOError(f"a reshape to {t} with more than one dynamic dim")
    return dims


def _pad(x, value, low, high, interior):
    if any(i < 0 for i in interior):
        raise UnsupportedStableHLOError("a pad with negative interior padding")
    host = _is_host(x)
    if any(interior):
        shape = [(n - 1) * (i + 1) + 1 if n else 0 for n, i in zip(x.shape, interior)]
        if host:
            out = np.full(shape, value, x.dtype)
        else:
            out = torch.full(shape, value, dtype=x.dtype, device=x.device)
        out[tuple(slice(None, None, i + 1) for i in interior)] = x
        x = out
    if host:
        x = x[tuple(slice(max(-lo, 0), n - max(-hi, 0)) for lo, hi, n in zip(low, high, x.shape))]
        return np.pad(x, [(max(lo, 0), max(hi, 0)) for lo, hi in zip(low, high)], constant_values=value)
    pads = []
    for lo, hi in zip(reversed(low), reversed(high)):
        pads += [lo, hi]
    if any(pads):
        x = F.pad(x, pads, value=value)
    return x


def _slice(x, start, limit, strides):
    return x[tuple(slice(a, b, s) for a, b, s in zip(start, limit, strides))]


# -- convolution, dot -------------------------------------------------------------


class _KernelCache:
    """A convolution kernel argument's ``O, I, spatial`` copy, kept per
    tensor and version, so a graph's lifted weights are laid out once."""

    def __init__(self):
        self._items: Dict[Tuple[int, Tuple[int, ...]], Tuple[Any, int, torch.Tensor]] = {}

    def get(self, w: torch.Tensor, perm: Tuple[int, ...], flip: Tuple[int, ...], channels_last: bool):
        key = (id(w), perm, flip, channels_last)
        hit = self._items.get(key)
        if hit is not None and hit[0]() is w and hit[1] == w._version:
            return hit[2]
        k = w.permute(*perm)
        if flip:
            k = torch.flip(k, flip)
        k = k.contiguous(memory_format=torch.channels_last) if channels_last else k.contiguous()
        self._items[key] = (weakref.ref(w, lambda _, key=key: self._items.pop(key, None)), w._version, k)
        return k


def _convolution(op: Op, kernel_cache: _KernelCache):
    a = op.attrs
    n_sp = len(_ints(a["input_spatial_dimensions"]))
    if n_sp not in (1, 2, 3):
        raise UnsupportedStableHLOError(f"a convolution with {n_sp} spatial dimensions")
    if int(a["batch_group_count"]) != 1:
        raise UnsupportedStableHLOError("a convolution with batch_group_count > 1")
    in_perm = (int(a["input_batch_dimension"]), int(a["input_feature_dimension"]),
               *_ints(a["input_spatial_dimensions"]))
    k_perm = (int(a["kernel_output_feature_dimension"]), int(a["kernel_input_feature_dimension"]),
              *_ints(a["kernel_spatial_dimensions"]))
    out_dims = (int(a["output_batch_dimension"]), int(a["output_feature_dimension"]),
                *_ints(a["output_spatial_dimensions"]))
    out_perm = tuple(int(i) for i in np.argsort(out_dims))  # N, C, spatial -> the output layout
    strides = _ints(a["window_strides"]) or [1] * n_sp
    pad = np.asarray(a["padding"]).reshape(-1, 2) if np.size(a["padding"]) else np.zeros((n_sp, 2), np.int64)
    lhs_dil = _ints(a["lhs_dilation"]) or [1] * n_sp
    rhs_dil = _ints(a["rhs_dilation"]) or [1] * n_sp
    rev = [bool(v) for v in np.asarray(a["window_reversal"]).reshape(-1)] if np.size(a["window_reversal"]) else []
    flip = tuple(2 + i for i, r in enumerate(rev) if r)
    groups = int(a["feature_group_count"])
    sym = [int(min(lo, hi)) if lo >= 0 and hi >= 0 else 0 for lo, hi in pad]
    extra = [(int(lo) - s, int(hi) - s) for (lo, hi), s in zip(pad, sym)]
    conv = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}[n_sp]
    out_type = op.results[0].type

    def run(x, w):
        x = x.permute(*in_perm)
        if any(d != 1 for d in lhs_dil):
            x = _pad(x, 0, [0] * (2 + n_sp), [0] * (2 + n_sp), [0, 0] + [d - 1 for d in lhs_dil])
        if any(lo or hi for lo, hi in extra):
            pads = []
            for lo, hi in reversed(extra):
                pads += [lo, hi]
            x = F.pad(x, pads)
        on_card = x.is_cuda and n_sp == 2
        k = kernel_cache.get(w, k_perm, flip, on_card)
        y = conv(x, k, None, strides, sym, rhs_dil, groups)
        y = y.permute(*out_perm)
        if TORCH_DTYPES[out_type.dtype] != y.dtype:
            y = y.to(TORCH_DTYPES[out_type.dtype])
        return y

    return run


def _dot_general(op: Op):
    a = op.attrs
    lb, rb = _ints(a["lhs_batching_dimensions"]), _ints(a["rhs_batching_dimensions"])
    lc, rc = _ints(a["lhs_contracting_dimensions"]), _ints(a["rhs_contracting_dimensions"])
    lt, rt = op.operands[0].type, op.operands[1].type
    letters = iter(string.ascii_letters)
    lhs = [None] * len(lt.shape)
    rhs = [None] * len(rt.shape)
    batch = []
    for i, j in zip(lb, rb):
        c = next(letters)
        lhs[i] = rhs[j] = c
        batch.append(c)
    for i, j in zip(lc, rc):
        c = next(letters)
        lhs[i] = rhs[j] = c
    lfree = [next(letters) if c is None else None for c in lhs]
    lhs = [c if c is not None else f for c, f in zip(lhs, lfree)]
    lfree = [f for f in lfree if f]
    rfree = [next(letters) if c is None else None for c in rhs]
    rhs = [c if c is not None else f for c, f in zip(rhs, rfree)]
    rfree = [f for f in rfree if f]
    eq = f"{''.join(lhs)},{''.join(rhs)}->{''.join(batch + lfree + rfree)}"
    out_dtype = TORCH_DTYPES[op.results[0].type.dtype]

    def run(x, y):
        if x.dtype != y.dtype:
            x, y = x.to(out_dtype), y.to(out_dtype)
        z = torch.einsum(eq, x, y)
        return z if z.dtype == out_dtype else z.to(out_dtype)

    return run


# -- gather -----------------------------------------------------------------------


def _gather(op: Op, dynamic: bool):
    a = op.attrs
    if _ints(a.get("operand_batching_dims", ())) or _ints(a.get("start_indices_batching_dims", ())):
        raise UnsupportedStableHLOError(f"a {op.name} with operand batching dims")
    offset_dims = _ints(a["offset_dims"])
    collapsed = _ints(a["collapsed_slice_dims"])
    start_map = _ints(a["start_index_map"])
    ivd = int(a["index_vector_dim"])
    static_sizes = None if dynamic else _ints(a["slice_sizes"])

    def run(x, idx, sizes=None):
        sizes = static_sizes if sizes is None else _ints(sizes)
        idx = idx if isinstance(idx, torch.Tensor) else _to_device(idx, x.device, torch.int64)
        if ivd == idx.dim():
            idx = idx.unsqueeze(-1)
        idx = torch.movedim(idx, ivd, -1).to(torch.int64)
        batch_shape = tuple(idx.shape[:-1])
        nb, r = len(batch_shape), x.dim()
        index = []
        for d in range(r):
            shape = [1] * (nb + r)
            shape[nb + d] = sizes[d]
            ar = torch.arange(sizes[d], device=x.device).reshape(shape)
            if d in start_map:
                s = idx[..., start_map.index(d)].clamp(0, x.shape[d] - sizes[d])
                index.append(s.reshape(batch_shape + (1,) * r) + ar)
            else:
                index.append(ar)
        g = x[tuple(index)]  # batch_shape + sizes
        keep = [d for d in range(r) if d not in collapsed]
        g = g.reshape(batch_shape + tuple(sizes[d] for d in keep))
        # batch dims fill the result positions that are not offset dims
        rank = nb + len(keep)
        batch_pos = [p for p in range(rank) if p not in offset_dims]
        src = [0] * rank
        for i, p in enumerate(batch_pos):
            src[p] = i
        for i, p in enumerate(offset_dims):
            src[p] = nb + i
        return g.permute(*src)

    return run


def _dynamic_slice(op: Op):
    sizes = _ints(op.attrs["slice_sizes"])

    def run(x, *starts):
        if all(_is_host(s) for s in starts):
            st = [min(max(int(s), 0), n - k) for s, n, k in zip(starts, x.shape, sizes)]
            return _slice(x, st, [s + k for s, k in zip(st, sizes)], [1] * len(sizes))
        out = x
        for d, (s, k) in enumerate(zip(starts, sizes)):
            s = s if isinstance(s, torch.Tensor) else _to_device(s, x.device, torch.int64)
            s = s.to(x.device, torch.int64).clamp(0, x.shape[d] - k)
            out = torch.index_select(out, d, s + torch.arange(k, device=x.device))
        return out

    return run


def _dynamic_update_slice(x, upd, *starts):
    if not all(_is_host(s) for s in starts):
        raise UnsupportedStableHLOError("a dynamic_update_slice at indices computed on the device")
    st = [min(max(int(s), 0), n - k) for s, n, k in zip(starts, x.shape, upd.shape)]
    out = x.clone() if isinstance(x, torch.Tensor) else x.copy()
    out[tuple(slice(s, s + k) for s, k in zip(st, upd.shape))] = upd
    return out


# -- reduce, reduce_window -----------------------------------------------------------


def _reduce(op: Op):
    if len(op.operands) != 2:
        raise UnsupportedStableHLOError(f"a reduce over {len(op.operands) // 2} operands (a variadic reduce)")
    body = region_reducer(op)
    red = _REDUCERS[body][0]
    dims = tuple(_ints(op.attrs["dimensions"]))
    out_dtype = TORCH_DTYPES[op.results[0].type.dtype]

    def run(x, init):
        y = red(x, dims) if dims else x
        y = _combine(body, y, init)
        return y if y.dtype == out_dtype else y.to(out_dtype)

    return run


def _reduce_window(op: Op):
    if len(op.operands) != 2:
        raise UnsupportedStableHLOError(f"a reduce_window over {len(op.operands) // 2} operands")
    body = region_reducer(op)
    red = _REDUCERS[body][0]
    a = op.attrs
    win = _ints(a["window_dimensions"])
    r = len(win)
    strides = _ints(a["window_strides"]) or [1] * r
    base = _ints(a["base_dilations"]) or [1] * r
    wdil = _ints(a["window_dilations"]) or [1] * r
    pad = np.asarray(a["padding"]).reshape(-1, 2).tolist() if np.size(a["padding"]) else [[0, 0]] * r
    lows, highs = [int(p[0]) for p in pad], [int(p[1]) for p in pad]
    window_axes = [d for d in range(r) if win[d] != 1 or strides[d] != 1 or lows[d] or highs[d] or base[d] != 1]
    pool2d = (
        body in ("stablehlo.maximum", "stablehlo.add")
        and len(window_axes) == 2
        and all(b == 1 for b in base)
        and (body == "stablehlo.maximum" or all(d == 1 for d in wdil))
    )

    def run(x, init):
        fill = float(init) if _is_host(init) else None
        if fill is None or any(b != 1 for b in base):
            if fill is None:
                raise UnsupportedStableHLOError("a reduce_window whose init value is computed on the device")
            x = _pad(x, fill, [0] * r, [0] * r, [b - 1 for b in base])
        if pool2d and fill is not None and (body == "stablehlo.add" and fill == 0.0
                                            or body == "stablehlo.maximum"):
            h, w = window_axes
            rest = [d for d in range(r) if d not in window_axes]
            perm = rest + [h, w]
            xv = x.permute(*perm)
            lead = tuple(xv.shape[:-2])
            if len(rest) != 2:  # pooling takes [N, C, H, W]
                xv = xv.reshape((1, -1) + tuple(xv.shape[-2:]))
            if any(lows[d] or highs[d] for d in (h, w)):
                xv = F.pad(xv, [lows[w], highs[w], lows[h], highs[h]], value=fill)
            if body == "stablehlo.maximum":
                y = F.max_pool2d(xv, (win[h], win[w]), (strides[h], strides[w]), 0, (wdil[h], wdil[w]))
            else:
                y = F.avg_pool2d(xv, (win[h], win[w]), (strides[h], strides[w]), 0, divisor_override=1)
            if len(rest) != 2:
                y = y.reshape(lead + tuple(y.shape[-2:]))
            y = y.permute(*np.argsort(perm).tolist())
            return _combine(body, y, init)
        pads = []
        for lo, hi in zip(reversed(lows), reversed(highs)):
            pads += [lo, hi]
        if any(pads):
            x = F.pad(x, pads, value=fill)
        for d in range(r):
            span = (win[d] - 1) * wdil[d] + 1
            x = x.unfold(d, span, strides[d])
            if wdil[d] != 1:
                x = x[..., ::wdil[d]]
        y = red(x, tuple(range(r, 2 * r)))
        return _combine(body, y, init)

    return run


def _select_and_scatter(op: Op):
    """``select_and_scatter`` (the gradient of a max or min pool): each
    window of the padded operand selects its first largest (``GE``) or
    smallest (``LE``) element, and the source value of the window is added
    there onto ``init``. Other bodies are refused, naming them."""
    select = op.regions[0].blocks[0] if len(op.regions[0].blocks) == 1 else None
    sel_ops = [o.name for o in select.ops] if select else ["<several blocks>"]
    direction = None
    if (select is not None and len(select.ops) == 2 and select.ops[0].name == "stablehlo.compare"
            and list(select.ops[0].operands) == select.args and select.ops[1].operands == select.ops[0].results):
        direction = select.ops[0].attrs["comparison_direction"]
    if direction not in ("GE", "LE"):
        raise UnsupportedStableHLOError(f"a stablehlo.select_and_scatter select body of ({', '.join(sel_ops)})")
    scatter = Op(op.name, op.vhlo, op.operands, op.results, op.attrs, [op.regions[1]])
    if region_reducer(scatter) != "stablehlo.add":
        raise UnsupportedStableHLOError("a stablehlo.select_and_scatter scatter body other than add")
    a = op.attrs
    win = _ints(a["window_dimensions"])
    r = len(win)
    strides = _ints(a["window_strides"]) or [1] * r
    pad = np.asarray(a["padding"]).reshape(-1, 2).tolist() if np.size(a["padding"]) else [[0, 0]] * r
    fill = -float("inf") if direction == "GE" else float("inf")

    def run(x, src, init):
        pads = []
        for lo, hi in reversed(pad):
            pads += [int(lo), int(hi)]
        xp = F.pad(x, pads, value=fill) if any(pads) else x
        padded = tuple(xp.shape)
        windows = xp
        for d in range(r):
            windows = windows.unfold(d, win[d], strides[d])
        out_shape = tuple(windows.shape[:r])
        flat = windows.reshape(out_shape + (-1,))
        pick = (flat.argmax(-1) if direction == "GE" else flat.argmin(-1)).to(torch.int64)
        # the picked element's index in the flattened padded operand
        elem_strides = [int(np.prod(padded[d + 1:], dtype=np.int64)) for d in range(r)]
        index = torch.zeros(out_shape, dtype=torch.int64, device=x.device)
        inner = 1
        for d in range(r - 1, -1, -1):
            offset = (pick // inner) % win[d]
            inner *= win[d]
            view = [1] * r
            view[d] = out_shape[d]
            start = (torch.arange(out_shape[d], device=x.device) * strides[d]).reshape(view)
            index = index + (start + offset) * elem_strides[d]
        acc = torch.zeros(int(np.prod(padded)), dtype=src.dtype, device=x.device)
        acc.scatter_add_(0, index.reshape(-1), src.reshape(-1))
        acc = acc.reshape(padded)
        acc = acc[tuple(slice(int(lo), n - int(hi)) for (lo, hi), n in zip(pad, padded))]
        return _combine("stablehlo.add", acc, init)

    return run


def _combine(body: str, y, init):
    """``body(y, init)`` elementwise, where ``body`` is a region's single
    op. A host ``init`` enters as a Python scalar (an identity is
    skipped), so no copy to the device, and no stream sync, is made."""
    if not _is_host(init):
        return _REDUCERS[body][1](y, init.to(y.dtype))
    v = init.item()
    if body == "stablehlo.add":
        return y if v == 0 else y + v
    if body == "stablehlo.multiply":
        return y if v == 1 else y * v
    if body == "stablehlo.maximum":
        return y if v == -np.inf else torch.clamp_min(y, v)
    if body == "stablehlo.minimum":
        return y if v == np.inf else torch.clamp_max(y, v)
    if body == "stablehlo.and":
        return y if v else torch.zeros_like(y)
    return torch.ones_like(y) if v else y  # or


def _to_device(value, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """A host value on ``device``: on the card through pinned memory and a
    copy that does not wait for the stream (a pageable copy would)."""
    t = torch.from_numpy(np.array(value, copy=True))
    if device.type == "cuda":
        return t.pin_memory().to(device, dtype, non_blocking=True)
    return t.to(dtype)


# -- the plan ----------------------------------------------------------------------


class _Compiled:
    """One function's plan over ``n_slots`` slots: ``static`` steps compute
    what does not change while the arguments keep their key (from constants,
    the arguments passed as ``"s"`` or ``"h"``, and the shapes of those
    passed as ``"d"``), ``steps`` the rest. The static values that later
    steps or the results read are kept, keyed by the identity, version and
    storage of each ``"s"``/``"u"`` argument (held weakly), the value of
    each ``"h"`` one and the shape of each ``"d"`` one, and reused while
    the key holds."""

    def __init__(self, func: Func, n_slots: int, arg_slots: List[int], kinds: List[str],
                 static: List[Callable], keep: List[int], steps: List[Callable], out_getters: List[Callable]):
        self.func = func
        self.n_slots = n_slots
        self.arg_slots = arg_slots
        self.kinds = kinds
        self.static = static
        self.keep = keep
        self.steps = steps
        self.out_getters = out_getters
        #: (key, kept values), replaced as one so that threads sharing the
        #: plan never pair one key with another's values
        self._cache: Optional[Tuple[List[Any], List[Any]]] = None

    @staticmethod
    def _version(t: torch.Tensor, kind: str):
        """The tensor's version counter. An inference tensor has none: a
        caller's (``"u"``) may have been written in place, so it never
        matches; the program's own kept values (``"s"``) are never written."""
        if t.is_inference():
            return -1 if kind == "s" else object()
        return t._version

    def _key_of(self, args: Sequence[Any]) -> List[Any]:
        key = []
        for kind, a in zip(self.kinds, args):
            if kind in "su":  # held weakly: a program kept in an LRU must not keep a model's weights
                key.append((weakref.ref(a), self._version(a, kind), a.data_ptr()))
            elif kind == "h":
                key.append((a.dtype.str, a.shape, a.tobytes()))
            else:
                key.append(tuple(a.shape))
        return key

    def _hit(self, args: Sequence[Any], key: List[Any]) -> bool:
        for kind, a, k in zip(self.kinds, args, key):
            if kind in "su":
                if k[0]() is not a or self._version(a, kind) != k[1] or a.data_ptr() != k[2]:
                    return False
            elif kind == "h":
                if a.tobytes() != k[2] or a.shape != k[1] or a.dtype.str != k[0]:
                    return False
            elif tuple(a.shape) != k:
                return False
        return True

    def run(self, args: Sequence[Any]) -> List[Any]:
        env: List[Any] = [None] * self.n_slots
        for s, a in zip(self.arg_slots, args):
            env[s] = a
        cache = self._cache
        if cache is not None and self._hit(args, cache[0]):
            for s, v in zip(self.keep, cache[1]):
                env[s] = v
        else:
            for step in self.static:
                step(env)
            self._cache = (self._key_of(args), [env[s] for s in self.keep])
        for step in self.steps:
            step(env)
        return [g(env) for g in self.out_getters]


class Program:
    """A :class:`~sparkdl_tpu_torch.graph.mlir_bytecode.Module` compiled
    into plans that run on ``device``.

    ``main``'s arguments with a static shape (a keras-3 export's weights)
    are taken as call-invariant while the same tensors come unchanged, and
    the others by their shapes: the values computed from the weights,
    constants and shapes alone (a BatchNorm's scale and shift, the shape
    arithmetic, a broadcast of a bias to the batch) are computed at the
    first call of a batch size and kept; a new tensor, one written in
    place, or another batch size recomputes them."""

    def __init__(self, module: Module, device, entry: str = "main"):
        if entry not in module.funcs:
            raise ValueError(f"StableHLO module has no @{entry} function")
        self.module = module
        self.device = torch.device(device)
        self.entry = entry
        self._kernels = _KernelCache()
        self._plans: Dict[str, _Compiled] = {}
        self._host_consts: Dict[int, torch.Tensor] = {}
        self.constants: List[torch.Tensor] = []  # the device constants, for memory accounting
        self._device_consts: Dict[int, torch.Tensor] = {}
        kinds = ["d" if t.dynamic else "u" for t in module.funcs[entry].type.inputs]
        self._main = self._compile(entry, kinds)
        self.ops_per_call = self._count(entry)

    @property
    def signature(self):
        return self.module.funcs[self.entry].type

    def _count(self, name: str) -> int:
        """Ops one call of ``name`` runs, calls counted through."""
        n = 0
        for op in _ops(self.module.funcs[name].body):
            n += 1
            if op.name == "func.call":
                n += self._count(op.attrs["callee"])
        return n

    def __call__(self, *args) -> List[Any]:
        main = self.module.funcs[self.entry]
        if len(args) != len(main.type.inputs):
            raise ValueError(f"StableHLO @{self.entry} takes {len(main.type.inputs)} arguments, got {len(args)}")
        for i, (a, t) in enumerate(zip(args, main.type.inputs)):
            shape = tuple(a.shape)
            if len(shape) != len(t.shape) or any(d is not None and d != s for d, s in zip(t.shape, shape)):
                raise ValueError(f"StableHLO @{self.entry} argument {i}: shape {shape} against {t}")
            want = TORCH_DTYPES[t.dtype]
            if isinstance(a, torch.Tensor) and a.dtype != want:
                raise ValueError(f"StableHLO @{self.entry} argument {i}: dtype {a.dtype} against {t}")
        args = [a if isinstance(a, torch.Tensor) else _to_device(a, self.device, TORCH_DTYPES[t.dtype])
                for a, t in zip(args, main.type.inputs)]
        with exact_float32():
            outs = self._main.run(args)
        return [o if isinstance(o, torch.Tensor) else _to_device(o, self.device, TORCH_DTYPES[t.dtype])
                for o, t in zip(outs, main.type.results)]

    # -- building

    def _compile(self, name: str, kinds: List[str], site: str = "") -> _Compiled:
        """``kinds`` per argument: ``"h"`` a host value, ``"u"`` a device
        tensor from the caller of the program that is call-invariant while
        unchanged, ``"s"`` one the program computed and keeps, ``"d"`` one
        that varies."""
        key = name + ":" + "".join(kinds) + site
        plan = self._plans.get(key)
        if plan is not None:
            return plan
        func = self.module.funcs.get(name)
        if func is None:
            raise UnsupportedStableHLOError(f"a call of the missing function @{name}")
        block = func.body.blocks[0] if len(func.body.blocks) == 1 else None
        if block is None:
            raise UnsupportedStableHLOError(f"@{name} with {len(func.body.blocks)} blocks")
        slots: Dict[int, int] = {}
        host: Dict[int, bool] = {}
        varies: Dict[int, bool] = {}
        const: Dict[int, Any] = {}

        def slot(v: Value) -> int:
            if id(v) not in slots:
                slots[id(v)] = len(slots)
            return slots[id(v)]

        arg_slots = []
        for v, k in zip(block.args, kinds):
            arg_slots.append(slot(v))
            host[id(v)] = k == "h"
            varies[id(v)] = k == "d"
        # last use of each value, for freeing
        last: Dict[int, int] = {}
        for i, op in enumerate(block.ops):
            for v in op.operands:
                last[id(v)] = i
        # which ops are call-invariant, and the static values that a varying
        # op or the results read (kept between calls)
        fixed_ops = set()
        fixed_vals = {id(v) for v, k in zip(block.args, kinds) if k != "d"}
        arg_ids = {id(v) for v in block.args}
        untrusted = {id(v) for v, k in zip(block.args, kinds) if k == "u"}
        kept_vals = set()
        for i, op in enumerate(block.ops):
            if op.name == "func.return":
                kept_vals.update(id(v) for v in op.operands if id(v) in fixed_vals)
            elif not _varies(op, {id(v): id(v) not in fixed_vals for v in op.operands}, arg_ids):
                fixed_ops.add(i)
                fixed_vals.update(id(v) for v in op.results)
            else:
                kept_vals.update(id(v) for v in op.operands if id(v) in fixed_vals)
        static: List[Callable] = []
        steps: List[Callable] = []
        out_getters: List[Callable] = []
        for i, op in enumerate(block.ops):
            if op.name == "func.return":
                out_getters = [self._getter(v, slots, host, const, want_host=None) for v in op.operands]
                continue
            step = self._step(op, slot, slots, host, const, varies, untrusted)
            for v in op.results:
                varies[id(v)] = i not in fixed_ops
            # a static step frees only what no varying step reads
            dead = list(dict.fromkeys(slots[id(v)] for v in op.operands if last.get(id(v)) == i
                                      and not (i in fixed_ops and id(v) in kept_vals)))
            if dead:
                step = _freeing(step, dead)
            (static if i in fixed_ops else steps).append(step)
        kept = sorted({slots[v] for v in kept_vals - arg_ids if v in slots})  # arguments come with each call
        plan = _Compiled(func, len(slots), arg_slots, kinds, static, kept, steps, out_getters)
        self._plans[key] = plan
        return plan

    def _getter(self, v: Value, slots, host, const, want_host: Optional[bool], varies=None) -> Callable:
        """Reads ``v``'s slot; ``want_host=False`` copies a host value to
        the device: a constant once, a value that does not vary between
        calls once per value it takes, and one that varies at each call."""
        s = slots[id(v)]
        if want_host is False and host.get(id(v)):
            dev = self.device
            dtype = TORCH_DTYPES[v.type.dtype]
            if id(v) in const:
                arr = const[id(v)]
                cache = self._host_consts
                key = id(arr)

                def get_const(env):
                    t = cache.get(key)
                    if t is None:
                        t = cache[key] = _to_device(arr, dev, dtype)
                    return t
                return get_const
            if varies is not None and not varies.get(id(v), True):
                held: List[Any] = [None]  # (the host value, its device copy), replaced as one

                def get_fixed(env):
                    value = env[s]
                    pair = held[0]
                    if pair is None or pair[0] is not value:
                        pair = held[0] = (value, _to_device(value, dev, dtype))
                    return pair[1]
                return get_fixed
            return lambda env: _to_device(env[s], dev, dtype)
        return lambda env: env[s]

    def _step(self, op: Op, slot, slots, host, const, varies, untrusted) -> Callable:
        name = op.name
        ins = op.operands
        all_host = all(host.get(id(v), False) for v in ins)
        outs = op.results
        small = (
            len(outs) == 1
            and not outs[0].type.dynamic
            and outs[0].type.dtype in _HOST_DTYPES
            and int(np.prod(outs[0].type.shape, dtype=np.int64)) <= HOST_ELEMENTS
        )

        def set_host(flag: bool):
            for v in outs:
                host[id(v)] = flag

        def bind(fn, want_host: Optional[bool] = False, getters=None):
            gs = getters or [self._getter(v, slots, host, const, want_host, varies) for v in ins]
            o = [slot(v) for v in outs]
            if len(o) == 1:
                (o0,) = o
                if len(gs) == 1:
                    (g0,) = gs
                    return lambda env: env.__setitem__(o0, fn(g0(env)))
                if len(gs) == 2:
                    g0, g1 = gs
                    return lambda env: env.__setitem__(o0, fn(g0(env), g1(env)))
                return lambda env: env.__setitem__(o0, fn(*[g(env) for g in gs]))

            def multi(env):
                r = fn(*[g(env) for g in gs])
                for s, x in zip(o, r):
                    env[s] = x
            return multi

        if name == "stablehlo.constant":
            value = op.attrs["value"]
            t = outs[0].type
            if t.dtype in _HOST_DTYPES and value.size <= HOST_ELEMENTS:
                arr = np.asarray(value, dtype=_np_dtype(t))
                const[id(outs[0])] = arr
                set_host(True)
                o = slot(outs[0])
                return lambda env: env.__setitem__(o, arr)
            tensor = self._device_consts.get(id(op))
            if tensor is None:  # one copy for every call site's plan
                tensor = torch.as_tensor(np.ascontiguousarray(value)).to(TORCH_DTYPES[t.dtype]).to(self.device)
                self._device_consts[id(op)] = tensor
                self.constants.append(tensor)
            set_host(False)
            o = slot(outs[0])
            return lambda env: env.__setitem__(o, tensor)

        if name == "stablehlo.get_dimension_size":
            d = int(op.attrs["dimension"])
            dt = _np_dtype(outs[0].type)
            set_host(True)
            size = ins[0].type.shape[d]
            if size is not None:  # a static dimension: no need of the operand
                value = np.asarray(size, dt)
                o = slot(outs[0])
                return lambda env: env.__setitem__(o, value)
            return bind(lambda x: np.asarray(x.shape[d], dt), want_host=None)

        if name == "stablehlo.custom_call":
            return self._custom_call(op, bind, set_host)

        if name == "func.call":
            callee = op.attrs["callee"]
            kinds = ["h" if host.get(id(v)) else "d" if varies.get(id(v), True) else "u" if id(v) in untrusted
                     else "s" for v in ins]
            # a plan per call site: each keeps the values of its own site
            plan = self._compile(callee, kinds, site=f"@{id(op)}")
            fn_outs = plan.func.type.results
            set_host(False)  # a host value the callee returns is copied to the device
            gs = [self._getter(v, slots, host, const, None) for v in ins]
            o = [slot(v) for v in outs]
            dev = self.device

            def call(env):
                r = plan.run([g(env) for g in gs])
                for s, x, t in zip(o, r, fn_outs):
                    env[s] = x if isinstance(x, torch.Tensor) else _to_device(x, dev, TORCH_DTYPES[t.dtype])
            return call

        host_fn = self._host_impl(op) if all_host and small else None
        if host_fn is not None:
            set_host(True)
            dt = _np_dtype(outs[0].type)
            return bind(lambda *xs: np.asarray(host_fn(*xs)).astype(dt, copy=False), want_host=None)

        set_host(False)
        fn, want = self._device_impl(op)
        if want is None:
            return bind(fn, want_host=None)
        getters = [self._getter(v, slots, host, const, w, varies) for v, w in zip(ins, want)]
        return bind(fn, getters=getters)

    def _custom_call(self, op: Op, bind, set_host):
        target = op.attrs.get("call_target_name")
        if target == "shape_assertion":
            msg = op.attrs.get("error_message", "shape assertion failed")

            def check(pred, *dims):
                if not _is_host(pred) or any(not _is_host(d) for d in dims):
                    raise UnsupportedStableHLOError("a shape_assertion over values on the device")
                if not bool(np.all(pred)):
                    raise ShapeAssertionError(msg.format(*[int(d) for d in dims]))
                return ()
            return bind(check, want_host=None)
        if target == "mhlo.erf":
            set_host(False)
            return bind(torch.special.erf)
        raise UnsupportedStableHLOError(f"custom_call @{target}")

    # -- op implementations

    def _host_impl(self, op: Op) -> Optional[Callable]:
        kind = op.name.split(".", 1)[1]
        a = op.attrs
        out = op.results[0].type
        if kind in BINARY_NP:
            return BINARY_NP[kind]
        if kind in UNARY_NP:
            return UNARY_NP[kind]
        if kind == "reshape" or kind == "dynamic_reshape":
            shape = tuple(out.shape)
            return lambda x, *s: np.reshape(x, shape)
        if kind == "convert":
            return lambda x: x
        if kind == "concatenate":
            d = int(a["dimension"])
            return lambda *xs: np.concatenate(xs, d)
        if kind == "broadcast_in_dim":
            dims, shape = _ints(a["broadcast_dimensions"]), tuple(out.shape)
            return lambda x: _broadcast_in_dim(x, dims, shape)
        if kind == "dynamic_broadcast_in_dim":
            dims = _ints(a["broadcast_dimensions"])
            return lambda x, s: _broadcast_in_dim(x, dims, _ints(s))
        if kind == "compare":
            f = _COMPARE_NP[a["comparison_direction"]]
            return f
        if kind == "select":
            return np.where
        if kind == "clamp":
            return lambda lo, x, hi: np.minimum(np.maximum(x, lo), hi)
        if kind == "slice":
            st, li, sd = _ints(a["start_indices"]), _ints(a["limit_indices"]), _ints(a["strides"])
            return lambda x: _slice(x, st, li, sd)
        if kind == "transpose":
            perm = _ints(a["permutation"])
            return lambda x: np.transpose(x, perm)
        if kind == "iota":
            d, shape = int(a["iota_dimension"]), tuple(out.shape)
            return lambda: _broadcast_in_dim(np.arange(shape[d]), [d], shape)
        return None

    def _device_impl(self, op: Op) -> Tuple[Callable, Optional[List[Optional[bool]]]]:
        """``(fn, want)``: ``want`` per operand, ``False`` for a device
        tensor, ``None`` for as it is (a shape operand stays on the host)."""
        kind = op.name.split(".", 1)[1]
        a = op.attrs
        n = len(op.operands)
        out = op.results[0].type if op.results else None
        dev = [False] * n
        if kind in UNARY:
            return UNARY[kind], dev
        if kind in BINARY:
            return BINARY[kind], dev
        if kind == "compare":
            f = getattr(torch, _COMPARE[a["comparison_direction"]])
            return f, dev
        if kind == "select":
            return torch.where, dev
        if kind == "clamp":
            return (lambda lo, x, hi: torch.minimum(torch.maximum(x, lo), hi)), dev
        if kind == "convert":
            dt = TORCH_DTYPES[out.dtype]
            return (lambda x: x if x.dtype == dt else x.to(dt)), dev
        if kind == "reshape":
            dims = _reshape_dims(out)
            return (lambda x: x.reshape(dims)), dev
        if kind == "dynamic_reshape":
            return (lambda x, s: x.reshape(_ints(s))), [False, None]
        if kind == "broadcast_in_dim":
            dims = _ints(a["broadcast_dimensions"])
            if out.dynamic:
                raise UnsupportedStableHLOError(f"a broadcast_in_dim to the dynamic {out}")
            shape = tuple(out.shape)
            return (lambda x: _broadcast_in_dim(x, dims, shape)), dev
        if kind == "dynamic_broadcast_in_dim":
            dims = _ints(a["broadcast_dimensions"])
            return (lambda x, s: _broadcast_in_dim(x, dims, _ints(s))), [False, None]
        if kind == "iota":
            d, shape, dt = int(a["iota_dimension"]), tuple(out.shape), TORCH_DTYPES[out.dtype]
            device = self.device
            return (lambda: _broadcast_in_dim(torch.arange(shape[d], device=device, dtype=dt), [d], shape)), dev
        if kind == "dynamic_iota":
            d, dt = int(a["iota_dimension"]), TORCH_DTYPES[out.dtype]
            device = self.device

            def dyn_iota(s):
                shape = _ints(s)
                return _broadcast_in_dim(torch.arange(shape[d], device=device, dtype=dt), [d], shape)
            return dyn_iota, [None]
        if kind == "transpose":
            perm = _ints(a["permutation"])
            return (lambda x: x.permute(*perm)), dev
        if kind == "concatenate":
            d = int(a["dimension"])
            return (lambda *xs: torch.cat(xs, d)), dev
        if kind == "slice":
            st, li, sd = _ints(a["start_indices"]), _ints(a["limit_indices"]), _ints(a["strides"])
            return (lambda x: _slice(x, st, li, sd)), dev
        if kind == "real_dynamic_slice":
            return (lambda x, s, l, t: _slice(x, _ints(s), _ints(l), _ints(t))), [False, None, None, None]
        if kind == "dynamic_slice":
            return _dynamic_slice(op), [False] + [None] * (n - 1)
        if kind == "dynamic_update_slice":
            return _dynamic_update_slice, [False, False] + [None] * (n - 2)
        if kind == "pad":
            lo, hi, it = _ints(a["edge_padding_low"]), _ints(a["edge_padding_high"]), _ints(a["interior_padding"])

            def pad(x, v):
                if not _is_host(v):
                    raise UnsupportedStableHLOError("a pad whose value is computed on the device")
                return _pad(x, v.item(), lo, hi, it)
            return pad, [False, None]
        if kind == "reverse":
            dims = _ints(a["dimensions"])
            return (lambda x: torch.flip(x, dims)), dev
        if kind == "dot_general":
            return _dot_general(op), dev
        if kind == "convolution":
            return _convolution(op, self._kernels), dev
        if kind == "reduce":
            return _reduce(op), [False, None]
        if kind == "reduce_window":
            return _reduce_window(op), [False, None]
        if kind == "select_and_scatter":
            return _select_and_scatter(op), [False, False, None]
        if kind == "gather":
            return _gather(op, dynamic=False), [False, None]
        if kind == "dynamic_gather":
            return _gather(op, dynamic=True), [False, None, None]
        raise UnsupportedStableHLOError(f"op {op.name}")


def _varies(op: Op, varies: Dict[int, bool], args: set) -> bool:
    """Whether ``op``'s results may change while the plan's key holds: they
    do where an operand's value does. The size of a static dimension, or
    of an argument's (whose shape the key holds), does not."""
    if op.name == "stablehlo.get_dimension_size":
        x = op.operands[0]
        if x.type.shape[int(op.attrs["dimension"])] is not None or id(x) in args:
            return False
    return any(varies.get(id(v), True) for v in op.operands)


def _freeing(step: Callable, dead: List[int]) -> Callable:
    if len(dead) == 1:
        (d,) = dead

        def run1(env):
            step(env)
            env[d] = None
        return run1

    def run(env):
        step(env)
        for d in dead:
            env[d] = None
    return run


def _ops(region: Region):
    for block in region.blocks:
        yield from block.ops


__all__ = ["Program", "ShapeAssertionError", "UnsupportedStableHLOError", "region_reducer"]
