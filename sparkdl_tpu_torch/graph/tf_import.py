"""TF GraphDef -> torch: the translator behind TF model ingestion.

Port of the JAX package's ``graph/tf_import.py``. As there, a frozen (or
variable-annotated) GraphDef is translated once, at ingestion, and no
TensorFlow runs after that; unlike there, nothing of TensorFlow runs at
ingestion either: the GraphDef comes decoded by the port's own wire-format
reader (``graph/tf_proto.py``), and constants become arrays through its
``make_ndarray``.

:func:`translate_graph_def` returns ``(module, fn)``: a
:class:`TranslatedGraph` ``nn.Module`` that holds the lifted weights as
buffers, and ``fn(module, x)``, which walks the graph's nodes in an order
fixed at translation time and runs each op as torch ops on the module's
device. Design, beside the JAX package's:

- **Weights.** Float constants of at least ``_PARAM_SIZE_THRESHOLD``
  elements, and every variable value, are lifted into the module. TF node
  names may hold ``.``, which buffer names may not, so the buffers are
  named ``w0, w1, ...`` and :meth:`TranslatedGraph.tf_state_dict` gives
  them by TF node name; :func:`load_translated_params` loads a dict keyed
  by TF node name (the JAX package's ``params``). A weight that feeds a
  ``Conv2D`` (NHWC) or ``DepthwiseConv2dNative`` filter is stored with its
  TF shape over the memory order that cuDNN's ``channels_last``
  convolution reads, so no conv copies its weight.
- **Host values.** Smaller constants and every integer constant stay host
  numpy, and an op whose inputs are all host values runs on the host
  (through torch on the CPU), so shape-feeding chains (``Shape ->
  StridedSlice -> Pack -> Reshape``) stay concrete, as the JAX package
  keeps them concrete under ``jit``. A value derived from the graph input
  lives on the device; an op that needs it on the host (a shape, an axis)
  raises at the first batch rather than read it back on every batch. A
  host constant that meets a device tensor is copied to that device once
  and the copy kept beside it.
- **Liveness.** Each value is dropped from the walk's environment right
  after its last consumer runs (``_Translator._free_after``, computed at
  translation time), so an eager walk holds what XLA's buffer liveness
  would, not every activation of the graph.
- **Layout.** An NHWC ``Conv2D`` runs as a ``permute`` view into NCHW,
  which on the card is ``channels_last`` memory: no copy per conv. TF's
  ``SAME`` padding pads the extra row and column at the bottom and right;
  a symmetric pad goes to the conv itself, an uneven one through
  ``F.pad``. ``AvgPool`` divides by the count of cells inside the image.
- **Control flow.** ``If``/``While`` evaluate their predicate on the
  host: a predicate on the device is read back once per branch or loop
  iteration (a host sync each time), where the JAX package compiles
  ``lax.cond``/``lax.while_loop``.
- **Precision.** Every walk runs under ``runtime/device.exact_float32``:
  float32 stays float32 on the card. A ``DT_BFLOAT16`` constant or
  variable stays bfloat16, as TF's ``MakeNdarray`` keeps it in the JAX
  package: ``make_ndarray`` widens its values to float32 exactly (numpy
  has no bfloat16 here), and the translator narrows them back, a lifted
  weight into a bf16 buffer and a host value through a ``bf16`` mark that
  :func:`_from_host` reads.
- ``XlaCallModule`` (a keras-3 or jax2tf SavedModel holds its whole
  model as one) runs its StableHLO module through the port's own reader
  and interpreter (``graph/mlir_bytecode.py``, ``graph/stablehlo.py``),
  where the JAX package builds a ``jax.export.Exported`` around it. Its
  checks are the JAX package's: a ``main`` whose argument count is not the
  node's input count (a multi-platform or token calling convention), or
  an output shape that cannot be inferred, is refused, naming ROADMAP
  Queue A item 13. Compiled programs are kept in an LRU of 16 keyed by the
  module's digest, the argument shapes and dtypes (and the device).
"""

from __future__ import annotations

import functools
import hashlib
import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sparkdl_tpu_torch.graph.tf_proto import DT_BFLOAT16, base_dtype, make_ndarray, np_dtype
from sparkdl_tpu_torch.runtime.device import exact_float32

#: ops translated nowhere, with why; each stays listed as refused
REFUSED: Dict[str, str] = {}


class UnsupportedTFOpError(NotImplementedError):
    """Raised at ingestion time when a GraphDef contains untranslatable ops."""

    def __init__(self, ops: Sequence[str]):
        self.ops = sorted(set(ops))
        refused = [REFUSED[op] for op in self.ops if op in REFUSED]
        super().__init__(
            "GraphDef contains TF ops with no torch translation: "
            f"{', '.join(self.ops)}. "
            + "".join(f"{why}. " for why in refused)
            + "Register a custom translation with "
            "sparkdl_tpu_torch.graph.tf_import.register_tf_op(op, handler) — "
            "handler(node, args) returns the op's output(s) as torch tensors "
            "(or host numpy arrays). "
            f"Supported ops: {', '.join(sorted(_OP_TABLE))}."
            + (f" Refused: {', '.join(sorted(REFUSED))}" if REFUSED else "")
        )


# Float consts with at least this many elements are lifted into the module
# (weights); smaller ones and all integer consts stay host numpy.
_PARAM_SIZE_THRESHOLD = 16

# Control-flow / call ops evaluated by the translator itself (they need
# the function library): op -> the node attrs naming their FunctionDefs.
_CONTROL_FLOW_OPS = {
    "PartitionedCall": ("f",),
    "StatefulPartitionedCall": ("f",),
    "If": ("then_branch", "else_branch"),
    "StatelessIf": ("then_branch", "else_branch"),
    "While": ("cond", "body"),
    "StatelessWhile": ("cond", "body"),
}

# Ops that forward their single input unchanged (inference-time no-ops).
# IdentityN is handled separately: it forwards ALL inputs to N outputs.
_PASSTHROUGH = {
    "Identity",
    "StopGradient",
    "PreventGradient",
    "CheckNumerics",
    "EnsureShape",
    "Snapshot",
}

# Ops with more than one NAMED output list, in declaration order: a
# FunctionDef-body ref 'node:out_name:k' addresses flat index
# offset(out_name) + k. Every other op this translator emits has a single
# output list, where the flat index is k itself.
_NAMED_OUTPUTS = {
    "FusedBatchNorm": (
        "y", "batch_mean", "batch_variance",
        "reserve_space_1", "reserve_space_2",
    ),
    "FusedBatchNormV2": (
        "y", "batch_mean", "batch_variance",
        "reserve_space_1", "reserve_space_2",
    ),
    "FusedBatchNormV3": (
        "y", "batch_mean", "batch_variance",
        "reserve_space_1", "reserve_space_2", "reserve_space_3",
    ),
    "TopKV2": ("values", "indices"),
}

_BUILTIN_NODE_OPS = ("Const", "Placeholder", "PlaceholderWithDefault", "NoOp", "VariableV2",
                     "VarHandleOp", "ReadVariableOp", "IdentityN")

#: TF ``DataType`` -> torch dtype
TORCH_DTYPES = {
    1: torch.float32, 2: torch.float64, 3: torch.int32, 4: torch.uint8, 5: torch.int16,
    6: torch.int8, 8: torch.complex64, 9: torch.int64, 10: torch.bool, 14: torch.bfloat16,
    17: torch.uint16, 18: torch.complex128, 19: torch.float16, 22: torch.uint32, 23: torch.uint64,
}


def _norm_name(ref: str) -> Tuple[str, int]:
    """'node:2' -> ('node', 2); 'node' -> ('node', 0).

    FunctionDef bodies use the 3-part form 'node:out_name:k'; this
    context-free parser treats k as the flat index, which is correct for
    single-output-list ops. Multi-named-output ops (_NAMED_OUTPUTS) need
    the node's op to compute the offset — translator-side resolution
    (``_Translator._resolve_ref``) handles those. TF node names cannot
    contain ':'."""
    parts = ref.split(":")
    if len(parts) == 1:
        return ref, 0
    if parts[-1].isdigit():
        return parts[0], int(parts[-1])
    return parts[0], 0


# -- host values and device tensors -------------------------------------------


class _HostConst(np.ndarray):
    """A constant's host value, which keeps its copy on each device it has
    met, so a constant is copied to the card once, not once per batch.
    ``bf16``: the value is a bfloat16 one, held widened to float32."""

    def __array_finalize__(self, obj):
        self._copies: Dict[torch.device, torch.Tensor] = {}
        self.bf16: bool = getattr(obj, "bf16", False)


def _host_const(a: np.ndarray, bf16: bool = False) -> np.ndarray:
    if np.asarray(a).dtype == object:
        return a
    out = np.asarray(a).view(_HostConst)
    out.bf16 = bf16
    return out


def _static(v, what: str) -> np.ndarray:
    """Require a host value (numpy): a shape, an axis, a size."""
    if isinstance(v, torch.Tensor):
        raise ValueError(
            f"{what} must be known on the host at translation time, but it "
            "is data-dependent (derived from a graph input, so it lives on "
            "the device, and reading it would wait for the device on every "
            "batch); re-export the model with concrete shapes."
        )
    return np.asarray(v)


def _tensor(v, device: torch.device) -> torch.Tensor:
    """``v`` as a tensor on ``device``: a host value is copied there (a
    constant's copy is kept, see :class:`_HostConst`)."""
    if isinstance(v, torch.Tensor):
        return v if v.device == device else v.to(device)
    copies = getattr(v, "_copies", None)
    if copies is not None and device in copies:
        return copies[device]
    t = _from_host(v)
    if device.type != "cpu":
        t = t.to(device)
    if copies is not None:
        copies[device] = t
    return t


def _from_host(v) -> torch.Tensor:
    """A host value as a CPU tensor, 0-d kept 0-d (sharing its memory
    where it can); a ``bf16`` host value comes back in bfloat16."""
    a = np.asarray(v)
    if not (a.flags.c_contiguous and a.flags.writeable):
        a = np.array(a)
    t = torch.from_numpy(a)
    return t.to(torch.bfloat16) if getattr(v, "bf16", False) else t


def _device_of(args) -> Optional[torch.device]:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return None


def _host(out):
    if isinstance(out, (list, tuple)):
        return [_host(o) for o in out]
    if isinstance(out, torch.Tensor) and out.dtype == torch.bfloat16:
        return _host_const(out.float().numpy(), bf16=True)
    return out.numpy() if isinstance(out, torch.Tensor) else out


def _apply(fn: Callable, args) -> Any:
    """``fn`` over ``args`` as tensors: on the device of the first tensor
    among them (host values copied there), or, when every input is a host
    value, on the CPU with the result handed back as host numpy."""
    device = _device_of(args)
    if device is None:
        return _host(fn(*[_from_host(a) for a in args]))
    return fn(*[_tensor(a, device) for a in args])


def torch_dtype_of(dtype) -> Optional[torch.dtype]:
    """A numpy dtype (or anything ``np.dtype`` takes) as torch's; None and
    torch dtypes pass through."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


def _cast_to(value, like):
    """``value`` in the dtype (and host or device) of ``like``."""
    if isinstance(like, torch.Tensor):
        return _tensor(value, like.device).to(like.dtype)
    if isinstance(value, torch.Tensor):
        return value.to(torch_dtype_of(np.asarray(like).dtype))
    return np.asarray(value).astype(np.asarray(like).dtype)


def _truth(pred) -> bool:
    """A predicate on the host: a device predicate is read back (one host
    sync)."""
    if isinstance(pred, torch.Tensor):
        return bool(pred.reshape(()).item())
    return bool(np.asarray(pred).reshape(()))


def _attr_torch_dtype(attr) -> torch.dtype:
    dt = attr.type - 100 if attr.type > 100 else attr.type
    try:
        return TORCH_DTYPES[dt]
    except KeyError:
        raise UnsupportedTFOpError([f"dtype enum {dt}"]) from None


# -- the translated module --------------------------------------------------


class TranslatedGraph(nn.Module):
    """The lifted weights of a translated GraphDef, as buffers ``w0, w1,
    ...`` (TF node names may hold ``.``). ``layouts`` names the weights
    stored for a convolution's filter: ``"conv"`` (``[H, W, I, O]`` over
    ``O, H, W, I`` memory, cuDNN's ``channels_last`` weight) or
    ``"depthwise"`` (``[H, W, C, M]`` over ``C, M, H, W`` memory).
    ``bf16``: the weights stored in bfloat16 (TF's ``DT_BFLOAT16``)."""

    def __init__(self, params: Dict[str, np.ndarray], layouts: Optional[Dict[str, str]] = None,
                 bf16: Sequence[str] = ()):
        super().__init__()
        layouts = layouts or {}
        self.tf_names: List[str] = list(params)
        self.bf16_names = frozenset(bf16)
        self.attr_of: Dict[str, str] = {}
        for i, (name, value) in enumerate(params.items()):
            attr = f"w{i}"
            self.attr_of[name] = attr
            stored = _stored(np.asarray(value), layouts.get(name))
            self.register_buffer(attr, stored.to(torch.bfloat16) if name in bf16 else stored)
        # tracks the module's device for a graph with no weights
        self.register_buffer("anchor", torch.empty(0), persistent=False)

    @property
    def device(self) -> torch.device:
        return self.anchor.device

    def tf_state_dict(self) -> Dict[str, torch.Tensor]:
        """The lifted weights by TF node name."""
        return {name: self._buffers[self.attr_of[name]] for name in self.tf_names}


def _stored(value: np.ndarray, layout: Optional[str]) -> torch.Tensor:
    if value.dtype == object:
        raise UnsupportedTFOpError(["string-valued weight"])
    if layout == "conv" and value.ndim == 4:
        return torch.from_numpy(np.ascontiguousarray(value.transpose(3, 0, 1, 2))).permute(1, 2, 3, 0)
    if layout == "depthwise" and value.ndim == 4:
        return torch.from_numpy(np.ascontiguousarray(value.transpose(2, 3, 0, 1))).permute(2, 3, 0, 1)
    return torch.from_numpy(np.ascontiguousarray(value))


def load_translated_params(module: TranslatedGraph, params: Dict[str, Any]) -> None:
    """Load weights keyed by TF node name (the JAX package's translated
    ``params``, numpy arrays or tensors) into ``module``'s buffers, in
    place; every lifted weight must be given, with its shape, but a
    bfloat16 constant, which the JAX translator keeps in its graph rather
    than in its params (numpy's float kind does not cover bfloat16)."""
    missing = set(module.tf_names) - set(params) - module.bf16_names
    extra = set(params) - set(module.tf_names)
    if missing or extra:
        raise KeyError(f"params do not match the graph's weights: missing {sorted(missing)[:4]}, "
                       f"unknown {sorted(extra)[:4]}")
    with torch.no_grad():
        for name in module.tf_names:
            if name not in params:
                continue
            dest = module._buffers[module.attr_of[name]]
            src = torch.as_tensor(np.asarray(params[name]))
            if tuple(src.shape) != tuple(dest.shape):
                raise ValueError(f"{name}: shape {tuple(src.shape)}, the graph's weight is {tuple(dest.shape)}")
            dest.copy_(src)


# -- the translator -----------------------------------------------------------


class _Translator:
    """Single-use: translate one GraphDef into (module weights, fn)."""

    def __init__(
        self,
        graph_def,
        input_names: Sequence[str],
        output_names: Sequence[str],
        variables: Optional[Dict[str, np.ndarray]] = None,
        functions: Optional[Dict[str, Any]] = None,
        lift_params: bool = True,
        fn_cache: Optional[Dict[str, Callable]] = None,
    ):
        self.nodes = {n.name: n for n in graph_def.node}
        self.inputs = [_norm_name(n)[0] for n in input_names]
        self.outputs = [self._resolve_ref(n) for n in output_names]
        self.variables = dict(variables or {})
        # FunctionDef library: control flow (If/While) and
        # PartitionedCall bodies live here, shared with sub-translators
        self.functions: Dict[str, Any] = dict(functions or {})
        library = getattr(graph_def, "library", None)
        if library is not None:
            for f in library.function:
                self.functions[f.signature.name] = f
        # fname -> callable, SHARED down the call DAG so a helper function
        # referenced from many bodies translates once per graph
        self._fn_cache: Dict[str, Callable] = fn_cache if fn_cache is not None else {}
        # function bodies receive weights as call ARGUMENTS (captures),
        # so sub-translators keep their consts embedded
        self.lift_params = lift_params
        self.params: Dict[str, np.ndarray] = {}
        self.layouts: Dict[str, str] = {}
        #: lifted weights whose TF dtype is bfloat16
        self.bf16: set = set()
        self._const_cache: Dict[str, np.ndarray] = {}
        # evaluation order fixed at translation time (iterative — no
        # recursion-depth ceiling on deep graphs like ResNet152 chains)
        self._topo = self._topo_order()
        if lift_params:
            self._collect_params()
        self._validate_ops()
        self._plan, self._free_after = self._make_plan()

    @classmethod
    def from_function_def(cls, fd, functions, fn_cache=None) -> "_Translator":
        """Translator over one FunctionDef body (control-flow branch /
        loop body / PartitionedCall target)."""

        class _Body:  # duck-typed GraphDef: only .node is consumed
            node = list(fd.node_def)

        inputs = [a.name for a in fd.signature.input_arg]
        outputs = [fd.ret[a.name] for a in fd.signature.output_arg]
        return cls(_Body, inputs, outputs, functions=functions, lift_params=False, fn_cache=fn_cache)

    def _resolve_ref(self, ref: str) -> Tuple[str, int]:
        """Tensor ref -> (node, flat output index), including the
        FunctionDef 3-part 'node:out_name:k' form for multi-named-output
        ops (FusedBatchNorm family) where the flat index is
        offset(out_name) + k."""
        parts = ref.split(":")
        if len(parts) == 3:
            node_name, out_name, k = parts[0], parts[1], int(parts[2])
            node = self.nodes.get(node_name)
            if node is not None and node.op in _NAMED_OUTPUTS:
                names = _NAMED_OUTPUTS[node.op]
                if out_name not in names:
                    raise UnsupportedTFOpError([f"{node.op}:{out_name}"])
                return node_name, names.index(out_name) + k
            return node_name, k
        return _norm_name(ref)

    def _function_callable(self, fname: str) -> Callable:
        """args-list -> outputs-list callable for a library function
        (built once, recursively validated at construction)."""
        if fname not in self._fn_cache:
            fd = self.functions.get(fname)
            if fd is None:
                raise UnsupportedTFOpError([f"function:{fname}"])
            inner = _Translator.from_function_def(fd, self.functions, fn_cache=self._fn_cache)
            self._fn_cache[fname] = lambda args, _inner=inner: _inner.run(list(args), {})
        return self._fn_cache[fname]

    # -- ingestion-time scans ---------------------------------------------------

    def _const_value(self, node) -> np.ndarray:
        if node.name not in self._const_cache:
            tensor = node.attr["value"].tensor
            self._const_cache[node.name] = _host_const(make_ndarray(tensor), bf16=tensor.dtype == DT_BFLOAT16)
        return self._const_cache[node.name]

    def _deps(self, name: str):
        node = self.nodes.get(name)
        if node is None:
            raise KeyError(f"GraphDef has no node named {name!r}")
        return [_norm_name(ref)[0] for ref in node.input if not ref.startswith("^")]

    def _reachable(self):
        """Nodes reachable from the requested outputs, STOPPING at declared
        inputs: feeding an internal tensor means everything upstream of it
        never executes, so it is neither validated nor collected."""
        seen: set = set()
        stack = [n for n, _ in self.outputs]
        while stack:
            name = stack.pop()
            if name in seen:
                continue
            seen.add(name)
            if name in self.inputs:
                continue  # fed tensor: upstream subgraph is dead
            stack.extend(self._deps(name))
        return seen

    def _topo_order(self):
        """Dependencies-first order of reachable, non-input nodes
        (iterative post-order DFS)."""
        order: List[str] = []
        done: set = set()
        inputs = set(self.inputs)
        stack: List[Tuple[str, bool]] = [(n, False) for n, _ in reversed(self.outputs)]
        on_path: set = set()
        while stack:
            name, expanded = stack.pop()
            if expanded:
                on_path.discard(name)
                if name not in done:
                    done.add(name)
                    order.append(name)
                continue
            if name in done or name in inputs:
                continue
            if name in on_path:
                raise ValueError(f"GraphDef contains a data-dependency cycle at {name!r}")
            on_path.add(name)
            stack.append((name, True))
            for dep in self._deps(name):
                if dep not in done and dep not in inputs:
                    stack.append((dep, False))
        return order

    def _collect_params(self):
        reachable = self._reachable()
        for name in reachable:
            if name in self.inputs:
                continue  # fed tensor: the node's own value is unused
            node = self.nodes[name]
            if node.op == "Const":
                val = self._const_value(node)
                if val.size >= _PARAM_SIZE_THRESHOLD and val.dtype.kind == "f":
                    self.params[name] = np.asarray(val)
                    if val.bf16:
                        self.bf16.add(name)
                    # lifted weights are read from the module at eval time;
                    # drop the cache copy so big models aren't held twice
                    del self._const_cache[name]
            elif node.op in ("VariableV2", "VarHandleOp"):
                if name not in self.variables:
                    raise ValueError(
                        f"Graph references variable {name!r} but no value "
                        "was provided (pass `variables=` or freeze the graph first)"
                    )
                self.params[name] = np.asarray(self.variables[name])
                if base_dtype(node.attr["dtype"].type) == DT_BFLOAT16:
                    self.bf16.add(name)
        # a weight read as a convolution's filter is stored in the memory
        # order cuDNN's channels_last convolution reads it in
        for name in reachable:
            node = self.nodes.get(name)
            if name in self.inputs or node is None or len(node.input) < 2:
                continue
            fmt = node.attr["data_format"].s.decode() or "NHWC"
            if node.op == "Conv2D" and fmt == "NHWC":
                layout = "conv"
            elif node.op == "DepthwiseConv2dNative":
                layout = "depthwise"
            else:
                continue
            src = _norm_name(node.input[1])[0]
            while src in self.nodes and self.nodes[src].op in _PASSTHROUGH | {"ReadVariableOp"}:
                src = _norm_name(self.nodes[src].input[0])[0]
            if src in self.params:
                self.layouts[src] = layout

    def _validate_ops(self):
        # function-body args are bare names with no node — skip inputs
        # BEFORE indexing self.nodes
        bad = [
            self.nodes[n].op
            for n in self._reachable()
            if n not in self.inputs
            and self.nodes[n].op not in _OP_TABLE
            and self.nodes[n].op not in _PASSTHROUGH
            and self.nodes[n].op not in _CONTROL_FLOW_OPS
            and self.nodes[n].op not in _BUILTIN_NODE_OPS
        ]
        if bad:
            raise UnsupportedTFOpError(bad)
        # force-build every referenced function NOW: a branch body with an
        # untranslatable op must fail at ingestion, not at the first batch
        for n in self._reachable():
            if n in self.inputs:
                continue
            node = self.nodes[n]
            if node.op in _CONTROL_FLOW_OPS:
                for attr in _CONTROL_FLOW_OPS[node.op]:
                    self._function_callable(node.attr[attr].func.name)

    def _make_plan(self):
        """Each node with its resolved data inputs, and the values that
        can be dropped after each step: a value dies after its last
        consumer, the requested outputs never."""
        plan = []
        last_use: Dict[str, int] = {}
        for i, name in enumerate(self._topo):
            node = self.nodes[name]
            refs = [self._resolve_ref(ref) for ref in node.input if not ref.startswith("^")]
            plan.append((name, node, refs))
            for src, _ in refs:
                last_use[src] = i
        keep = {n for n, _ in self.outputs}
        free_after: List[List[str]] = [[] for _ in plan]
        for src, i in last_use.items():
            if src not in keep:
                free_after[i].append(src)
        return plan, free_after

    # -- evaluation ---------------------------------------------------------

    def run(self, feeds: List[Any], buffers) -> List[Any]:
        """The graph's outputs for ``feeds`` (declared input order), with
        lifted weights read from ``buffers`` (TF name -> tensor)."""
        if len(feeds) != len(self.inputs):
            raise ValueError(f"graph expects {len(self.inputs)} inputs ({self.inputs}), got {len(feeds)}")
        env: Dict[str, List[Any]] = {name: [val] for name, val in zip(self.inputs, feeds)}

        def out_of(name: str, idx: int = 0):
            vals = env[name]
            if idx >= len(vals):
                raise KeyError(f"Node {name!r} has {len(vals)} output(s); output index {idx} requested")
            return vals[idx]

        for step, (name, node, refs) in enumerate(self._plan):
            if name not in env:
                env[name] = self._eval(name, node, [out_of(n, i) for n, i in refs], buffers, out_of)
            for dead in self._free_after[step]:
                env.pop(dead, None)
        return [out_of(n, i) for n, i in self.outputs]

    def _eval(self, name: str, node, args, buffers, out_of) -> List[Any]:
        op = node.op
        if op == "Const":
            if name in self.params:
                return [buffers[name]]
            return [self._const_value(node)]
        if op in ("VariableV2", "VarHandleOp"):
            return [buffers[name]]
        if op in ("Placeholder", "PlaceholderWithDefault"):
            if op == "PlaceholderWithDefault" and node.input:
                return [args[0]]
            raise KeyError(f"Placeholder {name!r} is not among declared inputs {self.inputs}")
        if op in _PASSTHROUGH:
            return [args[0]]
        if op == "IdentityN":
            return list(args)
        if op == "ReadVariableOp":
            return [args[0]]  # the VarHandleOp already resolved to the value
        if op in ("PartitionedCall", "StatefulPartitionedCall"):
            return self._function_callable(node.attr["f"].func.name)(args)
        if op in ("If", "StatelessIf"):
            branch = "then_branch" if _truth(args[0]) else "else_branch"
            return self._function_callable(node.attr[branch].func.name)(list(args[1:]))
        if op in ("While", "StatelessWhile"):
            return self._eval_while(node, args)
        result = _OP_TABLE[op](node, args)
        return result if isinstance(result, list) else [result]

    def _eval_while(self, node, args) -> List[Any]:
        """The loop on the host: ``cond`` is read back once per iteration
        when it lives on the device; each body output keeps its loop
        variable's dtype."""
        cond_fn = self._function_callable(node.attr["cond"].func.name)
        body_fn = self._function_callable(node.attr["body"].func.name)
        values = list(args)
        while _truth(cond_fn(values)[0]):
            values = [_cast_to(o, v) for o, v in zip(body_fn(values), values)]
        return values


# ---------------------------------------------------------------------------
# Op translations. Each entry: fn(node, args) -> value | [values], where a
# value is a torch tensor or a host numpy array. Implemented for inference
# graphs, as in the JAX package.
# ---------------------------------------------------------------------------


def _binop(tfn):
    return lambda node, args: _apply(tfn, args[:2])


def _unop(tfn):
    return lambda node, args: _apply(tfn, args[:1])


def _matmul(node, args):
    def mm(a, b):
        if node.attr["transpose_a"].b:
            a = a.transpose(-1, -2)
        if node.attr["transpose_b"].b:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)

    return _apply(mm, args)


def _batch_matmul(node, args):
    def mm(a, b):
        if node.attr["adj_x"].b:
            a = a.transpose(-1, -2)
        if node.attr["adj_y"].b:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)

    return _apply(mm, args)


def _bias_add(node, args):
    fmt = node.attr["data_format"].s.decode() or "NHWC"

    def add(x, b):
        if fmt == "NCHW":
            return x + b.reshape((1, -1) + (1,) * (x.dim() - 2))
        return x + b

    return _apply(add, args)


def _same_pads(size: int, k: int, stride: int, dilation: int = 1) -> Tuple[int, int]:
    """TF's SAME padding of one axis: the odd cell goes after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + (k - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


def _conv_padding(node, fmt="NHWC"):
    """'SAME' | 'VALID' | [(top, bottom), (left, right)]."""
    pad = node.attr["padding"].s.decode()
    if pad == "EXPLICIT":
        ep = list(node.attr["explicit_paddings"].list.i)
        # 8 values in data_format order; pull the H and W pairs
        h0 = 2 if fmt == "NHWC" else 4
        return [(ep[h0], ep[h0 + 1]), (ep[h0 + 2], ep[h0 + 3])]
    return pad


def _conv_hw_attrs(node):
    """(strides_hw, dilations_hw, fmt) — attr lists come in data_format
    order, so the H/W positions depend on it."""
    fmt = node.attr["data_format"].s.decode() or "NHWC"
    if fmt not in ("NHWC", "NCHW"):
        raise UnsupportedTFOpError([f"{node.op}({fmt})"])
    hw = slice(1, 3) if fmt == "NHWC" else slice(2, 4)
    strides = list(node.attr["strides"].list.i)[hw]
    dil = (list(node.attr["dilations"].list.i) or [1, 1, 1, 1])[hw]
    return strides, dil, fmt


def _spatial_pads(pad, in_hw, k_hw, strides, dil) -> List[Tuple[int, int]]:
    if pad == "VALID":
        return [(0, 0), (0, 0)]
    if pad == "SAME":
        return [_same_pads(in_hw[i], k_hw[i], strides[i], dil[i]) for i in range(2)]
    if isinstance(pad, list):
        return [tuple(p) for p in pad]
    raise UnsupportedTFOpError([f"padding {pad!r}"])


def _nchw_conv(x, weight, node, groups: int):
    """x NCHW, weight OIHW: TF's padding, strides and dilations."""
    strides, dil, fmt = _conv_hw_attrs(node)
    pads = _spatial_pads(_conv_padding(node, fmt), x.shape[2:], weight.shape[2:], strides, dil)
    if all(lo == hi for lo, hi in pads):
        padding = (pads[0][0], pads[1][0])
    else:
        x = F.pad(x, (pads[1][0], pads[1][1], pads[0][0], pads[0][1]))
        padding = (0, 0)
    return F.conv2d(x, weight, stride=tuple(strides), padding=padding, dilation=tuple(dil), groups=groups)


def _conv2d(node, args):
    fmt = _conv_hw_attrs(node)[2]

    def conv(x, k):
        weight = k.permute(3, 2, 0, 1)  # HWIO -> OIHW, a view
        if fmt == "NCHW":
            return _nchw_conv(x, weight, node, groups=x.shape[1] // weight.shape[1])
        # NHWC runs as an NCHW view (channels_last memory) and comes back
        # as an NHWC view: no copy either way
        y = _nchw_conv(x.permute(0, 3, 1, 2), weight, node, groups=x.shape[3] // weight.shape[1])
        return y.permute(0, 2, 3, 1)

    return _apply(conv, args)


def _depthwise_conv(node, args):
    fmt = _conv_hw_attrs(node)[2]

    def conv(x, k):
        h, w, c, m = k.shape
        weight = k.permute(2, 3, 0, 1).reshape(c * m, 1, h, w)  # [C·M, 1, H, W]
        if fmt == "NCHW":
            return _nchw_conv(x, weight, node, groups=c)
        return _nchw_conv(x.permute(0, 3, 1, 2), weight, node, groups=c).permute(0, 2, 3, 1)

    return _apply(conv, args)


def _fused_batch_norm(node, args):
    if node.attr["is_training"].b:
        raise UnsupportedTFOpError(["FusedBatchNorm(is_training=True)"])
    # attr presence, not truthiness (explicit 0.0 is valid); TF op default
    # is 1e-4.
    eps = node.attr["epsilon"].f if "epsilon" in node.attr else 1e-4
    fmt = node.attr["data_format"].s.decode() or "NHWC"
    if fmt not in ("NHWC", "NCHW"):
        raise UnsupportedTFOpError([f"{node.op}({fmt})"])

    def bn(x, scale, offset, mean, var):
        inv = scale * (1.0 / torch.sqrt(var + eps))
        shift = offset - mean * inv
        if fmt == "NCHW":
            bshape = (1, -1) + (1,) * (x.dim() - 2)
            inv, shift = inv.reshape(bshape), shift.reshape(bshape)
        y = x * inv + shift
        # TF emits 5-6 outputs; only y is meaningful at inference.
        return [y, mean, var, mean, var, var]

    return _apply(bn, args)


def _pool(node, args, kind: str):
    """MaxPool / AvgPool over the spatial axes (ksize and strides come in
    data_format order); TF's AvgPool divides by the cells inside the
    image."""
    fmt = node.attr["data_format"].s.decode() or "NHWC"
    if fmt not in ("NHWC", "NCHW"):
        raise UnsupportedTFOpError([f"{node.op}({fmt})"])
    ksize = list(node.attr["ksize"].list.i)
    strides = list(node.attr["strides"].list.i)
    hw = [1, 2] if fmt == "NHWC" else [2, 3]
    other = [0, 3] if fmt == "NHWC" else [0, 1]
    if any(ksize[i] != 1 or strides[i] != 1 for i in other):
        raise UnsupportedTFOpError([f"{node.op}(pooling over the batch or channel axis)"])
    k = (ksize[hw[0]], ksize[hw[1]])
    s = (strides[hw[0]], strides[hw[1]])
    pad = node.attr["padding"].s.decode()

    def pool(x):
        xc = x.permute(0, 3, 1, 2) if fmt == "NHWC" else x
        pads = _spatial_pads(pad, xc.shape[2:], k, s, (1, 1))
        symmetric = all(lo == hi and lo <= kk // 2 for (lo, hi), kk in zip(pads, k))
        padding = (pads[0][0], pads[1][0]) if symmetric else (0, 0)
        if kind == "max":
            if not symmetric:
                xc = F.pad(xc, (pads[1][0], pads[1][1], pads[0][0], pads[0][1]), value=float("-inf"))
            y = F.max_pool2d(xc, k, s, padding=padding)
        elif symmetric:
            y = F.avg_pool2d(xc, k, s, padding=padding, count_include_pad=False)
        else:
            flat = (pads[1][0], pads[1][1], pads[0][0], pads[0][1])
            total = F.avg_pool2d(F.pad(xc, flat), k, s, divisor_override=1)
            ones = torch.ones((1, 1) + tuple(xc.shape[2:]), dtype=xc.dtype, device=xc.device)
            y = total / F.avg_pool2d(F.pad(ones, flat), k, s, divisor_override=1)
        return y.permute(0, 2, 3, 1) if fmt == "NHWC" else y

    return _apply(pool, args[:1])


def _maxpool(node, args):
    return _pool(node, args, "max")


def _avgpool(node, args):
    return _pool(node, args, "avg")


def _axes(v, what: str) -> Tuple[int, ...]:
    return tuple(int(a) for a in np.atleast_1d(_static(v, what)).tolist())


def _reduce_each(tfn):
    """A reduction that takes one axis at a time, over several."""

    def run(x, axes, keepdims):
        for ax in sorted((a % x.dim() for a in axes), reverse=True):
            x = tfn(x, dim=ax, keepdim=keepdims)
        return x

    return run


def _reduction(tfn, one_axis: bool = False):
    reduce = _reduce_each(tfn) if one_axis else (lambda x, axes, keepdims: tfn(x, dim=axes, keepdim=keepdims))

    def run(node, args):
        axes = _axes(args[1], f"{node.op} axes")
        keep = node.attr["keep_dims"].b
        if not axes:
            return args[0]
        return _apply(lambda x: reduce(x, axes, keep), args[:1])

    return run


def _reshape(node, args):
    shape = tuple(int(d) for d in _static(args[1], "Reshape shape").tolist())
    if isinstance(args[0], torch.Tensor):
        return args[0].reshape(shape)
    return np.reshape(args[0], shape)


def _squeeze(node, args):
    dims = tuple(node.attr["squeeze_dims"].list.i)
    x = args[0]
    if isinstance(x, torch.Tensor):
        return x.squeeze(dims) if dims else x.squeeze()
    return np.squeeze(x, axis=dims or None)


def _expand_dims(node, args):
    axis = int(_static(args[1], "ExpandDims dim").reshape(-1)[0])
    if isinstance(args[0], torch.Tensor):
        return args[0].unsqueeze(axis)
    return np.expand_dims(args[0], axis)


def _transpose(node, args):
    perm = tuple(int(p) for p in _static(args[1], "Transpose perm").tolist())
    if isinstance(args[0], torch.Tensor):
        return args[0].permute(perm)
    return np.transpose(args[0], perm)


def _concat_v2(node, args):
    axis = int(_static(args[-1], "ConcatV2 axis"))
    return _apply(lambda *xs: torch.cat(xs, dim=axis), list(args[:-1]))


def _pack(node, args):
    axis = node.attr["axis"].i
    return _apply(lambda *xs: torch.stack(xs, dim=axis), list(args))


def _unpack(node, args):
    axis = node.attr["axis"].i
    return _apply(lambda x: list(torch.unbind(x, dim=axis)), args[:1])


def _mirror(x: torch.Tensor, pads, symmetric: bool) -> torch.Tensor:
    """numpy's ``reflect`` / ``symmetric`` padding, one axis at a time."""
    for axis, (lo, hi) in enumerate(pads):
        if not lo and not hi:
            continue
        n = x.shape[axis]
        inner = np.arange(n)
        if symmetric:
            before, after = inner[:lo][::-1], inner[n - hi:][::-1]
        else:
            before, after = inner[1:lo + 1][::-1], inner[n - 1 - hi:n - 1][::-1]
        index = torch.from_numpy(np.concatenate([before, inner, after])).to(x.device)
        x = x.index_select(axis, index)
    return x


def _pad(node, args):
    pads = [tuple(int(v) for v in r) for r in _static(args[1], "Pad paddings").tolist()]
    flat = [v for lo_hi in reversed(pads) for v in lo_hi]
    if node.op == "MirrorPad":
        mode = node.attr["mode"].s.decode().lower()
        return _apply(lambda x: _mirror(x, pads, symmetric=mode != "reflect"), args[:1])
    value = float(_static(args[2], "Pad value")) if node.op == "PadV2" else 0.0
    return _apply(lambda x: F.pad(x, flat, value=value), args[:1])


def _shape(node, args):
    return np.asarray(args[0].shape, dtype=np.int32)


def _index(x, idx):
    """``x[idx]`` with numpy's semantics; torch indexing takes no negative
    step, so such an index is applied to the flat positions on the host
    and gathered."""
    if isinstance(x, np.ndarray) or not any(isinstance(i, slice) and (i.step or 1) < 0 for i in idx):
        return x[idx]
    flat = np.arange(x.numel()).reshape(tuple(x.shape))[idx]
    return x.reshape(-1)[torch.from_numpy(np.ascontiguousarray(flat)).to(x.device)]


def _strided_slice(node, args):
    x, begin, end, strides = args
    begin = _static(begin, "StridedSlice begin").tolist()
    end = _static(end, "StridedSlice end").tolist()
    strides = _static(strides, "StridedSlice strides").tolist()
    bm = node.attr["begin_mask"].i
    em = node.attr["end_mask"].i
    ellipsis = node.attr["ellipsis_mask"].i
    new_axis = node.attr["new_axis_mask"].i
    shrink = node.attr["shrink_axis_mask"].i
    idx: List[Any] = []
    for i in range(len(begin)):
        if ellipsis & (1 << i):
            idx.append(Ellipsis)
        elif new_axis & (1 << i):
            idx.append(None)
        elif shrink & (1 << i):
            idx.append(begin[i])
        else:
            b = None if bm & (1 << i) else begin[i]
            e = None if em & (1 << i) else end[i]
            idx.append(slice(b, e, strides[i]))
    return _index(x, tuple(idx))


def _slice(node, args):
    x, begin, size = args
    begin = _static(begin, "Slice begin").tolist()
    size = _static(size, "Slice size").tolist()
    size = [(x.shape[i] - begin[i]) if s == -1 else s for i, s in enumerate(size)]
    return x[tuple(slice(b, b + s) for b, s in zip(begin, size))]


def _split(node, args):
    axis = int(_static(args[0], "Split axis"))
    n = node.attr["num_split"].i

    def split(x):
        if x.shape[axis] % n:
            raise ValueError(f"Split of an axis of {x.shape[axis]} into {n} equal parts")
        return list(torch.split(x, x.shape[axis] // n, dim=axis))

    return _apply(split, args[1:2])


def _cast(node, args):
    x = args[0]
    if not isinstance(x, torch.Tensor):
        if getattr(x, "bf16", False) or base_dtype(node.attr["DstT"].type) == DT_BFLOAT16:
            return _apply(lambda t: t.to(_attr_torch_dtype(node.attr["DstT"])), [x])
        return np.asarray(x).astype(np_dtype(node.attr["DstT"].type))
    return x.to(_attr_torch_dtype(node.attr["DstT"]))


def _gather_v2(node, args):
    axis = int(_static(args[2], "GatherV2 axis")) if len(args) > 2 else 0

    def take(x, indices):
        ax = axis % x.dim()
        flat = x.index_select(ax, indices.reshape(-1).long())
        return flat.reshape(tuple(x.shape[:ax]) + tuple(indices.shape) + tuple(x.shape[ax + 1:]))

    return _apply(take, args[:2])


def _arg_red(tfn):
    def run(node, args):
        axis = int(_static(args[1], f"{node.op} axis"))
        dst = _attr_torch_dtype(node.attr["output_type"]) if node.attr["output_type"].type else torch.int64
        return _apply(lambda x: tfn(x, dim=axis).to(dst), args[:1])

    return run


def _softmax(node, args):
    return _apply(lambda x: torch.softmax(x, dim=-1), args[:1])


def _leaky_relu(node, args):
    # attr presence, not truthiness: an explicit alpha=0.0 is valid.
    alpha = node.attr["alpha"].f if "alpha" in node.attr else 0.2
    return _apply(lambda x: F.leaky_relu(x, negative_slope=alpha), args[:1])


def _fill(node, args):
    dims = tuple(int(d) for d in _static(args[0], "Fill dims").tolist())
    return _apply(lambda v: v.reshape(()).expand(dims).contiguous(), args[1:2])


def _tile(node, args):
    multiples = tuple(int(m) for m in _static(args[1], "Tile multiples").tolist())
    return _apply(lambda x: x.repeat(multiples), args[:1])


def _range(node, args):
    start, limit, delta = (_static(a, "Range arg") for a in args)
    return np.arange(start, limit, delta)


def _select(node, args):
    return _apply(torch.where, args[:3])


def _add_n(node, args):
    def add(*xs):
        out = xs[0]
        for a in xs[1:]:
            out = out + a
        return out

    return _apply(add, list(args))


def _clip(node, args):
    return _apply(lambda x, lo, hi: torch.minimum(torch.maximum(x, lo), hi), args[:3])


@functools.lru_cache(maxsize=64)
def _interp_matrix(in_size: int, out_size: int, align_corners: bool, half_pixel: bool, nearest: bool) -> np.ndarray:
    """Static (out, in) interpolation matrix for ONE spatial axis,
    matching TF's three resize index conventions bit-for-bit (the kernels
    in tensorflow/core/kernels/image/resize_*): ``align_corners``
    (scale=(in-1)/(out-1), src=i*scale), ``half_pixel_centers``
    (src=(i+0.5)*in/out-0.5), legacy (src=i*in/out). Cached (the result is
    never written), so its device copy is made once."""
    w = np.zeros((out_size, in_size), dtype=np.float32)
    for i in range(out_size):
        if align_corners:
            scale = (in_size - 1) / (out_size - 1) if out_size > 1 else 0.0
            src = i * scale
        else:
            scale = in_size / out_size
            src = (i + 0.5) * scale - 0.5 if half_pixel else i * scale
        if nearest:
            # TF's roundf rounds half AWAY from zero; src >= 0 here, so
            # floor(x+0.5) == roundf
            if align_corners or half_pixel:
                idx = int(np.floor(src + 0.5))
            else:
                idx = int(np.floor(src))
            w[i, min(max(idx, 0), in_size - 1)] = 1.0
            continue
        src = min(max(src, 0.0), in_size - 1)
        lo = int(np.floor(src))
        hi = min(lo + 1, in_size - 1)
        frac = src - lo
        w[i, lo] += 1.0 - frac
        w[i, hi] += frac
    return _host_const(w)


@functools.lru_cache(maxsize=64)
def _nearest_index(in_size: int, out_size: int, align_corners: bool, half_pixel: bool) -> np.ndarray:
    return _host_const(_interp_matrix(in_size, out_size, align_corners, half_pixel, True).argmax(axis=1))


def _resize(nearest: bool):
    def run(node, args):
        out_h, out_w = (int(v) for v in _static(args[1], f"{node.op} size").reshape(-1))
        ac = node.attr["align_corners"].b
        hp = node.attr["half_pixel_centers"].b

        def resize(x):
            in_h, in_w = int(x.shape[1]), int(x.shape[2])
            if nearest:
                # one-hot rows -> index gathers, dtype-preserving (TF's
                # ResizeNearestNeighbor keeps the input dtype)
                rows = _tensor(_nearest_index(in_h, out_h, ac, hp), x.device)
                cols = _tensor(_nearest_index(in_w, out_w, ac, hp), x.device)
                return x.index_select(1, rows).index_select(2, cols)
            wh = _tensor(_interp_matrix(in_h, out_h, ac, hp, False), x.device)
            ww = _tensor(_interp_matrix(in_w, out_w, ac, hp, False), x.device)
            # TF's ResizeBilinear always emits float32 regardless of input
            y = torch.einsum("oh,bhwc->bowc", wh, x.to(torch.float32))
            return torch.einsum("pw,bowc->bopc", ww, y)

        return _apply(resize, args[:1])

    return run


def _einsum(node, args):
    equation = node.attr["equation"].s.decode()
    return _apply(lambda *xs: torch.einsum(equation, *xs), list(args))


def _gather_nd(node, args):
    return _apply(lambda params, indices: params[tuple(indices.long().unbind(-1))], args[:2])


def _top_k(node, args):
    k = int(_static(args[1], "TopKV2 k"))

    def top(x):
        values, indices = torch.topk(x, k, dim=-1, largest=True, sorted=True)
        return [values, indices.to(torch.int32)]

    return _apply(top, args[:1])


def _cumop(tfn, identity):
    def run(node, args):
        ax = int(_static(args[1], f"{node.op} axis"))
        reverse, exclusive = node.attr["reverse"].b, node.attr["exclusive"].b

        def scan(x):
            if reverse:
                x = x.flip(ax)
            y = tfn(x, dim=ax)
            if exclusive:
                lead = list(x.shape)
                lead[ax % x.dim()] = 1
                y = torch.cat([torch.full(lead, identity, dtype=y.dtype, device=y.device),
                               y.narrow(ax, 0, y.shape[ax] - 1)], dim=ax)
            if reverse:
                y = y.flip(ax)
            return y

        return _apply(scan, args[:1])

    return run


def _space_to_batch_nd(node, args):
    """TF frames dilated convolutions as SpaceToBatchND ∘ Conv ∘
    BatchToSpaceND in pre-fused exports: pad, reshape and permute."""
    block = [int(b) for b in _static(args[1], "SpaceToBatchND block_shape").tolist()]
    pads = [tuple(int(v) for v in r) for r in _static(args[2], "SpaceToBatchND paddings").tolist()]

    def s2b(x):
        m = len(block)
        full = [(0, 0)] + pads + [(0, 0)] * (x.dim() - 1 - m)
        x = F.pad(x, [v for lo_hi in reversed(full) for v in lo_hi])
        b = x.shape[0]
        spatial = x.shape[1:1 + m]
        rest = tuple(x.shape[1 + m:])
        # split each spatial dim into (outer, block), hoist blocks to batch
        split = []
        for s, bs in zip(spatial, block):
            split += [s // bs, bs]
        x = x.reshape((b, *split, *rest))
        block_axes = [2 + 2 * i for i in range(m)]
        outer_axes = [1 + 2 * i for i in range(m)]
        rest_axes = list(range(1 + 2 * m, x.dim()))
        x = x.permute((*block_axes, 0, *outer_axes, *rest_axes))
        out_spatial = [s // bs for s, bs in zip(spatial, block)]
        return x.reshape((b * int(np.prod(block)), *out_spatial, *rest))

    return _apply(s2b, args[:1])


def _batch_to_space_nd(node, args):
    block = [int(b) for b in _static(args[1], "BatchToSpaceND block_shape").tolist()]
    crops = [tuple(int(v) for v in r) for r in _static(args[2], "BatchToSpaceND crops").tolist()]

    def b2s(x):
        m = len(block)
        b = x.shape[0] // int(np.prod(block))
        spatial = tuple(x.shape[1:1 + m])
        rest = tuple(x.shape[1 + m:])
        x = x.reshape((*block, b, *spatial, *rest))
        # interleave each block factor back into its spatial dim
        perm = [m]
        for i in range(m):
            perm += [m + 1 + i, i]
        perm += list(range(1 + 2 * m, x.dim()))
        x = x.permute(perm)
        full = [s * bs for s, bs in zip(spatial, block)]
        x = x.reshape((b, *full, *rest))
        slices = [slice(None)] + [slice(lo, size - hi) for (lo, hi), size in zip(crops, full)]
        return x[tuple(slices + [slice(None)] * len(rest))]

    return _apply(b2s, args[:1])


def _depth_space(to_depth: bool):
    """DepthToSpace (pixel-shuffle upsampling) / SpaceToDepth, NHWC in
    TF's DCR order: reshape and permute."""

    def run(node, args):
        bs = int(node.attr["block_size"].i)
        fmt = node.attr["data_format"].s.decode() or "NHWC"
        if fmt != "NHWC":
            raise UnsupportedTFOpError([f"{node.op}({fmt})"])

        def move(x):
            b, h, w, c = x.shape
            if to_depth:
                x = x.reshape(b, h // bs, bs, w // bs, bs, c).permute(0, 1, 3, 2, 4, 5)
                return x.reshape(b, h // bs, w // bs, c * bs * bs)
            x = x.reshape(b, h, w, bs, bs, c // (bs * bs)).permute(0, 1, 3, 2, 4, 5)
            return x.reshape(b, h * bs, w * bs, c // (bs * bs))

        return _apply(move, args[:1])

    return run


def _floor_div(a, b):
    if a.is_floating_point() or b.is_floating_point():
        return torch.floor(a / b)
    return torch.div(a, b, rounding_mode="floor")


def _xla_call_module(node, args):
    """Run an embedded StableHLO module (keras-3 / jax2tf SavedModel
    exports serialize the whole model as ONE ``XlaCallModule`` op) on the
    port's interpreter. The program is compiled once per (module digest,
    argument shapes, dtypes, device) and kept in an LRU of 16, as the JAX
    package keeps its ``jax.export.Exported``; the module's own shape
    assertions reject ragged uses."""
    module_bytes = node.attr["module"].s
    device = _device_of(args) or torch.device("cpu")
    key = (
        _digest(module_bytes),
        tuple(tuple(np.shape(a)) for a in args),
        tuple(str(a.dtype) for a in args),
        str(device),
    )
    with _XCM_LOCK:
        program = _XCM_CACHE.get(key)
        if program is None:
            # the plan does not depend on the shapes: a program of the same
            # module on the same device serves a new batch size
            program = next((p for k, p in _XCM_CACHE.items() if k[0] == key[0] and k[3] == key[3]), None)
            if program is None:
                program = _build_xcm_program(node, len(args), device)
            _XCM_CACHE[key] = program
            while len(_XCM_CACHE) > _XCM_CACHE_MAX:
                _XCM_CACHE.pop(next(iter(_XCM_CACHE)))
        else:
            _XCM_CACHE.move_to_end(key)
    return list(program(*[_tensor(a, device) for a in args]))


_XCM_CACHE: "OrderedDict[Any, Any]" = OrderedDict()
_XCM_CACHE_MAX = 16
_XCM_LOCK = threading.Lock()


@functools.lru_cache(maxsize=_XCM_CACHE_MAX)
def _digest(module_bytes: bytes) -> str:
    return hashlib.sha256(module_bytes).hexdigest()


def _build_xcm_program(node, n_args: int, device: torch.device):
    from sparkdl_tpu_torch.graph.mlir_bytecode import read_module
    from sparkdl_tpu_torch.graph.stablehlo import Program

    module = read_module(node.attr["module"].s)
    main = module.funcs.get("main")
    if main is None:
        raise ValueError("XlaCallModule artifact has no @main function")
    if len(main.type.inputs) != n_args:
        raise UnsupportedTFOpError([
            "XlaCallModule(multi-platform or token calling convention: "
            f"main takes {len(main.type.inputs)} args, graph provides {n_args}; ROADMAP Queue A item 13)"
        ])
    uses_poly = any(t.dynamic for t in main.type.inputs)
    for s in node.attr["Sout"].list.shape:
        if s.unknown_rank or (any(d.size == -1 for d in s.dim) and not uses_poly):
            raise UnsupportedTFOpError([
                f"XlaCallModule(output shape not inferable: Sout={[d.size for d in s.dim]} with a static input "
                "signature; ROADMAP Queue A item 13)"
            ])
    return Program(module, device)


def _make_table() -> Dict[str, Callable]:
    t: Dict[str, Callable] = {
        # linear algebra
        "MatMul": _matmul,
        "BatchMatMul": _batch_matmul,
        "BatchMatMulV2": _batch_matmul,
        "BatchMatMulV3": _batch_matmul,
        "BiasAdd": _bias_add,
        "Conv2D": _conv2d,
        "DepthwiseConv2dNative": _depthwise_conv,
        "FusedBatchNorm": _fused_batch_norm,
        "FusedBatchNormV2": _fused_batch_norm,
        "FusedBatchNormV3": _fused_batch_norm,
        "MaxPool": _maxpool,
        "AvgPool": _avgpool,
        # binary elementwise
        "Add": _binop(torch.add),
        "AddV2": _binop(torch.add),
        "Sub": _binop(torch.sub),
        "Mul": _binop(torch.mul),
        "RealDiv": _binop(torch.true_divide),
        "Div": _binop(torch.true_divide),
        "FloorDiv": _binop(_floor_div),
        "FloorMod": _binop(torch.remainder),
        "Maximum": _binop(torch.maximum),
        "Minimum": _binop(torch.minimum),
        "Pow": _binop(torch.pow),
        "SquaredDifference": _binop(lambda a, b: torch.square(a - b)),
        "Greater": _binop(torch.gt),
        "GreaterEqual": _binop(torch.ge),
        "Less": _binop(torch.lt),
        "LessEqual": _binop(torch.le),
        "Equal": _binop(torch.eq),
        "NotEqual": _binop(torch.ne),
        "LogicalAnd": _binop(torch.logical_and),
        "LogicalOr": _binop(torch.logical_or),
        "AddN": _add_n,
        # unary elementwise
        "Relu": _unop(torch.relu),
        "Relu6": _unop(lambda x: torch.clamp(x, 0, 6)),
        "Elu": _unop(F.elu),
        "Selu": _unop(F.selu),
        "Sigmoid": _unop(torch.sigmoid),
        "Tanh": _unop(torch.tanh),
        "Softplus": _unop(lambda x: torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))),
        "Exp": _unop(torch.exp),
        "Log": _unop(torch.log),
        "Log1p": _unop(torch.log1p),
        "Sqrt": _unop(torch.sqrt),
        "Rsqrt": _unop(lambda x: 1.0 / torch.sqrt(x)),
        "Square": _unop(torch.square),
        "Neg": _unop(torch.neg),
        "Abs": _unop(torch.abs),
        "Floor": _unop(torch.floor),
        "Ceil": _unop(torch.ceil),
        "Round": _unop(torch.round),
        "Erf": _unop(torch.erf),
        "LogicalNot": _unop(torch.logical_not),
        "LeakyRelu": _leaky_relu,
        "Softmax": _softmax,
        "LogSoftmax": lambda node, args: _apply(lambda x: torch.log_softmax(x, dim=-1), args[:1]),
        "ClipByValue": _clip,
        # reductions
        "Mean": _reduction(torch.mean),
        "Sum": _reduction(torch.sum),
        "Max": _reduction(torch.amax),
        "Min": _reduction(torch.amin),
        "Prod": _reduction(torch.prod, one_axis=True),
        "All": _reduction(torch.all, one_axis=True),
        "Any": _reduction(torch.any, one_axis=True),
        "ArgMax": _arg_red(torch.argmax),
        "ArgMin": _arg_red(torch.argmin),
        # shape / layout
        "Reshape": _reshape,
        "Squeeze": _squeeze,
        "ExpandDims": _expand_dims,
        "Transpose": _transpose,
        "ConcatV2": _concat_v2,
        "Concat": lambda node, args: _concat_v2(node, list(args[1:]) + [args[0]]),
        "Pack": _pack,
        "Unpack": _unpack,
        "Pad": _pad,
        "PadV2": _pad,
        "MirrorPad": _pad,
        "Shape": _shape,
        "Size": lambda node, args: np.asarray(int(np.prod(args[0].shape)), np.int32),
        "Rank": lambda node, args: np.asarray(len(args[0].shape), np.int32),
        "StridedSlice": _strided_slice,
        "Slice": _slice,
        "Split": _split,
        "Cast": _cast,
        "GatherV2": _gather_v2,
        "Fill": _fill,
        "Tile": _tile,
        "Range": _range,
        "Select": _select,
        "SelectV2": _select,
        "ZerosLike": _unop(torch.zeros_like),
        "OnesLike": _unop(torch.ones_like),
        "Reciprocal": _unop(lambda x: 1.0 / x),
        "Inv": _unop(lambda x: 1.0 / x),
        # image resize (static output geometry -> dense interp matrices)
        "ResizeBilinear": _resize(nearest=False),
        "ResizeNearestNeighbor": _resize(nearest=True),
        # block/space layout ops (dilated-conv framing, pixel shuffle)
        "SpaceToBatchND": _space_to_batch_nd,
        "BatchToSpaceND": _batch_to_space_nd,
        "DepthToSpace": _depth_space(to_depth=False),
        "SpaceToDepth": _depth_space(to_depth=True),
        # trig/misc unary (signal models, positional encodings)
        "Sin": _unop(torch.sin),
        "Cos": _unop(torch.cos),
        "Tan": _unop(torch.tan),
        "Atan": _unop(torch.atan),
        "Atan2": _binop(torch.atan2),
        "Sign": _unop(torch.sign),
        "Softsign": _unop(lambda x: x / (1.0 + torch.abs(x))),
        "Expm1": _unop(torch.expm1),
        "IsFinite": _unop(torch.isfinite),
        "IsNan": _unop(torch.isnan),
        # contraction / gather / scan
        "Einsum": _einsum,
        "GatherNd": _gather_nd,
        "TopKV2": _top_k,
        "Cumsum": _cumop(torch.cumsum, identity=0),
        "Cumprod": _cumop(torch.cumprod, identity=1),
        # embedded StableHLO (keras-3 / jax2tf exports)
        "XlaCallModule": _xla_call_module,
    }
    return t


_OP_TABLE = _make_table()


def register_tf_op(op_name: str, handler: Callable) -> None:
    """Escape hatch: translate a TF op the built-in table doesn't cover.

    ``handler(node, args)`` receives the ``NodeDef`` (attrs available as
    ``node.attr[...]``) and the op's input values (torch tensors, or host
    numpy for statically evaluated subgraphs) and returns the output value
    — or a list of values for multi-output ops. The registration is
    process-global and applies to subsequent ingestions; it may override a
    built-in translation."""
    if not callable(handler):
        raise TypeError(f"handler for {op_name!r} must be callable")
    _OP_TABLE[op_name] = handler


def unregister_tf_op(op_name: str) -> None:
    """Remove a custom registration (restores the built-in, if any)."""
    _OP_TABLE.pop(op_name, None)
    builtin = _make_table()
    if op_name in builtin:
        _OP_TABLE[op_name] = builtin[op_name]


def translate_graph_def(
    graph_def,
    input_names: Sequence[str],
    output_names: Sequence[str],
    variables: Optional[Dict[str, np.ndarray]] = None,
) -> Tuple[TranslatedGraph, Callable]:
    """Translate a (frozen or variable-annotated) GraphDef: a decoded
    ``tf_proto`` GraphDef message.

    Returns ``(module, fn)``: the :class:`TranslatedGraph` holding the
    lifted weights (on the CPU; move it with ``.to(device)``) and
    ``fn(module, x)``, where ``x`` is one input or a tuple/list in
    declared input order (tensors, or numpy arrays that are copied to the
    module's device). ``fn`` returns one tensor, or a tuple in declared
    output order."""
    tr = _Translator(graph_def, input_names, output_names, variables)
    module = TranslatedGraph(tr.params, tr.layouts, tr.bf16)
    names = list(tr.params)

    def fn(mod: TranslatedGraph, x):
        device = mod.device
        feeds = [_tensor(v, device) for v in (x if isinstance(x, (tuple, list)) else [x])]
        buffers = {name: mod._buffers[mod.attr_of[name]] for name in names}
        with exact_float32():
            results = tr.run(feeds, buffers)
        results = [_tensor(r, device) for r in results]
        return results[0] if len(results) == 1 else tuple(results)

    return module, fn


__all__ = [
    "REFUSED", "TORCH_DTYPES", "TranslatedGraph", "UnsupportedTFOpError", "load_translated_params",
    "register_tf_op", "torch_dtype_of", "translate_graph_def", "unregister_tf_op",
]
