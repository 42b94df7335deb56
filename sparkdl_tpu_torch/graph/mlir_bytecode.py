"""A reader of MLIR bytecode for StableHLO portable artifacts: numpy and
the standard library only.

A keras-3 or jax2tf SavedModel carries its model as the ``module``
attribute of one ``XlaCallModule`` node, and the JAX package's
``program.stablehlo`` wraps the same kind of bytes (see
``graph/jax_exported.py``). Those bytes are a *portable artifact*: MLIR
bytecode whose ops and attributes are in StableHLO's versioned dialect,
VHLO (``vhlo.add_v1``, ``#vhlo.tensor_v1<...>``). The JAX package hands
them to ``jax.export``; the port reads them here and runs them with
``graph/stablehlo.py``.

:func:`read_module` returns a plain :class:`Module`: its functions, each a
:class:`Region` of :class:`Block`\\ s of :class:`Op`\\ s whose operands and
results are :class:`Value`\\ s with a :class:`TensorType`, attributes as
Python and numpy values, and nested regions (a ``reduce`` body). VHLO op
names are upgraded to the StableHLO op they denote: ``vhlo.add_v1`` is
``stablehlo.add``, ``vhlo.func_v1`` is ``func.func``, ``vhlo.call_v1`` is
``func.call`` and ``vhlo.return_v1`` is ``func.return`` in a function and
``stablehlo.return`` in an op's region, as jaxlib's
``deserialize_portable_artifact`` prints them.

**The container** (MLIR's ``BytecodeReader``): the magic ``ML\\xefR``, the
bytecode version (a varint; version 6 is read, any other is refused),
the producer string (``StableHLO_v1.13.4``: the VHLO version, read for
1.0.0 to 1.13.7), then sections, each an id byte (the high bit flags an
alignment varint and ``0xCB`` padding), a length and the data:

- 0 strings: a count, the sizes (with their NUL) in reverse order, then
  the strings packed at the section's end;
- 1 dialects: a count of dialect names (a string index with a
  has-version flag; a version is a nested section 7), the count of op
  names, then per dialect a group of op names (a string index with a
  was-registered flag);
- 2 and 3 attributes and types: section 3 holds the attribute count, the
  type count and per dialect a group of entry sizes (a size with a
  has-custom-encoding flag); section 2 holds the entries back to back,
  attributes first. Entries are decoded when an op first refers to them;
  an entry without a custom encoding (assembly text) is refused;
- 4 IR: the top-level block; an op whose regions are isolated from
  above (a function) carries them in a nested section 4;
- 5 and 6 resources and their offsets: refused where an attribute refers
  to one (``dense_resource``); JAX does not write them;
- 8 properties: a count, then each op's inherent attributes as a
  size-prefixed blob of attribute indices, in the sorted order of the
  op's attribute names (:data:`VHLO_OPS`).

Integers are prefix varints (the count of trailing zero bits of the
first byte is the count of bytes that follow; ``0x00`` is followed by 8
bytes); a signed varint is zigzag-coded. A flagged varint keeps its flag
in bit 0.

**An op**: its name index, a mask byte (``0x01`` attribute dictionary,
``0x02`` results, ``0x04`` operands, ``0x08`` successors, ``0x10``
regions, ``0x20`` use-list orders, ``0x40`` properties), its location,
then each present part: the dictionary's attribute index, the
properties' index, the result types, the operand value indices (values
are numbered per isolated region: block arguments and results in the
order they are defined, nested regions after), and the region count
with an isolated-from-above flag. A region is its block count, its value
count, then the blocks: ``(op count << 1) | has-arguments``, the
arguments (a type index with a has-location flag), and a use-list byte.
Use-list orders (a module written from text keeps them) are read past: a
count of values where the range holds more than one, then per value its
index, ``(count << 1) | pair-encoding`` and the indices.

**Builtin encodings** read here (the first varint of an entry): types 0
``IntegerType`` (``width << 2 | signedness``), 1 ``IndexType``;
attributes 0 ``ArrayAttr``, 1 ``DictionaryAttr``, 2 ``StringAttr``, 4
``FlatSymbolRefAttr``, 6 ``TypeAttr``, 7 ``UnitAttr``, 8 ``IntegerAttr``
(a value of width <= 8 is one byte, <= 64 a signed varint), 10--15 and
22 locations (never decoded).

**VHLO's encodings**, found from bytes by having jaxlib serialize small
hand-written modules one type or attribute at a time (``tests/
test_torch_stablehlo.py`` holds every parse against jaxlib's own text of
the same bytes):

- types: 0 ``bool_v1`` (i1), 1 ``complex_v1``, 2 ``bf16_v1``, 3
  ``f16_v1``, 4 ``f32_v1``, 5 ``f64_v1``, 6 ``f8E4M3FN_v1``, 7
  ``f8E5M2_v1``, 8 ``func_v1`` (inputs, results), 9 ``index_v1``, 10
  ``i4_v1``, 11 ``i8_v1``, 12 ``i16_v1``, 13 ``i32_v1``, 14 ``i64_v1``, 15
  ``ui4_v1``, 16 ``ui8_v1``, 17 ``ui16_v1``, 18 ``ui32_v1``, 19
  ``ui64_v1``, 20 ``tensor_v1`` (a dim count, signed dims with
  ``INT64_MIN`` for ``?``, the element type), 33 ``none_v1``;
- attributes: 1 ``array_v1``, 2 ``bool_v1``, 3 ``comparison_direction_v1``
  (EQ NE GE GT LE LT), 4 ``comparison_type_v1`` (NOTYPE FLOAT TOTALORDER
  SIGNED UNSIGNED), 5 ``api_version_v1`` (UNSPECIFIED ORIGINAL
  STATUS_RETURNING STATUS_RETURNING_UNIFIED TYPED_FFI), 6 ``dict_v1``, 9
  ``integer_v1`` (type, value), 11 ``precision_v1`` (DEFAULT HIGH
  HIGHEST), 14 ``string_v1``, 15 ``tensor_v1`` (type, then the raw data
  as a size-prefixed blob: little-endian, row-major, one element for a
  splat; ``i1`` is packed eight to a byte from the low bit, and a single
  ``0x00``/``0xff`` byte is a splat), 17 ``type_v1``, 19
  ``result_accuracy_mode_v1`` (DEFAULT HIGHEST TOLERANCE), 20
  ``result_accuracy_v1`` (atol, rtol, ulps, mode).

Anything else (another bytecode or VHLO version, an unknown code, an op
outside :data:`VHLO_OPS`) raises :class:`UnsupportedBytecodeError`, a
``NotImplementedError`` that names it and ROADMAP item 13; nothing is
guessed.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

MAGIC = b"ML\xefR"
#: the bytecode versions read (jaxlib 0.9 writes 6 for every VHLO target)
BYTECODE_VERSIONS = (6,)
#: the VHLO versions read, inclusive; both ends are tested
VHLO_VERSION_RANGE = ((1, 0, 0), (1, 13, 7))
ITEM = "ROADMAP Queue A item 13"


class UnsupportedBytecodeError(NotImplementedError):
    """Raised for bytecode this reader does not read, naming what."""

    def __init__(self, what: str):
        super().__init__(f"StableHLO bytecode: {what} is not supported ({ITEM})")


# section ids
_STRINGS, _DIALECTS, _ATTR_TYPE, _ATTR_TYPE_OFFSETS, _IR, _RESOURCE, _RESOURCE_OFFSETS, \
    _DIALECT_VERSIONS, _PROPERTIES = range(9)
_DYNAMIC = -(1 << 63)

#: every VHLO op read, with its inherent attributes in sorted order (the
#: order of a properties blob)
VHLO_OPS: Dict[str, Tuple[str, ...]] = {
    "abs_v1": (), "add_v1": (), "and_v1": (), "atan2_v1": (), "cbrt_v2": ("result_accuracy",),
    "ceil_v1": (), "clamp_v1": (), "convert_v1": (), "cosine_v2": ("result_accuracy",),
    "divide_v1": (), "dynamic_reshape_v1": (), "exponential_v2": ("result_accuracy",),
    "exponential_minus_one_v2": ("result_accuracy",), "floor_v1": (), "is_finite_v1": (),
    "log_v2": ("result_accuracy",), "log_plus_one_v2": ("result_accuracy",),
    "logistic_v2": ("result_accuracy",), "maximum_v1": (), "minimum_v1": (), "multiply_v1": (),
    "negate_v1": (), "not_v1": (), "or_v1": (), "power_v1": (), "remainder_v1": (),
    "reshape_v1": (), "return_v1": (), "round_nearest_even_v1": (), "round_nearest_afz_v1": (),
    "rsqrt_v2": ("result_accuracy",), "select_v1": (), "shift_left_v1": (),
    "shift_right_arithmetic_v1": (), "shift_right_logical_v1": (), "sign_v1": (),
    "sine_v2": ("result_accuracy",), "sqrt_v2": ("result_accuracy",), "subtract_v1": (),
    "tan_v2": ("result_accuracy",), "tanh_v2": ("result_accuracy",), "xor_v1": (),
    # the forms before result_accuracy (VHLO 1.9), dot_general's algorithm
    # and gather's batching dims
    "cbrt_v1": (), "cosine_v1": (), "exponential_v1": (), "exponential_minus_one_v1": (), "log_v1": (),
    "log_plus_one_v1": (), "logistic_v1": (), "rsqrt_v1": (), "sine_v1": (), "sqrt_v1": (), "tan_v1": (),
    "tanh_v1": (),
    "dot_general_v1": ("lhs_batching_dimensions", "lhs_contracting_dimensions", "precision_config",
                       "rhs_batching_dimensions", "rhs_contracting_dimensions"),
    "gather_v1": ("collapsed_slice_dims", "index_vector_dim", "indices_are_sorted", "offset_dims", "slice_sizes",
                  "start_index_map"),
    "dynamic_gather_v1": ("collapsed_slice_dims", "index_vector_dim", "indices_are_sorted", "offset_dims",
                          "start_index_map"),
    "broadcast_in_dim_v1": ("broadcast_dimensions",),
    "call_v1": ("callee",),
    "compare_v1": ("compare_type", "comparison_direction"),
    "concatenate_v1": ("dimension",),
    "constant_v1": ("value",),
    "convolution_v1": (
        "batch_group_count", "feature_group_count", "input_batch_dimension", "input_feature_dimension",
        "input_spatial_dimensions", "kernel_input_feature_dimension", "kernel_output_feature_dimension",
        "kernel_spatial_dimensions", "lhs_dilation", "output_batch_dimension", "output_feature_dimension",
        "output_spatial_dimensions", "padding", "precision_config", "rhs_dilation", "window_reversal",
        "window_strides"),
    "custom_call_v1": (
        "api_version", "backend_config", "call_target_name", "called_computations", "has_side_effect",
        "operand_layouts", "output_operand_aliases", "result_layouts"),
    "dot_general_v2": (
        "accumulation_type", "allow_imprecise_accumulation", "lhs_batching_dimensions",
        "lhs_component_count", "lhs_contracting_dimensions", "lhs_precision_type",
        "num_primitive_operations", "precision_config", "rhs_batching_dimensions", "rhs_component_count",
        "rhs_contracting_dimensions", "rhs_precision_type"),
    "dynamic_broadcast_in_dim_v1": (
        "broadcast_dimensions", "known_expanding_dimensions", "known_nonexpanding_dimensions"),
    "dynamic_gather_v2": (
        "collapsed_slice_dims", "index_vector_dim", "indices_are_sorted", "offset_dims", "operand_batching_dims",
        "start_index_map", "start_indices_batching_dims"),
    "dynamic_iota_v1": ("iota_dimension",),
    "dynamic_slice_v1": ("slice_sizes",),
    "dynamic_update_slice_v1": (),
    "func_v1": ("arg_attrs", "function_type", "res_attrs", "sym_name", "sym_visibility"),
    "gather_v2": (
        "collapsed_slice_dims", "index_vector_dim", "indices_are_sorted", "offset_dims",
        "operand_batching_dims", "slice_sizes", "start_index_map", "start_indices_batching_dims"),
    "get_dimension_size_v1": ("dimension",),
    "iota_v1": ("iota_dimension",),
    "pad_v1": ("edge_padding_high", "edge_padding_low", "interior_padding"),
    "real_dynamic_slice_v1": (),
    "reduce_v1": ("dimensions",),
    "reduce_window_v1": ("base_dilations", "padding", "window_dilations", "window_dimensions",
                         "window_strides"),
    "reverse_v1": ("dimensions",),
    "select_and_scatter_v1": ("padding", "window_dimensions", "window_strides"),
    "slice_v1": ("limit_indices", "start_indices", "strides"),
    "transpose_v1": ("permutation",),
}

_VHLO_TYPES = {
    0: "i1", 2: "bf16", 3: "f16", 4: "f32", 5: "f64", 9: "index", 11: "i8", 12: "i16", 13: "i32",
    14: "i64", 16: "ui8", 17: "ui16", 18: "ui32", 19: "ui64",
}
_VHLO_TYPE_NAMES = {1: "complex_v1", 6: "f8E4M3FN_v1", 7: "f8E5M2_v1", 10: "i4_v1", 15: "ui4_v1"}
_ENUMS = {
    3: ("comparison_direction_v1", ("EQ", "NE", "GE", "GT", "LE", "LT")),
    4: ("comparison_type_v1", ("NOTYPE", "FLOAT", "TOTALORDER", "SIGNED", "UNSIGNED")),
    5: ("api_version_v1", ("API_VERSION_UNSPECIFIED", "API_VERSION_ORIGINAL", "API_VERSION_STATUS_RETURNING",
                           "API_VERSION_STATUS_RETURNING_UNIFIED", "API_VERSION_TYPED_FFI")),
    11: ("precision_v1", ("DEFAULT", "HIGH", "HIGHEST")),
    19: ("result_accuracy_mode_v1", ("DEFAULT", "HIGHEST", "TOLERANCE")),
}
#: numpy storage of each element type; bf16 is read as its uint16 bits
NP_DTYPES = {
    "i1": np.bool_, "i8": np.int8, "i16": np.int16, "i32": np.int32, "i64": np.int64, "ui8": np.uint8,
    "ui16": np.uint16, "ui32": np.uint32, "ui64": np.uint64, "f16": np.float16, "f32": np.float32,
    "f64": np.float64, "bf16": np.uint16, "index": np.int64,
}
_WIDTHS = {"i1": 1, "i8": 8, "i16": 16, "i32": 32, "i64": 64, "ui8": 8, "ui16": 16, "ui32": 32, "ui64": 64,
           "index": 64, "f16": 16, "bf16": 16, "f32": 32, "f64": 64}


# -- the plain IR ---------------------------------------------------------------


@dataclass(frozen=True)
class TensorType:
    """A ranked tensor type: ``shape`` holds ``None`` for a dynamic dim."""

    shape: Tuple[Optional[int], ...]
    dtype: str

    def __str__(self) -> str:
        dims = "".join(("?" if d is None else str(d)) + "x" for d in self.shape)
        return f"tensor<{dims}{self.dtype}>"

    @property
    def dynamic(self) -> bool:
        return any(d is None for d in self.shape)


@dataclass(frozen=True)
class FunctionType:
    inputs: Tuple[TensorType, ...]
    results: Tuple[TensorType, ...]


class NoneType:
    """VHLO's ``none_v1``: an absent optional attribute."""

    def __repr__(self) -> str:
        return "none"


NONE = NoneType()


class Value:
    """An SSA value: an op result or a block argument."""

    __slots__ = ("type",)

    def __init__(self, type_):
        self.type = type_

    def __repr__(self) -> str:
        return f"Value({self.type})"


@dataclass
class Block:
    args: List[Value]
    ops: List["Op"]


@dataclass
class Region:
    blocks: List[Block]


@dataclass
class Op:
    name: str  # the StableHLO name, e.g. "stablehlo.add", "func.func"
    vhlo: str  # the name as written, e.g. "vhlo.add_v1"
    operands: List[Value]
    results: List[Value]
    attrs: Dict[str, Any]
    regions: List[Region] = field(default_factory=list)


@dataclass
class Func:
    name: str
    visibility: str
    type: FunctionType
    arg_attrs: List[Dict[str, Any]]
    res_attrs: List[Dict[str, Any]]
    body: Region


@dataclass
class Module:
    bytecode_version: int
    producer: str
    vhlo_version: Tuple[int, int, int]
    name: Optional[str]
    attrs: Dict[str, Any]
    funcs: Dict[str, Func]

    def walk(self):
        """Every op of every function, nested regions included, in order."""
        for fn in self.funcs.values():
            yield from _walk_region(fn.body)


def _walk_region(region: Region):
    for block in region.blocks:
        for op in block.ops:
            yield op
            for r in op.regions:
                yield from _walk_region(r)


def upgraded_name(vhlo_name: str, in_func: bool) -> str:
    """The StableHLO op that a VHLO op name denotes."""
    base = re.sub(r"_v\d+$", "", vhlo_name)
    if base == "func":
        return "func.func"
    if base == "call":
        return "func.call"
    if base == "return":
        return "func.return" if in_func else "stablehlo.return"
    return f"stablehlo.{base}"


# -- the encoding ---------------------------------------------------------------


class _Reader:
    """MLIR's ``EncodingReader`` over ``buf[start:end]``; ``base`` is the
    offset of ``buf`` in the file, for alignment."""

    __slots__ = ("buf", "pos", "end")

    def __init__(self, buf: memoryview, start: int = 0, end: Optional[int] = None):
        self.buf, self.pos, self.end = buf, start, len(buf) if end is None else end

    def empty(self) -> bool:
        return self.pos >= self.end

    def byte(self) -> int:
        if self.pos >= self.end:
            raise ValueError("StableHLO bytecode: unexpected end of data")
        v = self.buf[self.pos]
        self.pos += 1
        return v

    def varint(self) -> int:
        first = self.byte()
        if first & 1:
            return first >> 1
        if first == 0:
            v = int.from_bytes(self.take(8), "little")
            return v
        n = (first & -first).bit_length() - 1  # trailing zero bits = bytes that follow
        v = int.from_bytes(bytes(self.buf[self.pos - 1:self.pos + n]), "little")
        self.pos += n
        if self.pos > self.end:
            raise ValueError("StableHLO bytecode: unexpected end of data")
        return v >> (n + 1)

    def svarint(self) -> int:
        v = self.varint()
        return (v >> 1) ^ -(v & 1)

    def flagged(self) -> Tuple[int, bool]:
        v = self.varint()
        return v >> 1, bool(v & 1)

    def take(self, n: int) -> memoryview:
        if self.pos + n > self.end:
            raise ValueError("StableHLO bytecode: unexpected end of data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def cstring(self) -> str:
        end = bytes(self.buf[self.pos:self.end]).index(b"\0")
        s = bytes(self.buf[self.pos:self.pos + end]).decode()
        self.pos += end + 1
        return s

    def section(self) -> Tuple[int, "_Reader"]:
        id_byte = self.byte()
        length = self.varint()
        sid = id_byte & 0x7F
        if sid > _PROPERTIES:
            raise UnsupportedBytecodeError(f"section id {sid}")
        if id_byte & 0x80:
            align = self.varint()
            while self.pos % align:
                if self.byte() != 0xCB:
                    raise ValueError("StableHLO bytecode: bad alignment padding")
        start = self.pos
        self.take(length)
        return sid, _Reader(self.buf, start, start + length)


def _apint(r: _Reader, width: int) -> int:
    if width <= 8:
        return r.byte()
    if width <= 64:
        return r.svarint()
    raise UnsupportedBytecodeError(f"an integer of {width} bits")


def _unsigned(v: int, width: int) -> int:
    return v & ((1 << width) - 1) if width < 64 else v & ((1 << 64) - 1)


class _Decoder:
    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        r = _Reader(self.buf)
        if bytes(r.take(4)) != MAGIC:
            raise ValueError("not MLIR bytecode (no ML\\xefR magic)")
        self.version = r.varint()
        self.producer = r.cstring()
        m = re.fullmatch(r"StableHLO_v(\d+)\.(\d+)\.(\d+)", self.producer)
        if m is None:
            raise UnsupportedBytecodeError(f"producer {self.producer!r} (not a StableHLO portable artifact)")
        self.vhlo_version = tuple(int(g) for g in m.groups())
        lo, hi = VHLO_VERSION_RANGE
        if not lo <= self.vhlo_version <= hi:
            raise UnsupportedBytecodeError(
                f"VHLO version {'.'.join(map(str, self.vhlo_version))} (read: "
                f"{'.'.join(map(str, lo))} to {'.'.join(map(str, hi))})")
        if self.version not in BYTECODE_VERSIONS:
            raise UnsupportedBytecodeError(
                f"bytecode version {self.version} (read: {', '.join(map(str, BYTECODE_VERSIONS))})")
        self.sections: Dict[int, _Reader] = {}
        while not r.empty():
            sid, sr = r.section()
            self.sections[sid] = sr
        for sid in (_STRINGS, _DIALECTS, _ATTR_TYPE, _ATTR_TYPE_OFFSETS, _IR):
            if sid not in self.sections:
                raise ValueError(f"StableHLO bytecode: section {sid} is missing")
        self._read_strings()
        self._read_dialects()
        self._read_attr_type_offsets()
        self._read_properties()

    # -- tables

    def _read_strings(self):
        r = self.sections[_STRINGS]
        n = r.varint()
        sizes = [r.varint() for _ in range(n)]
        strings: List[str] = [""] * n
        end = r.end
        for i, size in zip(range(n - 1, -1, -1), sizes):
            strings[i] = bytes(self.buf[end - size:end - 1]).decode("utf-8", "surrogateescape")
            end -= size
        self.strings = strings

    def _read_dialects(self):
        r = self.sections[_DIALECTS]
        self.dialects = []
        for _ in range(r.varint()):
            idx, versioned = r.flagged()
            if versioned:
                sid, _vr = r.section()
                if sid != _DIALECT_VERSIONS:
                    raise ValueError("StableHLO bytecode: expected a dialect version section")
            self.dialects.append(self.strings[idx])
        for d in self.dialects:
            if d not in ("builtin", "vhlo"):
                raise UnsupportedBytecodeError(f"dialect {d!r}")
        r.varint()  # the count of op names
        self.op_names: List[Tuple[str, str]] = []
        while not r.empty():
            dialect = self.dialects[r.varint()]
            for _ in range(r.varint()):
                idx, _registered = r.flagged()
                self.op_names.append((dialect, self.strings[idx]))

    def _read_attr_type_offsets(self):
        r = self.sections[_ATTR_TYPE_OFFSETS]
        n_attrs, n_types = r.varint(), r.varint()
        data = self.sections[_ATTR_TYPE]
        entries = []
        pos = data.pos
        while not r.empty():
            dialect = self.dialects[r.varint()]
            for _ in range(r.varint()):
                size, custom = r.flagged()
                entries.append((dialect, custom, pos, pos + size))
                pos += size
        if len(entries) != n_attrs + n_types:
            raise ValueError("StableHLO bytecode: attribute/type table does not add up")
        self.attr_entries, self.type_entries = entries[:n_attrs], entries[n_attrs:]
        self.attrs: List[Any] = [_UNREAD] * n_attrs
        self.types: List[Any] = [_UNREAD] * n_types

    def _read_properties(self):
        self.props: List[Tuple[int, int]] = []
        r = self.sections.get(_PROPERTIES)
        if r is None or r.empty():
            return
        for _ in range(r.varint()):
            size = r.varint()
            self.props.append((r.pos, r.pos + size))
            r.take(size)

    # -- attributes and types

    def type(self, idx: int):
        t = self.types[idx]
        if t is _UNREAD:
            dialect, custom, start, end = self.type_entries[idx]
            if not custom:
                raise UnsupportedBytecodeError(
                    f"type in assembly form {bytes(self.buf[start:end - 1]).decode(errors='replace')!r}")
            r = _Reader(self.buf, start, end)
            t = self._vhlo_type(r) if dialect == "vhlo" else self._builtin_type(r)
            self.types[idx] = t
        return t

    def _builtin_type(self, r: _Reader):
        code = r.varint()
        if code == 0:
            wsig = r.varint()
            width, sign = wsig >> 2, wsig & 3
            name = ("i" if sign == 0 else "si" if sign == 1 else "ui") + str(width)
            return name
        if code == 1:
            return "index"
        raise UnsupportedBytecodeError(f"builtin type code {code}")

    def _vhlo_type(self, r: _Reader):
        code = r.varint()
        if code in _VHLO_TYPES:
            return _VHLO_TYPES[code]
        if code == 20:
            dims = [r.svarint() for _ in range(r.varint())]
            elt = self.type(r.varint())
            if not isinstance(elt, str):
                raise UnsupportedBytecodeError(f"tensor element type {elt!r}")
            return TensorType(tuple(None if d == _DYNAMIC else d for d in dims), elt)
        if code == 8:
            ins = tuple(self.type(r.varint()) for _ in range(r.varint()))
            outs = tuple(self.type(r.varint()) for _ in range(r.varint()))
            return FunctionType(ins, outs)
        if code == 33:
            return NONE
        raise UnsupportedBytecodeError(f"VHLO type {_VHLO_TYPE_NAMES.get(code, f'code {code}')}")

    def attr(self, idx: int):
        a = self.attrs[idx]
        if a is _UNREAD:
            dialect, custom, start, end = self.attr_entries[idx]
            if not custom:
                raise UnsupportedBytecodeError(
                    f"attribute in assembly form {bytes(self.buf[start:end - 1]).decode(errors='replace')!r}")
            r = _Reader(self.buf, start, end)
            a = self._vhlo_attr(r) if dialect == "vhlo" else self._builtin_attr(r)
            self.attrs[idx] = a
        return a

    def _builtin_attr(self, r: _Reader):
        code = r.varint()
        if code == 0:
            return [self.attr(r.varint()) for _ in range(r.varint())]
        if code == 1:
            out = {}
            for _ in range(r.varint()):
                k = self.attr(r.varint())
                out[k] = self.attr(r.varint())
            return out
        if code in (2, 4):
            return self.strings[r.varint()]
        if code == 6:
            return self.type(r.varint())
        if code == 7:
            return True
        if code == 8:
            t = self.type(r.varint())
            width = int(re.sub(r"\D", "", t)) if t != "index" else 64
            v = _apint(r, width)
            return bool(v) if width == 1 else v
        if code in (10, 11, 12, 13, 14, 15, 22):
            return _LOCATION
        raise UnsupportedBytecodeError(f"builtin attribute code {code}")

    def _vhlo_attr(self, r: _Reader):
        code = r.varint()
        if code == 1:
            return [self.attr(r.varint()) for _ in range(r.varint())]
        if code == 2:
            return bool(r.varint())
        if code in _ENUMS:
            name, values = _ENUMS[code]
            v = r.varint()
            if v >= len(values):
                raise UnsupportedBytecodeError(f"{name} value {v}")
            return values[v]
        if code == 6:
            out = {}
            for _ in range(r.varint()):
                k = self.attr(r.varint())
                out[k] = self.attr(r.varint())
            return out
        if code == 9:
            t = self.type(r.varint())
            width = _WIDTHS.get(t)
            if width is None:
                raise UnsupportedBytecodeError(f"integer_v1 of type {t}")
            v = _apint(r, width)
            if t.startswith("ui"):
                v = _unsigned(v, width)
            return bool(v) if t == "i1" else v
        if code == 14:
            return self.strings[r.varint()]
        if code == 15:
            t = self.type(r.varint())
            size = r.varint()
            return _dense(t, r.take(size))
        if code == 17:
            return self.type(r.varint())
        if code == 20:
            atol, rtol, ulps = r.svarint(), r.svarint(), r.svarint()
            mode = self.attr(r.varint())
            return {"atol": atol, "rtol": rtol, "ulps": ulps, "mode": mode}
        raise UnsupportedBytecodeError(f"VHLO attribute code {code}")

    # -- the IR

    def _region_scope(self, r: _Reader, scope: List, parent: str) -> Region:
        n_blocks = r.varint()
        if n_blocks == 0:
            return Region([])
        n_values = r.varint()
        base = len(scope)
        scope.extend([None] * n_values)
        cursor = [base]
        blocks = []
        for _ in range(n_blocks):
            blocks.append(self._block_body(r, scope, cursor, parent))
        del scope[base:]
        return Region(blocks)

    def _define(self, scope, cursor, v: Value):
        if cursor[0] >= len(scope):
            raise ValueError("StableHLO bytecode: more values than the region declares")
        scope[cursor[0]] = v
        cursor[0] += 1

    def _block_body(self, r: _Reader, scope, cursor, parent: str) -> Block:
        n_ops, has_args = r.flagged()
        args = []
        if has_args:
            for _ in range(r.varint()):
                tidx, has_loc = r.flagged()
                if has_loc:
                    r.varint()
                v = Value(self.type(tidx))
                self._define(scope, cursor, v)
                args.append(v)
            if r.byte():
                _skip_use_list_orders(r, len(args))
        ops = [self._op(r, scope, cursor, parent) for _ in range(n_ops)]
        return Block(args, ops)

    def _op(self, r: _Reader, scope, cursor, parent: str) -> Op:
        dialect, name = self.op_names[r.varint()]
        mask = r.byte()
        r.varint()  # location
        full = f"{dialect}.{name}"
        attrs: Dict[str, Any] = {}
        if mask & 0x01:
            d = self.attr(r.varint())
            attrs.update(d)
        if mask & 0x40:
            pidx = r.varint()
            start, end = self.props[pidx]
            pr = _Reader(self.buf, start, end)
            if full == "builtin.module":
                for key in ("sym_name", "sym_visibility"):
                    idx, present = pr.flagged()
                    if present:
                        attrs[key] = self.attr(idx)
            else:
                names = VHLO_OPS.get(name) if dialect == "vhlo" else None
                if names is None:
                    raise UnsupportedBytecodeError(f"op {full}")
                for key in names:
                    attrs[key] = self.attr(pr.varint())
                if not pr.empty():
                    raise UnsupportedBytecodeError(f"op {full} with more properties than {ITEM} reads")
        elif dialect == "vhlo" and name not in VHLO_OPS:
            raise UnsupportedBytecodeError(f"op {full}")
        results = []
        if mask & 0x02:
            results = [Value(self.type(r.varint())) for _ in range(r.varint())]
        operands = []
        if mask & 0x04:
            for _ in range(r.varint()):
                idx = r.varint()
                v = scope[idx] if idx < len(scope) else None
                if v is None:
                    raise UnsupportedBytecodeError(f"a forward reference in {full}")
                operands.append(v)
        if mask & 0x08:
            raise UnsupportedBytecodeError(f"successors of {full}")
        for v in results:
            self._define(scope, cursor, v)
        if mask & 0x20:
            _skip_use_list_orders(r, len(results))
        sname = full if dialect == "builtin" else upgraded_name(name, parent == "func")
        regions = []
        if mask & 0x10:
            n_regions, isolated = r.flagged()
            rr, inner_scope = r, scope
            if isolated:
                sid, rr = r.section()
                if sid != _IR:
                    raise ValueError("StableHLO bytecode: expected an IR section for a region")
                inner_scope = []
            child = "func" if sname == "func.func" else "op"
            regions = [self._region_scope(rr, inner_scope, child) for _ in range(n_regions)]
        return Op(sname, full, operands, results, attrs, regions)


_UNREAD = object()
_LOCATION = "<loc>"


def _top(self: _Decoder) -> Block:
    scope: List[Optional[Value]] = []
    r = self.sections[_IR]
    n_ops, has_args = r.flagged()
    if has_args:
        raise UnsupportedBytecodeError("arguments of the top-level block")
    ops = [self._op(r, scope, [0], "top") for _ in range(n_ops)]
    return Block([], ops)


def _skip_use_list_orders(r: _Reader, n_values: int) -> None:
    """Use-list orders (the order of a value's uses, kept when a module is
    written from text): read past; an interpreter does not need them."""
    count = r.varint() if n_values > 1 else 1
    for _ in range(count):
        if n_values > 1:
            r.varint()  # the value's index in the range
        n, _pairs = r.flagged()
        for _ in range(n):
            r.varint()


def _dense(t, raw: memoryview) -> np.ndarray:
    """A ``tensor_v1`` attribute's raw data as a numpy array of its shape
    (``bf16`` as float32: its bits shifted up, exact)."""
    if not isinstance(t, TensorType) or t.dynamic:
        raise UnsupportedBytecodeError(f"dense data of type {t}")
    shape = tuple(t.shape)
    n = int(np.prod(shape, dtype=np.int64))
    raw = bytes(raw)
    if t.dtype == "i1":
        if len(raw) == 1 and raw[0] in (0, 0xFF) and n != 1:
            flat = np.full(n, bool(raw[0]))
        else:
            flat = np.unpackbits(np.frombuffer(raw, np.uint8), bitorder="little")[:n].astype(bool)
            if len(flat) < n:
                raise ValueError(f"StableHLO bytecode: {len(raw)} bytes for {t}")
        return flat.reshape(shape)
    if t.dtype not in NP_DTYPES:
        raise UnsupportedBytecodeError(f"dense data of element type {t.dtype}")
    dt = np.dtype(NP_DTYPES[t.dtype]).newbyteorder("<")
    flat = np.frombuffer(raw, dt)
    if flat.size == 1 and n != 1:
        flat = np.full(n, flat[0], dt)
    elif flat.size != n:
        raise ValueError(f"StableHLO bytecode: {len(raw)} bytes for {t}")
    arr = flat.astype(dt.newbyteorder("="), copy=True).reshape(shape)
    if t.dtype == "bf16":
        arr = (arr.astype(np.uint32) << 16).view(np.float32)
    return arr


def read_module(data: bytes) -> Module:
    """Read a StableHLO portable artifact (VHLO bytecode) into a
    :class:`Module`."""
    dec = _Decoder(bytes(data))
    top = _top(dec)
    if len(top.ops) != 1 or top.ops[0].vhlo != "builtin.module":
        raise UnsupportedBytecodeError("a top level other than one builtin.module")
    mod = top.ops[0]
    funcs: Dict[str, Func] = {}
    body = mod.regions[0].blocks[0].ops if mod.regions and mod.regions[0].blocks else []
    for op in body:
        if op.name != "func.func":
            raise UnsupportedBytecodeError(f"module-level op {op.vhlo}")
        a = op.attrs
        funcs[a["sym_name"]] = Func(a["sym_name"], a["sym_visibility"], a["function_type"],
                                    list(a["arg_attrs"]), list(a["res_attrs"]), op.regions[0])
    attrs = {k: v for k, v in mod.attrs.items() if k not in ("sym_name", "sym_visibility")}
    return Module(dec.version, dec.producer, dec.vhlo_version, mod.attrs.get("sym_name"), attrs, funcs)


__all__ = [
    "BYTECODE_VERSIONS", "Block", "Func", "FunctionType", "Module", "NONE", "Op", "Region", "TensorType",
    "UnsupportedBytecodeError", "VHLO_OPS", "VHLO_VERSION_RANGE", "Value", "read_module", "upgraded_name",
]
