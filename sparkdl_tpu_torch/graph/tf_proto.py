"""The protobuf messages that TF model ingestion reads, without protobuf.

The JAX package parses GraphDefs, MetaGraphDefs and SavedModels with
TensorFlow's generated classes (``tensorflow.core.*_pb2``) and turns
``TensorProto``s into arrays with ``tensor_util.MakeNdarray``. The card's
machine has neither tensorflow nor protobuf, so the port decodes the wire
format itself: varints (plain, and zigzag for ``sint64``), fixed32 and
fixed64 scalars, length-delimited strings, bytes and sub-messages, and
repeated scalars both packed and unpacked (a reader must take either).

Only the fields ingestion reads are described, in :data:`SCHEMA`, with
the field numbers of TF's ``.proto`` files: of ``GraphDef``, ``NodeDef``,
``AttrValue`` and its ``ListValue`` (every field: a registered op handler
may read any attribute), ``TensorProto``, ``TensorShapeProto``,
``FunctionDefLibrary``/``FunctionDef``/``OpDef``, ``MetaGraphDef``,
``SavedModel``, ``SignatureDef``/``TensorInfo``, the parts of
``SavedObjectGraph`` and ``TrackableObjectGraph`` that map a captured
variable to its checkpoint key, and the tensor bundle's
``BundleHeaderProto``/``BundleEntryProto``. Other fields are skipped by
their wire type.

A decoded :class:`Message` reads like the generated classes: absent
scalars give their zero value, absent sub-messages an empty message,
repeated fields a list, and map fields a dict whose missing keys give the
value type's empty message (``node.attr["padding"].s``,
``.list.i``, ``.func.name``), so the translator's handlers read attributes
as the JAX package's do. :func:`make_ndarray` is ``MakeNdarray``: from
``tensor_content``, or from the typed ``*_val`` list, where fewer values
than elements repeat the last one (a single value with a larger shape is
a splat, as TF writes a filled constant).
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Optional, Tuple

import numpy as np

# field kinds that are not messages
_VARINT_KINDS = ("int32", "int64", "uint32", "uint64", "bool", "enum", "sint64")
_FIXED32_KINDS = {"float": "<f4", "fixed32": "<u4"}
_FIXED64_KINDS = {"double": "<f8", "fixed64": "<u8"}
_STRUCT_FORMATS = {"float": "<f", "fixed32": "<I", "double": "<d", "fixed64": "<Q"}
_SCALAR_KINDS = set(_VARINT_KINDS) | set(_FIXED32_KINDS) | set(_FIXED64_KINDS) | {"string", "bytes"}

#: ``{message: {field number: (name, kind, label)}}``; ``kind`` is a
#: scalar kind above or a message name, ``label`` is ``"one"``, ``"rep"``
#: (repeated) or ``"map"`` (a map from string keys to ``kind``).
SCHEMA: Dict[str, Dict[int, Tuple[str, str, str]]] = {
    # tensorflow/core/framework/graph.proto, node_def.proto
    "GraphDef": {1: ("node", "NodeDef", "rep"), 2: ("library", "FunctionDefLibrary", "one")},
    "NodeDef": {
        1: ("name", "string", "one"), 2: ("op", "string", "one"), 3: ("input", "string", "rep"),
        5: ("attr", "AttrValue", "map"),
    },
    # attr_value.proto: every field, as a registered handler may read any
    "AttrValue": {
        1: ("list", "AttrValue.ListValue", "one"), 2: ("s", "bytes", "one"), 3: ("i", "int64", "one"),
        4: ("f", "float", "one"), 5: ("b", "bool", "one"), 6: ("type", "enum", "one"),
        7: ("shape", "TensorShapeProto", "one"), 8: ("tensor", "TensorProto", "one"),
        9: ("placeholder", "string", "one"), 10: ("func", "NameAttrList", "one"),
    },
    "AttrValue.ListValue": {
        2: ("s", "bytes", "rep"), 3: ("i", "int64", "rep"), 4: ("f", "float", "rep"),
        5: ("b", "bool", "rep"), 6: ("type", "enum", "rep"), 7: ("shape", "TensorShapeProto", "rep"),
        8: ("tensor", "TensorProto", "rep"), 9: ("func", "NameAttrList", "rep"),
    },
    "NameAttrList": {1: ("name", "string", "one"), 2: ("attr", "AttrValue", "map")},
    # tensor_shape.proto, tensor.proto
    "TensorShapeProto": {2: ("dim", "TensorShapeProto.Dim", "rep"), 3: ("unknown_rank", "bool", "one")},
    "TensorShapeProto.Dim": {1: ("size", "int64", "one")},
    "TensorProto": {
        1: ("dtype", "enum", "one"), 2: ("tensor_shape", "TensorShapeProto", "one"),
        4: ("tensor_content", "bytes", "one"), 5: ("float_val", "float", "rep"),
        6: ("double_val", "double", "rep"), 7: ("int_val", "int32", "rep"),
        8: ("string_val", "bytes", "rep"), 9: ("scomplex_val", "float", "rep"),
        10: ("int64_val", "int64", "rep"), 11: ("bool_val", "bool", "rep"),
        12: ("dcomplex_val", "double", "rep"), 13: ("half_val", "int32", "rep"),
        16: ("uint32_val", "uint32", "rep"), 17: ("uint64_val", "uint64", "rep"),
    },
    # function.proto, op_def.proto
    "FunctionDefLibrary": {1: ("function", "FunctionDef", "rep")},
    "FunctionDef": {1: ("signature", "OpDef", "one"), 3: ("node_def", "NodeDef", "rep"), 4: ("ret", "string", "map")},
    "OpDef": {1: ("name", "string", "one"), 2: ("input_arg", "OpDef.ArgDef", "rep"),
              3: ("output_arg", "OpDef.ArgDef", "rep")},
    "OpDef.ArgDef": {1: ("name", "string", "one")},
    # protobuf/meta_graph.proto, saved_model.proto
    "MetaGraphDef": {
        1: ("meta_info_def", "MetaGraphDef.MetaInfoDef", "one"), 2: ("graph_def", "GraphDef", "one"),
        5: ("signature_def", "SignatureDef", "map"), 7: ("object_graph_def", "SavedObjectGraph", "one"),
    },
    "MetaGraphDef.MetaInfoDef": {4: ("tags", "string", "rep")},
    "SignatureDef": {1: ("inputs", "TensorInfo", "map"), 2: ("outputs", "TensorInfo", "map")},
    "TensorInfo": {1: ("name", "string", "one"), 3: ("tensor_shape", "TensorShapeProto", "one")},
    "SavedModel": {2: ("meta_graphs", "MetaGraphDef", "rep")},
    # protobuf/saved_object_graph.proto: a concrete function's captures are
    # object-graph node ids, the same ids as the checkpoint's object graph
    "SavedObjectGraph": {2: ("concrete_functions", "SavedConcreteFunction", "map")},
    "SavedConcreteFunction": {2: ("bound_inputs", "int32", "rep")},
    # protobuf/trackable_object_graph.proto
    "TrackableObjectGraph": {1: ("nodes", "TrackableObject", "rep")},
    "TrackableObject": {2: ("attributes", "SerializedTensor", "rep")},
    "SerializedTensor": {1: ("name", "string", "one"), 3: ("checkpoint_key", "string", "one")},
    # protobuf/tensor_bundle.proto
    "BundleHeaderProto": {1: ("num_shards", "int32", "one"), 2: ("endianness", "enum", "one")},
    "BundleEntryProto": {
        1: ("dtype", "enum", "one"), 2: ("shape", "TensorShapeProto", "one"),
        3: ("shard_id", "int32", "one"), 4: ("offset", "int64", "one"), 5: ("size", "int64", "one"),
        6: ("crc32c", "fixed32", "one"), 7: ("slices", "TensorSliceProto", "rep"),
    },
    "TensorSliceProto": {},
}

# name -> (kind, label) per message, for default values
_BY_NAME = {msg: {name: (kind, label) for name, kind, label in fields.values()} for msg, fields in SCHEMA.items()}

_ZERO = {"string": "", "bytes": b"", "bool": False, "float": 0.0, "double": 0.0}


class ProtoError(ValueError):
    """Malformed or truncated protobuf wire data."""


class Message:
    """One decoded message: its fields as attributes, with protobuf's
    defaults for the absent ones. Instances are read-only by convention."""

    __slots__ = ("type_name", "_values")

    def __init__(self, type_name: str, values: Optional[Dict[str, Any]] = None):
        self.type_name = type_name
        self._values = values if values is not None else {}

    def __getattr__(self, name: str):
        values = object.__getattribute__(self, "_values")
        if name in values:
            return values[name]
        type_name = object.__getattribute__(self, "type_name")
        try:
            kind, label = _BY_NAME[type_name][name]
        except KeyError:
            raise AttributeError(f"{type_name} has no field {name!r}") from None
        if label == "rep":
            return []
        if label == "map":
            return AttrMap(kind)
        if kind in _SCALAR_KINDS:
            return _ZERO.get(kind, 0)
        return Message(kind)

    def HasField(self, name: str) -> bool:
        """Whether the field was on the wire (protobuf's ``HasField``)."""
        return name in self._values

    def __repr__(self) -> str:
        return f"{self.type_name}({self._values!r})"


class AttrMap(dict):
    """A decoded map field: a missing key gives the value type's empty
    message (or zero value), as a generated map does, without inserting
    it, so ``key in attr`` still says whether the attribute was set."""

    __slots__ = ("value_kind",)

    def __init__(self, value_kind: str, *args):
        super().__init__(*args)
        self.value_kind = value_kind

    def __missing__(self, key):
        if self.value_kind in _SCALAR_KINDS:
            return _ZERO.get(self.value_kind, 0)
        return Message(self.value_kind)


def _varint(buf, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        try:
            b = buf[pos]
        except IndexError:
            raise ProtoError("truncated varint") from None
        pos += 1
        result |= (b & 0x7F) << shift
        if b < 0x80:
            return result, pos
        shift += 7
        if shift >= 70:
            raise ProtoError("varint longer than 10 bytes")


def _signed(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


def _varint_value(kind: str, v: int):
    if kind == "bool":
        return v != 0
    if kind == "sint64":
        return (v >> 1) ^ -(v & 1)
    if kind in ("uint32", "uint64"):
        return v
    return _signed(v)  # int32, int64 and enum values are sign-extended to 64 bits


def _packed(kind: str, buf, start: int, end: int) -> list:
    if kind in _FIXED32_KINDS or kind in _FIXED64_KINDS:
        fmt = _FIXED32_KINDS.get(kind) or _FIXED64_KINDS[kind]
        if (end - start) % np.dtype(fmt).itemsize:
            raise ProtoError(f"packed {kind} field of {end - start} bytes")
        return np.frombuffer(buf, dtype=fmt, count=(end - start) // np.dtype(fmt).itemsize,
                             offset=start).tolist()
    out = []
    pos = start
    while pos < end:
        v, pos = _varint(buf, pos)
        out.append(_varint_value(kind, v))
    if pos != end:
        raise ProtoError(f"packed {kind} field overruns its length")
    return out


def _decode(type_name: str, buf, start: int, end: int) -> Message:
    fields = SCHEMA[type_name]
    values: Dict[str, Any] = {}
    pos = start
    while pos < end:
        key, pos = _varint(buf, pos)
        number, wire = key >> 3, key & 7
        if wire == 0:
            raw, pos = _varint(buf, pos)
        elif wire == 1:
            raw, pos = (pos, pos + 8), pos + 8
        elif wire == 2:
            n, pos = _varint(buf, pos)
            raw, pos = (pos, pos + n), pos + n
        elif wire == 5:
            raw, pos = (pos, pos + 4), pos + 4
        else:
            raise ProtoError(f"{type_name} field {number}: wire type {wire} (groups) is not read")
        if pos > end:
            raise ProtoError(f"{type_name} field {number} overruns the message")
        spec = fields.get(number)
        if spec is None:
            continue  # a field ingestion does not read
        name, kind, label = spec
        if label == "map":
            if wire != 2:
                raise ProtoError(f"{type_name}.{name}: map entry with wire type {wire}")
            entry_key, entry_value = _map_entry(kind, buf, *raw)
            values.setdefault(name, AttrMap(kind))[entry_key] = entry_value
            continue
        if label == "rep" and wire == 2 and kind not in ("string", "bytes") and kind in _SCALAR_KINDS:
            values.setdefault(name, []).extend(_packed(kind, buf, *raw))
            continue
        value = _scalar_or_message(type_name, name, kind, wire, raw, buf)
        if label == "rep":
            values.setdefault(name, []).append(value)
        else:
            values[name] = value
    if pos != end:
        raise ProtoError(f"{type_name} overruns its length")
    return Message(type_name, values)


def _scalar_or_message(type_name: str, name: str, kind: str, wire: int, raw, buf):
    if kind in _VARINT_KINDS:
        if wire != 0:
            raise ProtoError(f"{type_name}.{name}: {kind} with wire type {wire}")
        return _varint_value(kind, raw)
    if kind in _FIXED32_KINDS or kind in _FIXED64_KINDS:
        want = 5 if kind in _FIXED32_KINDS else 1
        if wire != want:
            raise ProtoError(f"{type_name}.{name}: {kind} with wire type {wire}")
        return struct.unpack_from(_STRUCT_FORMATS[kind], buf, raw[0])[0]
    if wire != 2:
        raise ProtoError(f"{type_name}.{name}: {kind} with wire type {wire}")
    if kind == "bytes":
        return bytes(buf[raw[0]:raw[1]])
    if kind == "string":
        return bytes(buf[raw[0]:raw[1]]).decode("utf-8")
    return _decode(kind, buf, *raw)


def _map_entry(kind: str, buf, start: int, end: int):
    key, value = "", None
    pos = start
    while pos < end:
        tag, pos = _varint(buf, pos)
        number, wire = tag >> 3, tag & 7
        if wire != 2:
            raise ProtoError(f"map entry field {number} with wire type {wire}")
        n, pos = _varint(buf, pos)
        if number == 1:
            key = bytes(buf[pos:pos + n]).decode("utf-8")
        elif number == 2:
            value = _scalar_or_message("map entry", "value", kind, 2, (pos, pos + n), buf)
        pos += n
    if pos != end:
        raise ProtoError("map entry overruns its length")
    if value is None:
        value = AttrMap(kind).__missing__(key)
    return key, value


def parse(type_name: str, data) -> Message:
    """Decode serialized ``data`` (bytes-like) as message ``type_name``."""
    if type_name not in SCHEMA:
        raise KeyError(f"no schema for {type_name!r}; known: {sorted(SCHEMA)}")
    buf = data if isinstance(data, (bytes, bytearray)) else bytes(data)
    return _decode(type_name, buf, 0, len(buf))


# -- dtypes ------------------------------------------------------------------

DT_FLOAT, DT_DOUBLE, DT_INT32, DT_UINT8, DT_INT16, DT_INT8, DT_STRING = 1, 2, 3, 4, 5, 6, 7
DT_COMPLEX64, DT_INT64, DT_BOOL, DT_BFLOAT16, DT_HALF, DT_RESOURCE = 8, 9, 10, 14, 19, 20

#: TF ``DataType`` -> numpy dtype (reference types, +100, map to their base)
NP_DTYPES = {
    1: np.dtype(np.float32), 2: np.dtype(np.float64), 3: np.dtype(np.int32),
    4: np.dtype(np.uint8), 5: np.dtype(np.int16), 6: np.dtype(np.int8),
    7: np.dtype(object), 8: np.dtype(np.complex64), 9: np.dtype(np.int64),
    10: np.dtype(np.bool_), 11: np.dtype(np.int8), 12: np.dtype(np.uint8),
    13: np.dtype(np.int32), 15: np.dtype(np.int16), 16: np.dtype(np.uint16),
    17: np.dtype(np.uint16), 18: np.dtype(np.complex128), 19: np.dtype(np.float16),
    22: np.dtype(np.uint32), 23: np.dtype(np.uint64),
}

#: the ``*_val`` field each dtype's values are listed in
_VAL_FIELD = {
    1: "float_val", 2: "double_val", 9: "int64_val", 10: "bool_val", 22: "uint32_val",
    23: "uint64_val", 8: "scomplex_val", 18: "dcomplex_val", 19: "half_val", 14: "half_val",
    **{dt: "int_val" for dt in (3, 4, 5, 6, 11, 12, 13, 15, 16, 17)},
}


def base_dtype(dt: int) -> int:
    """A reference dtype (``DT_FLOAT_REF`` ...) -> its base type."""
    return dt - 100 if dt > 100 else dt


def np_dtype(dt: int) -> np.dtype:
    """TF ``DataType`` enum -> numpy dtype. bfloat16 has no numpy dtype
    here: :func:`make_ndarray` widens its values to float32."""
    dt = base_dtype(dt)
    if dt == DT_BFLOAT16:
        return np.dtype(np.float32)
    try:
        return NP_DTYPES[dt]
    except KeyError:
        raise NotImplementedError(f"TF dtype enum {dt} has no numpy counterpart in the port") from None


def shape_of(shape_proto: Message) -> Optional[Tuple[int, ...]]:
    """``TensorShapeProto`` -> dims (-1 for unknown), or None for an
    unknown rank."""
    if shape_proto.unknown_rank:
        return None
    return tuple(int(d.size) for d in shape_proto.dim)


def _bfloat16_to_float32(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def make_ndarray(tensor: Message) -> np.ndarray:
    """``TensorProto`` -> numpy array, as TF's ``MakeNdarray``. bfloat16
    values come back widened to float32 (exactly)."""
    shape = [int(d.size) for d in tensor.tensor_shape.dim]
    n = int(np.prod(shape, dtype=np.int64))
    dt = base_dtype(tensor.dtype)
    if dt not in NP_DTYPES and dt != DT_BFLOAT16:
        raise NotImplementedError(f"TensorProto of dtype enum {dt} is not read by the port")
    if tensor.tensor_content:
        if dt == DT_BFLOAT16:
            return _bfloat16_to_float32(np.frombuffer(tensor.tensor_content, "<u2")).reshape(shape)
        if dt == DT_STRING:
            raise ProtoError("a string TensorProto carries no tensor_content")
        return np.frombuffer(tensor.tensor_content, dtype=NP_DTYPES[dt].newbyteorder("<")).astype(
            NP_DTYPES[dt]).reshape(shape)
    if dt == DT_STRING:
        values = list(tensor.string_val)
        if n > len(values):
            values.extend([values[-1] if values else b""] * (n - len(values)))
        out = np.empty(len(values), dtype=object)
        out[:] = values
        return out.reshape(shape)
    raw = getattr(tensor, _VAL_FIELD[dt])
    if dt in (DT_HALF, DT_BFLOAT16):
        bits = np.asarray(raw, dtype=np.int64).astype(np.uint16)
        values = _bfloat16_to_float32(bits) if dt == DT_BFLOAT16 else bits.view(np.float16)
    elif dt in (8, 18):
        pairs = np.asarray(raw, dtype=np.float64).reshape(-1, 2)
        values = (pairs[:, 0] + 1j * pairs[:, 1]).astype(NP_DTYPES[dt])
    else:
        values = np.asarray(raw, dtype=NP_DTYPES[dt]) if raw else np.zeros(0, NP_DTYPES[dt])
    if values.size == 0:
        return np.zeros(shape, values.dtype)
    if values.size != n:
        values = np.pad(values, (0, n - values.size), "edge")
    return values.reshape(shape)


__all__ = [
    "AttrMap", "Message", "NP_DTYPES", "ProtoError", "SCHEMA", "base_dtype", "make_ndarray",
    "np_dtype", "parse", "shape_of",
]
