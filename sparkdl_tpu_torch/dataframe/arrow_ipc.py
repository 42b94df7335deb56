"""Arrow IPC files, both ways, without ``pyarrow``; and the Arrow types of
the port's columns.

The batch gang worker publishes one Arrow IPC **file** per partition and
the gather reads them back (the JAX package does both through
``pyarrow``, which the card's machine lacks). This module writes and
reads that format itself:

- a hand-written FlatBuffers reader (:class:`_Table`) and builder
  (:class:`_Builder`) for the ``Footer``, ``Schema``, ``Field``,
  ``KeyValue``, ``Message`` and ``RecordBatch`` tables of the Arrow
  format (``File.fbs``, ``Schema.fbs``, ``Message.fbs``), metadata
  version V5, little-endian, buffers 8-byte aligned;
- types null, bool, signed and unsigned ints, half/single/double floats,
  utf8 and binary (and their large forms when reading), struct, list,
  fixed-size list, and the ``arrow.fixed_shape_tensor`` extension carried
  in a field's ``ARROW:extension:name`` / ``ARROW:extension:metadata``.
  Dictionary-encoded fields, compressed bodies and other types raise
  NotImplementedError naming ROADMAP Queue A item 11.

The port's partitions hold plain lists of Python values, or a numpy block
``(rows, *shape)`` for a tensor column. :func:`infer_field` gives a
column the Arrow type the JAX package's ``columns.to_arrow_array`` gives
the same cells: uniformly shaped numeric ndarrays without nulls become a
FixedShapeTensor, Python ints ``int64``, floats ``double``, dicts
structs, and so on. Reading gives back what ``from_arrow_array`` gives:
``to_pylist`` values, and one contiguous block for a tensor column.

``write_partition(columns, path)`` publishes atomically (``path.tmp``
then ``os.replace``), and :func:`valid_output` is the worker's resume
check: a torn or garbage file reads as invalid.
"""

from __future__ import annotations

import base64
import json
import os
import struct
from dataclasses import dataclass, field as dc_field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from sparkdl_tpu_torch.dataframe.snappy import ROADMAP_ITEM

MAGIC = b"ARROW1"
CONTINUATION = b"\xff\xff\xff\xff"
TENSOR_EXTENSION = "arrow.fixed_shape_tensor"
EXT_NAME = "ARROW:extension:name"
EXT_META = "ARROW:extension:metadata"

# Type union ids (Schema.fbs)
_T_NULL, _T_INT, _T_FLOAT, _T_BINARY, _T_UTF8, _T_BOOL = 1, 2, 3, 4, 5, 6
_T_LIST, _T_STRUCT, _T_FSL = 12, 13, 16
_T_LARGE_BINARY, _T_LARGE_UTF8, _T_LARGE_LIST = 19, 20, 21
# MessageHeader union ids (Message.fbs)
_H_SCHEMA, _H_BATCH = 1, 3
_V5 = 4


class ArrowFormatError(ValueError):
    """Not a readable Arrow IPC file (torn, truncated or foreign)."""


# -- the type model -----------------------------------------------------------


@dataclass
class DType:
    """An Arrow type: ``kind`` is one of null, bool, int, float, utf8,
    binary, struct, list, fixed_size_list (large_* when read)."""

    kind: str
    bits: int = 0
    signed: bool = True
    children: List["Field"] = dc_field(default_factory=list)
    size: int = 0  # fixed_size_list

    def numpy(self) -> np.dtype:
        if self.kind == "bool":
            return np.dtype(bool)
        if self.kind == "int":
            return np.dtype(f"{'i' if self.signed else 'u'}{self.bits // 8}")
        if self.kind == "float":
            return np.dtype(f"f{self.bits // 8}")
        raise TypeError(f"no numpy dtype for {self.kind}")


@dataclass
class Field:
    name: str
    type: DType
    nullable: bool = True
    metadata: Dict[str, str] = dc_field(default_factory=dict)

    def tensor_shape(self) -> Optional[Tuple[int, ...]]:
        """The row shape of an ``arrow.fixed_shape_tensor`` field."""
        if self.metadata.get(EXT_NAME) != TENSOR_EXTENSION:
            return None
        meta = json.loads(self.metadata.get(EXT_META) or "{}")
        perm = meta.get("permutation")
        if perm is not None and list(perm) != sorted(perm):
            raise NotImplementedError(
                f"a permuted fixed_shape_tensor is not supported: {ROADMAP_ITEM}"
            )
        return tuple(int(d) for d in meta["shape"])


def _dtype_of_numpy(dt: np.dtype) -> DType:
    dt = np.dtype(dt)
    if dt.kind == "b":
        return DType("bool")
    if dt.kind in "iu":
        return DType("int", bits=dt.itemsize * 8, signed=dt.kind == "i")
    if dt.kind == "f":
        return DType("float", bits=dt.itemsize * 8)
    raise TypeError(f"no Arrow type for numpy dtype {dt}")


def tensor_field(name: str, dtype: np.dtype, shape: Sequence[int]) -> Field:
    """A FixedShapeTensor field: fixed_size_list<item: dtype>[prod(shape)]
    with the extension's metadata, as ``pyarrow.fixed_shape_tensor``."""
    shape = [int(d) for d in shape]
    item = Field("item", _dtype_of_numpy(dtype))
    return Field(
        name,
        DType("fixed_size_list", children=[item], size=int(np.prod(shape))),
        metadata={EXT_NAME: TENSOR_EXTENSION,
                  EXT_META: json.dumps({"shape": shape}, separators=(",", ":"))},
    )


def tensor_block(values) -> Optional[np.ndarray]:
    """The contiguous block of a tensor column: a numpy block of rank >= 2,
    or cells that are all numeric ndarrays of one shape and dtype (no
    nulls), as the JAX package's ``TensorColumn.maybe_pack``; else None."""
    if isinstance(values, np.ndarray):
        return values if values.ndim >= 2 else None
    vals = list(values)
    if not vals or not all(
        isinstance(v, np.ndarray) and v.dtype.kind in "fiub" for v in vals
    ):
        return None
    first = vals[0]
    if first.ndim == 0 or any(
        v.shape != first.shape or v.dtype != first.dtype for v in vals
    ):
        return None
    return np.stack(vals)


def _scalar_kind(v) -> str:
    if isinstance(v, (bool, np.bool_)):
        return "bool"
    if isinstance(v, (int, np.integer)):
        return "int"
    if isinstance(v, (float, np.floating)):
        return "float"
    if isinstance(v, str):
        return "utf8"
    if isinstance(v, (bytes, bytearray, memoryview)):
        return "binary"
    if isinstance(v, dict):
        return "struct"
    if isinstance(v, (list, tuple, np.ndarray)):
        return "list"
    raise TypeError(f"no Arrow type for a cell of type {type(v).__name__}")


def _infer_type(values: Sequence[Any]) -> DType:
    present = [v for v in values if v is not None]
    if not present:
        return DType("null")
    kinds = {_scalar_kind(v) for v in present}
    if kinds == {"int", "float"}:
        kinds = {"float"}
        present = [float(v) for v in present]
    if len(kinds) != 1:
        raise TypeError(f"a column mixes cells of kinds {sorted(kinds)}")
    kind = kinds.pop()
    if kind in ("int", "float"):
        np_types = {v.dtype for v in present if isinstance(v, np.generic)}
        if len(np_types) == 1 and len(present) == sum(
            isinstance(v, np.generic) for v in present
        ):
            return _dtype_of_numpy(np_types.pop())
        return DType("int", bits=64) if kind == "int" else DType("float", bits=64)
    if kind == "struct":
        names: List[str] = []
        for v in present:
            for k in v:
                if k not in names:
                    names.append(k)
        return DType("struct", children=[
            Field(k, _infer_type([v.get(k) for v in present])) for k in names
        ])
    if kind == "list":
        flat: List[Any] = []
        for v in present:
            flat.extend(v.tolist() if isinstance(v, np.ndarray) else v)
        return DType("list", children=[Field("item", _infer_type(flat))])
    return DType(kind)


def infer_field(name: str, values) -> Field:
    """The Arrow field of one column chunk (see the module docstring)."""
    block = tensor_block(values)
    if block is not None:
        return tensor_field(name, block.dtype, block.shape[1:])
    if isinstance(values, np.ndarray):  # a 1-D block of scalars
        return Field(name, _dtype_of_numpy(values.dtype))
    return Field(name, _infer_type(values))


def same_field(a: Field, b: Field) -> bool:
    return (a.name == b.name and a.metadata == b.metadata
            and _same_type(a.type, b.type))


def _same_type(a: DType, b: DType) -> bool:
    if (a.kind, a.bits, a.signed, a.size) != (b.kind, b.bits, b.signed, b.size):
        return False
    if len(a.children) != len(b.children):
        return False
    return all(same_field(x, y) for x, y in zip(a.children, b.children))


def unify_field(first: Field, other: Field) -> Optional[Field]:
    """``other`` cast to ``first``'s type where that loses nothing (a
    null-typed chunk takes any type, as a pyarrow cast does); None if the
    two differ otherwise."""
    if same_field(first, other):
        return first
    if first.name == other.name and other.type.kind == "null":
        return first
    if (first.name == other.name and first.type.kind == other.type.kind
            and first.type.kind in ("struct", "list")
            and len(first.type.children) == len(other.type.children)):
        kids = [unify_field(x, y) for x, y in
                zip(first.type.children, other.type.children)]
        if all(k is not None for k in kids):
            return first
    return None


# -- python cells <-> flat arrays ---------------------------------------------


def _validity(values) -> Optional[np.ndarray]:
    if isinstance(values, np.ndarray):
        return None
    mask = np.fromiter((v is not None for v in values), bool, len(values))
    return None if mask.all() else mask


def _bitmap(mask: np.ndarray) -> bytes:
    return np.packbits(mask.astype(np.uint8), bitorder="little").tobytes()


def _unbitmap(data, n: int) -> np.ndarray:
    bits = np.unpackbits(np.frombuffer(data, np.uint8), bitorder="little")
    return bits[:n].astype(bool)


def _primitive_array(dtype: DType, values) -> np.ndarray:
    npt = dtype.numpy()
    if isinstance(values, np.ndarray):
        return values.astype(npt, copy=False).reshape(-1)
    fill = False if dtype.kind == "bool" else 0
    return np.asarray([fill if v is None else v for v in values], dtype=npt)


def _binary_parts(kind: str, values) -> Tuple[np.ndarray, bytes]:
    chunks = []
    for v in values:
        if v is None:
            chunks.append(b"")
        elif kind == "utf8":
            chunks.append(v.encode("utf-8"))
        else:
            chunks.append(bytes(v))
    offsets = np.zeros(len(chunks) + 1, np.int64)
    np.cumsum([len(c) for c in chunks], out=offsets[1:])
    return offsets, b"".join(chunks)


# -- FlatBuffers ----------------------------------------------------------------


class _Table:
    """A FlatBuffers table at ``pos`` in ``buf`` (read side)."""

    __slots__ = ("buf", "pos", "vt", "vt_size")

    def __init__(self, buf, pos: int):
        if pos < 0 or pos + 4 > len(buf):
            raise ArrowFormatError("table offset outside the buffer")
        self.buf, self.pos = buf, pos
        self.vt = pos - struct.unpack_from("<i", buf, pos)[0]
        if self.vt < 0 or self.vt + 4 > len(buf):
            raise ArrowFormatError("vtable outside the buffer")
        self.vt_size = struct.unpack_from("<H", buf, self.vt)[0]

    def _off(self, slot: int) -> int:
        o = 4 + 2 * slot
        if o + 2 > self.vt_size:
            return 0
        return struct.unpack_from("<H", self.buf, self.vt + o)[0]

    def scalar(self, slot: int, fmt: str, default=0):
        o = self._off(slot)
        return struct.unpack_from("<" + fmt, self.buf, self.pos + o)[0] if o else default

    def _ref(self, slot: int) -> Optional[int]:
        o = self._off(slot)
        if not o:
            return None
        p = self.pos + o
        return p + struct.unpack_from("<I", self.buf, p)[0]

    def table(self, slot: int) -> Optional["_Table"]:
        p = self._ref(slot)
        return None if p is None else _Table(self.buf, p)

    def string(self, slot: int) -> Optional[str]:
        p = self._ref(slot)
        if p is None:
            return None
        n = struct.unpack_from("<I", self.buf, p)[0]
        return bytes(self.buf[p + 4:p + 4 + n]).decode("utf-8")

    def vector(self, slot: int) -> Tuple[int, int]:
        """(start of the elements, count); (0, 0) when absent."""
        p = self._ref(slot)
        if p is None:
            return 0, 0
        return p + 4, struct.unpack_from("<I", self.buf, p)[0]

    def tables(self, slot: int) -> List["_Table"]:
        start, n = self.vector(slot)
        out = []
        for i in range(n):
            q = start + 4 * i
            out.append(_Table(self.buf, q + struct.unpack_from("<I", self.buf, q)[0]))
        return out


class _Builder:
    """A forward FlatBuffers builder: a table's vtable goes just before it
    and its children after it, so every uoffset points forward, and every
    scalar sits at a multiple of its size from the buffer's start."""

    def __init__(self):
        self.buf = bytearray(b"\0\0\0\0")  # the root uoffset, patched in finish

    def _pad(self, align: int, shift: int = 0) -> None:
        while (len(self.buf) + shift) % align:
            self.buf.append(0)

    def _patch(self, at: int, target: int) -> None:
        struct.pack_into("<I", self.buf, at, target - at)

    def finish(self, root) -> bytes:
        self._patch(0, root())
        self._pad(8)
        return bytes(self.buf)

    def table(self, fields: List[Optional[Tuple[str, Any]]]):
        """A deferred table: ``fields[slot]`` is None (absent), a scalar
        ``(fmt, value)``, or ``("ref", writer)`` where ``writer()`` writes
        the child and returns its position."""

        def write() -> int:
            layout, cur = {}, 4
            for slot, f in enumerate(fields):
                if f is None:
                    continue
                size = 4 if f[0] == "ref" else struct.calcsize("<" + f[0])
                cur = (cur + size - 1) // size * size
                layout[slot] = cur
                cur += size
            inline = (cur + 3) // 4 * 4
            self._pad(2)
            vt = len(self.buf)
            vt_size = 4 + 2 * len(fields)
            self.buf += struct.pack("<HH", vt_size, inline)
            self.buf += b"".join(
                struct.pack("<H", layout.get(s, 0)) for s in range(len(fields)))
            self._pad(8)
            pos = len(self.buf)
            self.buf += bytes(inline)
            struct.pack_into("<i", self.buf, pos, pos - vt)
            refs = []
            for slot, off in layout.items():
                fmt, value = fields[slot]
                if fmt == "ref":
                    refs.append((pos + off, value))
                else:
                    struct.pack_into("<" + fmt, self.buf, pos + off, value)
            for at, writer in refs:
                self._patch(at, writer())
            return pos

        return write

    def string(self, s: str):
        def write() -> int:
            data = s.encode("utf-8")
            self._pad(4)
            pos = len(self.buf)
            self.buf += struct.pack("<I", len(data)) + data + b"\0"
            return pos

        return write

    def tables(self, writers: List):
        def write() -> int:
            self._pad(4)
            pos = len(self.buf)
            self.buf += struct.pack("<I", len(writers)) + bytes(4 * len(writers))
            for i, w in enumerate(writers):
                self._patch(pos + 4 + 4 * i, w())
            return pos

        return write

    def structs(self, fmt: str, items: List[tuple]):
        """A vector of structs of 8-byte members (elements 8-aligned)."""

        def write() -> int:
            self._pad(8, shift=4)
            pos = len(self.buf)
            self.buf += struct.pack("<I", len(items))
            for it in items:
                self.buf += struct.pack("<" + fmt, *it)
            return pos

        return write


# -- schema <-> flatbuffers ---------------------------------------------------


def _kv_writers(b: _Builder, meta: Dict[str, str]):
    return b.tables([
        b.table([("ref", b.string(k)), ("ref", b.string(v))])
        for k, v in meta.items()
    ])


def _type_writer(b: _Builder, t: DType) -> Tuple[int, Any]:
    if t.kind == "null":
        return _T_NULL, b.table([])
    if t.kind == "bool":
        return _T_BOOL, b.table([])
    if t.kind == "int":
        return _T_INT, b.table([("i", t.bits), ("?", t.signed)])
    if t.kind == "float":
        return _T_FLOAT, b.table([("h", {16: 0, 32: 1, 64: 2}[t.bits])])
    if t.kind == "utf8":
        return _T_UTF8, b.table([])
    if t.kind == "binary":
        return _T_BINARY, b.table([])
    if t.kind == "struct":
        return _T_STRUCT, b.table([])
    if t.kind == "list":
        return _T_LIST, b.table([])
    if t.kind == "fixed_size_list":
        return _T_FSL, b.table([("i", t.size)])
    raise NotImplementedError(f"cannot write Arrow type {t.kind}: {ROADMAP_ITEM}")


def _field_writer(b: _Builder, f: Field):
    type_id, type_w = _type_writer(b, f.type)
    return b.table([
        ("ref", b.string(f.name)),
        ("?", f.nullable),
        ("B", type_id),
        ("ref", type_w),
        None,
        ("ref", b.tables([_field_writer(b, c) for c in f.type.children])),
        ("ref", _kv_writers(b, f.metadata)) if f.metadata else None,
    ])


def _schema_writer(b: _Builder, fields: List[Field], meta: Optional[Dict[str, str]] = None):
    return b.table([
        ("h", 0),
        ("ref", b.tables([_field_writer(b, f) for f in fields])),
        ("ref", _kv_writers(b, meta)) if meta else None,
    ])


def _read_kv(t: _Table, slot: int) -> Dict[str, str]:
    return {kv.string(0): kv.string(1) or "" for kv in t.tables(slot)}


def _read_type(type_id: int, t: Optional[_Table], children: List[Field]) -> DType:
    if type_id == _T_NULL:
        return DType("null")
    if type_id == _T_BOOL:
        return DType("bool")
    if type_id == _T_INT:
        return DType("int", bits=t.scalar(0, "i"), signed=bool(t.scalar(1, "?")))
    if type_id == _T_FLOAT:
        return DType("float", bits={0: 16, 1: 32, 2: 64}[t.scalar(0, "h")])
    if type_id in (_T_UTF8, _T_LARGE_UTF8):
        return DType("utf8" if type_id == _T_UTF8 else "large_utf8")
    if type_id in (_T_BINARY, _T_LARGE_BINARY):
        return DType("binary" if type_id == _T_BINARY else "large_binary")
    if type_id == _T_STRUCT:
        return DType("struct", children=children)
    if type_id in (_T_LIST, _T_LARGE_LIST):
        return DType("list" if type_id == _T_LIST else "large_list", children=children)
    if type_id == _T_FSL:
        return DType("fixed_size_list", children=children, size=t.scalar(0, "i"))
    raise NotImplementedError(
        f"Arrow type id {type_id} is not supported by sparkdl_tpu_torch: {ROADMAP_ITEM}"
    )


def _read_field(t: _Table) -> Field:
    if t.table(4) is not None:
        raise NotImplementedError(
            f"dictionary-encoded Arrow fields are not supported: {ROADMAP_ITEM}"
        )
    children = [_read_field(c) for c in t.tables(5)]
    return Field(
        t.string(0) or "",
        _read_type(t.scalar(2, "B"), t.table(3), children),
        nullable=bool(t.scalar(1, "?")),
        metadata=_read_kv(t, 6),
    )


def _read_schema(t: _Table) -> Tuple[List[Field], Dict[str, str]]:
    if t.scalar(0, "h") != 0:
        raise NotImplementedError(f"big-endian Arrow data: {ROADMAP_ITEM}")
    return [_read_field(f) for f in t.tables(1)], _read_kv(t, 2)


def _message(b: _Builder, header_type: int, header_w, body_len: int) -> bytes:
    fb = b.finish(b.table([
        ("h", _V5), ("B", header_type), ("ref", header_w), ("q", body_len),
    ]))
    return CONTINUATION + struct.pack("<i", len(fb)) + fb


def schema_message(fields: List[Field], meta: Optional[Dict[str, str]] = None) -> bytes:
    """An encapsulated Schema message (what ``ARROW:schema`` holds)."""
    b = _Builder()
    return _message(b, _H_SCHEMA, _schema_writer(b, fields, meta), 0)


def _parse_message(buf, pos: int) -> Tuple[_Table, int]:
    """(Message table, position after its metadata) at ``pos``."""
    if bytes(buf[pos:pos + 4]) == CONTINUATION:
        pos += 4
    if pos + 4 > len(buf):
        raise ArrowFormatError("truncated message")
    n = struct.unpack_from("<i", buf, pos)[0]
    pos += 4
    if n <= 0 or pos + n > len(buf):
        raise ArrowFormatError("message metadata runs past the buffer")
    meta = memoryview(buf)[pos:pos + n]
    root = struct.unpack_from("<I", meta, 0)[0]
    return _Table(meta, root), pos + n


def read_schema_message(data: bytes) -> List[Field]:
    """The fields of an encapsulated Schema message (``ARROW:schema``'s
    base64 payload decoded)."""
    msg, _ = _parse_message(data, 0)
    if msg.scalar(1, "B") != _H_SCHEMA:
        raise ArrowFormatError("not a Schema message")
    return _read_schema(msg.table(2))[0]


def decode_arrow_schema(b64: str) -> List[Field]:
    return read_schema_message(base64.b64decode(b64))


# -- record batches ---------------------------------------------------------------


class _BodyWriter:
    def __init__(self):
        self.nodes: List[Tuple[int, int]] = []
        self.buffers: List[Tuple[int, int]] = []
        self.chunks: List[bytes] = []
        self.size = 0

    def buffer(self, data: bytes) -> None:
        self.buffers.append((self.size, len(data)))
        pad = (-len(data)) % 8
        self.chunks.append(data + bytes(pad))
        self.size += len(data) + pad

    def validity(self, mask: Optional[np.ndarray], n: int) -> int:
        if mask is None:
            self.buffer(b"")
            return 0
        self.buffer(_bitmap(mask))
        return int(n - mask.sum())

    def column(self, f: Field, values) -> None:
        t = f.type
        n = len(values)
        node = len(self.nodes)
        self.nodes.append((n, 0))
        if t.kind == "null":
            self.nodes[node] = (n, n)
            return
        mask = _validity(values)
        nulls = self.validity(mask, n)
        self.nodes[node] = (n, nulls)
        if t.kind == "bool":
            self.buffer(_bitmap(_primitive_array(t, values)))
        elif t.kind in ("int", "float"):
            self.buffer(_primitive_array(t, values).tobytes())
        elif t.kind in ("utf8", "binary"):
            offsets, data = _binary_parts(t.kind, values)
            self.buffer(offsets.astype(np.int32).tobytes())
            self.buffer(data)
        elif t.kind == "struct":
            for c in t.children:
                self.column(c, [None if v is None else v.get(c.name) for v in values])
        elif t.kind == "list":
            flat: List[Any] = []
            offsets = np.zeros(n + 1, np.int64)
            for i, v in enumerate(values):
                if v is not None:
                    flat.extend(v.tolist() if isinstance(v, np.ndarray) else v)
                offsets[i + 1] = len(flat)
            self.buffer(offsets.astype(np.int32).tobytes())
            self.column(t.children[0], flat)
        elif t.kind == "fixed_size_list":
            block = tensor_block(values) if not isinstance(values, np.ndarray) else values
            child = t.children[0]
            if block is not None:
                self.column(child, block.reshape(-1))
            else:
                flat = []
                for v in values:
                    if v is None:
                        flat.extend([None] * t.size)
                    else:
                        flat.extend(v.reshape(-1).tolist() if isinstance(v, np.ndarray) else v)
                self.column(child, flat)
        else:
            raise NotImplementedError(f"cannot write Arrow type {t.kind}: {ROADMAP_ITEM}")


def _record_batch(columns: Dict[str, Any], fields: List[Field], n: int) -> Tuple[bytes, bytes]:
    """(the RecordBatch message's metadata, its body)."""
    body = _BodyWriter()
    for f in fields:
        body.column(f, columns[f.name])
    b = _Builder()
    header = b.table([
        ("q", n),
        ("ref", b.structs("qq", body.nodes)),
        ("ref", b.structs("qq", body.buffers)),
    ])
    meta = _message(b, _H_BATCH, header, body.size)
    return meta, b"".join(body.chunks)


class _BodyReader:
    def __init__(self, body, nodes, buffers):
        self.body, self.nodes, self.buffers = body, nodes, buffers
        self.ni = self.bi = 0

    def _buf(self):
        off, n = self.buffers[self.bi]
        self.bi += 1
        if off + n > len(self.body):
            raise ArrowFormatError("buffer runs past the body")
        return self.body[off:off + n]

    def column(self, f: Field, as_block: bool = True):
        t = f.type
        n, nulls = self.nodes[self.ni]
        self.ni += 1
        if t.kind == "null":
            return [None] * n
        vbuf = self._buf()
        valid = _unbitmap(vbuf, n) if nulls and len(vbuf) else None
        if t.kind == "bool":
            vals = _unbitmap(self._buf(), n).tolist()
        elif t.kind in ("int", "float"):
            arr = np.frombuffer(self._buf(), t.numpy(), count=n)
            vals = arr.tolist()
        elif t.kind in ("utf8", "binary", "large_utf8", "large_binary"):
            ot = np.int64 if t.kind.startswith("large") else np.int32
            offsets = np.frombuffer(self._buf(), ot, count=n + 1)
            data = bytes(self._buf())
            raw = [data[offsets[i]:offsets[i + 1]] for i in range(n)]
            vals = [r.decode("utf-8") for r in raw] if t.kind.endswith("utf8") else raw
        elif t.kind == "struct":
            kids = [(c.name, self.column(c, as_block=False)) for c in t.children]
            vals = [{name: col[i] for name, col in kids} for i in range(n)]
        elif t.kind in ("list", "large_list"):
            ot = np.int64 if t.kind == "large_list" else np.int32
            offsets = np.frombuffer(self._buf(), ot, count=n + 1)
            child = self.column(t.children[0], as_block=False)
            vals = [child[offsets[i]:offsets[i + 1]] for i in range(n)]
        elif t.kind == "fixed_size_list":
            shape = f.tensor_shape()
            item = t.children[0]
            if shape is not None and as_block and valid is None:
                cn, cnulls = self.nodes[self.ni]
                if item.type.kind in ("int", "float") and not cnulls:
                    self.ni += 1
                    self._buf()  # the child's (empty) validity
                    arr = np.frombuffer(self._buf(), item.type.numpy(), count=cn)
                    return arr.reshape((n,) + shape).copy()
            child = self.column(item, as_block=False)
            vals = [child[i * t.size:(i + 1) * t.size] for i in range(n)]
        else:
            raise NotImplementedError(f"cannot read Arrow type {t.kind}: {ROADMAP_ITEM}")
        if valid is not None:
            vals = [v if ok else None for v, ok in zip(vals, valid)]
        return vals


# -- files --------------------------------------------------------------------


def _fields_for(columns: Dict[str, Any], fields: Optional[List[Field]]) -> List[Field]:
    if fields is not None:
        return fields
    return [infer_field(name, values) for name, values in columns.items()]


def write_file(columns: Dict[str, Any], path: str,
               fields: Optional[List[Field]] = None) -> None:
    """One record batch of ``columns`` (name -> cells or block) as an Arrow
    IPC file at ``path``."""
    fields = _fields_for(columns, fields)
    n = len(next(iter(columns.values()))) if columns else 0
    schema = schema_message(fields)
    meta, body = _record_batch(columns, fields, n)
    with open(path, "wb") as f:
        f.write(MAGIC + b"\0\0")
        f.write(schema)
        batch_at = f.tell()
        f.write(meta)
        f.write(body)
        f.write(CONTINUATION + b"\0\0\0\0")  # end of stream
        b = _Builder()
        footer = b.finish(b.table([
            ("h", _V5),
            ("ref", _schema_writer(b, fields)),
            ("ref", b.structs("qiiq", [])),
            ("ref", b.structs("qiiq", [(batch_at, len(meta), 0, len(body))])),
        ]))
        f.write(footer)
        f.write(struct.pack("<i", len(footer)))
        f.write(MAGIC)


def write_partition(columns: Dict[str, Any], path: str,
                    fields: Optional[List[Field]] = None) -> None:
    """:func:`write_file` to ``path.tmp``, then ``os.replace``: a reader
    never sees a partial partition."""
    tmp = path + ".tmp"
    write_file(columns, tmp, fields)
    os.replace(tmp, path)


def _footer(buf) -> Tuple[List[Field], List[Tuple[int, int, int]]]:
    n = len(buf)
    if n < 18 or bytes(buf[:6]) != MAGIC or bytes(buf[-6:]) != MAGIC:
        raise ArrowFormatError("no Arrow file magic at both ends")
    size = struct.unpack_from("<i", buf, n - 10)[0]
    start = n - 10 - size
    if size <= 0 or start < 8:
        raise ArrowFormatError("footer size out of range")
    fb = memoryview(buf)[start:n - 10]
    footer = _Table(fb, struct.unpack_from("<I", fb, 0)[0])
    schema = footer.table(1)
    if schema is None:
        raise ArrowFormatError("footer has no schema")
    fields, _ = _read_schema(schema)
    if footer.vector(2)[1]:
        raise NotImplementedError(f"Arrow dictionary batches: {ROADMAP_ITEM}")
    bstart, count = footer.vector(3)
    blocks = []
    for i in range(count):
        off, meta_len, _pad, body_len = struct.unpack_from("<qiiq", fb, bstart + 24 * i)
        if off < 8 or meta_len <= 0 or body_len < 0 or off + meta_len + body_len > start:
            raise ArrowFormatError("record batch block outside the file")
        blocks.append((off, meta_len, body_len))
    return fields, blocks


def read_schema(path: str) -> List[Field]:
    """The schema of an Arrow IPC file (from its footer)."""
    with open(path, "rb") as f:
        return _footer(f.read())[0]


def read_file(path: str, columns: Optional[Sequence[str]] = None) -> Tuple[List[Field], Dict[str, Any]]:
    """``(fields, {name: cells})`` of an Arrow IPC file, its record batches
    concatenated; a tensor column comes back as one numpy block."""
    with open(path, "rb") as f:
        buf = f.read()
    fields, blocks = _footer(buf)
    wanted = [f for f in fields if columns is None or f.name in columns]
    parts: Dict[str, List[Any]] = {f.name: [] for f in wanted}
    for off, meta_len, body_len in blocks:
        msg, _ = _parse_message(buf, off)
        if msg.scalar(1, "B") != _H_BATCH:
            raise ArrowFormatError("a footer block is not a record batch")
        batch = msg.table(2)
        if batch.table(3) is not None:
            raise NotImplementedError(f"compressed Arrow IPC bodies: {ROADMAP_ITEM}")
        nstart, nn = batch.vector(1)
        bstart, nb = batch.vector(2)
        meta = msg.buf
        nodes = [struct.unpack_from("<qq", meta, nstart + 16 * i) for i in range(nn)]
        bufs = [struct.unpack_from("<qq", meta, bstart + 16 * i) for i in range(nb)]
        body = memoryview(buf)[off + meta_len:off + meta_len + body_len]
        reader = _BodyReader(body, nodes, bufs)
        for fld in fields:
            col = reader.column(fld)
            if fld.name in parts:
                parts[fld.name].append(col)
    out: Dict[str, Any] = {}
    for fld in wanted:
        chunks = parts[fld.name]
        if chunks and all(isinstance(c, np.ndarray) for c in chunks):
            out[fld.name] = chunks[0] if len(chunks) == 1 else np.concatenate(chunks)
        elif not chunks and fld.tensor_shape() is not None:
            item = fld.type.children[0].type
            out[fld.name] = np.zeros((0,) + fld.tensor_shape(), item.numpy())
        else:
            merged: List[Any] = []
            for c in chunks:
                merged.extend(list(c))
            out[fld.name] = merged
    return wanted, out


def valid_output(path: str) -> bool:
    """True if ``path`` is a complete, readable Arrow IPC file: the resume
    check. A torn write or garbage reads as False, so resume recomputes
    it instead of gathering it."""
    try:
        with open(path, "rb") as f:
            _footer(f.read())
        return True
    except (OSError, ValueError, struct.error, KeyError, UnicodeDecodeError):
        return False


__all__ = [
    "ArrowFormatError", "DType", "Field", "TENSOR_EXTENSION",
    "decode_arrow_schema", "infer_field", "read_file", "read_schema",
    "read_schema_message", "schema_message", "tensor_block", "tensor_field",
    "unify_field", "valid_output", "write_file", "write_partition",
]
