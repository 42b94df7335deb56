"""The Thrift compact protocol, both ways, for Parquet's metadata.

Parquet encodes its footer (``FileMetaData`` and everything under it) and
every page header in Thrift's compact protocol. The protocol is
self-describing up to the struct level: each field carries its id and
wire type, so :func:`read_struct` decodes any struct into a plain
``{field_id: value}`` dict (nested structs as dicts, lists as lists,
strings and binaries as ``bytes``) and skips nothing it does not know,
which keeps the reader indifferent to fields newer writers add.

Writing needs the wire types, so :func:`write_struct` takes a list of
``(field_id, wire_type, value)`` triples, with ``(element_type, items)``
for a list and a nested triple list for a struct; a ``None`` value leaves
the field out. The Parquet field ids live in ``dataframe/parquet.py``.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple

# compact-protocol wire types
STOP, TRUE, FALSE, BYTE, I16, I32, I64, DOUBLE, BINARY, LIST, SET, MAP, STRUCT = range(13)
#: the type a writer names a bool field by (the wire carries TRUE/FALSE)
BOOL = TRUE


class ThriftError(ValueError):
    """Malformed or truncated compact-protocol data."""


def _varint(buf, pos: int) -> Tuple[int, int]:
    shift = result = 0
    while True:
        if pos >= len(buf):
            raise ThriftError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ThriftError("varint too long")


def _zigzag(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


def _read_value(buf, pos: int, ttype: int) -> Tuple[Any, int]:
    if ttype == TRUE:
        return True, pos
    if ttype == FALSE:
        return False, pos
    if ttype == BYTE:
        if pos >= len(buf):
            raise ThriftError("truncated byte")
        v = buf[pos]
        return (v - 256 if v > 127 else v), pos + 1
    if ttype in (I16, I32, I64):
        v, pos = _varint(buf, pos)
        return _zigzag(v), pos
    if ttype == DOUBLE:
        if pos + 8 > len(buf):
            raise ThriftError("truncated double")
        return struct.unpack_from("<d", buf, pos)[0], pos + 8
    if ttype == BINARY:
        n, pos = _varint(buf, pos)
        if pos + n > len(buf):
            raise ThriftError("truncated binary")
        return bytes(buf[pos:pos + n]), pos + n
    if ttype in (LIST, SET):
        if pos >= len(buf):
            raise ThriftError("truncated list header")
        head = buf[pos]
        pos += 1
        size, etype = head >> 4, head & 0x0F
        if size == 15:
            size, pos = _varint(buf, pos)
        items = []
        for _ in range(size):
            if etype in (TRUE, FALSE):
                # a bool element is one byte of its own (1 true, else false)
                items.append(buf[pos] == TRUE)
                pos += 1
            else:
                v, pos = _read_value(buf, pos, etype)
                items.append(v)
        return items, pos
    if ttype == MAP:
        size, pos = _varint(buf, pos)
        if not size:
            return {}, pos
        kv = buf[pos]
        pos += 1
        out = {}
        for _ in range(size):
            k, pos = _read_value(buf, pos, kv >> 4)
            v, pos = _read_value(buf, pos, kv & 0x0F)
            out[k] = v
        return out, pos
    if ttype == STRUCT:
        return read_struct(buf, pos)
    raise ThriftError(f"unknown compact type {ttype}")


def read_struct(buf, pos: int = 0) -> Tuple[Dict[int, Any], int]:
    """Decode one struct at ``pos``: ``({field_id: value}, end)``."""
    out: Dict[int, Any] = {}
    last = 0
    while True:
        if pos >= len(buf):
            raise ThriftError("truncated struct")
        head = buf[pos]
        pos += 1
        ttype = head & 0x0F
        if ttype == STOP:
            return out, pos
        delta = head >> 4
        if delta:
            fid = last + delta
        else:
            raw, pos = _varint(buf, pos)
            fid = _zigzag(raw)
        out[fid], pos = _read_value(buf, pos, ttype)
        last = fid


# -- writing ------------------------------------------------------------------


def _put_varint(out: bytearray, n: int) -> None:
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _put_zigzag(out: bytearray, n: int) -> None:
    _put_varint(out, (n << 1) ^ (n >> 63))


def _put_value(out: bytearray, ttype: int, value: Any) -> None:
    if ttype == BYTE:
        out.append(value & 0xFF)
    elif ttype in (I16, I32, I64):
        _put_zigzag(out, int(value))
    elif ttype == DOUBLE:
        out += struct.pack("<d", value)
    elif ttype == BINARY:
        data = value.encode() if isinstance(value, str) else bytes(value)
        _put_varint(out, len(data))
        out += data
    elif ttype == LIST:
        etype, items = value
        if len(items) < 15:
            out.append((len(items) << 4) | etype)
        else:
            out.append(0xF0 | etype)
            _put_varint(out, len(items))
        for item in items:
            if etype == BOOL:
                out.append(TRUE if item else FALSE)
            else:
                _put_value(out, etype, item)
    elif ttype == STRUCT:
        _put_struct(out, value)
    else:
        raise ThriftError(f"cannot write compact type {ttype}")


def _put_struct(out: bytearray, fields: List[Tuple[int, int, Any]]) -> None:
    last = 0
    for fid, ttype, value in fields:
        if value is None:
            continue
        wire = (TRUE if value else FALSE) if ttype == BOOL else ttype
        delta = fid - last
        if 0 < delta <= 15:
            out.append((delta << 4) | wire)
        else:
            out.append(wire)
            _put_zigzag(out, fid)
        if ttype != BOOL:
            _put_value(out, ttype, value)
        last = fid
    out.append(STOP)


def write_struct(fields: List[Tuple[int, int, Any]]) -> bytes:
    """Encode a struct given as ``(field_id, wire_type, value)`` triples in
    ascending field-id order."""
    out = bytearray()
    _put_struct(out, fields)
    return bytes(out)


__all__ = [
    "BINARY", "BOOL", "BYTE", "DOUBLE", "I16", "I32", "I64", "LIST", "MAP",
    "STRUCT", "ThriftError", "read_struct", "write_struct",
]
