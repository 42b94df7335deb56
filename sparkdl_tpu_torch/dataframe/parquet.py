"""A Parquet reader and writer in numpy, for the files the DataFrame and the
batch gang worker exchange (the card's machine has no ``pyarrow``).

**Reader.** It covers what ``pyarrow`` writes with its defaults for the
JAX package's ``DataFrame.writeParquet`` (and ``pq.write_table`` with the
usual options):

- the footer (``FileMetaData`` in Thrift's compact protocol,
  ``dataframe/thrift_compact.py``) and the row-group index, with each
  group's row count, so a caller decodes only the groups it needs
  (:meth:`ParquetFile.read_rows`);
- data pages v1 and v2 and dictionary pages, compressed with Snappy,
  gzip, ZSTD or not at all (``dataframe/snappy.py``);
- the PLAIN, PLAIN_DICTIONARY / RLE_DICTIONARY encodings and the
  RLE/bit-packed hybrid of levels and dictionary indices;
- the physical types BOOLEAN, INT32, INT64, FLOAT, DOUBLE, BYTE_ARRAY
  (strings and binaries) and FIXED_LEN_BYTE_ARRAY;
- definition levels (nulls), one struct level (the image struct) and one
  list level (repetition levels) for Arrow lists and FixedShapeTensor
  columns. The ``ARROW:schema`` key-value entry, the base64 IPC schema
  ``pyarrow`` stores, is parsed (``dataframe/arrow_ipc.py``) to recover
  Arrow's types: a FixedShapeTensor column reads back as one contiguous
  numpy block ``(rows, *shape)``, every other column as the Python
  values ``to_pylist`` gives.

**Writer.** :class:`ParquetWriter` writes PLAIN-encoded v1 data pages,
Snappy-compressed (the default) or uncompressed, one row group per
:meth:`~ParquetWriter.write` call, and the ``ARROW:schema`` entry, so
``pyarrow`` and the JAX package's ``readParquet`` read tensor columns
back as FixedShapeTensor.

Anything else (the DELTA_* and BYTE_STREAM_SPLIT encodings, INT96,
decimal and temporal annotations, maps, nesting deeper than one struct or
one list level, the LZ4, BROTLI and LZO codecs, writing ZSTD) raises
NotImplementedError naming ROADMAP Queue A item 11. ZSTD pages are read.
"""

from __future__ import annotations

import base64
import struct
from dataclasses import dataclass, field as dc_field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from sparkdl_tpu_torch.dataframe import arrow_ipc, snappy
from sparkdl_tpu_torch.dataframe import thrift_compact as tc
from sparkdl_tpu_torch.dataframe.arrow_ipc import DType, Field
from sparkdl_tpu_torch.dataframe.snappy import ROADMAP_ITEM

MAGIC = b"PAR1"

# Parquet Type
BOOLEAN, INT32, INT64, INT96, FLOAT, DOUBLE, BYTE_ARRAY, FLBA = range(8)
_TYPE_NAMES = ["BOOLEAN", "INT32", "INT64", "INT96", "FLOAT", "DOUBLE",
               "BYTE_ARRAY", "FIXED_LEN_BYTE_ARRAY"]
# FieldRepetitionType
REQUIRED, OPTIONAL, REPEATED = 0, 1, 2
# Encoding
PLAIN, PLAIN_DICTIONARY, RLE, BIT_PACKED = 0, 2, 3, 4
RLE_DICTIONARY = 8
_ENCODING_NAMES = {0: "PLAIN", 2: "PLAIN_DICTIONARY", 3: "RLE", 4: "BIT_PACKED",
                   5: "DELTA_BINARY_PACKED", 6: "DELTA_LENGTH_BYTE_ARRAY",
                   7: "DELTA_BYTE_ARRAY", 8: "RLE_DICTIONARY",
                   9: "BYTE_STREAM_SPLIT"}
# PageType
DATA_PAGE, INDEX_PAGE, DICTIONARY_PAGE, DATA_PAGE_V2 = range(4)
# ConvertedType
_UTF8, _MAP, _MAP_KV, _LIST = 0, 1, 2, 3
_INT_CONVERTED = {(8, True): 15, (16, True): 16, (32, True): 17, (64, True): 18,
                  (8, False): 11, (16, False): 12, (32, False): 13, (64, False): 14}
# LogicalType union members this reader accepts without Arrow's help
_LOGICAL_STRING, _LOGICAL_LIST, _LOGICAL_INT, _LOGICAL_NULL = 1, 3, 10, 11
_LOGICAL_OK = {_LOGICAL_STRING, _LOGICAL_LIST, _LOGICAL_INT, _LOGICAL_NULL}
_CODECS = {"snappy": snappy.SNAPPY, "none": snappy.UNCOMPRESSED,
           "uncompressed": snappy.UNCOMPRESSED, "gzip": snappy.GZIP}


def _refuse(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not supported by sparkdl_tpu_torch's Parquet reader and "
        f"writer: {ROADMAP_ITEM}"
    )


# -- the RLE / bit-packed hybrid ---------------------------------------------------


def _varint(buf, pos: int) -> Tuple[int, int]:
    shift = out = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def _unpack_bits(data, bit_width: int, count: int) -> np.ndarray:
    """``count`` little-endian bit-packed values of ``bit_width`` bits."""
    if bit_width == 0:
        return np.zeros(count, np.int64)
    bits = np.unpackbits(np.frombuffer(data, np.uint8), bitorder="little")
    bits = bits[:count * bit_width].reshape(count, bit_width).astype(np.int64)
    return bits @ (np.int64(1) << np.arange(bit_width, dtype=np.int64))


def decode_hybrid(buf, pos: int, end: int, bit_width: int, count: int) -> np.ndarray:
    """Decode ``count`` values of the RLE/bit-packed hybrid in ``buf[pos:end]``."""
    out = np.empty(count, np.int64)
    got = 0
    vbytes = (bit_width + 7) // 8
    while got < count:
        if pos >= end:
            raise ValueError("RLE/bit-packed data ends before its values")
        head, pos = _varint(buf, pos)
        if head & 1:
            groups = head >> 1
            nbytes = groups * bit_width
            vals = _unpack_bits(buf[pos:pos + nbytes], bit_width, groups * 8)
            pos += nbytes
        else:
            run = head >> 1
            value = int.from_bytes(buf[pos:pos + vbytes], "little")
            pos += vbytes
            vals = np.full(run, value, np.int64)
        take = min(len(vals), count - got)
        out[got:got + take] = vals[:take]
        got += take
    return out


def encode_rle(levels: np.ndarray, bit_width: int) -> bytes:
    """Levels as RLE runs of the hybrid (one run per stretch of equal
    values)."""
    out = bytearray()
    n = len(levels)
    if not n:
        return bytes(out)
    vbytes = (bit_width + 7) // 8
    change = np.flatnonzero(np.diff(levels)) + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [n]])
    for s, e in zip(starts.tolist(), ends.tolist()):
        head = (e - s) << 1
        while True:
            b = head & 0x7F
            head >>= 7
            out.append(b | 0x80 if head else b)
            if not head:
                break
        out += int(levels[s]).to_bytes(vbytes, "little")
    return bytes(out)


# -- PLAIN values -------------------------------------------------------------------


_NP_OF = {INT32: np.dtype("<i4"), INT64: np.dtype("<i8"), FLOAT: np.dtype("<f4"),
          DOUBLE: np.dtype("<f8")}


def decode_plain(buf, ptype: int, count: int, type_length: int = 0):
    """``count`` PLAIN values: a numpy array for fixed-width types, a list
    of ``bytes`` for byte arrays."""
    if ptype == BOOLEAN:
        bits = np.unpackbits(np.frombuffer(buf, np.uint8), bitorder="little")
        return bits[:count].astype(bool)
    if ptype in _NP_OF:
        return np.frombuffer(buf, _NP_OF[ptype], count=count)
    if ptype == BYTE_ARRAY:
        out, pos = [], 0
        mv = memoryview(buf)
        for _ in range(count):
            n = struct.unpack_from("<I", mv, pos)[0]
            out.append(bytes(mv[pos + 4:pos + 4 + n]))
            pos += 4 + n
        return out
    if ptype == FLBA:
        mv = bytes(buf)
        return [mv[i * type_length:(i + 1) * type_length] for i in range(count)]
    raise _refuse(f"the physical type {_TYPE_NAMES[ptype]}")


def encode_plain(ptype: int, values) -> bytes:
    if ptype == BOOLEAN:
        return np.packbits(np.asarray(values, bool).astype(np.uint8), bitorder="little").tobytes()
    if ptype in _NP_OF:
        return np.ascontiguousarray(values, _NP_OF[ptype]).tobytes()
    if ptype == BYTE_ARRAY:
        return b"".join(struct.pack("<I", len(v)) + v for v in values)
    raise _refuse(f"writing the physical type {_TYPE_NAMES[ptype]}")


# -- the schema -----------------------------------------------------------------------


@dataclass
class _Node:
    name: str
    repetition: int
    ptype: Optional[int] = None  # None for a group
    type_length: int = 0
    converted: Optional[int] = None
    logical: Dict[int, Any] = dc_field(default_factory=dict)
    children: List["_Node"] = dc_field(default_factory=list)

    @property
    def is_list(self) -> bool:
        return self.converted == _LIST or _LOGICAL_LIST in self.logical


@dataclass
class _Leaf:
    path: List[str]
    node: _Node
    max_def: int
    max_rep: int


@dataclass
class _Column:
    """One top-level column: how its leaves assemble into cells."""

    name: str
    kind: str  # "prim", "struct", "list"
    leaves: List[_Leaf]
    def_level: int = 0  # definition level at which the column itself is present
    arrow: Optional[Field] = None


def _parse_schema(elements: List[dict]) -> List[_Node]:
    pos = 0

    def build() -> _Node:
        nonlocal pos
        el = elements[pos]
        pos += 1
        node = _Node(
            name=el[4].decode("utf-8"), repetition=el.get(3, REQUIRED),
            ptype=el.get(1), type_length=el.get(2, 0), converted=el.get(6),
            logical=el.get(10) or {},
        )
        for _ in range(el.get(5, 0) or 0):
            node.children.append(build())
        if node.ptype is None and not node.children and el.get(5) is None:
            raise ValueError(f"schema element {node.name!r} has no type")
        return node

    root = build()
    return root.children


def _leaf_checks(node: _Node, where: str) -> None:
    if node.ptype == INT96:
        raise _refuse(f"INT96 (column {where})")
    bad = set(node.logical) - _LOGICAL_OK
    if bad or (node.converted is not None and node.converted not in (
            _UTF8, *_INT_CONVERTED.values())):
        raise _refuse(f"the logical annotation of column {where}")


def _columns_of(nodes: List[_Node], arrow: Dict[str, Field]) -> List[_Column]:
    cols = []
    for n in nodes:
        opt = 1 if n.repetition == OPTIONAL else 0
        if n.repetition == REPEATED:
            raise _refuse(f"a repeated top-level field ({n.name})")
        if n.ptype is not None:
            _leaf_checks(n, n.name)
            cols.append(_Column(n.name, "prim", [_Leaf([n.name], n, opt, 0)], opt))
        elif n.is_list:
            rep = n.children[0] if len(n.children) == 1 else None
            if rep is None or rep.repetition != REPEATED:
                raise _refuse(f"the list layout of column {n.name}")
            if rep.ptype is not None:  # the two-level legacy form
                leaf, path, max_def = rep, [n.name, rep.name], opt + 1
            else:
                if len(rep.children) != 1 or rep.children[0].ptype is None:
                    raise _refuse(f"nesting deeper than one list level ({n.name})")
                leaf = rep.children[0]
                path = [n.name, rep.name, leaf.name]
                max_def = opt + 1 + (1 if leaf.repetition == OPTIONAL else 0)
            _leaf_checks(leaf, n.name)
            cols.append(_Column(n.name, "list", [_Leaf(path, leaf, max_def, 1)], opt))
        else:
            if n.converted in (_MAP, _MAP_KV) or 2 in n.logical:
                raise _refuse(f"the map column {n.name}")
            leaves = []
            for c in n.children:
                if c.ptype is None or c.repetition == REPEATED:
                    raise _refuse(f"nesting deeper than one struct level ({n.name}.{c.name})")
                _leaf_checks(c, f"{n.name}.{c.name}")
                leaves.append(_Leaf([n.name, c.name], c,
                                    opt + (1 if c.repetition == OPTIONAL else 0), 0))
            cols.append(_Column(n.name, "struct", leaves, opt))
        cols[-1].arrow = arrow.get(n.name)
    return cols


# -- reading ----------------------------------------------------------------------------


def _cell_of(node: _Node, arrow_type: Optional[DType]):
    """A converter of one leaf's decoded values to Python cells."""
    utf8 = (node.converted == _UTF8 or _LOGICAL_STRING in node.logical
            or (arrow_type is not None and arrow_type.kind in ("utf8", "large_utf8")))
    if node.ptype in (BYTE_ARRAY, FLBA):
        if arrow_type is not None and arrow_type.kind == "float" and arrow_type.bits == 16:
            return lambda vals: np.frombuffer(b"".join(vals), "<f2").tolist()
        if utf8:
            return lambda vals: [v.decode("utf-8") for v in vals]
        return list
    return lambda vals: vals.tolist()


class ParquetFile:
    """A Parquet file opened at its footer. Row groups are read on demand,
    one column chunk at a time."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            f.seek(0, 2)
            size = f.tell()
            if size < 12:
                raise ValueError(f"{path}: too short for a Parquet file")
            f.seek(size - 8)
            tail = f.read(8)
            if tail[4:] != MAGIC:
                raise ValueError(f"{path}: no Parquet magic at the end")
            n = struct.unpack("<I", tail[:4])[0]
            f.seek(size - 8 - n)
            footer = f.read(n)
        meta, _ = tc.read_struct(footer)
        self.num_rows = int(meta.get(3, 0))
        self.row_groups: List[dict] = meta.get(4) or []
        self.key_value = {kv[1].decode(): (kv.get(2) or b"").decode()
                          for kv in meta.get(5) or []}
        arrow_fields: Dict[str, Field] = {}
        if "ARROW:schema" in self.key_value:
            for f_ in arrow_ipc.decode_arrow_schema(self.key_value["ARROW:schema"]):
                arrow_fields[f_.name] = f_
        self.columns = _columns_of(_parse_schema(meta[2]), arrow_fields)
        self._by_name = {c.name: c for c in self.columns}

    @property
    def column_names(self) -> List[str]:
        return [c.name for c in self.columns]

    def row_group_rows(self) -> List[int]:
        return [int(rg[3]) for rg in self.row_groups]

    def row_group_spans(self) -> List[Tuple[int, int]]:
        spans, row = [], 0
        for n in self.row_group_rows():
            spans.append((row, row + n))
            row += n
        return spans

    # -- column chunks --------------------------------------------------------

    def _chunk_meta(self, rg: dict, path: List[str]) -> dict:
        for chunk in rg[1]:
            md = chunk.get(3)
            if md is not None and [p.decode() for p in md[3]] == path:
                return md
        raise KeyError(f"row group has no column chunk {'.'.join(path)}")

    def _read_leaf(self, f, rg: dict, leaf: _Leaf):
        """(def levels, rep levels, values) of one leaf in one row group;
        levels are None where the maximum level is 0."""
        md = self._chunk_meta(rg, leaf.path)
        codec = md[4]
        total = int(md[5])
        start = int(md[9])
        dict_off = md.get(11)
        if dict_off:
            start = min(start, int(dict_off))
        f.seek(start)
        data = f.read(int(md[7]))
        ptype, tlen = leaf.node.ptype, leaf.node.type_length
        dictionary = None
        defs, reps, vals = [], [], []
        seen = pos = 0
        dbits = int(leaf.max_def).bit_length()
        rbits = int(leaf.max_rep).bit_length()
        while seen < total:
            header, pos = tc.read_struct(data, pos)
            ptype_page = header[1]
            comp_size, raw_size = header[3], header[2]
            body = data[pos:pos + comp_size]
            pos += comp_size
            if ptype_page == DICTIONARY_PAGE:
                dh = header[7]
                if dh.get(2, PLAIN) not in (PLAIN, PLAIN_DICTIONARY):
                    raise _refuse(f"the dictionary encoding {_ENCODING_NAMES.get(dh[2])}")
                raw = snappy.decompress(codec, body, raw_size)
                dictionary = decode_plain(raw, ptype, dh[1], tlen)
                continue
            if ptype_page == DATA_PAGE:
                dh = header[5]
                count, enc = dh[1], dh[2]
                raw = snappy.decompress(codec, body, raw_size)
                p = 0
                for bits, out, enc_slot in ((rbits, reps, 4), (dbits, defs, 3)):
                    if bits:
                        if dh.get(enc_slot, RLE) != RLE:
                            raise _refuse("BIT_PACKED levels")
                        n = struct.unpack_from("<I", raw, p)[0]
                        out.append(decode_hybrid(raw, p + 4, p + 4 + n, bits, count))
                        p += 4 + n
                values_raw = memoryview(raw)[p:]
            elif ptype_page == DATA_PAGE_V2:
                dh = header[8]
                count, enc = dh[1], dh[4]
                rlen, dlen = dh.get(6, 0), dh.get(5, 0)
                if rbits:
                    reps.append(decode_hybrid(body, 0, rlen, rbits, count))
                if dbits:
                    defs.append(decode_hybrid(body, rlen, rlen + dlen, dbits, count))
                rest = body[rlen + dlen:]
                if dh.get(7, True):
                    values_raw = memoryview(
                        snappy.decompress(codec, rest, raw_size - rlen - dlen))
                else:
                    values_raw = memoryview(rest)
            else:
                continue  # an index page carries no values
            present = count
            if dbits:
                present = int((defs[-1] == leaf.max_def).sum())
            if enc == PLAIN:
                vals.append(decode_plain(values_raw, ptype, present, tlen))
            elif enc in (PLAIN_DICTIONARY, RLE_DICTIONARY):
                if dictionary is None:
                    raise ValueError("a dictionary-encoded page with no dictionary page")
                width = values_raw[0] if len(values_raw) else 0
                idx = decode_hybrid(values_raw, 1, len(values_raw), width, present)
                if isinstance(dictionary, np.ndarray):
                    vals.append(dictionary[idx])
                else:
                    vals.append([dictionary[i] for i in idx.tolist()])
            elif enc == RLE and ptype == BOOLEAN:  # length-prefixed, width 1
                n = struct.unpack_from("<I", values_raw, 0)[0]
                vals.append(decode_hybrid(values_raw, 4, 4 + n, 1, present).astype(bool))
            else:
                raise _refuse(f"the encoding {_ENCODING_NAMES.get(enc, enc)}")
            seen += count
        if vals and isinstance(vals[0], np.ndarray):
            values = np.concatenate(vals) if len(vals) > 1 else vals[0]
        else:
            values = [v for chunk in vals for v in chunk]
        return (np.concatenate(defs) if defs else None,
                np.concatenate(reps) if reps else None, values)

    def _assemble(self, f, rg: dict, col: _Column):
        n = int(rg[3])
        if col.kind == "prim":
            leaf = col.leaves[0]
            d, _, vals = self._read_leaf(f, rg, leaf)
            cell = _cell_of(leaf.node, col.arrow.type if col.arrow else None)
            if col.arrow is not None and col.arrow.type.kind == "null":
                return [None] * n
            return _place(d, leaf.max_def, cell(vals), n)
        if col.kind == "struct":
            kids = []
            arrow_kids = {c.name: c for c in col.arrow.type.children} if col.arrow else {}
            for leaf in col.leaves:
                d, _, vals = self._read_leaf(f, rg, leaf)
                at = arrow_kids.get(leaf.path[-1])
                cell = _cell_of(leaf.node, at.type if at else None)
                cells = _place(d, leaf.max_def, cell(vals), n)
                kids.append((leaf.path[-1], cells, d))
            out = []
            for i in range(n):
                if col.def_level and kids and kids[0][2] is not None and kids[0][2][i] < col.def_level:
                    out.append(None)
                else:
                    out.append({name: cells[i] for name, cells, _ in kids})
            return out
        leaf = col.leaves[0]
        d, r, vals = self._read_leaf(f, rg, leaf)
        shape = col.arrow.tensor_shape() if col.arrow is not None else None
        if shape is not None and isinstance(vals, np.ndarray):
            size = int(np.prod(shape))
            if d is None or bool((d == leaf.max_def).all()):
                if len(vals) == n * size:
                    dtype = col.arrow.type.children[0].type.numpy()
                    return vals.astype(dtype, copy=False).reshape((n,) + shape)
        at = col.arrow.type.children[0].type if col.arrow is not None and col.arrow.type.children else None
        cells = _cell_of(leaf.node, at)(vals)
        return _assemble_lists(d, r, cells, leaf.max_def, col.def_level, n)

    def read_row_group(self, index: int, columns: Optional[Sequence[str]] = None) -> Dict[str, Any]:
        rg = self.row_groups[index]
        names = self.column_names if columns is None else list(columns)
        with open(self.path, "rb") as f:
            return {name: self._assemble(f, rg, self._by_name[name]) for name in names}

    def read_rows(self, lo: int, hi: int, columns: Optional[Sequence[str]] = None,
                  on_group=None) -> Dict[str, Any]:
        """Rows ``[lo, hi)``, decoding only the row groups that meet the
        span (``on_group(index)`` sees each one decoded)."""
        names = self.column_names if columns is None else list(columns)
        parts: Dict[str, List[Any]] = {c: [] for c in names}
        for r, (b0, b1) in enumerate(self.row_group_spans()):
            s, e = max(lo, b0), min(hi, b1)
            if s >= e:
                continue
            if on_group is not None:
                on_group(r)
            got = self.read_row_group(r, names)
            for c in names:
                parts[c].append(got[c][s - b0:e - b0])
        return {c: _concat(parts[c], self._by_name[c]) for c in names}

    def read(self, columns: Optional[Sequence[str]] = None) -> Dict[str, Any]:
        return self.read_rows(0, self.num_rows, columns)


def _empty_cells(col: _Column):
    shape = col.arrow.tensor_shape() if col.arrow is not None else None
    if shape is not None:
        return np.zeros((0,) + shape, col.arrow.type.children[0].type.numpy())
    return []


def _concat(chunks: List[Any], col: _Column):
    if not chunks:
        return _empty_cells(col)
    if all(isinstance(c, np.ndarray) for c in chunks):
        return chunks[0] if len(chunks) == 1 else np.concatenate(chunks)
    out: List[Any] = []
    for c in chunks:
        out.extend(list(c))
    return out


def _place(defs: Optional[np.ndarray], max_def: int, cells: list, n: int) -> list:
    if defs is None:
        return list(cells)
    out = [None] * n
    it = iter(cells)
    for i in np.flatnonzero(defs == max_def).tolist():
        out[i] = next(it)
    return out


def _assemble_lists(defs, reps, cells, max_def: int, list_def: int, n: int) -> list:
    """Rows of one list level from its leaf's levels: a row starts at each
    repetition level 0; a definition level below ``list_def`` is a null
    row, equal to it an empty list, below ``max_def`` a null element."""
    out: List[Any] = []
    it = iter(cells)
    row = None
    for d, r in zip(defs.tolist(), reps.tolist()):
        if r == 0:
            if row is not None:
                out.append(row)
            if d < list_def:
                row = None
                out.append(None)
                continue
            row = []
            if d == list_def:
                continue
        if row is None:
            raise ValueError("a repeated entry continues a null list")
        row.append(next(it) if d == max_def else None)
    if row is not None:
        out.append(row)
    if len(out) != n:
        raise ValueError(f"assembled {len(out)} lists for {n} rows")
    return out


# -- writing --------------------------------------------------------------------------------


def _leaf_schema(name: str, t: DType, repetition: int) -> list:
    """The SchemaElement fields of a primitive leaf of Arrow type ``t``."""
    logical = None
    converted = None
    if t.kind == "bool":
        ptype = BOOLEAN
    elif t.kind == "int":
        ptype = INT64 if t.bits == 64 else INT32
        if not (t.bits == 64 and t.signed):
            converted = _INT_CONVERTED[(t.bits, t.signed)]
            logical = [(_LOGICAL_INT, tc.STRUCT, [(1, tc.BYTE, t.bits), (2, tc.BOOL, t.signed)])]
    elif t.kind == "float" and t.bits in (32, 64):
        ptype = FLOAT if t.bits == 32 else DOUBLE
    elif t.kind == "utf8":
        ptype, converted = BYTE_ARRAY, _UTF8
        logical = [(_LOGICAL_STRING, tc.STRUCT, [])]
    elif t.kind == "binary":
        ptype = BYTE_ARRAY
    elif t.kind == "null":
        ptype = INT32
        logical = [(_LOGICAL_NULL, tc.STRUCT, [])]
    else:
        raise _refuse(f"writing the Arrow type {t.kind}{t.bits or ''} in column {name}")
    return [(1, tc.I32, ptype), (3, tc.I32, repetition), (4, tc.BINARY, name),
            (6, tc.I32, converted), (10, tc.STRUCT, logical)]


def _schema_elements(fields: List[Field]) -> Tuple[list, List[Tuple[List[str], DType]]]:
    elements = [[(4, tc.BINARY, "schema"), (5, tc.I32, len(fields))]]
    leaves: List[Tuple[List[str], DType]] = []
    for f in fields:
        t = f.type
        if t.kind == "struct":
            elements.append([(3, tc.I32, OPTIONAL), (4, tc.BINARY, f.name),
                             (5, tc.I32, len(t.children))])
            for c in t.children:
                if c.type.kind in ("struct", "list", "fixed_size_list"):
                    raise _refuse(f"nesting deeper than one struct level ({f.name}.{c.name})")
                elements.append(_leaf_schema(c.name, c.type, OPTIONAL))
                leaves.append(([f.name, c.name], c.type))
        elif t.kind in ("list", "fixed_size_list"):
            item = t.children[0].type
            if item.kind in ("struct", "list", "fixed_size_list"):
                raise _refuse(f"nesting deeper than one list level ({f.name})")
            elements.append([(3, tc.I32, OPTIONAL), (4, tc.BINARY, f.name),
                             (5, tc.I32, 1), (6, tc.I32, _LIST),
                             (10, tc.STRUCT, [(_LOGICAL_LIST, tc.STRUCT, [])])])
            elements.append([(3, tc.I32, REPEATED), (4, tc.BINARY, "list"), (5, tc.I32, 1)])
            elements.append(_leaf_schema("element", item, OPTIONAL))
            leaves.append(([f.name, "list", "element"], item))
        else:
            elements.append(_leaf_schema(f.name, t, OPTIONAL))
            leaves.append(([f.name], t))
    return elements, leaves


def _leaf_levels(f: Field, values) -> List[Tuple[np.ndarray, Optional[np.ndarray], Any]]:
    """Per leaf of field ``f``: (def levels, rep levels or None, present values)."""
    t = f.type
    n = len(values)
    if t.kind == "struct":
        out = []
        for c in t.children:
            defs = np.zeros(n, np.int64)
            vals = []
            for i, v in enumerate(values):
                if v is None:
                    continue
                x = v.get(c.name)
                if x is None:
                    defs[i] = 1
                else:
                    defs[i] = 2
                    vals.append(x)
            out.append((defs, None, vals))
        return out
    if t.kind in ("list", "fixed_size_list"):
        block = values if isinstance(values, np.ndarray) else arrow_ipc.tensor_block(values)
        if block is not None and t.kind == "fixed_size_list":
            size = t.size
            defs = np.full(n * size, 3, np.int64)
            reps = np.ones(n * size, np.int64)
            reps[::size] = 0
            return [(defs, reps, block.reshape(-1))]
        defs, reps, vals = [], [], []
        for v in values:
            if v is None:
                defs.append(0)
                reps.append(0)
                continue
            items = v.reshape(-1).tolist() if isinstance(v, np.ndarray) else list(v)
            if not items:
                defs.append(1)
                reps.append(0)
                continue
            for j, x in enumerate(items):
                reps.append(0 if j == 0 else 1)
                if x is None:
                    defs.append(2)
                else:
                    defs.append(3)
                    vals.append(x)
        return [(np.asarray(defs, np.int64), np.asarray(reps, np.int64), vals)]
    if isinstance(values, np.ndarray):
        return [(np.ones(n, np.int64), None, values)]
    defs = np.fromiter((v is not None for v in values), np.int64, n)
    return [(defs, None, [v for v in values if v is not None])]


def _plain_values(t: DType, vals) -> Tuple[int, bytes]:
    if t.kind == "utf8":
        return BYTE_ARRAY, encode_plain(BYTE_ARRAY, [v.encode("utf-8") for v in vals])
    if t.kind == "binary":
        return BYTE_ARRAY, encode_plain(BYTE_ARRAY, [bytes(v) for v in vals])
    if t.kind == "bool":
        return BOOLEAN, encode_plain(BOOLEAN, vals)
    if t.kind == "null":
        return INT32, b""
    if t.kind == "int":
        ptype = INT64 if t.bits == 64 else INT32
        arr = np.asarray(vals, t.numpy()).astype(_NP_OF[ptype])
        return ptype, arr.tobytes()
    ptype = FLOAT if t.bits == 32 else DOUBLE
    return ptype, np.asarray(vals, _NP_OF[ptype]).tobytes()


class ParquetWriter:
    """Streams row groups into one Parquet file. The schema is fixed by
    the first :meth:`write` (or by ``fields``)."""

    def __init__(self, path: str, fields: Optional[List[Field]] = None,
                 compression: str = "snappy"):
        if compression.lower() not in _CODECS:
            raise _refuse(f"the codec {compression!r}")
        self.path = path
        self.codec = _CODECS[compression.lower()]
        self.fields = fields
        self._row_groups: List[list] = []
        self._num_rows = 0
        self._f = open(path, "wb")
        self._f.write(MAGIC)

    def write(self, columns: Dict[str, Any]) -> None:
        """One row group of ``columns`` (name -> cells or block)."""
        if self.fields is None:
            self.fields = [arrow_ipc.infer_field(c, v) for c, v in columns.items()]
        n = len(columns[self.fields[0].name]) if self.fields else 0
        chunks, total_raw, total_comp = [], 0, 0
        rg_start = self._f.tell()
        _, leaves = _schema_elements(self.fields)
        li = 0
        for f in self.fields:
            for defs, reps, vals in _leaf_levels(f, columns[f.name]):
                path, t = leaves[li]
                li += 1
                chunk, raw, comp = self._write_chunk(path, t, defs, reps, vals,
                                                     max_def=3 if reps is not None else
                                                     (2 if len(path) == 2 else 1))
                chunks.append(chunk)
                total_raw += raw
                total_comp += comp
        self._row_groups.append([
            (1, tc.LIST, (tc.STRUCT, chunks)), (2, tc.I64, total_raw),
            (3, tc.I64, n), (5, tc.I64, rg_start), (6, tc.I64, total_comp),
            (7, tc.I16, len(self._row_groups)),
        ])
        self._num_rows += n

    def _write_chunk(self, path, t: DType, defs, reps, vals, max_def: int):
        ptype, values = _plain_values(t, vals)
        body = bytearray()
        if reps is not None:
            enc = encode_rle(reps, 1)
            body += struct.pack("<I", len(enc)) + enc
        enc = encode_rle(defs, int(max_def).bit_length())
        body += struct.pack("<I", len(enc)) + enc
        body += values
        comp = snappy.compress(self.codec, body)
        header = tc.write_struct([
            (1, tc.I32, DATA_PAGE), (2, tc.I32, len(body)), (3, tc.I32, len(comp)),
            (5, tc.STRUCT, [(1, tc.I32, len(defs)), (2, tc.I32, PLAIN),
                            (3, tc.I32, RLE), (4, tc.I32, RLE)]),
        ])
        offset = self._f.tell()
        self._f.write(header)
        self._f.write(comp)
        raw_size = len(header) + len(body)
        comp_size = len(header) + len(comp)
        meta = [
            (1, tc.I32, ptype), (2, tc.LIST, (tc.I32, [PLAIN, RLE])),
            (3, tc.LIST, (tc.BINARY, list(path))), (4, tc.I32, self.codec),
            (5, tc.I64, len(defs)), (6, tc.I64, raw_size), (7, tc.I64, comp_size),
            (9, tc.I64, offset),
        ]
        return [(2, tc.I64, offset), (3, tc.STRUCT, meta)], raw_size, comp_size

    def close(self) -> None:
        if self._f is None:
            return
        elements, _ = _schema_elements(self.fields or [])
        arrow_schema = base64.b64encode(arrow_ipc.schema_message(self.fields or [])).decode()
        footer = tc.write_struct([
            (1, tc.I32, 2),
            (2, tc.LIST, (tc.STRUCT, elements)),
            (3, tc.I64, self._num_rows),
            (4, tc.LIST, (tc.STRUCT, self._row_groups)),
            (5, tc.LIST, (tc.STRUCT, [[(1, tc.BINARY, "ARROW:schema"),
                                       (2, tc.BINARY, arrow_schema)]])),
            (6, tc.BINARY, "sparkdl_tpu_torch"),
        ])
        self._f.write(footer)
        self._f.write(struct.pack("<I", len(footer)))
        self._f.write(MAGIC)
        self._f.close()
        self._f = None

    def __enter__(self) -> "ParquetWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


__all__ = [
    "ParquetFile", "ParquetWriter", "ROADMAP_ITEM", "decode_hybrid", "encode_rle",
]
