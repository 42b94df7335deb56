"""A reader of the HDF5 files that h5py and Keras 3 write by default, in
numpy alone (it never imports h5py).

The card's machine has neither h5py nor keras, so the port reads Keras
weight stores (``.keras`` archives, legacy ``.h5`` model and weight
files, ``.weights.h5``) itself. The reader covers what those writers emit
with h5py's default settings (HDF5 File Format Specification, version
3.0):

- superblock version 0 or 1, with a user block before it if any;
- version 1 object headers, their continuation blocks included;
- symbol-table groups: version 1 B-trees of group nodes, symbol nodes
  (SNOD) and local heaps;
- the dataspace, datatype, fill value, data layout (version 3, compact
  and contiguous), attribute (versions 1 to 3), symbol table and
  continuation messages;
- fixed-point, IEEE float, fixed-length string and variable-length
  string datatypes, little- or big-endian; variable-length strings come
  from global heap collections (GCOL); opaque data (what h5py writes for
  bfloat16) as raw ``V<n>`` elements.

Anything else (superblock 2/3, version 2 object headers, chunked or
filtered datasets, v2 B-trees, fractal heaps, link messages, shared
messages, compound, enum, array and reference types) raises
NotImplementedError naming the feature and ROADMAP Queue A item 9.

The interface is the part of h5py's that the port reads::

    with File(path_or_bytes) as f:
        f.attrs["model_config"]            # str for a variable-length string
        group = f["model_weights/conv1"]   # a path of groups
        "vars" in group; len(group); list(group)
        np.asarray(group["0"])             # a dataset's array

Values are returned as h5py returns them: a dataset or an array
attribute as a numpy array (a fixed-length string array as ``S<n>``, a
variable-length string array as an object array of ``str`` for an
attribute, of ``bytes`` for a dataset), a scalar attribute as a numpy
scalar, a variable-length string attribute as ``str``.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional, Tuple, Union

import numpy as np

ROADMAP_ITEM = "ROADMAP Queue A item 9"
SIGNATURE = b"\x89HDF\r\n\x1a\n"

# message types (File Format Specification, IV.A.2)
_NIL, _DATASPACE, _LINK_INFO, _DATATYPE, _FILL_OLD, _FILL = 0x0, 0x1, 0x2, 0x3, 0x4, 0x5
_LINK, _EXTERNAL, _LAYOUT, _BOGUS, _GROUP_INFO, _FILTERS = 0x6, 0x7, 0x8, 0x9, 0xA, 0xB
_ATTRIBUTE, _COMMENT, _MTIME_OLD, _SHARED_TABLE, _CONTINUATION = 0xC, 0xD, 0xE, 0xF, 0x10
_SYMBOL_TABLE, _MTIME, _BTREE_K, _DRIVER_INFO, _ATTR_INFO, _REFCOUNT = 0x11, 0x12, 0x13, 0x14, 0x15, 0x16

#: messages a reader of this scope meets and does not need
_IGNORED = {_NIL, _FILL_OLD, _FILL, _BOGUS, _COMMENT, _MTIME_OLD, _MTIME, _BTREE_K,
            _DRIVER_INFO, _REFCOUNT, _GROUP_INFO}
#: messages that mean a feature outside the reader's scope
_REFUSED = {
    _LINK_INFO: "link info messages (new-style groups)",
    _LINK: "link messages (new-style groups)",
    _EXTERNAL: "external data files",
    _FILTERS: "filtered datasets (compression, shuffle, checksums)",
    _SHARED_TABLE: "shared object header message tables",
}


def _unsupported(what: str) -> NotImplementedError:
    return NotImplementedError(f"HDF5 {what} is outside the port's HDF5 reader ({ROADMAP_ITEM})")


def _pad8(n: int) -> int:
    return (n + 7) & ~7


class _Datatype:
    """A parsed datatype message: a numpy dtype for the fixed-size
    classes, or a variable-length string."""

    def __init__(self, dtype: Optional[np.dtype], size: int, vlen_string: bool = False,
                 encoding: str = "ascii"):
        self.dtype, self.size, self.vlen_string, self.encoding = dtype, size, vlen_string, encoding


class _Reader:
    """The file's bytes and the sizes its superblock sets."""

    def __init__(self, buf, base: int, offset_size: int, length_size: int):
        self.buf, self.base = buf, base
        self.o, self.l = offset_size, length_size
        self.undefined = (1 << (8 * offset_size)) - 1
        self._heaps: Dict[int, Dict[int, bytes]] = {}

    def uint(self, pos: int, size: int) -> int:
        return int.from_bytes(self.buf[pos:pos + size], "little")

    def addr(self, pos: int) -> int:
        return self.uint(pos, self.o)

    def at(self, address: int) -> int:
        """A file address -> a position in the buffer."""
        if address == self.undefined:
            raise ValueError("HDF5: read at an undefined address")
        pos = self.base + address
        if pos >= len(self.buf):
            raise ValueError(f"HDF5: address {address} beyond the end of the file")
        return pos

    def expect(self, pos: int, signature: bytes) -> None:
        got = bytes(self.buf[pos:pos + len(signature)])
        if got != signature:
            raise ValueError(f"HDF5: expected {signature!r} at {pos}, found {got!r}")

    # -- heaps ----------------------------------------------------------------

    def local_heap_data(self, address: int) -> int:
        """The position of a local heap's data segment."""
        pos = self.at(address)
        self.expect(pos, b"HEAP")
        if self.buf[pos + 4] != 0:
            raise _unsupported(f"local heap version {self.buf[pos + 4]}")
        return self.at(self.addr(pos + 8 + 2 * self.l))

    def cstring(self, pos: int) -> str:
        end = self.buf.find(b"\x00", pos)
        return bytes(self.buf[pos:end]).decode("utf-8")

    def global_heap_object(self, collection: int, index: int) -> bytes:
        if collection not in self._heaps:
            self._heaps[collection] = self._read_collection(collection)
        try:
            return self._heaps[collection][index]
        except KeyError:
            raise ValueError(f"HDF5: no object {index} in the global heap at {collection}") from None

    def _read_collection(self, address: int) -> Dict[int, bytes]:
        pos = self.at(address)
        self.expect(pos, b"GCOL")
        if self.buf[pos + 4] != 1:
            raise _unsupported(f"global heap version {self.buf[pos + 4]}")
        end = pos + self.uint(pos + 8, self.l)
        p, objects = pos + 8 + self.l, {}
        while p + 8 + self.l <= end:
            index = self.uint(p, 2)
            size = self.uint(p + 8, self.l)
            if index == 0:  # the free space closes the collection
                break
            data = p + 8 + self.l
            objects[index] = bytes(self.buf[data:data + size])
            p = data + _pad8(size)
        return objects

    # -- messages -------------------------------------------------------------

    def datatype(self, pos: int) -> _Datatype:
        class_version = self.buf[pos]
        cls, version = class_version & 0x0F, class_version >> 4
        if version not in (1, 2, 3):
            raise _unsupported(f"datatype message version {version}")
        bits = self.uint(pos + 1, 3)
        size = self.uint(pos + 4, 4)
        order = ">" if bits & 1 else "<"
        if cls == 0:  # fixed-point
            if size not in (1, 2, 4, 8):
                raise _unsupported(f"{size}-byte integers")
            kind = "i" if bits & 0x08 else "u"
            return _Datatype(np.dtype(f"{order}{kind}{size}"), size)
        if cls == 1:  # IEEE floating point
            if bits & 0x40:
                raise _unsupported("VAX-ordered floats")
            if size not in (2, 4, 8):
                raise _unsupported(f"{size}-byte floats")
            return _Datatype(np.dtype(f"{order}f{size}"), size)
        if cls == 3:  # fixed-length string
            return _Datatype(np.dtype(f"S{size}"), size)
        if cls == 5:  # opaque (how h5py stores dtypes it has no HDF5 type for, bfloat16)
            return _Datatype(np.dtype(f"V{size}"), size)
        if cls == 9:  # variable-length
            if bits & 0x0F != 1:
                raise _unsupported("variable-length sequences")
            encoding = "utf-8" if (bits >> 8) & 0x0F == 1 else "ascii"
            return _Datatype(None, size, vlen_string=True, encoding=encoding)
        names = {2: "time", 4: "bitfield", 6: "compound", 7: "reference",
                 8: "enumeration", 10: "array"}
        raise _unsupported(f"{names.get(cls, f'class {cls}')} datatypes")

    def dataspace(self, pos: int) -> Optional[Tuple[int, ...]]:
        """The shape: ``()`` for a scalar, None for a null dataspace."""
        version, rank, flags = self.buf[pos], self.buf[pos + 1], self.buf[pos + 2]
        if version == 1:
            dims = pos + 8
            if rank == 0:
                return ()
        elif version == 2:
            kind = self.buf[pos + 3]
            if kind == 0:
                return ()
            if kind == 2:
                return None
            dims = pos + 4
        else:
            raise _unsupported(f"dataspace message version {version}")
        if version == 1 and flags & 0x02:
            raise _unsupported("dataspace permutations")
        return tuple(self.uint(dims + i * self.l, self.l) for i in range(rank))

    def values(self, raw: bytes, dtype: _Datatype, shape: Tuple[int, ...], as_str: bool):
        """Raw element bytes -> a numpy array (or, for variable-length
        strings, an object array of str or bytes)."""
        count = int(np.prod(shape, dtype=np.int64))
        if not dtype.vlen_string:
            return np.frombuffer(raw, dtype.dtype, count=count).reshape(shape).copy()
        out = np.empty(count, dtype=object)
        for i in range(count):
            p = i * dtype.size
            length = int.from_bytes(raw[p:p + 4], "little")
            collection = int.from_bytes(raw[p + 4:p + 4 + self.o], "little")
            index = int.from_bytes(raw[p + 4 + self.o:p + 8 + self.o], "little")
            if collection in (0, self.undefined):
                data = b""
            else:
                data = self.global_heap_object(collection, index)[:length]
            out[i] = data.decode(dtype.encoding) if as_str else data
        return out.reshape(shape)


class _Object:
    """An object header: its messages as ``[(type, position, size)]``."""

    def __init__(self, reader: _Reader, address: int, name: str):
        self._r, self.name = reader, name
        self.messages: List[Tuple[int, int, int]] = []
        pos = reader.at(address)
        if bytes(reader.buf[pos:pos + 4]) == b"OHDR":
            raise _unsupported("version 2 object headers")
        if reader.buf[pos] != 1:
            raise _unsupported(f"object header version {reader.buf[pos]}")
        count, seen = reader.uint(pos + 2, 2), 0
        # the 12-byte prefix is padded to 16; every message is 8-aligned
        blocks = [(pos + 16, reader.uint(pos + 8, 4))]
        while blocks and seen < count:
            start, size = blocks.pop(0)
            p, end = start, start + size
            while p + 8 <= end and seen < count:
                mtype, msize, flags = reader.uint(p, 2), reader.uint(p + 2, 2), reader.buf[p + 4]
                data, p, seen = p + 8, p + 8 + msize, seen + 1
                if flags & 0x02:
                    raise _unsupported(f"shared messages (type {mtype:#x} in {name!r})")
                if mtype in _REFUSED:
                    raise _unsupported(f"{_REFUSED[mtype]} (in {name!r})")
                if mtype == _CONTINUATION:
                    blocks.append((reader.at(reader.addr(data)), reader.uint(data + reader.o, reader.l)))
                elif mtype == _ATTR_INFO:
                    self._check_attr_info(data)
                elif mtype not in _IGNORED:
                    self.messages.append((mtype, data, msize))

    def _check_attr_info(self, pos: int) -> None:
        flags = self._r.buf[pos + 1]
        p = pos + 2 + (2 if flags & 0x01 else 0)
        if self._r.addr(p) != self._r.undefined:
            raise _unsupported(f"dense attribute storage (fractal heap, in {self.name!r})")

    def find(self, mtype: int) -> List[Tuple[int, int]]:
        return [(pos, size) for t, pos, size in self.messages if t == mtype]

    def attributes(self) -> Dict[str, object]:
        out = {}
        for pos, _ in self.find(_ATTRIBUTE):
            name, value = self._attribute(pos)
            out[name] = value
        return out

    def _attribute(self, pos: int):
        r = self._r
        version = r.buf[pos]
        name_size, type_size, space_size = r.uint(pos + 2, 2), r.uint(pos + 4, 2), r.uint(pos + 6, 2)
        if version == 1:
            p = pos + 8
            name = bytes(r.buf[p:p + name_size]).rstrip(b"\x00").decode("utf-8")
            p += _pad8(name_size)
            dtype = r.datatype(p)
            p += _pad8(type_size)
            shape = r.dataspace(p)
            p += _pad8(space_size)
        elif version in (2, 3):
            if r.buf[pos + 1] & 0x03:
                raise _unsupported(f"shared attribute datatypes or dataspaces (in {self.name!r})")
            p = pos + 8 + (1 if version == 3 else 0)
            name = bytes(r.buf[p:p + name_size]).rstrip(b"\x00").decode("utf-8")
            p += name_size
            dtype = r.datatype(p)
            p += type_size
            shape = r.dataspace(p)
            p += space_size
        else:
            raise _unsupported(f"attribute message version {version}")
        if shape is None:
            return name, None
        count = int(np.prod(shape, dtype=np.int64))
        value = r.values(bytes(r.buf[p:p + count * dtype.size]), dtype, shape, as_str=True)
        if shape == ():
            value = value[()]
        return name, value


class Dataset:
    """A dataset: ``shape``, ``dtype``, ``attrs``; ``np.asarray(ds)`` or
    ``ds[()]`` reads it whole."""

    def __init__(self, reader: _Reader, header: _Object):
        self._r, self._h, self.name = reader, header, header.name
        (type_pos, _), = header.find(_DATATYPE)
        (space_pos, _), = header.find(_DATASPACE)
        self._type = reader.datatype(type_pos)
        self.shape = reader.dataspace(space_pos)
        self.dtype = np.dtype(object) if self._type.vlen_string else self._type.dtype
        self._attrs: Optional[dict] = None

    @property
    def attrs(self) -> dict:
        if self._attrs is None:
            self._attrs = self._h.attributes()
        return self._attrs

    def read(self) -> np.ndarray:
        r = self._r
        if self.shape is None:
            raise ValueError(f"HDF5 dataset {self.name!r} has a null dataspace")
        (pos, _), = self._h.find(_LAYOUT)
        version = r.buf[pos]
        if version != 3:
            raise _unsupported(f"data layout message version {version} (in {self.name!r})")
        kind = r.buf[pos + 1]
        nbytes = int(np.prod(self.shape, dtype=np.int64)) * self._type.size
        if kind == 0:  # compact: the data is in the message
            size = r.uint(pos + 2, 2)
            raw = bytes(r.buf[pos + 4:pos + 4 + size])
        elif kind == 1:  # contiguous
            address = r.addr(pos + 2)
            if address == r.undefined:  # never written: the fill value, 0
                raw = bytes(nbytes)
            else:
                start = r.at(address)
                raw = bytes(r.buf[start:start + nbytes])
        elif kind == 2:
            raise _unsupported(f"chunked datasets (in {self.name!r})")
        else:
            raise _unsupported(f"data layout class {kind} (in {self.name!r})")
        if len(raw) < nbytes:
            raise ValueError(f"HDF5 dataset {self.name!r}: {len(raw)} bytes, its shape needs {nbytes}")
        return r.values(raw, self._type, self.shape, as_str=False)

    def __array__(self, dtype=None, copy=None):
        a = self.read()
        return a if dtype is None else a.astype(dtype)

    def __getitem__(self, key):
        return self.read()[key]


class Group:
    """A symbol-table group: ``group[path]``, ``path in group``,
    ``get``, ``keys``, ``len``, iteration in name order, and
    ``attrs``."""

    def __init__(self, reader: _Reader, header: _Object):
        self._r, self._h, self.name = reader, header, header.name
        self._links: Optional[Dict[str, int]] = None
        self._attrs: Optional[dict] = None

    @property
    def attrs(self) -> dict:
        if self._attrs is None:
            self._attrs = self._h.attributes()
        return self._attrs

    def _members(self) -> Dict[str, int]:
        """``{name: object header address}``, in the B-tree's order
        (names sorted, as h5py lists them)."""
        if self._links is None:
            tables = self._h.find(_SYMBOL_TABLE)
            if not tables:
                raise _unsupported(f"groups without a symbol table (in {self.name!r})")
            pos, _ = tables[0]
            r = self._r
            btree, heap = r.addr(pos), r.addr(pos + r.o)
            heap_data = r.local_heap_data(heap)
            self._links = {}
            for entry in self._btree_entries(btree):
                name = r.cstring(heap_data + r.uint(entry, r.o))
                self._links[name] = r.addr(entry + r.o)
        return self._links

    def _btree_entries(self, address: int) -> Iterator[int]:
        """The position of every symbol table entry under a group B-tree
        node, in key order."""
        r = self._r
        pos = r.at(address)
        r.expect(pos, b"TREE")
        if r.buf[pos + 4] != 0:
            raise _unsupported(f"B-tree node type {r.buf[pos + 4]} under a group")
        level, used = r.buf[pos + 5], r.uint(pos + 6, 2)
        p = pos + 8 + 2 * r.o + r.l  # past the siblings and key 0
        for _ in range(used):
            child = r.addr(p)
            if level > 0:
                yield from self._btree_entries(child)
            else:
                node = r.at(child)
                r.expect(node, b"SNOD")
                if r.buf[node + 4] != 1:
                    raise _unsupported(f"symbol table node version {r.buf[node + 4]}")
                entry_size = 2 * r.o + 24
                for i in range(r.uint(node + 6, 2)):
                    yield node + 8 + i * entry_size
            p += r.o + r.l

    def _child(self, name: str) -> Union["Group", Dataset]:
        address = self._members()[name]
        path = f"{self.name.rstrip('/')}/{name}"
        header = _Object(self._r, address, path)
        if header.find(_SYMBOL_TABLE):
            return Group(self._r, header)
        if header.find(_LAYOUT):
            return Dataset(self._r, header)
        raise _unsupported(f"an object that is neither a symbol-table group nor a dataset ({path!r})")

    def __getitem__(self, path: str) -> Union["Group", Dataset]:
        node: Union[Group, Dataset] = self
        for part in path.strip("/").split("/"):
            if not isinstance(node, Group):
                raise KeyError(f"{path!r}: {node.name!r} is a dataset")
            if part not in node._members():
                raise KeyError(f"no {part!r} in HDF5 group {node.name!r}")
            node = node._child(part)
        return node

    def get(self, path: str, default=None):
        try:
            return self[path]
        except KeyError:
            return default

    def __contains__(self, path: str) -> bool:
        return self.get(path) is not None

    def keys(self) -> List[str]:
        return list(self._members())

    def __iter__(self):
        return iter(self.keys())

    def __len__(self) -> int:
        return len(self._members())


class File(Group):
    """An HDF5 file, from a path, ``bytes`` or a binary file object,
    read into memory whole."""

    def __init__(self, source, mode: str = "r"):
        if mode != "r":
            raise ValueError("the port's HDF5 reader only reads")
        if isinstance(source, (bytes, bytearray, memoryview)):
            buf, name = bytes(source), "<bytes>"
        elif hasattr(source, "read"):
            buf, name = source.read(), getattr(source, "name", "<file>")
        else:
            name = os.fspath(source)
            with open(name, "rb") as f:
                buf = f.read()
        reader, root = _superblock(buf, name)
        super().__init__(reader, _Object(reader, root, "/"))

    def close(self) -> None:
        """Nothing to release: the file was read whole (h5py's API)."""

    def __enter__(self) -> "File":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _superblock(buf, name: str) -> Tuple[_Reader, int]:
    """Find the superblock (at 0, 512, 1024, ...) -> (reader, root
    object header address)."""
    at = 0
    while bytes(buf[at:at + 8]) != SIGNATURE:
        at = 512 if at == 0 else 2 * at
        if at + 8 > len(buf):
            raise ValueError(f"{name}: not an HDF5 file (no signature)")
    version = buf[at + 8]
    if version not in (0, 1):
        raise _unsupported(f"superblock version {version}")
    offset_size, length_size = buf[at + 13], buf[at + 14]
    if offset_size not in (2, 4, 8) or length_size not in (2, 4, 8):
        raise ValueError(f"{name}: offsets of {offset_size} and lengths of {length_size} bytes")
    p = at + 24 + (4 if version == 1 else 0)
    base = int.from_bytes(buf[p:p + offset_size], "little")
    reader = _Reader(buf, base, offset_size, length_size)
    root_entry = p + 4 * offset_size
    return reader, reader.addr(root_entry + offset_size)


__all__ = ["Dataset", "File", "Group", "ROADMAP_ITEM", "SIGNATURE"]
