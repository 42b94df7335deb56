"""Orbax checkpoints without orbax: the on-disk layout read by the port.

:func:`read_orbax_checkpoint` is the counterpart of
``orbax.checkpoint.StandardCheckpointer().restore(path)`` with no
abstract tree. The card's machine has neither orbax nor tensorstore, so
this module reads what they write:

- ``_METADATA`` (JSON): the tree, one entry per leaf keyed by its path,
  with each key's kind (``key_type`` 2: a dict key, 1: a sequence index)
  and the leaf's ``value_type``; and the flags ``use_ocdbt`` and
  ``use_zarr3``.
- The key-value store the arrays live in: with ``use_ocdbt`` (the
  default) tensorstore's OCDBT database (``manifest.ocdbt`` at the root,
  its B-tree nodes in ``d/``, the values they point to in ``d/`` and in
  ``ocdbt.process_<N>/d/``); without it, plain files under the root.
  OCDBT files are a header (a big-endian magic, the file's length, a
  version and a compression byte: 1 is zstd), a body and a CRC-32C; the
  body of a node holds its data-file table (paths shared by prefix), then
  its entries as arrays (key prefix and suffix lengths, the suffixes,
  then per entry its value or child reference). Values up to the
  configured size sit inline in a leaf node, larger ones are a (file,
  offset, length) reference.
- Each array, as zarr v2 (``<name>/.zarray`` and chunks
  ``<name>/<i>.<j>``, each chunk whole, compressed with zstd or not at
  all) or zarr v3 as orbax's ``use_zarr3=True`` writes it
  (``<name>/zarr.json``, shards ``<name>/c/<i>/<j>`` under the
  ``sharding_indexed`` codec: inner chunks through ``bytes`` and ``zstd``,
  an index of (offset, length) pairs with its CRC-32C at the shard's end;
  other zarr v3 layouts raise NotImplementedError naming ROADMAP Queue A
  item 14).

Leaves come back as numpy arrays, ``scalar`` leaves as Python numbers,
and bfloat16 leaves (numpy has no bfloat16 here, and the card's machine
no ``ml_dtypes``) as ``torch.bfloat16`` tensors. zstd goes through the
port's own decoder (``utils/zstd.py``).
"""

from __future__ import annotations

import itertools
import json
import math
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from sparkdl_tpu_torch.graph.tf_bundle import crc32c
from sparkdl_tpu_torch.utils import zstd

_MANIFEST_MAGIC, _NODE_MAGIC = 0x0CDB3A2A, 0x0CDB20DE
_NO_CHUNK = (1 << 64) - 1
#: the value types of ``_METADATA`` that hold no array
_EMPTY = {"None": lambda: None, "Dict": dict, "List": list, "Tuple": tuple}


class OrbaxFormatError(ValueError):
    """A checkpoint file that does not read as orbax, OCDBT or zarr."""


class _Reader:
    def __init__(self, data: bytes, pos: int = 0):
        self.data, self.pos = data, pos

    def varint(self) -> int:
        out = shift = 0
        while True:
            if self.pos >= len(self.data):
                raise OrbaxFormatError("truncated varint")
            b = self.data[self.pos]
            self.pos += 1
            out |= (b & 0x7F) << shift
            if b < 0x80:
                return out
            shift += 7

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise OrbaxFormatError("truncated OCDBT record")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]


# -- OCDBT ----------------------------------------------------------------------


def _ocdbt_body(path: str, magic: int) -> bytes:
    """The (decompressed) body of an OCDBT file, its length and CRC-32C
    checked."""
    with open(path, "rb") as f:
        data = f.read()
    return _ocdbt_decode(data, magic, path)


def _ocdbt_decode(data: bytes, magic: int, what: str) -> bytes:
    if len(data) < 18 or int.from_bytes(data[:4], "big") != magic:
        raise OrbaxFormatError(f"{what}: not an OCDBT file of magic {magic:#010x}")
    if int.from_bytes(data[4:12], "little") != len(data):
        raise OrbaxFormatError(f"{what}: length field disagrees with the file")
    if crc32c(data[:-4]) != int.from_bytes(data[-4:], "little"):
        raise OrbaxFormatError(f"{what}: CRC-32C mismatch")
    r = _Reader(data, 12)
    version, compression = r.varint(), r.varint()
    if version != 0:
        raise OrbaxFormatError(f"{what}: OCDBT format version {version}")
    body = data[r.pos : -4]
    if compression == 1:
        return zstd.decompress(body)
    if compression != 0:
        raise OrbaxFormatError(f"{what}: OCDBT compression {compression}")
    return body


def _data_file_table(r: _Reader) -> List[str]:
    n = r.varint()
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    r.varints(n)  # base-path lengths: the paths are whole without them
    paths: List[str] = []
    for i in range(n):
        prev = paths[-1].encode() if paths else b""
        paths.append((prev[: prefix[i]] + r.take(suffix[i])).decode())
    return paths


def _keys(r: _Reader, n: int) -> Tuple[List[int], List[int]]:
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    return prefix, suffix


def _spelled(r: _Reader, prefix: List[int], suffix: List[int]) -> List[bytes]:
    keys: List[bytes] = []
    for p, s in zip(prefix, suffix):
        keys.append((keys[-1][:p] if keys else b"") + r.take(s))
    return keys


class OcdbtStore:
    """The key -> bytes store of an OCDBT database at ``root``, read from
    its manifest's newest version."""

    def __init__(self, root: str):
        self.root = root
        body = _Reader(_ocdbt_body(os.path.join(root, "manifest.ocdbt"), _MANIFEST_MAGIC))
        body.take(16)  # uuid
        if body.varint() != 0:
            raise NotImplementedError("an OCDBT manifest of the numbered kind is not read by the port")
        body.varint(), body.varint(), body.u8()  # max inline bytes, max node bytes, arity
        if body.varint() == 1:
            body.take(4)  # zstd level
        files = _data_file_table(body)
        n = body.varint()
        generation = body.varints(n)
        height = [body.u8() for _ in range(n)]
        fid, offset, length = body.varints(n), body.varints(n), body.varints(n)
        newest = max(range(n), key=generation.__getitem__) if n else None
        #: key -> inline bytes, or (file path, offset, length)
        self.entries: Dict[bytes, Any] = {}
        if newest is not None:
            self._node(files[fid[newest]], offset[newest], length[newest], height[newest], b"")

    def _node(self, file: str, offset: int, length: int, height: int, prefix: bytes) -> None:
        with open(os.path.join(self.root, file), "rb") as f:
            f.seek(offset)
            raw = f.read(length)
        r = _Reader(_ocdbt_decode(raw, _NODE_MAGIC, file))
        if r.u8() != height:
            raise OrbaxFormatError(f"{file}: B-tree node height disagrees with its reference")
        files = _data_file_table(r)
        n = r.varint()
        kp, ks = _keys(r, n)
        if height == 0:
            keys = _spelled(r, kp, ks)
            lengths = r.varints(n)
            kinds = r.varints(n)
            outside = [i for i in range(n) if kinds[i] == 1]
            ids, offsets = r.varints(len(outside)), r.varints(len(outside))
            refs = dict(zip(outside, zip(ids, offsets)))
            for i, key in enumerate(keys):
                if kinds[i] == 0:
                    self.entries[prefix + key] = r.take(lengths[i])
                else:
                    fi, off = refs[i]
                    self.entries[prefix + key] = (files[fi], off, lengths[i])
            return
        common = r.varints(n)
        keys = _spelled(r, kp, ks)
        ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
        for i in range(n):
            self._node(files[ids[i]], offsets[i], lengths[i], height - 1, prefix + keys[i][: common[i]])

    def get(self, key: str) -> Optional[bytes]:
        v = self.entries.get(key.encode())
        if v is None or isinstance(v, bytes):
            return v
        file, off, n = v
        with open(os.path.join(self.root, file), "rb") as f:
            f.seek(off)
            return f.read(n)


class DirStore:
    """The key -> bytes store of a checkpoint written without OCDBT: one
    file per key under ``root``."""

    def __init__(self, root: str):
        self.root = root

    def get(self, key: str) -> Optional[bytes]:
        path = os.path.join(self.root, *key.split("/"))
        if not os.path.isfile(path):
            return None
        with open(path, "rb") as f:
            return f.read()


# -- zarr -----------------------------------------------------------------------


def _np_dtype(name: str) -> np.dtype:
    """A zarr dtype name; bfloat16 as its uint16 bits."""
    if name == "bfloat16":
        return np.dtype("<u2")
    return np.dtype({"float32": "<f4", "float64": "<f8", "float16": "<f2", "int8": "i1", "int16": "<i2",
                     "int32": "<i4", "int64": "<i8", "uint8": "u1", "uint16": "<u2", "uint32": "<u4",
                     "uint64": "<u8", "bool": "?"}.get(name, name))


def _fill(value, dtype: np.dtype, bf16: bool):
    if value is None:
        return 0
    if isinstance(value, str):  # "NaN", "Infinity", "-Infinity"
        value = float(value)
    if bf16:
        return int(np.float32(value).view(np.uint32) >> 16)
    return value


def _decompress(codec: Optional[dict], raw: bytes) -> bytes:
    if codec is None:
        return raw
    kind = codec.get("id") or codec.get("name")
    if kind == "zstd":
        return zstd.decompress(raw)
    raise NotImplementedError(f"zarr compressor {kind!r} is not read by the port")


def _as_leaf(arr: np.ndarray, bf16: bool):
    if bf16:
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return arr


def _chunk_grid(shape, chunks):
    return itertools.product(*(range(math.ceil(s / c)) for s, c in zip(shape, chunks)))


def _place(out: np.ndarray, idx, chunks, block: np.ndarray) -> None:
    sl = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, out.shape))
    out[sl] = block[tuple(slice(0, s.stop - s.start) for s in sl)]


def read_zarr2(store, name: str):
    """The zarr v2 array ``name`` of ``store``."""
    raw_meta = store.get(f"{name}/.zarray")
    if raw_meta is None:
        raise KeyError(f"checkpoint holds no array {name!r}")
    meta = json.loads(raw_meta)
    if meta.get("filters"):
        raise NotImplementedError(f"{name}: zarr filters are not read by the port")
    bf16 = meta["dtype"] == "bfloat16"
    dtype = _np_dtype(meta["dtype"])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    order, sep = meta.get("order", "C"), meta.get("dimension_separator", ".")
    out = np.full(shape, _fill(meta.get("fill_value"), dtype, bf16), dtype=dtype)
    for idx in _chunk_grid(shape, chunks):
        raw = store.get(f"{name}/{sep.join(map(str, idx)) if idx else '0'}")
        if raw is None:
            continue
        block = np.frombuffer(_decompress(meta.get("compressor"), raw), dtype=dtype).reshape(chunks, order=order)
        if not shape:
            out[()] = block
        else:
            _place(out, idx, chunks, block)
    return _as_leaf(out, bf16)


def _codecs_bytes(codecs: List[dict], raw: bytes) -> Tuple[bytes, str]:
    """Undo a zarr v3 bytes-to-bytes codec chain; returns the bytes and
    the ``bytes`` codec's endianness."""
    endian = "little"
    for codec in reversed(codecs):
        kind, cfg = codec["name"], codec.get("configuration", {})
        if kind == "bytes":
            endian = cfg.get("endian", "little")
        elif kind == "crc32c":
            if crc32c(raw[:-4]) != int.from_bytes(raw[-4:], "little"):
                raise OrbaxFormatError("zarr v3 CRC-32C mismatch")
            raw = raw[:-4]
        elif kind == "zstd":
            raw = zstd.decompress(raw)
        else:
            raise NotImplementedError(f"zarr v3 codec {kind!r} is not read by the port")
    return raw, endian


def _refuse_zarr3(name: str, what: str) -> None:
    raise NotImplementedError(
        f"{name}: a zarr v3 array {what} is not read by the port; orbax's "
        "use_zarr3=True writes shards under sharding_indexed with its index "
        "at the end and the default chunk keys (ROADMAP Queue A item 14)"
    )


def read_zarr3(store, name: str):
    """The zarr v3 array ``name`` of ``store``, as orbax's ``use_zarr3=True``
    writes it: shards ``c/<i>/<j>`` under ``sharding_indexed``, the index
    (with its CRC-32C) at the shard's end."""
    raw_meta = store.get(f"{name}/zarr.json")
    if raw_meta is None:
        raise KeyError(f"checkpoint holds no array {name!r}")
    meta = json.loads(raw_meta)
    bf16 = meta["data_type"] == "bfloat16"
    dtype = _np_dtype(meta["data_type"])
    shape = tuple(meta["shape"])
    outer = tuple(meta["chunk_grid"]["configuration"]["chunk_shape"])
    enc = meta.get("chunk_key_encoding", {"name": "default"})
    if enc["name"] != "default" or enc.get("configuration", {}).get("separator", "/") != "/":
        _refuse_zarr3(name, f"with chunk keys {enc}")
    codecs = meta["codecs"]
    if len(codecs) != 1 or codecs[0]["name"] != "sharding_indexed":
        _refuse_zarr3(name, "without sharding_indexed")
    cfg = codecs[0]["configuration"]
    if cfg.get("index_location", "end") != "end":
        _refuse_zarr3(name, "with its shard index at the start")
    inner = tuple(cfg["chunk_shape"])
    per = [o // i for o, i in zip(outer, inner)]
    n_inner = int(np.prod(per, dtype=np.int64))
    index_len = 16 * n_inner + (4 if any(c["name"] == "crc32c" for c in cfg["index_codecs"]) else 0)
    fill = _fill(meta.get("fill_value"), dtype, bf16)
    out = np.full(shape, fill, dtype=dtype)
    for idx in _chunk_grid(shape, outer):
        raw = store.get(f"{name}/" + "/".join(["c", *map(str, idx)]))
        if raw is None:
            continue
        index_bytes, _ = _codecs_bytes(cfg["index_codecs"], raw[-index_len:])
        index = np.frombuffer(index_bytes, dtype="<u8").reshape(n_inner, 2)
        block = np.full(outer, fill, dtype=dtype)
        for k, sub in enumerate(itertools.product(*(range(p) for p in per))):
            off, nbytes = (int(v) for v in index[k])
            if off == _NO_CHUNK:
                continue
            data, endian = _codecs_bytes(cfg["codecs"], raw[off : off + nbytes])
            chunk = np.frombuffer(data, dtype=dtype.newbyteorder("<" if endian == "little" else ">"))
            _place(block, sub, inner, chunk.astype(dtype).reshape(inner))
        if not shape:
            out[()] = block.reshape(())
        else:
            _place(out, idx, outer, block)
    return _as_leaf(out, bf16)


# -- the tree -------------------------------------------------------------------


def _leaf(value, value_type: str):
    if value_type == "scalar":
        return value.item() if isinstance(value, np.ndarray) else value.reshape(()).item()
    return value


def _insert(tree, keys: List[dict], value) -> Any:
    """Set ``value`` at ``keys`` under ``tree`` (dicts for dict keys,
    lists for sequence indices); returns the (new) root."""
    key = keys[0]
    is_seq = key["key_type"] == 1
    if tree is None:
        tree = [] if is_seq else {}
    k = int(key["key"]) if is_seq else key["key"]
    if is_seq:
        while len(tree) <= k:
            tree.append(None)
    if len(keys) == 1:
        tree[k] = value
    else:
        tree[k] = _insert(tree[k] if (is_seq or k in tree) else None, keys[1:], value)
    return tree


def read_orbax_checkpoint(path: str) -> Any:
    """The tree saved at ``path`` by orbax's ``StandardCheckpointer`` (or
    ``PyTreeCheckpointer``), as ``restore(path)`` gives it: nested dicts
    and lists, numpy leaves, Python scalars, bfloat16 leaves as
    ``torch.bfloat16`` tensors."""
    with open(os.path.join(path, "_METADATA")) as f:
        meta = json.load(f)
    store = OcdbtStore(path) if meta.get("use_ocdbt", True) else DirStore(path)
    read = read_zarr3 if meta.get("use_zarr3", False) else read_zarr2
    tree = None
    for entry in meta["tree_metadata"].values():
        keys = entry["key_metadata"]
        value_type = entry["value_metadata"]["value_type"]
        if value_type in _EMPTY:  # a None or an empty container
            value = _EMPTY[value_type]()
        else:
            value = _leaf(read(store, ".".join(str(k["key"]) for k in keys)), value_type)
        tree = _insert(tree, keys, value)
    return {} if tree is None else tree


__all__ = ["DirStore", "OcdbtStore", "OrbaxFormatError", "read_orbax_checkpoint", "read_zarr2", "read_zarr3"]
