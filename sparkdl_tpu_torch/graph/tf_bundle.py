"""TF's tensor-bundle checkpoints, read without TensorFlow.

The JAX package reads a checkpoint with ``tf.train.load_checkpoint``. The
port reads the two files a bundle is made of itself:

- ``<prefix>.index`` is an SSTable (LevelDB's table format, as TF's
  ``core/lib/io/table`` writes it): a 48-byte footer ending in the table
  magic, holding the block handles (varint offset and size) of the
  meta-index and index blocks; the index block maps the last key of each
  data block to that block's handle; each block is a run of
  prefix-compressed entries (shared key length, unshared key length,
  value length as varints, the unshared key bytes, the value), an array of
  restart offsets and their count, and a 5-byte trailer after it: the
  compression type (0 none, 1 Snappy, decoded by the port's
  ``dataframe/snappy.py``) and the masked CRC-32C of the block and the
  type byte. The entry with the empty key holds the
  ``BundleHeaderProto``; every other key is a tensor name whose value is
  a ``BundleEntryProto``: dtype, shape, shard, offset and size.
- ``<prefix>.data-NNNNN-of-MMMMM`` holds the tensors' bytes at those
  offsets, little-endian. A numeric tensor's bytes carry the masked
  CRC-32C that its entry names. A ``DT_STRING`` tensor is laid out as the
  varint length of each element, the masked CRC-32C of those lengths (each
  taken as a little-endian uint32, or uint64 past 4 GiB), then the
  element bytes; the entry's checksum covers the lengths, the length
  checksum and the bytes. ``_CHECKPOINTABLE_OBJECT_GRAPH`` (a serialized
  ``TrackableObjectGraph``) is one such tensor.

Every checksum is verified; a mismatch raises :class:`BundleError`.
Sliced (partitioned) variables are refused.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Iterator, List, Tuple

import numpy as np

from sparkdl_tpu_torch.graph import tf_proto

TABLE_MAGIC = 0xDB4775248B80FB57
FOOTER_BYTES = 48
BLOCK_TRAILER_BYTES = 5
_MASK_DELTA = 0xA282EAD8
#: the bundle key of the object graph that TF2 checkpoints carry
OBJECT_GRAPH_KEY = "_CHECKPOINTABLE_OBJECT_GRAPH"


class BundleError(ValueError):
    """A malformed checkpoint or one whose checksums do not hold."""


# -- CRC-32C (Castagnoli) ------------------------------------------------------


def _crc_table() -> np.ndarray:
    table = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table[i] = c
    return table


_TABLE = _crc_table()
_TABLE_LIST = _TABLE.tolist()
_LANES = 4096


def _crc_bytes(crc: int, data) -> int:
    table = _TABLE_LIST
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc


def _crc_lanes(register: int, arr: np.ndarray) -> int:
    """The CRC register after ``arr`` from ``register`` (no final xor),
    over ``_LANES`` slices of ``arr`` at once: each lane runs from zero
    (lane 0 from ``register``) and the lanes are joined through the linear
    map that advancing a register over one lane of zero bytes applies,
    found by running the 32 unit registers beside the data."""
    n_lanes = _LANES
    length = arr.size // n_lanes
    lanes = arr[: n_lanes * length].reshape(n_lanes, length).T  # (length, lanes)
    state = np.zeros(n_lanes + 32, dtype=np.uint32)
    state[0] = register
    state[n_lanes:] = np.left_shift(np.uint32(1), np.arange(32, dtype=np.uint32))
    column = np.zeros(n_lanes + 32, dtype=np.uint32)
    for j in range(length):
        column[:n_lanes] = lanes[j]
        state = _TABLE[(state ^ column) & 0xFF] ^ (state >> 8)
    basis = state[n_lanes:].tolist()  # image of each unit register over `length` zero bytes
    # the map as four byte-indexed tables: shift(s) = xor of T_k[byte k of s]
    tables = []
    for k in range(4):
        t = [0] * 256
        for v in range(256):
            acc = 0
            for bit in range(8):
                if v >> bit & 1:
                    acc ^= basis[8 * k + bit]
            t[v] = acc
        tables.append(t)
    t0, t1, t2, t3 = tables
    values = state[:n_lanes].tolist()
    crc = values[0]
    for v in values[1:]:
        crc = t0[crc & 0xFF] ^ t1[crc >> 8 & 0xFF] ^ t2[crc >> 16 & 0xFF] ^ t3[crc >> 24] ^ v
    return _crc_bytes(crc, arr[n_lanes * length:].tolist())


def crc32c(data, crc: int = 0) -> int:
    """CRC-32C of ``data``, extending ``crc`` (the value of the bytes
    before it), as ``crc32c::Extend``."""
    arr = np.frombuffer(data, dtype=np.uint8) if not isinstance(data, np.ndarray) else data.view(np.uint8).ravel()
    register = crc ^ 0xFFFFFFFF
    if arr.size < 64 * _LANES:
        register = _crc_bytes(register, arr.tolist())
    else:
        register = _crc_lanes(register, arr)
    return register ^ 0xFFFFFFFF


def mask(crc: int) -> int:
    """``crc32c::Mask``: what TF stores beside data."""
    return (((crc >> 15) | (crc << 17)) + _MASK_DELTA) & 0xFFFFFFFF


def unmask(masked: int) -> int:
    rot = (masked - _MASK_DELTA) & 0xFFFFFFFF
    return ((rot >> 17) | (rot << 15)) & 0xFFFFFFFF


# -- the SSTable ------------------------------------------------------------


def _varint(buf, pos: int) -> Tuple[int, int]:
    try:
        return tf_proto._varint(buf, pos)
    except tf_proto.ProtoError as e:
        raise BundleError(str(e)) from None


def _block(data: bytes, offset: int, size: int, where: str) -> bytes:
    end = offset + size
    if end + BLOCK_TRAILER_BYTES > len(data):
        raise BundleError(f"{where}: block at {offset}+{size} runs past the file")
    kind = data[end]
    (stored,) = struct.unpack_from("<I", data, end + 1)
    if unmask(stored) != crc32c(data[offset:end + 1]):
        raise BundleError(f"{where}: block at {offset} fails its CRC-32C")
    contents = data[offset:end]
    if kind == 0:
        return contents
    if kind == 1:
        from sparkdl_tpu_torch.dataframe.snappy import snappy_decompress

        return snappy_decompress(contents)
    raise BundleError(f"{where}: block compression type {kind} is not read")


def _entries(block: bytes, where: str) -> Iterator[Tuple[bytes, bytes]]:
    if len(block) < 4:
        raise BundleError(f"{where}: block of {len(block)} bytes")
    (n_restarts,) = struct.unpack_from("<I", block, len(block) - 4)
    limit = len(block) - 4 * (1 + n_restarts)
    if limit < 0:
        raise BundleError(f"{where}: {n_restarts} restarts in a block of {len(block)} bytes")
    pos, key = 0, b""
    while pos < limit:
        shared, pos = _varint(block, pos)
        unshared, pos = _varint(block, pos)
        n_value, pos = _varint(block, pos)
        if shared > len(key) or pos + unshared + n_value > limit:
            raise BundleError(f"{where}: corrupt block entry at {pos}")
        key = key[:shared] + block[pos:pos + unshared]
        pos += unshared
        yield key, block[pos:pos + n_value]
        pos += n_value


def read_table(path: str) -> Dict[bytes, bytes]:
    """Every key and value of an SSTable file, in key order."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < FOOTER_BYTES:
        raise BundleError(f"{path}: {len(data)} bytes, shorter than a table footer")
    footer = data[-FOOTER_BYTES:]
    lo, hi = struct.unpack_from("<II", footer, FOOTER_BYTES - 8)
    if (hi << 32 | lo) != TABLE_MAGIC:
        raise BundleError(f"{path}: not an SSTable (bad magic)")
    _, pos = _varint(footer, 0)  # the meta-index handle: nothing in it is read
    _, pos = _varint(footer, pos)
    index_offset, pos = _varint(footer, pos)
    index_size, pos = _varint(footer, pos)
    out: Dict[bytes, bytes] = {}
    for _, handle in _entries(_block(data, index_offset, index_size, f"{path} index"), path):
        offset, p = _varint(handle, 0)
        size, _ = _varint(handle, p)
        for key, value in _entries(_block(data, offset, size, path), path):
            out[key] = value
    return out


# -- the bundle -------------------------------------------------------------


class BundleReader:
    """The tensors of one checkpoint ``prefix`` (``<prefix>.index`` and its
    data shards), read as ``tf.train.load_checkpoint(prefix)`` reads them
    (a directory holding a ``checkpoint`` state file is not resolved)."""

    def __init__(self, prefix: str):
        self.prefix = prefix
        table = read_table(prefix + ".index")
        header = table.pop(b"", None)
        if header is None:
            raise BundleError(f"{prefix}.index has no bundle header")
        self.header = tf_proto.parse("BundleHeaderProto", header)
        if self.header.endianness != 0:
            raise BundleError(f"{prefix}: a big-endian bundle is not read")
        self.entries = {key.decode("utf-8"): tf_proto.parse("BundleEntryProto", value) for key, value in table.items()}
        self._shards: Dict[int, bytes] = {}

    def keys(self) -> List[str]:
        return list(self.entries)

    def get_variable_to_shape_map(self) -> Dict[str, List[int]]:
        return {k: [int(d.size) for d in e.shape.dim] for k, e in self.entries.items()}

    def _shard(self, shard_id: int) -> bytes:
        if shard_id not in self._shards:
            path = f"{self.prefix}.data-{shard_id:05d}-of-{max(1, self.header.num_shards):05d}"
            if not os.path.exists(path):
                raise BundleError(f"checkpoint data shard {path} is missing")
            with open(path, "rb") as f:
                self._shards[shard_id] = f.read()
        return self._shards[shard_id]

    def get_tensor(self, key: str) -> np.ndarray:
        try:
            entry = self.entries[key]
        except KeyError:
            raise KeyError(f"checkpoint {self.prefix} has no tensor {key!r}") from None
        if entry.slices:
            raise BundleError(f"{key}: sliced (partitioned) variables are not read")
        data = self._shard(entry.shard_id)
        start, end = entry.offset, entry.offset + entry.size
        if end > len(data):
            raise BundleError(f"{key}: bytes {start}..{end} run past its data shard")
        raw = data[start:end]
        shape = [int(d.size) for d in entry.shape.dim]
        dt = tf_proto.base_dtype(entry.dtype)
        if dt == tf_proto.DT_STRING:
            return self._strings(key, raw, shape, entry.crc32c)
        if crc32c(raw) != unmask(entry.crc32c):
            raise BundleError(f"{key}: data fails its CRC-32C")
        if dt == tf_proto.DT_BFLOAT16:
            return tf_proto._bfloat16_to_float32(np.frombuffer(raw, "<u2")).reshape(shape)
        dtype = tf_proto.np_dtype(dt)
        return np.frombuffer(raw, dtype=dtype.newbyteorder("<")).astype(dtype).reshape(shape)

    @staticmethod
    def _strings(key: str, raw: bytes, shape, stored_crc: int) -> np.ndarray:
        n = int(np.prod(shape, dtype=np.int64))
        pos, lengths, crc = 0, [], 0
        for _ in range(n):
            length, pos = _varint(raw, pos)
            lengths.append(length)
            crc = crc32c(struct.pack("<I" if length <= 0xFFFFFFFF else "<Q", length), crc)
        if pos + 4 > len(raw):
            raise BundleError(f"{key}: string tensor truncated")
        length_crc = raw[pos:pos + 4]
        if unmask(struct.unpack("<I", length_crc)[0]) != crc:
            raise BundleError(f"{key}: string lengths fail their CRC-32C")
        crc = crc32c(length_crc, crc)
        pos += 4
        values = []
        for length in lengths:
            values.append(raw[pos:pos + length])
            pos += length
        if pos != len(raw):
            raise BundleError(f"{key}: string tensor holds {len(raw) - pos} stray bytes")
        crc = crc32c(raw[pos - sum(lengths):pos], crc)
        if crc != unmask(stored_crc):
            raise BundleError(f"{key}: string tensor fails its CRC-32C")
        out = np.empty(n, dtype=object)
        out[:] = values
        return out.reshape(shape)

    def object_graph(self) -> tf_proto.Message:
        """The checkpoint's ``TrackableObjectGraph`` (TF2 checkpoints)."""
        return tf_proto.parse("TrackableObjectGraph", self.get_tensor(OBJECT_GRAPH_KEY).reshape(-1)[0])


__all__ = ["BundleError", "BundleReader", "OBJECT_GRAPH_KEY", "crc32c", "mask", "read_table", "unmask"]
