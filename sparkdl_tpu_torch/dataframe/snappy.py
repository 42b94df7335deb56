"""Page codecs of Parquet: raw Snappy in plain Python, gzip through zlib,
ZSTD (on read) through the port's decoder ``utils/zstd.py``.

Snappy is the default codec of ``pyarrow`` and of Spark, and the card's
machine has no Snappy library, so :func:`snappy_decompress` and
:func:`snappy_compress` implement the raw format (the one Parquet pages
use, no framing): a varint of the uncompressed length, then literal and
copy elements. The compressor is the reference's greedy scheme, a hash of
4-byte windows per 64 KiB block with a lookup stride that grows while no
match turns up, so incompressible data (image bytes) passes through in a
few thousand lookups per block.

:func:`decompress` and :func:`compress` dispatch on Parquet's
``CompressionCodec`` ids. LZ4, BROTLI and LZO, and writing ZSTD, raise
NotImplementedError naming the Parquet-leftovers item.
"""

from __future__ import annotations

import zlib

#: what every refusal of the Parquet slice names
ROADMAP_ITEM = "ROADMAP Queue A item 11 (Parquet leftovers)"

# Parquet CompressionCodec ids
UNCOMPRESSED, SNAPPY, GZIP, LZO, BROTLI, LZ4, ZSTD, LZ4_RAW = range(8)
CODEC_NAMES = {
    UNCOMPRESSED: "UNCOMPRESSED", SNAPPY: "SNAPPY", GZIP: "GZIP", LZO: "LZO",
    BROTLI: "BROTLI", LZ4: "LZ4", ZSTD: "ZSTD", LZ4_RAW: "LZ4_RAW",
}

_BLOCK = 1 << 16


class SnappyError(ValueError):
    """Malformed Snappy data."""


def snappy_decompress(data) -> bytes:
    buf = memoryview(data)
    n = len(buf)
    pos = shift = size = 0
    while True:
        if pos >= n:
            raise SnappyError("truncated length")
        b = buf[pos]
        pos += 1
        size |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    out = bytearray()
    while pos < n:
        tag = buf[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:
            length = tag >> 2
            if length >= 60:
                extra = length - 59
                length = int.from_bytes(buf[pos:pos + extra], "little")
                pos += extra
            length += 1
            if pos + length > n:
                raise SnappyError("literal runs past the input")
            out += buf[pos:pos + length]
            pos += length
            continue
        if kind == 1:
            length = 4 + ((tag >> 2) & 7)
            offset = ((tag >> 5) << 8) | buf[pos]
            pos += 1
        elif kind == 2:
            length = (tag >> 2) + 1
            offset = buf[pos] | (buf[pos + 1] << 8)
            pos += 2
        else:
            length = (tag >> 2) + 1
            offset = int.from_bytes(buf[pos:pos + 4], "little")
            pos += 4
        start = len(out) - offset
        if offset == 0 or start < 0:
            raise SnappyError(f"copy offset {offset} outside the output")
        if offset >= length:
            out += out[start:start + length]
        else:  # an overlapping copy repeats the last `offset` bytes
            pattern = bytes(out[start:])
            out += (pattern * (length // offset + 1))[:length]
    if len(out) != size:
        raise SnappyError(f"decoded {len(out)} bytes, header says {size}")
    return bytes(out)


def _literal(out: bytearray, data, lo: int, hi: int) -> None:
    while lo < hi:
        n = min(hi - lo, _BLOCK)
        m = n - 1
        if m < 60:
            out.append(m << 2)
        elif m < 256:
            out += bytes((60 << 2, m))
        elif m < 65536:
            out.append(61 << 2)
            out += m.to_bytes(2, "little")
        else:
            out.append(62 << 2)
            out += m.to_bytes(3, "little")
        out += data[lo:lo + n]
        lo += n


def _copy(out: bytearray, offset: int, length: int) -> None:
    while length > 0:
        n = min(length, 64)
        if length - n and length - n < 4:  # never leave a copy shorter than 4
            n = length - 4
        if n < 12 and offset < 2048 and n >= 4:
            out.append(1 | ((n - 4) << 2) | ((offset >> 8) << 5))
            out.append(offset & 0xFF)
        else:
            out.append(2 | ((n - 1) << 2))
            out += offset.to_bytes(2, "little")
        length -= n


def snappy_compress(data) -> bytes:
    data = bytes(data)
    n = len(data)
    out = bytearray()
    size = n
    while True:  # the uncompressed length as a varint
        b = size & 0x7F
        size >>= 7
        out.append(b | 0x80 if size else b)
        if not size:
            break
    for base in range(0, n, _BLOCK):
        end = min(n, base + _BLOCK)
        table = {}
        lit = i = base
        skip = 32
        limit = end - 4
        while i <= limit:
            key = data[i:i + 4]
            cand = table.get(key)
            table[key] = i
            if cand is None:
                i += skip >> 5
                skip += 1
                continue
            # extend the match 8 bytes at a time, then byte by byte
            j, k = i + 4, cand + 4
            while j + 8 <= end and data[j:j + 8] == data[k:k + 8]:
                j += 8
                k += 8
            while j < end and data[j] == data[k]:
                j += 1
                k += 1
            _literal(out, data, lit, i)
            _copy(out, i - cand, j - i)
            i = lit = j
            skip = 32
        _literal(out, data, lit, end)
    return bytes(out)


def _refuse(codec: int) -> NotImplementedError:
    return NotImplementedError(
        f"Parquet codec {CODEC_NAMES.get(codec, codec)} is not supported by "
        f"sparkdl_tpu_torch (SNAPPY, GZIP and UNCOMPRESSED are): {ROADMAP_ITEM}"
    )


def decompress(codec: int, data, uncompressed_size: int) -> bytes:
    if codec == UNCOMPRESSED:
        return bytes(data)
    if codec == SNAPPY:
        out = snappy_decompress(data)
    elif codec == GZIP:
        out = zlib.decompress(bytes(data), 16 + zlib.MAX_WBITS)
    elif codec == ZSTD:
        from sparkdl_tpu_torch.utils.zstd import decompress as zstd_decompress

        out = zstd_decompress(data)
    else:
        raise _refuse(codec)
    if len(out) != uncompressed_size:
        raise ValueError(
            f"page decompressed to {len(out)} bytes, header says "
            f"{uncompressed_size}"
        )
    return out


def compress(codec: int, data) -> bytes:
    if codec == UNCOMPRESSED:
        return bytes(data)
    if codec == SNAPPY:
        return snappy_compress(data)
    if codec == GZIP:
        c = zlib.compressobj(6, zlib.DEFLATED, 16 + zlib.MAX_WBITS)
        return c.compress(bytes(data)) + c.flush()
    raise _refuse(codec)


__all__ = [
    "CODEC_NAMES", "GZIP", "ROADMAP_ITEM", "SNAPPY", "SnappyError",
    "UNCOMPRESSED", "compress", "decompress", "snappy_compress",
    "snappy_decompress",
]
