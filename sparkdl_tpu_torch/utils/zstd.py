"""A Zstandard decoder (RFC 8878) in plain Python.

Zstandard compresses orbax's checkpoint files (OCDBT nodes, zarr chunks)
and Parquet's ZSTD pages, and the card's machine has no zstd library, so
:func:`decompress` reads the format itself:

- frames: the header (single-segment, window, dictionary id, optional
  content size), raw, RLE and compressed blocks, the optional content
  checksum (the low 32 bits of XXH64, verified); several frames in a row,
  and skippable frames, which are passed over;
- literals: raw, RLE, Huffman-coded in 1 or 4 streams, and treeless
  (the previous block's Huffman table);
- sequences: predefined, RLE, FSE-compressed and repeated tables, and
  repeat offsets, which carry from block to block within a frame.

A frame that names a dictionary raises NotImplementedError. Malformed
input raises :class:`ZstdError`. Bit streams are read through 8-byte
windows (never as one big integer), so a block decodes in time linear in
its size. A Huffman stream's symbol and code length at every bit position
are looked up at once in numpy, which leaves two indexings per literal to
the Python loop; sequences are a Python loop each.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

_MAGIC = 0xFD2FB528
_SKIPPABLE_MASK, _SKIPPABLE = 0xFFFFFFF0, 0x184D2A50
_M64 = (1 << 64) - 1


class ZstdError(ValueError):
    """Malformed Zstandard data."""


# -- XXH64 ----------------------------------------------------------------------

_P1, _P2, _P3 = 11400714785074694791, 14029467366897019727, 1609587929392839161
_P4, _P5 = 9650029242287828579, 2870177450012600261


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    acc = (acc + lane * _P2) & _M64
    return (_rotl(acc, 31) * _P1) & _M64


def xxh64(data, seed: int = 0) -> int:
    """XXH64 of ``data``."""
    data = bytes(data)
    n = len(data)
    i = 0
    if n >= 32:
        v1, v2, v3, v4 = (seed + _P1 + _P2) & _M64, (seed + _P2) & _M64, seed, (seed - _P1) & _M64
        stripes = n // 32
        lanes = memoryview(data)[: stripes * 32].cast("Q").tolist()
        for j in range(0, 4 * stripes, 4):
            v1 = _rotl((v1 + lanes[j] * _P2) & _M64, 31) * _P1 & _M64
            v2 = _rotl((v2 + lanes[j + 1] * _P2) & _M64, 31) * _P1 & _M64
            v3 = _rotl((v3 + lanes[j + 2] * _P2) & _M64, 31) * _P1 & _M64
            v4 = _rotl((v4 + lanes[j + 3] * _P2) & _M64, 31) * _P1 & _M64
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M64
        for v in (v1, v2, v3, v4):
            h = ((h ^ _round(0, v)) * _P1 + _P4) & _M64
        i = stripes * 32
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while i + 8 <= n:
        h ^= _round(0, int.from_bytes(data[i : i + 8], "little"))
        h = (_rotl(h, 27) * _P1 + _P4) & _M64
        i += 8
    if i + 4 <= n:
        h ^= int.from_bytes(data[i : i + 4], "little") * _P1 & _M64
        h = (_rotl(h, 23) * _P2 + _P3) & _M64
        i += 4
    while i < n:
        h ^= data[i] * _P5 & _M64
        h = _rotl(h, 11) * _P1 & _M64
        i += 1
    h ^= h >> 33
    h = h * _P2 & _M64
    h ^= h >> 29
    h = h * _P3 & _M64
    return h ^ (h >> 32)


# -- bit streams --------------------------------------------------------------


class _ForwardBits:
    """Bits read from the low end of ``data`` upward (FSE table
    descriptions)."""

    def __init__(self, data: bytes, start: int):
        self.data, self.pos = data, start * 8

    def peek(self, n: int) -> int:
        b = self.pos >> 3
        return (int.from_bytes(self.data[b : b + 8], "little") >> (self.pos & 7)) & ((1 << n) - 1)

    def skip(self, n: int) -> None:
        self.pos += n


class _BackBits:
    """A backward bit stream (Huffman and FSE streams): read from the
    highest bit under the end marker down; bits past the start read as 0,
    and ``pos < 0`` tells that the reader went past it."""

    def __init__(self, data: bytes):
        if not data or data[-1] == 0:
            raise ZstdError("bit stream without its end marker")
        self.data = data
        self.pos = (len(data) - 1) * 8 + data[-1].bit_length() - 1

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        start = self.pos - n
        self.pos = start
        if start >= 0:
            b = start >> 3
            return (int.from_bytes(self.data[b : b + 8], "little") >> (start & 7)) & ((1 << n) - 1)
        return (int.from_bytes(self.data[:8], "little") << -start) & ((1 << n) - 1)

    def peek(self, n: int) -> int:
        start = self.pos - n
        if start >= 0:
            b = start >> 3
            return (int.from_bytes(self.data[b : b + 8], "little") >> (start & 7)) & ((1 << n) - 1)
        return (int.from_bytes(self.data[:8], "little") << -start) & ((1 << n) - 1)


# -- FSE ----------------------------------------------------------------------


class _FSETable:
    """An FSE decoding table: per state its symbol, the bits to read and
    the baseline of the next state."""

    __slots__ = ("log", "symbol", "nbits", "base")

    def __init__(self, log: int, symbol: List[int], nbits: List[int], base: List[int]):
        self.log, self.symbol, self.nbits, self.base = log, symbol, nbits, base

    @classmethod
    def from_norm(cls, norm: List[int], log: int) -> "_FSETable":
        size = 1 << log
        symbol = [0] * size
        high = size - 1
        nxt = [0] * len(norm)
        for s, c in enumerate(norm):
            if c == -1:
                symbol[high] = s
                high -= 1
                nxt[s] = 1
            else:
                nxt[s] = c
        step = (size >> 1) + (size >> 3) + 3
        mask, pos = size - 1, 0
        for s, c in enumerate(norm):
            for _ in range(max(c, 0)):
                symbol[pos] = s
                pos = (pos + step) & mask
                while pos > high:
                    pos = (pos + step) & mask
        if pos != 0:
            raise ZstdError("FSE table description does not fill its table")
        nbits, base = [0] * size, [0] * size
        for u in range(size):
            s = symbol[u]
            state = nxt[s]
            nxt[s] += 1
            nb = log - (state.bit_length() - 1)
            nbits[u] = nb
            base[u] = (state << nb) - size
        return cls(log, symbol, nbits, base)

    @classmethod
    def rle(cls, sym: int) -> "_FSETable":
        return cls(0, [sym], [0], [0])


def _read_fse_description(data: bytes, start: int, max_symbol: int, max_log: int) -> Tuple[_FSETable, int]:
    """An FSE table description at ``data[start:]``: ``(table, end)``."""
    bits = _ForwardBits(data, start)
    log = (bits.peek(4)) + 5
    bits.skip(4)
    if log > max_log:
        raise ZstdError(f"FSE accuracy log {log} over its maximum {max_log}")
    remaining = (1 << log) + 1
    threshold = 1 << log
    nb = log + 1
    norm: List[int] = []
    while remaining > 1 and len(norm) <= max_symbol:
        mx = (2 * threshold - 1) - remaining
        low = bits.peek(nb - 1)
        if low < mx:
            count = low
            bits.skip(nb - 1)
        else:
            count = bits.peek(nb)
            if count >= threshold:
                count -= mx
            bits.skip(nb)
        count -= 1
        remaining -= abs(count)
        norm.append(count)
        if count == 0:
            while True:
                rep = bits.peek(2)
                bits.skip(2)
                norm.extend([0] * rep)
                if rep != 3:
                    break
        while remaining < threshold:
            nb -= 1
            threshold >>= 1
    if remaining != 1 or len(norm) > max_symbol + 1:
        raise ZstdError("malformed FSE table description")
    return _FSETable.from_norm(norm, log), (bits.pos + 7) >> 3


_LL_DEFAULT = [4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1,
               -1, -1, -1, -1]
_ML_DEFAULT = [1, 4, 3, 2, 2, 2, 2, 2, 2] + [1] * 37 + [-1] * 7
_OF_DEFAULT = [1, 1, 1, 1, 1, 1, 2, 2, 2] + [1] * 15 + [-1] * 5
_LL_TABLE0 = _FSETable.from_norm(_LL_DEFAULT, 6)
_ML_TABLE0 = _FSETable.from_norm(_ML_DEFAULT, 6)
_OF_TABLE0 = _FSETable.from_norm(_OF_DEFAULT, 5)

_LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048, 4096,
                              8192, 16384, 32768, 65536]
_LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
_ML_BASE = [c + 3 for c in range(32)] + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027,
                                         2051, 4099, 8195, 16387, 32771, 65539]
_ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
_LL_MAX, _ML_MAX, _OF_MAX = 35, 52, 31


# -- Huffman ------------------------------------------------------------------


class _Huffman:
    """A Huffman decoding table over ``max_bits`` peeked bits."""

    __slots__ = ("max_bits", "symbol_np", "nbits_np")

    def __init__(self, weights: List[int]):
        total = sum(1 << (w - 1) for w in weights if w)
        if total == 0:
            raise ZstdError("Huffman weights are all zero")
        max_bits = total.bit_length()
        rest = (1 << max_bits) - total
        if rest & (rest - 1):
            raise ZstdError("Huffman weights do not complete a power of two")
        weights = weights + [rest.bit_length()]
        if max_bits > 11:
            raise ZstdError(f"Huffman code length {max_bits} over 11")
        rank = [0] * (max_bits + 2)
        for w in weights:
            if w:
                rank[w] += 1
        start, nxt = [0] * (max_bits + 2), 0
        for w in range(1, max_bits + 1):
            start[w] = nxt
            nxt += rank[w] << (w - 1)
        size = 1 << max_bits
        symbol, nbits = [0] * size, [0] * size
        for s, w in enumerate(weights):
            if not w:
                continue
            n = 1 << (w - 1)
            a = start[w]
            symbol[a : a + n] = [s] * n
            nbits[a : a + n] = [max_bits + 1 - w] * n
            start[w] = a + n
        self.max_bits = max_bits
        self.symbol_np = np.array(symbol, np.uint8)
        self.nbits_np = np.array(nbits, np.uint8)

    def decode(self, stream: bytes, count: int) -> bytes:
        """``count`` symbols of one backward stream. The symbol and the code
        length at every bit position of the stream are looked up at once
        (numpy), so the loop per symbol is two indexings: the stream is
        read from bit ``pos`` down, each step peeking ``max_bits`` (zeros
        below the start, hence the 16 zero bits in front)."""
        pos = _BackBits(stream).pos
        mb = self.max_bits
        a = np.frombuffer(b"\0\0" + bytes(stream) + b"\0\0", np.uint8).astype(np.uint32)
        w3 = a[:-2] | (a[1:-1] << 8) | (a[2:] << 16)
        at = np.arange(8 * len(w3), dtype=np.int64)
        peek = (w3[at >> 3] >> (at & 7).astype(np.uint32)) & ((1 << mb) - 1)
        sym_at, nb_at = bytes(self.symbol_np[peek]), bytes(self.nbits_np[peek])
        p = pos - mb + 16
        out = bytearray(count)
        for i in range(count):
            out[i] = sym_at[p]
            p -= nb_at[p]
        if p != 16 - mb:
            raise ZstdError("Huffman stream not consumed exactly")
        return bytes(out)


def _read_huffman(data: bytes, start: int) -> Tuple[_Huffman, int]:
    """A Huffman tree description at ``data[start:]``: ``(table, end)``."""
    header = data[start]
    if header >= 128:
        n = header - 127
        raw = data[start + 1 : start + 1 + (n + 1) // 2]
        weights = []
        for byte in raw:
            weights += [byte >> 4, byte & 15]
        return _Huffman(weights[:n]), start + 1 + (n + 1) // 2
    end = start + 1 + header
    table, pos = _read_fse_description(data, start + 1, 255, 6)
    bits = _BackBits(data[pos:end])
    s1 = bits.read(table.log)
    s2 = bits.read(table.log)
    sym, nbits, base = table.symbol, table.nbits, table.base
    weights: List[int] = []
    while True:
        weights.append(sym[s1])
        s1 = base[s1] + bits.read(nbits[s1])
        if bits.pos < 0:
            weights.append(sym[s2])
            break
        weights.append(sym[s2])
        s2 = base[s2] + bits.read(nbits[s2])
        if bits.pos < 0:
            weights.append(sym[s1])
            break
        if len(weights) > 255:
            raise ZstdError("too many Huffman weights")
    return _Huffman(weights), end


# -- frames and blocks --------------------------------------------------------


class _FrameState:
    __slots__ = ("huffman", "ll", "of", "ml", "reps")

    def __init__(self):
        self.huffman: Optional[_Huffman] = None
        self.ll = self.of = self.ml = None
        self.reps = [1, 4, 8]


def _literals(block: bytes, st: _FrameState) -> Tuple[bytes, int]:
    b0 = block[0]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    if kind in (0, 1):
        if fmt in (0, 2):
            size, pos = b0 >> 3, 1
        elif fmt == 1:
            size, pos = (b0 >> 4) + (block[1] << 4), 2
        else:
            size, pos = (b0 >> 4) + (block[1] << 4) + (block[2] << 12), 3
        if kind == 0:
            if pos + size > len(block):
                raise ZstdError("raw literals past the block")
            return bytes(block[pos : pos + size]), pos + size
        return bytes([block[pos]]) * size, pos + 1
    nhead = {0: 3, 1: 3, 2: 4, 3: 5}[fmt]
    h = int.from_bytes(block[:nhead], "little")
    width = {3: 10, 4: 14, 5: 18}[nhead]
    regen = (h >> 4) & ((1 << width) - 1)
    comp = (h >> (4 + width)) & ((1 << width) - 1)
    pos, end = nhead, nhead + comp
    if end > len(block):
        raise ZstdError("compressed literals past the block")
    if kind == 2:
        st.huffman, pos = _read_huffman(block, pos)
    elif st.huffman is None:
        raise ZstdError("treeless literals without an earlier Huffman table")
    huff = st.huffman
    if fmt == 0:
        return huff.decode(block[pos:end], regen), end
    s1, s2, s3 = (int.from_bytes(block[pos + 2 * i : pos + 2 * i + 2], "little") for i in range(3))
    pos += 6
    each = (regen + 3) // 4
    parts, counts = [], [each, each, each, regen - 3 * each]
    for size, count in zip((s1, s2, s3, end - pos - s1 - s2 - s3), counts):
        if size < 0 or count < 0:
            raise ZstdError("malformed 4-stream literals")
        parts.append(huff.decode(block[pos : pos + size], count))
        pos += size
    return b"".join(parts), end


def _table(mode: int, block: bytes, pos: int, default: _FSETable, previous, max_symbol: int,
           max_log: int) -> Tuple[_FSETable, int]:
    if mode == 0:
        return default, pos
    if mode == 1:
        return _FSETable.rle(block[pos]), pos + 1
    if mode == 2:
        return _read_fse_description(block, pos, max_symbol, max_log)
    if previous is None:
        raise ZstdError("repeat-mode table without an earlier table")
    return previous, pos


def _block(block: bytes, out: bytearray, st: _FrameState) -> None:
    lits, pos = _literals(block, st)
    if pos >= len(block):
        raise ZstdError("compressed block without its sequences section")
    b0 = block[pos]
    if b0 == 0:
        out += lits
        return
    if b0 < 128:
        nseq, pos = b0, pos + 1
    elif b0 < 255:
        nseq, pos = ((b0 - 128) << 8) + block[pos + 1], pos + 2
    else:
        nseq, pos = block[pos + 1] + (block[pos + 2] << 8) + 0x7F00, pos + 3
    modes = block[pos]
    pos += 1
    if modes & 3:
        raise ZstdError("reserved bits of the sequence modes are set")
    st.ll, pos = _table(modes >> 6, block, pos, _LL_TABLE0, st.ll, _LL_MAX, 9)
    st.of, pos = _table((modes >> 4) & 3, block, pos, _OF_TABLE0, st.of, _OF_MAX, 8)
    st.ml, pos = _table((modes >> 2) & 3, block, pos, _ML_TABLE0, st.ml, _ML_MAX, 9)
    bits = _BackBits(bytes(block[pos:]))
    read = bits.read
    ll_t, of_t, ml_t = st.ll, st.of, st.ml
    ll_sym, ll_nb, ll_base = ll_t.symbol, ll_t.nbits, ll_t.base
    of_sym, of_nb, of_base = of_t.symbol, of_t.nbits, of_t.base
    ml_sym, ml_nb, ml_base = ml_t.symbol, ml_t.nbits, ml_t.base
    ll_s = read(ll_t.log)
    of_s = read(of_t.log)
    ml_s = read(ml_t.log)
    r1, r2, r3 = st.reps
    lp = 0
    for i in range(nseq):
        of_code = of_sym[of_s]
        ml_code = ml_sym[ml_s]
        ll_code = ll_sym[ll_s]
        if of_code > _OF_MAX:
            raise ZstdError(f"offset code {of_code}")
        ofv = (1 << of_code) + read(of_code)
        ml = _ML_BASE[ml_code] + read(_ML_BITS[ml_code])
        ll = _LL_BASE[ll_code] + read(_LL_BITS[ll_code])
        if ofv > 3:
            offset = ofv - 3
            r1, r2, r3 = offset, r1, r2
        else:
            idx = ofv - 1 + (ll == 0)
            if idx == 0:
                offset = r1
            elif idx == 1:
                offset = r2
                r1, r2 = r2, r1
            elif idx == 2:
                offset = r3
                r1, r2, r3 = r3, r1, r2
            else:
                offset = r1 - 1
                if offset <= 0:
                    raise ZstdError("repeat offset 0")
                r1, r2, r3 = offset, r1, r2
        if ll:
            if lp + ll > len(lits):
                raise ZstdError("sequence past its literals")
            out += lits[lp : lp + ll]
            lp += ll
        n = len(out)
        if offset > n:
            raise ZstdError(f"offset {offset} before the frame's start")
        s = n - offset
        if offset >= ml:
            out += out[s : s + ml]
        else:
            pat = out[s:n]
            out += (pat * (ml // offset + 1))[:ml]
        if i + 1 < nseq:
            ll_s = ll_base[ll_s] + read(ll_nb[ll_s])
            ml_s = ml_base[ml_s] + read(ml_nb[ml_s])
            of_s = of_base[of_s] + read(of_nb[of_s])
    if bits.pos != 0:
        raise ZstdError("sequence stream not consumed exactly")
    out += lits[lp:]
    st.reps = [r1, r2, r3]


def _frame(data: bytes, pos: int) -> Tuple[bytes, int]:
    """One zstd frame at ``data[pos:]`` (past its magic): ``(content, end)``."""
    fhd = data[pos]
    pos += 1
    fcs_flag, single = fhd >> 6, (fhd >> 5) & 1
    checksum, dict_flag = (fhd >> 2) & 1, fhd & 3
    if fhd & 8:
        raise ZstdError("reserved bit of the frame header is set")
    if not single:
        pos += 1  # window descriptor: the whole frame is held anyway
    dsize = (0, 1, 2, 4)[dict_flag]
    if dsize and int.from_bytes(data[pos : pos + dsize], "little"):
        raise NotImplementedError("zstd frames with a dictionary are not supported")
    pos += dsize
    fsize = (1 if single else 0, 2, 4, 8)[fcs_flag]
    content_size = None
    if fsize:
        content_size = int.from_bytes(data[pos : pos + fsize], "little") + (256 if fsize == 2 else 0)
        pos += fsize
    out = bytearray()
    st = _FrameState()
    while True:
        if pos + 3 > len(data):
            raise ZstdError("truncated block header")
        h = int.from_bytes(data[pos : pos + 3], "little")
        pos += 3
        last, kind, size = h & 1, (h >> 1) & 3, h >> 3
        if kind == 0:
            if pos + size > len(data):
                raise ZstdError("truncated raw block")
            out += data[pos : pos + size]
            pos += size
        elif kind == 1:
            out += data[pos : pos + 1] * size
            pos += 1
        elif kind == 2:
            if pos + size > len(data):
                raise ZstdError("truncated compressed block")
            _block(data[pos : pos + size], out, st)
            pos += size
        else:
            raise ZstdError("reserved block type")
        if last:
            break
    if content_size is not None and content_size != len(out):
        raise ZstdError(f"frame content is {len(out)} bytes, its header says {content_size}")
    if checksum:
        want = int.from_bytes(data[pos : pos + 4], "little")
        pos += 4
        if xxh64(out) & 0xFFFFFFFF != want:
            raise ZstdError("content checksum mismatch")
    return bytes(out), pos


def decompress(data) -> bytes:
    """The content of every zstd frame in ``data``, in order; skippable
    frames are passed over."""
    data = bytes(data)
    pos, parts = 0, []
    while pos < len(data):
        if pos + 4 > len(data):
            raise ZstdError("truncated frame magic")
        magic = int.from_bytes(data[pos : pos + 4], "little")
        pos += 4
        if magic == _MAGIC:
            content, pos = _frame(data, pos)
            parts.append(content)
        elif magic & _SKIPPABLE_MASK == _SKIPPABLE:
            pos += 4 + int.from_bytes(data[pos : pos + 4], "little")
            if pos > len(data):
                raise ZstdError("truncated skippable frame")
        else:
            raise ZstdError(f"not a zstd frame: magic {magic:#010x}")
    return b"".join(parts)


__all__ = ["ZstdError", "decompress", "xxh64"]
