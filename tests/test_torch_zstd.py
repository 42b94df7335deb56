"""The port's zstd decoder (``utils/zstd.py``) against the ``zstandard``
module's compressor, byte for byte, on the CPU.

Levels -5 (fast, raw literals), 1, 3 (the default), 19 and 22 (ultra,
long matches and FSE-compressed tables), with and without the content
checksum and the content size; inputs from 0 B to 1 MiB of text, float32
weights and incompressible bytes; concatenated and skippable frames;
blocks with repeated tables (a stream compressor's many blocks); and the
refusals: a corrupted checksum, a dictionary, garbage.
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from sparkdl_tpu_torch.utils import zstd

zstandard = pytest.importorskip("zstandard")

_RNG = np.random.default_rng(2026)
_WORDS = [b"model", b"tensor", b"shard", b"orbax", b"the", b"of", b"checkpoint", b"zstd", b"kernel", b"\n"]


def _text(n: int) -> bytes:
    out = bytearray()
    while len(out) < n:
        out += _WORDS[int(_RNG.integers(len(_WORDS)))] + b" "
    return bytes(out[:n])


def _weights(n: int) -> bytes:
    return (_RNG.normal(size=(n + 3) // 4) * 0.02).astype(np.float32).tobytes()[:n]


INPUTS = {
    "empty": b"",
    "one": b"z",
    "text-1k": _text(1000),
    "text-1m": _text(1 << 20),
    "weights-64k": _weights(1 << 16),
    "weights-1m": _weights(1 << 20),
    "random-200k": _RNG.bytes(200_000),
    "zeros-300k": bytes(300_000),
    "periodic": bytes(range(7)) * 5000,
}
LEVELS = [-5, 1, 3, 19, 22]


def _compress(data: bytes, level: int, checksum: bool, content_size: bool) -> bytes:
    return zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                    write_content_size=content_size).compress(data)


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("name", sorted(INPUTS))
def test_decodes_every_level_equal_to_the_input(name, level):
    data = INPUTS[name]
    if len(data) >= 1 << 20 and level >= 19:
        data = data[: 1 << 18]  # the ultra levels' compressor is slow at 1 MiB
    for checksum, content_size in ((False, True), (True, False)):
        frame = _compress(data, level, checksum, content_size)
        assert zstd.decompress(frame) == data


def test_many_blocks_repeat_their_tables_and_offsets():
    """A stream compressor writes one frame of many blocks, with no
    content size: treeless literals and repeat-mode tables carry from
    block to block."""
    data = _text(600_000) + _weights(300_000)
    cobj = zstandard.ZstdCompressor(level=7, write_checksum=True).compressobj()
    frame = b"".join(cobj.compress(data[i : i + 40_000]) for i in range(0, len(data), 40_000)) + cobj.flush()
    assert zstd.decompress(frame) == data


def test_concatenated_and_skippable_frames():
    a, b = _text(5000), _weights(7000)
    skip = (0x184D2A53).to_bytes(4, "little") + (11).to_bytes(4, "little") + b"hello world"
    stream = _compress(a, 3, True, True) + skip + _compress(b, 1, False, False) + skip
    assert zstd.decompress(stream) == a + b


def test_a_corrupted_checksum_raises():
    frame = bytearray(_compress(_text(4000), 3, True, True))
    frame[-1] ^= 0x40
    with pytest.raises(zstd.ZstdError, match="checksum"):
        zstd.decompress(bytes(frame))


def test_a_dictionary_frame_is_refused():
    samples = [_text(300) for _ in range(200)]
    dictionary = zstandard.train_dictionary(2048, samples)
    frame = zstandard.ZstdCompressor(dict_data=dictionary).compress(_text(300))
    with pytest.raises(NotImplementedError, match="dictionary"):
        zstd.decompress(frame)


@pytest.mark.parametrize("bad", [b"\x00\x01\x02\x03rest", b"\x28\xb5\x2f"])
def test_garbage_raises(bad):
    with pytest.raises(zstd.ZstdError):
        zstd.decompress(bad)


def test_xxh64_against_the_reference_vectors():
    # XXH64 test vectors (seed 0) from the xxHash specification
    assert zstd.xxh64(b"") == 0xEF46DB3751D8E999
    assert zstd.xxh64(b"a") == 0xD24EC4F1A98C6E5B
    assert zstd.xxh64(b"abc") == 0x44BC2CF5AD770999
    data = bytes(range(256)) * 3
    frame = _compress(data, 3, True, True)
    assert zstd.xxh64(data) & 0xFFFFFFFF == int.from_bytes(frame[-4:], "little")


@settings(max_examples=40, deadline=None)
@given(data=st.binary(min_size=0, max_size=3000), level=st.sampled_from(LEVELS),
       repeat=st.integers(1, 20), checksum=st.booleans())
def test_hypothesis_round_trip(data, level, repeat, checksum):
    data = data * repeat
    assert zstd.decompress(_compress(data, level, checksum, not checksum)) == data
