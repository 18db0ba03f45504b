"""python-snappy compatibility surface (tpu_snappy.compat) and the Hadoop
SnappyCodec container (tpu_snappy.hadoop).

The compat layer must behave like `import snappy` (python-snappy): same
names, same exception type, incremental stream classes that interoperate
byte-level with the framing module and the native C++ golden. The Hadoop
container wraps raw Snappy streams the golden can independently verify."""

import io

import numpy as np
import pytest

from tpu_snappy import compat, framing, hadoop
from tpu_snappy.native import golden
from tpu_snappy.utils import corpus


def _text(n: int) -> bytes:
    return corpus.synth("text", n, 3)


def _rand(n: int, seed=11) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


# ---- raw-stream API ----

def test_compress_uncompress_roundtrip():
    data = _text(150_000)
    comp = compat.compress(data)
    assert compat.uncompress(comp) == data
    # Raw streams from the compat names are plain Snappy: golden decodes.
    assert golden.uncompress(comp) == data


def test_str_encoding_paths():
    s = "snappy héllo " * 40
    comp = compat.compress(s)  # utf-8 per python-snappy default
    assert compat.uncompress(comp, decoding="utf-8") == s


def test_decompress_alias():
    assert compat.decompress is compat.uncompress


def test_uncompress_error_type():
    with pytest.raises(compat.UncompressError):
        compat.uncompress(b"\xff\xff\xff\xff\xff\xff")


def test_is_valid_compressed():
    data = _text(1000)
    assert compat.isValidCompressed(compat.compress(data))
    assert not compat.isValidCompressed(b"\x05\x00garbage!")


# ---- framing stream classes ----

def test_stream_compressor_matches_framing_module():
    data = _text(200_000)
    c = compat.StreamCompressor()
    out = c.add_chunk(data)
    assert c.flush() == b""
    assert out == framing.compress(data)
    assert framing.decompress(out) == data
    assert golden.uncompress_framed(out) == data


def test_stream_compressor_multi_call_header_once():
    a, b = _text(70_000), _rand(1000)
    c = compat.StreamCompressor()
    out = c.add_chunk(a) + c.add_chunk(b)
    assert out.count(framing.STREAM_ID) == 1
    assert framing.decompress(out) == a + b


def test_stream_decompressor_whole_and_dribbled():
    data = _text(180_000)
    framed = framing.compress(data)
    d = compat.StreamDecompressor()
    assert d.decompress(framed) == data
    assert d.flush() == b""

    # Byte-dribble: feed awkward slice sizes; output concatenates exactly.
    d2 = compat.StreamDecompressor()
    got, pos = b"", 0
    for step in (1, 3, 9, 100, 7777, 65536, len(framed)):
        got += d2.decompress(framed[pos: pos + step])
        pos += step
        if pos >= len(framed):
            break
    got += d2.decompress(framed[pos:])
    d2.flush()
    assert got == data


def test_stream_decompressor_native_framed_input():
    data = _rand(130_000)
    framed = golden.compress_framed(data)
    d = compat.StreamDecompressor()
    assert d.decompress(framed) + d.decompress(b"") == data


def test_stream_decompressor_truncated_flush_raises():
    framed = framing.compress(b"x" * 100)
    d = compat.StreamDecompressor()
    d.decompress(framed[:-3])
    with pytest.raises(compat.UncompressError):
        d.flush()


def test_stream_decompressor_crc_corruption():
    framed = bytearray(framing.compress(_text(50_000)))
    framed[len(framing.STREAM_ID) + 10] ^= 0xFF  # flip a payload byte
    d = compat.StreamDecompressor()
    with pytest.raises(compat.UncompressError):
        d.decompress(bytes(framed))


def test_stream_classes_copy():
    c = compat.StreamCompressor()
    first = c.add_chunk(b"abc" * 100)
    c2 = c.copy()
    # The copy continues the stream: no second header.
    assert framing.STREAM_ID not in c2.add_chunk(b"def")
    d = compat.StreamDecompressor()
    d.decompress(first[:11])
    assert d.copy().decompress(first[11:]) == b"abc" * 100


def test_stream_file_helpers():
    data = _text(300_000)
    comp_f = io.BytesIO()
    compat.stream_compress(io.BytesIO(data), comp_f)
    out_f = io.BytesIO()
    compat.stream_decompress(io.BytesIO(comp_f.getvalue()), out_f)
    assert out_f.getvalue() == data
    # Chunks are call-independent: the multi-read stream still golden-decodes.
    assert golden.uncompress_framed(comp_f.getvalue()) == data


def test_stream_decompressor_skippable_chunks():
    # Padding (0xFE) and reserved-skippable (>=0x80) chunks may appear
    # anywhere after the stream id; the decompressor must skip them.
    data = _text(70_000)
    framed = framing.compress(data)
    head = len(framing.STREAM_ID)
    pad = bytes([framing.CHUNK_PADDING]) + (5).to_bytes(3, "little") + b"\0" * 5
    skp = bytes([0x93]) + (2).to_bytes(3, "little") + b"zz"
    spliced = framed[:head] + pad + framed[head:] + skp
    d = compat.StreamDecompressor()
    assert d.decompress(spliced) == data
    assert d.flush() == b""


def test_stream_decompressor_reserved_unskippable_raises():
    framed = framing.compress(b"y" * 200)
    head = len(framing.STREAM_ID)
    bad = (framed[:head]
           + bytes([0x40]) + (1).to_bytes(3, "little") + b"\0"
           + framed[head:])
    d = compat.StreamDecompressor()
    with pytest.raises(compat.UncompressError):
        d.decompress(bad)


# ---- Hadoop container ----

def test_hadoop_roundtrip_and_layout():
    data = _text(600_000)
    blob = hadoop.compress(data)
    assert hadoop.decompress(blob) == data
    # First block header: big-endian uncompressed length of the block.
    assert int.from_bytes(blob[:4], "big") == hadoop.SNAPPY_BUFFER_SIZE_DEFAULT
    # Each subblock is a standard raw Snappy stream: golden decodes it.
    clen = int.from_bytes(blob[4:8], "big")
    assert golden.uncompress(blob[8: 8 + clen]) == \
        data[: hadoop.SNAPPY_BUFFER_SIZE_DEFAULT]


def test_hadoop_blocksize_and_tail():
    data = _rand(100_000) + _text(30_000)
    blob = hadoop.compress(data, blocksize=65536)
    assert hadoop.decompress(blob) == data


def test_hadoop_multi_subblock_decode():
    # General form: one block, two subblocks (as a differently-configured
    # Hadoop writer could emit). Built by hand from golden streams.
    a, b = _text(40_000), _rand(10_000)
    sub_a, sub_b = golden.compress(a), golden.compress(b)
    blob = (len(a + b).to_bytes(4, "big")
            + len(sub_a).to_bytes(4, "big") + sub_a
            + len(sub_b).to_bytes(4, "big") + sub_b)
    assert hadoop.decompress(blob) == a + b


def test_hadoop_truncation_errors():
    blob = hadoop.compress(b"q" * 1000)
    with pytest.raises(ValueError):
        hadoop.decompress(blob[:-1])
    with pytest.raises(ValueError):
        hadoop.decompress(blob[:6])


def test_hadoop_empty_input():
    assert hadoop.compress(b"") == b""
    assert hadoop.decompress(b"") == b""


def test_hadoop_exposed_via_compat():
    assert compat.hadoop_snappy is hadoop
