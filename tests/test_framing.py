"""Framing-format tests: CRC-32C vectors, cross-implementation round trips
(device codec <-> native C++), and corruption detection.

The framing layer (tpu_snappy/framing.py) and the native one
(native/snappy_ref.cc sr_*_framed) are written independently; every stream
must cross-decode. CRC-32C is pinned by the public check value."""

import numpy as np
import pytest

from tpu_snappy import framing
from tpu_snappy.native import golden
from tpu_snappy.utils import corpus


def _text(n: int) -> bytes:
    return corpus.synth("text", n, 3)


def _rand(n: int, seed=7) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


# ---- CRC-32C ----

def test_crc32c_check_value():
    # The public CRC-32C check vector (e.g. RFC 3720 appendix B.4).
    assert framing.crc32c(b"123456789") == 0xE3069283


def test_crc32c_vs_native():
    for n in (0, 1, 7, 8, 9, 63, 64, 1000, 65536):
        buf = _rand(n, seed=n + 1)
        assert framing.crc32c(buf) == golden.crc32c(buf), n


def test_crc32c_batch_matches_single():
    rows = np.frombuffer(_rand(4 * 1000), np.uint8).reshape(4, 1000)
    batch = framing.crc32c_batch(rows)
    for i in range(4):
        assert int(batch[i]) == framing.crc32c(rows[i].tobytes())


def test_mask_roundtrip():
    for crc in (0, 1, 0xE3069283, 0xFFFFFFFF):
        assert framing.unmask(framing.mask(crc)) == crc


# ---- round trips ----

CASES = [
    b"",
    b"snappy" * 3,
    _text(150_000),          # 3 chunks, compressible
    _rand(70_000),           # 2 chunks, stays uncompressed
    _text(65_536),           # exactly one full chunk
    _text(65_537),           # full chunk + 1-byte chunk
]


@pytest.mark.parametrize("i", range(len(CASES)))
def test_roundtrip_ours_to_native(i):
    data = CASES[i]
    framed = framing.compress(data)
    assert framed.startswith(framing.STREAM_ID)
    assert golden.uncompress_framed(framed, max_out=len(data) + 1) == data


@pytest.mark.parametrize("i", range(len(CASES)))
def test_roundtrip_native_to_ours(i):
    data = CASES[i]
    framed = golden.compress_framed(data)
    assert framing.decompress(framed) == data


def test_roundtrip_ours_to_ours():
    data = _text(100_000) + _rand(80_000)
    assert framing.decompress(framing.compress(data)) == data


def test_incompressible_goes_uncompressed():
    framed = framing.compress(_rand(65_536))
    # stream id + one uncompressed chunk: 10 + 4 + 4 + 65536
    assert framed[10] == framing.CHUNK_UNCOMPRESSED
    assert len(framed) == 10 + 4 + 4 + 65_536


def test_skippable_chunks_ignored():
    data = _text(30_000)
    framed = bytearray(framing.compress(data))
    pad = bytes([framing.CHUNK_PADDING]) + (5).to_bytes(3, "little") + b"\0" * 5
    skip = bytes([0x80]) + (2).to_bytes(3, "little") + b"xy"
    framed = framed[:10] + pad + skip + framed[10:]
    assert framing.decompress(bytes(framed)) == data
    assert golden.uncompress_framed(bytes(framed)) == data


# ---- corruption detection (both implementations must reject) ----

def _flip(b: bytes, i: int) -> bytes:
    out = bytearray(b)
    out[i] ^= 0x5A
    return bytes(out)


def test_crc_mismatch_detected():
    framed = framing.compress(_text(30_000))
    bad = _flip(framed, len(framed) - 1)  # inside the chunk payload
    with pytest.raises(ValueError):
        framing.decompress(bad)
    with pytest.raises(ValueError):
        golden.uncompress_framed(bad)


def test_bad_stream_id_rejected():
    framed = framing.compress(b"hello")
    bad = _flip(framed, 5)
    with pytest.raises(ValueError):
        framing.decompress(bad)
    with pytest.raises(ValueError):
        golden.uncompress_framed(bad)


def test_reserved_unskippable_rejected():
    framed = framing.compress(b"hello")
    bad = framed[:10] + bytes([0x02, 1, 0, 0, 0]) + framed[10:]
    with pytest.raises(ValueError):
        framing.decompress(bad)
    with pytest.raises(ValueError):
        golden.uncompress_framed(bad)


def test_truncation_rejected():
    framed = framing.compress(_text(30_000))
    with pytest.raises(ValueError):
        framing.decompress(framed[:-3])
    with pytest.raises(ValueError):
        golden.uncompress_framed(framed[:-3])


def test_framed_mesh_roundtrip():
    # Framed chunks are independent: the container composes with DP mesh
    # sharding; the meshed stream must equal the single-device stream.
    from tpu_snappy.parallel import mesh as meshlib
    m = meshlib.make_mesh(8)
    # 9 chunks: > one 8-device pass with a ragged tail, half the old
    # 20-chunk cost (the mesh path is shape-identical beyond that)
    data = corpus.synth("text", 9 * framing.MAX_CHUNK + 777, 30)
    fr_mesh = framing.compress(data, mesh=m)
    assert fr_mesh == framing.compress(data)
    assert framing.decompress(fr_mesh, mesh=m) == data


def test_framed_stream_matches_oneshot():
    import io
    data = corpus.synth("text", 7 * framing.MAX_CHUNK + 123, 31)
    dst = io.BytesIO()
    n = framing.compress_stream(io.BytesIO(data), dst, len(data),
                                blocks_per_wave=3)
    assert dst.getvalue() == framing.compress(data)
    assert n == len(dst.getvalue())
    assert framing.decompress(dst.getvalue()) == data


def test_framed_decompress_stream():
    import io
    data = corpus.synth("text", 9 * framing.MAX_CHUNK + 4321, 32)
    framed = framing.compress(data)
    dst = io.BytesIO()
    n = framing.decompress_stream(io.BytesIO(framed), dst, chunks_per_wave=3)
    assert dst.getvalue() == data and n == len(data)
    # Corruption must raise from the window that contains it.
    bad = bytearray(framed)
    bad[len(framed) // 2] ^= 0xFF
    with pytest.raises(ValueError):
        framing.decompress_stream(io.BytesIO(bytes(bad)), io.BytesIO())
