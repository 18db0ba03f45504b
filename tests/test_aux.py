"""Auxiliary subsystem tests: profiling timer, streaming resume, structured
decode errors (SURVEY.md §5 parity: tracing, checkpoint/resume, failure
detection)."""

import io

import jax
import numpy as np
import pytest

from tpu_snappy import api, format as fmt
from tpu_snappy.native import golden
from tpu_snappy.parallel import mesh as meshlib, streaming
from tpu_snappy.utils import corpus, profiling


def test_timer_sections():
    t = profiling.Timer()
    x = jax.numpy.ones((128, 128))
    with t.section("mul", result=None):
        y = x * 2
    with t.section("sum", result=y):
        s = y.sum()
    rep = t.report()
    assert "mul" in rep and "sum" in rep
    assert t.sections["sum"] > 0


def test_device_bench_runs():
    f = jax.jit(lambda x: x + 1)
    dt = profiling.device_bench(f, jax.numpy.ones((8, 128)), iters=3, trials=1)
    assert dt > 0


def test_streaming_resume():
    mesh = meshlib.make_mesh(8)
    data = corpus.synth("text", 20 * fmt.BLOCK_SIZE, 20)
    # Full run for reference.
    full = io.BytesIO()
    streaming.compress_stream(io.BytesIO(data), full, len(data), mesh,
                              blocks_per_wave=8)
    # Interrupted after wave 1 (8 blocks), then resumed.
    part = io.BytesIO()
    src = io.BytesIO(data)
    stats1 = streaming.compress_stream(
        io.BytesIO(data[: 8 * fmt.BLOCK_SIZE]), part, 8 * fmt.BLOCK_SIZE,
        mesh, blocks_per_wave=8)
    # Rewrite the preamble for the full length, as a resuming caller would
    # have written it up front.
    resumed = io.BytesIO()
    resumed.write(fmt.varint_encode(len(data)))
    resumed.write(part.getvalue()[fmt.varint_size(8 * fmt.BLOCK_SIZE):])
    src.seek(8 * fmt.BLOCK_SIZE)
    stats = streaming.StreamStats(
        in_bytes=8 * fmt.BLOCK_SIZE, out_bytes=resumed.tell(), waves=1)
    streaming.compress_stream(src, resumed, len(data), mesh,
                              blocks_per_wave=8, resume=stats)
    assert resumed.getvalue() == full.getvalue()
    assert golden.uncompress(resumed.getvalue()) == data


def test_streaming_resume_rejects_misaligned():
    mesh = meshlib.make_mesh(2)
    with pytest.raises(ValueError, match="whole number of waves"):
        streaming.compress_stream(
            io.BytesIO(b"x" * 100), io.BytesIO(), 100, mesh,
            blocks_per_wave=2,
            resume=streaming.StreamStats(in_bytes=1, out_bytes=1, waves=0))


def test_decode_error_names_fragment():
    # > 1 block so the device fragment path (not the small-input host
    # fast-path) handles it and names the failing fragment.
    data = corpus.synth("text", 3 * fmt.BLOCK_SIZE, 21)
    comp = bytearray(golden.compress(data))
    # Corrupt a copy tag's offset byte near the end to break validation
    # (offset beyond write head). Find a copy2 tag by scanning.
    total, pos = fmt.varint_decode(bytes(comp))
    while pos < len(comp):
        tag = comp[pos]
        kind = tag & 3
        if kind == 2 and pos > 100:
            comp[pos + 1] = 0xFF
            comp[pos + 2] = 0xFF  # offset 65535 >> opos in a 5 KB stream
            break
        if kind == 0:
            code = tag >> 2
            pos += (1 + code + 1) if code < 60 else (
                2 + int.from_bytes(comp[pos+1:pos+1+code-59], "little") + code - 59)
        else:
            pos += 2 if kind == 1 else 3 if kind == 2 else 5
    with pytest.raises(ValueError, match="fragment"):
        api.decompress(bytes(comp))


def test_small_input_host_fastpath():
    # Sub-block inputs take the host codec (size-proportional latency, the
    # reference's own profile) and still round-trip + hit the ratio bar.
    data = corpus.synth("text", 5000, 22)
    comp = api.compress(data)
    assert api.decompress(comp) == data
    assert golden.uncompress(comp) == data
    assert len(comp) <= len(golden.compress(data))
    # Corrupt (truncated) small streams still raise precisely.
    with pytest.raises(ValueError):
        api.decompress(comp[:-1])


def test_fragment_granular_fallback(monkeypatch):
    # One exotic fragment must NOT re-decode the whole stream: the splice
    # path host-decodes only the failed fragment with the already-decoded
    # prefix as context. Whole-stream host decompress is forbidden here.
    rng = np.random.default_rng(7)
    a = rng.integers(0, 256, fmt.BLOCK_SIZE, dtype=np.uint8).tobytes()
    b = rng.integers(0, 256, fmt.BLOCK_SIZE - 74, dtype=np.uint8).tobytes()
    stream = fmt.varint_encode(3 * fmt.BLOCK_SIZE) + b"".join([
        fmt.literal_header(fmt.BLOCK_SIZE), a,
        # fragment 2 opens with a copy reaching into fragment 1 (exotic),
        # then fills out its 64 KB.
        fmt.copy_element(1000, 64),
        fmt.literal_header(len(b) + 10), b"0123456789", b,
        # fragment 3 is ordinary.
        fmt.literal_header(fmt.BLOCK_SIZE), a,
    ])
    expect = (a + a[fmt.BLOCK_SIZE - 1000: fmt.BLOCK_SIZE - 1000 + 64]
              + b"0123456789" + b + a)

    from tpu_snappy import reference_codec

    def forbid(_comp):
        raise AssertionError("whole-stream host decode must not run")

    monkeypatch.setattr(reference_codec, "decompress", forbid)
    assert api.decompress(stream) == expect


def test_host_decode_counters():
    # api.host_decodes counts the host work done for device-path calls:
    # one exotic fragment is one re-decoded fragment; a clean multi-block
    # stream adds nothing; a stream the fragment table refuses is one
    # host-decoded stream.
    from tpu_snappy.ops import decode as ops_decode
    a = np.random.default_rng(8).integers(
        0, 256, fmt.BLOCK_SIZE, dtype=np.uint8).tobytes()
    exotic = fmt.varint_encode(2 * fmt.BLOCK_SIZE) + b"".join([
        fmt.literal_header(fmt.BLOCK_SIZE), a,
        fmt.copy_element(1000, 64),
        fmt.literal_header(fmt.BLOCK_SIZE - 64), a[: fmt.BLOCK_SIZE - 64]])
    expect = a + a[fmt.BLOCK_SIZE - 1000: fmt.BLOCK_SIZE - 936] + a[:-64]
    api.host_decodes.clear()
    clean = corpus.synth("text", 2 * fmt.BLOCK_SIZE, 23)
    assert api.decompress(golden.compress(clean)) == clean
    assert sum(api.host_decodes.values()) == 0
    assert api.decompress(exotic) == expect
    assert api.host_decodes == {"fragments": 1}
    # An element straddling the 64 KB output boundary defeats the
    # fragment table: the whole stream decodes on the host.
    straddle = fmt.varint_encode(fmt.BLOCK_SIZE + 10) + (
        fmt.literal_header(fmt.BLOCK_SIZE + 10) + a + a[:10])
    with pytest.raises(ops_decode.FragmentFallback):
        ops_decode.fragment_table(straddle, fmt.varint_size(
            fmt.BLOCK_SIZE + 10), fmt.BLOCK_SIZE + 10)
    assert api.decompress(straddle) == a + a[:10]
    assert api.host_decodes == {"fragments": 1, "streams": 1}


def test_synth_regenerates_reference_corpus():
    # DataGenerator.scala parity: synth() must regenerate the reference's
    # actual corpus files byte-for-byte (java.util.Random LCG for random-*,
    # UTF-8-char-truncation quirk for real-*, all-'a' repeating-*). Needs
    # the reference corpus (TPU_SNAPPY_REFERENCE).
    if not corpus.has_reference_corpus():
        pytest.skip("reference corpus not present")
    assert corpus.synth("random", 100000) == corpus.load("randomASCII.txt")
    for t in ("random", "real", "repeating"):
        for n in (10, 5000, 50000):
            assert corpus.synth(t, n) == corpus.load(f"{t}-{n}.txt"), (t, n)


def test_synth_text_is_seeded_and_text_like():
    # The seeded text generator: deterministic per seed, different across
    # seeds, printable words and punctuation with line breaks, and a
    # text-like Snappy ratio (software Snappy compresses it ~1.85x).
    a = corpus.synth("text", 200_000, 5)
    assert a == corpus.synth("text", 200_000, 5)
    assert a != corpus.synth("text", 200_000, 6)
    assert len(a) == 200_000 and b"\n" in a and b". " in a and b", " in a
    assert all(32 <= c < 127 or c == 10 for c in set(a))
    ratio = len(a) / len(golden.compress(a))
    assert 1.6 < ratio < 2.2, ratio
