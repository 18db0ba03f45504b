"""Tier-3 tests: the vectorized JAX codec against both golden implementations.

The reference's equivalent tier is CompressionAcceleratorSpec (Test.scala:56-79)
driving the full pipeline over the benchmark corpus — but with the round-trip
assertion it lacked (SURVEY.md §4 gap): every stream we emit must be decoded
bit-exactly by independent deserializers, and we must decode theirs.
"""

import numpy as np
import pytest

from tpu_snappy import api, format as fmt, reference_codec as ref
from tpu_snappy.native import golden
from tpu_snappy.utils import corpus


def _fox() -> bytes:
    """A short seeded text sample (the size of a children's-book page)."""
    return corpus.synth("text", 2300, 1)


def certify(data: bytes) -> bytes:
    """Round-trip `data` through the JAX codec with all decoders agreeing."""
    comp = api.compress(data, small_fastpath=False)
    assert golden.uncompress(comp) == data, "C++ golden rejects our stream"
    assert ref.decompress(comp) == data, "Python golden rejects our stream"
    assert api.decompress(comp, small_fastpath=False) == data, "self-decode mismatch"
    return comp


@pytest.mark.parametrize("data", [
    b"",
    b"a",
    b"abc",
    b"abcd",
    b"aaaaaaaaaaaaaaaaaaaaaaaaaa",
    b"abcabcabcabcabcabcabcabc",
    b"The quick brown fox jumps over the lazy dog. " * 8,
    bytes(range(256)) * 16,
])
def test_edge_cases(data):
    certify(data)


def test_block_boundary_sizes():
    rng = np.random.default_rng(5)
    base = rng.integers(65, 91, 4000, dtype=np.uint8).tobytes()
    for n in (fmt.BLOCK_SIZE - 1, fmt.BLOCK_SIZE, fmt.BLOCK_SIZE + 1):
        data = (base * 20)[:n]
        certify(data)


def test_fast_config_roundtrips_exactly():
    # FAST_CONFIG trades per-file ratio bars for encode speed, NEVER
    # correctness: bit-exact round-trips through both goldens, and the
    # aggregate text ratio stays under software Snappy.
    from tpu_snappy.config import FAST_CONFIG
    datas = [_fox() * 3
             + b"ab" * 20000
             + np.random.default_rng(2).integers(
                 0, 256, 30000, dtype=np.uint8).tobytes()]
    datas.append(corpus.synth("text", 2 * fmt.BLOCK_SIZE, 2))
    for data in datas:
        comp = api.compress(data, FAST_CONFIG, small_fastpath=False)
        assert golden.uncompress(comp) == data
        assert api.decompress(comp, small_fastpath=False) == data
    gold = golden.compress(datas[-1])
    assert len(comp) <= len(gold)  # aggregate-text bar holds at K=8


def test_turbo_config_roundtrips_within_rtl_bar():
    # TURBO_CONFIG opens the reference RTL's own ratio trade (the RTL's
    # recorded real-50KB output is 1.57x software Snappy's size) for
    # encode speed, NEVER correctness: bit-exact round-trips through both
    # goldens, and text output stays well under that 1.57x bar (measured
    # ~1.07x aggregate; real-50000 is 30% SMALLER than the RTL's own).
    from tpu_snappy.config import TURBO_CONFIG
    datas = [_fox() * 3
             + b"ab" * 20000
             + np.random.default_rng(3).integers(
                 0, 256, 30000, dtype=np.uint8).tobytes()]
    datas.append(corpus.synth("text", 2 * fmt.BLOCK_SIZE, 2))
    for data in datas:
        comp = api.compress(data, TURBO_CONFIG, small_fastpath=False)
        assert golden.uncompress(comp) == data
        assert api.decompress(comp, small_fastpath=False) == data
    gold = golden.compress(datas[-1])
    assert len(comp) <= 1.5716 * len(gold)  # the RTL's own ratio trade


def test_ultra_config_roundtrips_within_rtl_bar():
    # ULTRA_CONFIG (turbo + stride-2 anchors) beats the RTL's cyc/B at
    # its own ratio point: correctness is never traded — bit-exact
    # round-trips through both goldens — and text output stays under the
    # RTL's 1.57x-of-snappy size (measured x1.357 aggregate; real-50000
    # 8.6% smaller than the RTL's own recorded output).
    from tpu_snappy.config import ULTRA_CONFIG
    datas = [_fox() * 3
             + b"ab" * 20000
             + np.random.default_rng(4).integers(
                 0, 256, 30000, dtype=np.uint8).tobytes()]
    datas.append(corpus.synth("text", 2 * fmt.BLOCK_SIZE, 2))
    for data in datas:
        comp = api.compress(data, ULTRA_CONFIG, small_fastpath=False)
        assert golden.uncompress(comp) == data
        assert api.decompress(comp, small_fastpath=False) == data
    gold = golden.compress(datas[-1])
    assert len(comp) <= 1.5716 * len(gold)


def test_interval_table_roundtrips_and_holds_ladder_bar():
    # cfg.table="intervals" (round-5 probe, kept as a tested knob): the
    # longest non-root probe ladder rides as one (lo, hi) slot pair.
    # Round-trips must stay bit-exact through both goldens, and the
    # interval must hold the golden bar on text at K=12.
    import dataclasses
    from tpu_snappy.config import DEFAULT_CONFIG
    icfg = dataclasses.replace(DEFAULT_CONFIG, candidates=12, probes=14,
                               table="intervals")
    datas = [_fox() * 2
             + b"xy" * 9000
             + np.random.default_rng(6).integers(
                 0, 256, 20000, dtype=np.uint8).tobytes()]
    datas.append(corpus.synth("text", fmt.BLOCK_SIZE + 5000, 6))
    for data in datas:
        comp = api.compress(data, icfg, small_fastpath=False)
        assert golden.uncompress(comp) == data
        assert api.decompress(comp, small_fastpath=False) == data
    assert len(comp) <= len(golden.compress(datas[-1]))


def test_strided_window_keys_match_sliced_full_keys():
    # The byte-group reinterpretation (u16 pairs at stride 2, u32 words at
    # stride 4) must reproduce _window_keys(...)[::stride] exactly,
    # including the validity mask and the wraparound of the final window.
    import jax.numpy as jnp
    from tpu_snappy.ops import encode as E
    rng = np.random.default_rng(9)
    iota = jnp.arange(fmt.BLOCK_SIZE, dtype=jnp.int32)
    for src in (rng.integers(0, 256, fmt.BLOCK_SIZE, dtype=np.uint8),
                np.frombuffer(corpus.synth("text", fmt.BLOCK_SIZE, 15),
                              np.uint8)):
        b = jnp.asarray(src)
        for n in (fmt.BLOCK_SIZE, fmt.BLOCK_SIZE - 7, 1000, 3):
            full = np.asarray(E._window_keys(b, jnp.int32(n), iota))
            for s in (2, 4):
                sk = np.asarray(E._window_keys_strided(b, jnp.int32(n), s))
                assert np.array_equal(full[::s], sk), (n, s)


def test_stride_offsets_are_stride_multiples():
    # Structural invariant of strided anchors: every emitted copy offset
    # is a multiple of the stride (anchor and source share the lattice).
    from tpu_snappy.config import CodecConfig
    data = _fox() * 10
    cfg = CodecConfig(candidates=4, probes=4, stride=2)
    comp = api.compress(data, cfg, small_fastpath=False)
    assert golden.uncompress(comp) == data
    _, ip = fmt.varint_decode(comp)
    while ip < len(comp):
        tag = comp[ip]
        kind = tag & 3
        if kind == 0:
            code = tag >> 2
            if code < 60:
                ip += 1 + code + 1
            else:
                extra = code - 59
                llen = int.from_bytes(comp[ip + 1: ip + 1 + extra],
                                      "little") + 1
                ip += 1 + extra + llen
        elif kind == 1:
            off = ((tag >> 5) << 8) | comp[ip + 1]
            assert off % 2 == 0, off
            ip += 2
        else:
            assert kind == 2
            off = comp[ip + 1] | (comp[ip + 2] << 8)
            assert off % 2 == 0, off
            ip += 3


def test_device_compaction_matches_join():
    # compact_blocks must reproduce the per-block host join exactly
    # (api.compress/shard/streaming all assemble from the dense form now).
    from tpu_snappy.ops import encode as E
    rng = np.random.default_rng(23)
    base = rng.integers(65, 91, 2500, dtype=np.uint8).tobytes()
    data = (base * 80)[: 2 * fmt.BLOCK_SIZE + 999]
    blocks, lengths = api._to_blocks(data, fmt.BLOCK_SIZE)
    out, lens = E.encode_blocks(blocks, lengths)
    out, lens = np.asarray(out), np.asarray(lens)
    ref = b"".join(out[i, : lens[i]].tobytes() for i in range(len(lengths)))
    pad = -len(lengths) % 3
    dense, _l, total = E.encode_corpus_compact(
        np.pad(blocks, ((0, pad), (0, 0))), np.pad(lengths, (0, pad)),
        wave=3)
    assert np.asarray(dense)[: int(total)].tobytes() == ref


def test_wave_override_identical_streams():
    # The api `wave` knob (throughput/compile trade, docs/API.md) must not
    # change a single output byte, and decode must accept any wave too.
    rng = np.random.default_rng(11)
    base = rng.integers(65, 91, 3000, dtype=np.uint8).tobytes()
    data = (base * 60)[: 2 * fmt.BLOCK_SIZE + 777]
    ref = api.compress(data)
    c1 = api.compress(data, wave=1)
    assert c1 == ref
    assert api.decompress(ref, wave=1) == data
    assert api.decompress(ref) == data


@pytest.mark.parametrize("name", [
    "text-2300", "text-5000", "text-50000", "text-200000",
    "repeating-5000", "random-5000",
    "repeating-50000", "random-50000",
])
def test_corpus_roundtrip_and_ratio(name):
    kind, n = name.split("-")
    data = corpus.synth(kind, int(n), 4444)
    comp = certify(data)
    gold = golden.compress(data)
    # Ratio bar (BASELINE.md): at-or-below software Snappy, held strictly
    # except where a measured per-file slack is recorded below.
    slack = {
        # Incompressible noise: one marginal len-4 copy survives the
        # profitability filter where software Snappy's skip walked past.
        "random-50000": 1,
    }.get(name, 0)
    assert len(comp) <= len(gold) + slack, (name, len(comp), len(gold))


def test_sig_sticky_mode_roundtrip_and_bars():
    """The signature sticky composition (cfg.sticky='sig') must round-trip
    against both goldens and still clear every ratio bar (its collisions
    may only change tie-breaks to other valid candidates)."""
    import dataclasses
    from tpu_snappy.config import DEFAULT_CONFIG
    cfg = dataclasses.replace(DEFAULT_CONFIG, sticky="sig")
    for name, data in (("text", corpus.synth("text", 70000, 8)),
                       ("repeating", corpus.synth("repeating", 50000))):
        comp = api.compress(data, cfg, small_fastpath=False)
        assert golden.uncompress(comp) == data, name
        assert ref.decompress(comp) == data, name
        assert len(comp) <= len(golden.compress(data)), name


def test_baseline_named_files_strictly_at_or_below():
    # The BASELINE ratio bar on seeded stand-ins for the named files
    # (two text samples, random ASCII): text strictly, and the aggregate
    # including random ASCII.
    total_ours = total_gold = 0
    for name, data in (("text", corpus.synth("text", 70000, 9)),
                       ("text2", corpus.synth("text", 20000, 10)),
                       ("randomASCII", corpus.synth("random", 20000))):
        ours = len(api.compress(data, small_fastpath=False))
        gold = len(golden.compress(data))
        total_ours += ours
        total_gold += gold
        if name != "randomASCII":
            assert ours <= gold, (name, ours, gold)
    assert total_ours <= total_gold


def test_decode_foreign_streams():
    # Streams produced by the independent C++ encoder (baseline & dense) and
    # the Python encoder must decode bit-exactly through the parallel decoder.
    for data in (_fox(), corpus.synth("text", 50000, 12),
                 corpus.synth("repeating", 5000)):
        for stream in (golden.compress(data), golden.compress(data, golden.MODE_DENSE),
                       ref.compress(data)):
            assert api.decompress(stream, small_fastpath=False) == data


def test_beats_software_snappy_on_text_sample():
    # 2-block slice of seeded text: strictly better than software Snappy.
    data = corpus.synth("text", 2 * fmt.BLOCK_SIZE, 13)
    comp = certify(data)
    assert len(comp) < len(golden.compress(data))


def test_invalid_stream_rejected():
    with pytest.raises(ValueError):
        api.decompress(fmt.varint_encode(100) + b"\x00",
                       small_fastpath=False)  # truncated
    # copy reaching before start of output
    bad = fmt.varint_encode(8) + bytes([(3 << 2) | 1, 200])
    with pytest.raises(ValueError):
        api.decompress(bad, small_fastpath=False)


def test_decoder_handles_all_literal_forms():
    # Construct streams exercising 1/2/3-byte literal headers explicitly.
    payload = bytes(np.random.default_rng(0).integers(0, 256, 70000, dtype=np.uint8))
    for n in (1, 60, 61, 256, 257, 65536):
        stream = fmt.varint_encode(n) + fmt.literal_header(n) + payload[:n]
        assert api.decompress(stream, small_fastpath=False) == payload[:n]


def test_overlapping_copies_rle():
    # offset < length: the decoder must honor RLE semantics through deep
    # copy chains (the repeating corpus worst case, SURVEY.md §7).
    for period in (1, 2, 3, 7, 63):
        data = (bytes(range(1, period + 1)) * (30000 // period + 1))[:30000]
        certify(data)


def test_probe_dedup_speed_knob():
    # candidates=12/probes=16 activates the rank-probe ladder dedup
    # (encode._candidate_offsets): streams must stay valid Snappy for both
    # golden decoders, and the ratio must stay at-or-below software Snappy
    # on text (the knob's documented exception is alignerTestData-style
    # uniform regions, which is why it is not the default).
    import dataclasses
    from tpu_snappy.config import DEFAULT_CONFIG
    cfg = dataclasses.replace(DEFAULT_CONFIG, candidates=12, probes=16)
    for data in (_fox(), corpus.synth("text", 5000, 14),
                 corpus.synth("repeating", 5000)):
        comp = api.compress(data, cfg=cfg, small_fastpath=False)
        assert golden.uncompress(comp) == data
        assert ref.decompress(comp) == data
        assert len(comp) <= len(golden.compress(data)) + 8
    run = (b"x" * 300 + b"period17-line\n\x00\x00\x00") * 40
    comp = api.compress(run, cfg=cfg, small_fastpath=False)
    assert golden.uncompress(comp) == run


@pytest.mark.parametrize("flatten", ["class", "full", "lift", "off"])
def test_flatten_modes_roundtrip(flatten):
    # All chain-flattening modes (config.flatten) must emit valid Snappy
    # accepted by both goldens. "lift" is the digit-lift ancestor variant
    # (encode._candidate_offsets): measured bars-PASS with a small ratio
    # win on mtg (-51150 vs -48683 B under golden) but decode-depth
    # neutral, so "class" stays the default.
    import dataclasses
    from tpu_snappy.config import DEFAULT_CONFIG
    cfg = dataclasses.replace(DEFAULT_CONFIG, flatten=flatten)
    rng = np.random.default_rng(11)
    words = [rng.integers(97, 123, rng.integers(3, 9), dtype=np.uint8)
             .tobytes() for _ in range(50)]
    data = b" ".join(words[int(i)] for i in rng.integers(0, 50, 30000))
    data = data[:70000] + b"\x00" * 600 + data[:3000]
    comp = api.compress(data, cfg=cfg, small_fastpath=False)
    assert golden.uncompress(comp) == data
    assert ref.decompress(comp) == data
    assert api.decompress(comp, small_fastpath=False) == data
