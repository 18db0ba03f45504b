"""Framed fast-decode sidecar (tpu_snappy/sidecar.py + framing 0x80 chunks).

Covers: root-map piece extraction (native vs pure-python, gather-expansion
exactness per corpus class), the device decode path (scatter+ffill+gather),
framed round-trips under every emission policy,
foreign-decoder interop (the independent C++ golden skips the chunk by
spec; the REAL google/snappy decodes each chunk payload), corruption
semantics (wrong sidecar falls back silently — it is a hint; wrong data
still raises), and the auto-policy size gate.
"""

import io

import numpy as np
import pytest

from tpu_snappy import api, format as fmt, framing, reference_codec as ref
from tpu_snappy import sidecar
from tpu_snappy.native import golden
from tpu_snappy.utils import corpus


def _classes():
    rng = np.random.default_rng(7)
    cases = [
        ("tinytext", b"The quick brown fox jumps over the lazy dog. " * 100),
        ("xrle", b"x" * 50000),
        ("abrle", b"ab" * 20000),
        ("random", rng.integers(0, 256, 30000, dtype=np.uint8).tobytes()),
    ]
    cases += [
        ("text", corpus.synth("text", 65536, 100)),
        ("repeating", corpus.synth("repeating", 50000)),
        ("text50k", corpus.synth("text", 50000, 101)),
    ]
    return cases


def _expand(starts, roots, slopes, ulen):
    plens = np.diff(np.concatenate([starts.astype(np.int64), [ulen]]))
    s, r, sl = (starts.astype(np.int64), roots.astype(np.int64),
                slopes.astype(np.int64))
    return (np.repeat(r - sl * s, plens)
            + np.repeat(sl, plens) * np.arange(ulen))


@pytest.mark.parametrize("name,data", _classes())
def test_root_pieces_expand_exactly(name, data):
    comp = ref.compress(data)
    total, start = fmt.varint_decode(comp)
    elems = comp[start:]
    starts, roots, slopes = golden.root_map(elems, total)
    g = _expand(starts, roots, slopes, total)
    got = np.frombuffer(elems, np.uint8)[g].tobytes()
    assert got == data
    assert starts[0] == 0 and (np.diff(starts) > 0).all()
    assert set(np.unique(slopes)) <= {0, 1}


def test_python_fallback_matches_native():
    for name, data in _classes()[:4]:
        comp = ref.compress(data)
        total, start = fmt.varint_decode(comp)
        a = sidecar._root_pieces_py(comp[start:], total)
        b = golden.root_map(comp[start:], total)
        for x, y in zip(a, b):
            assert (np.asarray(x) == np.asarray(y)).all(), name


def test_device_sidecar_decode_all_classes():
    # Own-encoder streams of every corpus class through the full device
    # path, batched at ONE common width — a single compiled graph covers
    # all classes (per-class calls would compile a graph per (PW, EW)
    # shape pair).
    jobs = []
    for name, data in _classes():
        comp = api.compress(data, small_fastpath=False)
        total, start = fmt.varint_decode(comp)
        elems = comp[start:]
        if len(elems) >= sidecar.OUT:
            continue  # multi-fragment; framed tests cover chunking
        payload = sidecar.build(elems, total)
        assert payload is not None, name
        parsed = sidecar.parse(payload)
        assert parsed is not None, name
        s2, vals = sidecar.prep_parent(*parsed, total)
        jobs.append((name, data, elems, total, s2, vals))
    assert len(jobs) >= 4
    B = len(jobs)
    pw = sidecar.pieces_width(max(len(j[4]) for j in jobs))
    ew = sidecar.elems_width(max(len(j[2]) for j in jobs))
    S = np.full((B, pw), sidecar.OUT, np.int32)
    V = np.zeros((B, pw), np.int32)
    E = np.zeros((B, ew), np.uint8)
    U = np.zeros(B, np.int32)
    for j, (_n, _d, elems, total, s2, vals) in enumerate(jobs):
        E[j, : len(elems)] = np.frombuffer(elems, np.uint8)
        S[j, : len(s2)] = s2
        V[j, : len(vals)] = vals
        U[j] = total
    out = np.asarray(sidecar.decode_chunks_jit(E, S, V, U))
    for j, (name, data, _e, total, _s, _v) in enumerate(jobs):
        assert out[j, :total].tobytes() == data, name
    # pack_batch (the packing framing and serving use) builds the same
    # batch, and the wave-mapped form decodes it identically.
    E2, S2, V2, U2 = sidecar.pack_batch(
        [(j[2], j[3], j[4], j[5]) for j in jobs], pad_rows=-B % 2)
    out2 = np.asarray(sidecar.decode_corpus_sidecar(E2, S2, V2, U2, wave=2))
    for j, (name, data, _e, total, _s, _v) in enumerate(jobs):
        assert out2[j, :total].tobytes() == data, name


def _mix():
    # One chunk of each class (text-ish / RLE / random / corpus text) —
    # multi-chunk with every sidecar regime, small enough that the CPU
    # device-path encodes in one wave.
    rng = np.random.default_rng(3)
    mix = (b"the cat sat on the mat and the dog sat on the log " * 1100
           + b"z" * 50000
           + rng.integers(0, 256, 40000, dtype=np.uint8).tobytes())
    mix += corpus.synth("text", 40000, 102)
    return mix


@pytest.mark.parametrize("policy", ["off", "auto", "always"])
def test_framed_roundtrip_policies(policy):
    mix = _mix()
    fr = framing.compress(mix, sidecar=policy)
    assert framing.decompress(fr) == mix
    assert framing.decompress(fr, use_sidecar=False) == mix
    # The independent C++ framed decoder ignores the chunk per spec.
    assert golden.uncompress_framed(fr, max_out=len(mix) + 10) == mix


def test_framed_sidecar_composes_with_mesh():
    # Sidecar fast-decode shards DP like every other chunk pass; streams
    # and bytes must match the single-device path exactly.
    from tpu_snappy.parallel import mesh as meshlib
    mix = _mix()
    m = meshlib.make_mesh(4)
    fr = framing.compress(mix, sidecar="always", mesh=m)
    assert fr == framing.compress(mix, sidecar="always")
    assert framing.decompress(fr, mesh=m) == mix
    # Non-default mesh axis name: the sidecar path must honor cfg.dp_axis
    # like the normal chunk path does (round-3 advisor finding).
    import dataclasses
    from tpu_snappy.config import DEFAULT_CONFIG
    mx = meshlib.make_mesh(4, axis="blocks")
    cfgx = dataclasses.replace(DEFAULT_CONFIG, dp_axis="blocks")
    assert framing.decompress(fr, cfg=cfgx, mesh=mx) == mix


def test_sidecar_chunk_type_is_spec_skippable():
    assert 0x80 <= framing.CHUNK_SIDECAR <= 0xFD
    assert framing.CHUNK_SIDECAR == sidecar.CHUNK_TYPE


def test_real_snappy_decodes_chunk_payloads():
    # The REAL google/snappy raw decoder must accept every compressed data
    # chunk payload of a sidecar-bearing framed stream untouched.
    from tpu_snappy.native import realsnappy
    if not realsnappy.available():
        pytest.skip("system libsnappy not present")
    mix = _mix()
    fr = framing.compress(mix, sidecar="always")
    ip = len(framing.STREAM_ID)
    pieces = []
    while ip < len(fr):
        typ = fr[ip]
        ln = int.from_bytes(fr[ip + 1: ip + 4], "little")
        body = fr[ip + 4: ip + 4 + ln]
        if typ == framing.CHUNK_COMPRESSED:
            pieces.append(realsnappy.uncompress(body[4:]))
        elif typ == framing.CHUNK_UNCOMPRESSED:
            pieces.append(body[4:])
        ip += 4 + ln
    assert b"".join(pieces) == mix


def test_auto_policy_gates_on_size():
    mix = _mix()
    fr_off = framing.compress(mix, sidecar="off")
    fr_auto = framing.compress(mix, sidecar="auto")
    fr_always = framing.compress(mix, sidecar="always")
    # auto pays at most SIDECAR_AUTO_FRAC per chunk; text chunks get none.
    assert len(fr_auto) - len(fr_off) <= int(
        framing.SIDECAR_AUTO_FRAC * len(mix)) + 8 * (len(mix) // 65536 + 1)
    assert len(fr_always) > len(fr_auto)
    # auto emitted at least the RLE chunk's sidecar
    assert len(fr_auto) > len(fr_off)


def _chunks_of(fr: bytes, typ: int) -> list[bytes]:
    out, ip = [], len(framing.STREAM_ID)
    while ip < len(fr):
        ln = int.from_bytes(fr[ip + 1: ip + 4], "little")
        if fr[ip] == typ:
            out.append(fr[ip + 4: ip + 4 + ln])
        ip += 4 + ln
    return out


def _has_chunk(fr: bytes, typ: int) -> int:
    return len(_chunks_of(fr, typ))


def test_depth_hint_fires_on_text_under_auto():
    # The auto policy must emit SOMETHING on dense text — the 76-byte
    # 0x81 per-tile depth hint — and the hinted stream must decode
    # bit-exactly on the device through the plain resolve (the decoder
    # skips the hints), with no host fallback. Every emitted hint is
    # well-formed for the wire constants.
    data = corpus.synth("text", 131072, 103)
    fr = framing.compress(data, sidecar="auto")
    hints = _chunks_of(fr, framing.CHUNK_DEPTH)
    assert len(hints) >= 1
    assert all(sidecar.parse_depth(h) is not None for h in hints)
    assert _has_chunk(fr, framing.CHUNK_SIDECAR) == 0  # root map too big
    framing.decode_stats.clear()
    assert framing.decompress(fr) == data
    assert framing.decode_stats["host_chunks"] == 0
    # foreign decoders skip 0x81 like any skippable chunk
    from tpu_snappy.native import golden as g
    assert g.uncompress_framed(fr, max_out=len(data) + 16) == data
    # and the hint is tiny: 12-byte header + 64 per-tile depths + the
    # 4-byte chunk header per text chunk (DEPTH_TILE=1024)
    fr_off = framing.compress(data, sidecar="off")
    assert len(fr) - len(fr_off) <= 84 * (len(data) // 65536 + 1)


def test_depth_hint_native_matches_pipeline_truth():
    # The native builder must reproduce the wire format's per-tile local
    # depths of the decode pipeline's one-step source map (dense rounds
    # until at most DEPTH_TAIL_CAP lanes move, then tile-local doubling).
    import jax
    import jax.numpy as jnp
    from tpu_snappy.native import golden as g
    from tpu_snappy.ops import decode as D
    CAP, TILE = sidecar.DEPTH_TAIL_CAP, sidecar.DEPTH_TILE
    data = (b"the cat sat on the mat and a dog sat on the log too " * 1300
            )[:65536]
    comp = api.compress(data, small_fastpath=False)
    total, start = fmt.varint_decode(comp)
    elems = comp[start:]
    native = g.depth_hints(elems, total, CAP, TILE)
    w = max(8192, -(-(len(elems) + 8) // 8192) * 8192)
    cc = np.zeros(w, np.uint8)
    cc[: len(elems)] = np.frombuffer(elems, np.uint8)
    _lit, src, ok = jax.jit(D.parse_transport)(
        jnp.asarray(cc), jnp.int32(len(elems)), jnp.int32(total))
    assert bool(ok)
    s = np.asarray(src)
    cnt, it = D.OUT + 1, 0
    while cnt > CAP and it < 16:
        s2 = s[s]
        cnt = int((s2 != s).sum())
        s, it = s2, it + 1
    for t in range(D.OUT // TILE):
        base = t * TILE
        st = s[base: base + TILE].copy()
        r = 0
        while True:
            gnext = np.where(st >= base,
                             st[np.clip(st - base, 0, TILE - 1)], st)
            if (gnext == st).all():
                break
            st, r = gnext, r + 1
        assert int(native[t]) == r, t


def test_depth_hint_analytic_matches_simulation():
    # sr_depth_hints derives both doubling phases analytically from
    # per-lane chain depths; sr_depth_hints_sim simulates them round by
    # round. They must agree bit-exactly on every stream, cap and tile.
    from tpu_snappy.native import golden as g

    rng = np.random.default_rng(20260820)
    streams = []
    text = (b"the cat sat on the mat and a dog sat on the log too " * 1300
            )[:65536]
    streams.append(text)
    streams.append(b"A" * 50000)                        # offset-1 RLE
    streams.append(bytes(rng.integers(0, 256, 4096, dtype=np.uint8)))
    pat = bytes(rng.integers(0, 256, 37, dtype=np.uint8))
    streams.append((pat * 1800)[:65536])                # periodic
    streams.append(b"xy")                               # tiny
    for data in streams:
        comp = api.compress(data, small_fastpath=False)
        total, start = fmt.varint_decode(comp)
        elems = comp[start:]
        for cap in (0, 40960, sidecar.DEPTH_TAIL_CAP, 65537):
            for tile in (128, sidecar.DEPTH_TILE, 4096, 65536):
                a = g.depth_hints(elems, total, cap, tile)
                s = g.depth_hints_sim(elems, total, cap, tile)
                assert np.array_equal(a, s), (len(data), cap, tile)


def test_depth_hint_analytic_matches_simulation_fuzz():
    # Fuzz leg of the analytic-vs-sim cross-check (both builders are
    # host-side C, so this is cheap): random mixtures of literal runs,
    # RLE runs and copied slices at random sizes, every stream checked
    # at two (cap, tile) points including the shipped one.
    from tpu_snappy.native import golden as g

    rng = np.random.default_rng(0xD5)
    words = [b"cat ", b"dog ", b"fish", b"\x00\x00", b"ab", b"Q"]
    for case in range(40):
        n = int(rng.integers(1, 60000))
        parts, size = [], 0
        while size < n:
            kind = int(rng.integers(0, 3))
            if kind == 0:       # random literals
                ln = int(rng.integers(1, 300))
                parts.append(bytes(rng.integers(0, 256, ln, dtype=np.uint8)))
            elif kind == 1:     # run
                ln = int(rng.integers(4, 2000))
                parts.append(bytes([int(rng.integers(0, 256))]) * ln)
            else:               # text-ish repetition
                ln = int(rng.integers(1, 40))
                parts.append(words[int(rng.integers(0, len(words)))] * ln)
            size += len(parts[-1])
        data = b"".join(parts)[:n]
        comp = api.compress(data, small_fastpath=False)
        total, start = fmt.varint_decode(comp)
        elems = comp[start:]
        for cap, tile in ((sidecar.DEPTH_TAIL_CAP, sidecar.DEPTH_TILE),
                          (int(rng.choice([0, 40960, 65537])),
                           int(rng.choice([128, 512, 4096])))):
            a = g.depth_hints(elems, total, cap, tile)
            s = g.depth_hints_sim(elems, total, cap, tile)
            assert np.array_equal(a, s), (case, n, cap, tile)


def test_corrupt_depth_hint_falls_back():
    # Depth hints never steer decoding: under- and over-declared depths
    # both decode exactly, with no chunk sent to the host.
    data = corpus.synth("text", 65536, 104)
    for delta in (-3, +2):
        fr = bytearray(framing.compress(data, sidecar="auto"))
        ip = len(framing.STREAM_ID)
        patched = 0
        while ip < len(fr):
            typ = fr[ip]
            ln = int.from_bytes(fr[ip + 1: ip + 4], "little")
            if typ == framing.CHUNK_DEPTH:
                off = ip + 4 + 12  # first depth byte
                fr[off] = max(0, fr[off] + delta)
                patched += 1
            ip += 4 + ln
        assert patched
        framing.decode_stats.clear()
        assert framing.decompress(bytes(fr)) == data
        assert framing.decode_stats["host_chunks"] == 0


def test_depth_hint_pipeline_mismatch_ignored():
    # A hint computed for different pipeline constants must parse to None
    # and route the chunk through the normal path.
    data = (b"ab" * 40000)[:65536]
    comp = api.compress(data, small_fastpath=False)
    total, start = fmt.varint_decode(comp)
    payload = bytearray(sidecar.build_depth(comp[start:], total) or b"")
    if payload:
        good = sidecar.parse_depth(bytes(payload))
        assert good is not None
        payload[4] ^= 1  # tail_cap mismatch
        assert sidecar.parse_depth(bytes(payload)) is None
    assert sidecar.parse_depth(b"tpD1" + b"\0" * 8) is None
    assert sidecar.parse_depth(b"") is None


def test_corrupt_sidecar_is_only_a_hint():
    mix = _mix()
    fr = bytearray(framing.compress(mix, sidecar="always"))
    ip = len(framing.STREAM_ID)
    flipped = 0
    while ip < len(fr):
        typ = fr[ip]
        ln = int.from_bytes(fr[ip + 1: ip + 4], "little")
        if typ == framing.CHUNK_SIDECAR and flipped < 2:
            fr[ip + 4 + 10] ^= 0xFF  # corrupt a piece entry
            flipped += 1
        ip += 4 + ln
    assert flipped
    assert framing.decompress(bytes(fr)) == mix  # falls back, still exact


def test_truncated_sidecar_is_ignored():
    mix = _mix()
    fr = framing.compress(mix, sidecar="always")
    # Rewrite every sidecar to garbage of the same length: parse() must
    # reject them and the stream must still decode on the normal path.
    out = bytearray()
    out += framing.STREAM_ID
    ip = len(framing.STREAM_ID)
    while ip < len(fr):
        typ = fr[ip]
        ln = int.from_bytes(fr[ip + 1: ip + 4], "little")
        chunk = bytearray(fr[ip: ip + 4 + ln])
        if typ == framing.CHUNK_SIDECAR:
            chunk[4:] = b"\xaa" * ln
        out += chunk
        ip += 4 + ln
    assert framing.decompress(bytes(out)) == mix


def test_adversarial_sidecar_payloads_never_corrupt():
    # Hardening: arbitrary bytes in a 0x80 chunk must never crash the
    # parser or corrupt output — parse() rejects or the CRC gate catches.
    rng = np.random.default_rng(99)
    data = b"the quick brown fox " * 600
    fr = framing.compress(data, sidecar="off")
    body = fr[len(framing.STREAM_ID):]
    for n in (0, 1, 7, 8, 37, 1000):
        junk = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        evil = (framing.STREAM_ID + bytes([framing.CHUNK_SIDECAR])
                + n.to_bytes(3, "little") + junk + body)
        assert framing.decompress(evil) == data
    # well-formed header + garbage piece tables (ascending starts forced)
    for p in (1, 5, 200):
        starts = np.sort(rng.choice(60000, p, replace=False)).astype("<u2")
        starts[0] = 0
        roots = rng.integers(0, 65536, p).astype("<u2")
        slopes = np.packbits(rng.integers(0, 2, p).astype(bool)).tobytes()
        payload = (b"tpS1" + np.uint32(p).tobytes() + starts.tobytes()
                   + roots.tobytes() + slopes)
        evil = (framing.STREAM_ID + bytes([framing.CHUNK_SIDECAR])
                + len(payload).to_bytes(3, "little") + payload + body)
        assert framing.decompress(evil) == data  # CRC gate -> fallback


def test_corrupt_data_chunk_still_raises():
    mix = _mix()
    fr = bytearray(framing.compress(mix, sidecar="always"))
    ip = len(framing.STREAM_ID)
    while ip < len(fr):
        typ = fr[ip]
        ln = int.from_bytes(fr[ip + 1: ip + 4], "little")
        if typ == framing.CHUNK_COMPRESSED:
            fr[ip + 4 + 9] ^= 0xFF
            break
        ip += 4 + ln
    with pytest.raises(ValueError, match="CRC"):
        framing.decompress(bytes(fr))


def test_streaming_decode_with_sidecars():
    mix = _mix()
    fr = framing.compress(mix, sidecar="always")
    for wave in (1, 2):
        dst = io.BytesIO()
        n = framing.decompress_stream(io.BytesIO(fr), dst,
                                      chunks_per_wave=wave)
        assert dst.getvalue() == mix and n == len(mix)


def test_streaming_encode_emits_sidecars():
    mix = _mix()
    dst = io.BytesIO()
    framing.compress_stream(io.BytesIO(mix), dst, len(mix), sidecar="always",
                            blocks_per_wave=2)
    assert dst.getvalue() == framing.compress(mix, sidecar="always")
    assert framing.decompress(dst.getvalue()) == mix
