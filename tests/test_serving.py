"""Dynamic-batching codec server (tpu_snappy/serving.py).

Covers: concurrent round-trips bit-exact vs the golden codec, actual
batching (waves < units when requests overlap), per-request error
isolation inside a shared wave, exotic-stream host settlement, the host
fast-path for tiny requests, and close() drain semantics."""

import threading

import numpy as np
import pytest

from tpu_snappy import format as fmt, serving
from tpu_snappy.native import golden
from tpu_snappy.utils import corpus


def _text(n: int) -> bytes:
    return corpus.synth("text", n, 3)


def _rand(n: int, seed=3) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


def test_concurrent_compress_roundtrip_and_batching():
    payloads = [_text(70_000), _rand(66_000, 1), _text(130_000)[::-1],
                _rand(65_536, 2)]
    with serving.CodecServer(wave=4, max_wait_ms=200) as srv:
        futs = [srv.compress(p) for p in payloads]
        comps = [f.result(timeout=600) for f in futs]
        stats = srv.stats
    for p, c in zip(payloads, comps):
        assert golden.uncompress(c) == p
    # 4 requests -> 7 blocks; wave=4 must have coalesced across requests.
    assert stats.units == 7
    assert stats.waves <= 2
    assert stats.occupancy >= 7 / 8


def test_server_with_speed_preset():
    # A server constructed with a speed preset (server-level choice: one
    # cfg per wave graph) round-trips through the golden decoder and its
    # own decompress lane.
    from tpu_snappy.config import ULTRA_CONFIG
    payloads = [_text(70_000), _rand(66_000, 7)]
    with serving.CodecServer(cfg=ULTRA_CONFIG, wave=4,
                             max_wait_ms=200) as srv:
        comps = [f.result(timeout=600)
                 for f in [srv.compress(p) for p in payloads]]
        backs = [f.result(timeout=600)
                 for f in [srv.decompress(c) for c in comps]]
    for p, c, b in zip(payloads, comps, backs):
        assert golden.uncompress(c) == p
        assert b == p


def test_decompress_batches_and_matches():
    payloads = [_text(100_000), _rand(70_000)]
    comps = [golden.compress(p) for p in payloads]
    with serving.CodecServer(wave=4, max_wait_ms=200) as srv:
        futs = [srv.decompress(c) for c in comps]
        outs = [f.result(timeout=600) for f in futs]
    assert outs == payloads


def test_tiny_requests_host_fastpath():
    with serving.CodecServer(wave=4) as srv:
        futs = [srv.compress(bytes([i]) * (i + 1)) for i in range(20)]
        outs = [f.result(timeout=60) for f in futs]
        stats = srv.stats
    assert stats.host_fastpath == 20 and stats.waves == 0
    for i, c in enumerate(outs):
        assert golden.uncompress(c) == bytes([i]) * (i + 1)


def test_error_isolation_in_shared_wave():
    good = _text(80_000)
    comp_good = golden.compress(good)
    # Deterministically-invalid second stream: 64 KB of RLE 'x', then a
    # copy whose offset (65537) exceeds everything written (65536) — no
    # valid decode exists, in any decoder.
    bad = (b"\x84\x80\x04"
           + b"\x3c" + b"x" * 16
           + (b"\xfe\x10\x00" * 1023)
           + b"\xbe\x10\x00"
           + b"\x0f" + (65537).to_bytes(4, "little"))
    with serving.CodecServer(wave=4, max_wait_ms=200) as srv:
        f_good = srv.decompress(comp_good)
        f_bad = srv.decompress(bad)
        assert f_good.result(timeout=600) == good
        with pytest.raises(ValueError):
            f_bad.result(timeout=600)


def test_exotic_stream_settles_on_host():
    # Cross-fragment copy (valid, no encoder emits it): 64 KB of 'x' via
    # RLE, then a second fragment whose first element copies from the
    # first fragment. The device flags it; the server must settle the
    # request on the host and return the exact bytes.
    stream = (b"\x84\x80\x04"                     # varint 65540
              + b"\x3c" + b"x" * 16               # literal 16
              + (b"\xfe\x10\x00" * 1023)          # 1023 x copy2 len64 off16
              + b"\xbe\x10\x00"                   # copy2 len48 off16
              + b"\x0e\x10\x00")                  # frag2: copy2 len4 off16
    with serving.CodecServer(wave=4, max_wait_ms=100) as srv:
        out = srv.decompress(stream).result(timeout=600)
        stats = srv.stats
    assert out == b"x" * 65540
    # Fragment-granular settlement: only the flagged fragment re-decoded.
    assert stats.spliced_fragments == 1


def test_one_bad_fragment_splices_only_itself(monkeypatch):
    # Multi-wave request (3 fragments at wave=2) with exactly ONE exotic
    # fragment in the middle: the cross-fragment copy at fragment 1's
    # start fails the device's off<=opos check, fragments 0 and 2 pass.
    # Settlement must re-decode ONLY fragment 1 on the host (with the
    # spliced prefix as context), not the whole request.
    xblock = (b"\x3c" + b"x" * 16                 # literal 16
              + (b"\xfe\x10\x00" * 1023)          # 1023 x copy2 len64 off16
              + b"\xbe\x10\x00")                  # copy2 len48 off16
    frag1 = (b"\x0e\x10\x00"                      # copy2 len4 off16 (cross!)
             + fmt.literal_header(65532) + b"y" * 65532)
    total = 65536 + 65536 + 100
    stream = (fmt.varint_encode(total) + xblock + frag1
              + fmt.literal_header(100) + b"z" * 100)

    from tpu_snappy import reference_codec
    calls = []
    orig = reference_codec.decompress_elements

    def counting(buf, start, end, ctx):
        calls.append(end - start)
        return orig(buf, start, end, ctx)

    monkeypatch.setattr(reference_codec, "decompress_elements", counting)
    with serving.CodecServer(wave=2, max_wait_ms=100) as srv:
        out = srv.decompress(stream).result(timeout=600)
        stats = srv.stats
    assert out == b"x" * 65536 + b"x" * 4 + b"y" * 65532 + b"z" * 100
    assert stats.spliced_fragments == 1
    assert len(calls) == 1  # host element-decode ran for ONE fragment
    assert stats.waves >= 2  # the request genuinely spanned waves


def test_framed_serving_roundtrip_and_interop():
    from tpu_snappy import framing
    payloads = [_text(150_000),
                _rand(70_000, 9) + b"q" * 80_000]  # mixed + RLE chunk
    with serving.CodecServer(wave=4, max_wait_ms=200) as srv:
        futs = [srv.compress_framed(p, sidecar="auto") for p in payloads]
        frames = [f.result(timeout=600) for f in futs]
        backs = [srv.decompress_framed(fr).result(timeout=600)
                 for fr in frames]
        # sidecar="always": every compressed chunk rides the sidecar wave
        fr_sc = srv.compress_framed(payloads[0],
                                    sidecar="always").result(timeout=600)
        back_sc = srv.decompress_framed(fr_sc).result(timeout=600)
        stats = srv.stats
    for p, fr, b in zip(payloads, frames, backs):
        assert b == p
        # byte-identical to the framing module's one-shot container
        assert fr == framing.compress(p, sidecar="auto")
        # independent C++ framed decoder consumes it (sidecars skipped)
        assert golden.uncompress_framed(fr, max_out=len(p) + 16) == p
    assert back_sc == payloads[0]
    assert fr_sc == framing.compress(payloads[0], sidecar="always")
    assert stats.waves >= 1  # blocks genuinely rode device waves
    assert stats.spliced_fragments == 0  # sidecar path passed CRC cleanly


def test_framed_serving_corruption_raises():
    with serving.CodecServer(wave=4, max_wait_ms=100) as srv:
        fr = bytearray(srv.compress_framed(_text(70_000)).result(timeout=600))
        # flip a payload byte inside the first compressed chunk
        ip = 10  # skip stream id
        while ip < len(fr):
            typ = fr[ip]
            ln = int.from_bytes(fr[ip + 1: ip + 4], "little")
            if typ == 0x00:
                fr[ip + 4 + 8] ^= 0xFF
                break
            ip += 4 + ln
        with pytest.raises(ValueError):
            srv.decompress_framed(bytes(fr)).result(timeout=600)
        # and an uncompressed/empty stream settles inline
        from tpu_snappy import framing
        assert srv.decompress_framed(framing.STREAM_ID).result(
            timeout=60) == b""


def _oversize_framed_chunk(n: int = 65536) -> bytes:
    """A spec-valid framed COMPRESSED chunk whose payload exceeds the
    device fragment capacity: n bytes emitted as n 1-byte literals
    (2 bytes each -> ~128 KB > FRAG_CAP)."""
    from tpu_snappy import framing
    data = (b"\x5a\xa5" * ((n + 1) // 2))[:n]
    elems = b"".join(b"\x00" + data[i:i + 1] for i in range(n))
    payload = fmt.varint_encode(n) + elems
    body = framing.mask(framing.crc32c(data)).to_bytes(4, "little") + payload
    return (bytes([framing.CHUNK_COMPRESSED])
            + len(body).to_bytes(3, "little") + body), data


def test_framed_oversize_chunk_settles_on_host_not_wave():
    # A foreign all-literal chunk (> FRAG_CAP compressed) must never be
    # enqueued on a device wave: it decodes on the host, and a co-batched
    # normal request is unaffected (round-3 advisor medium finding).
    from tpu_snappy import framing
    from tpu_snappy.ops import decode as ops_decode
    chunk, data = _oversize_framed_chunk()
    assert len(chunk) - 4 - 4 > ops_decode.FRAG_CAP
    fr_bad = framing.STREAM_ID + chunk
    normal = _text(100_000)
    fr_ok = framing.compress(normal)
    with serving.CodecServer(wave=4, max_wait_ms=150) as srv:
        f1 = srv.decompress_framed(fr_bad)
        f2 = srv.decompress_framed(fr_ok)
        assert f1.result(timeout=600) == data
        assert f2.result(timeout=600) == normal
        stats = srv.stats
    assert stats.spliced_fragments >= 1  # the oversize chunk went host-side
    # parity: the framing module handles the same stream
    assert framing.decompress(fr_bad) == data


def test_framed_oversize_uncompressed_chunk_rejected():
    # Both framed decode entry points must enforce the 65536-byte cap on
    # UNCOMPRESSED chunks (round-3 advisor finding).
    from tpu_snappy import framing
    piece = b"x" * 70_000
    body = framing.mask(framing.crc32c(piece)).to_bytes(4, "little") + piece
    fr = (framing.STREAM_ID + bytes([framing.CHUNK_UNCOMPRESSED])
          + len(body).to_bytes(3, "little") + body)
    with pytest.raises(ValueError):
        framing.decompress(fr)
    with serving.CodecServer(wave=4, max_wait_ms=100) as srv:
        with pytest.raises(ValueError):
            srv.decompress_framed(fr).result(timeout=60)


def test_many_threads_submit():
    payloads = {i: _rand(65_536 + 137 * i, seed=i) for i in range(6)}
    results = {}
    with serving.CodecServer(wave=8, max_wait_ms=100) as srv:
        def work(i):
            comp = srv.compress(payloads[i]).result(timeout=600)
            results[i] = srv.decompress(comp).result(timeout=600)
        threads = [threading.Thread(target=work, args=(i,))
                   for i in payloads]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert results == payloads


def test_mesh_serving_matches_single_device():
    # Same server semantics over the virtual 8-device DP mesh: each
    # dispatch spans the mesh (wave x 8 slots), results are bit-identical
    # to the single-device path and golden-decodable.
    from tpu_snappy.parallel import mesh as meshlib
    mesh = meshlib.make_mesh(8)
    payloads = [_text(65_536 * 2), _rand(65_536 + 5)]
    with serving.CodecServer(wave=1, max_wait_ms=150, mesh=mesh) as srv:
        comps = [f.result(timeout=600)
                 for f in [srv.compress(p) for p in payloads]]
        futs = [srv.decompress(c) for c in comps]
        outs = [f.result(timeout=600) for f in futs]
        stats = srv.stats
    assert outs == payloads
    for p, c in zip(payloads, comps):
        assert golden.uncompress(c) == p
        from tpu_snappy import api
        assert c == api.compress(p, small_fastpath=False)
    assert stats.waves >= 2  # one encode + one decode dispatch at least


def test_request_spanning_multiple_waves():
    # A 6-block request at wave=4 spans two dispatches; assembly must
    # stitch parts in order across waves.
    data = _text(65_536 * 5 + 1234)
    with serving.CodecServer(wave=4, max_wait_ms=50) as srv:
        comp = srv.compress(data).result(timeout=600)
        back = srv.decompress(comp).result(timeout=600)
        stats = srv.stats
    assert back == data and golden.uncompress(comp) == data
    assert stats.waves >= 4  # 2 encode + 2 decode dispatches


def test_latency_stats_and_backpressure():
    data = _text(65_536 * 2)
    with serving.CodecServer(wave=2, max_wait_ms=20, max_pending=4) as srv:
        futs = [srv.compress(data) for _ in range(3)]  # blocks when full
        for f in futs:
            assert golden.uncompress(f.result(timeout=600)) == data
        pct = srv.stats.latency_percentiles()
    assert pct["p50"] is not None and pct["p99"] >= pct["p50"] > 0
    assert len(srv.stats.latencies_s) == 3


def test_close_rejects_new_work():
    srv = serving.CodecServer(wave=2, max_wait_ms=10)
    fut = srv.compress(_text(65_536 * 2))
    srv.close()
    assert golden.uncompress(fut.result(timeout=60)) == _text(65_536 * 2)
    with pytest.raises(RuntimeError):
        srv.compress(_text(70_000))

def test_pipeline_depth_variants_roundtrip():
    # The batcher's wave pipeline (PIPELINE_DEPTH in-flight waves before
    # the oldest syncs) must be correctness-neutral at any depth — depth
    # 1 reproduces the old sync-per-wave behavior, deeper pipelines only
    # reorder host-side completion.
    payloads = [_text(70_000), _rand(66_000, 4), _text(100_000)]
    comps = [golden.compress(p) for p in payloads]
    for depth in (1, 3):
        with serving.CodecServer(wave=4, max_wait_ms=50) as srv:
            srv.PIPELINE_DEPTH = depth
            futs = [srv.compress(p) for p in payloads]
            dfuts = [srv.decompress(c) for c in comps]
            for p, f in zip(payloads, futs):
                assert golden.uncompress(f.result(timeout=600)) == p, depth
            for p, f in zip(payloads, dfuts):
                assert f.result(timeout=600) == p, depth
