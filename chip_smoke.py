"""Smoke run of the codec's main path on an NVIDIA GPU.

    python chip_smoke.py            # one card: every phase below
    python chip_smoke.py --four     # four cards: the data-parallel path only

Drives the normal entry points (api, framing, serving, parallel) on seeded
data: 64 MiB of English-like text (1,024 blocks) plus 8 MiB each of random
and repeating bytes. Every result is compared bit-exactly with the C++
golden codec (and the system libsnappy where present), and every phase
must do its work on the device: the host-decode counters that api, framing
and serving keep (fragments re-decoded on the host, streams refused by the
fragment table, framed chunks sent to the host decoder or rejected by
their CRC) must all stay at zero.

Earlier lines report the card, the compile check and per-phase wall times
(bring-up readings, not benchmark metrics). The last line of standard
output is one JSON object naming the device. Any failure, and a run that
finds no GPU, exits non-zero without that line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from tpu_snappy import api, framing
from tpu_snappy import format as fmt
from tpu_snappy.config import (DEFAULT_CONFIG, FAST_CONFIG, TURBO_CONFIG,
                               ULTRA_CONFIG)
from tpu_snappy.native import golden, realsnappy
from tpu_snappy.utils import corpus

MIB = 1 << 20
#: The smoke's scale: 64 MiB of text (1,024 blocks); the random and
#: repeating inputs are an eighth of it each.
TEXT_BYTES = 64 * MIB


def log(*a) -> None:
    print(*a, flush=True)


def card_line() -> str:
    """`name, power.limit` of the first card, read by nvidia-smi in a child
    process that never imports JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def smoke_data(seed: int, text_bytes: int, other_bytes: int) -> dict:
    """The seeded inputs: text, random bytes, one repeated byte."""
    rng = np.random.default_rng(seed)
    return {
        "text": corpus.synth("text", text_bytes, seed),
        "random": rng.integers(0, 256, other_bytes, np.uint8).tobytes(),
        "repeating": corpus.synth("repeating", other_bytes),
    }


@contextlib.contextmanager
def no_host_work(server=None):
    """Clear the host-decode counters, run the body, then fail unless every
    counter is still zero (the device did all the decode work)."""
    api.host_decodes.clear()
    framing.decode_stats.clear()
    yield
    host = {
        "api fragments re-decoded on host": api.host_decodes["fragments"],
        "api streams refused to host": api.host_decodes["streams"],
        "framed chunks decoded on host": framing.decode_stats["host_chunks"],
        "framed sidecars failing CRC": framing.decode_stats[
            "sidecar_rejected"],
    }
    if server is not None:
        host["served fragments re-decoded on host"] = (
            server.stats.spliced_fragments)
        host["served streams refused to host"] = (
            server.stats.fallback_streams)
    bad = {k: v for k, v in host.items() if v}
    assert not bad, f"host fallbacks: {bad}"


def _foreign_streams(data: bytes) -> dict:
    streams = {"golden": golden.compress(data)}
    if realsnappy.available():
        streams["libsnappy"] = realsnappy.compress(data)
    return streams


def check_compile(text: bytes, wave: int = api.API_WAVE) -> dict:
    """Compile encode_corpus and decode_corpus at the shapes api uses for
    `text`, and report their memory analysis."""
    from tpu_snappy.ops import decode as ops_decode
    from tpu_snappy.ops import encode as ops_encode

    blocks, lengths = api._to_blocks(text, fmt.BLOCK_SIZE)
    pad = -len(lengths) % wave
    blocks = np.pad(blocks, ((0, pad), (0, 0)))
    lengths = np.pad(lengths, (0, pad))
    comp = golden.compress(text)
    total, start = fmt.varint_decode(comp)
    frags, clens, ulens = ops_decode.fragment_table(comp, start, total)
    w = ops_decode.frag_width(clens)
    pad = -len(clens) % wave
    frags = np.pad(frags[:, :w], ((0, pad), (0, 0)))
    clens = np.pad(clens, (0, pad))
    ulens = np.pad(ulens, (0, pad))
    out = {}
    for name, fn, args, kw in (
            ("encode_corpus", ops_encode.encode_corpus, (blocks, lengths),
             {"cfg": DEFAULT_CONFIG, "wave": wave}),
            ("decode_corpus", ops_decode.decode_corpus,
             (frags, clens, ulens), {"wave": wave})):
        t0 = time.perf_counter()
        compiled = fn.lower(*args, **kw).compile()
        out[name] = time.perf_counter() - t0
        log(f"compile {name} {args[0].shape}: {out[name]:.3f} s; "
            f"memory_analysis: {compiled.memory_analysis()}")
    return out


def check_api(data: dict) -> dict:
    """Default preset through api.compress/decompress: our streams decode
    under the goldens, the text stream is no larger than the golden's
    baseline (software-Snappy emulating) output, and the device decodes
    our streams and the goldens' with no host work."""
    sizes = {}
    with no_host_work():
        for name, d in data.items():
            comp = api.compress(d)
            assert golden.uncompress(comp) == d, f"{name}: golden decode"
            if realsnappy.available():
                assert realsnappy.uncompress(comp) == d, \
                    f"{name}: libsnappy decode"
            base = len(golden.compress(d, golden.MODE_BASELINE))
            sizes[name] = (len(comp), base)
            assert api.decompress(comp) == d, f"{name}: device decode"
            for src, stream in _foreign_streams(d).items():
                assert api.decompress(stream) == d, \
                    f"{name}: device decode of the {src} stream"
    ours, base = sizes["text"]
    assert ours <= base, f"text: {ours} B > golden baseline {base} B"
    return sizes


def check_presets(text: bytes) -> dict:
    """FAST, TURBO and ULTRA round-trip bit-exactly."""
    sizes = {}
    with no_host_work():
        for name, cfg in (("fast", FAST_CONFIG), ("turbo", TURBO_CONFIG),
                          ("ultra", ULTRA_CONFIG)):
            comp = api.compress(text, cfg)
            assert golden.uncompress(comp) == text, f"{name}: golden decode"
            assert api.decompress(comp) == text, f"{name}: device decode"
            sizes[name] = len(comp)
    return sizes


def check_framing(data: dict) -> dict:
    """framing.compress/decompress under sidecar policies auto (0x81 depth
    hints on text) and always (0x80 root maps), exact on the device with
    no fallbacks, and readable by the golden framed decoder; under always,
    chunks decode through their root maps."""
    blob = b"".join(data.values())
    out = {}
    for policy in ("auto", "always"):
        with no_host_work():
            fr = framing.compress(blob, sidecar=policy)
            assert golden.uncompress_framed(fr, max_out=len(blob) + 1) \
                == blob, f"{policy}: golden framed decode"
            assert framing.decompress(fr) == blob, f"{policy}: device decode"
            out[policy] = {"bytes": len(fr),
                           "sidecar_chunks": framing.decode_stats["sidecar"]}
    assert out["always"]["sidecar_chunks"] > 0, \
        "always: no chunk decoded through its sidecar"
    return out


def check_serving(text: bytes, seed: int, n_requests: int = 16,
                  lo: int = 1 * MIB, hi: int = 8 * MIB, mesh=None) -> dict:
    """A CodecServer answers n_requests concurrent requests, half compress
    and half decompress (of golden streams), sized lo..hi bytes, exactly
    and with no host re-decodes."""
    from tpu_snappy.serving import CodecServer

    rng = np.random.default_rng(seed)
    hi = min(hi, len(text) // 2)
    lo = min(lo, hi)
    jobs = []
    for i in range(n_requests):
        n = int(rng.integers(lo, hi + 1))
        off = int(rng.integers(0, len(text) - n + 1))
        piece = text[off: off + n]
        jobs.append(("compress", piece, piece) if i % 2 == 0 else
                     ("decompress", golden.compress(piece), piece))
    with CodecServer(mesh=mesh) as srv, no_host_work(srv):
        with ThreadPoolExecutor(n_requests) as pool:
            futs = [pool.submit(getattr(srv, kind), arg)
                    for kind, arg, _ in jobs]
            results = [f.result().result(timeout=900) for f in futs]
        for (kind, _arg, want), got in zip(jobs, results):
            back = golden.uncompress(got) if kind == "compress" else got
            assert back == want, f"served {kind} of {len(want)} B"
        stats = srv.stats
    assert stats.host_fastpath == 0, "a request took the host path"
    return {"requests": stats.requests, "waves": stats.waves,
            "occupancy": stats.occupancy}


def check_four(text: bytes, seed: int, lo: int = 1 * MIB,
               hi: int = 8 * MIB) -> dict:
    """Block DP over a 4-device mesh: streams byte-identical to one device,
    exact decode, a meshed CodecServer, and streaming over the mesh."""
    import io

    import jax

    from tpu_snappy.parallel import mesh as meshlib, shard, streaming

    mesh = meshlib.make_mesh(4)
    assert len({d.id for d in mesh.devices.flat}) == 4, "mesh devices"
    probe = jax.device_put(np.zeros((8, 16), np.uint8),
                           meshlib.block_sharding(mesh))
    placed = {s.device.id for s in probe.addressable_shards}
    assert len(placed) == 4, f"shards placed on devices {sorted(placed)}"
    with no_host_work():
        comp4 = shard.encode_dp(text, mesh)
        log("four: encode_dp on 4 devices done")
        comp1 = shard.encode_dp(text, meshlib.make_mesh(1))
        assert comp4 == comp1, "4-device stream != 1-device stream"
        assert golden.uncompress(comp4) == text, "golden decode"
        log("four: 4-device stream == 1-device stream")
        assert shard.decode_dp(comp4, mesh) == text, "4-device decode"
        log("four: decode_dp exact")
        dst = io.BytesIO()
        streaming.compress_stream(io.BytesIO(text), dst, len(text), mesh)
        assert dst.getvalue() == comp4, "streamed stream != one-shot"
        log("four: streaming over the mesh == one-shot")
    served = check_serving(text, seed, n_requests=8, lo=lo, hi=hi,
                           mesh=mesh)
    return {"devices": sorted(placed), "bytes": len(comp4), **served}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card data-parallel path")
    args = ap.parse_args(argv)

    import jax

    from tpu_snappy.utils import compile_cache

    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU found (JAX platform {dev.platform!r})",
              file=sys.stderr)
        return 2
    need = 4 if args.four else 1
    if len(devices) < need:
        print(f"chip_smoke: {need} GPUs needed, {len(devices)} found",
              file=sys.stderr)
        return 2
    card = card_line()
    log(f"card: {card}")
    log(f"device_kind: {dev.device_kind}; devices: {len(devices)}; "
        f"jax {jax.__version__}; compile cache: {compile_cache.enable()}; "
        f"libsnappy: {'present' if realsnappy.available() else 'absent'}; "
        f"seed: {args.seed}")

    data = smoke_data(args.seed, TEXT_BYTES, TEXT_BYTES // 8)
    phases = ([("four", lambda: check_four(data["text"], args.seed))]
              if args.four else [
        ("compile", lambda: check_compile(data["text"])),
        ("api", lambda: check_api(data)),
        ("presets", lambda: check_presets(data["text"])),
        ("framing", lambda: check_framing(data)),
        ("serving", lambda: check_serving(data["text"], args.seed)),
    ])
    for name, fn in phases:
        t0 = time.perf_counter()
        facts = fn()
        dt = time.perf_counter() - t0
        log(f"phase {name}: ok in {dt:.3f} s wall [{card}]: {facts}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
