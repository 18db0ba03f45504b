"""Benchmark driver: one JSON line on stdout, detail on stderr.

Headline metric: encode throughput (GB/s per device) on seeded English-like
text (corpus.synth "text", --mib MiB from --seed), with round-trip
correctness and the software-Snappy ratio bar checked in the same run.

Timing: ITERS dispatches per window, timed to jax.block_until_ready on the
last output (the device queue runs them in order); compilation and two
warm-up passes run before each window. A run that finds no GPU fails.
"""

import json
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


#: Blocks/fragments per vmapped wave inside the single-dispatch corpus
#: programs (the whole input is one lax.map over waves). Not yet swept on
#: the GPU.
ENC_WAVE = 24
DEC_WAVE = 24
SPEED_WAVE = 48


def main():
    import argparse
    import contextlib

    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", metavar="DIR", default=None,
                    help="capture a jax.profiler trace of the timed encode "
                         "passes into DIR (the VCD-waveform role of the "
                         "reference's Treadle/Verilator flows — view with "
                         "tensorboard or xprof)")
    ap.add_argument("--mib", type=int, default=3,
                    help="MiB of seeded text (default 3 = 48 blocks)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from tpu_snappy import format as fmt
    from tpu_snappy.config import DEFAULT_CONFIG
    from tpu_snappy.native import golden
    from tpu_snappy.ops import decode as ops_decode
    from tpu_snappy.ops import encode as ops_encode
    from tpu_snappy.parallel import shard
    from tpu_snappy.utils import compile_cache, corpus

    compile_cache.enable()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench: no GPU found (platform {dev.platform!r})")
    log(f"device: {dev} ({dev.platform}, {dev.device_kind}, "
        f"{len(jax.devices())} devices)")

    data = corpus.synth("text", args.mib << 20, args.seed)
    n = len(data)
    nblocks = -(-n // fmt.BLOCK_SIZE)
    nwaves = -(-nblocks // ENC_WAVE)
    arr, lengths, _ = shard.blocks_of(data, fmt.BLOCK_SIZE, nwaves * ENC_WAVE)

    blocks_d = jax.device_put(arr)
    lens_d = jax.device_put(lengths)

    # One dispatched program per corpus pass (lax.map over WAVE-block
    # vmapped waves): same compile cost as a single wave, and the per-
    # dispatch fixed cost is paid once per pass instead of once per wave.
    enc = jax.jit(lambda b, l: ops_encode.encode_corpus(
        b, l, DEFAULT_CONFIG, wave=ENC_WAVE))

    # Warmup/compile, and correctness capture.
    t0 = time.time()
    out_np, lens_np = [np.asarray(x) for x in enc(blocks_d, lens_d)]
    log(f"encode compile+first corpus pass: {time.time()-t0:.1f}s")

    comp = fmt.varint_encode(n) + b"".join(
        out_np[i, : lens_np[i]].tobytes() for i in range(nblocks))
    csize = len(comp)

    # Correctness + ratio vs the independent C++ golden codec.
    rt_ok = golden.uncompress(comp) == data
    gsize = len(golden.compress(data))
    ratio_ok = csize <= gsize
    log(f"round-trip vs C++ golden: {rt_ok}; size {csize} vs snappy {gsize}"
        f" ({'-' if ratio_ok else '+'}{abs(1 - csize/gsize)*100:.2f}%)")

    # BASELINE.md's bar taken literally: bit-for-bit decompressible by
    # ACTUAL google/snappy (system libsnappy), ratio at-or-below its output.
    from tpu_snappy.native import realsnappy
    real_rt = real_ratio = None
    if realsnappy.available():
        real_rt = realsnappy.uncompress(comp) == data
        rsize = len(realsnappy.compress(data))
        real_ratio = round(csize / rsize, 4)
        log(f"round-trip vs REAL google/snappy: {real_rt}; "
            f"size vs its {rsize} (ratio {real_ratio})")

    ITERS = 20

    def window(fn, *a, iters=ITERS):
        """Seconds for `iters` back-to-back calls after two warm-ups."""
        for _ in range(2):
            jax.block_until_ready(fn(*a))
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*a)
        jax.block_until_ready(out)
        return time.perf_counter() - t0

    trace_ctx = (jax.profiler.trace(args.trace)
                 if args.trace else contextlib.nullcontext())
    with trace_ctx:
        dt = window(enc, blocks_d, lens_d)
    enc_gbps = n * ITERS / dt / 1e9
    log(f"encode: {ITERS} x {n/1e6:.1f} MB in {dt:.3f}s -> {enc_gbps:.3f} GB/s/chip")

    # The speed presets (config.FAST/TURBO/ULTRA_CONFIG).
    from tpu_snappy.config import FAST_CONFIG, TURBO_CONFIG, ULTRA_CONFIG
    presets = {}
    for name, cfg in (("fast", FAST_CONFIG), ("turbo", TURBO_CONFIG),
                      ("ultra", ULTRA_CONFIG)):
        encp = jax.jit(lambda b, l, cfg=cfg: ops_encode.encode_corpus(
            b, l, cfg, wave=SPEED_WAVE))
        nwp = -(-nblocks // SPEED_WAVE) * SPEED_WAVE
        arr_p, len_p, _ = shard.blocks_of(data, fmt.BLOCK_SIZE, nwp)
        bp, lp = jax.device_put(arr_p), jax.device_put(len_p)
        outp, lensp = [np.asarray(x) for x in encp(bp, lp)]
        compp = fmt.varint_encode(n) + b"".join(
            outp[i, : lensp[i]].tobytes() for i in range(nblocks))
        if golden.uncompress(compp) != data:
            raise AssertionError(f"{name} preset stream does not round-trip")
        gbps = n * ITERS / window(encp, bp, lp) / 1e9
        presets[name] = (gbps, round(len(compp) / gsize, 4))
        log(f"encode {name}: {gbps:.3f} GB/s/device "
            f"(size x{presets[name][1]} vs snappy)")

    # Sustained (in-graph) rate: one dispatch running R corpus passes in a
    # lax.fori_loop — removes the per-program launch overhead that
    # back-to-back dispatches pay.
    R = 10

    @jax.jit
    def enc_loop(b, l):
        # Two anti-optimization guards, both verified necessary: the carry
        # feeds a runtime-zero perturbation into the next pass's lengths
        # (else XLA hoists the loop-invariant body — an unguarded version
        # measured one pass instead of R), and the FULL output folds into
        # a checksum (else XLA dead-code-eliminates every stage the
        # returned manifest doesn't depend on).
        def body(_, carry):
            lens_prev, acc = carry
            pert = jnp.min(jnp.where(lens_prev < 0, 1, 0))
            out, lens2 = ops_encode.encode_corpus(
                b, l + pert, DEFAULT_CONFIG, wave=ENC_WAVE)
            return lens2, acc + jnp.sum(out.astype(jnp.uint32))
        return jax.lax.fori_loop(
            0, R, body, (jnp.zeros(b.shape[0], jnp.int32), jnp.uint32(0)))

    sus_gbps = n * 4 * R / window(enc_loop, blocks_d, lens_d, iters=4) / 1e9
    log(f"encode sustained (in-graph x{R}): {sus_gbps:.3f} GB/s/chip")

    # End-to-end: one full pass including device->host fetch and host
    # assembly, through DEVICE-SIDE COMPACTION (ops/encode.py
    # compact_blocks): the device scatters every block's exact bytes to
    # its manifest offset, so the host fetches ONE dense payload buffer
    # (bucketed slice) — no padded-capacity transfer, no per-block join.
    encc = jax.jit(lambda b, l: ops_encode.encode_corpus_compact(
        b, l, DEFAULT_CONFIG, wave=ENC_WAVE))
    BUCKET = 1 << 20

    def e2e_pass():
        dense, _lens, tt = encc(blocks_d, lens_d)
        total = int(tt)
        k = min(-(-total // BUCKET) * BUCKET, dense.shape[0])
        return fmt.varint_encode(n) + np.asarray(dense[:k])[:total].tobytes()

    comp2 = e2e_pass()  # warm (compile) + correctness
    assert comp2 == comp, "compacted stream mismatch"
    t0 = time.perf_counter()
    for _ in range(4):
        e2e_pass()
    t_pass = (time.perf_counter() - t0) / 4
    e2e_gbps = n / t_pass / 1e9
    t_fetch = t_pass - dt / ITERS  # fetch+assembly tail beyond device rate
    log(f"e2e (compacted): {t_pass*1e3:.1f} ms/pass -> {e2e_gbps:.3f} GB/s "
        f"(fetch+assembly tail {t_fetch*1e3:.1f} ms)")

    # Decode throughput on our own stream (same wave batching).
    total, start = fmt.varint_decode(comp)
    frags, clens, ulens = ops_decode.fragment_table(comp, start, total)
    frags = frags[:, : ops_decode.frag_width(clens)]
    nf = len(clens)
    nfw = -(-nf // DEC_WAVE)
    pad = nfw * DEC_WAVE - nf
    frags = np.pad(frags, ((0, pad), (0, 0)))
    clens = np.pad(np.asarray(clens, np.int32), (0, pad))
    ulens_p = np.pad(np.asarray(ulens, np.int32), (0, pad))
    dec = jax.jit(lambda f, c, u: ops_decode.decode_corpus(f, c, u, wave=DEC_WAVE))
    fd = jax.device_put(frags)
    cd = jax.device_put(clens)
    ud = jax.device_put(ulens_p)
    t0 = time.time()
    dout, dokv = dec(fd, cd, ud)
    dec_ok = bool(np.asarray(dokv)[:nf].all()) and b"".join(
        np.asarray(dout)[i, : ulens[i]].tobytes() for i in range(nf)) == data
    log(f"decode compile+first corpus pass: {time.time()-t0:.1f}s ok={dec_ok}")
    dec_gbps = n * ITERS / window(dec, fd, cd, ud) / 1e9
    log(f"decode: {dec_gbps:.3f} GB/s/chip")

    @jax.jit
    def dec_loop(f, c, u):
        # Same anti-hoist + anti-DCE guards as enc_loop: without the
        # output checksum XLA eliminates the whole resolve stage (ok does
        # not depend on it) and "sustained decode" measures the parse
        # front only.
        def body(_, carry):
            k, acc = carry
            pert = jnp.min(jnp.where(k, 0, 1))
            out, ok = ops_decode.decode_corpus(f, c, u + pert, wave=DEC_WAVE)
            return ok, acc + jnp.sum(out.astype(jnp.uint32))
        return jax.lax.fori_loop(
            0, R, body, (jnp.ones(f.shape[0], jnp.bool_), jnp.uint32(0)))

    dec_sus_gbps = n * 4 * R / window(dec_loop, fd, cd, ud, iters=4) / 1e9
    log(f"decode sustained (in-graph x{R}): {dec_sus_gbps:.3f} GB/s/chip")

    # Foreign-stream decode: the BASELINE interop bar is google-stream
    # correctness, so the perf story quotes its device throughput too.
    gcomp = golden.compress(data)
    gtotal, gstart = fmt.varint_decode(gcomp)
    gfrags, gclens, gulens = ops_decode.fragment_table(gcomp, gstart, gtotal)
    gw = ops_decode.frag_width(gclens)
    gnf = len(gclens)
    gpad = -gnf % DEC_WAVE
    gfd = jax.device_put(np.pad(np.asarray(gfrags)[:, :gw],
                                ((0, gpad), (0, 0))))
    gcd = jax.device_put(np.pad(np.asarray(gclens, np.int32), (0, gpad)))
    gud = jax.device_put(np.pad(np.asarray(gulens, np.int32), (0, gpad)))
    gok = bool(np.asarray(dec(gfd, gcd, gud)[1])[:gnf].all())
    foreign_gbps = n * ITERS / window(dec, gfd, gcd, gud) / 1e9
    log(f"decode (golden-encoded stream): {foreign_gbps:.3f} GB/s/device "
        f"ok={gok}")

    # Sidecar fast-decode (framed co-design, sidecar.py): the skippable
    # 0x80 chunk carries the resolved root map, so the device skips parse,
    # transport AND resolve — one scatter + ffill + byte gather. Size
    # overhead is measured and reported (it is the knob's cost).
    from tpu_snappy import sidecar as sc
    jobs = []
    side_bytes = 0
    for i in range(nf):
        elems = frags[i, : clens[i]].tobytes()
        payload = sc.build(elems, int(ulens[i]))
        assert payload is not None
        side_bytes += len(payload) + 4
        s2, vals = sc.prep_parent(*sc.parse(payload), int(ulens[i]))
        jobs.append((elems, int(ulens[i]), s2, vals))
    E, S, V, U = sc.pack_batch(jobs, pad_rows=-nf % DEC_WAVE)
    sfn = jax.jit(lambda e, s, v, u: sc.decode_corpus_sidecar(
        e, s, v, u, wave=DEC_WAVE))
    Ed, Sd, Vd, Ud = map(jax.device_put, (E, S, V, U))
    outs_np = np.asarray(sfn(Ed, Sd, Vd, Ud))
    side_exact = all(
        outs_np[j, : U[j]].tobytes()
        == data[j * fmt.BLOCK_SIZE: j * fmt.BLOCK_SIZE + U[j]]
        for j in range(nf))
    sidecar_gbps = n * ITERS / window(sfn, Ed, Sd, Vd, Ud) / 1e9
    sidecar_frac = side_bytes / csize
    log(f"decode sidecar path: {sidecar_gbps:.3f} GB/s/device "
        f"exact={side_exact}; sidecar bytes {side_bytes} "
        f"(+{100*sidecar_frac:.0f}% of payload)")
    if not side_exact:
        sidecar_gbps = None

    value = round(enc_gbps, 4)
    print(json.dumps({
        "metric": "encode_GBps_per_device_text"
                  + ("" if (rt_ok and ratio_ok and dec_ok) else "_INVALID"),
        "value": round(enc_gbps, 4),
        "unit": "GB/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "input_bytes": n,
        "seed": args.seed,
        "decode_GBps": round(dec_gbps, 4),
        "ratio_vs_snappy": round(csize / gsize, 4),
        "roundtrip_ok": bool(rt_ok),
        "roundtrip_vs_real_google_snappy": real_rt,
        "ratio_vs_real_google_snappy": real_ratio,
        "encode_e2e_GBps": round(e2e_gbps, 4),
        "e2e_fetch_tail_ms": round(t_fetch * 1e3, 2),
        "encode_sustained_GBps": round(sus_gbps, 4),
        "decode_sustained_GBps": round(dec_sus_gbps, 4),
        **{f"encode_{k}_GBps": round(v[0], 4) for k, v in presets.items()},
        **{f"encode_{k}_ratio_vs_snappy": v[1] for k, v in presets.items()},
        "ref_hw_size_vs_snappy": 1.5716,
        "decode_foreign_GBps": round(foreign_gbps, 4),
        "decode_sidecar_GBps": round(sidecar_gbps, 4) if sidecar_gbps else None,
        "sidecar_overhead_vs_payload": round(sidecar_frac, 4),
        # The reference RTL reports cycles in simulation only (3.50 cyc/B
        # encode steady state, benchmark/hw_results.csv:25).
        "ref_hw_encode_cyc_per_byte": 3.50,
    }))


if __name__ == "__main__":
    main()
