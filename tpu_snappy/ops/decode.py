"""Vectorized Snappy decoder (JAX).

The reference never built decode — RoCC funct=1 is a stub that just sets
`busy` (CompressionAccelerator.scala:385-388); its only decode path is
software snappy::Uncompress (tests/swcompression.cc:31). This is a
first-class, fragment-parallel decoder:

  1. FRAGMENT: split the stream at 64 KB-output boundaries (a host/native
     scan, sr_scan_index; encoders — ours, google's — always fragment there,
     so elements never straddle). Fragments decode independently because
     match offsets are fragment-local by construction.
  2. PARSE: speculatively compute an element size for *every* compressed
     byte (as if it were a tag), then recover the true tag chain with the
     general segment-map scan (ops/scan.py) — jumps are unbounded here
     because literal elements can span the whole fragment.
  3. TRANSPORT: literal payload bytes scatter straight from the compressed
     buffer to their output positions (no gather).
  4. RESOLVE: back-reference copies form chains (offset < length => RLE);
     each output byte's ultimate *literal* source is found by pointer
     doubling over output positions — the parallel-decode trick the
     ACEAPEX-style absolute-offset formulation suggests — then one gather
     materializes the bytes.

Foreign streams that violate fragment locality (legal but never produced by
known encoders) are detected and routed to the sequential host decoder.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .. import format as fmt
from ..config import CodecConfig, DEFAULT_CONFIG
from . import scan


#: Per-fragment compressed capacity. A 64 KB fragment from any sane encoder
#: compresses to <= 65536 + headers; adversarial-but-valid streams (e.g. all
#: 1-byte copies) can exceed this and fall back to sequential decode.
FRAG_CAP = 68 * 1024

OUT = fmt.BLOCK_SIZE

#: Sparse-resolve extraction width (hybrid path): the dense doubling loop
#: runs until the moving set fits this many lanes, then the sparse chase
#: takes over on the extracted lanes.
SPARSE_CAP = 12288


def _scatter_out(dest: jax.Array, values: jax.Array) -> jax.Array:
    """Additive scatter onto a 64K output block (dest == 65536 drops).
    Duplicate destinations SUM (the transport scatter relies on this:
    tag-descriptor and payload sources share cells via disjoint bit
    ranges). Returns (65536,) int32 with unwritten cells 0."""
    return jnp.zeros(OUT + 1, jnp.int32).at[dest].add(values)[:OUT]


def _elem_fields(c: jax.Array):
    """Speculative per-byte element decode (as if every byte were a tag).

    Returns (size, outbytes, is_lit, hdr, length, offset) — all (..., M) i32.
    """
    t = c.astype(jnp.int32)
    b1 = jnp.roll(t, -1, axis=-1)
    b2 = jnp.roll(t, -2, axis=-1)
    b3 = jnp.roll(t, -3, axis=-1)
    b4 = jnp.roll(t, -4, axis=-1)
    kind = t & 3
    code = t >> 2

    extra = jnp.clip(code - 59, 0, 4)
    ext_val = jnp.where(
        extra == 0, code,
        jnp.where(extra == 1, b1,
                  jnp.where(extra == 2, b1 | (b2 << 8),
                            jnp.where(extra == 3, b1 | (b2 << 8) | (b3 << 16),
                                      b1 | (b2 << 8) | (b3 << 16) | (b4 << 24)))))
    lit_len = ext_val + 1
    lit_hdr = 1 + extra
    lit_size = lit_hdr + lit_len

    copy_len = jnp.where(kind == 1, ((t >> 2) & 7) + 4, code + 1)
    copy_size = jnp.where(kind == 1, 2, jnp.where(kind == 2, 3, 5))
    copy_off = jnp.where(
        kind == 1, ((t >> 5) << 8) | b1,
        jnp.where(kind == 2, b1 | (b2 << 8),
                  b1 | (b2 << 8) | (b3 << 16) | (b4 << 24)))

    is_lit = kind == 0
    size = jnp.where(is_lit, lit_size, copy_size)
    outbytes = jnp.where(is_lit, lit_len, copy_len)
    hdr = jnp.where(is_lit, lit_hdr, copy_size)
    length = jnp.where(is_lit, lit_len, copy_len)
    return size, outbytes, is_lit, hdr, length, copy_off


def parse_transport(c: jax.Array, clen: jax.Array, ulen: jax.Array):
    """The decode front half: PARSE + TRANSPORT + run collapse.

    Returns (lit_out (65536,) i32 bytes, src (65536,) i32 one-step source
    map with src[p] <= p, ok bool) — exactly the RESOLVE stage's inputs.
    Factored out of decode_fragment so stage studies and alternative
    resolvers consume the identical front."""
    m = c.shape[-1]
    iota = jnp.arange(m, dtype=jnp.int32)

    size, outbytes, is_lit, hdr, _length, off = _elem_fields(c)

    # --- PARSE: true tag chain ---
    jump = jnp.clip(size, 1, None)
    tags = scan.commit_general(jump) & (iota < clen)

    # Output start position of each element; chain-consistency checks.
    opos = scan.exclusive_cumsum(jnp.where(tags, outbytes, 0))
    total_out = jnp.sum(jnp.where(tags, outbytes, 0))
    # The chain must consume exactly clen bytes: the last tag must end at clen.
    last_end = jnp.max(jnp.where(tags, iota + size, -1))
    ok = (total_out == ulen) & ((last_end == clen) | (clen == 0))
    # Copies must stay inside the fragment and behind the write head.
    bad_copy = tags & ~is_lit & ((off < 1) | (off > opos))
    ok &= ~jnp.any(bad_copy)

    # --- TRANSPORT: one fused scatter (compressed -> output space) ---
    # Literal payload bytes ride bits 0-7; the element descriptor rides
    # bits 8-24 at its element's output start, encoded as
    # `1` for a literal run and `offset + 1` for a copy (at most 2^24).
    # A tag source and a payload source can target the SAME cell (a
    # literal's first payload byte lands at its element's opos), but they
    # occupy disjoint bit ranges, so the duplicate-sum semantics compose
    # them exactly — one scatter instead of two.
    estart, eopos, ehdr, eislit = scan.ffill_many(
        tags, (iota, opos, hdr, is_lit.astype(jnp.int32)))
    is_payload = (eislit == 1) & (iota >= estart + ehdr) & (iota < clen)
    out_q = eopos + iota - estart - ehdr
    dump = OUT
    desc = jnp.where(is_lit, 1, jnp.clip(off, 0, OUT - 1) + 1)
    mdst = jnp.where(tags, jnp.minimum(opos, OUT),
                     jnp.where(is_payload, jnp.clip(out_q, 0, OUT), dump))
    mval = jnp.where(tags, desc << 8, c.astype(jnp.int32))
    merged = _scatter_out(mdst, mval)
    lit_out = merged & 0xFF
    o_desc = merged >> 8

    # --- RESOLVE: copy chains over output space ---
    oiota = jnp.arange(OUT, dtype=jnp.int32)
    desc_f = scan.ffill(o_desc != 0, o_desc)
    lit_f = desc_f == 1
    off_f = jnp.maximum(desc_f - 1, 0)

    # Periodic-run collapse (exact): maximal runs of contiguous copy
    # elements sharing one offset satisfy out[j] = out[j - off] throughout,
    # so any byte whose plain source falls INSIDE its own run resolves
    # arithmetically to the pre-run base region [run_start - off, run_start)
    # — no pointer-doubling needed. This removes the RLE worst case the
    # format's overlap semantics create (repeating-50000: 16 doubling
    # rounds -> 0; cross-window reference chains on text are unaffected
    # and still take ~6 rounds).
    src_plain = oiota - off_f
    is_start = o_desc != 0
    off_prev = jnp.roll(off_f, 1, axis=-1)
    lit_prev = jnp.roll(lit_f, 1, axis=-1)
    run_head = is_start & ~lit_f & (
        lit_prev | (off_prev != off_f) | (oiota == 0))
    rs_f = scan.ffill(run_head, oiota)
    base = rs_f - off_f
    offc = jnp.maximum(off_f, 1)
    src_mod = (oiota - base) % offc + base
    src = jnp.where(lit_f, oiota,
                    jnp.where(src_plain >= rs_f, src_mod, src_plain))
    src = jnp.clip(src, 0, OUT - 1)
    return lit_out, src, ok


def decode_fragment(c: jax.Array, clen: jax.Array, ulen: jax.Array,
                    resolve: str = "hybrid"):
    """Decode one fragment. c: (W,) uint8 zero-padded; clen/ulen scalars.
    resolve: copy-chain strategy — "hybrid" (dense doubling rounds while
    the moving set is large, then sort-extract + sparse pointer chase +
    sort-restore; see the inline analysis) or "plain" (dense doubling to
    the fixed point); identical results.
    Returns (out (65536,) uint8, ok bool)."""
    lit_out, src, ok = parse_transport(c, clen, ulen)
    oiota = jnp.arange(OUT, dtype=jnp.int32)

    # Pointer doubling to the fixed point (depth <= 65536 => <= 16 rounds;
    # chains always terminate: copy sources are strictly behind).
    if resolve == "hybrid":
        # Dense-then-sparse doubling. Measured depth distribution on text
        # (mtg, flattened streams): ~46% of bytes sit on chains deeper than
        # 8, so doubling must run dense while the unresolved set is large —
        # but it collapses fast past round ~5 (9.8K -> 3.6K -> 1K -> 0),
        # and the last ~4 full-table gather rounds touch 64K lanes to move
        # a few thousand. Instead, once the moving set fits CAP lanes:
        # extract (one 2-operand sort), CHASE pointers through the now-
        # frozen table with CAP-target gathers (the table is absorbing —
        # resolved entries are fixpoints, so stale reads stay exact and
        # every chase step advances 2^dense_rounds hops), and restore with
        # one more sort. Streams that resolve in <= 2 rounds (random;
        # repeating after run collapse) never enter the sparse while-loop.
        CAP = SPARSE_CAP
        mask = jnp.ones(OUT, jnp.bool_)
        cnt0, it0 = jnp.int32(OUT), jnp.int32(0)

        def dense_cond(c):
            _s, _m, cnt, it = c
            return (cnt > 0) & (it < 16) & ((it < 2) | (cnt > CAP))

        def dense_body(c):
            s, _m, _cnt, it = c
            s2 = s[s]
            m = s2 != s
            return s2, m, jnp.sum(m.astype(jnp.int32)), it + 1

        src, mask, cnt, _ = jax.lax.while_loop(
            dense_cond, dense_body, (src, mask, cnt0, it0))

        def sparse_cond(c):
            ran, cnt2 = c[0], c[1]
            return ~ran & (cnt2 > 0)

        def sparse_body(c):
            _ran, _cnt, s, m, _good = c
            # Unresolved-first extraction. `m` (moved last round) is a
            # sound over-approximation of "not yet at a literal": a lane
            # that did not move had a fixpoint (= literal) source already.
            key = jnp.where(m, oiota, oiota + (1 << 17))
            ks, qs = jax.lax.sort((key, s), num_keys=1)
            q = qs[:CAP]

            # Termination: when every pre-sparse round was a FULL dense
            # round exiting at round r with cnt <= CAP, each chase step
            # advances 2^r hops, bounding the chase at CAP/2^r + 1 <= 3073
            # steps. Convergence is still CHECKED rather than assumed: a
            # chase that hits the step cap marks the fragment not-ok and
            # the host decoder takes it (api.decompress fallback).
            def chase_cond(cc):
                _q, it, done = cc
                return ~done & (it < 8192)

            def chase_body(cc):
                q1, it, _done = cc
                q2 = s[q1]
                return q2, it + 1, jnp.all(q2 == q1)

            q, _, chase_done = jax.lax.while_loop(
                chase_cond, chase_body, (q, jnp.int32(0), jnp.bool_(False)))
            # Restore: the extraction rows are a permutation of all 64K
            # positions; one position-keyed sort puts the chased values
            # back. Position (16 bits) and value (16 bits) pack into one
            # u32 operand — a 1-operand sort beats the 2-operand form.
            allpos = (ks & 0xFFFF).astype(jnp.uint32)
            allval = jnp.concatenate([q, qs[CAP:]], axis=-1)
            packed = (allpos << 16) | allval.astype(jnp.uint32)
            s_new = (jnp.sort(packed, axis=-1) & 0xFFFF).astype(jnp.int32)
            return jnp.bool_(True), jnp.int32(0), s_new, m, chase_done

        _, _, src, _, chase_ok = jax.lax.while_loop(
            sparse_cond, sparse_body,
            (jnp.bool_(False), cnt, src, mask, jnp.bool_(True)))
        ok &= chase_ok
    elif resolve == "plain":
        def _cond(c):
            s, it, done = c
            return (it < 16) & ~done

        def _body(c):
            s, it, _ = c
            s2 = s[s]
            return s2, it + 1, jnp.all(s2 == s)

        src, _, _ = jax.lax.while_loop(
            _cond, _body, (src, jnp.int32(0), jnp.bool_(False)))
    else:
        raise ValueError(f"unknown resolve mode {resolve!r}")
    out = lit_out[src].astype(jnp.uint8)
    out = jnp.where(oiota < ulen, out, 0)
    return out, ok


@functools.partial(jax.jit, static_argnames=("resolve",))
def decode_fragments_jit(frags: jax.Array, clens: jax.Array,
                         ulens: jax.Array, resolve: str = "hybrid"):
    return jax.vmap(
        lambda c, cl, ul: decode_fragment(c, cl, ul, resolve)
    )(frags, clens, ulens)


def fragment_table(comp: bytes, start: int, total: int):
    """Host-side fragment split (native scan with Python fallback).

    Returns (frags (F, FRAG_CAP) uint8, clens (F,) i32, ulens (F,) i32).
    Raises ValueError for malformed streams; falls back to the sequential
    path by raising FragmentFallback for valid-but-exotic ones.
    """
    buf = np.frombuffer(comp, dtype=np.uint8)
    max_frags = total // fmt.BLOCK_SIZE + 2
    try:
        from ..native import golden
        offs, ulens, nfrag = golden.scan_index(comp, start, total, max_frags)
    except (ImportError, OSError, RuntimeError):
        offs, ulens, nfrag = _scan_index_py(buf, start, total, max_frags)
    offs = np.concatenate([offs[:nfrag], [len(comp)]]).astype(np.int64)
    clens = (offs[1:] - offs[:-1]).astype(np.int32)
    if nfrag == 0 or clens.max(initial=0) > FRAG_CAP:
        raise FragmentFallback("fragment exceeds parallel-decode capacity")
    frags = np.zeros((nfrag, FRAG_CAP), dtype=np.uint8)
    for i in range(nfrag):
        frags[i, : clens[i]] = buf[offs[i]: offs[i + 1]]
    return frags, clens, np.asarray(ulens[:nfrag], dtype=np.int32)


class FragmentFallback(Exception):
    """Stream is valid but not fragment-parallel decodable; use host path."""


def _scan_index_py(buf: np.ndarray, start: int, total: int, max_frags: int):
    """Pure-Python element walk (slow; only used without the native lib)."""
    ip, op = start, 0
    n = len(buf)
    offs, ulens = [], []
    frag_ip, frag_op = ip, 0
    while ip < n:
        tag = int(buf[ip])
        kind = tag & 3
        if kind == 0:
            code = tag >> 2
            if code < 60:
                outb = code + 1
                esize = 1 + outb
            else:
                extra = code - 59
                if ip + 1 + extra > n:
                    raise ValueError("truncated")
                outb = int.from_bytes(buf[ip + 1: ip + 1 + extra].tobytes(), "little") + 1
                esize = 1 + extra + outb
        else:
            esize = 2 if kind == 1 else 3 if kind == 2 else 5
            outb = (((tag >> 2) & 7) + 4) if kind == 1 else (tag >> 2) + 1
        if ip + esize > n:
            raise ValueError("truncated")
        ip += esize
        op += outb
        if op % fmt.BLOCK_SIZE == 0 or ip >= n:
            if op - frag_op > fmt.BLOCK_SIZE or len(offs) >= max_frags:
                raise FragmentFallback("exotic stream")
            offs.append(frag_ip)
            ulens.append(op - frag_op)
            frag_ip, frag_op = ip, op
        elif op // fmt.BLOCK_SIZE != (op - outb) // fmt.BLOCK_SIZE:
            raise FragmentFallback("element straddles fragment boundary")
    if op != total:
        raise ValueError("length mismatch vs preamble")
    return np.asarray(offs, np.int64), np.asarray(ulens, np.int64), len(offs)


def frag_width(clens) -> int:
    """Static fragment width for the jitted decoders: max compressed length
    rounded up to an 8 KB bucket (few jit variants, shapes stay sort/
    scatter-tile friendly). The transport scatter and the parse scans are
    MAC/step-proportional in the fragment width, and text compresses 64 KB
    to ~25 KB — running them at FRAG_CAP multiplies mostly zero padding."""
    m = int(np.max(clens)) if len(clens) else 0
    b = 8192
    return int(min(max(b, -(-m // b) * b), FRAG_CAP))


def decode_fragments(frags, clens, ulens, cfg: CodecConfig = DEFAULT_CONFIG):
    w = frag_width(np.asarray(clens))
    return decode_fragments_jit(jnp.asarray(frags[:, :w]),
                                jnp.asarray(clens), jnp.asarray(ulens))


@functools.partial(jax.jit, static_argnames=("resolve", "wave"))
def decode_corpus(frags: jax.Array, clens: jax.Array, ulens: jax.Array,
                  resolve: str = "hybrid", wave: int = 8):
    """Whole-corpus decode as ONE dispatched program (lax.map over waves of
    `wave` vmapped fragments) — the decode sibling of encode.encode_corpus:
    same results as decode_fragments_jit, single-wave compile cost, one
    per-dispatch fixed cost for the whole corpus."""
    nf = frags.shape[0]
    assert nf % wave == 0, "pad the fragment count to a wave multiple"
    fw = frags.reshape(nf // wave, wave, frags.shape[-1])
    cw = clens.reshape(nf // wave, wave)
    uw = ulens.reshape(nf // wave, wave)
    out, ok = jax.lax.map(
        lambda t: jax.vmap(
            lambda c, cl, ul: decode_fragment(c, cl, ul, resolve))(*t),
        (fw, cw, uw))
    return out.reshape(nf, -1), ok.reshape(nf)
