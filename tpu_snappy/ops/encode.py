"""Vectorized Snappy block encoder (JAX).

A from-scratch, data-parallel reformulation of the reference's encode
pipeline.
Where the RTL is a per-byte state machine —

  * MatchFinder streams 4-byte windows through a 512-entry hash table
    (MatchFinder.scala:26-77, HashTable.scala:11-54),
  * CopyCompress extends matches 4 comparator lanes per cycle
    (CopyCompress.scala:110-122),
  * the top module serializes literals through a 16-byte streamHolder and
    back-patches literal tags (CompressionAccelerator.scala:230-285),

— this encoder is four data-parallel stages over a whole 64 KB block:

  1. MATCH: sort (4-byte window, position) pairs; in sorted (rank) space the
     nearest previous occurrence of every window is an adjacent row, with
     equality already proven by key equality. No hash table, no collisions,
     denser candidates than any SRAM table. K (default 14) verified
     candidates per position, fed to the matcher in packed 16-bit pairs.
  2. EXTEND: stride-4 agreement chains turn per-position 4-byte matches into
     match lengths (roll-based capped run-length doubling — the VPU-wide
     replacement for the 4-lane comparator), then a max-plus cummax
     propagates suffix matches so chained copies of long matches and
     mid-match commits always have a candidate.
  3. COMMIT: the greedy parse (literal vs copy, pointer advance) becomes a
     bounded-state segment scan (ops/scan.py) — sound because no Snappy
     element advances more than 64 bytes.
  4. EMIT: element sizes -> exclusive scan -> byte offsets; tag/length/offset
     header bytes and literal payloads are scattered to their final positions
     (replacing streamHolder serialization + emptySpotAddr back-patching +
     the emitEmptyBytePos DMA barrier, MemoryController.scala:204,243-258).

Output parse differs from software Snappy's byte-for-byte (see the 4-byte
quantized extension below) but is valid Snappy at a comparable-or-better
ratio; bit-exact decompressibility is certified against the C++ golden
harness in tests.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .. import format as fmt
from ..config import CodecConfig, DEFAULT_CONFIG
from . import scan

N = fmt.BLOCK_SIZE  # 65536: fixed lane count of every per-position array

#: Windowed sticky-composition depth: composes the last 2**STICKY_LEVELS
#: stride-4 transfers. The chain horizon is 17 stride-4 steps (the capped
#: run-length doubling counts at most 16 links = 68 bytes), so a full
#: horizon needs 32 >= 17 transfers (5 levels); corpus-swept, 4 levels
#: (16 transfers — one short of the horizon) costs only +11 B on the whole
#: mtg corpus and 0 B on every BASELINE bar file, while cutting a fifth of
#: the matcher's K^2-membership work.
STICKY_LEVELS = 4

#: Inactive-destination sentinel of the placement sort (any value >= the
#: block capacity; dest << 8 | byte still fits a u32).
SENT = 1 << 20


def _windows_u32(block: jax.Array) -> jax.Array:
    """4-byte little-endian windows w[i] = bytes[i:i+4] (wraps at the end;
    callers mask the last 3 positions)."""
    b = block.astype(jnp.uint32)
    return (b
            | jnp.roll(b, -1, axis=-1) << 8
            | jnp.roll(b, -2, axis=-1) << 16
            | jnp.roll(b, -3, axis=-1) << 24)


def _window_keys(block: jax.Array, n: jax.Array, iota: jax.Array) -> jax.Array:
    """Pair-sort input keys: the 4-byte window at every valid position,
    0xFFFFFFFF past n-4 (sorts last)."""
    return jnp.where(iota <= n - 4, _windows_u32(block), jnp.uint32(0xFFFFFFFF))


def _window_keys_strided(block: jax.Array, n: jax.Array,
                         stride: int) -> jax.Array:
    """Sort keys for stride-spaced positions only. The 4-byte window at a
    stride-aligned position spans whole stride-aligned byte groups, so no
    strided memory access is needed at all: for stride 2 the window at
    position 2q is u16 words q and q+1 of the block; for stride 4 it IS
    u32 word q. Bit-identical to _window_keys(block, n, iota)[::stride]
    (tests assert it); replaces both the full 64K window build and the
    key[::stride] relayout on the strided-anchor path."""
    if stride == 2:
        v = jax.lax.bitcast_convert_type(
            block.reshape(N // 2, 2), jnp.uint16)
        w = v.astype(jnp.uint32) | (jnp.roll(v, -1).astype(jnp.uint32) << 16)
    elif stride == 4:
        w = jax.lax.bitcast_convert_type(block.reshape(N // 4, 4),
                                         jnp.uint32)
    else:
        raise ValueError("strided keys support stride 2 or 4")
    pos = jnp.arange(N // stride, dtype=jnp.int32) * stride
    return jnp.where(pos <= n - 4, w, jnp.uint32(0xFFFFFFFF))


def _expand_stride(x: jax.Array, stride: int) -> jax.Array:
    """Interleave stride-1 zero rows after each row of x, restoring the
    full position domain from a strided-anchor table (rows of x belong to
    positions 0, stride, 2*stride, ...)."""
    if stride == 1:
        return x
    z = jnp.zeros((x.shape[0], stride - 1) + x.shape[1:], x.dtype)
    return jnp.concatenate(
        [x[:, None, ...], z], axis=1
    ).reshape((x.shape[0] * stride,) + x.shape[1:])


def _candidate_offsets(key: jax.Array, n: jax.Array, iota: jax.Array, k: int,
                       flatten: str = "class", probes: int | None = None,
                       stride: int = 1, table: str = "points"):
    """Previous positions with an identical 4-byte window, as offsets
    (0 = no candidate). key: _window_keys output. Sort-based rank-space
    matcher: after sorting (window, position) pairs, the k-th previous
    occurrence of any window is exactly k rows up, with equality proven by
    key equality — denser and collision-free vs. any SRAM hash table
    (HashTable.scala keeps one 512-entry column and loses every collision).

    `probes` rank neighbors are probed, then deduped down to k-1 slots
    (+ the flattening slot): runs of identical bytes make every position in
    the run a previous occurrence, flooding the nearest ranks with the
    consecutive-offset ladder 1,2,3,… whose members are RLE-redundant with
    the smallest — dropping offsets equal to the previous probe + 1 frees
    slots for *structurally distinct* repeat distances (e.g. the period of
    a phrase whose body contains a byte run), which is what sticky chains
    actually need to survive. Carrying 12 deduped slots matches the parse
    quality of 16 raw ranks corpus-wide at 3/4 the restore-sort payload
    and half the sticky membership cost.

    Returns the (N, k) sticky-candidate table: column 0 is the gated
    chain-flattening choice (_flat_gate), columns 1..k-1 the deduped
    occurrence slots; every entry is window-verified by the sort."""
    r = max(probes or k, k)
    if flatten == "off":
        r = k  # legacy nearest-first table, no dedup
    # Strided anchors (cfg.stride > 1): match candidates only at every
    # stride-th position — the sort/probe/restore domain shrinks by the
    # stride while the rest of the pipeline is untouched (positions with
    # no candidates already parse as literals; match EXTENSION is
    # byte-granular, so strided anchors still cover odd content). All
    # emitted offsets become multiples of the stride; ratio cost measured
    # at stride 2 on K=3: mtg x1.23, real-50000 x1.26 vs software snappy
    # (the reference RTL's own point is x1.57).
    if stride > 1 and key.shape[0] == N:
        # Full-domain inputs: slice here (legacy/test path). encode_block
        # passes pre-strided keys from _window_keys_strided instead,
        # which skips the 64K window build and this relayout entirely.
        key = key[::stride]
        iota = iota[::stride]
    M = key.shape[0]
    w_s, pos_s = jax.lax.sort((key, iota), num_keys=2)

    rank = jnp.arange(M, dtype=jnp.int32)
    offs = []
    for shift in range(1, r + 1):
        prev_w = jnp.roll(w_s, shift, axis=-1)
        prev_pos = jnp.roll(pos_s, shift, axis=-1)
        same = (w_s == prev_w) & (rank >= shift) & (prev_pos <= n - 4) & (pos_s <= n - 4)
        offs.append(jnp.where(same, pos_s - prev_pos, 0))

    if flatten != "off":
        # Chain-flattening candidate, computed IN RANK SPACE so it rides
        # the restore sort in the payload slot of the dropped 16th-nearest
        # offset (payload count unchanged). "full": always the globally
        # oldest occurrence (the run head; positions within a run are
        # ascending) — minimal decode chain depth, some copy1 tags upgrade
        # to copy2. "class": the oldest occurrence that preserves the
        # nearest candidate's tag class — globally oldest when in class,
        # else the oldest of the K nearest. See _flat_gate for the commit
        # gate both modes share.
        run_start = (w_s != jnp.roll(w_s, 1, axis=-1)) | (rank == 0)
        first_pos = scan.ffill(run_start, pos_s)
        first = jnp.where(
            (w_s != jnp.uint32(0xFFFFFFFF)) & (first_pos < pos_s),
            pos_s - first_pos, 0)
        if flatten == "lift":
            # Digit-lift ancestor (decode co-design v2): instead of the
            # run-head ("first", depth-1 chains but far offsets) or the
            # nearest in-class occurrence (depth ~ occurrence count), point
            # at the occurrence whose index has the lowest nonzero base-16
            # digit cleared. Each hop zeroes one more low digit, so chain
            # depth <= number of base-16 digits (<= 4 for any run), while
            # 15/16 of hops span <= 16 occurrences (usually still copy1
            # class). Computed in rank space with three forward-fills: the
            # occurrence index q is rank minus the run head's rank, and the
            # latest D^j-aligned occurrence's position forward-fills from
            # the q % D^j == 0 marks (q == 0 marks every run head, so fills
            # never leak across runs).
            head_rank = scan.ffill(run_start, rank)
            q = rank - head_rank
            a1 = scan.ffill(q % 16 == 0, pos_s)
            a2 = scan.ffill(q % 256 == 0, pos_s)
            a3 = scan.ffill(q % 4096 == 0, pos_s)
            anc = jnp.where(q % 16 != 0, a1,
                            jnp.where(q % 256 != 0, a2,
                                      jnp.where(q % 4096 != 0, a3,
                                                first_pos)))
            lift = jnp.where(
                (w_s != jnp.uint32(0xFFFFFFFF)) & (anc < pos_s),
                pos_s - anc, 0)
        if flatten == "full":
            flat = first
        elif flatten == "lift":
            # Same class-preserving gate shape as "class", with the lift
            # ancestor in the oldest-occurrence role (first stays the
            # fallback when the position has no in-class lift).
            c0 = offs[0]
            in1 = [jnp.where((o > 0) & (o < fmt.COPY1_MAX_OFFSET), o, 0)
                   for o in offs]
            m1 = functools.reduce(jnp.maximum, in1)
            m2 = functools.reduce(jnp.maximum, offs)
            l1 = (lift > 0) & (lift < fmt.COPY1_MAX_OFFSET)
            flat = jnp.where(c0 < fmt.COPY1_MAX_OFFSET,
                             jnp.where(l1, lift, m1),
                             jnp.where(lift > 0, lift, m2))
        else:
            c0 = offs[0]
            in1 = [jnp.where((o > 0) & (o < fmt.COPY1_MAX_OFFSET), o, 0)
                   for o in offs]
            m1 = functools.reduce(jnp.maximum, in1)
            m2 = functools.reduce(jnp.maximum, offs)
            # (Probing run-relative ranks 32..512 for older in-class
            # occurrences was tried and changed nothing: cross-window probe
            # offsets rarely agree at stride 4, so the _flat_gate rejects
            # them. Measured chain depth on mtg is ~65 with ~2 KB hops —
            # near the class-preserving floor of 64K / 2KB = 32 — going
            # deeper is what flatten="full" trades tag bytes for.)
            f1 = (first > 0) & (first < fmt.COPY1_MAX_OFFSET)
            flat = jnp.where(c0 < fmt.COPY1_MAX_OFFSET,
                             jnp.where(f1, first, m1),
                             jnp.where(first > 0, first, m2))
        # Dedup-compact r ascending probes (valid entries are a prefix and
        # strictly increasing) into k-1 slots. A position inside a byte run
        # sees the contiguous offset ladder 1,2,…,m (every earlier run
        # position is an occurrence); those are RLE-redundant with offset 1.
        # Only that ladder is dropped — consecutive offsets NOT rooted at 1
        # encode distinct phase alignments to an earlier structure (e.g.
        # {14..21} around a 17-byte line period) and must survive, or
        # period-spanning sticky chains break. One fused elementwise pass.
        if table == "intervals":
            # Interval-set table (cfg.table docstring): the longest
            # maximal consecutive probe run NOT rooted at 1 becomes ONE
            # (lo, hi) pair in the last two slots. Probes within a run
            # are consecutive integers and each is sort-verified, so
            # every x in [lo, hi] is a verified occurrence offset —
            # interval membership in the sticky scan is exact. The
            # rank-13 ladder members that pinned K=14 (uniform regions,
            # e.g. 17-byte line periods over zero runs) ride the
            # interval instead of point slots.
            assert k % 2 == 0 and k >= 6 and r > k
            run_len = jnp.where(offs[0] > 0, 1, 0)
            best_len = jnp.zeros(M, jnp.int32)
            best_hi = jnp.zeros(M, jnp.int32)
            for j in range(1, r):
                step = (offs[j] == offs[j - 1] + 1) & (offs[j - 1] > 0)
                run_len = jnp.where(step, run_len + 1,
                                    jnp.where(offs[j] > 0, 1, 0))
                lo_j = offs[j] - run_len + 1
                take = (run_len >= 3) & (run_len > best_len) & (lo_j != 1)
                best_len = jnp.where(take, run_len, best_len)
                best_hi = jnp.where(take, offs[j], best_hi)
            ilo = jnp.where(best_len > 0, best_hi - best_len + 1, 0)
            ihi = jnp.where(best_len > 0, best_hi, 0)
            # Point slots: the usual root-ladder dedup, plus interval
            # members drop (slot demand, not information — they are in
            # [ilo, ihi]). The nearest probe always stays a point so
            # slot 0 keeps its nearest-candidate semantics.
            slots = [jnp.zeros(M, jnp.int32) for _ in range(k - 3)]
            cnt = jnp.zeros(M, jnp.int32)
            ladder = offs[0] == 1
            for j in range(r):
                kp = offs[j] > 0
                if j > 0:
                    step = offs[j] == offs[j - 1] + 1
                    kp &= ~(ladder & step)
                    ladder &= step
                    kp &= ~((offs[j] >= ilo) & (offs[j] <= ihi)
                            & (ilo > 0))
                for m in range(k - 3):
                    slots[m] = jnp.where(kp & (cnt == m), offs[j], slots[m])
                cnt += kp.astype(jnp.int32)
            offs = slots + [flat, ilo, ihi]
        elif r > k:
            slots = [jnp.zeros(M, jnp.int32) for _ in range(k - 1)]
            cnt = jnp.zeros(M, jnp.int32)
            ladder = offs[0] == 1
            for j in range(r):
                kp = offs[j] > 0
                if j > 0:
                    step = offs[j] == offs[j - 1] + 1
                    kp &= ~(ladder & step)
                    ladder &= step
                for m in range(k - 1):
                    slots[m] = jnp.where(kp & (cnt == m), offs[j], slots[m])
                cnt += kp.astype(jnp.int32)
            offs = slots + [flat]
        else:
            offs = offs[:k - 1] + [flat]

    # Back to position space: a second sort keyed by position, with
    # offsets (16-bit by construction) packed in pairs to halve the
    # payload operands. ODD k packs the last slot (the flattening offset)
    # into the free low half of the position key itself — positions are
    # unique, so (pos << 16 | off) sorts identically to pos and the
    # restore drops to ceil((k+1)/2) operands instead of k/2 + 1.
    if k % 2:
        skey = ((pos_s.astype(jnp.uint32) << 16)
                | (offs[k - 1] & 0xFFFF).astype(jnp.uint32))
        words = [
            offs[2 * j].astype(jnp.uint32)
            | (offs[2 * j + 1].astype(jnp.uint32) << 16)
            for j in range((k - 1) // 2)
        ]
        backall = jax.lax.sort((skey, *words), num_keys=1)
        flat_back = (backall[0] & 0xFFFF).astype(jnp.int32)
        back = backall[1:]
        assert flatten != "off", "odd k requires the flattening slot"
        out = []
        for p in back:
            out.append((p & 0xFFFF).astype(jnp.int32))
            out.append((p >> 16).astype(jnp.int32))
        pref = _flat_gate(flat_back, out[0])
        return _expand_stride(jnp.stack([pref] + out, axis=-1),
                              stride)  # (N, K)
    words = [
        offs[2 * j].astype(jnp.uint32)
        | (offs[2 * j + 1].astype(jnp.uint32) << 16)
        for j in range(k // 2)
    ]
    back = jax.lax.sort((pos_s, *words), num_keys=1)[1:]
    out = []
    for j, p in enumerate(back):
        out.append((p & 0xFFFF).astype(jnp.int32))
        out.append((p >> 16).astype(jnp.int32))
    if flatten == "off":
        return _expand_stride(jnp.stack(out[:k], axis=-1),
                              stride)  # (N, K) nearest-first
    if table == "intervals":
        # Layout: [pref, k-3 point slots, interval lo, interval hi] —
        # the flat slot (index k-3 post-restore) folds into pref as in
        # the point table; the interval pair stays in the last two
        # columns for the sticky scan's special-cased membership.
        pref = _flat_gate(out[k - 3], out[0])
        return _expand_stride(
            jnp.stack([pref] + out[:k - 3] + out[k - 2:k], axis=-1),
            stride)  # (N, K)
    # Column 0 drives the sticky default (the gated flat choice); chain
    # continuation only needs set membership, so flat takes the slot of the
    # dropped 16th-nearest candidate rather than growing K. Built in one
    # stack — no post-hoc concat rebuild of the (N, K) table.
    pref = _flat_gate(out[k - 1], out[0])
    return _expand_stride(jnp.stack([pref] + out[:k - 1], axis=-1),
                          stride)  # (N, K)


def _flat_gate(flat: jax.Array, c0: jax.Array) -> jax.Array:
    """Chain-flattening default choice (decode co-design).

    Naive nearest-candidate defaults make every repeat reference its
    *previous* occurrence, producing copy chains thousands of elements deep
    in natural text; the decoder's pointer doubling then needs ~log2(depth)
    full-block gather rounds. Referencing the OLDEST occurrence (`flat`,
    from _candidate_offsets — tag-class preserving by construction)
    collapses those chains at identical match length for genuine repeats,
    and measurably *improves* ratio on text (older verified matches extend
    at least as well). Ratio sweep of gates (mtg / repeating / real):

      * take flat only where it proves an 8-byte extension (the same flat
        offset at i+4 => bytes [i, i+8) match) — rejects periodic data,
        whose rotated windows first-occur at different distances and would
        break stride-4 chains (4x ratio loss on repeating-*);
      * keep the nearest when it is overlap-capable (c0 <= 68, RLE
        semantics can extend past any literal agreement) UNLESS the near
        chain itself breaks at stride 4 (no 8-byte extension => no RLE).
    """
    agree = (jnp.roll(flat, -4, axis=-1) == flat) & (flat > 0)
    agree_near = (jnp.roll(c0, -4, axis=-1) == c0) & (c0 > 0)
    return jnp.where(agree & ((c0 > 68) | ~agree_near), flat, c0)


def _sig_bit(x: jax.Array) -> jax.Array:
    """5-bit multiplicative-hash bucket of an offset, as a u32 one-bit
    signature. Knuth's golden-ratio constant decorrelates the consecutive
    offset ladders byte runs generate (low bits alone would collide the
    whole ladder into adjacent buckets)."""
    h = (x.astype(jnp.uint32) * jnp.uint32(0x9E3779B1)) >> 27
    return (jnp.uint32(1) << h).astype(jnp.uint32)


def _sticky_offsets_intervals(cands: jax.Array,
                              sticky: str = "exact") -> jax.Array:
    """Sticky composition over an interval-set candidate table
    (cfg.table='intervals'): columns [:-2] are point slots (column 0 the
    gated default), columns -2/-1 an inclusive verified-offset interval
    (lo, hi; lo == 0 = none). Membership adds two compares per test;
    interval state composes by intersection (cross terms between one
    window's points and the other's interval are dropped — an
    under-approximation that can only break a chain early). The final
    choice is exact-verified against the position's own table (points OR
    interval), so every emitted offset stays sort-verified."""
    # NOTE: this mirrors the compose/edge/verify structure of
    # _sticky_offsets / _sticky_offsets_sig with the interval plane and
    # membership term added, so the production forms stay unconditional.
    n = cands.shape[0]
    pts = cands[..., :-2]
    lo0 = cands[..., -2]
    hi0 = cands[..., -1]
    dflt = cands[..., 0]
    iota = jnp.arange(n, dtype=jnp.int32)

    def compose(shift, state):
        b_pts, b_lo, b_hi, b_d = state
        a_pts, a_lo, a_hi, a_d = (jnp.roll(state[0], shift, axis=0),
                                  jnp.roll(state[1], shift, axis=0),
                                  jnp.roll(state[2], shift, axis=0),
                                  jnp.roll(state[3], shift, axis=0))
        def in_ivl(x, lo, hi):
            return (x > 0) & (x >= lo) & (x <= hi) & (lo > 0)

        if sticky == "sig":
            mask = functools.reduce(
                jnp.bitwise_or,
                [jnp.where(b_pts[..., j] > 0, _sig_bit(b_pts[..., j]),
                           jnp.uint32(0)) for j in range(b_pts.shape[-1])])

            def in_b_scalar(x):
                return (x > 0) & (((mask & _sig_bit(x)) != 0)
                                  | in_ivl(x, b_lo, b_hi))

            def in_b_vec(x):  # x: (n, P)
                return (x > 0) & ((((mask[..., None] & _sig_bit(x)) != 0))
                                  | in_ivl(x, b_lo[..., None],
                                           b_hi[..., None]))
        else:
            def in_b_scalar(x):
                p = jnp.any((x[..., None] == b_pts) & (x[..., None] > 0),
                            axis=-1)
                return p | in_ivl(x, b_lo, b_hi)

            def in_b_vec(x):  # x: (n, P)
                p = jnp.any((x[..., None] == b_pts[..., None, :])
                            & (x[..., None] > 0), axis=-1)
                return p | in_ivl(x, b_lo[..., None], b_hi[..., None])

        keep = jnp.where(in_b_vec(a_pts), a_pts, 0)
        nlo = jnp.maximum(a_lo, b_lo)
        nhi = jnp.minimum(a_hi, b_hi)
        valid = (a_lo > 0) & (b_lo > 0) & (nlo <= nhi)
        nlo = jnp.where(valid, nlo, 0)
        nhi = jnp.where(valid, nhi, 0)
        d = jnp.where(in_b_scalar(a_d), a_d, b_d)
        edge = (iota < shift)
        keep = jnp.where(edge[..., None], b_pts, keep)
        nlo = jnp.where(edge, b_lo, nlo)
        nhi = jnp.where(edge, b_hi, nhi)
        d = jnp.where(edge, b_d, d)
        return keep, nlo, nhi, d

    state = (pts, lo0, hi0, dflt)
    for lvl in range(STICKY_LEVELS):
        state = compose(4 << lvl, state)
    d = state[3]
    # Exact verification against the position's own table (mandatory in
    # sig mode, a no-op-strength invariant otherwise — kept in both so
    # the emitted offset is always a verified occurrence).
    verified = (jnp.any((d[..., None] == pts) & (d[..., None] > 0), axis=-1)
                | ((d > 0) & (d >= lo0) & (d <= hi0) & (lo0 > 0)))
    return jnp.where(verified, d, cands[..., 0])


def _sticky_offsets_sig(cands: jax.Array) -> jax.Array:
    """Signature-based sticky composition (cfg.sticky='sig').

    The exact composition (_sticky_offsets) pays K^2 membership compares
    per level; here each keep-set is summarized as a 32-bit bucket bitmask
    and membership is one AND — O(K) signature builds + O(K) tests per
    level. False positives (two offsets in one of 32 buckets) can let a
    dropped value ride a level, so the final choice is re-verified exactly
    against the position's own candidate table and falls back to the
    nearest candidate when unverified — every emitted offset therefore
    remains sort-verified (the codec's core invariant), and a collision
    costs at most a different valid tie-break."""
    n, k = cands.shape
    keeps = cands
    dflt = cands[..., 0]
    iota = jnp.arange(n, dtype=jnp.int32)

    def compose(shift, state):
        a_keep, a_dflt = (jnp.roll(state[0], shift, axis=0),
                          jnp.roll(state[1], shift, axis=0))
        b_keep, b_dflt = state
        mask = functools.reduce(
            jnp.bitwise_or,
            [jnp.where(b_keep[..., j] > 0, _sig_bit(b_keep[..., j]),
                       jnp.uint32(0)) for j in range(k)])

        def in_b(x):
            return ((mask & _sig_bit(x)) != 0) & (x > 0)

        keep = jnp.where(
            jnp.stack([in_b(a_keep[..., j]) for j in range(k)], axis=-1),
            a_keep, 0)
        d = jnp.where(in_b(a_dflt), a_dflt, b_dflt)
        edge = (iota < shift)
        keep = jnp.where(edge[..., None], b_keep, keep)
        d = jnp.where(edge, b_dflt, d)
        return keep, d

    state = (keeps, dflt)
    for lvl in range(STICKY_LEVELS):
        state = compose(4 << lvl, state)
    d = state[1]
    # Exact re-verification gate (restores the invariant signatures relax).
    verified = jnp.any((d[..., None] == cands) & (d[..., None] > 0), axis=-1)
    return jnp.where(verified, d, cands[..., 0])


def _sticky_offsets(cands: jax.Array) -> jax.Array:
    """Chain-stable offset choice per position.

    Greedy chains want consecutive stride-4 positions to agree on one offset;
    each position independently picking its nearest candidate breaks chains
    (a closer duplicate appears mid-match). This scan makes the offset
    "sticky": a position keeps the offset arriving from position i-4 whenever
    any of its own K (verified) candidates equals it, else defaults to its
    nearest candidate. The per-position transfer functions
    f(s) = s if s in candidates else nearest compose in closed form —
    (surviving keep-set <= K values, default) — so the whole chain resolves
    in one associative scan along each of the 4 stride-4 lanes.

    The closed form is approximate (a state surviving the left sub-range but
    dropped mid-range evaluates to the wrong branch's default), but safely
    so: every produced offset is still one of its own position's verified
    candidates, so matches remain exact; only the tie-break differs from the
    sequential definition by a hair.

    Truncation: a sticky chain only needs to persist ~17 stride-4 steps (the
    run-length computation caps at 16 links = 68 bytes), so a windowed
    Hillis-Steele composition over the last 64 transfers (6 roll levels)
    replaces a full-length scan at identical parse quality.

    cands: (N, K) int32, nearest-first, 0 = none. Returns (N,) offsets.
    """
    n, k = cands.shape
    keeps = cands  # (N, K)
    dflt = cands[..., 0]  # (N,)
    iota = jnp.arange(n, dtype=jnp.int32)

    def compose(shift, state):
        a_keep, a_dflt = jnp.roll(state[0], shift, axis=0), jnp.roll(state[1], shift, axis=0)
        b_keep, b_dflt = state

        def in_b(x):
            return jnp.any((x[..., None] == b_keep[..., None, :]) &
                           (x[..., None] > 0), axis=-1)

        keep = jnp.where(in_b(a_keep), a_keep, 0)
        d = jnp.where(in_b(a_dflt[..., None])[..., 0], a_dflt, b_dflt)
        # Window start: no left context rolls in from the array end.
        edge = (iota < shift)
        keep = jnp.where(edge[..., None], b_keep, keep)
        d = jnp.where(edge, b_dflt, d)
        return keep, d

    state = (keeps, dflt)
    for lvl in range(STICKY_LEVELS):  # composes the last 32 stride-4 transfers
        state = compose(4 << lvl, state)
    return state[1]


def _match_lengths(off: jax.Array, n: jax.Array, iota: jax.Array) -> jax.Array:
    """Exact match length (capped at 68) per position from sticky offsets.

    Stride-4 chains: link[j] means the match at j continues at j+4 with the
    same offset; capped run-length doubling over uniform rolls (no gathers)
    gives 4-byte-quantized lengths. The four stride-4 lanes are then fused
    (phase max): a match at i+p (p<4) with the same offset extends i's match
    to p + len(i+p), recovering sub-4-byte tails exactly.
    """
    m4 = off > 0
    link = m4 & jnp.roll(m4, -4, axis=-1) & (jnp.roll(off, -4, axis=-1) == off)
    r = link.astype(jnp.int32)
    step = 1
    for _ in range(4):
        r = jnp.where(r == step, step + jnp.roll(r, -4 * step, axis=-1), r)
        step *= 2
    mlq = jnp.where(m4, 4 + 4 * jnp.minimum(r, 16), 0)

    ml = mlq
    for p in (1, 2, 3):
        agree = (jnp.roll(off, -p, axis=-1) == off) & jnp.roll(m4, -p, axis=-1)
        ml = jnp.maximum(ml, jnp.where(agree, p + jnp.roll(mlq, -p, axis=-1), 0))
    ml = jnp.where(m4, ml, 0)
    return jnp.minimum(ml, n - iota)


def _propagate(ml: jax.Array, off: jax.Array, iota: jax.Array):
    """Suffix-match propagation: ml'[i] = max_{j<=i} (ml[j] - (i-j)).

    A match of length L at j implies a match of length L-k at j+k with the
    same offset, so max-plus-scan = cummax of (ml + iota). Guarantees the
    60/64 chaining rule always finds its continuation match (the role of the
    RTL's `continue` chained-copy flag, CopyCompress.scala:80,143).

    Truncation: ml caps at 68, so inheritance from more than 128 positions
    back is always negative — a windowed max (7 roll levels) suffices.
    """
    pv = ml + iota
    pvs, offp = pv, off
    for lvl in range(7):  # window 128 >= the 68-byte inheritance horizon
        shift = 1 << lvl
        av = jnp.roll(pvs, shift, axis=-1).at[..., :shift].set(-1)
        ao = jnp.roll(offp, shift, axis=-1)
        take_a = av > pvs
        pvs = jnp.where(take_a, av, pvs)
        offp = jnp.where(take_a, ao, offp)
    mlp = jnp.minimum(pvs - iota, 68)
    return mlp, offp


def _jump(mlp: jax.Array) -> jax.Array:
    """Greedy advance per position: literals move 1; matches move by emitted
    copy length, splitting long matches 64/60-then-rest so the final element
    stays >= 4 (fmt.copy_fragment_lengths rule)."""
    return jnp.where(
        mlp < 4, 1,
        jnp.where(mlp <= 64, mlp, jnp.where(mlp < 68, 60, 64)))


def _matcher_xla(cands: jax.Array, n: jax.Array, iota: jax.Array,
                 lazy: int = 0, sticky: str = "exact",
                 table: str = "points"):
    """Candidate table -> (jump, offset), including the lazy-deferral mask
    and the sticky-composition mode. table='intervals' switches the sticky scan to the interval-aware
    form (last two columns are a verified-offset interval)."""
    off_s = (_sticky_offsets_intervals(cands, sticky)
             if table == "intervals"
             else _sticky_offsets_sig(cands) if sticky == "sig"
             else _sticky_offsets(cands))
    ml = _match_lengths(off_s, n, iota)
    # Profitability filter: short matches with 3-byte copy2 tags that also
    # split a literal run are net-negative (software Snappy's skip heuristic
    # sidesteps them on incompressible data; we drop them explicitly).
    # Drop len-4 @ far offset always, len-5 @ far offset when no other match
    # starts in the 16 bytes before (isolated => a literal split is certain).
    m4cnt = jnp.cumsum((ml > 0).astype(jnp.int32), axis=-1)
    before16 = m4cnt - jnp.where(iota >= 17, jnp.roll(m4cnt, 17, axis=-1), 0)
    isolated = (before16 - (ml > 0)) == 0
    near = off_s < fmt.COPY1_MAX_OFFSET
    keep = ((ml >= 5) | near) & ((ml >= 6) | near | ~isolated)
    ml = jnp.where(keep, ml, 0)
    mlp, off = _propagate(ml, off_s, iota)
    if lazy:
        # Lazy one-position lookahead: defer the match at i to a literal
        # whenever the match at i+1 is >= `lazy` bytes longer. Inheritance
        # (_propagate) guarantees mlp[i+1] >= mlp[i] - 1, so any strict
        # increase is a genuinely NEW (better) match, not an artifact.
        # Deferral chains need no sequential re-parse: each deferred
        # position simply becomes jump=1 and the commit scan walks through
        # it. Matches already at the 64/68 split band never defer (mlp
        # caps at 68, so nothing can beat them by >= 1 there... except 68
        # vs 67 — excluded explicitly so the 60+rest split stays intact).
        nxt = jnp.roll(mlp, -1, axis=-1).at[..., -1].set(0)
        defer = (mlp >= 4) & (mlp < 64) & (nxt >= mlp + lazy)
        mlp = jnp.where(defer, 0, mlp)
    return _jump(mlp), off


def encode_block(block: jax.Array, n: jax.Array,
                 cfg: CodecConfig = DEFAULT_CONFIG):
    """Encode one 64 KB block.

    block: (65536,) uint8 (zero-padded past n); n: scalar int32.
    Returns (out, out_len): out is (block_capacity,) uint8 of raw Snappy
    elements (no stream preamble), valid up to out_len.
    """
    iota = jnp.arange(N, dtype=jnp.int32)
    cap = cfg.block_capacity

    # --- MATCH + EXTEND ---
    if cfg.stride > 1:
        # Strided anchors: build only the stride-spaced keys (byte-group
        # reinterpretation — no 64K window pass, no [::stride] relayout)
        # and hand the candidate stage pre-strided inputs.
        key = _window_keys_strided(block, n, cfg.stride)
        kiota = jnp.arange(0, N, cfg.stride, dtype=jnp.int32)
    else:
        key = _window_keys(block, n, iota)
        kiota = iota
    cands = _candidate_offsets(key, n, kiota, cfg.candidates,
                               cfg.flatten, cfg.probes,
                               stride=cfg.stride, table=cfg.table)
    jump, off = _matcher_xla(cands, n, iota, cfg.lazy, cfg.sticky,
                             cfg.table)

    # --- COMMIT ---
    committed = scan.commit_bounded(jump) & (iota < n)
    is_copy = committed & (jump >= 4)
    is_lit = committed & ~is_copy

    # --- EMIT ---
    prev_lit = jnp.roll(is_lit, 1, axis=-1).at[..., 0].set(False)
    lit_start = is_lit & ~prev_lit
    elem = is_copy | lit_start

    run_end = jnp.minimum(scan.next_element_start(elem, N), n)
    lit_len = jnp.maximum(run_end - iota, 1)  # valid at lit_start only

    cpy_len = jump
    copy_small = (cpy_len <= fmt.COPY1_MAX_LEN) & (off < fmt.COPY1_MAX_OFFSET)
    copy_sz = jnp.where(copy_small, 2, 3)
    lit_hdr = jnp.where(lit_len <= 60, 1, jnp.where(lit_len <= 256, 2, 3))
    esz = jnp.where(is_copy, copy_sz, lit_hdr + lit_len)
    esz = jnp.where(elem, esz, 0)
    out_off = scan.exclusive_cumsum(esz)
    total = jnp.sum(esz)

    # Header byte values (all three lanes computed everywhere, masked on use).
    n1 = lit_len - 1
    lt0 = jnp.where(lit_len <= 60, n1 << 2,
                    jnp.where(lit_len <= 256, 60 << 2, 61 << 2))
    ct0 = jnp.where(
        copy_small,
        1 | ((cpy_len - 4) << 2) | ((off >> 8) << 5),
        2 | ((cpy_len - 1) << 2))
    t0 = jnp.where(is_copy, ct0, lt0)
    t1 = jnp.where(is_copy, off, n1) & 0xFF
    t2 = (jnp.where(is_copy, off, n1) >> 8) & 0xFF
    hdr = jnp.where(is_copy, copy_sz, lit_hdr)

    # --- byte placement ---
    # Both lanes' destinations are exactly 0..total-1, each written once,
    # so packing (dest << 8 | byte) and sorting puts byte j at rank j. Two
    # lanes suffice: the 2nd/3rd header byte of an element rides the lane
    # of position i+1/i+2, which never starts an element nor carries a
    # literal payload byte (elements with multi-byte headers cover those
    # positions themselves).
    def rollz(x, s):  # roll toward higher indices, zero-fill (dtype-safe)
        return jnp.roll(x, s, axis=-1).at[..., :s].set(x.dtype.type(0))

    e1 = rollz(elem, 1)
    e2 = rollz(elem, 2)
    a_t1 = e1 & (rollz(hdr, 1) >= 2)
    a_t2 = e2 & (rollz(hdr, 2) >= 3)
    lane_a_val = jnp.where(elem, t0,
                           jnp.where(a_t1, rollz(t1, 1), rollz(t2, 2)))
    lane_a_dst = jnp.where(elem, out_off,
                           jnp.where(a_t1, rollz(out_off, 1) + 1,
                                     rollz(out_off, 2) + 2))
    lane_a_on = elem | a_t1 | a_t2

    # Literal payload: dest = out_off[s] + hdr[s] + (i - s) for run start s.
    base = out_off + lit_hdr - iota
    basef = scan.ffill(lit_start, base)
    lane_b_dst = basef + iota

    sent = jnp.int32(SENT)
    dest = jnp.concatenate([
        jnp.where(lane_a_on, lane_a_dst, sent),
        jnp.where(is_lit, lane_b_dst, sent)], axis=-1)
    vals = jnp.concatenate([lane_a_val & 0xFF, block.astype(jnp.int32)],
                           axis=-1)
    pack = (dest.astype(jnp.uint32) << 8) | vals.astype(jnp.uint32)
    out = (jnp.sort(pack, axis=-1) & 0xFF).astype(jnp.uint8)[..., :cap]
    # Zero the tail (sentinel low bytes).
    out = jnp.where(jnp.arange(cap) < total, out, 0)
    return out, total


@functools.partial(jax.jit, static_argnames=("cfg",))
def encode_blocks(blocks: jax.Array, lengths: jax.Array,
                  cfg: CodecConfig = DEFAULT_CONFIG):
    """Batched block encode: blocks (B, 65536) uint8, lengths (B,) int32.
    Returns (out (B, capacity) uint8, out_lens (B,) int32)."""
    return jax.vmap(
        lambda b, n: encode_block(b, n, cfg))(blocks, lengths)


def compact_blocks(out: jax.Array, out_lens: jax.Array):
    """Device-side stream compaction: scatter each block's exact bytes to
    its manifest offset so the host fetches ONE dense buffer of exactly
    the compressed payload instead of (B, capacity) padded rows. This is
    the pure-functional form of the reference's store-bank drain (the
    RTL serializes through streamHolder into bank 1 and DMA-drains
    exactly the written rows, MemoryController.scala:219-264).

    out: (B, cap) uint8 rows, zero beyond out_lens (encode_block
    guarantees that); out_lens: (B,) int32. Returns (dense (B*cap,)
    uint8, total int32) with dense[:total] the concatenated stream and
    zeros beyond. Runs under jit; blocks concatenate in row order via an
    ascending scan of dynamic_update_slice, so each row's zero tail is
    overwritten by the next row's real bytes."""
    nb, cap = out.shape
    offs = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(out_lens)[:-1].astype(jnp.int32)])

    def body(dense, xs):
        row, off = xs
        return jax.lax.dynamic_update_slice(dense, row, (off,)), None

    dense0 = jnp.zeros(nb * cap, jnp.uint8)
    dense, _ = jax.lax.scan(body, dense0, (out, offs))
    return dense, jnp.sum(out_lens)


@functools.partial(jax.jit, static_argnames=("cfg", "wave"))
def encode_corpus_compact(blocks: jax.Array, lengths: jax.Array,
                          cfg: CodecConfig = DEFAULT_CONFIG, wave: int = 8):
    """encode_corpus fused with device-side compaction: returns
    (dense (NB*cap,) uint8, out_lens (NB,) int32, total int32). The host
    fetches out_lens (tiny) and dense[:total] — exactly the payload."""
    out, lens = encode_corpus(blocks, lengths, cfg, wave)
    dense, total = compact_blocks(out, lens)
    return dense, lens, total


@functools.partial(jax.jit, static_argnames=("cfg", "wave"))
def encode_corpus(blocks: jax.Array, lengths: jax.Array,
                  cfg: CodecConfig = DEFAULT_CONFIG, wave: int = 8):
    """Whole-corpus encode as ONE dispatched program: lax.map over waves of
    `wave` vmapped blocks. Identical outputs to encode_blocks; compile cost
    of a single wave (the loop body traces once), and a multi-wave corpus
    pays the per-dispatch fixed cost once instead of per wave.
    blocks: (W*wave, 65536) uint8; lengths: (W*wave,) int32.
    """
    nb = blocks.shape[0]
    assert nb % wave == 0, "pad the block count to a wave multiple"
    bw = blocks.reshape(nb // wave, wave, blocks.shape[-1])
    lw = lengths.reshape(nb // wave, wave)
    out, lens = jax.lax.map(
        lambda bl: encode_blocks(bl[0], bl[1], cfg), (bw, lw))
    return out.reshape(nb, -1), lens.reshape(nb)
