"""Parallel scan machinery shared by the encode and decode pipelines.

The core problem both pipelines share is *greedy pointer chasing*: the encoder
commits parse decisions at data-dependent positions (the role the reference's
per-cycle pointer-advance logic plays, CompressionAccelerator.scala:311-330),
and the decoder walks the tag chain (the loop the reference never built —
funct=1 is a stub, CompressionAccelerator.scala:385-388). Both are
"orbit of 0 under next[i] = i + jump[i]" problems. We parallelize them with a
two-level scheme with no data-dependent trip counts, only segment-local
gathers and scans:

  1. within 64-position segments, pointer-doubling computes an *exit map*
     (entry state -> exit state) for every possible entry state;
  2. maps compose associatively across segments (encode: log-depth
     associative scan because Snappy bounds every jump at 64 bytes; decode:
     a sequential-over-segments lax.scan because literal elements can jump
     up to 64 KB, which breaks the bounded-domain composition);
  3. a 64-step unrolled recurrence recovers per-position committed flags.

State convention: entering a segment with state d means the next committed
(parse) position is d slots past the segment start; d may be >= S when the
chase skips whole segments (decode only).
"""

from __future__ import annotations


import jax
import jax.numpy as jnp

S = 64  # segment width == MAX_COPY_LEN; the encode invariant jump <= S


def gather_s(maps: jax.Array, idx: jax.Array) -> jax.Array:
    """Within-segment gather y[..., g, t] = maps[..., g, idx[..., g, t]].

    A native integer gather: exact for every value, including the decode
    parse's exit states, which reach ~64K."""
    return jnp.take_along_axis(maps, idx, axis=-1)


def ffill(mask: jax.Array, vals: jax.Array) -> jax.Array:
    """Forward-fill `vals` from the latest position where mask is true.

    Positions before the first true mask keep vals' original entry.
    Works along the last axis; batch dims broadcast.
    """
    return ffill_many(mask, (vals,))[0]


def ffill_many(mask: jax.Array, vals: tuple) -> tuple:
    """Forward-fill several arrays from the same mask in one scan pass
    (one traversal instead of len(vals) — scans are HBM-bound)."""
    def comb(a, b):
        ma = a[0]
        mb = b[0]
        out = tuple(jnp.where(mb, xb, xa) for xa, xb in zip(a[1:], b[1:]))
        return (ma | mb,) + out

    res = jax.lax.associative_scan(comb, (mask,) + tuple(vals), axis=-1)
    return res[1:]


def exclusive_cumsum(x: jax.Array) -> jax.Array:
    return jnp.cumsum(x, axis=-1) - x


def next_element_start(flags: jax.Array, default: int) -> jax.Array:
    """For each i, the smallest j > i with flags[j], else `default` (last axis)."""
    n = flags.shape[-1]
    iota = jnp.arange(n, dtype=jnp.int32)
    eidx = jnp.where(flags, iota, jnp.int32(default))
    rc = jax.lax.cummin(eidx, axis=eidx.ndim - 1, reverse=True)
    out = jnp.roll(rc, -1, axis=-1)
    return out.at[..., -1].set(jnp.int32(default))


def segment_exit_maps(jump: jax.Array) -> jax.Array:
    """Within-segment chase tables.

    jump: (..., N) int32, every entry >= 1. Returns (..., N//S, S) exit maps:
    entry state d in [0, S) -> exit state (distance past segment end, >= 0;
    values >= S occur when a single jump overshoots the next segment).
    """
    n = jump.shape[-1]
    seg = jump.reshape(*jump.shape[:-1], n // S, S)
    local = jnp.arange(S, dtype=jnp.int32)
    t = local + seg
    # Chase within the segment: each round at least doubles covered hops;
    # min jump 1 => at most S hops => 6 rounds suffice.
    for _ in range(6):
        idx = jnp.clip(t, 0, S - 1)
        t = jnp.where(t >= S, t, gather_s(t, idx))
    return t - S


def _compose(f: jax.Array, g: jax.Array) -> jax.Array:
    """Compose exit maps: f covers earlier segments. Requires all f-values < S
    (the encode invariant), so the state never skips g's leading segment."""
    return gather_s(g, jnp.clip(f, 0, S - 1))


def entry_states_bounded(exit_maps: jax.Array) -> jax.Array:
    """Entry state per segment via log-depth composition (jump <= S only).

    exit_maps: (..., NSEG, S) with values in [0, S). Returns (..., NSEG).
    """
    prefix = jax.lax.associative_scan(_compose, exit_maps, axis=-2)
    e = prefix[..., 0]  # (..., NSEG): state after segments 0..s from entry 0
    entry = jnp.roll(e, 1, axis=-1)
    return entry.at[..., 0].set(0)


def entry_states_sequential(exit_maps: jax.Array) -> jax.Array:
    """Entry state per segment via a sequential lax.scan over segments.

    Handles unbounded jumps (decode: literal runs up to 64 KB). exit_maps may
    contain values >= S, meaning the chase skips following segments.
    Scan axis is -2; batch dims supported.
    """
    maps = jnp.moveaxis(exit_maps, -2, 0)  # (NSEG, ..., S)

    def step(d, m):
        # d: (...,) entry state of this segment; m: (..., S) its exit map.
        idx = jnp.clip(d, 0, S - 1)[..., None]
        thru = jnp.take_along_axis(m, idx, axis=-1)[..., 0]
        nxt = jnp.where(d >= S, d - S, thru)
        return nxt, d

    # unroll=4: each scan step is a tiny S-wide take_along_axis, so loop
    # bookkeeping would otherwise be a large share of the step.
    _, entries = jax.lax.scan(step, jnp.zeros(exit_maps.shape[:-2], jnp.int32),
                              maps, unroll=4)
    return jnp.moveaxis(entries, 0, -1)  # (..., NSEG)


def committed_from_entries(jump: jax.Array, entry: jax.Array) -> jax.Array:
    """Per-position committed flags from per-segment entry states.

    Runs the greedy recurrence d' = (d==0 ? jump : d) - 1 for the S positions
    of every segment in parallel (an S-step lax.scan over local position).
    """
    n = jump.shape[-1]
    seg = jump.reshape(*jump.shape[:-1], n // S, S)
    cols = jnp.moveaxis(seg, -1, 0)  # (S, ..., NSEG)

    def step(d, j):
        com = d == 0
        return jnp.where(com, j, d) - 1, com

    # unroll: same rationale as the entry scan above — each step is tiny.
    _, flags = jax.lax.scan(step, entry, cols, unroll=4)
    return jnp.moveaxis(flags, 0, -1).reshape(jump.shape)


def commit_bounded(jump: jax.Array) -> jax.Array:
    """Committed flags for bounded jumps (1 <= jump <= S). Encode path:
    the log-depth associative composition of the segment exit maps."""
    maps = segment_exit_maps(jump)
    return committed_from_entries(jump, entry_states_bounded(maps))


def commit_general(jump: jax.Array) -> jax.Array:
    """Committed flags for arbitrary jumps >= 1. Decode tag-parse path:
    a sequential scan over segments (literal runs may skip many)."""
    maps = segment_exit_maps(jump)
    return committed_from_entries(jump, entry_states_sequential(maps))
