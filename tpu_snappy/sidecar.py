"""Framed-stream decode sidecar: co-designed fast-decode metadata.

Much of the decoder's work is copy-chain RESOLUTION (pointer doubling),
yet the ENCODER holds every chain fully resolved when it emits. This module closes that loop at the format level, the way the
reference co-designed its output stream with its datapath
(CompressionAccelerator.scala:230-285): the framed encoder may emit one
spec-skippable chunk (type 0x80; framing_format.txt §4.4 — foreign
decoders MUST skip 0x80-0xfd) per compressed data chunk, carrying the
chunk's literal ROOT MAP, and our framed decoder then skips parse,
transport AND resolve entirely: expand the root map (one scatter + one
forward fill) and run ONE full-range byte gather from the element bytes.
Chunk CRCs (which cover the decoded bytes) still gate the result, so a
wrong, corrupt, or foreign sidecar can never corrupt output — the decoder
falls back to the normal path on any mismatch.

Root map representation: maximal affine pieces. For piece p covering
output positions start[p] <= i < start[p+1]:

    out[i] = elems[root[p] + slope[p] * (i - start[p])],  slope in {0, 1}

slope 1 covers literal runs and non-overlapping copies, slope 0 covers
offset-1 RLE (constant root). Size is measured, not assumed: the piece
count IS the fragmentation of the resolved chain structure, so
trivially-RLE data costs ~a dozen bytes while dense text costs more than
the compressed payload itself (several hundred percent of the payload
on text) — hence the "auto" emission policy in framing.compress.

Wire payload (little-endian):
    magic  b"tpS1"
    npieces u32
    starts  u16[P]   (strictly ascending, starts[0] == 0)
    roots   u16[P]
    slopes  bitset, ceil(P/8) bytes (np.packbits order)
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

MAGIC = b"tpS1"
#: Skippable framing chunk type carrying a sidecar (0x80-0xfd reserved for
#: skippable use by the spec; foreign decoders ignore it by requirement).
CHUNK_TYPE = 0x80

#: Per-tile depth hint: a 0x81 skippable chunk carrying, for each
#: DEPTH_TILE-byte output tile, the number of tile-local doubling rounds a
#: tile-sequential resolve needs after dense doubling rounds have run
#: until at most DEPTH_TAIL_CAP lanes still move (native sr_depth_hints).
#: 65536/DEPTH_TILE = 64 bytes + a 12-byte header, so the "auto" policy
#: emits it on every compressed text chunk (the full tpS1 root map costs
#: more than the payload there). The wire format names both constants; a
#: hint built for other values parses to None. This decoder skips the
#: hints and resolves every chunk the same way, so a hint never changes
#: the decoded bytes.
DEPTH_CHUNK_TYPE = 0x81
DEPTH_MAGIC = b"tpD1"
DEPTH_TAIL_CAP = 57344
DEPTH_TILE = 1024


def build_depth(elems: bytes, ulen: int) -> bytes | None:
    """Depth-hint payload for one compressed chunk, or None when the
    native library is unavailable or the stream is malformed."""
    if ulen <= 0 or ulen > OUT or len(elems) > 0xFFFF:
        return None
    try:
        from .native import golden
        d = golden.depth_hints(elems, ulen, DEPTH_TAIL_CAP, DEPTH_TILE)
    except (ImportError, OSError, RuntimeError):
        return None
    return (DEPTH_MAGIC + np.uint32(DEPTH_TAIL_CAP).tobytes()
            + np.uint16(DEPTH_TILE).tobytes()
            + bytes([len(d) & 0xFF, 1]) + d.tobytes())


def parse_depth(payload: bytes):
    """Unpack a depth-hint payload -> (nt,) int32 numpy array, or None if
    malformed/foreign or built for other wire constants (the chunk is
    skippable, so 'ignore')."""
    if len(payload) < 12 or payload[:4] != DEPTH_MAGIC:
        return None
    cap = int(np.frombuffer(payload[4:8], "<u4")[0])
    tile = int(np.frombuffer(payload[8:10], "<u2")[0])
    nt, flags = payload[10], payload[11]
    if (cap != DEPTH_TAIL_CAP or tile != DEPTH_TILE or flags != 1
            or nt != (OUT // tile) & 0xFF or len(payload) != 12 + nt):
        return None
    return np.frombuffer(payload[12:], np.uint8).astype(np.int32)


#: Piece cap: beyond this the sidecar is ignored (the normal decoder
#: runs). Also bounds the padded piece width PW.
MAX_PIECES = 40960

OUT = 1 << 16


# ---- encoder side ----

def build(elems: bytes, ulen: int) -> bytes | None:
    """Sidecar payload for one compressed chunk's element stream, or None
    when the stream is not representable (elems >= 64 KB, malformed, or
    more than MAX_PIECES pieces)."""
    try:
        starts, roots, slopes = _root_pieces(elems, ulen)
    except (ValueError, RuntimeError):
        return None
    if len(starts) == 0 or len(starts) > MAX_PIECES:
        return None
    return (MAGIC + np.uint32(len(starts)).tobytes()
            + starts.astype("<u2").tobytes() + roots.astype("<u2").tobytes()
            + np.packbits(slopes.astype(bool)).tobytes())


def _root_pieces(elems: bytes, ulen: int):
    try:
        from .native import golden
        return golden.root_map(elems, ulen)
    except (ImportError, OSError):
        return _root_pieces_py(elems, ulen)


def _root_pieces_py(elems: bytes, ulen: int):
    """Pure-python fallback: element walk building the root array (chunked
    numpy copies honor RLE), then greedy maximal affine pieces — mirrors
    native sr_root_map exactly."""
    if len(elems) > 0xFFFF or ulen > OUT:
        raise ValueError("sidecar capacity")
    buf = np.frombuffer(elems, np.uint8)
    root = np.zeros(ulen, np.int64)
    ip, op, n = 0, 0, len(buf)
    while ip < n:
        tag = int(buf[ip])
        kind = tag & 3
        if kind == 0:
            code = tag >> 2
            if code < 60:
                length, hdr = code + 1, 1
            else:
                extra = code - 59
                if ip + 1 + extra > n:
                    raise ValueError("truncated")
                length = int.from_bytes(
                    buf[ip + 1: ip + 1 + extra].tobytes(), "little") + 1
                hdr = 1 + extra
            if ip + hdr + length > n or op + length > ulen:
                raise ValueError("truncated/overlong literal")
            root[op: op + length] = np.arange(ip + hdr, ip + hdr + length)
            ip += hdr + length
        else:
            if kind == 1:
                if ip + 2 > n:
                    raise ValueError("truncated")
                length = ((tag >> 2) & 7) + 4
                offset = ((tag >> 5) << 8) | int(buf[ip + 1])
                ip += 2
            elif kind == 2:
                if ip + 3 > n:
                    raise ValueError("truncated")
                length = (tag >> 2) + 1
                offset = int.from_bytes(buf[ip + 1: ip + 3].tobytes(),
                                        "little")
                ip += 3
            else:
                if ip + 5 > n:
                    raise ValueError("truncated")
                length = (tag >> 2) + 1
                offset = int.from_bytes(buf[ip + 1: ip + 5].tobytes(),
                                        "little")
                ip += 5
            if offset < 1 or offset > op or op + length > ulen:
                raise ValueError("bad copy")
            k = 0
            while k < length:  # chunked copy: RLE-safe
                m = min(offset, length - k)
                root[op + k: op + k + m] = root[op + k - offset:
                                                op + k - offset + m]
                k += m
        op += length
    if op != ulen:
        raise ValueError("length mismatch")
    starts, roots, slopes = [], [], []
    i = 0
    while i < ulen:
        starts.append(i)
        roots.append(int(root[i]))
        slope = 1
        j = i + 1
        if j < ulen:
            d = int(root[j]) - int(root[i])
            if d in (0, 1):
                slope = d
                while j < ulen and root[j] == root[j - 1] + slope:
                    j += 1
        slopes.append(slope)
        i = j
    return (np.asarray(starts, np.uint16), np.asarray(roots, np.uint16),
            np.asarray(slopes, np.uint8))


# ---- decoder side (host half) ----

def parse(payload: bytes):
    """Unpack a sidecar chunk payload -> (starts, roots, slopes) int32
    numpy arrays, or None if malformed/foreign (the chunk type is
    skippable by spec, so malformed just means 'ignore')."""
    if len(payload) < 8 or payload[:4] != MAGIC:
        return None
    p = int(np.frombuffer(payload[4:8], "<u4")[0])
    need = 8 + 4 * p + (p + 7) // 8
    if p == 0 or p > OUT or len(payload) != need:
        return None
    starts = np.frombuffer(payload[8: 8 + 2 * p], "<u2").astype(np.int32)
    roots = np.frombuffer(payload[8 + 2 * p: 8 + 4 * p],
                          "<u2").astype(np.int32)
    slopes = np.unpackbits(
        np.frombuffer(payload[8 + 4 * p:], np.uint8))[:p].astype(np.int32)
    if starts[0] != 0 or (np.diff(starts) <= 0).any():
        return None
    return starts, roots, slopes


def parent_vals(starts: np.ndarray, roots: np.ndarray,
                slopes: np.ndarray) -> np.ndarray:
    """Scatter value per maximal piece: slope in bit 17,
    (root - slope*start + 2^16) below — position-independent within the
    piece, which is what makes scatter + forward-fill exact."""
    return ((slopes.astype(np.int32) << 17)
            | (roots.astype(np.int32) - slopes * starts + OUT))


def prep_parent(starts, roots, slopes, ulen: int):
    """Host prep for the device decode: validate the parsed sidecar
    against ulen and return (starts, scatter values), or None when
    inconsistent or beyond MAX_PIECES."""
    if len(starts) > MAX_PIECES or int(starts[-1]) >= ulen:
        return None
    return starts, parent_vals(starts, roots, slopes)


def pieces_width(total: int) -> int:
    """Static padded piece width: 4096-multiple buckets (few jit graphs)."""
    b = 4096
    return int(min(max(b, -(-total // b) * b), MAX_PIECES))


def elems_width(max_elems: int) -> int:
    """Static padded element-bytes width (the gather table): 8192-byte
    buckets, so few jit variants; compressed chunks are < 64 KB by the
    framing emit rule."""
    b = 8192
    return int(min(max(b, -(-max_elems // b) * b), OUT))


def pack_batch(jobs, pad_rows: int = 0):
    """Batch device arrays from per-chunk jobs (elems bytes, ulen, starts,
    vals) at the shared bucketed widths — the one packing used by
    framing, serving, and the benches. Returns (E, S, V, U) with
    len(jobs) + pad_rows rows; padding rows carry starts == OUT (dropped
    by the scatter) and ulen 0."""
    B = len(jobs)
    pw = pieces_width(max(len(j[2]) for j in jobs))
    ew = elems_width(max(len(j[0]) for j in jobs))
    E = np.zeros((B + pad_rows, ew), np.uint8)
    S = np.full((B + pad_rows, pw), OUT, np.int32)
    V = np.zeros((B + pad_rows, pw), np.int32)
    U = np.zeros(B + pad_rows, np.int32)
    for j, (elems, ulen, starts, vals) in enumerate(jobs):
        E[j, : len(elems)] = np.frombuffer(elems, np.uint8)
        S[j, : len(starts)] = starts
        V[j, : len(vals)] = vals
        U[j] = ulen
    return E, S, V, U


# ---- decoder side (device half) ----

def _decode_one(elems, starts, vals, ulen):
    """out[i] = elems[g[i]] with g expanded from scattered piece values:
    scatter (slope<<17 | root-slope*start+2^16) at piece starts (padding
    lanes carry starts == 65536 = dropped), forward-fill, then one byte
    gather. No parse, no transport, no resolve."""
    from .ops import scan

    ew = elems.shape[-1]
    oiota = jnp.arange(OUT, dtype=jnp.int32)
    scattered = jnp.zeros(OUT + 1, jnp.int32).at[
        jnp.clip(starts, 0, OUT)].add(vals)[:OUT]
    filled = scan.ffill(scattered != 0, scattered)
    slope = filled >> 17
    g = jnp.clip(slope * oiota + (filled & 0x1FFFF) - OUT, 0, ew - 1)
    out = elems[g]
    return jnp.where(oiota < ulen, out, 0).astype(jnp.uint8)


@jax.jit
def decode_chunks_jit(elems, starts, vals, ulens):
    """Batched sidecar decode: elems (B, EW) u8 (element bytes zero-padded
    to an elems_width bucket), starts/vals (B, PW) i32 (PW-padded with
    starts == 65536 = dropped), ulens (B,) i32. Returns out (B, 65536) u8;
    callers check each chunk's CRC."""
    return jax.vmap(_decode_one)(elems, starts, vals, ulens)


@functools.partial(jax.jit, static_argnames=("wave",))
def decode_corpus_sidecar(elems, starts, vals, ulens, wave: int = 8):
    """Single-dispatch wave-mapped form (the decode_corpus sibling): one
    compiled program decodes any number of sidecar chunks."""
    nf = elems.shape[0]
    assert nf % wave == 0, "pad the chunk count to a wave multiple"
    fw = elems.reshape(nf // wave, wave, elems.shape[-1])
    sw = starts.reshape(nf // wave, wave, starts.shape[-1])
    vw = vals.reshape(nf // wave, wave, vals.shape[-1])
    uw = ulens.reshape(nf // wave, wave)
    out = jax.lax.map(lambda t: jax.vmap(_decode_one)(*t), (fw, sw, vw, uw))
    return out.reshape(nf, -1)
