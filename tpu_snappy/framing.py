"""Snappy framing format (the official streaming container).

Spec: google/snappy `framing_format.txt` — a chunked stream carrying a
masked CRC-32C (Castagnoli) per data chunk, with at most 65536 uncompressed
bytes per chunk. The reference accelerator stops at raw block streams
(`CompressionAccelerator.scala` emits bare elements; even the varint
preamble is absent — SURVEY.md §0.2); this layer completes the production
container story, and it maps 1:1 onto the device design: one 64 KB block =
one chunk, so the same data-parallel block pipelines encode/decode framed
streams with no re-batching.

Two independent implementations exist for cross-validation: this module
(device codec + NumPy CRC) and the native C++ one (`native/snappy_ref.cc`
sr_compress_framed/sr_uncompress_framed, slice-by-8 CRC) — tests assert
both directions between them.
"""

from __future__ import annotations

import collections

import numpy as np

from . import format as fmt
from .config import CodecConfig, DEFAULT_CONFIG

#: Chunk types (framing_format.txt §4).
CHUNK_STREAM_ID = 0xFF
CHUNK_COMPRESSED = 0x00
CHUNK_UNCOMPRESSED = 0x01
CHUNK_PADDING = 0xFE
#: Skippable (0x80-0xfd) chunks carrying our decode sidecars (sidecar.py);
#: foreign decoders MUST ignore them per spec §4.4. 0x80 = full root map
#: (skip parse+resolve entirely); 0x81 = per-tile depth hints (76 bytes,
#: ~0.3% of a text stream — cheap enough that "auto" emits it on every
#: compressed text chunk). Decode skips 0x81 hints and resolves those
#: chunks like any other.
CHUNK_SIDECAR = 0x80
CHUNK_DEPTH = 0x81

#: Decode-side counts, by event, since import (callers may clear() it):
#: "sidecar" — chunks decoded through a 0x80 root map;
#: "sidecar_rejected" — chunks whose sidecar decode failed the chunk CRC
#: and went to the normal device path;
#: "host_chunks" — compressed chunks decoded by the sequential host
#: decoder (device-flagged, or beyond the device fragment capacity).
decode_stats: collections.Counter = collections.Counter()

STREAM_ID = b"\xff\x06\x00\x00sNaPpY"

#: "auto" sidecar policy: emit only when the sidecar costs at most this
#: fraction of the chunk's UNCOMPRESSED size (it competes with the ratio
#: cushion vs software Snappy, a few percent on text). Trivially-RLE
#: and near-incompressible chunks pass (their root maps are a few pieces);
#: dense text never does — its root-map fragmentation is larger than the
#: compressed payload itself.
SIDECAR_AUTO_FRAC = 0.03

#: Max uncompressed bytes per data chunk (spec-fixed; equals our block size).
MAX_CHUNK = 65536


# ---- CRC-32C (Castagnoli), NumPy slice-by-8, batched across chunks ----

def _make_tables() -> np.ndarray:
    t = np.zeros((8, 256), dtype=np.uint32)
    poly = np.uint32(0x82F63B78)
    for i in range(256):
        c = np.uint32(i)
        for _ in range(8):
            c = (c >> np.uint32(1)) ^ (poly if c & np.uint32(1) else np.uint32(0))
        t[0, i] = c
    for j in range(1, 8):
        t[j] = (t[j - 1] >> np.uint32(8)) ^ t[0, t[j - 1] & np.uint32(0xFF)]
    return t


_T = _make_tables()


def crc32c(data: bytes | np.ndarray) -> int:
    """CRC-32C of one buffer (unmasked).

    Single-buffer checksums route through the native slice-by-8 C path
    (~20 us / 64 KB): the numpy batch form below amortizes its python
    word loop across MANY rows, but degenerates to ~200 ms on a batch of
    one — measured; the decode path verifies one piece at a time."""
    try:
        from .native import golden
        return golden.crc32c(bytes(data))
    except (ImportError, OSError, RuntimeError):
        arr = np.frombuffer(bytes(data), dtype=np.uint8).reshape(1, -1)
        return int(crc32c_batch(arr)[0])


def crc32c_batch(rows: np.ndarray) -> np.ndarray:
    """CRC-32C of every row of a (C, L) uint8 matrix — the whole corpus'
    chunk checksums in one vectorized pass (slice-by-8 over u32 words)."""
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    c = np.full(rows.shape[0], 0xFFFFFFFF, dtype=np.uint32)
    L = rows.shape[1]
    k8 = L // 8 * 8
    if k8:
        # Little-endian word combine (as in the native Load32 slice-by-8):
        # byte i of each u32 must land in bits 8i, so the view is pinned to
        # '<u4' rather than host order (the pinned check-value test guards
        # this). The native golden's Load32 assumes a little-endian host,
        # which covers every target platform here (x86/ARM hosts).
        w = (rows[:, :k8].reshape(-1).view(np.dtype("<u4"))
             .reshape(rows.shape[0], -1))
        t0, t1, t2, t3, t4, t5, t6, t7 = _T
        m = np.uint32(0xFF)
        for j in range(0, w.shape[1], 2):
            lo = w[:, j] ^ c
            hi = w[:, j + 1]
            c = (t7[lo & m] ^ t6[(lo >> np.uint32(8)) & m]
                 ^ t5[(lo >> np.uint32(16)) & m] ^ t4[lo >> np.uint32(24)]
                 ^ t3[hi & m] ^ t2[(hi >> np.uint32(8)) & m]
                 ^ t1[(hi >> np.uint32(16)) & m] ^ t0[hi >> np.uint32(24)])
    for j in range(k8, L):
        c = (c >> np.uint32(8)) ^ _T[0, (c ^ rows[:, j]) & np.uint32(0xFF)]
    return c ^ np.uint32(0xFFFFFFFF)


def mask(crc: int) -> int:
    """The spec's CRC masking (rotate-right 15 + constant), so data that
    contains embedded CRCs doesn't feed back into its own checksum."""
    crc &= 0xFFFFFFFF
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def unmask(m: int) -> int:
    c = (m - 0xA282EAD8) & 0xFFFFFFFF
    return ((c >> 17) | (c << 15)) & 0xFFFFFFFF


# ---- Framed encode / decode on the device block pipelines ----

def _sidecar_chunk(elems: bytes, blen: int, policy: str) -> bytes:
    """Sidecar chunk bytes for one compressed chunk (b'' when the policy
    declines or the stream is unrepresentable). policy: 'off'|'auto'|
    'always' — 'always' emits the full 0x80 root map wherever
    representable; 'auto' emits the best hint under SIDECAR_AUTO_FRAC of
    the chunk's uncompressed size: the root map where it fits (RLE/
    near-incompressible chunks) and otherwise the 76-byte 0x81 per-tile
    depth hint (dense text — where the root map costs more than the
    payload). Both fall through to the depth hint when
    the root map is unrepresentable."""
    if policy == "off":
        return b""
    from . import sidecar as sc
    payload = sc.build(elems, blen)
    if payload is not None and (
            policy == "always"
            or len(payload) + 4 <= SIDECAR_AUTO_FRAC * blen):
        return (bytes([CHUNK_SIDECAR]) + len(payload).to_bytes(3, "little")
                + payload)
    dp = sc.build_depth(elems, blen)
    if dp is not None and len(dp) + 4 <= SIDECAR_AUTO_FRAC * blen:
        return (bytes([CHUNK_DEPTH]) + len(dp).to_bytes(3, "little") + dp)
    return b""


def compress(data: bytes, cfg: CodecConfig = DEFAULT_CONFIG,
             mesh=None, sidecar: str = "off") -> bytes:
    """Compress to a framed stream: one data chunk per 64 KB block, all
    blocks encoded by the batched device pipeline in one pass; a chunk is
    emitted uncompressed when compression would not shrink it (the spec's
    recommendation — incompressible data costs 8 bytes per 64 KB, not the
    raw-stream worst case). `mesh` shards the block encode data-parallel
    (chunks are independent, so the framed container composes with DP
    exactly like the raw stream does). `sidecar` ('off'|'auto'|'always')
    prepends a spec-skippable fast-decode chunk to each compressed data
    chunk (see sidecar.py); foreign decoders ignore it, ours then skips
    parse and resolve for chunks carrying a root map."""
    parts = [STREAM_ID]
    if not data:
        return STREAM_ID

    from . import api
    blocks, lengths = api._to_blocks(data, MAX_CHUNK)
    nb = len(lengths)
    elems_list = _encode_blocks_any(blocks, lengths, cfg, mesh)
    crcs = crc32c_batch(blocks)  # zero-padding is masked off below

    pos = 0
    for i in range(nb):
        blen = int(lengths[i])
        # Padded block rows share a width; a short final block needs its
        # own CRC over just blen bytes.
        crc = int(crcs[i]) if blen == MAX_CHUNK else crc32c(
            blocks[i, :blen].tobytes())
        elems = elems_list[i]
        payload = fmt.varint_encode(blen) + elems
        if len(payload) < blen:
            parts.append(_sidecar_chunk(elems, blen, sidecar))
            body = mask(crc).to_bytes(4, "little") + payload
            parts.append(bytes([CHUNK_COMPRESSED]) +
                         len(body).to_bytes(3, "little") + body)
        else:
            body = mask(crc).to_bytes(4, "little") + data[pos:pos + blen]
            parts.append(bytes([CHUNK_UNCOMPRESSED]) +
                         len(body).to_bytes(3, "little") + body)
        pos += blen
    return b"".join(parts)


def _encode_blocks_any(blocks, lengths, cfg: CodecConfig, mesh):
    """Batched block encode via the single-device wave pipeline or, when a
    mesh is given, the sharded DP path (bounded-compile either way) —
    both through device-side compaction (ops/encode.py compact_blocks),
    so the host fetches dense payload instead of padded capacity rows.
    Returns a list of per-block element-bytes for the rows of `blocks`."""
    from . import api
    from .ops import encode as ops_encode

    def split(buf: bytes, lens) -> list[bytes]:
        offs = np.concatenate([[0], np.cumsum(lens)])
        return [buf[offs[i]: offs[i + 1]] for i in range(len(lens))]

    nb = len(lengths)
    if mesh is not None:
        from .parallel import mesh as meshlib, shard
        ndev = mesh.devices.size
        per_dev = -(-nb // ndev)
        wave = min(shard.DP_WAVE, per_dev)
        padded = (-(-per_dev // wave) * wave) * ndev
        bp = np.pad(blocks, ((0, padded - nb), (0, 0)))
        lp = np.pad(lengths, (0, padded - nb))
        import jax
        dense, out_lens = shard._encode_fn_compact(mesh, cfg, wave)(
            jax.device_put(bp, meshlib.block_sharding(mesh, cfg.dp_axis)),
            jax.device_put(lp, meshlib.scalar_sharding(mesh, cfg.dp_axis)))
        lens_np = shard.fetch_global(out_lens)
        buf = b"".join(shard.assemble_compact(
            dense, lens_np, nb, mesh, cfg.block_capacity))
        return split(buf, lens_np[:nb])
    if nb > api.API_WAVE:
        pad = -nb % api.API_WAVE
        bp = np.pad(blocks, ((0, pad), (0, 0))) if pad else blocks
        lp = np.pad(lengths, (0, pad)) if pad else lengths
        dense, out_lens, total = ops_encode.encode_corpus_compact(
            bp, lp, cfg, wave=api.API_WAVE)
        total = int(total)
        bucket = 1 << 20
        k = min(-(-total // bucket) * bucket, dense.shape[0])
        buf = np.asarray(dense[:k])[:total].tobytes()
        return split(buf, np.asarray(out_lens)[:nb])
    out, out_lens = ops_encode.encode_blocks(blocks, lengths, cfg)
    out, lens_np = np.asarray(out), np.asarray(out_lens)
    return [out[i, : lens_np[i]].tobytes() for i in range(nb)]


def compress_stream(src, dst, total_len: int, mesh=None,
                    blocks_per_wave: int = 64,
                    cfg: CodecConfig = DEFAULT_CONFIG,
                    sidecar: str = "off") -> int:
    """Stream `total_len` bytes from src into a framed stream on dst.

    Chunks are independent, so a framed stream concatenates across waves
    with no global state (unlike the raw stream's single preamble) — the
    output is byte-identical to compress() on the whole input. Device
    fetch + chunk assembly of wave k overlaps wave k+1's encode on a
    worker thread. Returns the number of bytes written."""
    import concurrent.futures as cf

    from . import api

    dst.write(STREAM_ID)
    written = len(STREAM_ID)
    remaining = total_len

    def assemble(raw, elems_list, lengths):
        nonlocal written
        crcs = crc32c_batch(
            np.frombuffer(raw.ljust(len(lengths) * MAX_CHUNK, b"\0"),
                          np.uint8).reshape(len(lengths), MAX_CHUNK))
        pos = 0
        parts = []
        for i in range(len(lengths)):
            blen = int(lengths[i])
            crc = int(crcs[i]) if blen == MAX_CHUNK else crc32c(
                raw[pos:pos + blen])
            elems = elems_list[i]
            payload = fmt.varint_encode(blen) + elems
            if len(payload) < blen:
                parts.append(_sidecar_chunk(elems, blen, sidecar))
                body = mask(crc).to_bytes(4, "little") + payload
                parts.append(bytes([CHUNK_COMPRESSED])
                             + len(body).to_bytes(3, "little") + body)
            else:
                body = mask(crc).to_bytes(4, "little") + raw[pos:pos + blen]
                parts.append(bytes([CHUNK_UNCOMPRESSED])
                             + len(body).to_bytes(3, "little") + body)
            pos += blen
        blob = b"".join(parts)
        dst.write(blob)
        written += len(blob)

    with cf.ThreadPoolExecutor(max_workers=1) as pool:
        fut = None
        while remaining > 0:
            take = min(blocks_per_wave * MAX_CHUNK, remaining)
            raw = src.read(take)
            if len(raw) != take:
                raise IOError("short read from source")
            remaining -= take
            blocks, lengths = api._to_blocks(raw, MAX_CHUNK)
            elems_list = _encode_blocks_any(blocks, lengths, cfg, mesh)
            if fut is not None:
                fut.result()
            fut = pool.submit(assemble, raw, elems_list, lengths)
        if fut is not None:
            fut.result()
    return written


def _parse_chunks(framed: bytes):
    """Split a framed stream into (type, payload-offset, payload-len) with
    structural validation."""
    if not framed.startswith(STREAM_ID):
        raise ValueError("missing stream identifier chunk")
    chunks = []
    ip, n = len(STREAM_ID), len(framed)
    while ip < n:
        if ip + 4 > n:
            raise ValueError("truncated chunk header")
        typ = framed[ip]
        ln = int.from_bytes(framed[ip + 1: ip + 4], "little")
        ip += 4
        if ip + ln > n:
            raise ValueError("truncated chunk payload")
        if typ == CHUNK_STREAM_ID:
            if framed[ip - 4: ip + ln] != STREAM_ID:
                raise ValueError("malformed repeated stream identifier")
        elif typ in (CHUNK_COMPRESSED, CHUNK_UNCOMPRESSED):
            if ln < 4:
                raise ValueError("data chunk shorter than its checksum")
            chunks.append((typ, ip, ln))
        elif typ == CHUNK_SIDECAR:
            # Our fast-decode sidecars (skippable for everyone else):
            # carried through so the decoder can pair them with the data
            # chunk that follows.
            chunks.append((typ, ip, ln))
        elif typ == CHUNK_PADDING or typ >= 0x80:
            pass  # skippable
        else:
            raise ValueError(f"reserved unskippable chunk type {typ:#x}")
        ip += ln
    return chunks


def _decode_sidecar_chunks(bodies, side_for, comp_idx, out_parts,
                           cfg: CodecConfig = DEFAULT_CONFIG, mesh=None):
    """Fast-path decode of compressed chunks that carry a usable sidecar.

    Fills out_parts for every chunk whose sidecar-decoded bytes pass the
    chunk CRC; returns the indices still needing the normal decoder
    (no/unusable sidecar, or CRC mismatch — a wrong sidecar is just a
    skippable hint, never an error by itself). With a mesh, the batch
    shards DP like every other chunk pass (shard._decode_sidecar_fn)."""
    from . import api
    from . import sidecar as sc

    jobs = []  # (chunk index, elems bytes, ulen, starts, vals)
    rest = []
    for i in comp_idx:
        body = bodies[i][1]
        job = None
        if i in side_for:
            try:
                ulen, vstart = fmt.varint_decode(body[4:])
            except ValueError:
                ulen, vstart = None, 0
            elems = body[4 + vstart:]
            if ulen is not None and 0 < ulen <= MAX_CHUNK \
                    and len(elems) < sc.OUT:
                parsed = sc.parse(side_for[i])
                if parsed is not None:
                    sv = sc.prep_parent(*parsed, ulen)
                    if sv is not None:
                        job = (i, elems, ulen, sv[0], sv[1])
        if job is None:
            rest.append(i)
        else:
            jobs.append(job)
    if not jobs:
        return rest

    B = len(jobs)
    units = [job[1:] for job in jobs]
    if mesh is not None:
        import jax

        from .parallel import mesh as meshlib, shard
        ndev = mesh.devices.size
        per_dev = -(-B // ndev)
        wave = min(shard.DP_WAVE, per_dev)
        padded = (-(-per_dev // wave) * wave) * ndev
        E, S, V, U = sc.pack_batch(units, pad_rows=padded - B)
        bs = meshlib.block_sharding(mesh, cfg.dp_axis)
        ss = meshlib.scalar_sharding(mesh, cfg.dp_axis)
        out = shard._decode_sidecar_fn(mesh, cfg.dp_axis, wave)(
            jax.device_put(E, bs), jax.device_put(S, bs),
            jax.device_put(V, bs), jax.device_put(U, ss))
        out = shard.fetch_global(out)[:B]
    elif B > api.API_WAVE:
        E, S, V, U = sc.pack_batch(units, pad_rows=-B % api.API_WAVE)
        out = np.asarray(sc.decode_corpus_sidecar(
            E, S, V, U, wave=api.API_WAVE))[:B]
    else:
        out = np.asarray(sc.decode_chunks_jit(*sc.pack_batch(units)))
    for j, (i, _elems, ulen, _s, _v) in enumerate(jobs):
        piece = out[j, :ulen].tobytes()
        want = unmask(int.from_bytes(bodies[i][1][:4], "little"))
        if crc32c(piece) == want:
            out_parts[i] = piece
            decode_stats["sidecar"] += 1
        else:
            rest.append(i)  # settle on the normal path (raises if corrupt)
            decode_stats["sidecar_rejected"] += 1
    rest.sort()
    return rest


def _decode_data_chunks(bodies: list[tuple[int, bytes]],
                        cfg: CodecConfig, mesh,
                        use_sidecar: bool = True) -> list[bytes]:
    """Decode + CRC-verify a window of data chunks, in order.

    bodies: (type, body) pairs where body = 4-byte masked CRC + payload
    (compressed: varint ulen + Snappy elements; uncompressed: raw bytes);
    sidecar (0x80) entries pair with the compressed chunk that follows.
    All compressed chunks of the window decode in one batched device pass:
    a chunk's uncompressed size is <= 64 KB by spec, so each is exactly
    one fragment of the fragment-parallel decoder — the framing layer IS
    the fragment table. Chunks with a usable sidecar take the fast path
    (sidecar.py: skip parse/transport/resolve, one gather); the chunk CRC
    still gates the result, so a wrong sidecar only costs a re-decode.
    Depth hints (0x81) are skipped: their chunks decode like unhinted
    ones. Raises ValueError with the (window-relative) chunk index on
    corruption."""
    from .ops import decode as ops_decode
    from . import api

    out_parts: list[bytes | None] = [None] * len(bodies)

    # Pair each sidecar with the compressed data chunk that follows it.
    side_for: dict[int, bytes] = {}
    pending_s = None
    for i, (t, b) in enumerate(bodies):
        if t == CHUNK_SIDECAR:
            pending_s = b
        elif t == CHUNK_COMPRESSED:
            if pending_s is not None:
                side_for[i] = pending_s
            pending_s = None
        elif t == CHUNK_UNCOMPRESSED:
            pending_s = None

    comp_idx = [i for i, (t, _) in enumerate(bodies)
                if t == CHUNK_COMPRESSED]
    if use_sidecar and side_for:
        comp_idx = _decode_sidecar_chunks(bodies, side_for, comp_idx,
                                          out_parts, cfg, mesh)

    if comp_idx:
        clens = np.zeros(len(comp_idx), np.int32)
        ulens = np.zeros(len(comp_idx), np.int32)
        payloads = []
        for j, i in enumerate(comp_idx):
            body = bodies[i][1]
            ulen, vstart = fmt.varint_decode(body[4:])
            if ulen > MAX_CHUNK:
                raise ValueError("chunk uncompressed size exceeds 65536")
            clens[j] = len(body) - 4 - vstart
            ulens[j] = ulen
            payloads.append(body[4 + vstart:])
        # Spec-valid chunks can exceed the device fragment capacity
        # (sr_max_compressed_length(65536) ~= 76.5 KB; adversarial all-
        # literal encoders reach ~131 KB). Those decode on the host path
        # below — same route as a failed ok flag — instead of raising.
        oversize = clens > ops_decode.FRAG_CAP
        clens_dev = np.where(oversize, 0, clens).astype(np.int32)
        w = ops_decode.frag_width(clens_dev)
        frags = np.zeros((len(comp_idx), w), np.uint8)
        for j, p in enumerate(payloads):
            if not oversize[j]:
                frags[j, : clens[j]] = np.frombuffer(p, np.uint8)
        clens = clens_dev
        nf = len(comp_idx)
        if mesh is not None:
            from .parallel import mesh as meshlib, shard
            import jax
            ndev = mesh.devices.size
            per_dev = -(-nf // ndev)
            wave = min(shard.DP_WAVE, per_dev)
            padded = (-(-per_dev // wave) * wave) * ndev
            fr = np.pad(frags, ((0, padded - nf), (0, 0)))
            cl = np.pad(clens, (0, padded - nf))
            ul = np.pad(ulens, (0, padded - nf))
            out, ok = shard._decode_fn(mesh, cfg.dp_axis, wave)(
                jax.device_put(fr, meshlib.block_sharding(mesh, cfg.dp_axis)),
                jax.device_put(cl, meshlib.scalar_sharding(mesh, cfg.dp_axis)),
                jax.device_put(ul, meshlib.scalar_sharding(mesh, cfg.dp_axis)))
            out, ok = shard.fetch_global(out)[:nf], shard.fetch_global(ok)[:nf]
        elif nf > api.API_WAVE:
            pad = -nf % api.API_WAVE
            fr = np.pad(frags, ((0, pad), (0, 0)))
            cl = np.pad(clens, (0, pad))
            ul = np.pad(ulens, (0, pad))
            out, ok = ops_decode.decode_corpus(fr, cl, ul, wave=api.API_WAVE)
            out, ok = np.asarray(out)[:nf], np.asarray(ok)[:nf]
        else:
            out, ok = ops_decode.decode_fragments(frags, clens, ulens, cfg)
            out, ok = np.asarray(out), np.asarray(ok)
        for j, i in enumerate(comp_idx):
            body = bodies[i][1]
            if ok[j] and not oversize[j]:
                piece = out[j, : ulens[j]].tobytes()
            else:
                # Exotic-but-valid or corrupt: the sequential host decoder
                # settles it (decodes the former, raises on the latter).
                from . import reference_codec
                decode_stats["host_chunks"] += 1
                piece = reference_codec.decompress(body[4:])
            want = unmask(int.from_bytes(body[:4], "little"))
            if crc32c(piece) != want:
                raise ValueError(f"chunk {i}: CRC-32C mismatch")
            out_parts[i] = piece

    for i, (typ, body) in enumerate(bodies):
        if typ == CHUNK_UNCOMPRESSED:
            piece = body[4:]
            if len(piece) > MAX_CHUNK:
                raise ValueError("uncompressed chunk exceeds 65536")
            want = unmask(int.from_bytes(body[:4], "little"))
            if crc32c(piece) != want:
                raise ValueError(f"chunk {i}: CRC-32C mismatch")
            out_parts[i] = piece
    return [p for p in out_parts if p is not None]


def decompress(framed: bytes, cfg: CodecConfig = DEFAULT_CONFIG,
               mesh=None, use_sidecar: bool = True) -> bytes:
    """Decompress + validate a framed stream (structure and every CRC);
    see _decode_data_chunks for the batched device pass. use_sidecar=False
    ignores fast-decode sidecar chunks (they are skippable by spec)."""
    chunks = _parse_chunks(framed)
    bodies = [(t, framed[off: off + ln]) for t, off, ln in chunks]
    return b"".join(_decode_data_chunks(bodies, cfg, mesh, use_sidecar))


def decompress_stream(src, dst, mesh=None, chunks_per_wave: int = 64,
                      cfg: CodecConfig = DEFAULT_CONFIG,
                      use_sidecar: bool = True) -> int:
    """Stream-decode a framed stream from src to dst in chunk waves.

    Chunks are independent, so windows of chunks_per_wave data chunks
    decode batch-wise without materializing the whole stream — the framed
    counterpart of parallel/streaming.py. Returns bytes written."""
    head = src.read(len(STREAM_ID))
    if head != STREAM_ID:
        raise ValueError("missing stream identifier chunk")
    written = 0
    window: list[tuple[int, bytes]] = []
    ndata = 0

    def flush():
        nonlocal written, ndata
        for piece in _decode_data_chunks(window, cfg, mesh, use_sidecar):
            dst.write(piece)
            written += len(piece)
        window.clear()
        ndata = 0

    while True:
        hdr = src.read(4)
        if not hdr:
            break
        if len(hdr) != 4:
            raise ValueError("truncated chunk header")
        typ = hdr[0]
        ln = int.from_bytes(hdr[1:4], "little")
        body = src.read(ln)
        if len(body) != ln:
            raise ValueError("truncated chunk payload")
        if typ == CHUNK_STREAM_ID:
            if hdr + body != STREAM_ID:
                raise ValueError("malformed repeated stream identifier")
        elif typ in (CHUNK_COMPRESSED, CHUNK_UNCOMPRESSED):
            if ln < 4:
                raise ValueError("data chunk shorter than its checksum")
            window.append((typ, body))
            ndata += 1
            # Flush only after a DATA chunk so a sidecar never dangles at
            # a window boundary away from the chunk it describes.
            if ndata >= chunks_per_wave:
                flush()
        elif typ == CHUNK_SIDECAR:
            window.append((typ, body))
        elif typ == CHUNK_PADDING or typ >= 0x80:
            pass  # skippable
        else:
            raise ValueError(f"reserved unskippable chunk type {typ:#x}")
    flush()
    return written
