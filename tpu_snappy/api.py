"""Host-facing codec API: bytes in, bytes out.

This is the role of the reference's C driver API (`compress(src, dst)` /
`uncompress`, tests/compression.c:20-39) — set up the job, invoke the
accelerator, collect the variable-length result — except the "accelerator"
is a jitted JAX pipeline and multi-block jobs are batched device-wide.
"""

from __future__ import annotations

import collections

import numpy as np

from . import format as fmt
from .config import CodecConfig, DEFAULT_CONFIG
from .ops import encode as ops_encode
from .ops import decode as ops_decode


def _to_blocks(data: bytes, block_size: int):
    """Split + zero-pad input into (B, 65536) blocks with a length vector."""
    n = len(data)
    nblocks = max(1, -(-n // block_size))
    arr = np.zeros((nblocks, fmt.BLOCK_SIZE), dtype=np.uint8)
    flat = np.frombuffer(data, dtype=np.uint8)
    for i in range(nblocks):
        chunk = flat[i * block_size:(i + 1) * block_size]
        arr[i, :len(chunk)] = chunk
    lengths = np.minimum(
        np.maximum(n - np.arange(nblocks) * block_size, 0), block_size
    ).astype(np.int32)
    return arr, lengths


#: Blocks/fragments per vmapped wave for multi-block API calls. Jitting a
#: vmap over ALL blocks compiles a graph proportional to the input size;
#: lax.map over fixed 8-wide waves bounds compile cost at one wave for any
#: input size.
API_WAVE = 8

#: Inputs below one block take the host codec: a device dispatch has a
#: fixed cost regardless of size, while the native C++ codec compresses
#: 50 KB in tens of microseconds. Host output is golden-verified by
#: construction (it IS a golden codec); device semantics (ratio bars,
#: round-trip) are unchanged above the threshold. Only applies at default
#: config — custom knobs force the device path so A/B experiments measure
#: what they ask for.
SMALL_INPUT_BYTES = fmt.BLOCK_SIZE

#: Host decode work done on behalf of device-path calls, since import
#: (callers may clear() it): "fragments" — fragments the device flagged
#: and the host re-decoded (_splice_parts); "streams" — whole streams the
#: fragment table refused (FragmentFallback) and the host decoded. The
#: small-input host path above is by design and not counted.
host_decodes: collections.Counter = collections.Counter()


def _host_compress(data: bytes) -> bytes:
    try:
        from .native import golden
        return golden.compress(data)
    except (ImportError, OSError, RuntimeError):
        from . import reference_codec
        return reference_codec.compress(data)


def _host_decompress(comp: bytes) -> bytes:
    try:
        from .native import golden
        return golden.uncompress(comp)
    except (ImportError, OSError, RuntimeError, ValueError):
        # Native rejects what it can't parse without detail; the Python
        # decoder re-raises with a precise message (or succeeds on streams
        # the native capacity checks refuse).
        from . import reference_codec
        return reference_codec.decompress(comp)


def compress(data: bytes, cfg: CodecConfig = DEFAULT_CONFIG, *,
             small_fastpath: bool = True, wave: int | None = None) -> bytes:
    """Compress to a standard Snappy stream (varint preamble + elements).

    small_fastpath=False forces the device pipeline even below the
    threshold (tests certify the device codec on small inputs that way).
    wave: blocks per vmapped device wave (default API_WAVE=8); each
    distinct wave width compiles its own graph. See docs/API.md."""
    if (small_fastpath and len(data) < SMALL_INPUT_BYTES
            and cfg == DEFAULT_CONFIG):
        return _host_compress(data)
    w = wave or API_WAVE
    blocks, lengths = _to_blocks(data, cfg.block_size)
    nb = len(lengths)
    if nb > w:
        pad = -nb % w
        if pad:
            blocks = np.pad(blocks, ((0, pad), (0, 0)))
            lengths = np.pad(lengths, (0, pad))
        # Device-side compaction: ONE dense fetch of exactly the payload
        # (bucketed slice widths bound the fetch-program count) instead
        # of (B, capacity) padded rows + a per-block host join.
        dense, out_lens, total = ops_encode.encode_corpus_compact(
            blocks, lengths, cfg, wave=w)
        total = int(total)
        bucket = 1 << 20
        k = min(-(-total // bucket) * bucket, dense.shape[0])
        return (fmt.varint_encode(len(data))
                + np.asarray(dense[:k])[:total].tobytes())
    out, out_lens = ops_encode.encode_blocks(blocks, lengths, cfg)
    out = np.asarray(out)
    out_lens = np.asarray(out_lens)
    parts = [fmt.varint_encode(len(data))]
    for i in range(nb):
        parts.append(out[i, : out_lens[i]].tobytes())
    return b"".join(parts)


def decompress(comp: bytes, cfg: CodecConfig = DEFAULT_CONFIG, *,
               small_fastpath: bool = True, wave: int | None = None) -> bytes:
    """Decompress a standard Snappy stream (ours or any other encoder's).

    Fragment-parallel on device; valid-but-exotic streams that defeat
    fragment-local decoding fall back to the sequential host decoder.
    small_fastpath=False forces the device pipeline below the threshold.
    wave: fragments per device wave — same compile-cost trade as
    api.compress."""
    total, start = fmt.varint_decode(comp)
    if total == 0:
        if len(comp) != start:
            raise ValueError("trailing bytes after empty stream")
        return b""
    if (small_fastpath and total < SMALL_INPUT_BYTES
            and cfg == DEFAULT_CONFIG):
        return _host_decompress(comp)
    try:
        frags, fstarts, fulens = ops_decode.fragment_table(comp, start, total)
    except ops_decode.FragmentFallback:
        from . import reference_codec
        host_decodes["streams"] += 1
        return reference_codec.decompress(comp)
    nf = len(fulens)
    wv = wave or API_WAVE
    if nf > wv:
        # Bounded-compile wave batching (see compress/API_WAVE).
        w = ops_decode.frag_width(np.asarray(fstarts))
        pad = -nf % wv
        fr = np.pad(np.asarray(frags)[:, :w], ((0, pad), (0, 0)))
        cl = np.pad(np.asarray(fstarts, np.int32), (0, pad))
        ul = np.pad(np.asarray(fulens, np.int32), (0, pad))
        out, ok = ops_decode.decode_corpus(fr, cl, ul, wave=wv)
        out, ok = out[:nf], ok[:nf]
    else:
        out, ok = ops_decode.decode_fragments(frags, fstarts, fulens, cfg)
    ok = np.asarray(ok)
    out = np.asarray(out)
    if not ok.all():
        result = _splice_failed_fragments(frags, fstarts, fulens, out, ok)
    else:
        result = b"".join(
            out[i, : fulens[i]].tobytes() for i in range(len(fulens)))
    if len(result) != total:
        raise ValueError("length mismatch vs preamble")
    return result


def _splice_failed_fragments(frags, clens, ulens, out: np.ndarray,
                             ok: np.ndarray) -> bytes:
    """Fragment-granular fallback: a fragment fails device validation when
    it is corrupt OR valid-but-exotic (e.g. a copy reaching across the
    64 KB fragment boundary, which no known encoder emits but the format
    permits). Only the FAILED fragments re-decode on the host — with the
    already-decoded prefix as copy context — instead of the whole stream;
    ok fragments' device bytes are exact regardless of their neighbors
    (fragments decode independently). Corrupt fragments raise with ids."""
    parts = [out[i, : ulens[i]].tobytes() if ok[i] else None
             for i in range(len(ulens))]
    return _splice_parts(frags, clens, ulens, parts, ok)


def _splice_parts(frags, clens, ulens, parts, ok) -> bytes:
    """Core of the fragment splice, over per-fragment device bytes.

    parts[i] is fragment i's device-decoded output (consulted only when
    ok[i]); failed fragments re-decode sequentially with the spliced
    prefix as copy context. Shared by api.decompress and the serving
    batcher (serving._settle_spliced) so both paths pay O(failed), not
    O(request), host work."""
    from . import reference_codec
    ctx = bytearray()
    for i in range(len(ulens)):
        if ok[i]:
            ctx += parts[i]
            continue
        host_decodes["fragments"] += 1
        before = len(ctx)
        try:
            reference_codec.decompress_elements(
                frags[i].tobytes(), 0, int(clens[i]), ctx)
        except (ValueError, IndexError) as host_err:
            raise ValueError(
                f"invalid Snappy stream: fragment {i} of {len(ulens)} "
                f"failed validation ({host_err})") from host_err
        if len(ctx) - before != ulens[i]:
            raise ValueError(
                f"invalid Snappy stream: fragment {i} of {len(ulens)} "
                f"decoded {len(ctx) - before} bytes, expected {ulens[i]}")
    return bytes(ctx)
