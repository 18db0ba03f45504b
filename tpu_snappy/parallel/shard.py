"""Data-parallel codec over a device mesh.

Blocks shard across chips on the `dp` axis; per-block work (sort-based
matching, commit scan, emission) stays chip-local — mirroring the
reference's per-job hash-table locality (clearPresent per job,
MatchFinder.scala:55) — and the variable-length results are reassembled in
original block order from an (offset, length) manifest. The sharded
programs hold no collective: every output, the manifest included, stays
sharded on its device and the host gathers it (fetch_global). Programs
without collectives need no NCCL clique, so two of them in flight at once
(a wave's encode beside the previous wave's assembly) cannot wait on each
other.
"""

from __future__ import annotations

import functools

import jax
import numpy as np

from .. import format as fmt
from ..config import CodecConfig, DEFAULT_CONFIG
from ..ops import decode as ops_decode
from ..ops import encode as ops_encode
from . import mesh as meshlib


def pad_count(count: int, n_devices: int) -> int:
    """Work items padded to a multiple of the mesh size (empty blocks encode
    to zero bytes and drop out at assembly)."""
    return -(-count // n_devices) * n_devices


#: Blocks/fragments per vmapped wave inside the sharded programs. The jit
#: below traces ONE wave regardless of total block count (shard_map gives
#: each device a local lax.map over its waves), so compile cost is
#: block-count-independent — the DP sibling of api.API_WAVE.
DP_WAVE = 8


@functools.lru_cache(maxsize=8)
def _encode_fn(mesh, cfg: CodecConfig, wave: int = DP_WAVE):
    """Jitted sharded encode: payload and length manifest stay
    block-sharded on their device (each device runs a bounded-compile
    lax.map over its local waves)."""
    from jax.sharding import PartitionSpec as P
    axis = cfg.dp_axis
    local = jax.shard_map(
        lambda b, l: ops_encode.encode_corpus(b, l, cfg, wave=wave),
        mesh=mesh, in_specs=(P(axis, None), P(axis)),
        out_specs=(P(axis, None), P(axis)), check_vma=False)
    return jax.jit(
        local,
        out_shardings=(meshlib.block_sharding(mesh, axis),
                       meshlib.scalar_sharding(mesh, axis)),
    )


@functools.lru_cache(maxsize=8)
def _encode_fn_compact(mesh, cfg: CodecConfig, wave: int = DP_WAVE):
    """Sharded encode with DEVICE-SIDE stream compaction: each device
    scatters its blocks' exact bytes to their local manifest offsets
    (ops_encode.compact_blocks — the RTL's store-bank drain role), so
    assembly fetches per-device dense payload segments instead of
    (B, capacity) padded rows. Returns (dense (NB*cap,) device-sharded,
    lens (NB,) device-sharded)."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    axis = cfg.dp_axis

    def local(b, l):
        out, lens = ops_encode.encode_corpus(b, l, cfg, wave=wave)
        dense, _total = ops_encode.compact_blocks(out, lens)
        return dense, lens

    fn = jax.shard_map(
        local, mesh=mesh, in_specs=(P(axis, None), P(axis)),
        out_specs=(P(axis), P(axis)), check_vma=False)
    return jax.jit(
        fn,
        out_shardings=(NamedSharding(mesh, P(cfg.dp_axis)),
                       NamedSharding(mesh, P(cfg.dp_axis))),
    )


def assemble_compact(dense, lens_np: np.ndarray, nblocks: int, mesh,
                     cap: int, fetch_bucket: int = 1 << 20) -> list[bytes]:
    """Host assembly from the compacted form: per-device dense segments
    sliced to their exact local totals (bucketed slice shapes keep the
    fetch-program count bounded). Returns the per-device payload pieces
    in block order. Multi-process runs gather the global dense first
    (fetch_global); single-process fetches only ceil(total/bucket) of
    each segment.

    Each segment is sliced from its own device's shard, a one-device
    program. A slice of the global array would be a multi-device program
    that the partitioner may give a collective, and callers assemble on a
    worker thread while the next wave is dispatched from another."""
    ndev = mesh.devices.size
    per = len(lens_np) // ndev
    pieces = []
    if jax.process_count() > 1:
        dn = fetch_global(dense)
        for d in range(ndev):
            nb_d = min(max(nblocks - d * per, 0), per)
            if nb_d == 0:
                break
            total = int(lens_np[d * per: d * per + nb_d].sum())
            pieces.append(dn[d * per * cap: d * per * cap + total].tobytes())
        return pieces
    shards = sorted(dense.addressable_shards,
                    key=lambda sh: sh.index[0].start or 0)
    for d in range(ndev):
        nb_d = min(max(nblocks - d * per, 0), per)
        if nb_d == 0:
            break
        total = int(lens_np[d * per: d * per + nb_d].sum())
        k = min(-(-total // fetch_bucket) * fetch_bucket, per * cap)
        seg = np.asarray(shards[d].data[:k])
        pieces.append(seg[:total].tobytes())
    return pieces


@functools.lru_cache(maxsize=8)
def _decode_sidecar_fn(mesh, axis: str = "dp", wave: int = DP_WAVE):
    """Sharded sidecar fast-decode (framing 0x80 chunks): the per-chunk
    scatter+ffill+gather pipeline is chunk-independent like everything
    else, so it shards DP identically to _decode_fn."""
    from jax.sharding import PartitionSpec as P

    from .. import sidecar as sc
    local = jax.shard_map(
        lambda e, s, v, u: sc.decode_corpus_sidecar(e, s, v, u, wave=wave),
        mesh=mesh, in_specs=(P(axis, None), P(axis, None), P(axis, None),
                             P(axis)),
        out_specs=P(axis, None), check_vma=False)
    return jax.jit(local, out_shardings=meshlib.block_sharding(mesh, axis))


@functools.lru_cache(maxsize=8)
def _decode_fn(mesh, axis: str = "dp", wave: int = DP_WAVE):
    from jax.sharding import PartitionSpec as P
    local = jax.shard_map(
        lambda f, c, u: ops_decode.decode_corpus(f, c, u, wave=wave),
        mesh=mesh, in_specs=(P(axis, None), P(axis), P(axis)),
        out_specs=(P(axis, None), P(axis)), check_vma=False)
    return jax.jit(
        local,
        out_shardings=(meshlib.block_sharding(mesh, axis),
                       meshlib.scalar_sharding(mesh, axis)),
    )


def fetch_global(x) -> np.ndarray:
    """Materialize a (possibly process-spanning) sharded array on the host.

    Single-process: a plain fetch. Multi-process: the payload shards live
    on other hosts' devices, so an explicit cross-process all-gather
    brings the global value to every host — host 0 then assembles the
    stream."""
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils
        return np.asarray(multihost_utils.process_allgather(x, tiled=True))
    return np.asarray(x)


def blocks_of(data: bytes, block_size: int, padded: int):
    """Host-side split of `data` into (padded, 65536) blocks + lengths."""
    n = len(data)
    arr = np.zeros((padded, fmt.BLOCK_SIZE), dtype=np.uint8)
    flat = np.frombuffer(data, dtype=np.uint8)
    nblocks = max(1, -(-n // block_size))
    for i in range(nblocks):
        chunk = flat[i * block_size:(i + 1) * block_size]
        arr[i, : len(chunk)] = chunk
    lengths = np.minimum(
        np.maximum(n - np.arange(padded, dtype=np.int64) * block_size, 0),
        block_size).astype(np.int32)
    return arr, lengths, nblocks


def encode_dp(data: bytes, mesh, cfg: CodecConfig = DEFAULT_CONFIG) -> bytes:
    """Compress `data` with blocks sharded data-parallel over `mesh`."""
    n = len(data)
    nblocks = max(1, -(-n // cfg.block_size))
    ndev = mesh.devices.size
    per_dev = -(-nblocks // ndev)
    wave = min(DP_WAVE, per_dev)  # small jobs stay one short wave
    padded = (-(-per_dev // wave) * wave) * ndev
    arr, lengths, nblocks = blocks_of(data, cfg.block_size, padded)

    blocks = jax.device_put(arr, meshlib.block_sharding(mesh, cfg.dp_axis))
    lens = jax.device_put(lengths, meshlib.scalar_sharding(mesh, cfg.dp_axis))
    dense, out_lens = _encode_fn_compact(mesh, cfg, wave)(blocks, lens)

    # Ordered assembly on host: per-device dense payload segments (the
    # device already compacted each block to its manifest offset — no
    # per-block Python join, no padded-capacity fetch).
    lens_np = fetch_global(out_lens)
    parts = [fmt.varint_encode(n)] + assemble_compact(
        dense, lens_np, nblocks, mesh, cfg.block_capacity)
    return b"".join(parts)


def decode_dp(comp: bytes, mesh, cfg: CodecConfig = DEFAULT_CONFIG) -> bytes:
    """Fragment-parallel decompression sharded over `mesh`."""
    total, start = fmt.varint_decode(comp)
    if total == 0:
        return b""
    frags, clens, ulens = ops_decode.fragment_table(comp, start, total)
    frags = frags[:, : ops_decode.frag_width(clens)]
    nfrag = len(clens)
    ndev = mesh.devices.size
    per_dev = -(-nfrag // ndev)
    wave = min(DP_WAVE, per_dev)
    padded = (-(-per_dev // wave) * wave) * ndev
    if padded != nfrag:
        frags = np.pad(frags, ((0, padded - nfrag), (0, 0)))
        clens = np.pad(clens, (0, padded - nfrag))
        ulens = np.pad(ulens, (0, padded - nfrag))

    out, ok = _decode_fn(mesh, cfg.dp_axis, wave)(
        jax.device_put(frags, meshlib.block_sharding(mesh, cfg.dp_axis)),
        jax.device_put(np.asarray(clens, np.int32),
                       meshlib.scalar_sharding(mesh, cfg.dp_axis)),
        jax.device_put(np.asarray(ulens, np.int32),
                       meshlib.scalar_sharding(mesh, cfg.dp_axis)),
    )
    okv = fetch_global(ok)[:nfrag]
    if not okv.all():
        # Fragment-granular host fallback (exotic fragments re-decode with
        # the already-decoded prefix as context; corrupt ones raise).
        from ..api import _splice_failed_fragments
        result = _splice_failed_fragments(
            frags[:nfrag], clens[:nfrag], ulens[:nfrag],
            fetch_global(out)[:nfrag], okv)
    else:
        out_np = fetch_global(out)
        result = b"".join(out_np[i, : ulens[i]].tobytes()
                          for i in range(nfrag))
    if len(result) != total:
        raise ValueError("length mismatch vs preamble")
    return result
