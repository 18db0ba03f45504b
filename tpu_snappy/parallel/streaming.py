"""Streaming driver for inputs larger than device memory.

The reference's answer to "input bigger than fast memory" is the sliding
ring-buffer window (MemoryController.scala:184-187). Snappy's 64 KB window
makes the device answer simpler: stream the input in multi-block waves, keep
two waves in flight (host->device copy of wave k+1 overlaps device encode of
wave k — the MemoryController compute/IO-overlap role), and append each
wave's manifest-ordered output to the sink. Multi-host runs shard each wave
over the full mesh; the per-wave manifest gather (shard.fetch_global) is
the only synchronization point, which is also the natural resume point
(SURVEY.md §5 checkpoint note).
"""

from __future__ import annotations

import dataclasses
from typing import BinaryIO, Iterator

import jax

from .. import format as fmt
from ..config import CodecConfig, DEFAULT_CONFIG
from . import mesh as meshlib
from . import shard


@dataclasses.dataclass
class StreamStats:
    in_bytes: int = 0
    out_bytes: int = 0
    waves: int = 0

    @property
    def ratio(self) -> float:
        return self.in_bytes / max(1, self.out_bytes)


def compress_stream(src: BinaryIO, dst: BinaryIO, total_len: int, mesh=None,
                    blocks_per_wave: int | None = None,
                    cfg: CodecConfig = DEFAULT_CONFIG,
                    resume: StreamStats | None = None) -> StreamStats:
    """Compress `total_len` bytes from src to dst in double-buffered waves.

    The output is one standard Snappy stream (single varint preamble);
    every wave is a whole number of 64 KB blocks so waves concatenate
    seamlessly.

    Resume: the per-wave manifest is the natural checkpoint (SURVEY.md §5).
    Pass the StreamStats of an interrupted run (with src seeked to
    stats.in_bytes and dst positioned/truncated at stats.out_bytes) to
    continue; completed waves are never recomputed.
    """
    if mesh is None:
        mesh = meshlib.make_mesh()
    n_dev = mesh.devices.size
    if blocks_per_wave is None:
        # Per-DEVICE batch: 24 blocks (3 jit waves of DP_WAVE) per device.
        blocks_per_wave = 24 * n_dev
    blocks_per_wave = shard.pad_count(blocks_per_wave, n_dev)
    # Per-device block count must be a whole number of jit waves (the
    # bounded-compile lax.map inside shard._encode_fn).
    per_dev = blocks_per_wave // n_dev
    jwave = min(shard.DP_WAVE, per_dev)
    blocks_per_wave = (-(-per_dev // jwave) * jwave) * n_dev
    wave_bytes = blocks_per_wave * cfg.block_size
    enc = shard._encode_fn_compact(mesh, cfg, jwave)
    bspec = meshlib.block_sharding(mesh)
    sspec = meshlib.scalar_sharding(mesh)

    if resume is not None:
        if resume.in_bytes % wave_bytes:
            raise ValueError("resume point must be a whole number of waves")
        stats = StreamStats(resume.in_bytes, resume.out_bytes, resume.waves)
    else:
        stats = StreamStats()
        dst.write(fmt.varint_encode(total_len))
        stats.out_bytes += fmt.varint_size(total_len)

    def waves() -> Iterator[tuple]:
        remaining = total_len - stats.in_bytes
        while remaining > 0:
            take = min(wave_bytes, remaining)
            buf = src.read(take)
            if len(buf) != take:
                raise IOError("short read from source")
            remaining -= take
            arr, lengths, nblocks = shard.blocks_of(buf, cfg.block_size,
                                                    blocks_per_wave)
            yield (jax.device_put(arr, bspec),
                   jax.device_put(lengths, sspec), nblocks, take)

    # Drain (device fetch + host assembly + sink write) runs on a single
    # worker thread so it overlaps the NEXT wave's host->device copy and
    # device encode — the host-assembly half of the MemoryController
    # compute/IO-overlap role. One worker keeps writes ordered.
    import concurrent.futures as cf

    with cf.ThreadPoolExecutor(max_workers=1) as pool:
        fut = None
        for blocks, lens, nblocks, take in waves():
            dense, out_lens = enc(blocks, lens)  # async dispatch
            if fut is not None:
                fut.result()  # surface drain errors before queueing more
            fut = pool.submit(_drain, (dense, out_lens, nblocks, take),
                              dst, stats, mesh, cfg.block_capacity)
        if fut is not None:
            fut.result()
    return stats


def _drain(pending, dst, stats, mesh, cap) -> None:
    dense, out_lens, nblocks, take = pending
    lens_np = shard.fetch_global(out_lens)
    # Device-compacted wave: fetch per-device dense payload segments and
    # write them straight out — no per-block Python join (the device
    # scattered every block to its manifest offset, ops/encode.py
    # compact_blocks).
    for piece in shard.assemble_compact(dense, lens_np, nblocks, mesh, cap):
        dst.write(piece)
        stats.out_bytes += len(piece)
    stats.in_bytes += take
    stats.waves += 1
