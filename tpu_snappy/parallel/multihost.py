"""Multi-host process bootstrap and global-mesh codec entry points.

BASELINE config 5 is a 2+-host streaming encode: blocks data-parallel over
the global device set, the per-wave (offset, length) manifest all-gathered
across hosts, host 0 assembling output in order. The reference has no analogue
(single RoCC on a single tile, SURVEY.md §2.6); this is new capability.

This single-host dev environment cannot execute a 2-host run; the layer is
exercised by the same code paths as the single-host mesh (shard.py is
host-count agnostic — `jax.distributed.initialize` just widens
`jax.devices()`), and the multi-device behavior is validated on the virtual
CPU mesh in tests.
"""

from __future__ import annotations

import jax

from ..config import CodecConfig, DEFAULT_CONFIG
from . import mesh as meshlib
from . import shard
from . import streaming


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Bring up the multi-host runtime (idempotent).

    With no arguments JAX autodetects the cluster where a cluster
    environment describes it; otherwise pass the explicit form:
        init_distributed("host0:8476", num_processes=2, process_id=rank)
    """
    # Idempotency must not touch the backend: jax.process_count() would
    # initialize XLA, after which jax.distributed.initialize() refuses to
    # run. Check the distributed client state directly.
    from jax._src import distributed as _dist
    if getattr(_dist.global_state, "client", None) is not None:
        return  # already initialized
    kwargs = {}
    if coordinator is not None:
        kwargs = dict(coordinator_address=coordinator,
                      num_processes=num_processes, process_id=process_id)
    jax.distributed.initialize(**kwargs)


def global_mesh(axis: str = "dp"):
    """1-D dp mesh over every device of every process."""
    return meshlib.make_mesh(axis=axis)


def compress_multihost(src, dst, total_len: int,
                       blocks_per_wave: int | None = None,
                       cfg: CodecConfig = DEFAULT_CONFIG):
    """Streaming encode over the global mesh.

    Every process must call this collectively with the same arguments;
    `src` must yield identical bytes on every process (shared filesystem),
    and only process 0's `dst` receives output (others may pass a sink).
    The wave manifest is gathered to every host after each wave
    (shard.fetch_global) — the only cross-host communication.
    """
    mesh = global_mesh()
    stats = streaming.compress_stream(
        src, dst if jax.process_index() == 0 else _NullSink(),
        total_len, mesh, blocks_per_wave=blocks_per_wave, cfg=cfg)
    return stats


class _NullSink:
    def write(self, b):
        return len(b)


def compress_dp_global(data: bytes, cfg: CodecConfig = DEFAULT_CONFIG) -> bytes:
    """One-shot global-mesh compress (all processes call collectively)."""
    return shard.encode_dp(data, global_mesh(), cfg)
