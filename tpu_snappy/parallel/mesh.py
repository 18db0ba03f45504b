"""Device mesh construction for data-parallel block sharding.

The reference has no multi-chip story (single RoCC on a single Rocket tile,
SURVEY.md §2.6); this layer is the device scaling design: independent
64 KB Snappy blocks are data-parallel by format definition (no cross-block
references), so the only mesh axis is `dp`. Every sharded program keeps
its inputs and outputs on the `dp` axis and holds no collective; the host
gathers the (offset, length) manifest and the payload (shard.fetch_global).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, axis: str = "dp") -> Mesh:
    """1-D mesh over the first n_devices devices (all by default). Asking
    for more devices than exist is an error, never a smaller mesh."""
    devs = jax.devices()
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(f"mesh of {n_devices} devices requested, "
                             f"{len(devs)} present")
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def block_sharding(mesh: Mesh, axis: str = "dp") -> NamedSharding:
    """Blocks (B, 65536) sharded along the block axis."""
    return NamedSharding(mesh, P(axis, None))


def scalar_sharding(mesh: Mesh, axis: str = "dp") -> NamedSharding:
    """Per-block scalars (B,) sharded along the block axis."""
    return NamedSharding(mesh, P(axis))
