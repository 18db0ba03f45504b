"""tpu-snappy: a Snappy codec in JAX for NVIDIA GPUs.

Brand-new implementation of the capabilities of the reference Chisel RoCC
compression accelerator (nullromo/compression-accelerator): XLA programs
over whole 64 KB blocks, data-parallel block sharding over device meshes,
and a native C++ golden harness.
"""

from .config import CodecConfig, DEFAULT_CONFIG  # noqa: F401
from . import format  # noqa: F401
from . import reference_codec  # noqa: F401

# Lazy conveniences (import jax/numpy only when touched):
#   tpu_snappy.api     — compress()/decompress() host API
#   tpu_snappy.compat  — python-snappy drop-in surface
#   tpu_snappy.hadoop  — Hadoop SnappyCodec container
#   tpu_snappy.framing — official framing-format container

__version__ = "0.1.0"
