"""Test configuration: force CPU with an 8-device virtual mesh.

The default suite needs no accelerator: multi-device sharding is validated
on a virtual CPU mesh (the TLTestRAM/DummyPTW analogue of
ScratchpadTest.scala — fake the fabric, run the real logic). Tests that
need the GPU carry the `gpu` marker and take the `gpu` fixture, which
skips them on a machine without one; `python chip_smoke.py` runs the same
checks on the card.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax

# No persistent compilation cache for the CPU suite: test workers compile
# many small graphs concurrently, and nothing is gained by keeping them.
jax.config.update("jax_enable_compilation_cache", False)


import pytest


@pytest.fixture()
def gpu():
    """The first device, when it is a GPU; skips otherwise. Decided here,
    at run time — never at import or collection time, so every test
    worker collects the same tests."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX platform is {dev.platform!r}")
    return dev


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Free compiled executables between test modules.

    The full suite accumulates hundreds of distinct XLA:CPU executables in
    one process; past some threshold a later compile reproducibly
    segfaults inside backend_compile (observed three runs in a row at the
    same test, which passes in isolation and in any smaller combination —
    an upstream XLA:CPU resource/codegen issue, not a codec bug). Dropping
    the jit caches per module keeps the live-executable count bounded; the
    cost is re-compiling shared graphs (~+20% suite time)."""
    yield
    import jax
    jax.clear_caches()
