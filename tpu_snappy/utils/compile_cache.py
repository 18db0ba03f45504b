"""Where the persistent XLA compilation cache lives.

JAX keys cached executables by program and compiler, not by directory, but
a cache is only found again at the same path. So the path is fixed: the
directory `JAX_COMPILATION_CACHE_DIR` names when it is set (JAX reads that
variable itself), and otherwise `<repo root>/.jax_cache`, found from this
package's own location. Never a path built from a temporary name, a pid or
the time.
"""

from __future__ import annotations

import os
import pathlib

REPO_ROOT = pathlib.Path(__file__).resolve().parents[2]
ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def cache_dir() -> pathlib.Path:
    """The compile-cache directory this process uses."""
    env = os.environ.get(ENV_VAR)
    return pathlib.Path(env) if env else REPO_ROOT / ".jax_cache"


def enable() -> pathlib.Path:
    """Point JAX's persistent compilation cache at cache_dir() and return
    it. Where the environment variable is set, JAX already uses it and no
    other directory is set here."""
    import jax

    path = cache_dir()
    if ENV_VAR not in os.environ:
        jax.config.update("jax_compilation_cache_dir", str(path))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
