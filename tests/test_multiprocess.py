"""Two-process jax.distributed validation (the real multi-process
collective path: global mesh spanning processes, cross-process payload
all-gather, host-0 assembly). Runs tools/multiproc_run.py as CPU
subprocesses, the CPU backend playing the fabric (the analogue of the
TLTestRAM fake-SoC tier); the GPU path never starts a second JAX
process."""

import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.nightly
def test_two_process_distributed_encode():
    """Marked nightly: a 2-process jax.distributed bootstrap + two full
    pipeline compiles per process is minutes-scale on a loaded machine
    (the default suite's budget is ~10 min total). Run explicitly via
    `pytest -m nightly tests/test_multiprocess.py`. The launcher reaps
    its worker processes on failure/timeout (multiproc_run.main)."""
    r = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "multiproc_run.py")],
        cwd=ROOT, capture_output=True, text=True, timeout=1200,
        env={k: v for k, v in __import__("os").environ.items()
             if k not in ("JAX_PLATFORMS", "XLA_FLAGS")})
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    out = json.loads([ln for ln in r.stdout.splitlines()
                      if ln.startswith("{")][-1])
    assert out["processes"] == 2 and out["global_devices"] == 8
    assert out["roundtrip_ok"] and out["oneshot_bytes"] == out["stream_bytes"]
