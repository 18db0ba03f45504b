"""Multi-process jax.distributed check of the multihost codec path, on CPU.

The multihost LAYER (jax.distributed bootstrap, global mesh spanning
processes, cross-process manifest all-gather, host-0 assembly) is fully
exercisable with CPU processes on one machine: each process owns 4 virtual
CPU devices and the global mesh spans all of them. This is a CPU-only
check: on a GPU machine one process drives every card (one JAX process
per card), so nothing on the GPU path starts a second JAX process.

Usage:  python tools/multiproc_run.py [--nprocs N]   # launcher (default 2)
        python tools/multiproc_run.py --rank N       # worker (internal)

Rank 0 prints one JSON line with the result.
"""

import argparse
import json
import os
import pathlib
import socket
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def worker(rank: int, port: int, nprocs: int) -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=4")
    sys.path.insert(0, str(ROOT))
    import jax
    jax.config.update("jax_platforms", "cpu")

    from tpu_snappy.parallel import multihost
    multihost.init_distributed(f"localhost:{port}", num_processes=nprocs,
                               process_id=rank)
    assert jax.process_count() == nprocs, jax.process_count()
    assert len(jax.devices()) == 4 * nprocs, len(jax.devices())

    import io

    from tpu_snappy.utils import corpus
    # 9 blocks, and a streaming wave sized so both entry points resolve to
    # the SAME cached _encode_fn(mesh, cfg, wave) program — each process
    # compiles the pipeline ONCE. This is a collective-path validation,
    # not a throughput run, and XLA:CPU compile dominated the old
    # 17-block two-graph form.
    data = corpus.synth("text", 8 * 65536 + 12345, 0)
    ndev = 4 * nprocs
    nblocks = -(-len(data) // 65536)
    per_dev = -(-nblocks // ndev)

    # One-shot global-mesh compress (collective).
    comp = multihost.compress_dp_global(data)

    # Streaming multihost encode (collective; only rank 0 keeps output).
    dst = io.BytesIO()
    stats = multihost.compress_multihost(io.BytesIO(data), dst, len(data),
                                         blocks_per_wave=per_dev * ndev)

    if rank == 0:
        from tpu_snappy import reference_codec
        assert reference_codec.decompress(comp) == data
        assert reference_codec.decompress(dst.getvalue()) == data
        out = {
            "processes": nprocs,
            "devices_per_process": 4,
            "global_devices": 4 * nprocs,
            "platform": "cpu",
            "input_bytes": len(data),
            "oneshot_bytes": len(comp),
            "stream_bytes": stats.out_bytes,
            "roundtrip_ok": True,
        }
        print(json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--nprocs", type=int, default=2)
    args = ap.parse_args()
    if args.rank is not None:
        worker(args.rank, args.port, args.nprocs)
        return 0
    port = _free_port()
    procs = [
        subprocess.Popen([sys.executable, __file__, "--rank", str(r),
                          "--port", str(port), "--nprocs",
                          str(args.nprocs)], cwd=ROOT)
        for r in range(args.nprocs)
    ]
    rc = 0
    try:
        for p in procs:
            rc |= p.wait(timeout=1200)
    finally:
        # Reap stragglers: if any worker failed or the launcher is being
        # torn down (e.g. a pytest timeout killed us mid-wait), no orphan
        # may outlive this process.
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            if p.poll() is None:
                p.wait(timeout=30)
    print("multiproc run:", "OK" if rc == 0 else f"FAIL rc={rc}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
