"""ctypes bindings to the clean-room C++ golden codec (native/).

Builds the shared library and the CLI harness with the system C++ compiler
on first use and keeps them under native/build/. This is the Python face of
the reference's tests/swcompression.cc path: an independent native
implementation used to certify the device codec's output.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import pathlib
import platform
import subprocess
import threading

_ROOT = pathlib.Path(__file__).resolve().parent.parent.parent
_NATIVE = _ROOT / "native"
_BUILD = _NATIVE / "build"

MODE_BASELINE = 0
MODE_DENSE = 1

_ERRORS = {
    1: "truncated stream",
    2: "bad copy offset",
    3: "length mismatch",
    4: "output capacity too small",
    5: "bad varint",
    6: "chunk CRC mismatch",
    7: "bad chunk",
}

_lock = threading.Lock()
_lib = None


_SOURCES = ("snappy_ref.cc", "snappy_ref.h", "swcompression.cc")


def _stamp() -> str:
    """What the build depends on: the sources, the compiler, the machine
    and the build directory's own path. A build whose stamp differs (a
    source edit, another toolchain, a tree copied from elsewhere) is
    rebuilt rather than trusted."""
    h = hashlib.sha256()
    for name in _SOURCES:
        h.update((_NATIVE / name).read_bytes())
    cxx = os.environ.get("CXX", "c++")
    ver = subprocess.run([cxx, "--version"], capture_output=True,
                         text=True).stdout
    h.update("\0".join([cxx, ver, platform.platform(), str(_BUILD)]).encode())
    return h.hexdigest()


def _build() -> pathlib.Path:
    """Build (or reuse) native/build/libsnappy_ref.so and the swcompression
    CLI with `c++ -O2`. A file lock serializes concurrent builders (test
    workers); outputs are written under temporary names and renamed."""
    lib = _BUILD / "libsnappy_ref.so"
    _BUILD.mkdir(parents=True, exist_ok=True)
    with open(_BUILD / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        stamp_file = _BUILD / "stamp"
        stamp = _stamp()
        if (lib.exists() and (_BUILD / "swcompression").exists()
                and stamp_file.exists()
                and stamp_file.read_text() == stamp):
            return lib
        cxx = os.environ.get("CXX", "c++")
        tmp_lib = _BUILD / f"libsnappy_ref.so.tmp{os.getpid()}"
        tmp_cli = _BUILD / f"swcompression.tmp{os.getpid()}"
        subprocess.run(
            [cxx, "-O2", "-std=c++17", "-shared", "-fPIC",
             str(_NATIVE / "snappy_ref.cc"), "-o", str(tmp_lib)],
            check=True, capture_output=True)
        os.replace(tmp_lib, lib)
        subprocess.run(
            [cxx, "-O2", "-std=c++17", str(_NATIVE / "swcompression.cc"),
             "-o", str(tmp_cli), "-L", str(_BUILD), "-lsnappy_ref",
             "-Wl,-rpath,$ORIGIN"],
            check=True, capture_output=True)
        os.replace(tmp_cli, _BUILD / "swcompression")
        stamp_file.write_text(stamp)
    return lib


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            lib.sr_max_compressed_length.restype = ctypes.c_size_t
            lib.sr_max_compressed_length.argtypes = [ctypes.c_size_t]
            lib.sr_compress.restype = ctypes.c_size_t
            lib.sr_compress.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_int
            ]
            lib.sr_uncompressed_length.restype = ctypes.c_int
            lib.sr_uncompressed_length.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_uint64)
            ]
            lib.sr_uncompress.restype = ctypes.c_int
            lib.sr_uncompress.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p,
                ctypes.c_size_t, ctypes.POINTER(ctypes.c_uint64),
            ]
            lib.sr_scan_index.restype = ctypes.c_int
            lib.sr_scan_index.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_size_t,
                ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint32),
                ctypes.POINTER(ctypes.c_uint32), ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_uint32),
            ]
            lib.sr_root_map.restype = ctypes.c_int
            lib.sr_root_map.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint64,
                ctypes.POINTER(ctypes.c_uint16),
                ctypes.POINTER(ctypes.c_uint16),
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_uint32),
            ]
            lib.sr_depth_hints.restype = ctypes.c_int
            lib.sr_depth_hints.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint64,
                ctypes.c_uint32, ctypes.c_uint32,
                ctypes.POINTER(ctypes.c_uint8),
            ]
            lib.sr_depth_hints_sim.restype = ctypes.c_int
            lib.sr_depth_hints_sim.argtypes = lib.sr_depth_hints.argtypes
            lib.sr_crc32c.restype = ctypes.c_uint32
            lib.sr_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
            lib.sr_max_framed_length.restype = ctypes.c_size_t
            lib.sr_max_framed_length.argtypes = [ctypes.c_size_t]
            lib.sr_compress_framed.restype = ctypes.c_size_t
            lib.sr_compress_framed.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_int
            ]
            lib.sr_uncompress_framed.restype = ctypes.c_int
            lib.sr_uncompress_framed.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p,
                ctypes.c_size_t, ctypes.POINTER(ctypes.c_uint64),
            ]
            _lib = lib
    return _lib


def swcompression_path() -> pathlib.Path:
    """Path to the CLI harness binary (built on demand)."""
    _build()
    return _BUILD / "swcompression"


def compress(data: bytes, mode: int = MODE_BASELINE) -> bytes:
    lib = _load()
    cap = lib.sr_max_compressed_length(len(data))
    out = ctypes.create_string_buffer(cap)
    n = lib.sr_compress(data, len(data), out, mode)
    return out.raw[:n]


def scan_index(comp: bytes, start: int, total: int, max_frags: int):
    """Fragment table of a Snappy stream via the native element walk.

    Returns (comp_offsets u32[F], out_lens u32[F], F). Raises RuntimeError
    on malformed or non-fragmentable streams (callers fall back)."""
    import numpy as np

    lib = _load()
    offs = (ctypes.c_uint32 * max_frags)()
    lens = (ctypes.c_uint32 * max_frags)()
    nfrag = ctypes.c_uint32()
    rc = lib.sr_scan_index(comp, len(comp), start, total, offs, lens,
                           max_frags, ctypes.byref(nfrag))
    if rc:
        raise RuntimeError(f"scan_index: {_ERRORS.get(rc, rc)}")
    f = nfrag.value
    return (np.frombuffer(offs, dtype=np.uint32)[:f].astype(np.int64),
            np.frombuffer(lens, dtype=np.uint32)[:f].astype(np.int64), f)


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli, unmasked) via the native slice-by-8 path."""
    return _load().sr_crc32c(data, len(data))


def root_map(elems: bytes, ulen: int):
    """Affine pieces of the element stream's literal-root map (the framed
    sidecar payload; see sr_root_map in native/snappy_ref.h).

    Returns (starts u16[P], roots u16[P], slopes u8[P] in {0,1}) as numpy
    arrays. Raises RuntimeError on malformed streams or capacity (elems
    >= 64 KB)."""
    import numpy as np

    lib = _load()
    max_pieces = max(1, ulen)
    starts = (ctypes.c_uint16 * max_pieces)()
    roots = (ctypes.c_uint16 * max_pieces)()
    slopes = (ctypes.c_uint8 * max_pieces)()
    npieces = ctypes.c_uint32()
    rc = lib.sr_root_map(elems, len(elems), ulen, starts, roots, slopes,
                         max_pieces, ctypes.byref(npieces))
    if rc:
        raise RuntimeError(f"root_map: {_ERRORS.get(rc, rc)}")
    p = npieces.value
    return (np.frombuffer(starts, dtype=np.uint16)[:p].copy(),
            np.frombuffer(roots, dtype=np.uint16)[:p].copy(),
            np.frombuffer(slopes, dtype=np.uint8)[:p].copy())


def depth_hints(elems: bytes, ulen: int, tail_cap: int, tile: int):
    """Per-tile resolve depth hints for one element stream (the framed
    0x81 sidecar; see sr_depth_hints). Returns a (65536//tile,) uint8
    numpy array. Raises RuntimeError on malformed streams/capacity."""
    import numpy as np

    lib = _load()
    nt = 65536 // tile
    out = (ctypes.c_uint8 * nt)()
    rc = lib.sr_depth_hints(elems, len(elems), ulen, tail_cap, tile, out)
    if rc:
        raise RuntimeError(f"depth_hints: {_ERRORS.get(rc, rc)}")
    return np.frombuffer(out, dtype=np.uint8).copy()


def depth_hints_sim(elems: bytes, ulen: int, tail_cap: int, tile: int):
    """Brute-force simulation oracle for depth_hints (sr_depth_hints_sim);
    tests assert the analytic builder matches it bit-exactly."""
    import numpy as np

    lib = _load()
    nt = 65536 // tile
    out = (ctypes.c_uint8 * nt)()
    rc = lib.sr_depth_hints_sim(elems, len(elems), ulen, tail_cap, tile, out)
    if rc:
        raise RuntimeError(f"depth_hints_sim: {_ERRORS.get(rc, rc)}")
    return np.frombuffer(out, dtype=np.uint8).copy()


def compress_framed(data: bytes, mode: int = MODE_BASELINE) -> bytes:
    """Compress to the official Snappy framing format (framing_format.txt)."""
    lib = _load()
    cap = lib.sr_max_framed_length(len(data))
    out = ctypes.create_string_buffer(cap)
    n = lib.sr_compress_framed(data, len(data), out, mode)
    return out.raw[:n]


def uncompress_framed(data: bytes, max_out: int | None = None) -> bytes:
    """Decompress + fully validate a framed stream (structure and CRCs)."""
    lib = _load()
    # Framed streams carry no total-length preamble; size the buffer from
    # the worst-case expansion (every chunk a full 64 KB uncompressed).
    cap = max_out if max_out is not None else max(1, len(data) * 256)
    out = ctypes.create_string_buffer(cap)
    got = ctypes.c_uint64()
    rc = lib.sr_uncompress_framed(data, len(data), out, cap,
                                  ctypes.byref(got))
    if rc:
        raise ValueError(f"golden uncompress_framed: {_ERRORS.get(rc, rc)}")
    return out.raw[: got.value]


def uncompress(data: bytes) -> bytes:
    lib = _load()
    ulen = ctypes.c_uint64()
    rc = lib.sr_uncompressed_length(data, len(data), ctypes.byref(ulen))
    if rc:
        raise ValueError(f"golden uncompress: {_ERRORS.get(rc, rc)}")
    out = ctypes.create_string_buffer(max(1, ulen.value))
    got = ctypes.c_uint64()
    rc = lib.sr_uncompress(data, len(data), out, ulen.value, ctypes.byref(got))
    if rc:
        raise ValueError(f"golden uncompress: {_ERRORS.get(rc, rc)}")
    return out.raw[: got.value]
