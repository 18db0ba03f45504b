"""ctypes bindings to the REAL google/snappy system library.

BASELINE.md's correctness bar is "bit-for-bit decompressible by
google/snappy (tests/swcompression.cc path)" — the reference links the
actual library (reference tests/swcompression.cc:31, .gitmodules:13-15).
This module binds the system libsnappy (libsnappy.so.1) through snappy's
stable C ABI (snappy-c.h), alongside the two clean-room goldens.

Everything degrades gracefully: `available()` is False where no system
snappy exists, and the dependent tests skip (the clean-room goldens
remain the always-on certifiers).
"""

from __future__ import annotations

import ctypes
import ctypes.util

_LIB = None
_TRIED = False

#: snappy_status values (snappy-c.h).
OK, INVALID_INPUT, BUFFER_TOO_SMALL = 0, 1, 2


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    for name in ("libsnappy.so.1", "libsnappy.so",
                 ctypes.util.find_library("snappy")):
        if not name:
            continue
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            continue
        lib.snappy_max_compressed_length.restype = ctypes.c_size_t
        lib.snappy_max_compressed_length.argtypes = [ctypes.c_size_t]
        lib.snappy_compress.restype = ctypes.c_int
        lib.snappy_compress.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_size_t)]
        lib.snappy_uncompress.restype = ctypes.c_int
        lib.snappy_uncompress.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_size_t)]
        lib.snappy_uncompressed_length.restype = ctypes.c_int
        lib.snappy_uncompressed_length.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_size_t)]
        lib.snappy_validate_compressed_buffer.restype = ctypes.c_int
        lib.snappy_validate_compressed_buffer.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t]
        _LIB = lib
        break
    return _LIB


def available() -> bool:
    return _load() is not None


def compress(data: bytes) -> bytes:
    """google/snappy's own compressor (raw stream)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("system libsnappy not available")
    cap = lib.snappy_max_compressed_length(len(data))
    out = ctypes.create_string_buffer(cap)
    out_len = ctypes.c_size_t(cap)
    rc = lib.snappy_compress(data, len(data), out, ctypes.byref(out_len))
    if rc != OK:
        raise RuntimeError(f"snappy_compress failed ({rc})")
    return out.raw[: out_len.value]


def uncompress(comp: bytes) -> bytes:
    """google/snappy's own decompressor; ValueError on invalid input."""
    lib = _load()
    if lib is None:
        raise RuntimeError("system libsnappy not available")
    ulen = ctypes.c_size_t(0)
    rc = lib.snappy_uncompressed_length(comp, len(comp), ctypes.byref(ulen))
    if rc != OK:
        raise ValueError(f"snappy_uncompressed_length failed ({rc})")
    out = ctypes.create_string_buffer(max(1, ulen.value))
    out_len = ctypes.c_size_t(ulen.value)
    rc = lib.snappy_uncompress(comp, len(comp), out, ctypes.byref(out_len))
    if rc != OK:
        raise ValueError(f"snappy_uncompress failed ({rc})")
    return out.raw[: out_len.value]


def validate(comp: bytes) -> bool:
    lib = _load()
    if lib is None:
        raise RuntimeError("system libsnappy not available")
    return lib.snappy_validate_compressed_buffer(comp, len(comp)) == OK
