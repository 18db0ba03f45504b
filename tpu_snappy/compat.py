"""python-snappy–compatible API surface (drop-in `import snappy` shim).

The de-facto Python interface to this format is the `python-snappy`
package (`import snappy`): `compress` / `uncompress` / `isValidCompressed`,
the framing-format `StreamCompressor` / `StreamDecompressor` incremental
classes, and the `stream_compress` / `stream_decompress` file helpers.
The reference accelerator's host-side users program against exactly this
kind of byte-level API (tests/compression.c:20-39 `compress(src, dst)` /
`uncompress`); anyone migrating a Python Snappy workload onto the device
codec needs the same names with the same semantics. Usage:

    from tpu_snappy import compat as snappy
    snappy.uncompress(snappy.compress(b"payload"))

Everything routes through the batched device pipelines (api.py for raw
streams, framing.py for the framed container), so the compatibility layer
inherits wave batching, golden verification, and the host small-input
fast-path unchanged. The Hadoop SnappyCodec container lives in
tpu_snappy.hadoop (exposed here as `hadoop` for parity with
python-snappy's `snappy.hadoop_snappy`).
"""

from __future__ import annotations

import io

from . import api, framing
from .config import CodecConfig, DEFAULT_CONFIG

__all__ = [
    "UncompressError", "compress", "uncompress", "decompress",
    "isValidCompressed", "StreamCompressor", "StreamDecompressor",
    "stream_compress", "stream_decompress",
]

#: File-helper read granularity (python-snappy's _STREAM_TO_STREAM_BLOCK_SIZE
#: is also one framing chunk, 65536). Larger reads still emit 64 KB chunks;
#: this only sets how much data each device wave sees at once.
_STREAM_TO_STREAM_BLOCK_SIZE = framing.MAX_CHUNK


class UncompressError(Exception):
    """Raised for malformed compressed input (python-snappy's exception)."""


def _coerce(data, encoding: str | None) -> bytes:
    if isinstance(data, str):
        if encoding is None:
            raise TypeError("str input requires an encoding")
        return data.encode(encoding)
    return bytes(data)


def compress(data, encoding: str = "utf-8",
             cfg: CodecConfig = DEFAULT_CONFIG) -> bytes:
    """Raw Snappy stream of `data` (str accepted, per python-snappy)."""
    return api.compress(_coerce(data, encoding), cfg)


def uncompress(data, decoding: str | None = None,
               cfg: CodecConfig = DEFAULT_CONFIG):
    """Decompress a raw Snappy stream; UncompressError on malformed input.

    `decoding` returns str (python-snappy extension for text payloads)."""
    try:
        out = api.decompress(bytes(data), cfg)
    except ValueError as e:
        raise UncompressError(str(e)) from e
    return out.decode(decoding) if decoding else out


decompress = uncompress


def isValidCompressed(data) -> bool:
    """True iff `data` is a structurally valid raw Snappy stream."""
    try:
        api.decompress(bytes(data))
        return True
    except ValueError:
        return False


class StreamCompressor:
    """Incremental framing-format compressor (framing_format.txt).

    add_chunk(data) returns the framed bytes for `data` — the stream
    identifier first, then one data chunk per 64 KB, encoded by the
    batched device pipeline. Output concatenates across calls into one
    valid framed stream; chunk boundaries follow call boundaries (chunks
    are independent, so any boundary placement is spec-valid and
    decompresses identically)."""

    def __init__(self, cfg: CodecConfig = DEFAULT_CONFIG):
        self._cfg = cfg
        self._header_sent = False

    def add_chunk(self, data, compress=None) -> bytes:
        # `compress` is python-snappy's deprecated no-op knob (kept for
        # signature parity; the encoder already falls back to uncompressed
        # chunks when compression would not shrink, per the spec).
        out = framing.compress(_coerce(data, "utf-8"), self._cfg)
        if self._header_sent:
            out = out[len(framing.STREAM_ID):]
        else:
            self._header_sent = True
        return out

    compress = add_chunk

    def flush(self) -> bytes:
        """No buffered state — every add_chunk emits complete chunks."""
        return b""

    def copy(self) -> "StreamCompressor":
        c = StreamCompressor(self._cfg)
        c._header_sent = self._header_sent
        return c


class StreamDecompressor:
    """Incremental framing-format decompressor.

    decompress(data) buffers arbitrary byte slices and returns all
    uncompressed bytes whose chunks completed, CRC-verified; complete
    chunks in one call decode as one batched device wave. flush() raises
    UncompressError if a partial chunk remains (truncated stream)."""

    def __init__(self, cfg: CodecConfig = DEFAULT_CONFIG):
        self._cfg = cfg
        self._buf = bytearray()
        self._header_seen = False

    def decompress(self, data) -> bytes:
        self._buf += bytes(data)
        if not self._header_seen:
            if len(self._buf) < len(framing.STREAM_ID):
                return b""
            if not bytes(self._buf).startswith(framing.STREAM_ID):
                raise UncompressError("missing stream identifier chunk")
            del self._buf[: len(framing.STREAM_ID)]
            self._header_seen = True

        window: list[tuple[int, bytes]] = []
        while True:
            if len(self._buf) < 4:
                break
            typ = self._buf[0]
            ln = int.from_bytes(self._buf[1:4], "little")
            if len(self._buf) < 4 + ln:
                break
            body = bytes(self._buf[4: 4 + ln])
            del self._buf[: 4 + ln]
            if typ == framing.CHUNK_STREAM_ID:
                if body != framing.STREAM_ID[4:]:
                    raise UncompressError("malformed repeated stream id")
            elif typ in (framing.CHUNK_COMPRESSED,
                         framing.CHUNK_UNCOMPRESSED):
                if ln < 4:
                    raise UncompressError("data chunk shorter than its CRC")
                window.append((typ, body))
            elif typ == framing.CHUNK_PADDING or typ >= 0x80:
                pass  # skippable
            else:
                raise UncompressError(
                    f"reserved unskippable chunk type {typ:#x}")
        if not window:
            return b""
        try:
            return b"".join(
                framing._decode_data_chunks(window, self._cfg, None))
        except ValueError as e:
            raise UncompressError(str(e)) from e

    def flush(self) -> bytes:
        if self._buf:
            raise UncompressError("chunk truncated")
        return b""

    def copy(self) -> "StreamDecompressor":
        c = StreamDecompressor(self._cfg)
        c._buf = bytearray(self._buf)
        c._header_seen = self._header_seen
        return c


def stream_compress(src: io.RawIOBase, dst: io.RawIOBase,
                    blocksize: int = _STREAM_TO_STREAM_BLOCK_SIZE,
                    cfg: CodecConfig = DEFAULT_CONFIG) -> None:
    """Framed-compress a binary file object into another (python-snappy
    file helper). Reads `blocksize` bytes per device wave."""
    c = StreamCompressor(cfg)
    while True:
        buf = src.read(blocksize)
        if not buf:
            break
        out = c.add_chunk(buf)
        if out:
            dst.write(out)


def stream_decompress(src: io.RawIOBase, dst: io.RawIOBase,
                      blocksize: int = _STREAM_TO_STREAM_BLOCK_SIZE,
                      cfg: CodecConfig = DEFAULT_CONFIG) -> None:
    """Framed-decompress a binary file object into another."""
    d = StreamDecompressor(cfg)
    while True:
        buf = src.read(blocksize)
        if not buf:
            break
        out = d.decompress(buf)
        if out:
            dst.write(out)
    d.flush()


# python-snappy exposes the Hadoop container as snappy.hadoop_snappy.
from . import hadoop  # noqa: E402  (re-export for API parity)

hadoop_snappy = hadoop
