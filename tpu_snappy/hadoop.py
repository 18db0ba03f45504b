"""Hadoop SnappyCodec container (BlockCompressorStream framing).

Hadoop's `org.apache.hadoop.io.compress.SnappyCodec` wraps raw Snappy in
its own block container: a sequence of blocks, each

    [4-byte big-endian uncompressed block length]
    [one or more subblocks:
        4-byte big-endian compressed length, raw Snappy stream]

python-snappy ships this as `snappy.hadoop_snappy`; Spark/Hive/HDFS
`.snappy` files use it. The reference accelerator has no container at all
(SURVEY.md §0.2 — bare elements without even the varint preamble), so this
is pure framework surface: each subblock is a standard raw Snappy stream,
so the device block pipelines do all the work and this module only adds the
length framing.

Encode emits one subblock per block (what python-snappy and Hadoop's
default buffer configuration produce); decode accepts the general
multi-subblock form.
"""

from __future__ import annotations

import io
import struct

from . import api
from .config import CodecConfig, DEFAULT_CONFIG

#: Hadoop's io.compression.codec.snappy.buffersize default is 256 KB;
#: python-snappy's hadoop module uses the same figure.
SNAPPY_BUFFER_SIZE_DEFAULT = 256 * 1024

_INT = struct.Struct(">i")


def pack_block(block: bytes, cfg: CodecConfig = DEFAULT_CONFIG) -> bytes:
    """One Hadoop block (single subblock) for `block`."""
    comp = api.compress(block, cfg)
    return _INT.pack(len(block)) + _INT.pack(len(comp)) + comp


def stream_compress(src: io.RawIOBase, dst: io.RawIOBase,
                    blocksize: int = SNAPPY_BUFFER_SIZE_DEFAULT,
                    cfg: CodecConfig = DEFAULT_CONFIG) -> None:
    """Hadoop-compress a binary file object into another.

    Blocks whose size is a multiple of 64 KB batch all their 64 KB device
    blocks in one wave pass (api.compress does the batching); other sizes
    are equally valid, just less aligned to the device pipeline."""
    while True:
        buf = src.read(blocksize)
        if not buf:
            break
        dst.write(pack_block(buf, cfg))


def compress(data: bytes, blocksize: int = SNAPPY_BUFFER_SIZE_DEFAULT,
             cfg: CodecConfig = DEFAULT_CONFIG) -> bytes:
    """Hadoop container for `data` as bytes-in/bytes-out."""
    out = io.BytesIO()
    stream_compress(io.BytesIO(data), out, blocksize, cfg)
    return out.getvalue()


def stream_decompress(src: io.RawIOBase, dst: io.RawIOBase,
                      cfg: CodecConfig = DEFAULT_CONFIG) -> None:
    """Hadoop-decompress a binary file object into another (general
    multi-subblock form; validates every declared length)."""
    while True:
        hdr = src.read(4)
        if not hdr:
            break
        if len(hdr) != 4:
            raise ValueError("truncated Hadoop block header")
        (ulen,) = _INT.unpack(hdr)
        if ulen < 0:
            raise ValueError("negative Hadoop block length")
        got = 0
        while got < ulen:
            chdr = src.read(4)
            if len(chdr) != 4:
                raise ValueError("truncated Hadoop subblock header")
            (clen,) = _INT.unpack(chdr)
            if clen < 0:
                raise ValueError("negative Hadoop subblock length")
            sub = src.read(clen)
            if len(sub) != clen:
                raise ValueError("truncated Hadoop subblock payload")
            piece = api.decompress(sub, cfg)
            got += len(piece)
            dst.write(piece)
        if got != ulen:
            raise ValueError(
                f"Hadoop block decoded {got} bytes, header said {ulen}")


def decompress(data: bytes, cfg: CodecConfig = DEFAULT_CONFIG) -> bytes:
    """Hadoop container decode as bytes-in/bytes-out."""
    out = io.BytesIO()
    stream_decompress(io.BytesIO(data), out, cfg)
    return out.getvalue()
