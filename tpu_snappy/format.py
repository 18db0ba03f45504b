"""Snappy wire-format primitives: varints, tag bytes, size math.

This is the format layer of the device codec. It owns every constant and
bit-layout rule of the (public, stable) Snappy format so that the kernel code
never hard-codes format details.

Capability parity notes (reference = /root/reference, a Chisel RoCC Snappy
accelerator):
  * The reference computes the same multiplicative hash
    (HashTable.scala:51-53) and emits copy tags via CopyStreamFormer
    (CopyCompress.scala:236-260), but never emits the varint length preamble
    and only uses 1-byte literal tags (CompressionAccelerator.scala:172).
    We implement the FULL format: varint preamble + all literal tag forms +
    copy1/copy2/copy4, as required for bit-compatibility with software Snappy
    (tests/swcompression.cc path).
"""

from __future__ import annotations

# --- Stream-level constants -------------------------------------------------

#: Maximum LZ window / fragment size. Matches must not reach across a
#: fragment boundary, which bounds offsets to 16 bits (the reference gets the
#: same bound from its 16-bit hash-table offset column, MatchFinder.scala:52).
BLOCK_SIZE = 1 << 16

#: Snappy's multiplicative hash constant (format-neutral but proven; the
#: reference RTL uses the identical constant, HashTable.scala:53).
HASH_MUL = 0x1E35A7BD

#: Minimum match length the encoder will emit as a copy.
MIN_MATCH = 4

#: Maximum length of a single copy element.
MAX_COPY_LEN = 64

#: Element type tags (low 2 bits of the tag byte).
TAG_LITERAL = 0b00
TAG_COPY1 = 0b01
TAG_COPY2 = 0b10
TAG_COPY4 = 0b11

#: Maximum literal length encodable purely in the tag byte.
MAX_INLINE_LITERAL = 60

#: Copy1 constraints.
COPY1_MAX_OFFSET = 1 << 11   # offset < 2048
COPY1_MIN_LEN = 4
COPY1_MAX_LEN = 11

#: Copy2 constraints.
COPY2_MAX_OFFSET = 1 << 16
COPY2_MAX_LEN = 64


# --- Varint -----------------------------------------------------------------

def varint_encode(value: int) -> bytes:
    """Little-endian base-128 varint (the stream's uncompressed-length preamble)."""
    if value < 0:
        raise ValueError("varint must be non-negative")
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def varint_decode(buf: bytes, pos: int = 0) -> tuple[int, int]:
    """Decode a varint starting at ``pos``; returns (value, next_pos)."""
    value = 0
    shift = 0
    for i in range(5):
        if pos >= len(buf):
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        if not b & 0x80:
            return value, pos
        shift += 7
    raise ValueError("varint too long (more than 5 bytes)")


def varint_size(value: int) -> int:
    """Encoded size of a varint in bytes."""
    size = 1
    while value >= 0x80:
        value >>= 7
        size += 1
    return size


# --- Tag/element math (scalar; the jnp kernels re-derive these same rules
# --- vectorized, and tests assert both agree) --------------------------------

def literal_header(length: int) -> bytes:
    """Header bytes for a literal run of ``length`` bytes (payload excluded)."""
    if length <= 0:
        raise ValueError("literal length must be positive")
    n = length - 1
    if n < MAX_INLINE_LITERAL:
        return bytes([n << 2])
    if n < (1 << 8):
        return bytes([60 << 2, n & 0xFF])
    if n < (1 << 16):
        return bytes([61 << 2, n & 0xFF, (n >> 8) & 0xFF])
    if n < (1 << 24):
        return bytes([62 << 2, n & 0xFF, (n >> 8) & 0xFF, (n >> 16) & 0xFF])
    return bytes([
        63 << 2, n & 0xFF, (n >> 8) & 0xFF, (n >> 16) & 0xFF, (n >> 24) & 0xFF
    ])


def copy_element(offset: int, length: int) -> bytes:
    """Encode one copy element (offset back-reference of ``length`` bytes).

    Picks the smallest valid tag form, mirroring the rules the reference
    implements in CopyStreamFormer (CopyCompress.scala:236-260) but including
    the copy4 form it also supports.
    """
    if not 1 <= length <= MAX_COPY_LEN:
        raise ValueError(f"copy length {length} out of range")
    if offset < 1:
        raise ValueError("copy offset must be >= 1")
    if COPY1_MIN_LEN <= length <= COPY1_MAX_LEN and offset < COPY1_MAX_OFFSET:
        tag = TAG_COPY1 | ((length - 4) << 2) | ((offset >> 8) << 5)
        return bytes([tag, offset & 0xFF])
    if offset < COPY2_MAX_OFFSET:
        tag = TAG_COPY2 | ((length - 1) << 2)
        return bytes([tag, offset & 0xFF, (offset >> 8) & 0xFF])
    tag = TAG_COPY4 | ((length - 1) << 2)
    return bytes([
        tag, offset & 0xFF, (offset >> 8) & 0xFF,
        (offset >> 16) & 0xFF, (offset >> 24) & 0xFF,
    ])


def copy_fragment_lengths(total: int) -> list[int]:
    """Split a match of ``total`` bytes into per-element copy lengths.

    Emits 64-byte elements while >= 68 remain, then a 60-byte element if the
    remainder still exceeds one element, so the final element is always >= 4
    bytes (software Snappy's splitting rule; the RTL instead chains plain
    64-byte copies, CopyCompress.scala:80,143, which can strand a 1-3 byte
    tail — a ratio bug we do not reproduce).
    """
    if total < MIN_MATCH:
        raise ValueError("match shorter than MIN_MATCH")
    out = []
    while total >= MAX_COPY_LEN + MIN_MATCH:
        out.append(MAX_COPY_LEN)
        total -= MAX_COPY_LEN
    if total > MAX_COPY_LEN:
        out.append(60)
        total -= 60
    out.append(total)
    return out


def max_compressed_size(n: int) -> int:
    """Worst-case compressed size for ``n`` input bytes (preamble included).

    Worst case is incompressible data: one literal element per 64 KB block
    plus the varint preamble. 32 + n + n/6 is the classic safe bound.
    """
    return 32 + n + n // 6


def snappy_hash(u32: int, shift: int) -> int:
    """Snappy's multiplicative hash of a 4-byte little-endian word."""
    return ((u32 * HASH_MUL) & 0xFFFFFFFF) >> shift


def hash_table_bits(block_len: int, max_bits: int = 14) -> int:
    """Hash table size (log2) used by software Snappy for a block length."""
    bits = 8
    while (1 << bits) < block_len and bits < max_bits:
        bits += 1
    return bits
