"""Golden-codec round-trip tests over synthetic and reference corpus data."""

import random

import pytest

from tpu_snappy import format as fmt
from tpu_snappy import reference_codec as ref
from tpu_snappy.native import golden
from tpu_snappy.utils import corpus


def roundtrip(data: bytes, **kw) -> bytes:
    comp = ref.compress(data, **kw)
    assert ref.decompress(comp) == data
    return comp


@pytest.mark.parametrize("data", [
    b"",
    b"a",
    b"abc",
    b"abcd",
    b"aaaaaaaa",
    b"a" * 100,
    b"abcabcabcabcabcabcabc",
    b"The quick brown fox jumps over the lazy dog. " * 10,
    bytes(range(256)) * 4,
])
def test_roundtrip_small(data):
    roundtrip(data)


def test_preamble_and_shape():
    comp = ref.compress(b"aaaaaaaaaaaaaaaaaaaaaaaa")
    n, pos = fmt.varint_decode(comp)
    assert n == 24
    # 'a' x24: literal 'a...' then an overlapping copy — must be small.
    assert len(comp) < 12


def test_incompressible_is_single_literal():
    data = corpus.synth("random", 5000)
    comp = roundtrip(data)
    # preamble + literal header + payload
    n, pos = fmt.varint_decode(comp)
    assert n == 5000
    tag = comp[pos]
    assert tag & 3 == fmt.TAG_LITERAL
    assert len(comp) <= 5000 + 5


def test_repeating_compresses_hard():
    data = corpus.synth("repeating", 50000)
    comp = roundtrip(data)
    assert len(comp) < 2500  # ratio > 20, like the reference's repeat-50000


def test_multi_block_boundary():
    # Spans two 64 KB fragments; matches must not cross the boundary.
    rng = random.Random(7)
    base = bytes(rng.randrange(65, 91) for _ in range(1000))
    data = (base * 80)[:fmt.BLOCK_SIZE + 5000]
    roundtrip(data)


def test_random_fuzz_roundtrip():
    rng = random.Random(1234)
    for trial in range(20):
        n = rng.randrange(0, 3000)
        # Mix of compressible and random segments.
        parts = []
        while sum(map(len, parts)) < n:
            if rng.random() < 0.5:
                parts.append(bytes(rng.randrange(256) for _ in range(rng.randrange(1, 50))))
            else:
                parts.append(bytes([rng.randrange(256)]) * rng.randrange(1, 200))
        data = b"".join(parts)[:n]
        roundtrip(data)
        roundtrip(data, dense_table=False)


@pytest.mark.parametrize("name", ["text-4600", "text-5000", "repeating-5000", "random-5000", "lowent-20000"])
def test_corpus_roundtrip(name):
    kind, n = name.split("-")
    data = (corpus.synth(kind, int(n), 4444) if kind != "lowent"
            else corpus.synth("text", 2000, 90) * 10)
    comp = roundtrip(data)
    assert len(comp) <= fmt.max_compressed_size(len(data))


def test_ratio_sanity_vs_reference_hw():
    # The RTL produced 2351 B for repeating-50000 (hw_results.csv:37) and
    # 32683 B for real-50000 (hw_results.csv:25), 1.57x software Snappy's
    # size. Our format-complete greedy encoder must beat the RTL's
    # degraded ratio: on 50 KB of seeded text, under the same 1.57x of
    # the golden, and on repeating-50000, at most the RTL's bytes.
    text = corpus.synth("text", 50000, 91)
    assert len(roundtrip(text)) < 1.5716 * len(golden.compress(text))
    rep = corpus.synth("repeating", 50000)
    assert len(roundtrip(rep)) <= 2351
