"""Cross-validation: Python golden codec vs clean-room C++ golden codec.

Two independent implementations agreeing on round-trips across the corpus is
the correctness anchor for everything above (the role the reference assigns
to tests/swcompression.cc + google/snappy)."""

import random
import subprocess

import pytest

from tpu_snappy import reference_codec as ref
from tpu_snappy.native import golden
from tpu_snappy.utils import corpus


@pytest.fixture(scope="module", autouse=True)
def built():
    golden.swcompression_path()


@pytest.mark.parametrize("data", [
    b"", b"a", b"abcd", b"a" * 100,
    b"The quick brown fox jumps over the lazy dog. " * 20,
    bytes(range(256)) * 300,  # crosses the 64 KB block boundary
])
def test_cross_roundtrip(data):
    # C++ decodes Python-compressed, Python decodes C++-compressed.
    assert golden.uncompress(ref.compress(data)) == data
    for mode in (golden.MODE_BASELINE, golden.MODE_DENSE):
        assert ref.decompress(golden.compress(data, mode)) == data


def test_cross_fuzz():
    rng = random.Random(99)
    for _ in range(30):
        n = rng.randrange(0, 5000)
        parts = []
        while sum(map(len, parts)) < n:
            if rng.random() < 0.5:
                parts.append(bytes(rng.randrange(256) for _ in range(rng.randrange(1, 40))))
            else:
                seg = bytes(rng.randrange(256) for _ in range(rng.randrange(1, 8)))
                parts.append(seg * rng.randrange(1, 60))
        data = b"".join(parts)[:n]
        assert golden.uncompress(ref.compress(data)) == data
        assert ref.decompress(golden.compress(data)) == data


@pytest.mark.parametrize("name", [
    "text-4600", "random-100000", "text-30000",
    "text-50000", "repeating-50000", "random-50000",
])
def test_corpus_cross(name):
    kind, n = name.split("-")
    data = corpus.synth(kind, int(n), 4444)
    comp_py = ref.compress(data)
    assert golden.uncompress(comp_py) == data
    comp_cc = golden.compress(data)
    assert ref.decompress(comp_cc) == data
    # Dense parse should not lose much vs baseline (sanity on ratio).
    assert len(comp_py) <= len(comp_cc) * 1.03 + 16


def test_cli_roundtrip(tmp_path):
    cli = golden.swcompression_path()
    sample = tmp_path / "text.txt"
    sample.write_bytes(corpus.synth("text", 4602, 80))
    out = subprocess.run(
        [str(cli), "roundtrip", str(sample)],
        capture_output=True, text=True, check=True,
    )
    length, clen = out.stdout.strip().split(";")
    assert int(length) == 4602
    assert int(clen) < 4602


def test_golden_rejects_garbage():
    with pytest.raises(ValueError):
        golden.uncompress(b"\x10\xff\xff\xff")
    with pytest.raises(ValueError):
        golden.uncompress(b"")
