"""Full benchmark-corpus round-trip sweep — the CompressionAcceleratorSpec
tier (Test.scala:56-79 iterates every benchmark-data file through the whole
pipeline), with the bit-exactness assertions the reference lacked."""

from tpu_snappy import api
from tpu_snappy.native import golden, realsnappy
from tpu_snappy.utils import corpus


def test_all_36_corpus_files_roundtrip():
    # The reference's 3 types x 12 sizes, regenerated by corpus.synth
    # ("text" stands in for "real" when the reference corpus is absent).
    real = realsnappy.available()
    total_ours = total_gold = total_real = 0
    kinds = ("random", "real" if corpus.has_reference_corpus() else "text",
             "repeating")
    for name, data in ((f"{k}-{n}", corpus.synth(k, n, 4444))
                       for k in kinds for n in corpus.SIZES):
        comp = api.compress(data, small_fastpath=False)
        assert golden.uncompress(comp) == data, name
        assert api.decompress(comp, small_fastpath=False) == data, name
        total_ours += len(comp)
        total_gold += len(golden.compress(data))
        if real:
            # BASELINE.md's literal bar: bit-for-bit decompressible by
            # ACTUAL google/snappy (system libsnappy, v1.1.9) — and the
            # foreign direction decodes through our host golden.
            assert realsnappy.uncompress(comp) == data, name
            c_real = realsnappy.compress(data)
            total_real += len(c_real)
            assert golden.uncompress(c_real) == data, name
    # Aggregate ratio across the whole sweep: strictly at-or-below software
    # Snappy (per-file wins/losses are covered elsewhere) — both the
    # clean-room golden's and, when present, the real library's output.
    assert total_ours <= total_gold
    if real:
        assert total_ours <= total_real


def test_data_dir_files_roundtrip():
    # Seeded stand-ins for the reference's data/ files: short text,
    # random ASCII, a multi-block text sample and a low-entropy sample.
    for name, data in (("text", corpus.synth("text", 4600, 70)),
                       ("randomASCII", corpus.synth("random", 100_000)),
                       ("text-multi", corpus.synth("text", 300_000, 71)),
                       ("lowent", corpus.synth("text", 9000, 72)[:900] * 40)):
        comp = api.compress(data, small_fastpath=False)
        assert golden.uncompress(comp) == data, name
