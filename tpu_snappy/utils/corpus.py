"""Benchmark corpus access and synthesis.

Plays the role of the reference's DataGenerator.scala (corpus synthesis:
random/real/repeating at 12 sizes, seeded random files) plus the loose corpus
files under data/ and benchmark/benchmark-data/. The reference corpus is
read from the directory TPU_SNAPPY_REFERENCE names, when it is set; every
test and run that must work without it uses synth(), including the seeded
"text" generator.
"""

from __future__ import annotations

import os
import pathlib

import numpy as np


REFERENCE_ROOT = pathlib.Path(os.environ.get("TPU_SNAPPY_REFERENCE", "")
                              or "/nonexistent-reference-corpus")
BENCH_DATA = REFERENCE_ROOT / "benchmark" / "benchmark-data"
DATA = REFERENCE_ROOT / "data"

#: The 12 sizes × 3 types of DataGenerator.scala:24-72.
SIZES = [10, 20, 50, 100, 200, 500, 1000, 2000, 5000, 10000, 20000, 50000]
TYPES = ["random", "real", "repeating"]


def has_reference_corpus() -> bool:
    return BENCH_DATA.is_dir() and DATA.is_dir()


def load(name: str) -> bytes:
    """Load a corpus file by bare name from either corpus directory."""
    for root in (BENCH_DATA, DATA):
        p = root / name
        if p.is_file():
            return p.read_bytes()
    raise FileNotFoundError(name)


def corpus_files() -> list[str]:
    """Benchmark sweep files, mirroring Test.scala:61-66's selection
    (no '_'-suffixed bank splits, size < 5e6)."""
    if not BENCH_DATA.is_dir():
        return []
    out = []
    for p in sorted(BENCH_DATA.iterdir()):
        if "_" in p.name or p.stat().st_size >= 5_000_000:
            continue
        typ = p.name.partition("-")[0]
        if typ not in TYPES or p.stat().st_size == 0:
            continue  # stray/empty fixtures (e.g. the empty alignerTestData)
        out.append(p.name)
    return out


class _JavaRandom:
    """java.util.Random's 48-bit LCG — RandomFileGenerator uses
    `new Random(4444)` (DataGenerator.scala:13), and reproducing it
    bit-exactly lets synth() REGENERATE data/randomASCII.txt rather than
    approximate it (tests assert equality against the mounted file)."""

    _MULT = 0x5DEECE66D
    _MASK = (1 << 48) - 1

    def __init__(self, seed: int):
        self.seed = (seed ^ self._MULT) & self._MASK

    def _next(self, bits: int) -> int:
        self.seed = (self.seed * self._MULT + 0xB) & self._MASK
        return self.seed >> (48 - bits)

    def next_int(self, bound: int) -> int:
        if bound & (bound - 1) == 0:  # power of two
            return (bound * self._next(31)) >> 31
        while True:
            bits = self._next(31)
            val = bits % bound
            if bits - val + (bound - 1) < (1 << 31):  # no int32 overflow
                return val


#: Function words at the head of the text vocabulary (the most frequent
#: ranks of English); the rest of the vocabulary is pseudo-words built
#: from the syllables below by a generator with a fixed seed, so the
#: vocabulary is the same in every run and only the word sequence follows
#: the caller's seed.
_FUNCTION_WORDS = (
    "the of and to a in is it you that he was for on are with as his they "
    "be at one have this from or had by not word but what some we can out "
    "other were all there when up use your how said an each she which do "
    "their time if will way about many then them write would like so these "
    "her long make thing see him two has look more day could go come did "
    "number sound no most people my over know water than call first who "
    "may down side been now find any new work part take get place made "
    "live where after back little only round man year came show every good "
    "me give our under name very through just form sentence great think "
    "say help low line differ turn cause much mean before move right boy "
    "old too same tell does set three want air well also play small end "
    "put home read hand port large spell add even land here must big high "
    "such follow act why ask men change went light kind off need house "
    "picture try us again animal point mother world near build self earth "
    "father head stand own page should country found answer school grow "
    "study still learn plant cover food sun four between state keep eye "
    "never last let thought city tree cross farm hard start might story saw "
    "far sea draw left late run while press close night real life few north"
).split()
_SYLLABLES = (
    "ba be bi bo bu ca ce ci co cu da de di do du fa fe fi fo ga ge go ha "
    "he hi ho ka ke ki ko la le li lo lu ma me mi mo mu na ne ni no nu pa "
    "pe pi po ra re ri ro ru sa se si so su ta te ti to tu va ve vi vo wa "
    "we wi ya yo za an en in on un ar er ir or ur al el il ol st str th "
    "ch sh tion ment ness ing ed er ly est ous ive able"
).split()
_TEXT_VOCAB = 8192
_ZIPF_S = 1.1


_TEXT_PHRASES = 4096
_PHRASE_SHARE = 0.3


def _text_vocab() -> list[bytes]:
    """The fixed vocabulary: the function words, then pseudo-words, then
    _TEXT_PHRASES phrases of 2-5 vocabulary words (collocations, which
    give natural text its multi-word repeats)."""
    rng = np.random.default_rng(0x5EED)
    words, seen = [], set()
    for w in _FUNCTION_WORDS:
        if w not in seen:
            seen.add(w)
            words.append(w)
    while len(words) < _TEXT_VOCAB:
        n = int(rng.integers(1, 5))
        w = "".join(_SYLLABLES[int(i)]
                    for i in rng.integers(0, len(_SYLLABLES), n))
        if w not in seen:
            seen.add(w)
            words.append(w)
    cdf = _zipf_cdf(len(words))
    phrases = []
    for n in rng.integers(2, 6, _TEXT_PHRASES):
        ids = np.searchsorted(cdf, rng.random(int(n)))
        phrases.append(" ".join(words[int(i)] for i in ids))
    return [w.encode() for w in words + phrases]


def _zipf_cdf(n: int) -> np.ndarray:
    cdf = np.cumsum(1.0 / np.arange(1, n + 1) ** _ZIPF_S)
    return cdf / cdf[-1]


def _synth_text(size: int, seed: int) -> bytes:
    """Seeded English-like text: Zipf(s=_ZIPF_S) ranks over a fixed
    vocabulary of words and phrases, sentences with a capitalized first
    token, commas, sentence-final punctuation, and line and paragraph
    breaks. Built in vectorized chunks (64 MiB takes seconds)."""
    vocab = _text_vocab()
    v = len(vocab)
    nw = _TEXT_VOCAB
    caps = [w[:1].upper() + w[1:] for w in vocab]
    seps = [b" ", b", ", b". ", b".\n", b".\n\n", b"? ", b"! ", b"; "]
    table = vocab + caps + seps
    tlen = np.array([len(t) for t in table], np.int64)
    toff = np.concatenate([[0], np.cumsum(tlen)[:-1]])
    tbuf = np.frombuffer(b"".join(table), np.uint8)
    wcdf = _zipf_cdf(nw)
    pcdf = _zipf_cdf(v - nw)
    rng = np.random.default_rng(seed)
    out, have = [], 0
    while have < size:
        k = 1 << 20  # tokens per chunk
        words = np.searchsorted(wcdf, rng.random(k))
        phrases = nw + np.searchsorted(pcdf, rng.random(k))
        toks = np.where(rng.random(k) < _PHRASE_SHARE, phrases, words)
        # Each token ends its sentence with probability 1/12; the token
        # after a sentence end is capitalized.
        end = rng.random(k) < 1 / 12
        start = np.concatenate([[True], end[:-1]])
        sep_end = rng.choice([2, 3, 4, 5, 6], size=k,
                             p=[0.72, 0.15, 0.05, 0.05, 0.03])
        sep_mid = rng.choice([0, 1, 7], size=k, p=[0.9, 0.08, 0.02])
        tok = np.empty(2 * k, np.int64)
        tok[0::2] = np.where(start, toks + v, toks)
        tok[1::2] = 2 * v + np.where(end, sep_end, sep_mid)
        lens = tlen[tok]
        starts = np.cumsum(lens) - lens
        total = int(lens.sum())
        idx = np.repeat(toff[tok] - starts, lens) + np.arange(total)
        chunk = tbuf[idx].tobytes()
        out.append(chunk)
        have += len(chunk)
    return b"".join(out)[:size]


def synth(kind: str, size: int, seed: int = 4444) -> bytes:
    """Synthesize corpus data. The first three kinds are byte-identical to
    DataGenerator.scala:

    random    — `new Random(4444).nextInt(93) + 32` ASCII stream
                (RandomFileGenerator; regenerates data/randomASCII.txt and
                every random-<n>.txt prefix exactly)
    repeating — all 'a' (DataGenerator's repeatingWriter)
    real      — prefix of data/all-mtg-cards.txt (DataGenerator's
                realWriter; a repeating+random stand-in only when the
                corpus is not present)
    text      — seeded English-like text (_synth_text); the in-repo
                stand-in for natural-language corpora
    """
    if kind == "text":
        return _synth_text(size, seed)
    if kind == "random":
        rand = _JavaRandom(seed)
        return bytes(rand.next_int(93) + 32 for _ in range(size))
    if kind == "repeating":
        return b"a" * size
    if kind == "real":
        try:
            data = load("all-mtg-cards.txt")
        except FileNotFoundError:
            data = synth("repeating", size * 4, seed) + synth("random", size, seed)
            return data[:size]
        # DataGenerator reads the corpus as a UTF-8 STRING and writes
        # `allMTGCards(i).toByte.toChar` — i.e. the i-th CHARACTER's
        # codepoint truncated to a byte (em-dash U+2014 -> 0x14). Mirror
        # that quirk exactly: real-<n>.txt files are char-prefixes, not
        # byte-prefixes, of all-mtg-cards.txt.
        chars = data.decode("utf-8")[:size]
        return bytes(ord(c) & 0xFF for c in chars)
    raise ValueError(kind)
