"""Property-based round-trip fuzzing (hypothesis).

The CopyCompressSpec model (randomized cases, golden recomputed
independently) applied to the whole pipeline: arbitrary byte structures
must round-trip through the JAX codec with both independent golden
decoders agreeing, and our decoder must accept golden-encoded streams.
"""

import numpy as np
import pytest

try:
    from hypothesis import HealthCheck, given, settings, strategies as st
    HAVE_HYP = True
except ImportError:  # pragma: no cover
    HAVE_HYP = False

from tpu_snappy import api, reference_codec as ref
from tpu_snappy.native import golden

pytestmark = pytest.mark.skipif(not HAVE_HYP, reason="hypothesis not installed")


def structured_bytes():
    """Mixes of random runs, repeats, and back-references — the structures
    that exercise literals, RLE, near/far copies, and chain breaks."""
    segment = st.one_of(
        st.binary(min_size=1, max_size=60),
        # period-p repetition
        st.tuples(st.binary(min_size=1, max_size=12),
                  st.integers(1, 400)).map(lambda t: t[0] * t[1]),
        # printable text-ish
        st.text(alphabet="abcdefgh THEthe.,", min_size=1, max_size=200)
        .map(lambda s: s.encode()),
    )
    return st.lists(segment, min_size=0, max_size=12).map(b"".join)


@settings(max_examples=40, deadline=None)
@given(structured_bytes())
def test_roundtrip_fuzz(data):
    comp = api.compress(data, small_fastpath=False)
    assert golden.uncompress(comp) == data
    assert ref.decompress(comp) == data
    assert api.decompress(comp, small_fastpath=False) == data
    # and decode the independent encoder's stream
    assert api.decompress(golden.compress(data), small_fastpath=False) == data


@settings(max_examples=10, deadline=None)
@given(structured_bytes())
def test_roundtrip_fuzz_speed_presets(data):
    # The speed presets trade only ratio; correctness properties must hold
    # for arbitrary structures (incl. the stride-2 even-offset lattice).
    from tpu_snappy.config import TURBO_CONFIG, ULTRA_CONFIG
    for cfg in (TURBO_CONFIG, ULTRA_CONFIG):
        comp = api.compress(data, cfg, small_fastpath=False)
        assert golden.uncompress(comp) == data
        assert ref.decompress(comp) == data
        assert api.decompress(comp, small_fastpath=False) == data


@settings(max_examples=8, deadline=None)
@given(structured_bytes())
def test_roundtrip_fuzz_interval_table(data):
    # cfg.table="intervals" (tested knob): the (lo, hi) ladder slot pair
    # must never let an unverified offset through — correctness holds for
    # arbitrary structures, only tie-breaks may differ from points.
    import dataclasses
    from tpu_snappy.config import DEFAULT_CONFIG
    cfg = dataclasses.replace(DEFAULT_CONFIG, candidates=12, probes=14,
                              table="intervals")
    comp = api.compress(data, cfg, small_fastpath=False)
    assert golden.uncompress(comp) == data
    assert ref.decompress(comp) == data
    assert api.decompress(comp, small_fastpath=False) == data


@settings(max_examples=15, deadline=None)
@given(st.integers(0, 2**32 - 1), st.integers(100, 4000))
def test_roundtrip_random_seeds(seed, n):
    rng = np.random.default_rng(seed)
    # byte histogram skewed toward a small alphabet => dense matches
    alphabet = rng.integers(0, 256, 8, dtype=np.uint8)
    data = alphabet[rng.integers(0, 8, n)].tobytes()
    comp = api.compress(data, small_fastpath=False)
    assert golden.uncompress(comp) == data
    assert len(comp) <= len(data) + 8


@settings(max_examples=6, deadline=None)
@given(structured_bytes())
def test_sidecar_framed_fuzz(data):
    """Framed sidecar property: for arbitrary structures, always-emitted
    sidecars must decode bit-exactly through the fast path, through the
    sidecar-ignoring path, and through the independent C++ framed golden."""
    from tpu_snappy import framing
    fr = framing.compress(data, sidecar="always")
    assert framing.decompress(fr) == data
    assert framing.decompress(fr, use_sidecar=False) == data
    assert golden.uncompress_framed(fr, max_out=len(data) + 16) == data


@settings(max_examples=12, deadline=None)
@given(structured_bytes())
def test_block_placement_exact_fuzz(data):
    # The placement sort puts every output byte at its rank: the first
    # out_len bytes are a valid element stream and every byte past it is
    # zero (sentinel lanes never leak), for arbitrary structures.
    import jax.numpy as jnp
    from tpu_snappy import format as fmt
    from tpu_snappy.ops import encode as E
    n = min(len(data), fmt.BLOCK_SIZE)
    buf = np.zeros(fmt.BLOCK_SIZE, np.uint8)
    buf[:n] = np.frombuffer(data[:n], np.uint8)
    out, tot = E.encode_blocks(jnp.asarray(buf)[None],
                               jnp.full((1,), n, jnp.int32))
    out, tot = np.asarray(out)[0], int(tot[0])
    assert not out[tot:].any()
    stream = fmt.varint_encode(n) + out[:tot].tobytes()
    assert golden.uncompress(stream) == data[:n]


@settings(max_examples=12, deadline=None)
@given(structured_bytes())
def test_resolve_modes_roundtrip_fuzz(data):
    # Every resolve strategy (incl. the hybrid default's sparse chase)
    # must decode arbitrary structures bit-exactly.
    import jax.numpy as jnp
    from tpu_snappy import format as fmt
    from tpu_snappy.ops import decode as D
    comp = ref.compress(data)
    total, start = fmt.varint_decode(comp)
    if total == 0:
        return
    frags, clens, ulens = D.fragment_table(comp, start, total)
    for resolve in ("plain", "hybrid"):
        out, ok = D.decode_fragments_jit(
            jnp.asarray(frags), jnp.asarray(clens), jnp.asarray(ulens),
            resolve=resolve)
        assert np.asarray(ok).all()
        got = b"".join(np.asarray(out[i, :ulens[i]]).tobytes()
                       for i in range(len(ulens)))
        assert got == data, resolve


@pytest.mark.nightly
@settings(max_examples=500, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(structured_bytes())
def test_roundtrip_fuzz_nightly(data):
    """Deep differential-fuzz budget (golden-independence hardening):
    run with `pytest -m nightly` (deselected by default via -m "not
    nightly" in pytest.ini addopts). 500 structured examples through
    every decoder pairing, both encoders."""
    comp = api.compress(data, small_fastpath=False)
    assert golden.uncompress(comp) == data
    assert ref.decompress(comp) == data
    assert api.decompress(comp, small_fastpath=False) == data
    gstream = golden.compress(data)
    assert api.decompress(gstream, small_fastpath=False) == data
    assert ref.decompress(gstream) == data
