"""Unit tests for the parallel-scan machinery (ops/scan.py).

CopyCompressSpec-style (CopyCompressSpec.scala:36-130): golden results
recomputed independently (a plain sequential pointer chase in numpy),
randomized over jump distributions including the adversarial shapes the
decode parse sees (giant literal jumps, all-ones, max-copy runs).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from tpu_snappy import format as fmt, reference_codec as ref
from tpu_snappy.ops import scan


def _golden_committed(jump: np.ndarray) -> np.ndarray:
    out = np.zeros(len(jump), bool)
    i = 0
    while i < len(jump):
        out[i] = True
        i += max(1, int(jump[i]))
    return out


def _cases(rng, n):
    yield np.ones(n, np.int32)                                   # all literals
    yield np.full(n, 64, np.int32)                               # max copies
    yield rng.integers(1, 65, n).astype(np.int32)                # bounded mix
    j = rng.integers(1, 6, n).astype(np.int32)                   # small + giant
    j[rng.choice(n, 20, replace=False)] = rng.integers(1000, n, 20)
    yield j
    j = np.ones(n, np.int32)                                     # one huge jump
    j[0] = n - 1
    yield j


@pytest.mark.parametrize("n", [scan.S * 4 * 17, 68 * 1024])
def test_commit_general_matches_sequential_chase(n):
    rng = np.random.default_rng(n)
    for jump in _cases(rng, n):
        got = np.asarray(scan.commit_general(jnp.asarray(jump)))
        assert (got == _golden_committed(jump)).all()


def test_commit_bounded_matches_chase():
    rng = np.random.default_rng(3)
    n = 1 << 16
    jump = rng.integers(1, 65, n).astype(np.int32)
    got = np.asarray(scan.commit_bounded(jnp.asarray(jump)))
    assert (got == _golden_committed(jump)).all()


def test_gather_s_matches_numpy_loop():
    # The segment-local gather is exact for every int32 value, including
    # the decode parse's exit states (~64K, far above 2^11), with and
    # without batch dims.
    rng = np.random.default_rng(17)
    for shape in ((5, scan.S), (3, 17, scan.S)):
        maps = rng.integers(0, 70000, shape).astype(np.int32)
        maps.flat[0] = 65535
        idx = rng.integers(0, scan.S, shape).astype(np.int32)
        got = np.asarray(scan.gather_s(jnp.asarray(maps), jnp.asarray(idx)))
        want = np.empty_like(maps)
        for pos in np.ndindex(shape):
            want[pos] = maps[pos[:-1] + (idx[pos],)]
        assert (got == want).all()


def test_segment_exit_maps_match_numpy_loop():
    # Exit map of every segment and entry state, against a plain chase;
    # literal-run jumps push exit states well past 2^11.
    rng = np.random.default_rng(23)
    n = scan.S * 64
    jump = rng.integers(1, 6, n).astype(np.int32)
    big = rng.random(n) < 0.03
    jump[big] = rng.integers(2048, 65536, big.sum())
    got = np.asarray(scan.segment_exit_maps(jnp.asarray(jump)))
    want = np.empty((n // scan.S, scan.S), np.int64)
    for g in range(n // scan.S):
        for d in range(scan.S):
            p = d
            while p < scan.S:
                p += int(jump[g * scan.S + p])
            want[g, d] = p - scan.S
    assert want.max() > 1 << 11
    assert (got == want).all()


def _walk(elems: bytes):
    """Element starts and (is_literal, output length) of a raw element
    stream — the reference codec's parse, recovered by a plain walk."""
    out, ip = [], 0
    while ip < len(elems):
        tag = elems[ip]
        kind = tag & 3
        if kind == 0:
            code = tag >> 2
            extra = max(code - 59, 0)
            ln = (code if extra == 0 else int.from_bytes(
                elems[ip + 1: ip + 1 + extra], "little")) + 1
            out.append((ip, True, ln))
            ip += 1 + extra + ln
        else:
            ln = ((tag >> 2) & 7) + 4 if kind == 1 else (tag >> 2) + 1
            out.append((ip, False, ln))
            ip += 2 if kind == 1 else 3 if kind == 2 else 5
    return out


def _ref_streams():
    from tpu_snappy.utils import corpus
    rng = np.random.default_rng(29)
    for data in (corpus.synth("text", 60000, 24),
                 b"ab" * 20000 + corpus.synth("text", 3000, 25),
                 rng.integers(0, 256, 30000, dtype=np.uint8).tobytes()):
        comp = ref.compress(data)
        _total, start = fmt.varint_decode(comp)
        yield data, comp[start:]


def test_commit_general_matches_reference_parse():
    # The decode parse: speculative per-byte element sizes, then the tag
    # chain from commit_general, must land on exactly the element starts
    # of the reference encoder's streams.
    from tpu_snappy.ops import decode as D
    for _data, elems in _ref_streams():
        w = -(-len(elems) // 8192) * 8192
        c = np.zeros(w, np.uint8)
        c[: len(elems)] = np.frombuffer(elems, np.uint8)
        size = D._elem_fields(jnp.asarray(c))[0]
        tags = np.asarray(scan.commit_general(jnp.clip(size, 1, None)))
        tags = tags & (np.arange(w) < len(elems))
        want = np.zeros(w, bool)
        want[[ip for ip, _lit, _ln in _walk(elems)]] = True
        assert (tags == want).all()


def test_commit_bounded_matches_reference_parse():
    # The encode commit: positions that start a copy jump by its length,
    # literal bytes by 1, and positions inside a copy carry arbitrary
    # jumps that the scan must step over. commit_bounded must commit
    # exactly the reference parse's literal bytes and copy starts.
    rng = np.random.default_rng(31)
    for data, elems in _ref_streams():
        n = 1 << 16
        jump = rng.integers(1, 65, n).astype(np.int32)
        want = np.ones(n, bool)
        op = 0
        for _ip, lit, ln in _walk(elems):
            if lit:
                jump[op: op + ln] = 1
            else:
                jump[op] = ln
                want[op + 1: op + ln] = False
            op += ln
        assert op == len(data)
        jump[op:] = 1
        got = np.asarray(scan.commit_bounded(jnp.asarray(jump)))
        assert (got == want).all()
