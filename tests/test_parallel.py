"""Multi-device DP sharding tests on the virtual 8-device CPU mesh
(the ScratchpadTest fake-SoC analogue: real logic, fake fabric)."""

import io

import jax
import numpy as np
import pytest

from tpu_snappy import format as fmt
from tpu_snappy.config import DEFAULT_CONFIG
from tpu_snappy.native import golden
from tpu_snappy.parallel import mesh as meshlib, shard, streaming
from tpu_snappy.utils import corpus


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return meshlib.make_mesh(8)


def test_mesh_shape(mesh8):
    assert mesh8.devices.size == 8
    assert mesh8.axis_names == ("dp",)


def test_encode_dp_matches_single_device(mesh8):
    data = corpus.synth("text", 10 * fmt.BLOCK_SIZE + 1234, 50)
    comp = shard.encode_dp(data, mesh8)
    assert golden.uncompress(comp) == data
    # Sharded run must produce the identical stream to the 1-device run
    # (per-block determinism — manifests just reorder the same bytes).
    mesh1 = meshlib.make_mesh(1)
    assert comp == shard.encode_dp(data, mesh1)


def test_decode_dp_roundtrip(mesh8):
    data = corpus.synth("text", 9 * fmt.BLOCK_SIZE + 77, 51)
    comp = shard.encode_dp(data, mesh8)
    assert shard.decode_dp(comp, mesh8) == data
    # Cross: decode a C++-golden stream sharded.
    assert shard.decode_dp(golden.compress(data), mesh8) == data


def test_encode_dp_small_input(mesh8):
    # Fewer blocks than devices: padding blocks must vanish from the output.
    data = b"hello hello hello hello " * 10
    comp = shard.encode_dp(data, mesh8)
    assert golden.uncompress(comp) == data


def test_streaming_compress(mesh8):
    data = corpus.synth("text", 20 * fmt.BLOCK_SIZE + 5, 52)
    src, dst = io.BytesIO(data), io.BytesIO()
    stats = streaming.compress_stream(src, dst, len(data), mesh8,
                                      blocks_per_wave=8)
    comp = dst.getvalue()
    assert stats.in_bytes == len(data)
    assert stats.out_bytes == len(comp)
    assert stats.waves == 3  # 20.0001 blocks in waves of 8
    assert golden.uncompress(comp) == data
    # Stream output identical to one-shot output (wave boundaries invisible).
    assert comp == shard.encode_dp(data, mesh8)


_COLLECTIVES = ("all-gather", "all-reduce", "collective-permute",
                "all-to-all", "reduce-scatter", "collective-broadcast")


@pytest.mark.parametrize("program", ["encode", "encode_compact", "decode",
                                     "decode_sidecar"])
def test_sharded_programs_hold_no_collective(mesh8, program):
    # Every sharded program keeps its outputs on the dp axis. A program
    # with a collective needs all devices to enter it together, and the
    # streaming drain and the server dispatch such programs from more than
    # one thread, which can enter two of them in different orders on
    # different devices.
    from jax.sharding import PartitionSpec as P

    def arg(shape, dtype, spec):
        return jax.ShapeDtypeStruct(
            shape, dtype, sharding=jax.sharding.NamedSharding(mesh8, spec))

    rows, wave = 16, 2
    blocks = arg((rows, fmt.BLOCK_SIZE), np.uint8, P("dp", None))
    scal = arg((rows,), np.int32, P("dp"))
    fn, args = {
        "encode": (shard._encode_fn(mesh8, DEFAULT_CONFIG, wave),
                   (blocks, scal)),
        "encode_compact": (
            shard._encode_fn_compact(mesh8, DEFAULT_CONFIG, wave),
            (blocks, scal)),
        "decode": (shard._decode_fn(mesh8, "dp", wave),
                   (arg((rows, 8192), np.uint8, P("dp", None)), scal, scal)),
        "decode_sidecar": (
            shard._decode_sidecar_fn(mesh8, "dp", wave),
            (arg((rows, 8192), np.uint8, P("dp", None)),
             arg((rows, 256), np.int32, P("dp", None)),
             arg((rows, 256), np.int32, P("dp", None)), scal)),
    }[program]
    hlo = fn.lower(*args).compile().as_text()
    assert "num_partitions=8" in hlo
    found = [op for op in _COLLECTIVES if op + "(" in hlo
             or op + "-start(" in hlo]
    assert not found, f"{program}: collectives {found}"


def test_corpus_single_dispatch_matches_waves():
    # encode_corpus/decode_corpus (one lax.map program for many waves) must
    # produce bit-identical results to the per-wave dispatch entry points.
    import jax.numpy as jnp

    from tpu_snappy.ops import decode as ops_decode, encode as ops_encode

    data = corpus.synth("text", 6 * fmt.BLOCK_SIZE + 999, 53)
    arr, lengths, nblocks = shard.blocks_of(data, fmt.BLOCK_SIZE, 8)
    b, l = jnp.asarray(arr), jnp.asarray(lengths)
    out_w, len_w = ops_encode.encode_blocks(b, l)
    out_c, len_c = ops_encode.encode_corpus(b, l, wave=4)
    assert np.array_equal(np.asarray(len_w), np.asarray(len_c))
    assert np.array_equal(np.asarray(out_w), np.asarray(out_c))

    comp = fmt.varint_encode(len(data)) + b"".join(
        np.asarray(out_w)[i, : np.asarray(len_w)[i]].tobytes()
        for i in range(nblocks))
    total, start = fmt.varint_decode(comp)
    frags, clens, ulens = ops_decode.fragment_table(comp, start, total)
    pad = 8 - len(clens)
    frags = np.pad(frags, ((0, pad), (0, 0)))
    clens = np.pad(clens, (0, pad))
    ulens = np.pad(ulens, (0, pad))
    f, c, u = (jnp.asarray(frags), jnp.asarray(clens, jnp.int32),
               jnp.asarray(ulens, jnp.int32))
    dec_w, ok_w = ops_decode.decode_fragments_jit(f, c, u)
    dec_c, ok_c = ops_decode.decode_corpus(f, c, u, wave=4)
    assert np.array_equal(np.asarray(ok_w), np.asarray(ok_c))
    assert np.array_equal(np.asarray(dec_w), np.asarray(dec_c))


def test_multihost_entrypoints_single_process():
    # The multihost layer is host-count agnostic (jax.distributed just
    # widens jax.devices()); on one process it must behave exactly like
    # the local mesh paths — the TLTestRAM-style fake-fabric tier.
    import io
    from tpu_snappy.parallel import multihost
    from tpu_snappy.native import golden
    data = corpus.synth("text", 10 * fmt.BLOCK_SIZE + 99, 54)
    comp = multihost.compress_dp_global(data)
    assert golden.uncompress(comp) == data
    dst = io.BytesIO()
    stats = multihost.compress_multihost(
        io.BytesIO(data), dst, len(data), blocks_per_wave=8)
    assert golden.uncompress(dst.getvalue()) == data
    assert stats.out_bytes == len(dst.getvalue())
