"""Multi-device sharded codec tests on the 8-virtual-device CPU mesh.

The reference has no distributed backend (SURVEY.md §2.2); these tests pin
the one invariant that makes distribution free: sharded encode/decode is
bit-identical to the single-device path (and hence to the golden model),
because fill runs never cross block boundaries (tests.cpp:227-239) and
shard boundaries are block-aligned.
"""
import jax
import numpy as np
import pytest

from conftest import clustered_bitmap, random_bitmap
from wah_tpu import golden
from wah_tpu.constants import BLOCK_CHUNKS, BLOCK_INTS
from wah_tpu.golden import chunk_count
from wah_tpu.parallel import (
    ShardedCodec,
    decode_sharded,
    encode_sharded,
    gather_bitmap,
    gather_stream,
    make_mesh,
)


@pytest.fixture(scope="module")
def mesh():
    m = make_mesh()
    assert m.size == 8, "conftest should provide 8 virtual CPU devices"
    return m


def _roundtrip(mesh, data):
    codec = ShardedCodec(mesh)
    stream = codec.compress(data)
    ref = golden.encode(data)
    np.testing.assert_array_equal(stream, ref)
    out = codec.decompress(stream, out_ints=data.shape[0])
    np.testing.assert_array_equal(out, data)


def test_sharded_encode_matches_golden_random(mesh):
    data = random_bitmap(16 * BLOCK_INTS, density=1 / 16)
    _roundtrip(mesh, data)


def test_sharded_encode_matches_golden_clustered(mesh):
    data = clustered_bitmap(16 * BLOCK_INTS)
    _roundtrip(mesh, data)


def test_sharded_all_zeros(mesh):
    _roundtrip(mesh, np.zeros(8 * BLOCK_INTS, dtype=np.uint32))


def test_sharded_all_ones(mesh):
    _roundtrip(mesh, np.full(8 * BLOCK_INTS, 0xFFFFFFFF, dtype=np.uint32))


def test_sharded_non_block_multiple(mesh):
    data = random_bitmap(5 * BLOCK_INTS + 17, density=0.3, seed=7)
    _roundtrip(mesh, data)


def test_sharded_dense(mesh):
    data = random_bitmap(8 * BLOCK_INTS, density=0.5)
    _roundtrip(mesh, data)


def test_encode_sharded_totals_sum(mesh):
    data = random_bitmap(8 * BLOCK_INTS, density=1 / 64)
    ref = golden.encode(data)
    dev = jax.device_put(data)
    words, totals = encode_sharded(mesh, dev, np.int32(chunk_count(len(data))))
    assert int(np.asarray(totals).sum()) == len(ref)
    np.testing.assert_array_equal(gather_stream(words, totals), ref)


def test_decode_sharded_span_partition(mesh):
    """Each shard's output slice equals the corresponding golden slice."""
    data = clustered_bitmap(8 * BLOCK_INTS, seed=3)
    stream = golden.encode(data)
    cap = 8 * BLOCK_CHUNKS
    M = 1024
    padded = np.zeros(M, dtype=np.uint32)
    padded[: len(stream)] = stream
    ints, n_chunks = decode_sharded(
        mesh, jax.device_put(padded), np.int32(len(stream)), cap
    )
    n = int(np.asarray(n_chunks)[0])
    assert n == chunk_count(len(data))
    out = gather_bitmap(ints, (31 * n + 31) // 32)
    np.testing.assert_array_equal(out[: len(data)], data)


def test_sharded_jit_full_pipeline(mesh):
    """Encode -> global stitch -> decode as ONE jitted computation with no
    host round trips (this is the dryrun_multichip path)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from wah_tpu.parallel import stitch_global

    data = random_bitmap(8 * BLOCK_INTS, density=1 / 8, seed=11)
    nv = chunk_count(len(data))
    cap = 8 * BLOCK_CHUNKS

    @jax.jit
    def step(x):
        words, totals = encode_sharded(mesh, x, nv)
        stream, total, _ = stitch_global(mesh, words, totals)
        ints, n_chunks = decode_sharded(mesh, stream, total, cap)
        return stream, total, ints, n_chunks

    dev = jax.device_put(data, NamedSharding(mesh, P("blocks")))
    stream, total, ints, n_chunks = step(dev)
    ref = golden.encode(data)
    assert int(total) == len(ref)
    np.testing.assert_array_equal(np.asarray(stream)[: int(total)], ref)
    n = int(np.asarray(n_chunks)[0])
    out = gather_bitmap(ints, (31 * n + 31) // 32)
    np.testing.assert_array_equal(out[: len(data)], data)


def test_sharded_codec_roundtrip(mesh):
    data = clustered_bitmap(8 * BLOCK_INTS, seed=5)
    codec = ShardedCodec(mesh)
    stream = codec.compress(data)
    out = codec.decompress(stream, out_ints=len(data))
    np.testing.assert_array_equal(out, data)


def test_sharded_decompress_rejects_corrupt_stream(mesh):
    from wah_tpu.parallel.dist import ShardedCodec

    codec = ShardedCodec(mesh)
    with pytest.raises(ValueError):
        codec.decompress(np.array([0x80000000], dtype=np.uint32))


def test_sharded_uneven_shards(mesh):
    """The encoder under a real 8-device shard_map, 12 blocks per shard: each shard's chunk_base must keep its padding
    and its block validity global, and the one-fill tail on the last
    shard must stay one word per block."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    nb = 96  # nb_l = 12
    n = nb * BLOCK_INTS
    rng = np.random.default_rng(42)
    data = np.where(
        rng.random(n) < 0.5, rng.integers(0, 1 << 32, n, dtype=np.uint64), 0
    ).astype(np.uint32)
    data[2 * BLOCK_INTS : 5 * BLOCK_INTS] = 0  # fills inside shard 0
    data[-3 * BLOCK_INTS :] = 0xFFFFFFFF  # one-fill tail on shard 7
    nv = chunk_count(n)
    ref = golden.encode(data)

    dev = jax.device_put(data, NamedSharding(mesh, P("blocks")))
    words, totals = encode_sharded(mesh, dev, np.int32(nv))
    np.testing.assert_array_equal(gather_stream(words, totals), ref)


def test_sharded_codec_sparse_hint_roundtrip(mesh):
    """Near-empty data: almost every block is one zero fill, so most
    shards emit a handful of words; the stream stays golden."""
    from wah_tpu import golden

    data = np.zeros(8 * BLOCK_INTS, dtype=np.uint32)
    data[::4099] = 1
    codec = ShardedCodec(mesh)
    stream = codec.compress(data)
    np.testing.assert_array_equal(stream, golden.encode(data))


def test_sharded_partial_last_shard(mesh):
    """The sharded encode of a bitmap that ends inside the last shard, then the sharded decode back: stream golden, roundtrip
    exact."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    n = 13 * BLOCK_INTS + 77
    data = random_bitmap(n, density=1 / 16, seed=17)
    data[3 * BLOCK_INTS : 4 * BLOCK_INTS] = 0
    nv = chunk_count(n)
    nb = 16  # two blocks per shard, the last ones mostly padding
    padded = np.zeros(nb * BLOCK_INTS, np.uint32)
    padded[:n] = data
    dev = jax.device_put(padded, NamedSharding(mesh, P("blocks")))
    words, totals = encode_sharded(mesh, dev, np.int32(nv))
    ref = golden.encode(data)
    np.testing.assert_array_equal(gather_stream(words, totals), ref)
    M = 1 << (len(ref) - 1).bit_length()
    wp = np.zeros(M, np.uint32)
    wp[: len(ref)] = ref
    ints, _ = decode_sharded(
        mesh, jax.device_put(wp), np.int32(len(ref)), nb * BLOCK_CHUNKS
    )
    np.testing.assert_array_equal(gather_bitmap(ints, n), data)


def test_stitch_global_bounded_payload(mesh):
    """word_cap bounds the all_gather payload: the replicated stream
    capacity shrinks to D*word_cap and stays bit-exact when every
    shard's live words fit the bound."""
    from wah_tpu.parallel import stitch_global, stitch_word_cap

    data = random_bitmap(16 * BLOCK_INTS, density=1 / 256, seed=23)
    ref = golden.encode(data)
    dev = jax.device_put(data)
    words, totals = encode_sharded(mesh, dev, np.int32(chunk_count(len(data))))
    cap_w = stitch_word_cap(totals)
    assert cap_w < words.shape[0] // mesh.size  # bound actually bites
    stream, total, overflow = stitch_global(mesh, words, totals, cap_w)
    assert not bool(overflow)
    assert stream.shape[0] == mesh.size * cap_w
    assert int(total) == len(ref)
    np.testing.assert_array_equal(np.asarray(stream)[: len(ref)], ref)


def test_stitch_global_overflow_flag(mesh):
    """A word_cap below some shard's live count must raise the overflow
    flag (total stays correct — it comes from the totals gather)."""
    from wah_tpu.parallel import stitch_global

    data = random_bitmap(8 * BLOCK_INTS, density=0.5, seed=29)
    ref = golden.encode(data)
    dev = jax.device_put(data)
    words, totals = encode_sharded(mesh, dev, np.int32(chunk_count(len(data))))
    assert int(np.asarray(totals).max()) > 64
    _, total, overflow = stitch_global(mesh, words, totals, 64)
    assert bool(overflow)
    assert int(total) == len(ref)
    # retry unbounded: the fallback path recovers the exact stream
    stream, total, overflow = stitch_global(mesh, words, totals)
    assert not bool(overflow) and int(total) == len(ref)
    np.testing.assert_array_equal(np.asarray(stream)[: len(ref)], ref)


def test_estimate_word_cap_holds(mesh):
    """The sample-based cap must cover the true per-shard maximum for
    representative densities (the overflow flag covers the rest)."""
    from wah_tpu.parallel import estimate_word_cap

    D = mesh.size
    nb = 16
    for dens, seed in ((1 / 2, 1), (1 / 16, 2), (1 / 1024, 3)):
        data = random_bitmap(nb * BLOCK_INTS, density=dens, seed=seed)
        dev = jax.device_put(data)
        _, totals = encode_sharded(mesh, dev, np.int32(chunk_count(len(data))))
        cap_w = estimate_word_cap(data, nb // D)
        assert cap_w >= int(np.asarray(totals).max()), (dens, cap_w)
