"""Differential tests: pure-JAX encode/decode vs the NumPy golden model."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conftest import clustered_bitmap, random_bitmap
from wah_tpu import golden
from wah_tpu.constants import BIT31, ONES
from wah_tpu.ops import bits, decode as jdec, encode as jenc
from cases import GRID

U = np.uint32


# ---------- primitives ----------

def test_repartition_matches_golden(rng):
    data = rng.integers(0, 2**32, size=992 * 2, dtype=U)
    out = np.asarray(bits.repartition_chunks(jnp.asarray(data)))
    np.testing.assert_array_equal(out, golden.repartition_chunks(data))


def test_merge_matches_golden(rng):
    chunks = rng.integers(0, 2**31, size=1024 * 2, dtype=U)
    out = np.asarray(bits.merge_chunks(jnp.asarray(chunks)))
    np.testing.assert_array_equal(out, golden.merge_chunks(chunks))


def test_block_words_slots_and_counts():
    """block_words: one run end per word slot, slots 0..count-1 in
    order, values equal to the golden stream of each block."""
    data = random_bitmap(992 * 3, 1 / 16, seed=4)
    data[992 : 992 + 500] = 0
    chunks = bits.repartition_chunks(jnp.asarray(data)).reshape(3, 1024)
    value, end, slot, counts = map(np.asarray, jenc.block_words(chunks))
    for b in range(3):
        np.testing.assert_array_equal(slot[b][end[b]], np.arange(counts[b]))
        np.testing.assert_array_equal(
            value[b][end[b]], golden.encode(data[992 * b : 992 * (b + 1)])
        )


def test_expand_window_drops_dead_words():
    """Words outside the live mask must not reach the span, even where
    their (clamped) offsets collide with live ones."""
    C = 64
    words = np.full(C, U(BIT31 | 2))  # zero fills of 2 chunks
    words[0] = U(0x1234)  # live literal at chunk 0
    off = np.clip(np.arange(C) * 2 - 1, 0, C).astype(np.int32)
    ok = np.zeros(C, bool)
    ok[:3] = True  # literal, then fills at 1 and 3 (chunks 1..4)
    words[3] = U(0x5555)  # dead word aimed at chunk 5
    out = np.asarray(jdec.expand_window(
        jnp.asarray(words), jnp.asarray(off), jnp.asarray(ok)))
    assert out[0] == 0x1234 and not out[1:6].any()


# ---------- encode ----------

ENCODE_CASES = [
    ("zeros", lambda: np.zeros(992 * 2, dtype=U)),
    ("ones", lambda: np.full(992 * 2, ONES, dtype=U)),
    ("sparse", lambda: random_bitmap(992 * 4, 0.01)),
    ("half", lambda: random_bitmap(992 * 4, 0.5)),
    ("dense0", lambda: random_bitmap(992 * 4, 0.999, seed=3)),
    ("clustered", lambda: clustered_bitmap(992 * 4)),
    ("partial_warp", lambda: random_bitmap(31, 0.3, seed=5)),
    ("partial_block", lambda: random_bitmap(992 + 31 * 7, 0.05, seed=9)),
    ("unaligned", lambda: random_bitmap(1000, 0.1, seed=11)),
]


@pytest.mark.parametrize("name,gen", ENCODE_CASES, ids=[c[0] for c in ENCODE_CASES])
def test_encode_matches_golden(name, gen):
    data = gen()
    words, total = jax.jit(jenc.encode)(jnp.asarray(data))
    total = int(total)
    expected = golden.encode(data)
    assert total == expected.shape[0]
    np.testing.assert_array_equal(np.asarray(words)[:total], expected)
    # capacity tail is zeroed
    assert not np.asarray(words)[total:].any()


def test_encode_batched_vmap():
    """Bitmap-index batch: vmapped encode over column bitmaps."""
    cols = np.stack([random_bitmap(992, 0.02, seed=s) for s in range(4)])
    words, totals = jax.jit(jax.vmap(jenc.encode))(jnp.asarray(cols))
    for c in range(4):
        exp = golden.encode(cols[c])
        assert int(totals[c]) == exp.shape[0]
        np.testing.assert_array_equal(np.asarray(words)[c, : exp.shape[0]], exp)


# ---------- decode ----------

@pytest.mark.parametrize("name,gen", ENCODE_CASES, ids=[c[0] for c in ENCODE_CASES])
def test_decode_matches_golden(name, gen):
    data = gen()
    stream = golden.encode(data)
    cap_chunks = golden.chunk_count(data.shape[0])
    cap_chunks = -(-cap_chunks // 1024) * 1024
    M = max(stream.shape[0], 8)
    padded = np.zeros(M, dtype=U)
    padded[: stream.shape[0]] = stream
    ints, n_ints = jax.jit(jdec.decode, static_argnums=2)(
        jnp.asarray(padded), stream.shape[0], cap_chunks
    )
    expected = golden.decode(stream)
    assert int(n_ints) == expected.shape[0]
    np.testing.assert_array_equal(np.asarray(ints)[: int(n_ints)], expected)


def test_roundtrip_jax_only():
    data = random_bitmap(992 * 8, 0.03, seed=21)
    words, total = jax.jit(jenc.encode)(jnp.asarray(data))
    cap = -(-golden.chunk_count(data.shape[0]) // 1024) * 1024
    ints, n_ints = jax.jit(jdec.decode, static_argnums=2)(words, total, cap)
    assert int(n_ints) == data.shape[0]
    np.testing.assert_array_equal(np.asarray(ints)[: data.shape[0]], data)


def test_decode_n_ints_past_int32_bit_count():
    """31*n_chunks overflows int32 once n_chunks > 69,273,666 (a 268 MB
    bitmap): the s=128 sweep config (496 MB, density 0.5) decoded a
    NEGATIVE n_ints and the host sliced the output short. n_ints must
    use the overflow-free form n - n//32."""
    from wah_tpu.constants import BIT31

    nb = 67_652  # n_chunks = nb*1024 = 69,275,648, past the threshold
    words = np.full(nb, np.uint32(BIT31 | 1024))
    cap = nb * 1024
    ints, n_ints = jax.jit(jdec.decode, static_argnums=2)(
        jnp.asarray(words), np.int32(nb), cap
    )
    nc = nb * 1024
    assert int(n_ints) == nc - nc // 32 == (31 * nc + 31) // 32
    assert int(jnp.count_nonzero(ints)) == 0


@pytest.mark.parametrize("name", sorted(GRID))
def test_decode_grid_matches_golden(name):
    """The scatter + cummax decode over the shared case grid."""
    data = GRID[name]()
    stream = golden.encode(data)
    cap = -(-golden.chunk_count(len(data)) // 1024) * 1024
    M = max(1024, stream.shape[0])
    padded = np.zeros(M, dtype=U)
    padded[: stream.shape[0]] = stream
    ints, n_ints = jax.jit(jdec.decode, static_argnums=2)(
        jnp.asarray(padded), np.int32(stream.shape[0]), cap
    )
    np.testing.assert_array_equal(np.asarray(ints)[: len(data)], data)
    np.testing.assert_array_equal(
        np.asarray(ints)[: int(n_ints)], golden.decode(stream)
    )
