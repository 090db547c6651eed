"""The XLA encoder (ops/encode.py), differential against the golden model
over the shared case grid, plus its shard, batch and stitch contracts."""
import jax
import numpy as np
import pytest

from cases import GRID, U
from conftest import random_bitmap
from wah_tpu import golden
from wah_tpu.constants import BIT31, BLOCK_CHUNKS, BLOCK_INTS, ONES
from wah_tpu.golden import chunk_count
from wah_tpu.ops import encode as xla_encode

_encode = jax.jit(xla_encode.encode_padded)


def padded(data: np.ndarray, nb: int | None = None):
    n = len(data)
    nv = chunk_count(n)
    nb = nb or -(-nv // BLOCK_CHUNKS)
    p = np.zeros(nb * BLOCK_INTS, dtype=U)
    p[:n] = data
    return p, nv


def encode(data: np.ndarray) -> np.ndarray:
    p, nv = padded(data)
    words, total = _encode(p, np.int32(nv))
    return np.asarray(words)[: int(total)]


@pytest.mark.parametrize("name", sorted(GRID))
def test_encode_matches_golden_grid(name):
    data = GRID[name]()
    np.testing.assert_array_equal(encode(data), golden.encode(data))


@pytest.mark.parametrize("base_blocks", [0, 4, 28])
def test_shard_padding_emits_no_words(base_blocks):
    """A shard of a distributed encode: chunk positions count from
    chunk_base, and positions at or past the GLOBAL n_valid_chunks emit
    nothing, so padding on the last shard adds no fill words."""
    nb = 4
    data = np.zeros(nb * BLOCK_INTS, dtype=U)
    nv_global = np.int32(30 * BLOCK_CHUNKS + 100)  # ends inside shard 7
    base = np.int32(base_blocks * BLOCK_CHUNKS)
    words, total = _encode(data, nv_global, base)
    live = int(np.clip(nv_global - base, 0, nb * BLOCK_CHUNKS))
    full, part = divmod(live, BLOCK_CHUNKS)
    want = np.array([BIT31 | BLOCK_CHUNKS] * full + ([BIT31 | part] if part
                                                     else []), dtype=U)
    assert int(total) == len(want)
    np.testing.assert_array_equal(np.asarray(words)[: len(want)], want)


@pytest.mark.parametrize("n", [1, 30, 31, 992 + 1, 5 * 992 + 17, 63 * 992 + 991])
def test_sizes_not_block_multiples(n):
    data = random_bitmap(n, 0.05, seed=n)
    np.testing.assert_array_equal(encode(data), golden.encode(data))


def test_capacity_filling_stream():
    """Incompressible data: every chunk is a literal, the stream fills
    its capacity exactly, and every block's words are a full row."""
    rng = np.random.default_rng(3)
    data = rng.integers(1, 2**32 - 1, size=8 * BLOCK_INTS,
                        dtype=np.uint64).astype(U)
    p, nv = padded(data)
    words, total = _encode(p, np.int32(nv))
    assert int(total) == 8 * BLOCK_CHUNKS
    np.testing.assert_array_equal(np.asarray(words), golden.encode(data))


def test_blocks_stitch_to_per_block_streams():
    """The scan-and-scatter stitch: block b's words are the golden stream
    of block b alone, placed at the sum of the earlier blocks' counts."""
    data = random_bitmap(8 * BLOCK_INTS, 1 / 16, seed=2)
    data[BLOCK_INTS : 2 * BLOCK_INTS] = 0
    words = encode(data)
    at = 0
    for b in range(8):
        want = golden.encode(data[b * BLOCK_INTS : (b + 1) * BLOCK_INTS])
        np.testing.assert_array_equal(words[at : at + len(want)], want)
        at += len(want)
    assert at == len(words)


@pytest.mark.parametrize("kinds", [
    ["literals", "zeros", "ones", "literals"],
    ["zeros", "literals", "literals", "zeros"],
])
def test_stitch_of_full_and_single_word_blocks(kinds):
    """Blocks of 1024 words beside blocks of one word: every block's
    words land right after the previous block's, none overwritten."""
    rng = np.random.default_rng(5)
    fill = {
        "literals": lambda: rng.integers(1, 2**31, size=BLOCK_INTS,
                                         dtype=np.uint64).astype(U) | U(1),
        "zeros": lambda: np.zeros(BLOCK_INTS, U),
        "ones": lambda: np.full(BLOCK_INTS, ONES, U),
    }
    data = np.concatenate([fill[k]() for k in kinds])
    words = encode(data)
    counts = [BLOCK_CHUNKS if k == "literals" else 1 for k in kinds]
    assert len(words) == sum(counts)
    np.testing.assert_array_equal(words, golden.encode(data))


@pytest.mark.parametrize("densities", [
    [1 / 64, 1 / 8, 0.5, 0.0],
    [1.0, 1 / 512, 0.3],
    [1 / 16],
])
def test_batch_matches_golden(densities):
    n = 2 * BLOCK_INTS + 100
    cols = np.stack([random_bitmap(n, d, seed=10 + i)
                     for i, d in enumerate(densities)])
    nv = chunk_count(n)
    nb = 4
    p = np.zeros((len(cols), nb * BLOCK_INTS), U)
    p[:, :n] = cols
    words, totals = jax.jit(xla_encode.encode_batch)(p, np.int32(nv))
    words, totals = np.asarray(words), np.asarray(totals)
    for c, col in enumerate(cols):
        ref = golden.encode(col)
        assert totals[c] == len(ref), c
        np.testing.assert_array_equal(words[c, : totals[c]], ref)


def test_batch_capacity_filling_column():
    """A column whose stream fills its capacity sits next to sparse
    ones: its words must not spill into the next column."""
    nb = 2
    rng = np.random.default_rng(4)
    cols = np.stack([
        rng.integers(1, 2**32 - 1, size=nb * BLOCK_INTS,
                     dtype=np.uint64).astype(U),
        np.zeros(nb * BLOCK_INTS, U),
        random_bitmap(nb * BLOCK_INTS, 0.5, seed=12),
    ])
    words, totals = xla_encode.encode_batch(cols, np.int32(nb * BLOCK_CHUNKS))
    words, totals = np.asarray(words), np.asarray(totals)
    assert totals[0] == nb * BLOCK_CHUNKS
    for c, col in enumerate(cols):
        np.testing.assert_array_equal(words[c, : totals[c]],
                                      golden.encode(col))
