"""Batched-columns (bitmap-index) API tests: each column must produce
exactly the stream the golden model produces for it alone."""
import numpy as np

from conftest import clustered_bitmap, random_bitmap
from wah_tpu import WahCodec, golden
from wah_tpu.constants import BLOCK_INTS


def _columns(n_ints, densities, seed0=100):
    return np.stack(
        [
            random_bitmap(n_ints, d, seed=seed0 + i)
            for i, d in enumerate(densities)
        ]
    )


def test_batch_compress_matches_per_column_golden():
    data = _columns(2 * BLOCK_INTS + 100, [1 / 64, 1 / 8, 0.5, 0.0])
    codec = WahCodec(kernel="xla")
    words, totals = codec.compress_batch(data)
    for c in range(data.shape[0]):
        ref = golden.encode(data[c])
        assert totals[c] == len(ref), c
        np.testing.assert_array_equal(words[c, : totals[c]], ref)


def test_batch_roundtrip():
    data = _columns(3 * BLOCK_INTS, [1 / 32, 0.2, 1 / 1024])
    codec = WahCodec(kernel="xla")
    words, totals = codec.compress_batch(data)
    out = codec.decompress_batch(words, totals, out_ints=data.shape[1])
    np.testing.assert_array_equal(out, data)


def test_batch_mixed_extremes():
    n = BLOCK_INTS
    data = np.stack(
        [
            np.zeros(n, np.uint32),
            np.full(n, 0xFFFFFFFF, np.uint32),
            clustered_bitmap(n, seed=9),
        ]
    )
    codec = WahCodec(kernel="xla")
    words, totals = codec.compress_batch(data)
    assert totals[0] == 1 and totals[1] == 1  # single fill word each
    out = codec.decompress_batch(words, totals, out_ints=n)
    np.testing.assert_array_equal(out, data)


def test_batch_streams_and_roundtrip():
    """One batched encode over all columns' blocks: exact per-column
    streams, and the batched decode returns the columns."""
    data = _columns(2 * BLOCK_INTS + 100, [1 / 64, 0.5, 0.0], seed0=7)
    codec = WahCodec()
    words, totals = codec.compress_batch(data)
    for c in range(data.shape[0]):
        ref = golden.encode(data[c])
        assert totals[c] == len(ref), c
        np.testing.assert_array_equal(words[c, : totals[c]], ref)
    out = codec.decompress_batch(words, totals, out_ints=data.shape[1])
    np.testing.assert_array_equal(out, data)


def test_batch_capacity_filling_columns():
    """Per-column streams bit-exact vs golden across densities, including
    a column whose stream fills its capacity exactly (incompressible
    data) beside all-zero and all-one columns."""
    nb = 8
    n = nb * BLOCK_INTS  # block-aligned: full-capacity column possible
    rng = np.random.default_rng(42)
    cols = np.stack(
        [
            random_bitmap(n, 1 / 64, seed=11),
            rng.integers(1, 2**32, size=n, dtype=np.uint64).astype(
                np.uint32
            ),  # no zero/ones words: total == nb*1024 exactly
            np.zeros(n, np.uint32),
            random_bitmap(n, 0.5, seed=12),
            np.full(n, 0xFFFFFFFF, np.uint32),
        ]
    )
    words, totals = WahCodec().compress_batch(cols)
    assert totals[1] == nb * 1024  # capacity-filling column
    for c in range(cols.shape[0]):
        ref = golden.encode(cols[c])
        assert totals[c] == len(ref), c
        np.testing.assert_array_equal(words[c, : totals[c]], ref)


def test_batch_agrees_with_single_columns_with_tail():
    """A non-block-multiple column length (partial last block) and a
    non-pow2 block count: the batched encode gives each column the
    stream that compress() gives it alone."""
    n = 5 * BLOCK_INTS + 123
    cols = np.stack(
        [random_bitmap(n, d, seed=20 + i) for i, d in enumerate(
            [1 / 512, 0.3, 0.0, 1.0, 1 / 16])]
    )
    codec = WahCodec()
    bw, bt = codec.compress_batch(cols)
    for c in range(cols.shape[0]):
        single, _ = codec.compress(cols[c])
        np.testing.assert_array_equal(bw[c, : bt[c]], single)
        np.testing.assert_array_equal(single, golden.encode(cols[c]))


def test_batch_decode_mixed_columns():
    """decompress_batch over mixed columns — all-zeros (max-length fills),
    incompressible (capacity-filling stream), dense, sparse, all-ones,
    clustered — with a partial last block."""
    n = 7 * BLOCK_INTS + 200
    rng = np.random.default_rng(77)
    cols = np.stack(
        [
            np.zeros(n, np.uint32),
            rng.integers(1, 2**32, size=n, dtype=np.uint64).astype(
                np.uint32
            ),
            random_bitmap(n, 0.5, seed=31),
            random_bitmap(n, 1 / 512, seed=32),
            np.full(n, 0xFFFFFFFF, np.uint32),
            clustered_bitmap(n, seed=33),
        ]
    )
    streams = [golden.encode(c) for c in cols]
    M = max(len(s) for s in streams)
    w2 = np.zeros((len(streams), M), np.uint32)
    for i, s in enumerate(streams):
        w2[i, : len(s)] = s
    totals = np.array([len(s) for s in streams])
    out = WahCodec().decompress_batch(w2, totals, out_ints=n)
    np.testing.assert_array_equal(out, cols)


def test_batch_decompress_unequal_expansions():
    """Columns of different expanded lengths share one batch decode: the
    capacity follows the longest, shorter ones decode to their own
    length and zeros after it."""
    a = random_bitmap(3 * BLOCK_INTS, 1 / 8, seed=41)
    b = random_bitmap(BLOCK_INTS + 10, 0.5, seed=42)
    sa, sb = golden.encode(a), golden.encode(b)
    w2 = np.zeros((2, max(len(sa), len(sb))), np.uint32)
    w2[0, : len(sa)] = sa
    w2[1, : len(sb)] = sb
    out = WahCodec().decompress_batch(w2, np.array([len(sa), len(sb)]))
    np.testing.assert_array_equal(out[0, : len(a)], a)
    np.testing.assert_array_equal(out[1, : len(b)], b)
    assert not out[1, len(golden.decode(sb)) :].any()
