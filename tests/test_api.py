"""End-to-end tests of the host API (compress/decompress with timings)."""
import numpy as np
import pytest

from conftest import clustered_bitmap, random_bitmap
from wah_tpu import WahCodec, compress, decompress, golden, validate_stream

U = np.uint32


@pytest.mark.parametrize(
    "n,density",
    [(992 * 4, 0.01), (992 * 4, 0.5), (31, 0.2), (1000, 0.1), (992 * 7 + 5, 0.003)],
)
def test_compress_matches_golden(n, density):
    data = random_bitmap(n, density, seed=n)
    stream, t = compress(data)
    np.testing.assert_array_equal(stream, golden.encode(data))
    validate_stream(stream)
    assert t.kernel_ms >= 0.0


def test_roundtrip_api():
    for gen in (
        lambda: random_bitmap(992 * 8, 0.02),
        lambda: clustered_bitmap(992 * 6),
        lambda: np.zeros(992 * 2, dtype=U),
    ):
        data = gen()
        stream, _ = compress(data)
        out, _ = decompress(stream, out_ints=data.shape[0])
        np.testing.assert_array_equal(out, data)


def test_decompress_default_size():
    data = random_bitmap(31 * 5, 0.2, seed=42)
    stream, _ = compress(data)
    out, _ = decompress(stream)
    assert out.shape[0] == 31 * 5  # ceil(31 * chunks / 32)
    np.testing.assert_array_equal(out, data)


def test_empty_input():
    stream, _ = compress(np.zeros(0, dtype=U))
    assert stream.shape == (0,)
    out, _ = decompress(stream)
    assert out.shape == (0,)


def test_jit_cache_reuse():
    codec = WahCodec(kernel="xla")
    for seed in range(3):
        data = random_bitmap(992 * 2, 0.05, seed=seed)
        stream, _ = codec.compress(data)
        out, _ = codec.decompress(stream, out_ints=data.shape[0])
        np.testing.assert_array_equal(out, data)
    assert len(codec._encode_fns) == 1  # bucketed: one compile for all three


def test_validate_stream_rejects_bad():
    with pytest.raises(ValueError):
        validate_stream(np.array([0], dtype=U))
    with pytest.raises(ValueError):
        validate_stream(np.array([0x7FFFFFFF], dtype=U))
    with pytest.raises(ValueError):
        validate_stream(np.array([0x80000000], dtype=U))  # zero-length fill


def test_foreign_wah_long_fill_rejected():
    """Interop envelope (README): a stream from a general WAH encoder
    may carry fill lengths up to 2^30-1 (the format limit the reference
    decoder masks with 0x3FFFFFFF, kernels.cu:300,334), but this codec
    only accepts the block invariant it emits — fills in [1, 1024].
    Pins the rejection and its message."""
    foreign = np.array([0x80000000 | 2048], dtype=U)  # legal WAH, >1024
    with pytest.raises(ValueError, match="fill length out of range"):
        validate_stream(foreign)
    with pytest.raises(ValueError, match="fill length out of range"):
        WahCodec().decompress(foreign)


def test_decompress_rejects_corrupt_stream():
    """Every decompress entry validates the stream first (the reference
    checks nothing, decompress.cu:48-52, and expands garbage)."""
    codec = WahCodec()
    good = golden.encode(np.array([5, 0, 0, 7], dtype=U))
    for bad in ([0], [0x7FFFFFFF], [0x80000000], [0xC0000000 | 2000]):
        stream = np.concatenate([good, np.array(bad, dtype=U)])
        with pytest.raises(ValueError):
            codec.decompress(stream)


def test_decompress_batch_rejects_corrupt_column():
    codec = WahCodec()
    words, totals = codec.compress_batch(
        np.array([[1, 2, 3, 4] * 8, [0] * 32], dtype=U)
    )
    words = np.array(words)  # returned arrays may be read-only views
    words[1, 0] = 0x80000000  # zero-length fill in column 1's prefix
    with pytest.raises(ValueError):
        codec.decompress_batch(words, totals)
    # corruption beyond the valid prefix must NOT trip validation
    words[1, 0] = golden.encode(np.zeros(32, dtype=U))[0]
    words[1, int(totals[1])] = 0x7FFFFFFF
    codec.decompress_batch(words, totals)


def test_size_cap_guard():
    """int32 chunk positions cap one bitmap at 2^20 blocks (4.16 GB);
    the API raises instead of silently wrapping."""
    from wah_tpu.api import MAX_INTS_PER_BITMAP, _check_size

    _check_size(MAX_INTS_PER_BITMAP)  # at the cap: fine
    with pytest.raises(ValueError):
        _check_size(MAX_INTS_PER_BITMAP + 1)


@pytest.mark.parametrize("entry", ["decompress", "decompress_batch"])
def test_decompress_refuses_streams_past_the_chunk_cap(entry):
    """A stream that expands past 2^30 chunks (as a concatenation of
    segment streams may) is refused before any device work, with the
    segment methods named, instead of wrapping int32 positions."""
    from wah_tpu.api import MAX_CHUNKS
    from wah_tpu.constants import BIT31, BLOCK_CHUNKS

    n_words = MAX_CHUNKS // BLOCK_CHUNKS + 1
    stream = np.full(n_words, BIT31 | BLOCK_CHUNKS, np.uint32)
    codec = WahCodec()
    with pytest.raises(ValueError, match="segments"):
        if entry == "decompress":
            codec.decompress(stream)
        else:
            codec.decompress_batch(stream[None], np.array([n_words]))
    # at the cap the size check passes (only the check is run here)
    from wah_tpu.api import _check_chunks

    _check_chunks((n_words - 1) * BLOCK_CHUNKS)


def test_segmented_compress_decompress():
    """Segmented codec: block-aligned segments concatenate to the exact
    golden stream of the whole bitmap and roundtrip at any size."""
    from conftest import clustered_bitmap, random_bitmap
    from wah_tpu import golden
    from wah_tpu.api import WahCodec
    from wah_tpu.constants import BLOCK_INTS

    codec = WahCodec(kernel="xla")
    seg = 2 * BLOCK_INTS
    for data in (
        random_bitmap(7 * BLOCK_INTS + 123, 1 / 16, seed=91),
        clustered_bitmap(6 * BLOCK_INTS, seed=92),
        np.zeros(5 * BLOCK_INTS, np.uint32),
    ):
        stream = codec.compress_segments(data, segment_ints=seg)
        np.testing.assert_array_equal(stream, golden.encode(data))
        out = codec.decompress_segments(
            stream, out_ints=len(data), segment_ints=seg
        )
        np.testing.assert_array_equal(out, data)


def test_segment_defaults_are_block_aligned():
    """The default segment_ints values must satisfy the functions' own
    block-alignment assert (1 << 28 / 1 << 23 did NOT — 992 does not
    divide powers of two — so any default-argument call on data larger
    than one segment raised AssertionError)."""
    import inspect

    from wah_tpu.api import WahCodec
    from wah_tpu.constants import BLOCK_INTS

    for fn in (
        WahCodec.compress_segments,
        WahCodec.decompress_segments,
        WahCodec.compress_batch_segments,
        WahCodec.decompress_batch_segments,
    ):
        default = inspect.signature(fn).parameters["segment_ints"].default
        assert default % BLOCK_INTS == 0, fn.__name__


def test_segmented_batch_compress_decompress():
    """Column-segmented batched codec (BASELINE configs[3] machinery):
    per-column streams equal the unsegmented golden streams and the
    batched segment decode reproduces every column."""
    from conftest import clustered_bitmap, random_bitmap
    from wah_tpu import golden
    from wah_tpu.api import WahCodec
    from wah_tpu.constants import BLOCK_INTS

    n = 5 * BLOCK_INTS + 201
    cols = np.stack(
        [
            random_bitmap(n, 1 / 32, seed=60),
            clustered_bitmap(n, seed=61),
            np.zeros(n, np.uint32),
            random_bitmap(n, 0.5, seed=62),
        ]
    )
    codec = WahCodec()
    streams = codec.compress_batch_segments(
        cols, segment_ints=2 * BLOCK_INTS
    )
    for c in range(cols.shape[0]):
        np.testing.assert_array_equal(
            streams[c], golden.encode(cols[c]), err_msg=str(c)
        )
    out = codec.decompress_batch_segments(
        streams, out_ints=n, segment_ints=2 * BLOCK_INTS
    )
    np.testing.assert_array_equal(out, cols)
