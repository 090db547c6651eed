"""Property-based roundtrip tests (hypothesis): for ANY bitmap, every
execution path must produce the golden stream and invert it exactly.

This generalizes the reference's fixed crafted vectors (tests.cpp) into
a property: encode/decode are a bijection between bitmaps and valid WAH
streams, across golden / pure-XLA / native C++ paths,
at any size
(including non-block, non-warp multiples the reference leaves UB —
SURVEY.md §4.1.1-2).
"""
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from wah_tpu import golden, native
from wah_tpu.api import validate_stream
from wah_tpu.ops import decode as dops
from wah_tpu.ops import encode as eops

SETTINGS = dict(
    max_examples=25,
    deadline=None,
    suppress_health_check=[HealthCheck.too_slow],
)


@st.composite
def bitmaps(draw):
    """Bitmaps biased toward runs and block-seam structure."""
    n = draw(st.integers(min_value=0, max_value=3 * 992 + 40))
    kind = draw(st.sampled_from(["random", "runs", "sparse", "const"]))
    rng = np.random.default_rng(draw(st.integers(0, 2**31)))
    if kind == "random":
        return rng.integers(0, 1 << 32, size=n, dtype=np.int64).astype(
            np.uint32
        )
    if kind == "sparse":
        x = np.zeros(n, dtype=np.uint32)
        if n:
            idx = rng.integers(0, n, size=max(1, n // 50))
            x[idx] = np.uint32(1) << rng.integers(0, 32, size=idx.shape[0])
        return x
    if kind == "const":
        return np.full(
            n, draw(st.sampled_from([0, 0xFFFFFFFF])), dtype=np.uint32
        )
    # runs: alternating 0/1 bit runs with random lengths
    total_bits = n * 32
    bits = np.zeros(total_bits, dtype=np.uint8)
    pos, val = 0, rng.integers(0, 2)
    while pos < total_bits:
        ln = int(rng.integers(1, 4000))
        bits[pos : pos + ln] = val
        val ^= 1
        pos += ln
    if n == 0:
        return np.zeros(0, dtype=np.uint32)
    return np.packbits(bits, bitorder="little").view(np.uint32)[:n].copy()


@given(bitmaps())
@settings(**SETTINGS)
def test_golden_roundtrip_and_stream_validity(data):
    stream = golden.encode(data)
    validate_stream(stream)
    out = golden.decode(stream, out_ints=len(data))
    np.testing.assert_array_equal(out, data)


@given(bitmaps())
@settings(**SETTINGS)
def test_native_matches_golden(data):
    if not native.available():
        pytest.skip("no native toolchain")
    np.testing.assert_array_equal(native.encode(data), golden.encode(data))
    stream = golden.encode(data)
    np.testing.assert_array_equal(
        native.decode(stream, out_ints=len(data)), data
    )


@given(bitmaps())
@settings(max_examples=10, deadline=None)
def test_xla_matches_golden(data):
    from wah_tpu.constants import BLOCK_CHUNKS, BLOCK_INTS
    from wah_tpu.golden import chunk_count

    n = len(data)
    if n == 0:
        return
    ref = golden.encode(data)
    nv = chunk_count(n)
    nb = -(-nv // BLOCK_CHUNKS)
    padded = np.zeros(nb * BLOCK_INTS, dtype=np.uint32)
    padded[:n] = data
    words, total = eops.encode_padded(padded, nv)
    np.testing.assert_array_equal(np.asarray(words)[: int(total)], ref)

    cap = nb * BLOCK_CHUNKS
    M = max(1024, len(ref))
    wp = np.zeros(M, dtype=np.uint32)
    wp[: len(ref)] = ref
    ints, n_ints = dops.decode(wp, np.int32(len(ref)), cap)
    np.testing.assert_array_equal(np.asarray(ints)[:n], data)


@given(st.data())
@settings(max_examples=8, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
def test_batch_roundtrip(data_st):
    """Property: for ANY set of equal-length columns, the batched encode
    produces each column's golden stream, and the batch decode inverts
    it exactly."""
    from wah_tpu import WahCodec

    C = data_st.draw(st.integers(min_value=1, max_value=5))
    n = data_st.draw(st.integers(min_value=1, max_value=2 * 992 + 40))
    # draw C independent bitmaps, truncated/padded to a common length
    raw = [data_st.draw(bitmaps()) for _ in range(C)]
    cols = np.zeros((C, n), np.uint32)
    for i, r in enumerate(raw):
        cols[i, : min(n, len(r))] = r[:n]

    codec = WahCodec()
    words, totals = codec.compress_batch(cols)
    for c in range(C):
        ref = golden.encode(cols[c])
        assert totals[c] == len(ref), c
        np.testing.assert_array_equal(words[c, : totals[c]], ref)
    out = codec.decompress_batch(words, totals, out_ints=n)
    np.testing.assert_array_equal(out, cols)
