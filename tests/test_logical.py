"""Compressed-domain logical ops: differential against the obvious
decode-op-encode oracle built from the golden model."""
import numpy as np
import pytest

from conftest import clustered_bitmap, random_bitmap
from wah_tpu import WahCodec, golden
from wah_tpu.constants import BLOCK_INTS
from wah_tpu.ops.logical import OPS, complement_stream


def _oracle(a_bits, b_bits, op):
    return {
        "and": a_bits & b_bits,
        "or": a_bits | b_bits,
        "xor": a_bits ^ b_bits,
        "andnot": a_bits & ~b_bits,
    }[op]


@pytest.fixture(scope="module")
def codec():
    return WahCodec(kernel="xla")


@pytest.mark.parametrize("op", sorted(OPS))
def test_logical_matches_oracle(codec, op):
    n = 3 * BLOCK_INTS + 111
    a = random_bitmap(n, 0.05, seed=1)
    b = clustered_bitmap(n, seed=2)
    sa, sb = golden.encode(a), golden.encode(b)
    got = codec.logical(sa, sb, op, n)
    want = golden.encode(_oracle(a, b, op))
    np.testing.assert_array_equal(got, want)


def test_logical_extreme_operands(codec):
    n = 2 * BLOCK_INTS
    zeros = np.zeros(n, np.uint32)
    ones = np.full(n, 0xFFFFFFFF, np.uint32)
    sz, so = golden.encode(zeros), golden.encode(ones)
    assert list(codec.logical(sz, so, "and", n)) == list(sz)
    assert list(codec.logical(sz, so, "or", n)) == list(so)
    assert list(codec.logical(so, so, "xor", n)) == list(sz)


def test_complement_stream_roundtrip():
    n = 2 * BLOCK_INTS  # whole blocks: no padding-bit semantics to mask
    a = random_bitmap(n, 0.2, seed=3)
    s = golden.encode(a)
    sc = np.asarray(complement_stream(s, len(s)))
    out = golden.decode(sc, out_ints=n)
    np.testing.assert_array_equal(out, ~a)


def test_logical_composition(codec):
    """(A and B) or (A xor B) == A or B, computed fully compressed."""
    n = BLOCK_INTS + 77
    a = random_bitmap(n, 0.3, seed=4)
    b = random_bitmap(n, 0.3, seed=5)
    sa, sb = golden.encode(a), golden.encode(b)
    t1 = codec.logical(sa, sb, "and", n)
    t2 = codec.logical(sa, sb, "xor", n)
    got = codec.logical(t1, t2, "or", n)
    np.testing.assert_array_equal(got, golden.encode(a | b))


def test_logical_many_matches_pairwise():
    """logical_many (one batch decode + reduce + encode) equals the
    pairwise fold, on both encode paths."""
    from conftest import random_bitmap
    from wah_tpu import WahCodec, golden

    n = 2 * 992 + 100
    cols = [random_bitmap(n, d, seed=50 + i)
            for i, d in enumerate([1 / 64, 0.4, 0.0, 1 / 8])]
    streams = [golden.encode(c) for c in cols]
    expect = cols[0]
    for c in cols[1:]:
        expect = expect | c
    ref = golden.encode(expect)
    codec = WahCodec()
    got = codec.logical_many(streams, "or", n)
    np.testing.assert_array_equal(got, ref)
    # and/xor too
    ea = cols[0]
    ex = cols[0]
    for c in cols[1:]:
        ea = ea & c
        ex = ex ^ c
    np.testing.assert_array_equal(
        codec.logical_many(streams, "and", n), golden.encode(ea)
    )
    np.testing.assert_array_equal(
        codec.logical_many(streams, "xor", n), golden.encode(ex)
    )


def test_logical_many_nonpow2_fanin():
    """k=5 exercises the identity-stream padding to a pow2 tree: AND
    pads with all-ones streams, OR/XOR with all-zeros streams."""
    n = 992 + 37
    cols = [random_bitmap(n, d, seed=80 + i)
            for i, d in enumerate([0.02, 0.6, 0.0, 1.0, 1 / 32])]
    streams = [golden.encode(c) for c in cols]
    codec = WahCodec()
    for op, fold in (("or", np.bitwise_or), ("and", np.bitwise_and),
                     ("xor", np.bitwise_xor)):
        want = golden.encode(fold.reduce(cols))
        np.testing.assert_array_equal(
            codec.logical_many(streams, op, n), want, err_msg=op
        )


def test_logical_many_wide_fanin():
    """k=64 — real query fan-in; O(log k) tree depth."""
    n = 992 + 11
    cols = [
        random_bitmap(n, (0.03 if i % 3 else 0.5), seed=300 + i)
        for i in range(64)
    ]
    streams = [golden.encode(c) for c in cols]
    want = golden.encode(np.bitwise_or.reduce(cols))
    codec = WahCodec()
    np.testing.assert_array_equal(codec.logical_many(streams, "or", n), want)
    wanta = golden.encode(np.bitwise_and.reduce(cols))
    np.testing.assert_array_equal(
        codec.logical_many(streams, "and", n), wanta
    )
