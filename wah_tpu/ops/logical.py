"""Compressed-domain logical operations on WAH streams.

WAH's purpose is bitmap indexes, whose queries are bitwise AND/OR/XOR/
ANDNOT across compressed columns (Andrzejewski & Wrembel target exactly
this workload; the reference repo ships only the codec). Binary ops
decode both operands into block chunk space, apply the op elementwise,
and re-encode — one jitted pipeline, all device-resident, whose cost
follows the uncompressed size.

NOT is complement: every literal flips, zero-fills and one-fills swap —
a pure stream rewrite with no decode at all (one vectorized pass over
the compressed words). Callers supply the bitmap's true bit length so
padding chunks stay zero.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..constants import BIT31, BIT3130, BLOCK_CHUNKS, BLOCK_INTS, ONES31
from . import decode as _dec
from .encode import encode_padded

__all__ = [
    "logical_op",
    "logical_reduce",
    "logical_reduce_flat",
    "complement_stream",
    "OPS",
]

_U = jnp.uint32
_I = jnp.int32

OPS = {
    "and": lambda a, b: a & b,
    "or": lambda a, b: a | b,
    "xor": lambda a, b: a ^ b,
    "andnot": lambda a, b: a & ~b,
}


def logical_op(
    words_a: jnp.ndarray,
    m_a,
    words_b: jnp.ndarray,
    m_b,
    op: str,
    n_ints: int,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """streams A, B (equal logical length n_ints) -> compressed A op B.

    Fully jittable: decode A and B to bitmaps, combine elementwise,
    re-encode — no host round trips. Returns (words, total) with the
    same dense-prefix contract as ops.encode.encode.
    """
    fn = OPS[op]
    from ..golden import chunk_count

    nv = chunk_count(n_ints)
    nb = -(-nv // BLOCK_CHUNKS)
    cap = nb * BLOCK_CHUNKS
    a, _ = _dec.decode(words_a.astype(_U), m_a, cap)
    b, _ = _dec.decode(words_b.astype(_U), m_b, cap)
    combined = fn(a, b)
    # mask bits beyond the true length (ANDNOT/ops with ~ could set
    # padding bits, which must encode as zero fills)
    pad_ints = nb * BLOCK_INTS
    i = jnp.arange(pad_ints, dtype=_I)
    last_bits = n_ints * 32  # bitmaps are whole uint32 words
    combined = jnp.where(i * 32 < last_bits, combined, _U(0))
    return encode_padded(combined[:pad_ints], nv)


def _identity_words(op: str, nv: int, M: int) -> tuple[jnp.ndarray, int]:
    """(M,) constant identity stream for op-padding a k-way reduce to a
    power-of-two fan-in: all-ones bitmap for AND, all-zeros for OR/XOR
    — as proper fill streams (one fill word per 1024-chunk block) so the
    flattened batch decoder's uniform-expansion contract holds for the
    padding columns too. Returns (words, word count)."""
    import numpy as np

    nb = -(-nv // BLOCK_CHUNKS)
    assert M >= nb, (M, nb)
    lens = np.full(nb, BLOCK_CHUNKS, np.uint32)
    lens[-1] = nv - (nb - 1) * BLOCK_CHUNKS
    hdr = np.uint32(BIT3130 if op == "and" else BIT31)
    out = np.zeros(M, np.uint32)
    out[:nb] = hdr | lens
    return jnp.asarray(out), nb


def logical_reduce(
    words2d: jnp.ndarray,
    ms: jnp.ndarray,
    op: str,
    n_ints: int,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """2-D (C, M) wrapper over logical_reduce_flat."""
    C, M = words2d.shape
    return logical_reduce_flat(
        words2d.reshape(C * M), C, ms, op=op, n_ints=n_ints
    )


def logical_reduce_flat(
    words_flat: jnp.ndarray,
    C: int,
    ms: jnp.ndarray,
    op: str,
    n_ints: int,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Fold C streams with an associative op (or/and/xor) -> one
    compressed stream. The index workload's k-way queries (query_in's
    OR over membership columns) pay ONE flattened batch decode + one
    elementwise reduce + ONE encode instead of k-1 pairwise
    decode+decode+encode pipelines (~3x less codec work for large k).

    The reduce is a TREE fold over halves of the decoded columns —
    O(log C) graph depth and at most 2x one decode output of extra
    element traffic — padded to a power-of-two fan-in with identity
    streams."""
    assert op in ("or", "and", "xor"), op  # andnot is not associative
    fn = OPS[op]
    from ..golden import chunk_count

    M = words_flat.shape[0] // C
    assert words_flat.shape[0] == C * M, (words_flat.shape, C)
    nv = chunk_count(n_ints)
    nb = -(-nv // BLOCK_CHUNKS)
    pad_ints = nb * BLOCK_INTS
    Cp = 1 << max(0, (C - 1).bit_length())
    if Cp != C:
        idw, mi = _identity_words(op, nv, M)
        words_flat = jnp.concatenate(
            [words_flat, jnp.tile(idw, Cp - C)]
        )
        ms = jnp.concatenate(
            [jnp.asarray(ms, _I), jnp.full((Cp - C,), mi, _I)]
        )
    ints2d, _ = _dec.decode_batch(
        words_flat.reshape(Cp, M), ms, chunk_capacity=nb * BLOCK_CHUNKS
    )
    c = Cp
    while c > 1:
        h = c // 2
        ints2d = fn(ints2d[:h], ints2d[h:])
        c = h
    acc = ints2d[0][:pad_ints]
    i = jnp.arange(pad_ints, dtype=_I)
    acc = jnp.where(i * 32 < n_ints * 32, acc, _U(0))
    return encode_padded(acc, nv)


def complement_stream(words: jnp.ndarray, m) -> jnp.ndarray:
    """NOT in the compressed domain: literals flip their payload bits,
    zero-fills become one-fills and vice versa — one vectorized pass,
    no decode. The caller owns trailing-bit semantics (a bitmap padded
    to whole chunks complements its padding too; re-mask on decode or
    follow with logical_op masking when exact tail bits matter).
    """
    words = words.astype(_U)
    is_fill = (words & _U(BIT31)) != 0
    flipped_literal = words ^ _U(ONES31)
    flipped_fill = words ^ _U(BIT3130 & ~BIT31)  # toggle the ones bit
    out = jnp.where(is_fill, flipped_fill, flipped_literal)
    i = jnp.arange(words.shape[0], dtype=_I)
    return jnp.where(i < jnp.asarray(m, _I), out, words)
