"""Pure-JAX (XLA) WAH encoder.

The reference's warp/shared-memory hierarchy (compressData,
kernels.cu:51-262) re-expressed as vectorised masks and scans over a
(num_blocks, 1024) chunk array, and its scan-then-moveData stitch
(compress.cu:133-166, kernels.cu:273-280) as one scatter:

  repartition -> classify -> run starts / ends -> cumsum word slot ->
  cummax run start -> word values -> block-count exclusive scan ->
  scatter each run's word to offsets[block] + slot.

Semantics match the reference kernel exactly: complete run-length
coalescing of fill chunks within each 1024-chunk block, never across
blocks; literals always emitted verbatim (see golden.py and SURVEY.md
section 0.1). Output is (capacity,) uint32 plus a word count — all shapes
static, the compressed stream is the valid prefix (zero after it).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..constants import (
    BIT31,
    BIT3130,
    BLOCK_CHUNKS,
    BLOCK_INTS,
    ONES31,
    WORD_LITERAL,
    WORD_ONES,
    WORD_ZEROS,
)
from . import bits
from ..golden import chunk_count

__all__ = ["classify", "block_words", "encode_padded", "encode", "encode_batch"]

_U = jnp.uint32
_I = jnp.int32


def _shift(x: jnp.ndarray, k: int, fill) -> jnp.ndarray:
    """y[..., i] = x[..., i-k] along the last axis (k > 0: right, k < 0:
    left); positions shifted in from outside take `fill`."""
    pad = jnp.full((*x.shape[:-1], abs(k)), fill, dtype=x.dtype)
    if k > 0:
        return jnp.concatenate([pad, x[..., :-k]], axis=-1)
    return jnp.concatenate([x[..., -k:], pad], axis=-1)


def classify(chunks: jnp.ndarray) -> jnp.ndarray:
    """Chunk type: WORD_ZEROS / WORD_ONES / WORD_LITERAL
    (reference: kernels.cu:93-112)."""
    return jnp.where(
        chunks == _U(0),
        _I(WORD_ZEROS),
        jnp.where(chunks == _U(ONES31), _I(WORD_ONES), _I(WORD_LITERAL)),
    )


def block_words(chunks: jnp.ndarray, n_valid_chunks=None, chunk_base=0):
    """Per-chunk view of the (nb, 1024) blocks' words.

    Returns (value, end, slot, counts): the word of the run ending at
    each chunk (meaningful where `end`), whether the chunk ends a run,
    the run's word slot within its block, and each block's word count.
    `n_valid_chunks` (static or traced scalar) marks trailing padding
    chunks as non-emitting; `chunk_base` is the global chunk index of
    chunks[0, 0] (nonzero on shards of a distributed encode, where
    validity is judged against the global position).
    """
    nb, C = chunks.shape
    assert C == BLOCK_CHUNKS, chunks.shape
    if n_valid_chunks is None:
        n_valid_chunks = nb * C

    t = classify(chunks)
    col = jnp.arange(C, dtype=_I)
    gpos = (
        jnp.asarray(chunk_base, dtype=_I)
        + jnp.arange(nb, dtype=_I)[:, None] * C
        + col[None, :]
    )
    v = gpos < jnp.asarray(n_valid_chunks, dtype=_I)

    # run starts (reference run-end flags inverted; kernels.cu:126-141)
    prev_t = _shift(t, 1, -1)  # block-local: col 0 always starts
    start = v & ((t != prev_t) | (t == WORD_LITERAL))
    slot = jnp.cumsum(start, axis=-1, dtype=_I) - 1
    counts = jnp.sum(start, axis=-1, dtype=_I)
    # run ends: next chunk starts a new run, or is invalid / past block end
    end = v & (_shift(start, -1, True) | ~_shift(v, -1, False))

    # covering run start via cummax (replaces the per-lane backward walk
    # at kernels.cu:155-162 and the warp-merge machinery)
    run_start = jax.lax.cummax(jnp.where(start, col, _I(-1)), axis=1)
    run_len = (col - run_start + 1).astype(_U)
    value = jnp.where(
        t == WORD_LITERAL,
        chunks,
        jnp.where(
            t == WORD_ONES, _U(BIT3130) | run_len, _U(BIT31) | run_len
        ),
    )
    return value, end, slot, counts


def encode_padded(
    ints: jnp.ndarray, n_valid_chunks, chunk_base=0
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Compress a block-aligned (nb*992,) uint32 bitmap whose first
    `n_valid_chunks` (traced scalar allowed) chunks are live; trailing
    padding emits no words. Returns (words (nb*1024,), total_count).

    The block-count exclusive scan and one scatter replace
    thrust::exclusive_scan + moveData (compress.cu:133-166): the word of
    the run ending at chunk (b, i) lands at offsets[b] + slot[b, i]."""
    assert ints.shape[0] % BLOCK_INTS == 0, ints.shape
    nb = ints.shape[0] // BLOCK_INTS
    cap = nb * BLOCK_CHUNKS
    chunks = bits.repartition_chunks(ints.astype(_U)).reshape(nb, BLOCK_CHUNKS)
    value, end, slot, counts = block_words(chunks, n_valid_chunks, chunk_base)
    offsets = jnp.cumsum(counts, dtype=_I) - counts  # exclusive scan
    total = offsets[-1] + counts[-1]
    # chunks that end no run aim past the end, each at its own index,
    # so that every index is unique and the scatter drops them
    dest = jnp.where(
        end,
        offsets[:, None] + slot,
        cap + jnp.arange(cap, dtype=_I).reshape(nb, BLOCK_CHUNKS),
    )
    words = jnp.zeros((cap,), _U).at[dest.reshape(-1)].set(
        value.reshape(-1), mode="drop", unique_indices=True
    )
    return words, total


def encode_batch(
    ints: jnp.ndarray, n_valid_chunks
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Compress a batch of equal-length bitmap columns (the bitmap-index
    workload: one bitmap per indexed value).

    ints: (C, nb*992) uint32, each row a block-aligned column;
    n_valid_chunks applies to every column. Returns
    (words (C, nb*1024), totals (C,)). Columns are fully independent —
    the reference has no batched mode (one compress() call per column,
    compress.h:12); here the column axis is just a vmapped leading dim.
    """
    f = jax.vmap(lambda x: encode_padded(x, n_valid_chunks))
    words, totals = f(ints.astype(_U))
    return words, totals


def encode(ints: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Compress a (n,) uint32 bitmap -> (words (capacity,), total_count).

    capacity = ceil(chunk_count(n) / 1024) * 1024; the stream is
    words[:total_count]. Mirrors the reference host driver compress()
    (compress.cu:41-209) as a single fused XLA computation.
    """
    n = ints.shape[0]
    nv = chunk_count(n)
    nb = -(-nv // BLOCK_CHUNKS)
    ints = ints.astype(_U)
    padded = jnp.zeros(nb * BLOCK_INTS, dtype=_U).at[:n].set(ints)
    return encode_padded(padded, nv)

