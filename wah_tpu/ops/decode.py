"""Pure-JAX (XLA) WAH decoder.

The reference decode pipeline (getCounts -> scan -> decompressWords ->
mergeWords, decompress.cu:18-141, kernels.cu:291-385) as XLA passes. The
reference's load-imbalanced per-thread fill loops (kernels.cu:346-348)
become a scatter of each compressed word's index to its output start
position (the exclusive scan of the word counts), a cummax forward fill
of that index, and a gather of the covering word at every output chunk —
a fixed number of bandwidth-bound passes, perfectly balanced.

The core primitive is `decode_span`: expand an arbitrary window
[base, base + chunk_capacity) of the stream's chunk space. Because every
compressed word expands to >= 1 chunk, at most `chunk_capacity` words can
cover a span of that many chunks, so the span decoder windows the stream
with a gather of static size `chunk_capacity` — this is what makes
the sharded multi-device decoder (each shard owns a chunk range) possible
with fully static shapes.

Shapes are static: the caller supplies a chunk capacity; true sizes are
returned as traced scalars.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..constants import BIT31, BIT3130, LEN_MASK, ONES31
from . import bits

__all__ = [
    "word_counts",
    "decode_span",
    "decode_chunks",
    "decode",
    "decode_batch",
]

_U = jnp.uint32
_I = jnp.int32

# offset sentinel for window slots past the stream: no valid chunk offset
# is larger (a stream holds at most 2^30 chunks), and it is safe against
# int32 overflow
_FAR = 1 << 30


def word_counts(words: jnp.ndarray, m) -> jnp.ndarray:
    """Expanded chunk count per compressed word: fill -> run length,
    literal -> 1 (reference getCounts, kernels.cu:291-309); words at or
    beyond index m count 0."""
    i = jnp.arange(words.shape[0], dtype=_I)
    is_fill = (words & _U(BIT31)) != 0
    c = jnp.where(is_fill, (words & _U(LEN_MASK)).astype(_I), _I(1))
    return jnp.where(i < m, c, _I(0))


def expand_window(
    win_words: jnp.ndarray, off_local: jnp.ndarray, ok: jnp.ndarray
) -> jnp.ndarray:
    """Expand a word window into the (C,) chunk span it covers.

    win_words: (C,) compressed words; off_local: (C,) their start chunk
    positions relative to the span, clamped to [0, C] (strictly
    increasing over live words: only the head word can be clamped to 0);
    ok: live mask. The live words cover the span from chunk 0 without
    gaps, as a stream's words do. Returns chunks (C,) with garbage
    beyond the covered range (caller masks by span length).
    """
    C = win_words.shape[0]
    j = jnp.arange(C, dtype=_I)
    # each live word writes its window index + 1 at its start chunk
    # (starts are distinct); dead ones aim past the end, each at its own
    # index, and are dropped. cummax then gives every chunk its covering
    # word (0: none). Indices stay below C + 1, so nothing wraps.
    dest = jnp.where(ok, off_local, C + j)
    starts = jnp.zeros((C,), _I).at[dest].set(
        j + 1, mode="drop", unique_indices=True
    )
    cover = jax.lax.cummax(starts, axis=0)
    w = jnp.take(win_words, jnp.maximum(cover - 1, 0), mode="clip",
                 indices_are_sorted=True)
    # a literal covers only its own start chunk, so the chunk is the
    # literal there and the fill's value everywhere else
    is_fill = (w & _U(BIT31)) != 0
    is_ones = (w & _U(BIT3130)) == _U(BIT3130)
    val = jnp.where(is_fill, jnp.where(is_ones, _U(ONES31), _U(0)), w)
    return jnp.where(cover > 0, val, _U(0))


def decode_span(
    words: jnp.ndarray, m, base, chunk_capacity: int
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Expand chunks [base, base + chunk_capacity) of the stream words[:m].

    Returns (chunks (chunk_capacity,), n_chunks_total) where
    n_chunks_total is the full expanded length of the stream; span chunks
    at or beyond n_chunks_total - base are zero. `base` may be a traced
    scalar — this is the unit of work one shard owns in the distributed
    decoder.
    """
    M = words.shape[0]
    C = chunk_capacity
    words = words.astype(_U)
    base = jnp.asarray(base, dtype=_I)
    counts = word_counts(words, m)
    offsets = jnp.cumsum(counts, dtype=_I) - counts
    n_chunks = offsets[-1] + counts[-1]

    # last word starting at or before `base` (covers the span head)
    lo = jnp.clip(
        jnp.searchsorted(offsets, base, side="right").astype(_I) - 1,
        0,
        jnp.maximum(M - 1, 0),
    )

    # the window words[lo : lo + C], read past the end as padding (a
    # gather, so no padded copy of the stream is made)
    idx = lo + jnp.arange(C, dtype=_I)
    win_words = jnp.take(words, idx, mode="fill", fill_value=0,
                         unique_indices=True, indices_are_sorted=True)
    win_off = jnp.take(offsets, idx, mode="fill", fill_value=_FAR,
                       unique_indices=True, indices_are_sorted=True)
    win_cnt = word_counts(win_words, m - lo)

    ok = (idx < m) & (win_off < base + C) & (win_off + win_cnt > base)
    off_local = jnp.clip(win_off - base, 0, C)
    chunks = expand_window(win_words, off_local, ok)
    i = jnp.arange(C, dtype=_I)
    chunks = jnp.where(i < n_chunks - base, chunks, _U(0))
    return chunks, n_chunks


def decode_chunks(
    words: jnp.ndarray, m, chunk_capacity: int
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Expand words[:m] into 31-bit chunks.

    Returns (chunks (chunk_capacity,), n_chunks). Requires
    chunk_capacity >= n_chunks; chunks beyond n_chunks are zero. Fill
    words with zero run length are not produced by any WAH encoder and
    are unsupported here (the golden model and api layer validate
    streams).
    """
    return decode_span(words, m, 0, chunk_capacity)


def decode(
    words: jnp.ndarray, m, chunk_capacity: int
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Decompress words[:m] -> (ints (chunk_capacity//32*31,), n_ints).

    n_ints = ceil(31 * n_chunks / 32) (reference: decompress.cu:82-92);
    ints beyond n_ints are zero. chunk_capacity must be a multiple of 32.
    """
    assert chunk_capacity % 32 == 0, chunk_capacity
    chunks, n_chunks = decode_chunks(words, m, chunk_capacity)
    ints = bits.merge_chunks(chunks)
    # ceil(31*n/32) = n - n//32, overflow-free: 31*n_chunks wraps int32
    # past n_chunks = 69,273,666 (~268 MB bitmaps)
    n_ints = n_chunks - n_chunks // 32
    return ints, n_ints


def decode_batch(
    words: jnp.ndarray, ms: jnp.ndarray, chunk_capacity: int
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Decompress a batch of streams (bitmap-index columns).

    words: (C, M) uint32, row c holding stream c as a prefix of ms[c]
    words. Returns (ints (C, chunk_capacity//32*31), n_ints (C,)).
    """
    f = jax.vmap(lambda w, m: decode(w, m, chunk_capacity))
    return f(words.astype(_U), ms.astype(_I))

