"""Bit-repartition primitives: 32-bit words <-> 31-bit WAH chunks.

The reference warp-shuffle repartition (reference: kernels.cu:72-79
encode, kernels.cu:369-385 decode) as pure elementwise bit arithmetic —
no lane-crossing shuffles needed; the lane-neighbor terms become
statically shifted views of the same array.

Layout contract (reference: tests.cpp:94-97): logical bit i of the bitmap
is bit (i % 32), LSB-first, of uint32 word i // 32; chunk k holds logical
bits [31k, 31k+31) LSB-first in its low 31 bits.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..constants import ONES31, WARP_INTS

__all__ = ["repartition_chunks", "merge_chunks"]

_U = jnp.uint32


def repartition_chunks(ints: jnp.ndarray) -> jnp.ndarray:
    """(..., 31k) uint32 -> (..., 32k) uint32 31-bit chunks.

    Within each group of 31 input words ("warp" in the reference):
      chunk[x] = ONES31 & ((int[x-1] >> (32-x)) | (int[x] << x)),
    with int[-1] = int[31] = 0. The undefined shift-by-32 at x=0
    (reference: kernels.cu:79 relies on PTX clamping) is avoided by
    splitting the right shift.
    """
    assert ints.shape[-1] % WARP_INTS == 0, ints.shape
    w = ints.astype(_U).reshape(*ints.shape[:-1], -1, WARP_INTS)
    zcol = jnp.zeros((*w.shape[:-1], 1), dtype=_U)
    a = jnp.concatenate([w, zcol], axis=-1)  # int[x], a[31] = 0
    b = jnp.concatenate([zcol, w], axis=-1)  # int[x-1], b[0] = 0
    x = jnp.arange(32, dtype=_U)
    chunks = (((b >> (31 - x)) >> _U(1)) | (a << x)) & _U(ONES31)
    return chunks.reshape(*ints.shape[:-1], -1)


def merge_chunks(chunks: jnp.ndarray, carry=None) -> jnp.ndarray:
    """(..., 32k) uint32 31-bit chunks -> (..., 31k) uint32 words.

    Inverse of repartition_chunks:
      int[x] = (chunk[x] >> x) | (chunk[x+1] << (31-x)),  x in [0, 31),
    where chunk[32] is the next warp's chunk[0] (cross-group carry).
    `carry` supplies the chunk following the array (shape (..., ) scalarish
    per row, default 0) — used by the sharded decoder, where the chunk
    after a shard's range lives on the next shard.
    """
    assert chunks.shape[-1] % 32 == 0, chunks.shape
    c = chunks.astype(_U)
    if carry is None:
        last = jnp.zeros((*c.shape[:-1], 1), dtype=_U)
    else:
        last = jnp.broadcast_to(
            jnp.asarray(carry, dtype=_U), (*c.shape[:-1], 1)
        )
    nxt = jnp.concatenate([c[..., 1:], last], axis=-1)
    cw = c.reshape(*c.shape[:-1], -1, 32)
    nw = nxt.reshape(*c.shape[:-1], -1, 32)
    x = jnp.arange(31, dtype=_U)
    ints = (cw[..., :31] >> x) | (nw[..., :31] << (_U(31) - x))
    return ints.reshape(*c.shape[:-1], -1)
