"""Shared bitmap grid for the encode and decode tests.

The reference's crafted vectors (tests.cpp), Bernoulli densities 2^-1 to
2^-16, clustered (Zipfian) runs, fill runs that meet a block seam,
all-zeros and all-ones, and sizes that are not block multiples. Every
case is at most 64 blocks, so the CPU tests stay quick.
"""
import numpy as np

from conftest import clustered_bitmap, random_bitmap
from wah_tpu import golden
from wah_tpu.constants import BLOCK_CHUNKS, BLOCK_INTS, ONES, ONES31

U = np.uint32


def warp_pattern() -> np.ndarray:
    """Crafted warp pattern (reference: tests.cpp:23-31)."""
    d = np.zeros(31, dtype=U)
    d[0] = 8
    d[3] = U(4) << 28
    d[5] = U(63) << 26
    d[6] = ONES
    d[7] = U(ONES) >> 8
    return d


def wandering_pattern(blocks: int = 1) -> np.ndarray:
    """Single set bit sliding through each warp (reference: tests.cpp:33-39)."""
    d = np.zeros(BLOCK_INTS * blocks, dtype=U)
    for b in range(blocks):
        base = BLOCK_INTS * b
        d[base] = 1
        d[base + 31] = U(1) << 31
        for i in range(30):
            d[base + 31 + (i + 1) * 32] = U(1) << (30 - i)
    return d


def _every_other_warp(word_fn) -> np.ndarray:
    d = np.zeros(BLOCK_INTS, dtype=U)
    word_fn(d)
    return d


def _ones_starts(d):  # reference: tests.cpp:174-185
    for i in range(0, 32, 2):
        d[31 * i] = ONES


def _alternating(d):  # reference: tests.cpp:187-199
    for i in range(2, 32, 4):
        d[31 * i : 31 * i + 62] = ONES


def _final_literals(d):  # reference: tests.cpp:201-211
    for i in range(32):
        d[31 * (i + 1) - 1] = 88


def bitmap_of_chunks(chunks: np.ndarray) -> np.ndarray:
    """A bitmap whose 31-bit chunk sequence is exactly `chunks`."""
    return golden.merge_chunks(np.asarray(chunks, dtype=U))


def seam_runs(k: int) -> np.ndarray:
    """Two blocks of literals with a zero run of 2k+1 chunks across the
    block seam (it must split into fills of k and k+1) and a one run of
    up to k chunks before it in the first block."""
    rng = np.random.default_rng(100 + k)
    chunks = rng.integers(1, ONES31 - 1, size=2 * BLOCK_CHUNKS, dtype=U)
    lo = max(0, BLOCK_CHUNKS - k)
    chunks[lo : BLOCK_CHUNKS + k + 1] = 0
    chunks[5 : 5 + max(0, min(k, lo - 6))] = ONES31
    return bitmap_of_chunks(chunks)


CRAFTED = {
    "warp": warp_pattern,
    "block_of_warps": lambda: np.tile(warp_pattern(), 32),
    "ones_starts": lambda: _every_other_warp(_ones_starts),
    "alternating_runs": lambda: _every_other_warp(_alternating),
    "final_literals": lambda: _every_other_warp(_final_literals),
    "wandering_1": lambda: wandering_pattern(1),
    "wandering_2": lambda: wandering_pattern(2),
}

DENSITIES = {
    f"density_2^-{i}": (lambda i=i: random_bitmap(8 * BLOCK_INTS, 2.0 ** -i,
                                                  seed=i))
    for i in range(1, 17)
}

SHAPES = {
    "clustered": lambda: clustered_bitmap(16 * BLOCK_INTS, seed=5),
    "clustered_64_blocks": lambda: clustered_bitmap(64 * BLOCK_INTS, seed=6),
    "all_zeros": lambda: np.zeros(8 * BLOCK_INTS, dtype=U),
    "all_ones": lambda: np.full(8 * BLOCK_INTS, ONES, dtype=U),
    "odd_size": lambda: random_bitmap(3 * BLOCK_INTS + 345, 0.1, seed=6),
    "partial_warp": lambda: random_bitmap(31, 0.3, seed=5),
    "unaligned": lambda: random_bitmap(1000, 0.1, seed=11),
    "tiny": lambda: np.array([0x1, 0, 0, 0xFFFFFFFF], dtype=U),
    "incompressible": lambda: np.random.default_rng(42).integers(
        1, 2**32 - 1, size=8 * BLOCK_INTS, dtype=np.uint64).astype(U),
    "mixed_blocks": lambda: np.where(
        (np.arange(16 * BLOCK_INTS) // BLOCK_INTS) % 2 == 0,
        U(0),
        random_bitmap(16 * BLOCK_INTS, 0.4, seed=7),
    ).astype(U),
}

SEAMS = {f"seam_run_{1 << b}": (lambda b=b: seam_runs(1 << b))
         for b in range(11)}

GRID = {**CRAFTED, **DENSITIES, **SHAPES, **SEAMS}
