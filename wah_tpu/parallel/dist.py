"""Multi-device sharded WAH codec: mesh + shard_map + XLA collectives.

The reference is single-process / single-GPU — it has no distributed
backend at all (SURVEY.md §2.2; the only "communication" is PCIe
cudaMemcpy, compress.cu:108,184). Here the 1024-chunk block axis (the
reference's CUDA grid axis, compress.cu:62-67) becomes a sharded mesh
axis over the devices (a 1-D mesh: every card of a host reaches every
other over NVLink at the same rate, so the mesh follows the algorithm).

Design (bit-identical to one device by construction):

  encode: bitmap blocks are sharded over the mesh; each shard runs the
    encoder (ops.encode.encode_padded) and stitches its own dense word
    stream. Because fill runs never cross a 1024-chunk block boundary
    (reference: tests.cpp:227-239) and shard boundaries are block-aligned,
    concatenating the shards' streams in mesh order *is* the single-device
    stream — the only cross-device data needed is the (D,) vector of
    per-shard word totals (an all_gather of a few bytes).

  decode: the compressed stream is small (by the compression ratio) —
    and stitch_global's word_cap bound keeps the all_gather that
    replicates it proportional to the compressed size, not the padded
    capacity — so it is replicated; each shard expands only its own chunk span
    [shard * chunks_l, (shard+1) * chunks_l) via ops.decode.decode_span
    and emits its slice of the bitmap. The one-chunk cross-shard carry
    needed by the 31->32-bit merge is decoded locally from the replicated
    stream (no neighbor exchange needed).

Output streams/bitmaps stay sharded on device; `gather_stream` /
`gather_bitmap` assemble the exact host arrays.
"""
from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..constants import BLOCK_CHUNKS, BLOCK_INTS
from ..golden import chunk_count
from ..ops import bits
from ..ops.decode import decode_span
from ..ops.encode import encode_padded

__all__ = [
    "make_mesh",
    "encode_sharded",
    "decode_sharded",
    "gather_stream",
    "gather_bitmap",
    "stitch_global",
    "stitch_word_cap",
    "estimate_word_cap",
    "ShardedCodec",
]

_U = jnp.uint32
_I = jnp.int32

AXIS = "blocks"


def make_mesh(devices=None) -> Mesh:
    """1-D mesh over the block axis — the codec's data-parallel axis."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (AXIS,))


# --------------------------------------------------------------------------
# encode
# --------------------------------------------------------------------------

def _encode_local(ints_l: jnp.ndarray, nv: jnp.ndarray):
    """Per-shard encode: (nb_l*992,) ints -> (nb_l*1024,) words, (1,) total.

    Chunk validity is judged against the global position, so padding on
    the last shards emits nothing."""
    nb_l = ints_l.shape[0] // BLOCK_INTS
    shard = jax.lax.axis_index(AXIS).astype(_I)
    chunk_base = shard * _I(nb_l * BLOCK_CHUNKS)
    words_l, total_l = encode_padded(ints_l.astype(_U), nv, chunk_base)
    return words_l, total_l[None]


def encode_sharded(
    mesh: Mesh,
    ints: jnp.ndarray,
    n_valid_chunks,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Distributed encode over `mesh`.

    ints: (nb*992,) uint32, nb divisible by mesh size, sharded (or
    shardable) over AXIS. Returns (words (nb*1024,) sharded — each
    shard's words are the dense prefix of its nb_l*1024 slice — and
    totals (D,), one word count per shard). The pair is the distributed
    representation of the stream; `gather_stream` assembles the exact
    single-device stream.
    """
    assert ints.shape[0] % (BLOCK_INTS * mesh.size) == 0, ints.shape
    f = _encode_shardmap(mesh)
    return f(ints.astype(_U), jnp.asarray(n_valid_chunks, dtype=_I))


@lru_cache(maxsize=64)
def _encode_shardmap(mesh: Mesh):
    """Cached jitted shard_map: rebuilding the wrapped callable per call
    defeats the jit cache, so a segment loop like
    benchmarks/config4_dryrun recompiled every iteration."""
    return jax.jit(jax.shard_map(
        _encode_local,
        mesh=mesh,
        in_specs=(P(AXIS), P()),
        out_specs=(P(AXIS), P(AXIS)),
    ))


def _stitch_global_local(
    words_l: jnp.ndarray, totals_l: jnp.ndarray, word_cap: int | None = None
):
    """Per-shard body: all_gather the shard streams and compact them into
    one replicated dense stream (the cross-device equivalent of the
    reference's thrust::exclusive_scan + moveData stitch,
    compress.cu:133-166). Communication: one all_gather of the (D,)
    totals + one of the word payload. word_cap (static) bounds
    the payload to the first word_cap words of each shard — the
    interconnect analogue of the reference's exact-size output alloc
    (compress.cu:159-166): never move dead capacity bytes. Totals are
    gathered FIRST, so the overflow check (any shard's live words exceed
    the bound) is a scalar compare on data already in hand."""
    totals = jax.lax.all_gather(totals_l, AXIS).reshape(-1)  # (D,)
    cap_l = words_l.shape[0]
    eff = cap_l if word_cap is None else min(int(word_cap), cap_l)
    overflow = (
        (jnp.max(totals) > _I(eff))[None]
        if eff < cap_l
        else jnp.zeros((1,), bool)
    )
    segs = jax.lax.all_gather(words_l[:eff], AXIS)  # (D, eff)
    D = segs.shape[0]
    offsets = jnp.cumsum(totals) - totals
    total = offsets[-1] + totals[-1]
    out = jnp.zeros(D * eff, dtype=_U)

    def body(d, out):
        # Each segment lands at its global offset; its garbage tail is
        # overwritten by the next segment (offsets are non-decreasing and
        # writes happen in shard order).
        return jax.lax.dynamic_update_slice(out, segs[d], (offsets[d],))

    out = jax.lax.fori_loop(0, D, body, out)
    col = jnp.arange(D * eff, dtype=_I)
    return jnp.where(col < total, out, _U(0)), total[None], overflow


def stitch_global(
    mesh: Mesh,
    words: jnp.ndarray,
    totals: jnp.ndarray,
    word_cap: int | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Sharded (words, totals) -> (replicated dense stream, total,
    overflow).

    Jit-safe device-side equivalent of gather_stream: after this, every
    device holds the full compressed stream, ready for sharded decode or
    host offload.

    word_cap: static per-shard payload bound in words (None = full
    capacity). Without it the all_gather moves each shard's whole
    nb_l*1024-word capacity buffer regardless of how little is live —
    ~6x the compressed bytes at ratio 0.22. Pass stitch_word_cap(totals)
    (exact, needs the tiny (D,) totals on host) or
    estimate_word_cap(data, nb_l) (sample-based, no device sync) to make
    interconnect traffic proportional to compressed size. overflow is a
    replicated bool scalar: True iff some shard's live words exceed
    word_cap, in which case the stream is truncated garbage and the
    caller must retry with a larger bound (total is always correct — it
    comes from the totals gather, not the payload).
    """
    stream, total, ovf = _stitch_shardmap(mesh, word_cap)(words, totals)
    return stream, total[0], ovf[0]


def stitch_word_cap(totals) -> int:
    """Exact static payload bound from the per-shard totals (host): the
    max live word count, rounded up to a 1024-word tile."""
    t = int(np.max(np.asarray(totals)))
    return max(1024, -(-t // 1024) * 1024)


def estimate_word_cap(data: np.ndarray, nb_l: int) -> int:
    """Sample-based static payload bound from the RAW bitmap (host, no
    device sync), from a strided sample of the bitmap.

    Per 1024-chunk block, words = literals + fill runs and consecutive
    fill runs are separated by >=1 literal, so words <= 2*literals + 1.
    The sampled nonzero-word fraction f approximates the non-zero-chunk
    fraction (literals + one-fills), giving the per-block estimate
    min(1024, 2048*f + 64) with margin for sampling noise. Not a hard
    guarantee (stitch_global's overflow flag covers the residual): a
    shard whose data is locally much denser than the global sample can
    exceed it."""
    step = max(1, data.shape[0] >> 16)
    sample = data[::step]
    f = np.count_nonzero(sample) / max(1, sample.shape[0])
    per_block = min(BLOCK_CHUNKS, int(2048 * f) + 64)
    return max(1024, -(-nb_l * per_block // 1024) * 1024)


@lru_cache(maxsize=64)
def _stitch_shardmap(mesh: Mesh, word_cap: int | None = None):
    """Cached jitted shard_map (see _encode_shardmap)."""
    # check_vma=False: the outputs ARE replicated (every shard computes the
    # same stitch from the same all_gathered segments), but the dynamic
    # update-slice loop defeats static replication inference.
    return jax.jit(jax.shard_map(
        partial(_stitch_global_local, word_cap=word_cap),
        mesh=mesh,
        in_specs=(P(AXIS), P(AXIS)),
        out_specs=(P(), P(), P()),
        check_vma=False,
    ))


def gather_stream(words: jax.Array, totals: jax.Array) -> np.ndarray:
    """Assemble the dense host stream from the sharded (words, totals)."""
    words = np.asarray(words)
    totals = np.asarray(totals)
    d = totals.shape[0]
    cap_l = words.shape[0] // d
    return np.concatenate(
        [words[i * cap_l : i * cap_l + totals[i]] for i in range(d)]
    )


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------

def _decode_local(words: jnp.ndarray, m: jnp.ndarray, chunks_l: int):
    """Per-shard decode of chunk span [shard*chunks_l, (shard+1)*chunks_l).

    words is replicated. Returns (ints_l (chunks_l//32*31,), n_chunks (1,)).
    """
    shard = jax.lax.axis_index(AXIS).astype(_I)
    base = shard * _I(chunks_l)
    # +32 capacity: one extra warp of chunks so chunk[chunks_l] (the
    # cross-shard merge carry, reference: kernels.cu:377) decodes locally
    chunks_ext, n_chunks = decode_span(words, m, base, chunks_l + 32)
    ints_l = bits.merge_chunks(chunks_ext[:chunks_l], carry=chunks_ext[chunks_l])
    return ints_l, n_chunks[None]


def decode_sharded(
    mesh: Mesh,
    words: jnp.ndarray,
    m,
    chunk_capacity: int,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Distributed decode: replicated stream -> block-sharded bitmap.

    chunk_capacity: static upper bound on expanded chunks, divisible by
    32 * mesh size (block-aligned shards recommended). Returns
    (ints (chunk_capacity//32*31,) sharded over AXIS, n_chunks (D,)
    replicated total per shard).
    """
    D = mesh.size
    assert chunk_capacity % (32 * D) == 0, (chunk_capacity, D)
    chunks_l = chunk_capacity // D
    f = _decode_shardmap(mesh, chunks_l)
    return f(words.astype(_U), jnp.asarray(m, dtype=_I))


@lru_cache(maxsize=64)
def _decode_shardmap(mesh: Mesh, chunks_l: int):
    """Cached jitted shard_map (see _encode_shardmap)."""
    return jax.jit(jax.shard_map(
        partial(_decode_local, chunks_l=chunks_l),
        mesh=mesh,
        in_specs=(P(), P()),
        out_specs=(P(AXIS), P(AXIS)),
        check_vma=False,
    ))


def gather_bitmap(ints: jax.Array, n_ints: int) -> np.ndarray:
    """Trim the sharded bitmap to its true length on host."""
    return np.asarray(ints)[:n_ints]


# --------------------------------------------------------------------------
# host-facing convenience codec
# --------------------------------------------------------------------------

class ShardedCodec:
    """Host API over the sharded codec (mirrors api.WahCodec, N devices)."""

    def __init__(self, mesh: Mesh | None = None):
        self.mesh = mesh if mesh is not None else make_mesh()
        self._dec_cache: dict[int, object] = {}

    def compress(self, data: np.ndarray) -> np.ndarray:
        data = np.ascontiguousarray(data, dtype=np.uint32)
        n = data.shape[0]
        if n == 0:
            return np.zeros(0, dtype=np.uint32)
        from ..api import _check_size

        _check_size(n)
        D = self.mesh.size
        nv = chunk_count(n)
        nb = -(-nv // BLOCK_CHUNKS)
        nb = -(-nb // D) * D
        padded = np.zeros(nb * BLOCK_INTS, dtype=np.uint32)
        padded[:n] = data
        sharding = NamedSharding(self.mesh, P(AXIS))
        dev = jax.device_put(padded, sharding)
        words, totals = encode_sharded(self.mesh, dev, np.int32(nv))
        return gather_stream(words, totals)

    def decompress(
        self, words: np.ndarray, out_ints: int | None = None
    ) -> np.ndarray:
        from ..api import checked_stream

        words = checked_stream(words)
        m = words.shape[0]
        if m == 0:
            return np.zeros(0, dtype=np.uint32)
        from ..api import _check_chunks, _next_pow2  # shared policy
        from ..constants import BIT31, LEN_MASK

        is_fill = (words & np.uint32(BIT31)) != 0
        n_chunks = int(
            np.where(is_fill, words & np.uint32(LEN_MASK), 1).sum()
        )
        _check_chunks(n_chunks)
        D = self.mesh.size
        nb = max(D, -(-n_chunks // BLOCK_CHUNKS))
        nb = -(-_next_pow2(nb) // D) * D
        cap = nb * BLOCK_CHUNKS
        M = min(_next_pow2(max(m, 1024)), cap)
        padded = np.zeros(M, dtype=np.uint32)
        padded[:m] = words
        fn = self._dec_cache.get((M, cap))
        if fn is None:
            fn = jax.jit(
                partial(decode_sharded, self.mesh, chunk_capacity=cap)
            )
            self._dec_cache[(M, cap)] = fn
        ints, n_chunks_dev = fn(jax.device_put(padded), m=np.int32(m))
        n_ints = (31 * int(np.asarray(n_chunks_dev)[0]) + 31) // 32
        out = gather_bitmap(ints, n_ints)
        if out_ints is not None:
            out = out[:out_ints]
        return out
