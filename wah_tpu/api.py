"""Host-facing codec API — the reference's two public entry points
compress() / decompress() (reference: compress.h:12-18, decompress.h:11-17),
including their three phase timings per direction.

Differences by design:
  * device arrays are padded to static shape buckets (powers of two in
    blocks) so repeated calls hit the jit cache instead of recompiling;
  * the compressed stream is returned exactly sized (the valid prefix of
    the static-capacity device buffer), like the reference's exact-size
    host malloc (compress.cu:159-184);
  * non-block-multiple inputs are zero-padded to a 31-word multiple and
    encoded at chunk granularity — defined behavior where the reference
    is UB (SURVEY.md section 4.1.1-2).
"""
from __future__ import annotations

from functools import partial

import jax
import numpy as np

from . import backend
from .constants import BIT31, BLOCK_CHUNKS, BLOCK_INTS, LEN_MASK, ONES31
from .golden import chunk_count
from .ops import decode as _decode_ops
from .ops import encode as _encode_ops
from .utils.timing import PhaseTimer, PhaseTimings

__all__ = ["WahCodec", "compress", "decompress", "validate_stream"]


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


# Chunk positions are int32 throughout the ops, which also form
# position + capacity: a chunk capacity of at most 2^30 keeps both below
# 2^31. Capacities are powers of two in blocks, so one bitmap is capped at
# 2^20 blocks (1,040,187,392 ints, 4,160,749,568 B). Checked at every
# compress and decompress entry; larger bitmaps go through the *_segments
# methods.
MAX_CHUNKS = 1 << 30
MAX_INTS_PER_BITMAP = (MAX_CHUNKS // BLOCK_CHUNKS) * BLOCK_INTS


def _check_size(n: int) -> None:
    if n > MAX_INTS_PER_BITMAP:
        raise ValueError(
            f"bitmap of {n} ints exceeds the {MAX_INTS_PER_BITMAP}-int "
            "(2^30-chunk) limit of one call; use the *_segments methods"
        )


def _check_chunks(n_chunks: int) -> None:
    if n_chunks > MAX_CHUNKS:
        raise ValueError(
            f"stream expands to {n_chunks} chunks, past the 2^30-chunk "
            "limit of one call; use the *_segments methods"
        )


def validate_stream(words: np.ndarray) -> None:
    """Sanity-check a WAH stream against the format invariants
    (SURVEY.md section 0.1): no 0x0/0x7FFFFFFF words, fill lengths in
    [1, 1024]. The reference decoder checks nothing (decompress.cu:48-52)
    and expands corrupt streams into silent garbage; every decompress
    entry point here validates first."""
    words = np.asarray(words, dtype=np.uint32)
    if np.any(words == 0) or np.any(words == ONES31):
        raise ValueError("invalid WAH stream: contains literal-fill word")
    fills = words[(words & np.uint32(BIT31)) != 0]
    lens = fills & np.uint32(LEN_MASK)
    if fills.size and (lens.min() < 1 or lens.max() > BLOCK_CHUNKS):
        raise ValueError("invalid WAH stream: fill length out of range")


def checked_stream(words: np.ndarray) -> np.ndarray:
    """ascontiguousarray(uint32) + validation (native fast path when the
    C++ codec is built, else the NumPy check)."""
    words = np.ascontiguousarray(words, dtype=np.uint32)
    from . import native

    if native.available():
        native.validate(words)
    else:
        validate_stream(words)
    return words


class WahCodec:
    """Shape-bucketed, jit-cached WAH codec.

    kernel: "auto" (the platform's path, backend.execution_path) or
    "xla" (the plain jax.numpy ops).
    """

    def __init__(self, kernel: str = "auto"):
        backend.resolve(kernel)
        self._kernel = kernel
        # jit caches keyed by shape bucket (+ op variants)
        self._encode_fns: dict[tuple, object] = {}
        self._decode_fns: dict[tuple, object] = {}

    @property
    def path(self) -> str:
        return backend.resolve(self._kernel)

    def _encode_fn(self, nb: int):
        fn = self._encode_fns.get(nb)
        if fn is None:
            fn = jax.jit(_encode_ops.encode_padded)
            self._encode_fns[nb] = fn
        return fn

    def _decode_fn(self, M: int, cap: int):
        key = (M, cap)
        fn = self._decode_fns.get(key)
        if fn is None:
            fn = jax.jit(partial(_decode_ops.decode, chunk_capacity=cap))
            self._decode_fns[key] = fn
        return fn

    # -- batched columns (bitmap-index workload) ---------------------------
    def compress_batch(
        self, data: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        """Compress C equal-length bitmap columns at once.

        data: (C, n) uint32. Returns (words (C, cap), totals (C,));
        column c's stream is words[c, :totals[c]]. The reference would
        call compress() per column (compress.h:12)."""
        data = np.ascontiguousarray(data, dtype=np.uint32)
        C, n = data.shape
        if n == 0:
            return np.zeros((C, 0), np.uint32), np.zeros((C,), np.int64)
        _check_size(n)
        nv = chunk_count(n)
        nb = _next_pow2(-(-nv // BLOCK_CHUNKS))
        padded = np.zeros((C, nb * BLOCK_INTS), dtype=np.uint32)
        padded[:, :n] = data
        key = ("batch_enc", C, nb)
        fn = self._encode_fns.get(key)
        if fn is None:
            fn = jax.jit(_encode_ops.encode_batch)
            self._encode_fns[key] = fn
        words, totals = fn(jax.device_put(padded), np.int32(nv))
        return np.asarray(words), np.asarray(totals)

    def decompress_batch(
        self,
        words: np.ndarray,
        totals: np.ndarray,
        out_ints: int | None = None,
    ) -> np.ndarray:
        """Inverse of compress_batch: (words (C, M), totals (C,)) ->
        bitmaps (C, out_ints)."""
        words = np.ascontiguousarray(words, dtype=np.uint32)
        totals = np.asarray(totals)
        C, M = words.shape
        if M == 0:
            return np.zeros((C, 0), np.uint32)
        # per-word invariants hold column-wise on the valid prefixes
        live = np.arange(M)[None, :] < totals[:, None]
        validate_stream(words[live])
        is_fill = (words & np.uint32(BIT31)) != 0
        counts = np.where(is_fill & live, words & np.uint32(LEN_MASK), live)
        n_chunks = int(counts.sum(axis=1).max())
        _check_chunks(n_chunks)
        cap = _next_pow2(max(1, -(-n_chunks // BLOCK_CHUNKS))) * BLOCK_CHUNKS
        key = ("batch_dec", C, M, cap)
        fn = self._decode_fns.get(key)
        if fn is None:
            fn = jax.jit(partial(_decode_ops.decode_batch, chunk_capacity=cap))
            self._decode_fns[key] = fn
        ints, _ = fn(jax.device_put(words), totals.astype(np.int32))
        out = np.asarray(ints)
        if out_ints is not None:
            out = out[:, :out_ints]
        return out

    # -- compressed-domain logical ops (bitmap-index queries) --------------
    def logical(
        self,
        stream_a: np.ndarray,
        stream_b: np.ndarray,
        op: str,
        n_ints: int,
    ) -> np.ndarray:
        """A op B on compressed streams of equal logical length n_ints
        (op: and/or/xor/andnot). One fused device pipeline
        (decode + combine + re-encode); returns the compressed result."""
        from .ops import logical as _lops

        _check_size(n_ints)
        a = np.ascontiguousarray(stream_a, dtype=np.uint32)
        b = np.ascontiguousarray(stream_b, dtype=np.uint32)
        M = _next_pow2(max(len(a), len(b), 1024))
        pa = np.zeros(M, np.uint32)
        pa[: len(a)] = a
        pb = np.zeros(M, np.uint32)
        pb[: len(b)] = b
        key = ("logical", op, M, n_ints)
        fn = self._encode_fns.get(key)
        if fn is None:
            fn = jax.jit(partial(_lops.logical_op, op=op, n_ints=n_ints))
            self._encode_fns[key] = fn
        words, total = fn(
            jax.device_put(pa), np.int32(len(a)),
            jax.device_put(pb), np.int32(len(b)),
        )
        return np.asarray(words[: int(total)])

    def compress_segments(
        self, data: np.ndarray, segment_ints: int = BLOCK_INTS << 18
    ) -> np.ndarray:
        """Compress a bitmap of ANY size as block-aligned segments.

        The int32 chunk-position limit caps one compress() call at
        4,160,749,568 B (_check_size). Segments that are multiples of 992 ints
        start exactly at 1024-chunk block boundaries, and fill runs
        never cross those (SURVEY.md §0.1) — so concatenating the
        per-segment streams IS the whole bitmap's stream, bit-identical
        to a single golden encode."""
        data = np.ascontiguousarray(data, dtype=np.uint32)
        assert segment_ints % BLOCK_INTS == 0, segment_ints
        _check_size(segment_ints)
        if data.shape[0] <= segment_ints:
            return self.compress(data)[0]
        parts = [
            self.compress(data[i : i + segment_ints])[0]
            for i in range(0, data.shape[0], segment_ints)
        ]
        return np.concatenate(parts)

    def decompress_segments(
        self,
        words: np.ndarray,
        out_ints: int,
        segment_ints: int = BLOCK_INTS << 18,
    ) -> np.ndarray:
        """Inverse of compress_segments for streams of ANY size.

        Splits the stream at the word positions covering each
        segment's first chunk (exact: segment edges are block edges, so
        no fill crosses them), decodes each segment independently, and
        concatenates."""
        words = np.ascontiguousarray(words, dtype=np.uint32)
        assert segment_ints % BLOCK_INTS == 0, segment_ints
        if out_ints <= segment_ints:
            out, _ = self.decompress(words, out_ints=out_ints)
            return out
        bounds = self._segment_edges(words, out_ints, segment_ints)
        n_segs = len(bounds) - 1
        outs = []
        for s in range(n_segs):
            seg = words[bounds[s] : bounds[s + 1]]
            ni = min(segment_ints, out_ints - s * segment_ints)
            out, _ = self.decompress(seg, out_ints=ni)
            outs.append(out)
        return np.concatenate(outs)

    def compress_batch_segments(
        self, data: np.ndarray, segment_ints: int = BLOCK_INTS << 13
    ) -> list[np.ndarray]:
        """Batched columns of ANY length: (C, n) -> C exact per-column
        streams (BASELINE configs[3] is 256 columns x 1 Gbit = 32 GB
        logical, past both the 4.16 GB position cap and device memory).

        Segments are block-aligned (segment_ints % 992 == 0), so each
        column's concatenated per-segment streams ARE its whole-column
        stream, bit-identical to compress_segments / the golden model
        (fill runs never cross block boundaries, SURVEY.md §0.1). Each
        segment is one flattened batched-kernel call over all C columns."""
        data = np.ascontiguousarray(data, dtype=np.uint32)
        assert segment_ints % BLOCK_INTS == 0, segment_ints
        _check_size(segment_ints)
        C, n = data.shape
        if n <= segment_ints:
            words, totals = self.compress_batch(data)
            return [words[c, : totals[c]].copy() for c in range(C)]
        parts: list[list[np.ndarray]] = [[] for _ in range(C)]
        for lo in range(0, n, segment_ints):
            words, totals = self.compress_batch(
                data[:, lo : lo + segment_ints]
            )
            for c in range(C):
                parts[c].append(words[c, : totals[c]])
        return [np.concatenate(p) for p in parts]

    @staticmethod
    def _segment_edges(
        words: np.ndarray, out_ints: int, segment_ints: int
    ) -> list[int]:
        """Word boundaries splitting a stream at block-aligned segment
        edges (exact: no fill crosses them). Shared by the segmented
        single-stream and batched decoders."""
        is_fill = (words & np.uint32(BIT31)) != 0
        counts = np.where(
            is_fill, (words & np.uint32(LEN_MASK)).astype(np.int64), 1
        )
        ccum = np.cumsum(counts)
        seg_chunks = (segment_ints // BLOCK_INTS) * BLOCK_CHUNKS
        n_segs = -(-out_ints // segment_ints)
        edges_c = np.arange(1, n_segs, dtype=np.int64) * seg_chunks
        edges_w = np.searchsorted(ccum, edges_c, side="left") + 1
        if not np.array_equal(ccum[edges_w - 1], edges_c):
            raise ValueError(
                "stream does not split at block-aligned segment edges "
                "(wrong segment_ints, or not a WAH stream)"
            )
        return [0, *edges_w.tolist(), words.shape[0]]

    def decompress_batch_segments(
        self,
        streams: list[np.ndarray],
        out_ints: int,
        segment_ints: int = BLOCK_INTS << 13,
    ) -> np.ndarray:
        """Inverse of compress_batch_segments: C per-column streams ->
        (C, out_ints) bitmaps, segment by segment (every segment is one
        flattened batched decode; per-column expansions are equal within
        a segment because the columns share the segment length)."""
        assert segment_ints % BLOCK_INTS == 0, segment_ints
        C = len(streams)
        streams = [
            np.ascontiguousarray(s, dtype=np.uint32) for s in streams
        ]
        if out_ints <= segment_ints:
            M = max(len(s) for s in streams)
            w2 = np.zeros((C, M), np.uint32)
            totals = np.zeros((C,), np.int64)
            for c, s in enumerate(streams):
                w2[c, : len(s)] = s
                totals[c] = len(s)
            return self.decompress_batch(w2, totals, out_ints=out_ints)
        bounds = [
            self._segment_edges(s, out_ints, segment_ints) for s in streams
        ]
        n_segs = len(bounds[0]) - 1
        out = np.empty((C, out_ints), np.uint32)
        for s in range(n_segs):
            segs = [
                streams[c][bounds[c][s] : bounds[c][s + 1]]
                for c in range(C)
            ]
            ni = min(segment_ints, out_ints - s * segment_ints)
            M = max(len(x) for x in segs)
            w2 = np.zeros((C, M), np.uint32)
            totals = np.zeros((C,), np.int64)
            for c, x in enumerate(segs):
                w2[c, : len(x)] = x
                totals[c] = len(x)
            out[:, s * segment_ints : s * segment_ints + ni] = (
                self.decompress_batch(w2, totals, out_ints=ni)
            )
        return out

    def logical_many(
        self, streams, op: str, n_ints: int
    ) -> np.ndarray:
        """Fold k compressed streams with an associative op
        (or/and/xor) in ONE fused pipeline: flattened batch decode +
        elementwise reduce + one encode (vs k-1 pairwise logical()
        calls). Returns the compressed result."""
        streams = [
            np.ascontiguousarray(s, dtype=np.uint32) for s in streams
        ]
        assert streams, "empty stream set"
        if len(streams) == 1:
            return streams[0].copy()
        _check_size(n_ints)
        C = len(streams)
        M = _next_pow2(max(max(len(s) for s in streams), 1024))
        w2 = np.zeros((C, M), np.uint32)
        ms = np.zeros((C,), np.int32)
        for i, s in enumerate(streams):
            w2[i, : len(s)] = s
            ms[i] = len(s)
        from .ops import logical as _lops

        key = ("logical_many", op, C, M, n_ints)
        fn = self._encode_fns.get(key)
        if fn is None:
            fn = jax.jit(
                partial(_lops.logical_reduce_flat, C=C, op=op, n_ints=n_ints)
            )
            self._encode_fns[key] = fn
        words, total = fn(jax.device_put(w2.reshape(-1)), ms=ms)
        return np.asarray(words[: int(total)])

    # -- public API --------------------------------------------------------
    def compress(
        self, data: np.ndarray
    ) -> tuple[np.ndarray, PhaseTimings]:
        """Bitmap (uint32 array) -> (WAH stream, phase timings).

        Mirrors reference compress() (compress.cu:41-209).
        """
        data = np.ascontiguousarray(data, dtype=np.uint32)
        n = data.shape[0]
        if n == 0:
            return np.zeros(0, dtype=np.uint32), PhaseTimings()
        _check_size(n)
        nv = chunk_count(n)
        nb = -(-nv // BLOCK_CHUNKS)
        nb_b = _next_pow2(nb)
        padded = np.zeros(nb_b * BLOCK_INTS, dtype=np.uint32)
        padded[:n] = data

        t = PhaseTimer()
        t.start()
        dev = jax.device_put(padded)
        dev.block_until_ready()
        t.stop("to_device")

        fn = self._encode_fn(nb_b)
        t.start()
        words, total = fn(dev, np.int32(nv))
        jax.block_until_ready((words, total))
        t.stop("kernel")

        t.start()
        total = int(total)
        out = np.asarray(words[:total])
        t.stop("from_device")
        return out, t.timings

    def decompress(
        self, words: np.ndarray, out_ints: int | None = None
    ) -> tuple[np.ndarray, PhaseTimings]:
        """WAH stream -> (bitmap, phase timings).

        Default output length is ceil(31 * total_chunks / 32) words
        (reference: decompress.cu:82-92); pass `out_ints` to trim to the
        original un-padded length.
        """
        words = checked_stream(words)
        m = words.shape[0]
        if m == 0:
            return np.zeros(0, dtype=np.uint32), PhaseTimings()
        # host-side size precomputation (the reference syncs sizes
        # mid-pipeline too: decompress.cu:72-93)
        is_fill = (words & np.uint32(BIT31)) != 0
        n_chunks = int(
            np.where(is_fill, words & np.uint32(LEN_MASK), 1).sum()
        )
        _check_chunks(n_chunks)
        nb = max(1, -(-n_chunks // BLOCK_CHUNKS))
        cap = _next_pow2(nb) * BLOCK_CHUNKS
        M = min(_next_pow2(max(m, 1024)), cap)
        padded = np.zeros(M, dtype=np.uint32)
        padded[:m] = words

        t = PhaseTimer()
        t.start()
        dev = jax.device_put(padded)
        dev.block_until_ready()
        t.stop("to_device")

        fn = self._decode_fn(M, cap)
        t.start()
        ints, n_ints = fn(dev, np.int32(m))
        jax.block_until_ready((ints, n_ints))
        t.stop("kernel")

        t.start()
        n_ints = int(n_ints)
        out = np.asarray(ints[:n_ints])
        t.stop("from_device")
        if out_ints is not None:
            out = out[:out_ints]
        return out, t.timings


_default = WahCodec()


def compress(data: np.ndarray) -> tuple[np.ndarray, PhaseTimings]:
    return _default.compress(data)


def decompress(
    words: np.ndarray, out_ints: int | None = None
) -> tuple[np.ndarray, PhaseTimings]:
    return _default.decompress(words, out_ints=out_ints)
