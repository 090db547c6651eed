"""Smoke test of the codec on an NVIDIA GPU, through the user's entry points.

    python chip_smoke.py               # one card, all phases
    python chip_smoke.py --four-cards  # only the sharded codec over 4 cards

One process drives the card. Every phase compares bit-exactly with the
plain reference: streams with the native C++ encoder (golden.encode where
it cannot be built), bitmaps with the input, queries with a NumPy fold.
The phases, at sizes a bitmap index holds on one card:

  1. compress -> decompress of one 130 MB column (32,768 blocks) at
     densities 2^-4, 1e-4 and 0.5, and of Zipfian clustered runs;
  2. the reference sweep's largest bitmap, 992 MB, at 2^-4, and the
     largest bitmap one call takes, 2^20 blocks (4.16 GB, 2^30 chunks),
     at 2^-4;
  3. compress_batch / decompress_batch over 256 columns of 65 Mbit;
  4. logical_many (k=16, OR and AND) over 32.5 MB columns at 2^-8, a
     pairwise logical AND and complement_stream;
  5. timing of encode and decode at 130 MB: device time from a profiler
     trace, and end to end through WahCodec.

Each phase prints its wall time and the device's peak_bytes_in_use. The
last line is one JSON object: {"ok": true, "device": {...}}. Any failure
raises, so the script exits non-zero and prints no such line; so does a
machine where JAX finds no GPU.
"""
from __future__ import annotations

import argparse
import json
import tempfile
import time

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from wah_tpu import WahCodec, golden, native
from wah_tpu.api import MAX_INTS_PER_BITMAP
from wah_tpu.backend import enable_compile_cache
from wah_tpu.constants import BLOCK_CHUNKS, BLOCK_INTS
from wah_tpu.golden import chunk_count
from wah_tpu.ops.encode import encode_padded
from wah_tpu.ops.logical import complement_stream
from wah_tpu.utils.device import card_line, require_gpu
from wah_tpu.utils.profiling import device_time, trace

COLUMN_BLOCKS = 32768  # 130 MB: 32,768 x 992 uint32
SWEEP_MAX_BLOCKS = 256 * 1024  # 992 MB
BATCH_COLUMNS, BATCH_BLOCKS = 256, 2048  # 2,031,616 ints = 65 Mbit each
QUERY_K, QUERY_BLOCKS = 16, 8192  # 32.5 MB columns
TIMING_REPS = 10


def reference_encode(data: np.ndarray) -> np.ndarray:
    return native.encode(data) if native.available() else golden.encode(data)


def bernoulli(key, shape, density: float) -> jax.Array:
    """uint32 bitmap on the device, P(bit set) = density."""
    k = -np.log2(density)
    if k == int(k):  # 2^-k: AND of k uniform words
        keys = jax.random.split(key, int(k))
        x = jax.random.bits(keys[0], shape, jnp.uint32)
        for kk in keys[1:]:
            x = x & jax.random.bits(kk, shape, jnp.uint32)
        return x
    thr = jnp.uint32(round(density * 2**32))
    bits = jax.random.bits(key, (*shape, 32), jnp.uint32) < thr
    weights = jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(jnp.where(bits, weights, jnp.uint32(0)), axis=-1,
                   dtype=jnp.uint32)


def clustered(n_ints: int, seed: int, a: float = 1.5) -> np.ndarray:
    """Alternating 0/1 runs with Zipfian lengths in whole chunks (the
    distribution of tests/conftest.py's clustered_bitmap, drawn in bulk)."""
    rng = np.random.default_rng(seed)
    total = n_ints * 32
    lens = []
    have = 0
    while have < total:
        draw = np.minimum(rng.zipf(a, size=1 << 20), 1 << 22) * 31
        lens.append(draw)
        have += int(draw.sum())
    lens = np.concatenate(lens)
    lens = lens[: int(np.searchsorted(np.cumsum(lens), total)) + 1]
    vals = (np.arange(lens.shape[0]) & 1).astype(np.uint8)
    bits = np.repeat(vals, lens)[:total]
    return np.packbits(bits, bitorder="little").view(np.uint32)


class Phase:
    """Times a phase and reports its wall time and the device's peak
    memory; exceptions propagate."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        print(f"[{self.name}] start", flush=True)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, *_):
        if exc_type is None:
            stats = jax.devices()[0].memory_stats() or {}
            print(f"[{self.name}] ok wall_s={time.perf_counter() - self.t0:.3f}"
                  f" peak_bytes_in_use={stats.get('peak_bytes_in_use')}",
                  flush=True)


def check_column(codec: WahCodec, data: np.ndarray, label: str) -> None:
    stream, ct = codec.compress(data)
    ref = reference_encode(data)
    assert np.array_equal(stream, ref), f"{label}: stream != reference"
    out, dt = codec.decompress(stream, out_ints=len(data))
    assert np.array_equal(out, data), f"{label}: roundtrip mismatch"
    print(f"  {label}: {data.nbytes} B -> {stream.size} words "
          f"(ratio {stream.size / data.size:.4f}); compress kernel "
          f"{ct.kernel_ms:.3f} ms, decompress kernel {dt.kernel_ms:.3f} ms",
          flush=True)


def phase_columns(codec: WahCodec, seed: int) -> None:
    n = COLUMN_BLOCKS * BLOCK_INTS
    with Phase("1 column 130 MB"):
        for i, d in enumerate((2.0**-4, 1e-4, 0.5)):
            data = np.asarray(bernoulli(jax.random.PRNGKey(seed + i), (n,), d))
            check_column(codec, data, f"density {d:g}")
        check_column(codec, clustered(n, seed), "zipf clustered")
    with Phase("2 sweep max 992 MB"):
        data = np.asarray(bernoulli(jax.random.PRNGKey(seed + 10),
                                    (SWEEP_MAX_BLOCKS * BLOCK_INTS,), 2.0**-4))
        check_column(codec, data, "density 2^-4")
    with Phase("2b largest column 4.16 GB"):
        # past 2^29 chunks: chunk positions need all of int32's range
        data = np.asarray(bernoulli(jax.random.PRNGKey(seed + 11),
                                    (MAX_INTS_PER_BITMAP,), 2.0**-4))
        check_column(codec, data, "density 2^-4")


def phase_batch(codec: WahCodec, seed: int) -> None:
    with Phase("3 batch 256 x 65 Mbit"):
        n = BATCH_BLOCKS * BLOCK_INTS
        cols = np.asarray(bernoulli(jax.random.PRNGKey(seed + 20),
                                    (BATCH_COLUMNS, n), 2.0**-4))
        words, totals = codec.compress_batch(cols)
        for c in range(BATCH_COLUMNS):
            ref = reference_encode(cols[c])
            assert totals[c] == len(ref), f"column {c}: total"
            assert np.array_equal(words[c, : totals[c]], ref), f"column {c}"
        out = codec.decompress_batch(words, totals, out_ints=n)
        assert np.array_equal(out, cols), "batch roundtrip mismatch"
        print(f"  {cols.nbytes} B in {BATCH_COLUMNS} columns -> "
              f"{int(totals.sum())} words", flush=True)


def phase_queries(codec: WahCodec, seed: int) -> None:
    with Phase("4 queries k=16 over 32.5 MB columns"):
        n = QUERY_BLOCKS * BLOCK_INTS
        cols = np.asarray(bernoulli(jax.random.PRNGKey(seed + 30),
                                    (QUERY_K, n), 2.0**-8))
        streams = [reference_encode(c) for c in cols]
        for op, fold in (("or", np.bitwise_or), ("and", np.bitwise_and)):
            got = codec.logical_many(streams, op, n)
            want = reference_encode(fold.reduce(cols))
            assert np.array_equal(got, want), f"logical_many {op}"
        got = codec.logical(streams[0], streams[1], "and", n)
        assert np.array_equal(got, reference_encode(cols[0] & cols[1])), "and"
        s = streams[2]
        comp = np.asarray(jax.jit(complement_stream)(s, np.int32(len(s))))
        assert np.array_equal(golden.decode(comp, out_ints=n), ~cols[2]), "not"


def _device_seconds(fn, args, reps: int = 5) -> tuple[float, dict, list]:
    jax.block_until_ready(fn(*args))
    with tempfile.TemporaryDirectory() as d:
        with trace(d):
            for _ in range(reps):
                jax.block_until_ready(fn(*args))
        plane = next(iter(device_time(d).values()))
    top = dict(list(plane["kernels"].items())[:4])
    return (plane["busy_s"] / reps, {k: v / reps for k, v in top.items()},
            plane["lines"])


def phase_timing(codec: WahCodec, seed: int) -> None:
    """Encode and decode at 130 MB: device time (profiler trace of the
    jitted op on a device-resident input) and end to end (WahCodec wall
    time, host array in, host array out), with the API's kernel phase."""
    with Phase("5 timing 130 MB"):
        n = COLUMN_BLOCKS * BLOCK_INTS
        nv = np.int32(chunk_count(n))
        for d in (2.0**-4, 0.5):
            x = bernoulli(jax.random.PRNGKey(seed + 40), (n,), d)
            host = np.asarray(x)
            stream, _ = codec.compress(host)  # compile
            codec.decompress(stream, out_ints=n)
            e2e = {"encode": [], "decode": []}
            kern = {"encode": [], "decode": []}
            for _ in range(TIMING_REPS):
                t = time.perf_counter()
                stream, ph = codec.compress(host)
                e2e["encode"].append(time.perf_counter() - t)
                kern["encode"].append(ph.kernel_ms / 1e3)
                t = time.perf_counter()
                _, ph = codec.decompress(stream, out_ints=n)
                e2e["decode"].append(time.perf_counter() - t)
                kern["decode"].append(ph.kernel_ms / 1e3)
            m = len(stream)
            wp = np.zeros(1 << (m - 1).bit_length(), np.uint32)
            wp[:m] = stream
            dec = codec._decode_fn(wp.shape[0], COLUMN_BLOCKS * BLOCK_CHUNKS)
            runs = {
                "encode": (jax.jit(encode_padded), (x, nv)),
                "decode": (dec, (jax.device_put(wp), np.int32(m))),
            }
            for op, (fn, args) in runs.items():
                dev_s, top, lines = _device_seconds(fn, args)
                print("  timing " + json.dumps({
                    "op": op, "path": codec.path, "density": d,
                    "device_s": dev_s,
                    "e2e_s_median": float(np.median(e2e[op])),
                    "kernel_phase_s_median": float(np.median(kern[op])),
                    "gbps_device": host.nbytes / dev_s / 1e9, "top": top,
                    "trace_lines": lines,
                }), flush=True)


def phase_four_cards(seed: int) -> None:
    """ShardedCodec's pipeline over 4 GPUs with a 992 MB shard per card:
    encode_sharded -> stitch_global -> decode_sharded."""
    from wah_tpu.parallel import (
        AXIS, decode_sharded, encode_sharded, make_mesh, stitch_global,
        stitch_word_cap,
    )

    with Phase("four cards: sharded encode -> stitch -> decode"):
        devices = jax.devices()
        assert len(devices) == 4, f"need 4 GPUs, found {len(devices)}"
        mesh = make_mesh(devices)
        nb = 4 * SWEEP_MAX_BLOCKS
        n = nb * BLOCK_INTS
        nv = chunk_count(n)
        shard = NamedSharding(mesh, P(AXIS))
        x = jax.jit(lambda k: bernoulli(k, (n,), 2.0**-4),
                    out_shardings=shard)(jax.random.PRNGKey(seed + 50))
        words, totals = encode_sharded(mesh, x, np.int32(nv))
        cap_w = stitch_word_cap(totals)
        stream, total, overflow = stitch_global(mesh, words, totals, cap_w)
        assert not bool(overflow), "stitch overflow with the exact bound"
        ints, n_chunks = decode_sharded(mesh, stream, total, nb * BLOCK_CHUNKS)
        jax.block_until_ready((stream, ints))
        for name, arr in (("words", words), ("bitmap", ints)):
            devs = [str(s.device) for s in arr.addressable_shards]
            print(f"  {name} shards on {devs}", flush=True)
            assert len(set(devs)) == 4, f"{name} shards not on 4 devices"
        host = np.asarray(x)
        ref = reference_encode(host)
        assert int(total) == len(ref), "sharded total != reference"
        assert np.array_equal(np.asarray(stream)[: len(ref)], ref), "stream"
        assert int(np.asarray(n_chunks)[0]) == nv, "n_chunks"
        assert np.array_equal(np.asarray(ints)[:n], host), "roundtrip"
        print(f"  {host.nbytes} B over 4 cards -> {len(ref)} words, "
              "bit-exact", flush=True)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the sharded codec over 4 GPUs")
    p.add_argument("--seed", type=int, default=1337)
    args = p.parse_args()

    device = require_gpu()
    print(card_line(), flush=True)
    print(f"jax {jax.__version__}, {device}, compile cache "
          f"{enable_compile_cache()}, native reference "
          f"{native.available()}", flush=True)
    if args.four_cards:
        phase_four_cards(args.seed)
    else:
        codec = WahCodec()
        print(f"execution path: {codec.path}", flush=True)
        phase_columns(codec, args.seed)
        phase_batch(codec, args.seed)
        phase_queries(codec, args.seed)
        phase_timing(codec, args.seed)
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
