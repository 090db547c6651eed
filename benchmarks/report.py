"""Benchmark report generator — the reference's benchmark main
(reference: source.cpp:29-148).

Reproduces the same protocol: a size x density sweep (sizes s*1024
blocks with s doubling, densities 2^-i), `reps` repetitions per config
averaged, roundtrip asserted every iteration (source.cpp:103), rows
appended to a CSV with the reference's 11 columns (source.cpp:38-48)
plus derived GB/s columns. Append mode makes interrupted sweeps
resumable: completed (size, density) configs found in the existing
report are skipped (the reference's partial results survive the same
way through its append-mode results.txt, source.cpp:36).

Phase times are the codec's own (WahCodec's PhaseTimings: host clock
around each phase, ending in block_until_ready), on whatever device JAX
runs; the device is printed to stderr first.

Usage:
  python -m benchmarks.report --sizes 1 2 4 --densities 1 2 3 4 \
      --reps 3 --out results.txt
"""
from __future__ import annotations

import argparse
import csv
import os
import sys

import numpy as np

HEADER = [
    "Original size [Int]",
    "Compressed size [Int]",
    "Decompressed size [Int]",
    "Density",
    "Compression Ratio",
    "Compression transfer to device [ms]",
    "Compression time [ms]",
    "Compression transfer from device [ms]",
    "Decompression transfer to device [ms]",
    "Decompression time [ms]",
    "Decompression transfer from device [ms]",
    # extensions beyond the reference schema:
    "Compression throughput [GB/s]",
    "Decompression throughput [GB/s]",
]


def generate_random_data(n_ints: int, every_n: int, seed: int = 1337) -> np.ndarray:
    """Bernoulli bitmap with P(bit set) = 1/every_n (reference
    generateRandomData, tests.cpp:42-64, fixed seed 1337).

    Generated in slabs: the naive (n, 32) int64 draw would need ~66 GB
    for the 992 MB sweep config. PCG64 consumes its bit stream value by
    value, so slab-wise draws produce the identical bitmap (pinned by
    tests/test_report.py)."""
    rng = np.random.default_rng(seed)
    out = np.empty(n_ints, dtype=np.uint32)
    slab = 1 << 21
    for lo in range(0, n_ints, slab):
        hi = min(lo + slab, n_ints)
        bits = rng.integers(0, every_n, size=(hi - lo, 32), dtype=np.int64) == 0
        out[lo:hi] = (
            np.packbits(bits.astype(np.uint8), axis=1, bitorder="little")
            .view(np.uint32)
            .reshape(-1)
        )
    return out


def completed_configs(path: str) -> set[tuple[int, float]]:
    done = set()
    if not os.path.exists(path):
        return done
    with open(path) as f:
        for row in csv.reader(f):
            if not row or row[0].lstrip().startswith(("#", "Original")):
                continue
            try:
                done.add((int(row[0]), float(row[3])))
            except (ValueError, IndexError):
                continue
    return done


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--sizes", type=int, nargs="+",
                   default=[1, 2, 4, 8, 16, 32, 64, 128, 256],
                   help="s values; input = s*1024 blocks (reference "
                        "source.cpp:54)")
    p.add_argument("--densities", type=int, nargs="+",
                   default=list(range(1, 17)),
                   help="i values; P(bit) = 2^-i (reference source.cpp:57)")
    p.add_argument("--reps", type=int, default=10,
                   help="repetitions per config (reference source.cpp:70)")
    p.add_argument("--out", default="results.txt")
    p.add_argument("--seed", type=int, default=1337)
    args = p.parse_args(argv)

    from wah_tpu import WahCodec
    from wah_tpu.constants import BLOCK_INTS
    from wah_tpu.utils.device import card_line, device_info

    codec = WahCodec()
    print(f"device {device_info()} path {codec.path}", file=sys.stderr)
    if device_info()["platform"] == "gpu":
        print(card_line(), file=sys.stderr)
    done = completed_configs(args.out)
    new_file = not os.path.exists(args.out)
    f = open(args.out, "a", newline="")
    w = csv.writer(f)
    if new_file:
        w.writerow(HEADER)
        f.flush()

    for s in args.sizes:
        n = s * 1024 * BLOCK_INTS
        for i in args.densities:
            density = 2.0 ** (-i)
            if (n, density) in done:
                print(f"skip s={s} i={i} (already in {args.out})",
                      file=sys.stderr)
                continue
            data = generate_random_data(n, 1 << i, seed=args.seed)
            # untimed warmup: jit compilation happens per shape bucket
            # (the reference pays no compile cost; cudaEvent timings
            # would otherwise absorb it into the first rep)
            s0, _ = codec.compress(data)
            codec.decompress(s0, out_ints=n)
            acc = np.zeros(6)
            comp_size = 0
            for _ in range(args.reps):
                stream, ct = codec.compress(data)
                out, dt = codec.decompress(stream, out_ints=n)
                # roundtrip assert every iteration (source.cpp:103)
                assert np.array_equal(out, data), (s, i)
                comp_size = stream.shape[0]
                acc += [
                    ct.to_device_ms, ct.kernel_ms, ct.from_device_ms,
                    dt.to_device_ms, dt.kernel_ms, dt.from_device_ms,
                ]
            acc /= args.reps
            ratio = comp_size / n
            enc_gbps = data.nbytes / (acc[1] / 1e3) / 1e9
            dec_gbps = data.nbytes / (acc[4] / 1e3) / 1e9
            w.writerow(
                [n, comp_size, n, density, f"{ratio:.6f}"]
                + [f"{x:.4f}" for x in acc]
                + [f"{enc_gbps:.3f}", f"{dec_gbps:.3f}"]
            )
            f.flush()
            print(f"s={s} i={i}: ratio={ratio:.4f} "
                  f"enc={enc_gbps:.2f} GB/s dec={dec_gbps:.2f} GB/s",
                  file=sys.stderr)
    f.close()


if __name__ == "__main__":
    from wah_tpu.backend import enable_compile_cache

    enable_compile_cache()
    main()
