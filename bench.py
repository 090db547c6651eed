"""Headline benchmark: single-GPU WAH encode throughput.

Protocol mirrors the reference benchmark main (source.cpp:29-148): a
Bernoulli random bitmap of 130 MB (32,768 blocks; seed 1337, density
2^-4), roundtrip asserted against the input and the stream against the
native reference encoder. The reference times its kernels with
cudaEvents, excluding PCIe transfers (compress.cu:125-172); here the
kernel phase of WahCodec.compress is timed the same way: input already
on the device, host clock around the call and its block_until_ready.

Prints the card's name and power limit, then ONE JSON line:
  {"metric": "encode_throughput", "value": ..., "unit": "GB/s",
   "kernel_ms": ..., "device": {"platform", "kind", "count"}}
Exits non-zero when JAX finds no GPU. Run: python bench.py
"""
from __future__ import annotations

import json

import numpy as np


def main(reps: int = 20) -> None:
    from wah_tpu import WahCodec, golden, native
    from wah_tpu.backend import enable_compile_cache
    from wah_tpu.constants import BLOCK_INTS
    from wah_tpu.utils.device import card_line, require_gpu

    from benchmarks.report import generate_random_data

    device = require_gpu()
    print(card_line(), flush=True)
    enable_compile_cache()

    n = 32768 * BLOCK_INTS
    data = generate_random_data(n, 16, seed=1337)
    codec = WahCodec()
    stream, _ = codec.compress(data)  # compiles
    ref = native.encode(data) if native.available() else golden.encode(data)
    assert np.array_equal(stream, ref), "stream mismatch vs reference"
    out, _ = codec.decompress(stream, out_ints=n)
    assert np.array_equal(out, data), "roundtrip mismatch"

    kernel_ms = [codec.compress(data)[1].kernel_ms for _ in range(reps)]
    ms = float(np.median(kernel_ms))
    print(json.dumps({
        "metric": "encode_throughput",
        "value": data.nbytes / (ms / 1e3) / 1e9,
        "unit": "GB/s",
        "kernel_ms": ms,
        "path": codec.path,
        "device": device,
    }))


if __name__ == "__main__":
    main()
