"""BASELINE configs[4] at spec SIZE on the available hardware: a
64e9-bit (8 GB) bitmap sharded over an 8-device mesh, ordered gather,
bit-exact stitched output. This runs the FULL distributed pipeline —
block-sharded encode, (D,) totals all_gather, ordered stream gather,
span-sharded decode — at the spec'd data size on an 8-virtual-device
CPU mesh. It validates the mechanism at 64e9 bits (2e9 ints), not the
throughput of any device.

Execution is streamed through block-aligned SEGMENTS (16 x 4e9 bits),
each a full mesh encode/decode round: segment streams concatenate
exactly because fill runs never cross 1024-chunk blocks and segment
boundaries are block-aligned (same argument as api.compress_segments,
pinned by tests/test_api.py); every inter-segment seam is additionally
golden-verified word-exact in the gathered stream. Each segment stays
inside the 2^30-chunk limit of one call (api.MAX_CHUNKS), and the
segmenting bounds host RAM — the pure-XLA CPU shard body materializes ~a dozen
live span-sized intermediates per device, which at the full 2e9-int
span peaked past 117 GB RSS (OOM-killed). A mesh of GPUs would not
need it at this size: each of 8 devices would hold a 1 GB input shard.

    python -u -m benchmarks.config4_dryrun          # ~tens of minutes
Writes benchmarks/config4_cpu_mesh.json.
"""
from __future__ import annotations

import gc
import json
import os
import time

import numpy as np

OUT = os.path.join(os.path.dirname(__file__), "config4_cpu_mesh.json")
D = 8
SEGMENTS = 16
BITS = 64_000_000_000


def _rss_gb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS"):
                return int(line.split()[1]) / 1048576
    return 0.0


def _trim() -> None:
    """Return freed glibc-arena memory to the OS: the 8 XLA CPU device
    threads each churn ~GB buffers per segment and glibc retains freed
    chunks in per-thread arenas — RSS climbed ~15 GB/segment to an OOM
    kill at 106 GB even though live data was ~12 GB."""
    import ctypes

    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except OSError:
        pass


def main() -> None:
    import jax

    jax.config.update("jax_num_cpu_devices", D)
    jax.config.update("jax_platforms", "cpu")
    from jax.sharding import NamedSharding, PartitionSpec as P

    from wah_tpu import golden
    from wah_tpu.constants import BLOCK_CHUNKS, BLOCK_INTS
    from wah_tpu.golden import chunk_count
    from wah_tpu.parallel import dist

    from .report import generate_random_data

    n = BITS // 32  # 2e9 ints
    t0 = time.perf_counter()
    data = generate_random_data(n, 100)  # p = 0.01, configs[0] density
    t_gen = time.perf_counter() - t0
    print(f"datagen {n} ints in {t_gen:.1f} s", flush=True)

    nv = chunk_count(n)
    nb = -(-nv // BLOCK_CHUNKS)
    # segment size: ceil(nb/SEGMENTS) rounded up to a mesh multiple, so
    # every segment is block-aligned AND shardable
    nb_seg = -(-(-(-nb // SEGMENTS)) // D) * D  # ceil(ceil(nb/S)/D)*D
    seg_ints = nb_seg * BLOCK_INTS
    seg_chunks = nb_seg * BLOCK_CHUNKS

    mesh = dist.make_mesh(jax.devices())
    sharding = NamedSharding(mesh, P(dist.AXIS))

    t_put = t_enc = t_gather = t_dec = 0.0
    streams: list[np.ndarray] = []
    rt_ok = True
    seg_buf = np.zeros(seg_ints, dtype=np.uint32)
    for s in range(SEGMENTS):
        lo = s * seg_ints
        if lo >= n:
            break
        valid_ints = min(seg_ints, n - lo)
        nv_seg = int(min(seg_chunks, nv - s * seg_chunks))
        seg_buf[:valid_ints] = data[lo : lo + valid_ints]
        seg_buf[valid_ints:] = 0

        t0 = time.perf_counter()
        dev = jax.device_put(seg_buf, sharding)
        jax.block_until_ready(dev)
        t_put += time.perf_counter() - t0

        t0 = time.perf_counter()
        words, totals = dist.encode_sharded(mesh, dev, np.int32(nv_seg))
        jax.block_until_ready((words, totals))
        t_enc += time.perf_counter() - t0

        t0 = time.perf_counter()
        stream_s = dist.gather_stream(words, totals)
        t_gather += time.perf_counter() - t0
        del dev, words, totals
        gc.collect()

        # roundtrip this segment: span-sharded decode of its stream
        Mp = -(-len(stream_s) // 1024) * 1024
        wpad = np.zeros(Mp, np.uint32)
        wpad[: len(stream_s)] = stream_s
        t0 = time.perf_counter()
        ints, _ = dist.decode_sharded(
            mesh, jax.device_put(wpad), np.int32(len(stream_s)), seg_chunks
        )
        jax.block_until_ready(ints)
        t_dec += time.perf_counter() - t0
        out_seg = dist.gather_bitmap(ints, valid_ints)
        rt_ok = rt_ok and np.array_equal(out_seg, data[lo : lo + valid_ints])
        del ints, out_seg, wpad
        gc.collect()

        streams.append(stream_s)
        _trim()
        print(
            f"segment {s}: {len(stream_s)} words, roundtrip_ok={rt_ok}, "
            f"rss={_rss_gb():.1f} GB",
            flush=True,
        )

    seg_lens = [len(x) for x in streams]
    stream = np.concatenate(streams)
    del streams, seg_buf
    gc.collect()

    # bit-exactness vs the oracle: stream prefix == golden encode of a
    # block-aligned prefix (fills never cross 1024-chunk block
    # boundaries, so the words of the first kb blocks are identical in
    # both — exact, not fuzzy)
    kb = 2048
    gk = golden.encode(data[: kb * BLOCK_INTS])
    golden_ok = np.array_equal(stream[: len(gk)], gk)

    # every inter-segment seam, golden-verified in the CONCATENATED
    # stream (per-segment roundtrips alone can't see a misplaced seam):
    # the 2 blocks before boundary block b end exactly at the segment's
    # stream edge, the 2 after start exactly there — block independence
    # makes both windows word-exact against the oracle
    seams_ok = True
    edge = 0
    for s in range(1, len(seg_lens)):
        edge += seg_lens[s - 1]
        b = s * nb_seg
        lo, hi = (b - 2) * BLOCK_INTS, min((b + 2) * BLOCK_INTS, n)
        g_pre = golden.encode(data[lo : b * BLOCK_INTS])
        g_post = golden.encode(data[b * BLOCK_INTS : hi])
        seams_ok = (
            seams_ok
            and np.array_equal(stream[edge - len(g_pre) : edge], g_pre)
            and np.array_equal(stream[edge : edge + len(g_post)], g_post)
        )
    golden_ok = golden_ok and seams_ok

    res = {
        "metric": "config4_64e9bit_sharded_mesh_dryrun",
        "backend": "cpu-mesh-8dev (mechanism at spec size; pod perf is "
                   "projected in DESIGN.md)",
        "bits": BITS,
        "ints": n,
        "blocks": int(nb),
        "segments": SEGMENTS,
        "density": 0.01,
        "compressed_words": int(len(stream)),
        "ratio": round(len(stream) / n, 4),
        "golden_prefix_ok": bool(golden_ok),
        "roundtrip_ok": bool(rt_ok),
        "gen_s": round(t_gen, 1),
        "device_put_s": round(t_put, 1),
        "encode_s": round(t_enc, 1),
        "gather_s": round(t_gather, 1),
        "decode_s": round(t_dec, 1),
    }
    with open(OUT, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res))
    assert golden_ok and rt_ok


if __name__ == "__main__":
    main()
