"""Child process for the real multi-process multihost test.

Invoked by test_multihost.py as
    python tests/_multihost_child.py <process_id> <num_processes> <port>

Each process brings up jax.distributed (CPU backend, 2 local virtual
devices), places its host-local rows of a shared global bitmap, runs the
full sharded pipeline (encode -> global stitch -> sharded decode), and
verifies bit-exactness against the golden model — the actual contract
multihost.py exists for, exercised without a cluster.
"""
import sys


def main() -> None:
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]

    import jax

    # CPU platform before any backend use (jax.distributed.initialize
    # must run before backend init — see multihost.initialize's guard).
    jax.config.update("jax_num_cpu_devices", 2)
    jax.config.update("jax_platforms", "cpu")

    import numpy as np

    from wah_tpu import golden
    from wah_tpu.constants import BLOCK_CHUNKS, BLOCK_INTS
    from wah_tpu.golden import chunk_count
    from wah_tpu.parallel import (
        decode_sharded,
        encode_sharded,
        estimate_word_cap,
        multihost,
        stitch_global,
    )

    multihost.initialize(
        coordinator_address=f"localhost:{port}",
        num_processes=nproc,
        process_id=pid,
    )
    assert jax.process_count() == nproc, jax.process_count()
    # idempotent: a second call must be a no-op, not a re-init crash
    multihost.initialize(
        coordinator_address=f"localhost:{port}",
        num_processes=nproc,
        process_id=pid,
    )

    mesh = multihost.global_mesh()
    D = mesh.size
    assert D == 2 * nproc, D

    # identical global bitmap on every process (seeded), mixed content
    nb = 4 * D
    rng = np.random.default_rng(42)
    data = (rng.random(nb * BLOCK_INTS) < 0.2).astype(np.uint32)
    data[: 2 * BLOCK_INTS] = 0  # leading zero-fill blocks
    ref = golden.encode(data)

    # each process places only its own contiguous rows (process order)
    rows = data.reshape(nb, BLOCK_INTS)
    per = nb // nproc
    local = np.ascontiguousarray(rows[pid * per : (pid + 1) * per]).reshape(-1)
    arr = multihost.host_shard_bitmap(mesh, local)

    nv = chunk_count(len(data))
    words, totals = encode_sharded(mesh, arr, nv)
    # bounded payload gather: the sample-based cap must hold for this
    # mixed bitmap (DCN traffic proportional to compressed size)
    cap_w = estimate_word_cap(data, nb // D)
    stream, total, overflow = stitch_global(mesh, words, totals, cap_w)
    assert not bool(jax.device_get(overflow)), "word_cap estimate overflowed"

    got = np.asarray(jax.device_get(stream))  # replicated on all hosts
    assert int(jax.device_get(total)) == len(ref), (int(total), len(ref))
    np.testing.assert_array_equal(got[: len(ref)], ref)

    # sharded decode: every process verifies its addressable shards
    cap = nb * BLOCK_CHUNKS
    ints, _ = decode_sharded(mesh, stream, total, cap)
    per_dev = (cap // 32 * 31) // D
    for shard in ints.addressable_shards:
        lo = shard.index[0].start or 0
        np.testing.assert_array_equal(
            np.asarray(shard.data), data[lo : lo + per_dev]
        )

    print(f"MULTIHOST_OK {pid}", flush=True)


if __name__ == "__main__":
    main()
