"""Multi-host helper tests (single-process: the bring-up is a no-op,
the mesh/data-placement helpers are exercised on the virtual CPU mesh)."""
import jax
import os
import numpy as np

from wah_tpu import golden
from wah_tpu.constants import BLOCK_INTS
from wah_tpu.golden import chunk_count
from wah_tpu.parallel import encode_sharded, gather_stream, multihost


def test_initialize_single_process_noop():
    multihost.initialize(num_processes=1)  # must not raise or distribute
    assert jax.process_count() == 1


def test_global_mesh_covers_all_devices():
    mesh = multihost.global_mesh()
    assert mesh.size == len(jax.devices())
    assert mesh.axis_names == ("blocks",)


def test_host_shard_bitmap_roundtrip():
    mesh = multihost.global_mesh()
    nb = mesh.size * 2
    data = (
        np.random.default_rng(3).random(nb * BLOCK_INTS) < 0.1
    ).astype(np.uint32)
    arr = multihost.host_shard_bitmap(mesh, data)
    assert arr.shape == data.shape
    np.testing.assert_array_equal(np.asarray(arr), data)
    # placed array feeds the sharded encoder directly
    words, totals = encode_sharded(mesh, arr, chunk_count(len(data)))
    np.testing.assert_array_equal(
        gather_stream(words, totals), golden.encode(data)
    )


def test_multihost_two_process_pipeline():
    """Real jax.distributed bring-up: 2 processes x 2 virtual CPU devices,
    full sharded encode -> stitch -> decode, bit-exact vs golden. Runs
    the distributed branch of multihost.initialize (the single-process
    tests above only hit the early returns)."""
    import socket
    import subprocess
    import sys
    from pathlib import Path

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    child = Path(__file__).with_name("_multihost_child.py")
    repo = child.parent.parent
    env = dict(os.environ)
    # APPEND the repo root (wah_tpu isn't installed); keep whatever
    # PYTHONPATH the caller set
    env["PYTHONPATH"] = os.pathsep.join(
        filter(None, [env.get("PYTHONPATH"), str(repo)])
    )
    procs = [
        subprocess.Popen(
            [sys.executable, str(child), str(pid), "2", str(port)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            cwd=str(repo),
            env=env,
        )
        for pid in range(2)
    ]
    outs = []
    for pid, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out}"
        assert f"MULTIHOST_OK {pid}" in out, out
