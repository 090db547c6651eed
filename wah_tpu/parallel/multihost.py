"""Multi-host (multi-process) support: jax.distributed bring-up and
host-local input/output helpers for the sharded codec.

The reference is strictly single-process (SURVEY.md §2.2); this module
is the scale-out path: one process per host, the GPUs of a host joined
by NVLink and hosts by the network, with the codec's block axis sharded
over every device in the job. Stream assembly is exactly the
single-device stream because shard boundaries are block-aligned
(tests.cpp:227-239 pins no-merge-across-blocks).

Usage (one process per host):

    from wah_tpu.parallel import multihost
    multihost.initialize()                  # jax.distributed bring-up
    mesh = multihost.global_mesh()          # 1-D mesh over ALL devices
    codec = ShardedCodec(mesh)              # works as on one host

Testing without a cluster: the sharded codec itself is mesh-size agnostic
and is exercised on an 8-virtual-device CPU mesh in tests/test_dist.py;
this module only adds the process-group bring-up glue, which follows
the standard jax.distributed contract.
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .dist import AXIS

__all__ = ["initialize", "global_mesh", "host_shard_bitmap"]


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Bring up the JAX process group (no-op for single-process jobs).

    With no arguments, relies on jax.distributed's auto-detection of the
    cluster environment; where nothing describes a cluster, pass
    coordinator_address ("host:port"), num_processes and process_id.
    """
    if num_processes is not None and num_processes <= 1:
        return
    # Already-initialized guard. Must NOT call jax.process_count() here:
    # that would initialize the single-process local backend before
    # jax.distributed.initialize() runs, defeating the bring-up this
    # function exists for. Check the distributed client state directly.
    from jax._src import distributed as _jdist

    if getattr(_jdist.global_state, "client", None) is not None:
        return
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def global_mesh() -> Mesh:
    """1-D mesh over every device in the job, in (process, local-device)
    order so stream order == process order (deterministic assembly)."""
    return Mesh(np.asarray(jax.devices()), (AXIS,))


def host_shard_bitmap(mesh: Mesh, host_ints: np.ndarray) -> jax.Array:
    """Place this host's slice of a globally block-aligned bitmap.

    host_ints: the rows of the global (nb, 992) bitmap owned by this
    process (equal-sized contiguous slices in process order). Returns
    the global sharded array via make_array_from_process_local_data.
    """
    sharding = NamedSharding(mesh, P(AXIS))
    return jax.make_array_from_process_local_data(
        sharding, np.ascontiguousarray(host_ints, dtype=np.uint32)
    )
