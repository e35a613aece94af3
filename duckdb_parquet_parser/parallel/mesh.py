"""Device mesh helpers.

The engine's parallel axis is *pages* (the scan analog of data parallelism —
SURVEY.md §2.1): page batches shard along a 1-D mesh axis "pages"; exchange
for the inverted-index build rides `all_to_all` over the same axis.  The
cards of a host are joined all to all, so the mesh follows the algorithm
alone.  One process drives every card of its host; multi-host
initialization is `jax.distributed.initialize` + the same mesh over
`jax.devices()`.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

PAGES_AXIS = "pages"


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(f"need {n_devices} devices, have {len(devs)}")
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (PAGES_AXIS,))


def pages_sharding(mesh: Mesh) -> NamedSharding:
    """Shard axis 0 (pages) across the mesh."""
    return NamedSharding(mesh, PartitionSpec(PAGES_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())


def distributed_init_from_env() -> bool:
    """Multi-host process-group init; returns True when a group formed.

    DPQ_COORDINATOR (+ DPQ_NUM_PROCESSES / DPQ_PROCESS_ID) is an explicit
    rendezvous that works on any backend incl. CPU (the two-process
    localhost smoke test in tests/test_multihost.py runs this way); without
    it the process runs alone (see the README "Multi-host launch" runbook).
    """
    import os

    if os.environ.get("DPQ_COORDINATOR"):
        jax.distributed.initialize(
            coordinator_address=os.environ["DPQ_COORDINATOR"],
            num_processes=int(os.environ.get("DPQ_NUM_PROCESSES", "1")),
            process_id=int(os.environ.get("DPQ_PROCESS_ID", "0")),
        )
        return True
    return False


def to_global_numpy(x) -> np.ndarray:
    """Materializes a (possibly cross-process sharded) jax.Array as a full
    numpy array on EVERY host — the result boundary for distributed ops.
    Single-process: a plain device_get."""
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(x, tiled=True))
    return np.asarray(x)


def survivor_mesh(mesh: Mesh, live: list[int]) -> Mesh:
    """A 1-D 'pages' mesh over the surviving device slots of `mesh`
    (elastic recovery re-runs orphaned shards on this)."""
    devs = list(np.asarray(mesh.devices).reshape(-1))
    return Mesh(np.array([devs[d] for d in live]), (PAGES_AXIS,))
