"""Multi-process scaffolding.

The reference is single-process/single-GPU (SURVEY §2.3). Here several
processes can share one render: initialize the JAX distributed runtime,
build a 2-D ``(host, chip)`` mesh, shard pixel tiles over BOTH axes
(forward rendering is embarrassingly parallel — zero collectives),
replicate the scene per device, and let shard_map's transpose insert the
parameter-gradient psum for inverse rendering.

One process driving all the cards of a host needs no initialize(). Several
processes call it once each, before any jax computation, naming the
coordinator themselves — nothing in the environment describes a cluster:

    from ray_tracer.parallel import distributed
    distributed.initialize("localhost:1234", num_processes=2, process_id=0)
    mesh = distributed.make_host_chip_mesh()
    img = render_frame_distributed(scene, basis, params, 0, mesh)
"""

from __future__ import annotations

import logging
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh

logger = logging.getLogger("ray_tracer.distributed")

HOST_AXIS = "host"
CHIP_AXIS = "chip"

_initialized = False


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> bool:
    """Initialize jax.distributed; returns True when the runtime is (now)
    initialized, False in a single-process environment with no
    coordinator. Idempotent: later calls return True without re-entering
    jax.distributed (which raises on a second initialization).

    Name the coordinator explicitly; failing to reach a named coordinator
    raises, since silently continuing single-process would have every
    process render the full image."""
    global _initialized
    if _initialized:
        return True
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id)
    except (RuntimeError, ValueError) as e:
        if "already initialized" in str(e).lower():
            _initialized = True
            return True
        if coordinator_address is not None or num_processes is not None:
            raise
        logger.info("jax.distributed not initialized (single-process): %s",
                    str(e).splitlines()[0])
        return False
    _initialized = True
    return True


def make_host_chip_mesh(devices=None) -> Mesh:
    """(host, chip) mesh: axis 0 spans processes, axis 1 the devices
    within each process. With one process this is (1, n_devices).

    Groups devices by their actual ``process_index`` (not a bare reshape,
    which silently mispairs when jax ever reorders) and requires an equal
    chip count per host — a DP pixel shard must exist on every host."""
    devices = list(jax.devices() if devices is None else devices)
    by_proc: dict = {}
    for d in devices:
        by_proc.setdefault(getattr(d, "process_index", 0), []).append(d)
    counts = {p: len(ds) for p, ds in by_proc.items()}
    if len(set(counts.values())) > 1:
        raise ValueError(
            f"uneven devices per process {counts}; pass an explicit "
            f"`devices` subset with equal chips per host")
    grid = np.array([by_proc[p] for p in sorted(by_proc)])
    return Mesh(grid, (HOST_AXIS, CHIP_AXIS))


def pixel_sharding_spec():
    """PartitionSpec for the flat pixel axis: split over host AND chip —
    (host·chip)-way data parallelism with scene replicated."""
    from jax.sharding import PartitionSpec as P
    return P((HOST_AXIS, CHIP_AXIS))
