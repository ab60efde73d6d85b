"""Device mesh helpers.

The reference is strictly single-device (SURVEY §2.3); scaling is a
first-class new component here: a 1-D ``jax.sharding.Mesh`` over all
devices, pixel tiles sharded, scene replicated. The cards of one host are
joined all to all, so the mesh follows the algorithm alone.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh

AXIS = "devices"


def make_mesh(n_devices: Optional[int] = None, axis: str = AXIS) -> Mesh:
    """1-D mesh over the first ``n_devices`` devices (all by default)."""
    devs = jax.devices()
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(f"requested {n_devices} devices, have {len(devs)}")
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def shard_map_fn(fn, mesh: Mesh, in_specs, out_specs):
    """``jax.shard_map`` with varying-axes checking off: the render body
    contains pallas_call, whose out_shapes carry no varying-axes metadata,
    and the body has no collectives for the check to validate (forward
    rendering is embarrassingly parallel; the gradient psum is inserted by
    shard_map's own transpose)."""
    return jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)
