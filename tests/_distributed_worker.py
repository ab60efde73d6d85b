"""Worker for the REAL multi-process jax.distributed test (VERDICT r4 #6).

Spawned by tests/test_distributed.py::test_initialize_multi_process as 2
processes x 4 virtual CPU devices each. Exercises the actual multi-host
code path — ``distributed.initialize()`` with explicit coordinator args,
``make_host_chip_mesh`` built from real per-process device groups, and a
sharded render whose pixel shards live on two processes — which the
in-process 8-device harness can never reach (its process_index is always
0). Prints one line of JSON and exits 0 on success.

Usage: python tests/_distributed_worker.py <process_id> <port>
"""

import json
import os
import sys

# 4 virtual CPU devices per process, forced BEFORE backend init; the
# platform is set through jax.config so the worker stays on the CPU
# whatever the parent's environment says.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=4").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402


def main() -> None:
    process_id = int(sys.argv[1])
    port = int(sys.argv[2])

    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    import ray_tracer as rt
    from ray_tracer.parallel import distributed, render_frame_distributed
    from ray_tracer.renderer import render_frame

    # the code under test: the explicit-coordinator branch of initialize()
    ok = distributed.initialize(
        coordinator_address=f"localhost:{port}",
        num_processes=2,
        process_id=process_id)
    assert ok, "initialize() returned False with explicit coordinator args"
    assert distributed.initialize(), "second initialize() not idempotent"

    assert jax.process_count() == 2, jax.process_count()
    assert jax.local_device_count() == 4, jax.local_device_count()
    assert jax.device_count() == 8, jax.device_count()

    mesh = distributed.make_host_chip_mesh()
    assert mesh.axis_names == (distributed.HOST_AXIS, distributed.CHIP_AXIS)
    assert mesh.devices.shape == (2, 4), mesh.devices.shape
    for row in mesh.devices:
        assert len({d.process_index for d in row}) == 1, "mixed-host row"

    # sharded render across both processes vs a process-local render
    scene, cam = rt.builtin_scene("metal", aspect=1.0, pad=8)
    params = rt.RenderParams(width=16, height=16, bounces=1, skybox=True,
                             backend="jnp")
    basis = rt.camera_basis(cam)
    img_d = render_frame_distributed(scene, basis, params, 0, mesh)

    from jax.experimental import multihost_utils
    img_full = np.asarray(
        multihost_utils.process_allgather(img_d, tiled=True))
    img_ref = np.asarray(render_frame(scene, basis, params, jnp.int32(0)))
    max_diff = float(np.abs(img_full - img_ref).max())
    assert max_diff <= 1e-5, f"sharded render mismatch: {max_diff}"

    print(json.dumps({
        "process_id": process_id,
        "process_count": jax.process_count(),
        "mesh_shape": list(mesh.devices.shape),
        "max_diff": max_diff,
        "ok": True,
    }))


if __name__ == "__main__":
    main()
