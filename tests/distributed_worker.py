"""Worker process for the 2-process ``jax.distributed`` test (SURVEY §2.4
multihost orchestration row).  Launched by tests/test_distributed.py as
``python tests/distributed_worker.py <outdir>`` with the coordinator env vars
(JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID) set by the
parent — the exact contract ``parallel.mesh.maybe_initialize_distributed``
triggers on (mesh.py:24-49).

Each process owns 2 virtual CPU devices; the 4-device 'pairs' mesh spans both
processes, so the sharded GICP's collectives actually cross a process
boundary (gloo).  Process 0 writes the gathered result for the parent to
compare against a single-process run.
"""

import os
import sys


def main() -> int:
    outdir = sys.argv[1]
    import jax  # JAX_PLATFORMS=cpu comes from the parent's environment

    # mesh imports lazily (parallel/__init__ is PEP-562): nothing touches the
    # XLA backend before jax.distributed.initialize runs inside
    # maybe_initialize_distributed — the ordering jax requires.
    from pcr_tpu.parallel import mesh as mesh_mod

    assert mesh_mod.maybe_initialize_distributed(), "expected multi-process"
    assert jax.process_count() == 2, jax.process_count()
    assert jax.local_device_count() == 2, jax.local_device_count()
    assert len(jax.devices()) == 4

    import numpy as np
    import jax.numpy as jnp
    from jax.experimental import multihost_utils

    from pcr_tpu.ops import normals as normals_ops
    from pcr_tpu.parallel import pair_sharding
    from pcr_tpu.utils import cloud

    # Identical seeded data in both processes (replicated host input).
    rng = np.random.default_rng(0)
    B = 4
    srcs, tgts = [], []
    for _ in range(B):
        pts = rng.uniform(-1, 1, size=(300, 3)).astype(np.float32)
        srcs.append(normals_ops.with_normals_knn(
            cloud.from_numpy(pts, capacity=320), 10))
        tgts.append(normals_ops.with_normals_knn(
            cloud.from_numpy(pts + np.float32(0.05), capacity=320), 10))
    src = cloud.stack_clouds(srcs)
    tgt = cloud.stack_clouds(tgts)
    T0 = jnp.tile(jnp.eye(4, dtype=jnp.float32), (B, 1, 1))

    mesh = mesh_mod.make_pair_mesh(4)
    res = pair_sharding.sharded_batched_gicp(mesh, src, tgt, T0, 0.3,
                                             max_iteration=3)
    T = multihost_utils.process_allgather(res.transformation, tiled=True)
    fit = multihost_utils.process_allgather(res.fitness, tiled=True)
    if jax.process_index() == 0:
        np.save(os.path.join(outdir, "dist_T.npy"), np.asarray(T))
        np.save(os.path.join(outdir, "dist_fit.npy"), np.asarray(fit))
    multihost_utils.sync_global_devices("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
