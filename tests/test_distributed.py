"""Multi-process execution of the multihost path (VERDICT r2 item 4): two
real OS processes, a localhost coordinator, ``jax.distributed.initialize``
via ``parallel.mesh.maybe_initialize_distributed``, and a 4-device 'pairs'
mesh whose collectives cross the process boundary (gloo CPU backend).

Skips (not fails) when the coordinator can't come up — sandboxed CI hosts
may forbid localhost sockets."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

WORKER = os.path.join(os.path.dirname(__file__), "distributed_worker.py")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_sharded_gicp(tmp_path):
    try:
        port = _free_port()
    except OSError as e:  # pragma: no cover - sandboxed host
        pytest.skip(f"no localhost sockets: {e}")
    base_env = {
        **os.environ,
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": "--xla_force_host_platform_device_count=2",
        "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
        "JAX_NUM_PROCESSES": "2",
        # the workers import this checkout's package, whatever the caller's
        # PYTHONPATH holds
        "PYTHONPATH": REPO,
    }
    procs = []
    for pid in (0, 1):
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, str(tmp_path)],
            env={**base_env, "JAX_PROCESS_ID": str(pid)},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=REPO,
        ))
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed workers timed out")
        outs.append(out)
    for p, out in zip(procs, outs):
        if p.returncode != 0:
            low = out.lower()
            if "unavailable" in low or "bind" in low or "deadline" in low:
                pytest.skip(f"coordinator unavailable on this host:\n{out[-2000:]}")
            pytest.fail(f"worker failed rc={p.returncode}:\n{out[-4000:]}")

    # Compare against a single-process run of the same seeded workload.
    import jax
    import jax.numpy as jnp

    from pcr_tpu.ops import normals as normals_ops
    from pcr_tpu.parallel import pair_sharding
    from pcr_tpu.utils import cloud

    rng = np.random.default_rng(0)
    srcs, tgts = [], []
    for _ in range(4):
        pts = rng.uniform(-1, 1, size=(300, 3)).astype(np.float32)
        srcs.append(normals_ops.with_normals_knn(
            cloud.from_numpy(pts, capacity=320), 10))
        tgts.append(normals_ops.with_normals_knn(
            cloud.from_numpy(pts + np.float32(0.05), capacity=320), 10))
    src = cloud.stack_clouds(srcs)
    tgt = cloud.stack_clouds(tgts)
    T0 = jnp.tile(jnp.eye(4, dtype=jnp.float32), (4, 1, 1))
    res = pair_sharding.batched_gicp(src, tgt, T0, 0.3, max_iteration=3)

    T_dist = np.load(tmp_path / "dist_T.npy")
    fit_dist = np.load(tmp_path / "dist_fit.npy")
    np.testing.assert_allclose(T_dist, np.asarray(res.transformation), atol=1e-5)
    np.testing.assert_allclose(fit_dist, np.asarray(res.fitness), atol=1e-5)
