"""Bring-up probe on one GPU: the per-op facts PERF.md records for the card.

    python benchmarks/bringup_probe.py

On one seeded NCLT-shaped scan pair (chip_smoke.generate), warm, median of
several runs, each ending in block_until_ready:

  * k=200 self-kNN: the exact tiled merge (the default) vs
    ``lax.approx_min_k`` (``knn_approx``), which the GPU lowers to an exact
    sort-based selection;
  * GICP cost per Gauss-Newton iteration at the finest pyramid scale, for
    the hash grid (the default) and the band sweep: (t(101 iters) -
    t(1 iter)) / 100, convergence disabled so the count is exact;
  * the K=3 nearest-neighbour merge (``nn1_exact``) under matmul precision
    "highest" vs "default", with the distance error "default" costs.

Refuses to run without a GPU.  Prints one JSON object as its last line.
"""

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def timed(fn, reps=5):
    import jax

    jax.block_until_ready(fn())           # compile + warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def main() -> int:
    import jax

    if jax.devices()[0].platform != "gpu":
        raise SystemExit("bringup_probe: needs a GPU, JAX found "
                         f"{jax.devices()[0].platform}")
    import jax.numpy as jnp

    import chip_smoke
    from pcr_tpu.models import gicp, multiscale
    from pcr_tpu.ops import knn
    from pcr_tpu.utils import cloud, device

    out = {"device": device.describe()}
    scans, poses = chip_smoke.generate(0, n_scans=2)
    c0 = cloud.from_numpy(scans[0], capacity=chip_smoke.BUCKET)
    c1 = cloud.from_numpy(scans[1], capacity=chip_smoke.BUCKET)
    cc = cloud.compact(c0, cloud.bucket_capacity(c0))
    out["points"] = int(len(scans[0]))
    out["bucket"] = int(cc.capacity)

    # k=200 self-kNN: exact merge vs approx_min_k
    out["knn200_exact_s"] = timed(lambda: knn.knn_exact(
        cc.points, cc.points, cc.mask, 200, exclude_self=True))
    out["knn200_approx_min_k_s"] = timed(lambda: knn.knn_approx(
        cc.points, cc.points, cc.mask, 200, exclude_self=True, rescore=False))

    # GICP per-iteration cost at the finest scale
    caps = cloud.plan_scale_caps([c0, c1], multiscale.create_scales(5))
    p0 = multiscale.build_pyramid(c0, n_scales=5, scale_capacities=caps)
    p1 = multiscale.build_pyramid(c1, n_scales=5, scale_capacities=caps)
    T = jnp.asarray(chip_smoke.relative_ground_truth(poses)[0], jnp.float32)
    for method in ("grid", "band"):
        t = {}
        for iters in (1, 101):
            t[iters] = timed(lambda: gicp.registration_gicp(
                p1[-1], p0[-1], 0.1, T, corr_method=method,
                max_iteration=iters, relative_fitness=-1.0,
                relative_rmse=-1.0).transformation)
        out[f"gicp_finest_{method}_ms_per_iter"] = 1e3 * (t[101] - t[1]) / 100
        out[f"gicp_finest_{method}_one_iter_s"] = t[1]
    out["gicp_finest_points"] = int(caps[-1])

    # K=3 merge under "highest" vs "default" matmul precision
    q = cc.points + jnp.float32(0.01)
    res = {}
    for prec in ("highest", "default"):
        with jax.default_matmul_precision(prec):
            out[f"nn1_exact_{prec}_s"] = timed(
                lambda: knn.nn1_exact(q, cc.points, cc.mask))
            res[prec] = np.asarray(knn.nn1_exact(q, cc.points, cc.mask)[0])
    m = np.asarray(cc.mask)
    out["nn1_default_vs_highest_max_d2_diff"] = float(
        np.abs(res["default"] - res["highest"])[m].max())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
