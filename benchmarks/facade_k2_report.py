"""Facade k=2 "SLAM mode" evidence run (VERDICT r4 item 5).

The reference's generalized product is ``full_registration`` (k-connectivity
pose graph, ALL_FUNCTIONS.py:342-394) followed by Open3D's
``global_optimization`` (3_...py:343-354).  This runs that END TO END on the
real 7-scan Facade circuit via the BATCHED builder
(models/graph_builder.full_registration_batched — chunked vmapped FGR +
doubling M-GICP + batched information matrices, with the serial retry ladder
for gated pairs), optimizes the k=2 graph (11 edges: 6 odometry + 5
loop-closure), and writes outputs/Facade_k2_summary.json with per-edge gate
fitness, the optimizer diagnostics, and node ATE vs the shipped absolute
fixtures (ATE-level targets, SURVEY §0).

Usage: python benchmarks/facade_k2_report.py [output_root]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(root="outputs"):
    import numpy as np

    from pcr_tpu.models import graph_builder
    from pcr_tpu.models.global_refine import pose_graph as pg
    from pcr_tpu.utils import cloud as cloud_mod, device, poses_io, se3

    n, k = 7, 2
    t0 = time.time()
    clouds = cloud_mod.load_dataset("Facade", indices=range(n))
    edges_log = []
    graph = graph_builder.full_registration_batched(
        clouds, voxel_size=0.1, k=k, n_scales=3, iterations=100,
        batch_size=2, log=edges_log.append)
    t_build = time.time() - t0
    t1 = time.time()
    out, info = pg.global_optimization(
        graph, max_correspondence_distance=0.2, edge_prune_threshold=0.25,
        return_info=True)
    t_opt = time.time() - t1

    nodes = np.asarray(out.nodes, np.float64)
    ref_abs = np.asarray(poses_io.load_reference_absolute("Facade"))[:n]
    dR, dt = se3.pose_errors(nodes, ref_abs)
    dR, dt = np.asarray(dR), np.asarray(dt)
    aligned = None
    try:
        from pcr_tpu.models import evaluate as eval_mod

        aligned = eval_mod.aligned_ate(nodes, ref_abs)
    except Exception:
        pass

    summary = {
        "graph": f"Facade {n} scans, k={k} connectivity "
                 f"({k * (2 * n - k - 1) // 2} edges: {n - 1} odometry + "
                 f"{k * (2 * n - k - 1) // 2 - (n - 1)} loop closure), "
                 "90,112-point bucket",
        "device": device.describe(),
        "builder": "full_registration_batched (chunked vmapped FGR + "
                   "doubling M-GICP, serial retry ladder)",
        "edges": edges_log,
        "build_seconds_incl_compiles": round(t_build, 2),
        "optimize_seconds": round(t_opt, 2),
        "pruned_edges": int((~np.asarray(out.edge_mask)).sum()),
        "optimizer": info,
        "node_ate_vs_reference_absolutes": {
            "dt_mean_m": float(dt.mean()), "dt_max_m": float(dt.max()),
            "dR_mean": float(dR.mean()), "dR_max": float(dR.max()),
        },
        "aligned_ate_vs_reference_absolutes": aligned,
        "note": "Reference absolutes are ATE-level targets, not exact chain "
                "products of the relative fixtures (their own chain is "
                "~0.25 m off, SURVEY S0).  Round-5 evidence: the batched "
                "k-connectivity builder + pose-graph LM end to end on real "
                "TLS data (ALL_FUNCTIONS.py:342-394 + 3_...py:343-354).",
    }
    path = os.path.join(root, "Facade_k2_summary.json")
    os.makedirs(root, exist_ok=True)
    with open(path, "w") as fh:
        json.dump(summary, fh, indent=2)
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main(*sys.argv[1:])
