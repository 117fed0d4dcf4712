"""Facade full-circuit evidence report.

Reads this repo's own end-to-end Facade outputs (outputs/<stage>/Facade —
produced by ``python -m pcr_tpu full --dataset Facade``) plus the reference
fixtures, and writes outputs/Facade_summary.json: stage-2 agreement vs the
shipped FGR_GICP fixtures, circuit closure per stage, per-method stage-3 ATE
vs the shipped absolute fixtures (ATE-level targets, SURVEY §0), and the
pose-graph optimizer diagnostics persisted by run_stage3_global.

Usage: python benchmarks/facade_report.py [output_root] [total_seconds]
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pcr_tpu.utils import device, poses_io, se3  # noqa: E402


def closure(rel):
    T = np.asarray(se3.loop_closure_error(np.asarray(rel, np.float64)))
    return {"t_norm_m": float(np.linalg.norm(T[:3, 3])),
            "R_frob": float(np.linalg.norm(T[:3, :3] - np.eye(3)))}


def main(root="outputs", total_seconds=None, note=""):
    n = 7
    s1 = poses_io.load_relative_circuit(
        os.path.join(root, "relative_poses_FGR", "Facade"), n)
    s2 = poses_io.load_relative_circuit(
        os.path.join(root, "relative_poses_FGR_GICP", "Facade"), n)
    r2 = poses_io.load_reference_relative("FGR_GICP", "Facade")
    dR, dt = se3.pose_errors(s2, r2)
    dR, dt = np.asarray(dR), np.asarray(dt)
    ref_abs = np.asarray(poses_io.load_reference_absolute("Facade"))

    out = {
        "n_scans": n,
        "total_seconds_incl_compile": total_seconds,
        "device": device.describe(),
        "note": note,
        "stage2_vs_fixture": {
            "dt_median_m": float(np.median(dt)), "dt_max_m": float(dt.max()),
            "dR_median": float(np.median(dR)),
        },
        "closure": {
            "ours_FGR": closure(s1),
            "ours_FGR_GICP": closure(s2),
            "fixture_FGR_GICP": closure(r2),
        },
        "stage3_ate_vs_shipped_absolutes": {},
    }
    for m in ("LUM", "SLERP", "SLERP_LUM", "pose_graph"):
        d = os.path.join(root, f"absolute_poses_{m}", "Facade")
        if not os.path.isdir(d):
            continue
        poses = poses_io.load_absolute_poses(d, n)
        dR_m, dt_m = se3.pose_errors(poses, ref_abs)
        dR_m, dt_m = np.asarray(dR_m), np.asarray(dt_m)
        out["stage3_ate_vs_shipped_absolutes"][m] = {
            "ate_median_m": float(np.median(dt_m)),
            "ate_max_m": float(dt_m.max()),
            "dR_median": float(np.median(dR_m)),
        }
    cons_path = os.path.join(root, "metrics", "Facade", "stage3_consistency.json")
    if os.path.exists(cons_path):
        saved = json.load(open(cons_path))
        if "pose_graph" in saved:
            out["stage3_pose_graph_optimizer"] = saved["pose_graph"].get("optimizer")
            out["stage3_pose_graph_consistency"] = {
                k: v for k, v in saved["pose_graph"].items()
                if isinstance(v, (int, float))}
    path = os.path.join(root, "Facade_summary.json")
    with open(path, "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    args = sys.argv[1:]
    root = args[0] if args else "outputs"
    secs = float(args[1]) if len(args) > 1 else None
    note = args[2] if len(args) > 2 else ""
    main(root, secs, note)
