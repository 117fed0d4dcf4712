"""CPU reference implementation of the stage-2 M-GICP pipeline.

Stand-in for the reference's Open3D-C++ per-pair path (the environment has no
open3d to rerun; SURVEY §6 notes the reference records no numbers).  Same
algorithm per pair — voxel downsample, statistical outlier removal, KNN-20
normals, 5-scale GICP(L1) with the 2_...py schedules — implemented with
numpy + scipy cKDTree (C spatial index + LAPACK eigh, i.e. a reasonable
CPU-native baseline; Open3D's C++ core is typically within a small factor).

Run:  python benchmarks/cpu_baseline.py [n_pairs]
Writes benchmarks/baseline_cpu.json with pairs/sec, consumed by bench.py.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
from scipy.spatial import cKDTree

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pcr_tpu.utils import pcd, poses_io  # noqa: E402

EPS = 1e-3


def voxel_downsample(pts, v):
    ijk = np.floor((pts - pts.min(0)) / v).astype(np.int64)
    key = (ijk[:, 0] << 42) + (ijk[:, 1] << 21) + ijk[:, 2]
    order = np.argsort(key)
    key_s, pts_s = key[order], pts[order]
    boundary = np.concatenate([[True], key_s[1:] != key_s[:-1]])
    seg = np.cumsum(boundary) - 1
    sums = np.zeros((seg[-1] + 1, 3))
    np.add.at(sums, seg, pts_s)
    counts = np.bincount(seg)
    return sums / counts[:, None]


def remove_outliers(pts, k=30, std_ratio=1.0):
    tree = cKDTree(pts)
    d, _ = tree.query(pts, k + 1)
    mean_d = d[:, 1:].mean(1)
    thresh = mean_d.mean() + std_ratio * mean_d.std(ddof=1)
    return pts[mean_d <= thresh]


def estimate_covariances(pts, k=20):
    tree = cKDTree(pts)
    _, idx = tree.query(pts, k)
    nb = pts[idx]
    mean = nb.mean(1, keepdims=True)
    c = nb - mean
    cov = np.einsum("nki,nkj->nij", c, c) / k
    w, V = np.linalg.eigh(cov)
    d = np.array([EPS, 1.0, 1.0])
    return np.einsum("nik,k,njk->nij", V, d, V)


def skew(v):
    out = np.zeros(v.shape[:-1] + (3, 3))
    out[..., 0, 1] = -v[..., 2]; out[..., 0, 2] = v[..., 1]
    out[..., 1, 0] = v[..., 2]; out[..., 1, 2] = -v[..., 0]
    out[..., 2, 0] = -v[..., 1]; out[..., 2, 1] = v[..., 0]
    return out


def se3_exp(xi):
    from scipy.spatial.transform import Rotation

    T = np.eye(4)
    T[:3, :3] = Rotation.from_rotvec(xi[:3]).as_matrix()
    T[:3, 3] = xi[3:]
    return T


def gicp(src, src_cov, tgt, tgt_cov, max_dist, T, iters=100, tol=1e-6):
    tree = cKDTree(tgt)
    prev_fit, prev_rmse = -1.0, -1.0
    for _ in range(iters):
        p = src @ T[:3, :3].T + T[:3, 3]
        d, j = tree.query(p, 1, distance_upper_bound=max_dist)
        valid = np.isfinite(d)
        fit = valid.mean()
        rmse = np.sqrt((d[valid] ** 2).mean()) if valid.any() else 0.0
        if abs(fit - prev_fit) < tol and abs(rmse - prev_rmse) < tol:
            break
        prev_fit, prev_rmse = fit, rmse
        pv, jv = p[valid], j[valid]
        q = tgt[jv]
        r = q - pv
        M = np.linalg.inv(tgt_cov[jv] + np.einsum("ij,njk,lk->nil", T[:3, :3], src_cov[valid], T[:3, :3]))
        w = 1.0 / np.maximum(np.linalg.norm(r, axis=1), 1e-8)  # L1 loss
        G = np.concatenate([skew(pv), -np.broadcast_to(np.eye(3), pv.shape + (3,))], axis=2)
        MG = np.einsum("nij,njk->nik", M, G)
        H = np.einsum("nij,nik,n->jk", G, MG, w)
        g = np.einsum("nij,ni,n->j", MG, r, w)
        xi = -np.linalg.solve(H + 1e-6 * np.trace(H) / 6 * np.eye(6), g)
        T = se3_exp(xi) @ T
    return T


def mgicp_pair(src_pts, tgt_pts, T0, n_scales=5, iters=100):
    scales = [0.1 + 0.1 * i for i in reversed(range(n_scales))]
    dists = [3 * scales[0], 2.5 * scales[1], 2 * scales[2], 1.5 * scales[3], scales[4]]
    T = T0.copy()
    for v, d in zip(scales, dists):
        s = remove_outliers(voxel_downsample(src_pts, v))
        t = remove_outliers(voxel_downsample(tgt_pts, v))
        s_cov = estimate_covariances(s)
        t_cov = estimate_covariances(t)
        T = gicp(s, s_cov, t, t_cov, d, T, iters=iters)
    return T


# ---------------------------------------------------------------------------
# Stage-1 baseline: FPFH features + FGR (the reference's hottest kernel,
# 1_FGR_pairwise_registration...py:44-65) in numpy + cKDTree.
# ---------------------------------------------------------------------------

def estimate_normals(pts, radius=0.2, max_nn=20):
    tree = cKDTree(pts)
    d, idx = tree.query(pts, max_nn)
    idx = np.where(d <= radius, idx, np.arange(len(pts))[:, None])
    nb = pts[idx]
    c = nb - nb.mean(1, keepdims=True)
    cov = np.einsum("nki,nkj->nij", c, c)
    _, V = np.linalg.eigh(cov)
    return V[:, :, 0]  # smallest-eigenvalue direction


def fpfh(pts, normals, radius=1.0, max_nn=200):
    """33-dim FPFH: SPFH Darboux-angle histograms (11 bins x 3 features) +
    distance-weighted neighbor sum, the Open3D two-pass structure."""
    n = len(pts)
    tree = cKDTree(pts)
    d, idx = tree.query(pts, max_nn, distance_upper_bound=radius)
    valid = np.isfinite(d) & (d > 0)
    idx = np.where(valid, idx, 0)
    # pair features between each point and its neighbors
    p = pts[:, None, :]
    q = pts[idx]
    u = normals[:, None, :]
    nq = normals[idx]
    dv = q - p
    dist = np.maximum(np.linalg.norm(dv, axis=2), 1e-12)
    dvn = dv / dist[..., None]
    v = np.cross(dvn, np.broadcast_to(u, dvn.shape))
    w = np.cross(np.broadcast_to(u, dvn.shape), v)
    f1 = np.einsum("nkj,nkj->nk", v, nq)                      # alpha
    f2 = np.einsum("nkj,nkj->nk", dvn, np.broadcast_to(u, dvn.shape))  # phi
    f3 = np.arctan2(np.einsum("nkj,nkj->nk", w, nq),
                    np.einsum("nkj,nkj->nk", np.broadcast_to(u, dvn.shape), nq))
    spfh = np.zeros((n, 33))
    rows = np.broadcast_to(np.arange(n)[:, None], f1.shape)[valid]
    for k, (f, lo, hi) in enumerate(
            ((f1, -1.0, 1.0), (f2, -1.0, 1.0), (f3, -np.pi, np.pi))):
        b = np.clip(((f - lo) / (hi - lo) * 11).astype(np.int64), 0, 10)
        np.add.at(spfh, (rows, 11 * k + b[valid]), 1.0)
    # second pass: distance-weighted neighbor SPFH sum
    wgt = np.where(valid, 1.0 / np.maximum(d, 1e-12), 0.0)
    out = spfh + np.einsum("nk,nkf->nf", wgt, spfh[idx])
    norm = np.linalg.norm(out, axis=1, keepdims=True)
    return out / np.maximum(norm, 1e-12)


def fgr_pair(src, feat_s, tgt, feat_t, max_dist=0.2, iters=300,
             division_factor=1.4, tuple_scale=0.95, seed=0):
    """Mutual feature matching -> tuple test -> Geman-McClure GNC."""
    ts = cKDTree(feat_t)
    tt = cKDTree(feat_s)
    _, ij = ts.query(feat_s, 1)
    _, ji = tt.query(feat_t, 1)
    mutual = ji[ij] == np.arange(len(feat_s))
    ci = np.arange(len(feat_s))[mutual]
    cj = ij[mutual]
    # tuple test
    rng = np.random.default_rng(seed)
    m = len(ci)
    keep = np.zeros(m, bool)
    if m >= 3:
        tri = rng.integers(0, m, size=(min(m * 3, 30000), 3))
        pa, qa = src[ci[tri]], tgt[cj[tri]]
        ok = np.ones(len(tri), bool)
        for a, b in ((0, 1), (1, 2), (2, 0)):
            r = (np.linalg.norm(pa[:, a] - pa[:, b], axis=1)
                 / np.maximum(np.linalg.norm(qa[:, a] - qa[:, b], axis=1), 1e-12))
            ok &= (r > tuple_scale) & (r < 1 / tuple_scale)
        keep[np.unique(tri[ok])] = True
    p, q = src[ci[keep]], tgt[cj[keep]]
    if len(p) < 3:
        return np.eye(4)
    # normalized GNC (use_absolute_scale=False)
    c_p, c_q = p.mean(0), q.mean(0)
    scale = max(np.abs(p - c_p).max(), np.abs(q - c_q).max(), 1e-6)
    pn, qn = (p - c_p) / scale, (q - c_q) / scale
    T = np.eye(4)
    mu = 1.0
    delta = max_dist / scale
    for it in range(iters):
        if it % 4 == 0 and mu > delta * delta:
            mu /= division_factor
        pt = pn @ T[:3, :3].T + T[:3, 3]
        r = qn - pt
        r2 = (r * r).sum(1)
        l = (mu / (mu + r2)) ** 2
        G = np.concatenate([skew(pt), -np.broadcast_to(np.eye(3), pt.shape + (3,))], axis=2)
        H = np.einsum("nij,nik,n->jk", G, G, l)
        g = np.einsum("nij,ni,n->j", G, r, l)
        xi = -np.linalg.solve(H + 1e-6 * (np.trace(H) / 6 + 1) * np.eye(6), g)
        T = se3_exp(xi) @ T
    R = T[:3, :3]
    t = scale * T[:3, 3] + c_q - R @ c_p
    out = np.eye(4); out[:3, :3] = R; out[:3, 3] = t
    return out


def stage1_features(pts, voxel=0.1):
    normals = estimate_normals(pts, radius=2 * voxel, max_nn=20)
    return fpfh(pts, normals, radius=10 * voxel, max_nn=200)


def bench_stage1(clouds, n_pairs):
    """Per-scan features shared by the two pairs each scan serves — the same
    economy as the JAX pipeline, so the ratio compares like for like."""
    t0 = time.time()
    feats = {}
    for i in range(n_pairs):
        for k in (i, i + 1):
            if k not in feats:
                feats[k] = stage1_features(clouds[k])
        fgr_pair(clouds[i + 1], feats[i + 1], clouds[i], feats[i], seed=i + 1)
    return n_pairs / (time.time() - t0)


def main(n_pairs=4):
    clouds = [
        pcd.read_pcd(poses_io.reference_cloud_path("NCLT", i)).points.astype(np.float64)
        for i in range(n_pairs + 1)
    ]
    init = [
        poses_io.load_pose(
            os.path.join(poses_io.reference_fixture_dir("FGR", "NCLT"), f"pose_{i + 1}_{i}.txt")
        )
        for i in range(n_pairs)
    ]
    t0 = time.time()
    for i in range(n_pairs):
        mgicp_pair(clouds[i + 1], clouds[i], init[i])
    dt = time.time() - t0
    fgr_pps = bench_stage1(clouds, n_pairs)
    result = {
        "pairs_per_sec": n_pairs / dt,
        "seconds_per_pair": dt / n_pairs,
        "fgr_pairs_per_sec": fgr_pps,
        "fgr_seconds_per_pair": 1.0 / fgr_pps,
        "n_pairs": n_pairs,
        "workload": "NCLT stage-2 M-GICP (5 scales, 100 iters, L1) "
                    "+ stage-1 FPFH+FGR (1_...py:44-65)",
        "impl": "numpy+scipy cKDTree CPU baseline",
    }
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "baseline_cpu.json")
    with open(out, "w") as fh:
        json.dump(result, fh, indent=2)
    print(json.dumps(result))


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
