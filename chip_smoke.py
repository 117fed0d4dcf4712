"""Bring-up smoke test: the registration pipeline end to end on one GPU.

    python chip_smoke.py                          # phases (a)-(d), one GPU
    python chip_smoke.py --chips 4                # phase (e) alone, four GPUs
    python chip_smoke.py --chips 4 --only points  # phase (e), 2x2 mesh only

Phases, in one process:

  (a) device — refuses anything but a GPU (no CPU fallback) and prints the
      card's name and power limit, the JAX version, the compile-cache
      directory and the matmul precision;
  (b) data — a seeded 32-beam spinning-sensor simulator casts a closed
      16-scan loop through a procedural outdoor scene (rough ground,
      buildings, walls, cars, poles, trees, bushes), thins each sweep on a
      voxel grid and writes binary PCD files at NCLT shapes (20k-31k points
      per scan, the 32,768 bucket), keeping the ground-truth poses;
  (c) kernels — each device kernel of the main path, compiled for the card
      at real width, against the repo's plain reference;
  (d) main path — ``python -m pcr_tpu full --dataset NCLT --n 16`` in-process
      (stages 1->2->3, all four stage-3 methods), cold and then warm, with
      the stage-2 relative poses checked against ground truth;
  (e) ``--chips 4`` only — the single-device stage 1 + stage 2 baseline,
      then stage 2 over a 2x2 pairs x points mesh and stage 1 + stage 2 over
      a 4-device 'pairs' mesh, each against the baseline by pose agreement
      (``--only points|pairs`` runs the baseline and one of the two).  A run
      that hangs dumps every thread's stack and exits non-zero.

Any failed check raises, so the process exits non-zero.  The last line of
standard output is one JSON object naming the device, printed only when
every phase passed.  Data and outputs go to ``.smoke/`` in the checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, ".smoke")
DATA_ROOT = os.path.join(WORK, "reference")

N_SCANS = 16
BUCKET = 32768            # cloud.BUCKETS["NCLT"]
VOXEL = 0.1               # the pipeline's stage-1 voxel (PipelineConfig)

# HDL-32E-like sensor: 32 beams from -30.67 to +10.67 degrees elevation,
# 2250 azimuth steps (0.16 deg at 10 Hz), ~69k rays per sweep.  Like NCLT's
# preprocessed scans, each sweep is thinned on a voxel grid, which lands it at
# 20k-31k points.
ELEVATIONS_DEG = np.linspace(-30.67, 10.67, 32)
N_AZIMUTH = 2250
SCAN_VOXEL = 0.08
MAX_RANGE = 80.0
RANGE_NOISE = 0.02        # m, 1 sigma (HDL-32E: +-2 cm)
DROPOUT = 0.03
SENSOR_HEIGHT = 1.2

# Stage-2 pose bounds against ground truth.  On the H100 stage 2 lands at
# median 0.7 mm, max 1.4 mm, 0.0175 deg; stage 1 alone (FGR) at median 46 mm,
# max 0.13 m, 0.81 deg.  The bounds sit between the two, so a GICP that
# returned its FGR init unchanged fails them; so does one that does not halve
# the stage-1 median error.
MEDIAN_T_ERR = 0.01       # m
MAX_T_ERR = 0.02          # m
MAX_R_ERR_DEG = 0.2
STAGE1_GAIN = 0.5         # stage-2 median dt <= this x stage-1 median dt

# Phase (e): a CLI run still going after this long is taken to hang (the
# slowest seen, stage 2 over a 1-device mesh with a cold compile cache, took
# 143 s on an H100, 101 s of it compiling).
HANG_SECONDS = 300


class CheckFailed(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    print(("PASS " if ok else "FAIL ") + what, flush=True)
    if not ok:
        raise CheckFailed(what)


# ---------------------------------------------------------------------------
# (b) seeded scan generator
# ---------------------------------------------------------------------------

def _rot_z(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _rot_xyz(rx, ry, rz):
    cx, sx, cy, sy = np.cos(rx), np.sin(rx), np.cos(ry), np.sin(ry)
    Rx = np.array([[1.0, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1.0, 0], [-sy, 0, cy]])
    return _rot_z(rz) @ Ry @ Rx


def make_scene(rng) -> dict:
    """Procedural outdoor scene around the origin, tens of metres across:
    buildings, walls and parked cars as yawed boxes, poles and tree trunks
    as vertical cylinders, tree crowns and bushes as spheres, over gently
    rough ground.  Everything stays >= 2 m clear of the sensor loop (radius
    ~4 m around the origin)."""
    boxes = []   # (cx, cy, cz, hx, hy, hz, yaw)
    for k in range(12):         # buildings in a ring of sectors
        ang = 2 * np.pi * (k + rng.uniform(0.1, 0.9)) / 12
        hx, hy = rng.uniform(3.0, 8.0), rng.uniform(2.0, 5.0)
        dist = rng.uniform(11.0, 26.0) + hy
        hz = rng.uniform(3.0, 10.0)
        boxes.append((dist * np.cos(ang), dist * np.sin(ang), hz, hx, hy, hz,
                      ang + np.pi / 2 + rng.normal(scale=0.3)))
    for _ in range(6):          # low walls and fences
        ang, dist = rng.uniform(0, 2 * np.pi), rng.uniform(7.0, 14.0)
        h = rng.uniform(0.4, 1.2)
        boxes.append((dist * np.cos(ang), dist * np.sin(ang), h,
                      rng.uniform(2.0, 5.0), 0.1, h, rng.uniform(0, np.pi)))
    for _ in range(10):         # cars
        ang, dist = rng.uniform(0, 2 * np.pi), rng.uniform(7.5, 13.0)
        boxes.append((dist * np.cos(ang), dist * np.sin(ang), 0.75,
                      2.25, 0.9, 0.75, rng.uniform(0, np.pi)))
    poles = []   # (cx, cy, r, h)
    spheres = []  # (cx, cy, cz, r)
    for _ in range(16):         # poles and sign posts
        ang, dist = rng.uniform(0, 2 * np.pi), rng.uniform(6.0, 25.0)
        poles.append((dist * np.cos(ang), dist * np.sin(ang),
                      rng.uniform(0.08, 0.3), rng.uniform(2.5, 8.0)))
    for _ in range(14):         # trees: trunk + crown
        ang, dist = rng.uniform(0, 2 * np.pi), rng.uniform(6.5, 22.0)
        x, y, r = dist * np.cos(ang), dist * np.sin(ang), rng.uniform(1.2, 2.5)
        h = rng.uniform(2.0, 3.5)
        poles.append((x, y, rng.uniform(0.15, 0.35), h + 0.5))
        spheres.append((x, y, h + 0.8 * r, r))
    for _ in range(10):         # bushes
        ang, dist = rng.uniform(0, 2 * np.pi), rng.uniform(6.5, 20.0)
        r = rng.uniform(0.6, 1.5)
        spheres.append((dist * np.cos(ang), dist * np.sin(ang), 0.6 * r, r))
    return {"boxes": np.asarray(boxes), "poles": np.asarray(poles),
            "spheres": np.asarray(spheres),
            "ground": rng.uniform(0, 2 * np.pi, size=4)}


def ground_height(scene: dict, x, y):
    """Gently rough ground: a few centimetres of smooth relief."""
    p = scene["ground"]
    return (0.06 * np.sin(0.35 * x + p[0]) * np.cos(0.27 * y + p[1])
            + 0.03 * np.sin(1.3 * x + 0.9 * y + p[2])
            + 0.02 * np.cos(2.1 * y - 1.7 * x + p[3]))


def circuit_poses(rng, n: int = N_SCANS) -> np.ndarray:
    """Sensor-to-world poses of a closed loop: n stations on a ~4 m circle
    (1-2 m apart, so the wraparound pair overlaps like its neighbours),
    heading along the loop, with small roll/pitch/height jitter."""
    radius = 4.0
    poses = np.zeros((n, 4, 4))
    for i in range(n):
        a = 2 * np.pi * i / n
        r = radius + rng.normal(scale=0.1)
        R = _rot_xyz(rng.normal(scale=np.radians(1.0)),
                     rng.normal(scale=np.radians(1.0)),
                     a + np.pi / 2 + rng.normal(scale=np.radians(3.0)))
        poses[i, :3, :3] = R
        poses[i, :3, 3] = [r * np.cos(a), r * np.sin(a),
                           SENSOR_HEIGHT + rng.normal(scale=0.02)]
        poses[i, 3, 3] = 1.0
    return poses


def sensor_rays(n_azimuth: int = N_AZIMUTH) -> np.ndarray:
    """(32 * n_azimuth, 3) unit ray directions in the sensor frame."""
    el = np.radians(ELEVATIONS_DEG)[:, None]
    az = (2 * np.pi * np.arange(n_azimuth) / n_azimuth)[None, :]
    d = np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az),
                  np.sin(el) * np.ones_like(az)], axis=-1)
    return d.reshape(-1, 3)


def _hit_boxes(o, d, boxes):
    c, h, yaw = boxes[:, :3], boxes[:, 3:6], boxes[:, 6]
    cy, sy = np.cos(-yaw), np.sin(-yaw)
    # ray into each box frame: translate, then rotate by -yaw about z
    ox, oy, oz = o[0] - c[:, 0], o[1] - c[:, 1], o[2] - c[:, 2]
    lo = np.stack([cy * ox - sy * oy, sy * ox + cy * oy, oz], -1)        # (B, 3)
    ld = np.stack([d[:, None, 0] * cy - d[:, None, 1] * sy,
                   d[:, None, 0] * sy + d[:, None, 1] * cy,
                   np.broadcast_to(d[:, None, 2], (d.shape[0], len(boxes)))], -1)
    with np.errstate(divide="ignore", invalid="ignore"):
        t1 = (-h[None] - lo[None]) / ld
        t2 = (h[None] - lo[None]) / ld
    tn = np.nanmax(np.minimum(t1, t2), axis=-1)
    tf = np.nanmin(np.maximum(t1, t2), axis=-1)
    return np.where((tn <= tf) & (tn > 0), tn, np.inf)


def _hit_poles(o, d, poles):
    c, r, h = poles[:, :2], poles[:, 2], poles[:, 3]
    px, py = o[0] - c[:, 0], o[1] - c[:, 1]
    a = d[:, None, 0] ** 2 + d[:, None, 1] ** 2
    b = 2 * (d[:, None, 0] * px + d[:, None, 1] * py)
    cc = px ** 2 + py ** 2 - r ** 2
    disc = b * b - 4 * a * cc
    with np.errstate(invalid="ignore", divide="ignore"):
        t = (-b - np.sqrt(disc)) / (2 * a)
    z = o[2] + t * d[:, None, 2]
    return np.where((disc >= 0) & (t > 0) & (z >= 0) & (z <= h), t, np.inf)


def _hit_spheres(o, d, spheres):
    p = o[None, :] - spheres[:, :3]                                      # (S, 3)
    b = 2 * d @ p.T
    cc = np.sum(p * p, axis=1) - spheres[:, 3] ** 2
    disc = b * b - 4 * cc
    with np.errstate(invalid="ignore"):
        t = (-b - np.sqrt(disc)) / 2
    return np.where((disc >= 0) & (t > 0), t, np.inf)


def cast_scan(scene: dict, pose: np.ndarray, rays: np.ndarray, rng) -> np.ndarray:
    """Ray-cast one scan; returns its points (m, 3) in the sensor frame."""
    o = pose[:3, 3]
    d = rays @ pose[:3, :3].T                                            # world
    with np.errstate(divide="ignore", invalid="ignore"):
        t_ground = np.where(d[:, 2] < 0, -o[2] / d[:, 2], np.inf)
        for _ in range(3):      # fixed-point steps onto the rough ground
            g = ground_height(scene, o[0] + t_ground * d[:, 0],
                              o[1] + t_ground * d[:, 1])
            t_ground = np.where(d[:, 2] < 0, (g - o[2]) / d[:, 2], np.inf)
    t = np.minimum.reduce([
        t_ground,
        _hit_boxes(o, d, scene["boxes"]).min(axis=1),
        _hit_poles(o, d, scene["poles"]).min(axis=1),
        _hit_spheres(o, d, scene["spheres"]).min(axis=1),
    ])
    t = t + rng.normal(scale=RANGE_NOISE, size=t.shape)
    keep = (t > 0.5) & (t < MAX_RANGE) & (rng.uniform(size=t.shape) >= DROPOUT)
    return (t[keep, None] * rays[keep]).astype(np.float32)


def voxel_thin(points: np.ndarray, voxel: float) -> np.ndarray:
    """Mean point of each occupied voxel (the scan preprocessing)."""
    keys = np.floor(points / voxel).astype(np.int64)
    _, inv, cnt = np.unique(keys, axis=0, return_inverse=True,
                            return_counts=True)
    out = np.zeros((len(cnt), 3))
    np.add.at(out, inv.ravel(), points)
    return (out / cnt[:, None]).astype(np.float32)


def generate(seed: int = 0, n_scans: int = N_SCANS,
             n_azimuth: int = N_AZIMUTH, voxel: float = SCAN_VOXEL):
    """(scans, poses): ``n_scans`` float32 (m_i, 3) sensor-frame scans and
    their (n_scans, 4, 4) sensor-to-world ground-truth poses."""
    rng = np.random.default_rng(seed)
    scene = make_scene(rng)
    poses = circuit_poses(rng, n_scans)
    rays = sensor_rays(n_azimuth)
    scans = [voxel_thin(cast_scan(scene, poses[i], rays, rng), voxel)
             for i in range(n_scans)]
    return scans, poses


def relative_ground_truth(poses: np.ndarray) -> np.ndarray:
    """rel[k] maps scan (k+1) % n into scan k's frame — the circuit pair
    (source, target) = ((k+1) % n, k) of pipeline.circuit_pairs."""
    nxt = np.roll(poses, -1, axis=0)
    return np.linalg.inv(poses) @ nxt


def write_dataset(root: str, scans) -> str:
    """Write scans as binary PCDs where the NCLT loader looks for them."""
    from pcr_tpu.utils import pcd

    d = os.path.join(root, "nuvens", "nuvens_pre_processadas", "NCLT")
    os.makedirs(d, exist_ok=True)
    for i, pts in enumerate(scans):
        pcd.write_pcd(os.path.join(d, f"s{i}.pcd"), pts, binary=True)
    return d


def pose_errors(est: np.ndarray, gt: np.ndarray):
    """(translation errors in m, rotation errors in degrees) per pose."""
    dt = np.linalg.norm(est[:, :3, 3] - gt[:, :3, 3], axis=1)
    # ||Ra - Rb||_F = 2 sqrt(2) sin(angle / 2); unlike arccos of the trace it
    # stays accurate at tiny angles for float32-orthonormal matrices.
    fro = np.linalg.norm(est[:, :3, :3] - gt[:, :3, :3], axis=(1, 2))
    return dt, np.degrees(2 * np.arcsin(np.clip(fro / (2 * np.sqrt(2)), 0, 1)))


# ---------------------------------------------------------------------------
# (a) device
# ---------------------------------------------------------------------------

def device_phase(jax, want: int) -> None:
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU, JAX found "
                         f"{devs[0].platform} ({devs[0].device_kind})")
    if len(devs) < want:
        raise SystemExit(f"chip_smoke: needs {want} GPUs, JAX found {len(devs)}")
    from pcr_tpu.utils import device

    print(f"nvidia-smi: {device.nvidia_smi()}")
    print(f"jax {jax.__version__}: {len(devs)} x {devs[0].device_kind}")
    print(f"compile cache: {jax.config.jax_compilation_cache_dir} "
          f"(JAX_COMPILATION_CACHE_DIR "
          f"{'set' if 'JAX_COMPILATION_CACHE_DIR' in os.environ else 'unset'})")
    print(f"matmul precision: {jax.config.jax_default_matmul_precision}")


# ---------------------------------------------------------------------------
# (c) kernels at real width vs the plain references
# ---------------------------------------------------------------------------

def _nn_agreement(name, d_fast, d_ref, max_dist, q):
    """A pruned NN search vs the exact tiled merge.  ``nn1_exact`` ranks by
    the matmul metric |q|^2 + |r|^2 - 2 q.r, whose float32 cancellation is
    ~3 ulp(|q|^2 + |r|^2); the pruned searches rank by exact differences.
    So the pruned search may find a NEARER neighbour than the merge by up to
    that bound, and must never be farther beyond fp rounding."""
    r2 = max_dist * max_dist
    v_fast, v_ref = d_fast <= r2, d_ref <= r2
    both = v_fast & v_ref
    canc = 3 * np.spacing(np.float32(2 * np.max(np.sum(q * q, axis=1))))
    worse = d_fast[both] - d_ref[both]
    n_mis = int(np.sum(v_fast != v_ref))
    print(f"{name}: {int(both.sum())} queries in radius, validity mismatch "
          f"{n_mis}, max(fast - exact) {worse.max():.3g} m^2, "
          f"max(exact - fast) {(-worse).max():.3g} m^2 "
          f"(cancellation bound {canc:.3g} m^2)")
    check(worse.max() <= 1e-6, f"{name} never farther than the exact merge "
          "(tolerance 1e-6 m^2: float32 rounding of one exact difference)")
    check((-worse).max() <= canc, f"{name} nearer than the exact merge by at "
          "most the merge's float32 cancellation bound")
    check(n_mis <= max(1, int(1e-3 * both.sum())),
          f"{name} radius validity agrees on >= 99.9% of queries (boundary "
          "cases within the cancellation bound may flip)")


def kernel_phase(scans) -> dict:
    import jax
    import jax.numpy as jnp

    from pcr_tpu.models import multiscale
    from pcr_tpu.ops import band_nn, fpfh, fpfh_sorted, grid_nn, knn, normals
    from pcr_tpu.ops import outlier, preprocess, voxel
    from pcr_tpu.utils import cloud, se3

    t0 = time.time()
    c0 = cloud.from_numpy(scans[0], capacity=BUCKET)
    c1 = cloud.from_numpy(scans[1], capacity=BUCKET)
    caps = cloud.plan_scale_caps([c0, c1], multiscale.create_scales(5))
    print(f"scan 0: {len(scans[0])} points; pyramid capacities {caps}")
    T_pert = np.asarray(se3.se3_exp(jnp.asarray(
        [0.01, -0.005, 0.02, 0.05, -0.03, 0.01], jnp.float32)))

    # GICP correspondence searches at the coarsest and finest pyramid scales
    for scale, (v, dist, cap) in {"coarsest": (0.5, 1.5, caps[0]),
                                  "finest": (0.1, 0.1, caps[-1])}.items():
        ref = preprocess.preprocess_scale_fused(c0, v, cap)
        q = se3.transform_points(jnp.asarray(T_pert), ref.points)
        q_np = np.asarray(q)[np.asarray(ref.mask)]
        d_ex, _ = knn.nn1_exact(q, ref.points, ref.mask)
        grid = grid_nn.build_grid(ref.points, ref.mask, dist)
        d_gr, _ = grid_nn.nn1_grid(grid, q, dist)
        index = band_nn.build_band_index(q, ref.mask, ref.points, ref.mask)
        d_bd, _ = band_nn.nn1_band_query(index, q, ref.mask, dist)
        m = np.asarray(ref.mask)
        d_ex = np.asarray(d_ex)[m]
        _nn_agreement(f"nn1_grid ({scale}, r={dist} m)",
                      np.asarray(d_gr)[m], d_ex, dist, q_np)
        _nn_agreement(f"nn1_band_query ({scale}, r={dist} m)",
                      np.asarray(d_bd)[m], d_ex, dist, q_np)

    # fused preprocess vs the exact outlier -> normals chain (finest scale)
    fused = preprocess.preprocess_scale_fused(c0, VOXEL, caps[-1])
    d = voxel.voxel_downsample_cloud(c0, VOXEL)
    d = cloud.Cloud(points=d.points[:caps[-1]], mask=d.mask[:caps[-1]])
    chain = normals.with_normals_knn(outlier.remove_statistical_outliers(d, 30, 1.0), 20)
    f_pts = np.asarray(fused.points)[np.asarray(fused.mask)]
    e_pts = np.asarray(chain.points)[np.asarray(chain.mask)]
    f_key = {tuple(p): i for i, p in enumerate(f_pts.round(4).tolist())}
    e_key = {tuple(p): i for i, p in enumerate(e_pts.round(4).tolist())}
    common = sorted(set(f_key) & set(e_key))
    fused_only = len(f_key) - len(common)
    chain_only = len(e_key) - len(common)
    fn = np.asarray(fused.normals)[np.asarray(fused.mask)]
    en = np.asarray(chain.normals)[np.asarray(chain.mask)]
    a = fn[[f_key[k] for k in common]]
    b = en[[e_key[k] for k in common]]
    nd = np.minimum(np.linalg.norm(a - b, axis=1), np.linalg.norm(a + b, axis=1))
    print(f"preprocess_scale_fused: {len(f_key)} survivors vs chain "
          f"{len(e_key)}: {fused_only} kept only by the fused op, "
          f"{chain_only} only by the chain; normal diff median "
          f"{np.median(nd):.3g}, p90 {np.quantile(nd, 0.9):.3g}")
    check(fused_only <= max(1, 0.002 * len(f_key)),
          "fused survivors are a subset of the chain's (<= 0.2% exceptions "
          "from threshold ties)")
    check(chain_only <= 0.05 * len(e_key),
          "fused op removes at most 5% more than the chain (its spacing-hint "
          "branch keeps stragglers out of mu/sigma and bisects its "
          "thresholds: a documented, stricter filter)")
    check(np.median(nd) < 0.02 and np.quantile(nd, 0.9) < 0.2,
          "fused normals: median diff < 0.02, p90 < 0.2 (neighbourhood "
          "thresholds may differ by a point or two; CPU-test bounds)")

    # banded stage-1 features vs the oracle FPFH on the same normals
    feats = []
    for c in (c0, c1):
        cc = cloud.compact(c, cloud.bucket_capacity(c))
        feats.append(fpfh_sorted.fgr_features_sorted(cc, VOXEL, band=2048))
    cs, fs = feats[0]
    oracle = fpfh.fpfh(cs.points, cs.normals, cs.mask, 10 * VOXEL, 200)
    m = np.asarray(cs.mask)
    F, O = np.asarray(fs)[m], np.asarray(oracle)[m]
    l1 = np.abs(F - O).sum(1) / (np.abs(O).sum(1) + 1e-9)
    print(f"fgr_features_sorted vs fpfh.fpfh: relative L1 median "
          f"{np.median(l1):.3g}, p95 {np.quantile(l1, 0.95):.3g}, "
          f"{int(m.sum())} points")
    check(np.median(l1) < 0.07, "banded FPFH median relative L1 < 0.07 vs the "
          "oracle (the CPU tests' bound; bands that miss a true neighbour "
          "widen the threshold)")

    # mutual feature matching vs two exact nearest-neighbour passes
    (ca, fa), (cb, fb) = feats
    n = max(ca.capacity, cb.capacity)
    ca, cb = cloud.pad_to(ca, n), cloud.pad_to(cb, n)
    fa = jnp.pad(fa, ((0, n - fa.shape[0]), (0, 0)))
    fb = jnp.pad(fb, ((0, n - fb.shape[0]), (0, 0)))
    ij, ji = knn.nn1_mutual(fa, ca.mask, fb, cb.mask)
    _, ij_ex = knn.nn1_exact(fa, fb, cb.mask)
    _, ji_ex = knn.nn1_exact(fb, fa, ca.mask)
    for name, got, ex, qf, rf, qm in (
            ("a->b", ij, ij_ex, fa, fb, ca.mask),
            ("b->a", ji, ji_ex, fb, fa, cb.mask)):
        qm = np.asarray(qm)
        got, ex = np.asarray(got)[qm], np.asarray(ex)[qm]
        qf64, rf64 = np.asarray(qf, np.float64)[qm], np.asarray(rf, np.float64)
        dg = np.sum((qf64 - rf64[got]) ** 2, axis=1)
        de = np.sum((qf64 - rf64[ex]) ** 2, axis=1)
        tol = 3 * np.spacing(np.float32(2 * np.max(np.sum(rf64 ** 2, axis=1))))
        diff = int(np.sum(got != ex))
        print(f"nn1_mutual {name}: {diff} of {len(got)} indices differ from "
              f"nn1_exact; max |d_mutual - d_exact| {np.abs(dg - de).max():.3g} "
              f"(tolerance {tol:.3g})")
        check(np.abs(dg - de).max() <= tol, f"nn1_mutual {name} picks a "
              "neighbour as near as nn1_exact's within the matmul metric's "
              "float32 cancellation (different tilings may break near-ties "
              "differently)")
    jax.effects_barrier()
    return {"seconds": time.time() - t0}


# ---------------------------------------------------------------------------
# (d) main path
# ---------------------------------------------------------------------------

def _stage2_check(label: str, root: str, rel_gt: np.ndarray,
                  fgr_dir: str | None = None) -> None:
    """Stage-2 relative poses under ``root`` against ground truth, and
    against the stage-1 poses that seeded them (under ``fgr_dir``, default
    ``root``)."""
    from pcr_tpu.utils import poses_io

    errs = {}
    for stage, d in (("FGR", fgr_dir or root), ("FGR_GICP", root)):
        est = poses_io.load_relative_circuit(
            os.path.join(d, f"relative_poses_{stage}", "NCLT"), len(rel_gt))
        dt, dr = errs[stage] = pose_errors(est, rel_gt)
        print(f"{label}: {stage} vs ground truth: translation median "
              f"{np.median(dt):.4f} m, max {dt.max():.4f} m; rotation max "
              f"{dr.max():.4f} deg; per pair dt {np.round(dt, 4).tolist()}")
    dt, dr = errs["FGR_GICP"]
    check(np.median(dt) <= MEDIAN_T_ERR and dt.max() <= MAX_T_ERR
          and dr.max() <= MAX_R_ERR_DEG,
          f"{label}: stage 2 median dt <= {MEDIAN_T_ERR} m, max dt <= "
          f"{MAX_T_ERR} m, max dR <= {MAX_R_ERR_DEG} deg")
    check(np.median(dt) <= STAGE1_GAIN * np.median(errs["FGR"][0]),
          f"{label}: stage 2 median dt <= {STAGE1_GAIN} x stage 1's")


def main_path_phase(rel_gt: np.ndarray) -> dict:
    import jax

    from pcr_tpu import __main__ as cli

    out = {}
    for run in ("cold", "warm"):
        root = os.path.join(WORK, "outputs", run)
        t0 = time.time()
        rc = cli.main(["full", "--dataset", "NCLT", "--n", str(N_SCANS),
                       "--output-root", root])
        dt = time.time() - t0
        check(rc == 0, f"full run ({run}) exit code 0")
        print(f"full run ({run}): {dt:.2f} s for {N_SCANS} pairs, stages 1-3")
        out[f"{run}_seconds"] = dt
        _stage2_check(f"full run ({run})", root, rel_gt)
        for m in ("LUM", "SLERP", "SLERP_LUM", "pose_graph"):
            check(os.path.exists(os.path.join(
                root, f"absolute_poses_{m}", "NCLT", f"pose{N_SCANS - 1}.txt")),
                f"full run ({run}) wrote stage-3 {m} poses")
    stats = jax.devices()[0].memory_stats() or {}
    out["peak_bytes_in_use"] = stats.get("peak_bytes_in_use")
    print(f"peak_bytes_in_use: {out['peak_bytes_in_use']}")
    return out


# ---------------------------------------------------------------------------
# (e) four devices
# ---------------------------------------------------------------------------

def _cli_run(cli, argv: list[str], label: str) -> float:
    """One in-process CLI run; seconds.  A run that outlives HANG_SECONDS
    dumps every thread's stack to stderr and ends the process."""
    import faulthandler

    print(f"{label}: start", flush=True)
    faulthandler.dump_traceback_later(HANG_SECONDS, exit=True)
    t0 = time.time()
    try:
        rc = cli.main(argv)
    finally:
        faulthandler.cancel_dump_traceback_later()
    dt = time.time() - t0
    check(rc == 0, f"{label} exit code 0 ({dt:.2f} s)")
    return dt


def four_chip_phase(rel_gt: np.ndarray, only: str | None = None) -> dict:
    """The single-device baseline once, then the 2x2 pairs x points mesh and
    the 4-device pairs mesh, each compared with the baseline as soon as it
    ends."""
    from pcr_tpu import __main__ as cli
    from pcr_tpu.utils import poses_io

    base = ["--dataset", "NCLT", "--n", str(N_SCANS)]
    root = os.path.join(WORK, "four")
    result = {"seconds": {}}

    def run(name, stage, mesh, *extra):
        argv = [stage, *base, *mesh, *extra,
                "--output-root", os.path.join(root, name)]
        result["seconds"][f"{name}_{stage}"] = _cli_run(cli, argv, f"{name} {stage}")

    def load(name, stage):
        return poses_io.load_relative_circuit(
            os.path.join(root, name, f"relative_poses_{stage}", "NCLT"), N_SCANS)

    def compare(name, stage):
        # Batch composition and psum order change float32 reduction order,
        # and the chunks' capacity buckets differ.  Stage 1 may move inside
        # its own error (tens of mm); stage 2 converges to the same optimum.
        tol_m, tol_deg = (0.05, 0.5) if stage == "FGR" else (0.005, 0.1)
        dt, dr = pose_errors(load(name, stage), load("devices1", stage))
        key = f"{name}_vs_devices1_{stage}"
        result[key] = {"max_dt_m": float(dt.max()), "max_dR_deg": float(dr.max())}
        print(f"{key}: max translation diff {dt.max():.3g} m, max rotation "
              f"diff {dr.max():.3g} deg", flush=True)
        check(dt.max() <= tol_m and dr.max() <= tol_deg,
              f"{key}: poses agree within {tol_m} m / {tol_deg} deg")

    run("devices1", "stage1", ["--devices", "1"])
    run("devices1", "stage2", ["--devices", "1"])
    _stage2_check("devices1", os.path.join(root, "devices1"), rel_gt)
    if only in (None, "points"):
        # stage 2 from the baseline's stage-1 poses
        run("pairs2_points2", "stage2", ["--devices", "2", "--shard-points", "2"],
            "--init", os.path.join(root, "devices1", "relative_poses_FGR", "NCLT"))
        compare("pairs2_points2", "FGR_GICP")
        _stage2_check("pairs2_points2", os.path.join(root, "pairs2_points2"),
                      rel_gt, fgr_dir=os.path.join(root, "devices1"))
    if only in (None, "pairs"):
        run("devices4", "stage1", ["--devices", "4"])
        compare("devices4", "FGR")
        run("devices4", "stage2", ["--devices", "4"])
        compare("devices4", "FGR_GICP")
        _stage2_check("devices4", os.path.join(root, "devices4"), rel_gt)
    print("four-device result: " + json.dumps(result))
    return result


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1,
                    help="4: run only the four-device mesh phase")
    ap.add_argument("--only", choices=("points", "pairs"), default=None,
                    help="with --chips 4: the baseline and only the 2x2 "
                         "pairs x points mesh, or only the 4-device pairs mesh")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.only and args.chips != 4:
        ap.error("--only needs --chips 4")

    # pcr_tpu reads its data root when it is first imported
    os.environ["PCR_REFERENCE_ROOT"] = DATA_ROOT
    import jax

    t_start = time.time()
    device_phase(jax, args.chips)   # (a) — exits unless JAX found GPUs

    # (b) data
    shutil.rmtree(WORK, ignore_errors=True)
    scans, poses = generate(args.seed)
    counts = [len(s) for s in scans]
    print(f"generated {N_SCANS} scans (seed {args.seed}): points per scan "
          f"min {min(counts)}, max {max(counts)}")
    check(all(20000 <= c <= 31000 for c in counts) and max(counts) <= BUCKET,
          "every scan holds 20k-31k points, inside the 32,768 bucket")
    write_dataset(DATA_ROOT, scans)
    rel_gt = relative_ground_truth(poses)
    print(f"ground-truth step lengths: min "
          f"{np.linalg.norm(rel_gt[:, :3, 3], axis=1).min():.3f} m, max "
          f"{np.linalg.norm(rel_gt[:, :3, 3], axis=1).max():.3f} m")

    report = {}
    with jax.default_matmul_precision("highest"):
        if args.chips == 4:
            report["four"] = four_chip_phase(rel_gt, args.only)
        else:
            report["kernels"] = kernel_phase(scans)
            report["main"] = main_path_phase(rel_gt)
    report["total_seconds"] = time.time() - t_start
    print("report: " + json.dumps(report))
    devs = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
