"""FGR tests: matching, tuple test, GNC convergence on synthetic + real data."""

import os

import numpy as np
import pytest
import jax.numpy as jnp

from pcr_tpu.models import fgr
from pcr_tpu.utils import cloud, poses_io, se3
from tests.conftest import random_rotation

HAVE_REF = os.path.isdir(os.path.join(poses_io.REFERENCE_ROOT, "nuvens"))


def test_match_features_mutual(rng):
    f = rng.normal(size=(50, 33)).astype(np.float32)
    perm = rng.permutation(50)
    fa = cloud.from_numpy(np.zeros((50, 3), np.float32), capacity=64)
    # identical features permuted -> mutual matches recover the permutation
    feat_a = np.zeros((64, 33), np.float32); feat_a[:50] = f
    feat_b = np.zeros((64, 33), np.float32); feat_b[:50] = f[perm] + 0.001 * rng.normal(size=(50, 33))
    ci, cj, m = fgr.match_features(jnp.asarray(feat_a), fa.mask, jnp.asarray(feat_b), fa.mask)
    ci, cj, m = np.asarray(ci), np.asarray(cj), np.asarray(m)
    inv = np.argsort(perm)
    assert m[:50].mean() > 0.9
    matched = m[:50]
    np.testing.assert_array_equal(cj[:50][matched], inv[matched])


def test_tuple_test_filters_bad_pairs(rng):
    n = 100
    pts_src = rng.uniform(-5, 5, size=(n, 3)).astype(np.float32)
    R = random_rotation(rng).astype(np.float32)
    t = np.array([1.0, -2.0, 0.5], np.float32)
    pts_tgt = pts_src @ R.T + t
    # corrupt 30 correspondences to random targets (wrong geometry)
    corr_j = np.arange(n, dtype=np.int32)
    bad = rng.choice(n, size=30, replace=False)
    corr_j[bad] = rng.permutation(n)[:30]
    keep = fgr.tuple_test(
        jnp.asarray(pts_src), jnp.asarray(pts_tgt),
        jnp.arange(n, dtype=jnp.int32), jnp.asarray(corr_j),
        jnp.ones(n, dtype=bool), seed=0, max_tuples=512, n_trials=4096,
    )
    keep = np.asarray(keep)
    good = np.setdiff1d(np.arange(n), bad[corr_j[bad] != bad])
    truly_bad = bad[corr_j[bad] != bad]
    assert keep[good].mean() > 0.9          # good pairs survive
    assert keep[truly_bad].mean() < 0.3     # corrupted pairs mostly culled


def test_fgr_gnc_recovers_pose(rng):
    n = 400
    pts = rng.uniform(-3, 3, size=(n, 3)).astype(np.float32)
    R = random_rotation(rng).astype(np.float32)
    t = np.array([0.5, -1.0, 2.0], np.float32)
    src = cloud.from_numpy(pts, capacity=512)
    tgt = cloud.from_numpy((pts @ R.T + t).astype(np.float32), capacity=512)
    T_gt = np.eye(4, dtype=np.float32); T_gt[:3, :3] = R; T_gt[:3, 3] = t
    corr = jnp.arange(512, dtype=jnp.int32)
    opts = fgr.FgrOptions(maximum_correspondence_distance=0.2, iteration_number=128)
    T = np.asarray(fgr.fgr_from_correspondences(src, tgt, corr, corr, src.mask, opts))
    dR, dt = se3.pose_errors(T, T_gt)
    assert float(dt) < 1e-2, (T, T_gt)
    assert float(dR) < 1e-2


@pytest.mark.slow
@pytest.mark.skipif(not HAVE_REF, reason="reference data not mounted")
def test_fgr_nclt_golden_pair():
    """[slow ~33 s on the CPU mesh, warm cache] Stage-1 golden test (VERDICT r1 item 2): the full registro_FGR pipeline
    on real NCLT scans s1->s0 must land near the shipped FGR fixture pose."""
    c0, c1 = cloud.load_dataset("NCLT", indices=[0, 1])
    res = fgr.registro_fgr(c1, c0, voxel_size=0.1, seed=1)
    T = np.asarray(res.transformation, np.float64)
    T_ref = poses_io.load_pose(
        os.path.join(poses_io.reference_fixture_dir("FGR", "NCLT"), "pose_1_0.txt")
    )
    dR, dt = se3.pose_errors(T, T_ref)
    assert float(res.fitness) > 0.40          # the reference's success gate
    assert float(dt) < 0.20, (float(dt), T)   # FGR is tuple-sampled: loose tol
    assert float(dR) < 0.05, float(dR)


def test_fgr_gnc_robust_to_outlier_matches(rng):
    """GNC must reject 40% wrong correspondences."""
    n = 400
    pts = rng.uniform(-3, 3, size=(n, 3)).astype(np.float32)
    R = random_rotation(rng).astype(np.float32)
    t = np.array([0.3, 0.7, -0.2], np.float32)
    src = cloud.from_numpy(pts, capacity=512)
    tgt = cloud.from_numpy((pts @ R.T + t).astype(np.float32), capacity=512)
    T_gt = np.eye(4, dtype=np.float32); T_gt[:3, :3] = R; T_gt[:3, 3] = t
    corr_j = np.arange(512, dtype=np.int32)
    bad = rng.choice(n, size=160, replace=False)
    corr_j[bad] = rng.integers(0, n, size=160)
    opts = fgr.FgrOptions(maximum_correspondence_distance=0.2, iteration_number=256)
    T = np.asarray(
        fgr.fgr_from_correspondences(
            src, tgt, jnp.arange(512, dtype=jnp.int32), jnp.asarray(corr_j), src.mask, opts
        )
    )
    dR, dt = se3.pose_errors(T, T_gt)
    assert float(dt) < 0.05, float(dt)
    assert float(dR) < 0.05


def test_default_options_capacity_matches_cloud_form():
    """default_options_capacity(B) must equal default_options on two clouds
    padded to the same capacity B — the merged-window runners build options
    from the pair bucket BEFORE the pads happen inside the fused jit
    (pipeline._fgr_pair_step), and the two forms drifting apart would
    silently change maximum_tuple_count between the streamed and fused
    paths."""
    a = cloud.from_numpy(np.zeros((10, 3), np.float32), capacity=4096)
    b = cloud.from_numpy(np.zeros((10, 3), np.float32), capacity=4096)
    assert (fgr.default_options(a, b, 0.1)
            == fgr.default_options_capacity(4096, 0.1))
    assert (fgr.default_options_capacity(20480, 0.05).maximum_tuple_count
            == max(int(0.2 * 20480), 256))
