"""Fused preprocessing (ops/preprocess.py) vs the exact op chain.

The fused op trades exact kNN lists for threshold-based neighborhood
reductions (see module docstring); these tests pin how close it must stay to
the exact ops/outlier.py + ops/normals.py chain on synthetic LiDAR-like data.
"""

import numpy as np
import jax
import jax.numpy as jnp

from pcr_tpu.ops import normals, outlier, preprocess, voxel
from pcr_tpu.utils import cloud


def make_surface(rng, n=4000, cap=4096):
    """Bumpy 2.5D surface with a few far outliers (LiDAR-like)."""
    xy = rng.uniform(-10, 10, size=(n, 2)).astype(np.float32)
    z = (0.5 * np.sin(0.7 * xy[:, :1]) + 0.3 * np.cos(1.3 * xy[:, 1:2])).astype(
        np.float32
    )
    pts = np.concatenate([xy, z], axis=1)
    n_out = n // 100
    pts[:n_out, 2] += rng.uniform(3, 8, size=n_out).astype(np.float32)
    return cloud.from_numpy(pts, capacity=cap)


def test_fused_matches_exact_chain():
    rng = np.random.default_rng(0)
    c = make_surface(rng)

    exact = normals.with_normals_knn(
        outlier.remove_statistical_outliers(c, 30, 1.0), 20
    )
    fused = preprocess.outlier_and_normals_sorted(c.points, c.mask, 30, 1.0, 20)

    # same survivors (up to a small boundary set from threshold ties)
    e_pts = np.asarray(exact.points)[np.asarray(exact.mask)]
    f_pts = np.asarray(fused.points)[np.asarray(fused.mask)]
    e_set = {tuple(p) for p in e_pts.round(4).tolist()}
    f_set = {tuple(p) for p in f_pts.round(4).tolist()}
    inter = len(e_set & f_set)
    assert inter / max(len(e_set), len(f_set)) > 0.97, (len(e_set), len(f_set), inter)

    # normals agree on the common points (up to sign); small angular tail is
    # allowed where the neighborhood threshold differs by a point or two
    e_n = {tuple(p): n for p, n in zip(
        e_pts.round(4).tolist(), np.asarray(exact.normals)[np.asarray(exact.mask)].tolist())}
    diffs = []
    for p, n in zip(f_pts.round(4).tolist(),
                    np.asarray(fused.normals)[np.asarray(fused.mask)].tolist()):
        t = tuple(p)
        if t in e_n:
            a = np.asarray(n)
            b = np.asarray(e_n[t])
            diffs.append(min(np.linalg.norm(a - b), np.linalg.norm(a + b)))
    diffs = np.asarray(diffs)
    assert np.median(diffs) < 0.02, float(np.median(diffs))
    assert np.quantile(diffs, 0.9) < 0.2, float(np.quantile(diffs, 0.9))


def test_fused_spacing_hint_matches_exact_chain():
    """The production default (preprocess_scale_fused always passes
    voxel_size as spacing_hint) — the bisection branch must match the exact
    outlier+normals chain on voxel-downsampled input (ADVICE r1)."""
    rng = np.random.default_rng(5)
    v = 0.25
    c = voxel.voxel_downsample_cloud(make_surface(rng), v)

    exact = normals.with_normals_knn(
        outlier.remove_statistical_outliers(c, 30, 1.0), 20
    )
    fused = preprocess.outlier_and_normals_sorted(
        c.points, c.mask, 30, 1.0, 20, spacing_hint=v
    )

    e_pts = np.asarray(exact.points)[np.asarray(exact.mask)]
    f_pts = np.asarray(fused.points)[np.asarray(fused.mask)]
    e_set = {tuple(p) for p in e_pts.round(4).tolist()}
    f_set = {tuple(p) for p in f_pts.round(4).tolist()}
    inter = len(e_set & f_set)
    assert inter / max(len(e_set), len(f_set)) > 0.97, (len(e_set), len(f_set), inter)

    e_n = {tuple(p): n for p, n in zip(
        e_pts.round(4).tolist(), np.asarray(exact.normals)[np.asarray(exact.mask)].tolist())}
    diffs = []
    for p, n in zip(f_pts.round(4).tolist(),
                    np.asarray(fused.normals)[np.asarray(fused.mask)].tolist()):
        t = tuple(p)
        if t in e_n:
            a, b = np.asarray(n), np.asarray(e_n[t])
            diffs.append(min(np.linalg.norm(a - b), np.linalg.norm(a + b)))
    diffs = np.asarray(diffs)
    assert np.median(diffs) < 0.02, float(np.median(diffs))


def test_spacing_hint_guard():
    import pytest

    rng = np.random.default_rng(6)
    c = make_surface(rng)
    with pytest.raises(ValueError):
        preprocess.preprocess_scale_fused(c, 0.0)
    with pytest.raises(ValueError):
        preprocess.outlier_and_normals_sorted(c.points, c.mask, spacing_hint=-1.0)


def test_fused_removes_outliers():
    rng = np.random.default_rng(1)
    c = make_surface(rng)
    fused = preprocess.outlier_and_normals_sorted(c.points, c.mask, 30, 1.0, 20)
    pts = np.asarray(fused.points)[np.asarray(fused.mask)]
    # the injected far outliers (z > 2) must be gone
    assert (pts[:, 2] > 2.5).sum() == 0


def test_fused_normals_unit_and_masked():
    rng = np.random.default_rng(2)
    c = make_surface(rng)
    fused = preprocess.outlier_and_normals_sorted(c.points, c.mask, 30, 1.0, 20)
    n = np.asarray(fused.normals)
    m = np.asarray(fused.mask)
    np.testing.assert_allclose(np.linalg.norm(n[m], axis=1), 1.0, atol=1e-3)
    assert np.all(n[~m] == 0.0)


def test_preprocess_scale_fused_slices_capacity():
    rng = np.random.default_rng(3)
    c = make_surface(rng, n=4000, cap=4096)
    out = preprocess.preprocess_scale_fused(c, 0.5, scale_capacity=2048)
    assert out.capacity == 2048
    # voxel downsample at 0.5 on a 20x20 m extent -> well under 2048 voxels
    d = voxel.voxel_downsample_cloud(c, 0.5)
    assert int(d.mask.sum()) == int(out.mask.sum()) or int(out.mask.sum()) <= int(d.mask.sum())
    assert int(out.mask.sum()) > 500


def test_plan_scale_caps_covers_voxel_counts():
    """plan_scale_caps must never pick a capacity below the true number of
    occupied voxels (silent truncation), and should stay tight (one bucket)."""
    rng = np.random.default_rng(4)
    clouds = [make_surface(rng), make_surface(rng, n=3000)]
    scales = [0.5, 0.2]
    caps = cloud.plan_scale_caps(clouds, scales, bucket=256, margin=0)
    assert len(caps) == 2
    for v, cap in zip(scales, caps):
        worst = max(int(voxel.voxel_downsample_cloud(c, v).mask.sum()) for c in clouds)
        assert cap >= worst
        assert cap <= max(worst + 256, 256)
        assert cap % 256 == 0 or cap == clouds[0].capacity
