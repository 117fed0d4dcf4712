"""Kernel tests vs numpy oracles (SURVEY §4b): knn, voxel, outlier, normals."""

import numpy as np
import jax.numpy as jnp

from pcr_tpu.ops import eigen3, knn, normals, outlier, voxel
from pcr_tpu.utils import cloud


def make_points(rng, n, cap=None, scale=10.0):
    pts = rng.normal(size=(n, 3)).astype(np.float32) * scale
    c = cloud.from_numpy(pts, capacity=cap)
    return pts, c


def np_knn(query, ref, k, exclude_self=False):
    d2 = ((query[:, None, :] - ref[None, :, :]) ** 2).sum(-1)
    if exclude_self:
        np.fill_diagonal(d2, np.inf)
    idx = np.argsort(d2, axis=1)[:, :k]
    return np.take_along_axis(d2, idx, axis=1), idx


def test_knn_exact_small(rng):
    pts, c = make_points(rng, 300, cap=512)
    d2, idx = knn.knn(c.points, c.points, c.mask, 8, q_tile=128, r_chunk=256)
    d2, idx = np.asarray(d2)[:300], np.asarray(idx)[:300]
    od2, oidx = np_knn(pts, pts, 8)
    np.testing.assert_allclose(d2, od2, rtol=1e-4, atol=1e-5)
    # indices may differ on exact ties; check distances of chosen points instead
    chosen = ((pts[:, None, :] - pts[idx]) ** 2).sum(-1)
    np.testing.assert_allclose(chosen, od2, rtol=1e-4, atol=1e-5)


def test_knn_exclude_self(rng):
    pts, c = make_points(rng, 200, cap=256)
    d2, idx = knn.knn(c.points, c.points, c.mask, 5, exclude_self=True, q_tile=64, r_chunk=128)
    idx = np.asarray(idx)[:200]
    assert not np.any(idx == np.arange(200)[:, None])
    od2, _ = np_knn(pts, pts, 5, exclude_self=True)
    np.testing.assert_allclose(np.asarray(d2)[:200], od2, rtol=1e-4, atol=1e-5)


def test_knn_approx_norescore_matches_exact(rng):
    """knn_approx(rescore=False) returns the same neighbor sets as the exact
    path (on CPU approx_min_k is exact), with matmul-metric distances within
    the documented ~1e-3 cancellation tolerance, and never returns self."""
    pts, c = make_points(rng, 300, cap=512, scale=100.0)
    d2a, idxa = knn.knn_approx(c.points, c.points, c.mask, 8,
                               exclude_self=True, q_tile=128, rescore=False)
    d2e, idxe = knn.knn_exact(c.points, c.points, c.mask, 8,
                              exclude_self=True, q_tile=128, r_chunk=256)
    d2a, idxa = np.asarray(d2a)[:300], np.asarray(idxa)[:300]
    assert not np.any(idxa == np.arange(300)[:, None])
    assert (d2a >= 0.0).all()
    np.testing.assert_allclose(d2a, np.asarray(d2e)[:300], rtol=1e-3, atol=5e-2)
    # same neighbor sets (order within ties may differ)
    assert np.array_equal(np.sort(idxa, axis=1), np.sort(np.asarray(idxe)[:300], axis=1))


def test_knn_approx_norescore_pads_invalid(rng):
    pts = rng.normal(size=(5, 3)).astype(np.float32)
    c = cloud.from_numpy(pts, capacity=64)
    d2, idx = knn.knn_approx(c.points, c.points, c.mask, 8, q_tile=64, rescore=False)
    d2 = np.asarray(d2)[:5]
    assert (d2[:, :5] < knn.BIG).all()
    assert (d2[:, 5:] >= knn.BIG).all()


def test_knn_respects_mask(rng):
    pts = rng.normal(size=(100, 3)).astype(np.float32)
    c = cloud.from_numpy(pts, capacity=256)  # 156 padded invalid points
    _, idx = knn.knn(c.points, c.points, c.mask, 4, q_tile=64, r_chunk=64)
    assert np.asarray(idx)[:100].max() < 100  # never selects padding


def test_knn_k_exceeds_valid(rng):
    pts = rng.normal(size=(5, 3)).astype(np.float32)
    c = cloud.from_numpy(pts, capacity=64)
    d2, idx = knn.knn(c.points, c.points, c.mask, 8, q_tile=64, r_chunk=64)
    d2 = np.asarray(d2)[:5]
    assert (d2[:, :5] < knn.BIG).all()
    assert (d2[:, 5:] >= knn.BIG).all()


def test_nn1_matches_knn(rng):
    a = rng.normal(size=(400, 3)).astype(np.float32)
    b = rng.normal(size=(300, 3)).astype(np.float32)
    ca, cb = cloud.from_numpy(a, capacity=512), cloud.from_numpy(b, capacity=512)
    d1, i1 = knn.nn1_exact(ca.points, cb.points, cb.mask, q_tile=128, r_chunk=128)
    od2, oidx = np_knn(a, b, 1)
    np.testing.assert_allclose(np.asarray(d1)[:400], od2[:, 0], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(i1)[:400], oidx[:, 0])


def test_nn1_mutual_matches_two_nn1(rng):
    """One-pass mutual NN (the FGR matching kernel) == two separate argmins,
    including masked rows on both sides and a non-multiple-of-tile size."""
    a = rng.normal(size=(300, 33)).astype(np.float32)
    b = rng.normal(size=(200, 33)).astype(np.float32)
    ca = cloud.from_numpy(rng.normal(size=(300, 3)).astype(np.float32), capacity=384)
    cb = cloud.from_numpy(rng.normal(size=(200, 3)).astype(np.float32), capacity=256)
    fa = np.zeros((384, 33), np.float32); fa[:300] = a
    fb = np.zeros((256, 33), np.float32); fb[:200] = b
    ij, ji = knn.nn1_mutual(jnp.asarray(fa), ca.mask, jnp.asarray(fb), cb.mask,
                            q_tile=128)
    d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    np.testing.assert_array_equal(np.asarray(ij)[:300], d2.argmin(axis=1))
    np.testing.assert_array_equal(np.asarray(ji)[:200], d2.argmin(axis=0))


def test_normals_hybrid_from_knn_matches_direct(rng):
    """Sharing the FPFH k=200 selection with normals (fgr_features) gives the
    same hybrid(r, 20) normals as the direct path on exact-selection data."""
    pts, c = make_points(rng, 300, cap=512, scale=1.0)
    n_direct, cov_direct = normals.estimate_normals_hybrid(c.points, c.mask, 0.8, 20)
    d2, idx = knn.knn_exact(c.points, c.points, c.mask, 64, exclude_self=True,
                            q_tile=128, r_chunk=256)
    n_shared, cov_shared = normals.estimate_normals_hybrid_from_knn(
        c.points, c.mask, d2, idx, 0.8, 20)
    # atol 2e-3: a neighbor exactly at the radius boundary can flip in/out
    # between the two paths' distance computations (matmul-metric vs exact),
    # perturbing that point's covariance/normal slightly.
    np.testing.assert_allclose(np.asarray(n_shared), np.asarray(n_direct),
                               rtol=1e-3, atol=2e-3)
    np.testing.assert_allclose(np.asarray(cov_shared), np.asarray(cov_direct),
                               rtol=1e-3, atol=1e-4)


def test_hybrid_radius_gate(rng):
    pts, c = make_points(rng, 200, cap=256, scale=1.0)
    d2, idx, valid = knn.hybrid(c.points, c.points, c.mask, 10, radius=0.5, q_tile=64, r_chunk=64)
    d2, valid = np.asarray(d2)[:200], np.asarray(valid)[:200]
    assert (d2[valid] <= 0.25 + 1e-6).all()
    assert (d2[~valid] > 0.25 - 1e-6).all() or (d2[~valid] >= knn.BIG).any()


def test_eigh3_matches_numpy(rng):
    A = rng.normal(size=(64, 3, 3)).astype(np.float32)
    A = A @ np.swapaxes(A, -1, -2)  # PSD
    w, V = eigen3.eigh3(jnp.asarray(A))
    w, V = np.asarray(w), np.asarray(V)
    ow = np.linalg.eigvalsh(A)
    np.testing.assert_allclose(w, ow, rtol=1e-3, atol=1e-4)
    # Eigen equation A v = w v
    for i in range(3):
        lhs = np.einsum("nij,nj->ni", A, V[..., i])
        rhs = w[:, i, None] * V[..., i]
        np.testing.assert_allclose(lhs, rhs, atol=2e-3)


def test_eigh3_degenerate():
    A = np.stack([np.eye(3, dtype=np.float32), np.diag([2.0, 2.0, 1.0]).astype(np.float32)])
    w, V = eigen3.eigh3(jnp.asarray(A))
    w, V = np.asarray(w), np.asarray(V)
    np.testing.assert_allclose(w[0], [1, 1, 1], atol=5e-4)
    np.testing.assert_allclose(w[1], [1, 2, 2], atol=5e-4)
    # orthonormal frames even with repeated eigenvalues
    for i in range(2):
        np.testing.assert_allclose(V[i].T @ V[i], np.eye(3), atol=1e-4)


def test_voxel_downsample_centroids(rng):
    # Points laid out so voxel membership is unambiguous
    base = rng.integers(0, 6, size=(500, 3)).astype(np.float32)
    jitter = rng.uniform(0.2, 0.8, size=(500, 3)).astype(np.float32)
    pts = base + jitter
    c = cloud.from_numpy(pts, capacity=512)
    out_pts, out_mask = voxel.voxel_downsample(c.points, c.mask, 1.0)
    out_pts, out_mask = np.asarray(out_pts), np.asarray(out_mask)
    n_out = out_mask.sum()
    # Oracle: group by integer cell
    cells = np.floor((pts - pts.min(0)) / 1.0).astype(int)
    keys = {}
    for p, ckey in zip(pts, map(tuple, cells)):
        keys.setdefault(ckey, []).append(p)
    oracle = {k: np.mean(v, axis=0) for k, v in keys.items()}
    assert n_out == len(oracle)
    got = sorted(map(tuple, out_pts[:n_out].round(4)))
    want = sorted(map(tuple, np.stack(list(oracle.values())).round(4)))
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_outlier_removal(rng):
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    outliers = rng.normal(size=(10, 3)).astype(np.float32) * 50.0 + 100.0
    all_pts = np.concatenate([pts, outliers])
    c = cloud.from_numpy(all_pts, capacity=512)
    filtered = outlier.remove_statistical_outliers(c, nb_neighbors=20, std_ratio=1.0)
    mask = np.asarray(filtered.mask)
    assert not mask[300:310].any()          # far-away outliers dropped
    assert mask[:300].sum() > 200           # bulk kept


def test_normals_on_plane(rng):
    xy = rng.uniform(-1, 1, size=(400, 2)).astype(np.float32)
    pts = np.concatenate([xy, 0.001 * rng.normal(size=(400, 1)).astype(np.float32)], axis=1)
    c = cloud.from_numpy(pts, capacity=512)
    n, cov = normals.estimate_normals_knn(c.points, c.mask, 20)
    n = np.asarray(n)[:400]
    # normals ~ +-Z with nz >= 0 sign convention
    assert (np.abs(n[:, 2]) > 0.99).all()
    assert (n[:, 2] >= 0).all()


def test_normals_hybrid_radius(rng):
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    c = cloud.from_numpy(pts, capacity=512)
    n, cov = normals.estimate_normals_hybrid(c.points, c.mask, radius=0.4, k=20)
    n = np.asarray(n)[:300]
    norms = np.linalg.norm(n, axis=1)
    # each normal is either unit (enough neighbors in radius) or zero
    assert ((np.abs(norms - 1) < 1e-4) | (norms < 1e-6)).all()


def test_cloud_mean_covariance(rng):
    pts = rng.normal(size=(500, 3)).astype(np.float32) * [1.0, 2.0, 3.0]
    c = cloud.from_numpy(pts, capacity=512)
    mean, cov = normals.cloud_mean_and_covariance(c.points, c.mask)
    np.testing.assert_allclose(np.asarray(mean), pts.mean(0), atol=1e-4)
    np.testing.assert_allclose(np.asarray(cov), np.cov(pts.T, bias=True), rtol=1e-3, atol=1e-3)
