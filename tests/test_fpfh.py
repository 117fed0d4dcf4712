"""FPFH tests vs a straightforward numpy oracle of the Open3D scheme."""

import numpy as np
import jax.numpy as jnp

from pcr_tpu.ops import fpfh as fpfh_mod
from pcr_tpu.utils import cloud


def np_pair_features(p, np_, q, nq_):
    d = q - p
    dist = np.linalg.norm(d)
    if dist == 0:
        return None
    dn = d / dist
    a1, a2 = np_ @ dn, nq_ @ dn
    if abs(a2) > abs(a1):
        u, nt, dn_eff = nq_, np_, -dn
    else:
        u, nt, dn_eff = np_, nq_, dn
    f2 = u @ dn_eff
    v = np.cross(dn_eff, u)
    nv = np.linalg.norm(v)
    if nv < 1e-12:
        return None
    v = v / nv
    w = np.cross(u, v)
    f1 = v @ nt
    f3 = np.arctan2(w @ nt, u @ nt)
    return f1, f2, f3, dist


def np_fpfh(points, normals, radius, max_nn):
    n = len(points)
    d2 = ((points[:, None] - points[None]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    spfh = np.zeros((n, 33))
    nbrs = []
    for i in range(n):
        order = np.argsort(d2[i])[:max_nn]
        order = order[d2[i][order] <= radius**2]
        nbrs.append(order)
        if len(order) == 0:
            continue
        incr = 100.0 / len(order)
        for j in order:
            pf = np_pair_features(points[i], normals[i], points[j], normals[j])
            if pf is None:
                continue
            f1, f2, f3, _ = pf
            b1 = min(int(np.floor(11 * (f1 + 1) / 2)), 10)
            b2 = min(int(np.floor(11 * (f2 + 1) / 2)), 10)
            b3 = min(int(np.floor(11 * (f3 + np.pi) / (2 * np.pi))), 10)
            spfh[i, max(b1, 0)] += incr
            spfh[i, 11 + max(b2, 0)] += incr
            spfh[i, 22 + max(b3, 0)] += incr
    out = np.zeros((n, 33))
    for i in range(n):
        acc = np.zeros(33)
        for j in nbrs[i]:
            dist2 = d2[i, j]
            if dist2 == 0:
                continue
            acc += spfh[j] / dist2
        for blk in range(3):
            s = acc[blk * 11 : (blk + 1) * 11].sum()
            if s > 0:
                acc[blk * 11 : (blk + 1) * 11] *= 100.0 / s
        out[i] = acc + spfh[i]
    return out


def test_fpfh_matches_oracle(rng):
    pts = rng.uniform(-1, 1, size=(96, 3)).astype(np.float32)
    nrm = rng.normal(size=(96, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    c = cloud.from_numpy(pts, capacity=128)
    normals = np.zeros((128, 3), np.float32)
    normals[:96] = nrm
    feats = np.asarray(
        fpfh_mod.fpfh(c.points, jnp.asarray(normals), c.mask, radius=1.0, max_nn=25, nb_chunk=5)
    )[:96]
    oracle = np_fpfh(pts.astype(np.float64), nrm.astype(np.float64), 1.0, 25)
    # Bin-edge jitter from f32 vs f64 can move single histogram entries;
    # compare with a tolerance on the L1 distance per point.
    l1 = np.abs(feats - oracle).sum(1)
    scale = np.abs(oracle).sum(1) + 1e-9
    assert (l1 / scale < 0.05).mean() > 0.9, (l1 / scale).max()
    np.testing.assert_allclose(feats.sum(), oracle.sum(), rtol=0.02)


def test_fpfh_padding_invariance(rng):
    """Features must not depend on padding capacity."""
    pts = rng.uniform(-1, 1, size=(64, 3)).astype(np.float32)
    nrm = np.tile([0.0, 0.0, 1.0], (64, 1)).astype(np.float32)
    feats = []
    for cap in (64, 256):
        c = cloud.from_numpy(pts, capacity=cap)
        normals = np.zeros((cap, 3), np.float32)
        normals[:64] = nrm
        f = np.asarray(
            fpfh_mod.fpfh(c.points, jnp.asarray(normals), c.mask, radius=0.8, max_nn=10, nb_chunk=5)
        )[:64]
        feats.append(f)
    np.testing.assert_allclose(feats[0], feats[1], atol=1e-3)
