"""Banded gather-free stage-1 features (ops/fpfh_sorted) vs the exact FPFH
oracle and the selection-path implementations."""

import numpy as np
import jax.numpy as jnp

from pcr_tpu.ops import fpfh_sorted
from pcr_tpu.utils import cloud
from tests.test_fpfh import np_fpfh


def test_banded_fpfh_matches_oracle(rng):
    """With a full-coverage band the banded neighborhoods equal the exact
    hybrid sets, so the features must match the O(n^2) numpy oracle (up to
    bin-edge jitter + bisection threshold slack admitting a tied neighbor)."""
    pts = rng.uniform(-1, 1, size=(96, 3)).astype(np.float32)
    nrm = rng.normal(size=(96, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    c = cloud.from_numpy(pts, capacity=128)
    nin = np.zeros((128, 3), np.float32)
    nin[:96] = nrm
    c2, f2 = fpfh_sorted.fgr_features_sorted(
        c, 0.1, q_tile=128, band=128, max_nn=25, normals_in=jnp.asarray(nin))
    P2, M2, N2 = np.asarray(c2.points), np.asarray(c2.mask), np.asarray(c2.normals)
    assert M2.sum() == 96
    oracle = np_fpfh(P2[M2].astype(np.float64), N2[M2].astype(np.float64), 1.0, 25)
    F2 = np.asarray(f2)[M2]
    l1 = np.abs(F2 - oracle).sum(1) / (np.abs(oracle).sum(1) + 1e-9)
    assert (l1 < 0.07).mean() > 0.95, (np.median(l1), l1.max())
    np.testing.assert_allclose(F2.sum(), oracle.sum(), rtol=0.02)


def test_banded_normals_match_selection_path(rng):
    """The banded moments normals must agree with the selection-path hybrid
    normals (same Hybrid(2v, 20) semantics, same nz >= 0 sign convention)."""
    from pcr_tpu.models import fgr as fgr_mod

    pts = rng.uniform(-2, 2, size=(800, 3)).astype(np.float32)
    pts[:, 2] = 0.1 * np.sin(pts[:, 0] * 2) + 0.05 * pts[:, 1]
    c = cloud.from_numpy(pts, capacity=1024)
    c1, _ = fgr_mod.fgr_features(c, 0.2)
    c2, _ = fpfh_sorted.fgr_features_sorted(c, 0.2, q_tile=256, band=512)
    P1, M1, N1 = np.asarray(c1.points), np.asarray(c1.mask), np.asarray(c1.normals)
    P2, M2, N2 = np.asarray(c2.points), np.asarray(c2.mask), np.asarray(c2.normals)
    lookup = {tuple(np.round(P1[i], 5)): i for i in range(len(P1)) if M1[i]}
    diffs = []
    for j in range(len(P2)):
        if not M2[j]:
            continue
        i = lookup[tuple(np.round(P2[j], 5))]
        diffs.append(min(np.linalg.norm(N1[i] - N2[j]),
                         np.linalg.norm(N1[i] + N2[j])))
    diffs = np.asarray(diffs)
    assert np.median(diffs) < 1e-3
    assert (diffs < 0.1).mean() > 0.97, np.percentile(diffs, 99)


def test_banded_features_padding_invariance(rng):
    """Features of the valid points must not depend on the padding capacity."""
    pts = rng.uniform(-1, 1, size=(200, 3)).astype(np.float32)
    nrm = rng.normal(size=(200, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)

    def run(cap):
        c = cloud.from_numpy(pts, capacity=cap)
        nin = np.zeros((cap, 3), np.float32)
        nin[:200] = nrm
        c2, f2 = fpfh_sorted.fgr_features_sorted(
            c, 0.1, q_tile=128, band=256, max_nn=25,
            normals_in=jnp.asarray(nin))
        P, M, F = np.asarray(c2.points), np.asarray(c2.mask), np.asarray(f2)
        order = np.lexsort(P[M].T)
        return P[M][order], F[M][order]

    P_a, F_a = run(256)
    P_b, F_b = run(384)
    np.testing.assert_allclose(P_a, P_b, atol=0)
    np.testing.assert_allclose(F_a, F_b, atol=1e-3)


def test_banded_downstream_fgr_recovers_pose(rng):
    """End-to-end: FGR with banded features recovers a known pose on
    overlapping synthetic scans (the downstream validation path the module
    docstring promises)."""
    from pcr_tpu.models import fgr as fgr_mod
    from pcr_tpu.utils import se3
    from tests.test_pipeline import _bumpy_clouds
    from pcr_tpu import pipeline as pl

    clouds, gt = _bumpy_clouds(rng, n_clouds=2, n=900, cap=1024, step=0.3)
    feats = [fpfh_sorted.fgr_features_sorted(c, 0.2, q_tile=256, band=512)
             for c in clouds]
    (tgt, ft), (src, fs) = feats
    opts = fgr_mod.default_options(src, tgt, 0.2)
    res = fgr_mod.registration_fgr(src, tgt, fs, ft, opts, seed=1)
    _, dt = se3.pose_errors(np.asarray(res.transformation, np.float64), gt[1])
    assert float(res.fitness) > 0.4
    assert float(dt) < 0.25, (dt, np.asarray(res.transformation))
