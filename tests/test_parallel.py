"""Multi-device tests on the virtual 8-device CPU mesh (SURVEY §4d):
sharded == single-device for pair-batched GICP and the distributed pose-graph
solve."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from pcr_tpu.models import gicp
from pcr_tpu.models.global_refine import pose_graph
from pcr_tpu.ops import normals as normals_ops
from pcr_tpu.parallel import distributed_pg, mesh as mesh_mod, pair_sharding
from pcr_tpu.utils import cloud, se3
from tests.test_global_refine import make_pose_graph

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices"
)


def make_pair_batch(rng, B=8, n=600, cap=640):
    srcs, tgts, Ts = [], [], []
    for b in range(B):
        xy = rng.uniform(-2, 2, size=(n, 2)).astype(np.float32)
        z = 0.3 * np.sin(2 * xy[:, 0]) + 0.2 * np.cos(3 * xy[:, 1])
        pts = np.concatenate([xy, z[:, None].astype(np.float32)], axis=1)
        xi = (rng.normal(size=6) * 0.02).astype(np.float32)
        T_gt = np.asarray(se3.se3_exp(jnp.asarray(xi)))
        src = normals_ops.with_normals_knn(cloud.from_numpy(pts, capacity=cap), 15)
        tgt_pts = (pts @ T_gt[:3, :3].T + T_gt[:3, 3]).astype(np.float32)
        tgt = normals_ops.with_normals_knn(cloud.from_numpy(tgt_pts, capacity=cap), 15)
        srcs.append(src); tgts.append(tgt); Ts.append(T_gt)
    return (
        cloud.stack_clouds(srcs),
        cloud.stack_clouds(tgts),
        np.stack([np.eye(4, dtype=np.float32)] * B),
        np.stack(Ts),
    )


def test_sharded_gicp_matches_unsharded(rng):
    src, tgt, T0, T_gt = make_pair_batch(rng)
    m = mesh_mod.make_pair_mesh(8)
    res_single = pair_sharding.batched_gicp(src, tgt, jnp.asarray(T0), 0.3, max_iteration=10)
    res_shard = pair_sharding.sharded_batched_gicp(m, src, tgt, jnp.asarray(T0), 0.3, max_iteration=10)
    np.testing.assert_allclose(
        np.asarray(res_shard.transformation), np.asarray(res_single.transformation),
        atol=1e-5,
    )
    # and both recover the ground truth
    T_all = np.asarray(res_shard.transformation)
    for b in range(8):
        _, dt = se3.pose_errors(T_all[b], T_gt[b])
        assert float(dt) < 0.01


def test_distributed_pose_graph_matches_single(rng):
    graph, _ = make_pose_graph(rng, 16, drift=0.03)
    m = mesh_mod.make_pair_mesh(8)
    mu = 10.0
    res_single = pose_graph.optimize_pose_graph_once(graph, mu=mu, max_iterations=30)
    res_dist = distributed_pg.distributed_optimize(m, graph, mu=mu, max_iterations=30)
    np.testing.assert_allclose(
        np.asarray(res_dist.nodes), np.asarray(res_single.nodes), atol=5e-4
    )


def test_distributed_global_optimization_closes_loop(rng):
    graph, _ = make_pose_graph(rng, 16, drift=0.03)
    m = mesh_mod.make_pair_mesh(8)
    out = distributed_pg.distributed_global_optimization(m, graph, max_correspondence_distance=0.5)
    after = np.asarray(out.nodes)
    T = np.asarray(graph.edge_T[-1])
    r = np.linalg.inv(T) @ np.linalg.inv(after[0]) @ after[-1]
    r0 = np.linalg.inv(T) @ np.linalg.inv(np.asarray(graph.nodes[0])) @ np.asarray(graph.nodes[-1])
    assert np.linalg.norm(r[:3, 3]) < np.linalg.norm(r0[:3, 3]) * 0.2


def test_sharded_nn1_matches_single(rng):
    """Point sharding: ref rows split over the 'points' axis; result must be
    bit-identical to the single-device exact merge."""
    from pcr_tpu.ops import knn as knn_ops
    from pcr_tpu.parallel import point_sharding

    q = rng.uniform(-5, 5, size=(2048, 3)).astype(np.float32)
    r = rng.uniform(-5, 5, size=(4096, 3)).astype(np.float32)
    m = np.ones(4096, dtype=bool)
    m[4000:] = False
    mesh = mesh_mod.make_point_mesh(8)
    d_s, i_s = point_sharding.sharded_nn1(
        mesh, jnp.asarray(q), jnp.asarray(r), jnp.asarray(m)
    )
    d_1, i_1 = knn_ops.nn1_exact(jnp.asarray(q), jnp.asarray(r), jnp.asarray(m))
    np.testing.assert_allclose(np.asarray(d_s), np.asarray(d_1), rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(i_s), np.asarray(i_1))


def test_sharded_knn_matches_single(rng):
    from pcr_tpu.ops import knn as knn_ops
    from pcr_tpu.parallel import point_sharding

    q = rng.uniform(-5, 5, size=(512, 3)).astype(np.float32)
    r = rng.uniform(-5, 5, size=(2048, 3)).astype(np.float32)
    m = np.ones(2048, dtype=bool)
    mesh = mesh_mod.make_point_mesh(8)
    d_s, i_s = point_sharding.sharded_knn(
        mesh, jnp.asarray(q), jnp.asarray(r), jnp.asarray(m), k=8
    )
    d_1, i_1 = knn_ops.knn_exact(jnp.asarray(q), jnp.asarray(r), jnp.asarray(m), 8)
    np.testing.assert_allclose(np.asarray(d_s), np.asarray(d_1), rtol=1e-6, atol=1e-7)
    # indices may differ only on exact-distance ties; require distance equality
    same = np.asarray(i_s) == np.asarray(i_1)
    assert same.mean() > 0.999


def _fgr_pair_batch(rng, B=8, n=400, cap=512, voxel=0.2):
    """B synthetic FGR-ready pairs: per-scan features from fgr_features, the
    stage-1 preprocessing (normals + FPFH)."""
    from pcr_tpu.models import fgr as fgr_mod

    srcs, tgts, fss, fts = [], [], [], []
    for b in range(B):
        pts = rng.uniform(-3, 3, size=(n, 3)).astype(np.float32)
        xi = (rng.normal(size=6) * np.array([0.05] * 3 + [0.2] * 3)).astype(np.float32)
        T_gt = np.asarray(se3.se3_exp(jnp.asarray(xi)))
        src_c = cloud.from_numpy(pts, capacity=cap)
        tgt_c = cloud.from_numpy(
            (pts @ T_gt[:3, :3].T + T_gt[:3, 3]).astype(np.float32), capacity=cap)
        s, fs = fgr_mod.fgr_features(src_c, voxel)
        t, ft = fgr_mod.fgr_features(tgt_c, voxel)
        srcs.append(s); tgts.append(t); fss.append(fs); fts.append(ft)
    return (cloud.stack_clouds(srcs), cloud.stack_clouds(tgts),
            jnp.stack(fss), jnp.stack(fts))


def test_sharded_fgr_matches_batched(rng):
    """Stage-1 pair parallelism (SURVEY §2.4): shard_map over 'pairs' must
    reproduce the single-device vmapped FGR."""
    from pcr_tpu.models import fgr as fgr_mod

    src, tgt, fs, ft = _fgr_pair_batch(rng, B=8)
    opts = fgr_mod.FgrOptions(
        maximum_correspondence_distance=0.4, iteration_number=64,
        maximum_tuple_count=256)
    seeds = jnp.arange(8, dtype=jnp.int32)
    res_b = fgr_mod.batched_registration_fgr(src, tgt, fs, ft, opts, seeds,
                                             n_trials=4096)
    m = mesh_mod.make_pair_mesh(8)
    res_s = pair_sharding.sharded_fgr(m, src, tgt, fs, ft, seeds, opts,
                                      n_trials=4096)
    np.testing.assert_allclose(
        np.asarray(res_s.transformation), np.asarray(res_b.transformation),
        atol=1e-4)
    np.testing.assert_allclose(
        np.asarray(res_s.fitness), np.asarray(res_b.fitness), atol=1e-4)


def test_sharded_fgr_features_matches_batched(rng):
    from pcr_tpu.models import fgr as fgr_mod

    from pcr_tpu.ops import fpfh_sorted

    pts = [rng.uniform(-3, 3, size=(300, 3)).astype(np.float32) for _ in range(8)]
    stacked = cloud.stack_clouds([cloud.from_numpy(p, capacity=512) for p in pts])
    m = mesh_mod.make_pair_mesh(8)
    # selection path: sharded == batched
    c_b, f_b = fgr_mod.batched_fgr_features(stacked, 0.2)
    c_s, f_s = pair_sharding.sharded_fgr_features(m, stacked, 0.2,
                                                  features="selection")
    np.testing.assert_allclose(np.asarray(f_s), np.asarray(f_b), atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(c_s.normals), np.asarray(c_b.normals), atol=1e-5)
    # banded path (the default): sharded == batched
    c_b2, f_b2 = fpfh_sorted.batched_fgr_features_sorted(stacked, 0.2, band=256)
    c_s2, f_s2 = pair_sharding.sharded_fgr_features(m, stacked, 0.2,
                                                    features="banded", band=256)
    np.testing.assert_allclose(np.asarray(f_s2), np.asarray(f_b2), atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(c_s2.normals), np.asarray(c_b2.normals), atol=1e-5)


def test_point_sharded_gicp_matches_single(rng):
    """VERDICT r2 item 2: the point-sharding CONSUMER — a full GICP loop with
    source rows sharded over 'points' must match single-device registration."""
    from pcr_tpu.parallel import point_sharding

    src, tgt, T0, T_gt = make_pair_batch(rng, B=1, n=900, cap=1024)
    src1 = jax.tree.map(lambda x: x[0], src)
    tgt1 = jax.tree.map(lambda x: x[0], tgt)
    res1 = gicp.registration_gicp(src1, tgt1, 0.3, jnp.asarray(T0[0]),
                                  corr_method="brute", max_iteration=10)
    mesh = mesh_mod.make_point_mesh(8)
    res8 = point_sharding.point_sharded_gicp(
        mesh, src1, tgt1, 0.3, T0[0], corr_method="brute", max_iteration=10)
    np.testing.assert_allclose(
        np.asarray(res8.transformation), np.asarray(res1.transformation),
        atol=1e-5)
    np.testing.assert_allclose(float(res8.fitness), float(res1.fitness), atol=1e-5)
    _, dt = se3.pose_errors(np.asarray(res8.transformation), T_gt[0])
    assert float(dt) < 0.01


def test_point_sharded_multiscale_matches_single(rng):
    from pcr_tpu.models import multiscale as ms_mod
    from pcr_tpu.parallel import point_sharding

    src, tgt, T0, T_gt = make_pair_batch(rng, B=1, n=900, cap=1024)
    src1 = jax.tree.map(lambda x: x[0], src)
    tgt1 = jax.tree.map(lambda x: x[0], tgt)
    caps = (256, 1024)
    pyr_s = ms_mod.build_pyramid(src1, n_scales=2, scale_capacities=caps)
    pyr_t = ms_mod.build_pyramid(tgt1, n_scales=2, scale_capacities=caps)
    res1 = ms_mod.multiscale_gicp_pyramids(
        pyr_s, pyr_t, jnp.asarray(T0[0]), n_scales=2, iterations=8)
    mesh = mesh_mod.make_point_mesh(8)
    res8 = point_sharding.point_sharded_multiscale_gicp(
        mesh, pyr_s, pyr_t, T0[0], n_scales=2, iterations=8)
    np.testing.assert_allclose(
        np.asarray(res8.transformation), np.asarray(res1.transformation),
        atol=5e-5)


def test_sharded_gicp_2d_matches_batched(rng):
    """make_2d_mesh consumer (VERDICT r3 item 5): GICP over a combined
    (2 pairs x 4 points) mesh — pair batch on 'pairs', source rows on
    'points' with per-iteration psum of the normal equations — must match
    the single-device batched result."""
    from pcr_tpu.parallel import point_sharding

    src, tgt, T0, T_gt = make_pair_batch(rng, B=2, n=900, cap=1024)
    m2 = mesh_mod.make_2d_mesh(2, 4)
    res_1d = pair_sharding.batched_gicp(
        src, tgt, jnp.asarray(T0), 0.3, corr_method="brute", max_iteration=10)
    res_2d = point_sharding.sharded_gicp_2d(
        m2, src, tgt, 0.3, T0, corr_method="brute", max_iteration=10)
    np.testing.assert_allclose(
        np.asarray(res_2d.transformation), np.asarray(res_1d.transformation),
        atol=5e-4)
    for b in range(2):
        _, dt = se3.pose_errors(
            np.asarray(res_2d.transformation)[b], T_gt[b])
        assert float(dt) < 0.02


def test_sharded_mgicp_2d_matches_batched(rng):
    """The 2-D mesh PRODUCT path (VERDICT r4 weak #6): full multi-scale GICP
    — per-pair preprocessing sharded over 'pairs', every scale's solve with
    source rows split over 'points' — must match the single-device
    batched_mgicp used by the streamed stage-2 runner."""
    from pcr_tpu.parallel import point_sharding

    src, tgt, T0, T_gt = make_pair_batch(rng, B=2, n=900, cap=1024)
    # raw clouds (no precomputed normals): both paths preprocess per scale
    src = src.with_(normals=None, covariances=None)
    tgt = tgt.with_(normals=None, covariances=None)
    caps = (256, 1024)
    m2 = mesh_mod.make_2d_mesh(2, 4)
    res_b = pair_sharding.batched_mgicp(
        src, tgt, jnp.asarray(T0), n_scales=2, iterations=8,
        scale_capacities=caps)
    res_2d = point_sharding.sharded_mgicp_2d(
        m2, src, tgt, T0, n_scales=2, iterations=8, scale_capacities=caps)
    np.testing.assert_allclose(
        np.asarray(res_2d.transformation), np.asarray(res_b.transformation),
        atol=5e-4)
    for b in range(2):
        _, dt = se3.pose_errors(np.asarray(res_2d.transformation)[b], T_gt[b])
        assert float(dt) < 0.02


def test_sharded_mgicp_matches_batched_and_compiles_once(rng):
    """The pairs-mesh stage-2 entry (CLI --devices) matches the
    single-device batched pyramid, and a second chunk of the same shape
    reuses the first chunk's program: the entry is jitted with the mesh
    static (an eager shard_map compiled every primitive, per chunk)."""
    src, tgt, T0, T_gt = make_pair_batch(rng, B=4, n=900, cap=1024)
    src = src.with_(normals=None, covariances=None)
    tgt = tgt.with_(normals=None, covariances=None)
    kw = dict(n_scales=2, iterations=8, scale_capacities=(256, 1024))
    m = mesh_mod.make_pair_mesh(4)
    res_b = pair_sharding.batched_mgicp(src, tgt, jnp.asarray(T0), **kw)
    before = pair_sharding.sharded_mgicp._cache_size()
    res_s = pair_sharding.sharded_mgicp(m, src, tgt, jnp.asarray(T0), **kw)
    np.testing.assert_allclose(
        np.asarray(res_s.transformation), np.asarray(res_b.transformation),
        atol=5e-4)
    for b in range(4):
        _, dt = se3.pose_errors(np.asarray(res_s.transformation)[b], T_gt[b])
        assert float(dt) < 0.02
    pair_sharding.sharded_mgicp(m, tgt, src, jnp.asarray(T0), **kw)
    assert pair_sharding.sharded_mgicp._cache_size() == before + 1


@pytest.mark.parametrize("env, want", [
    ({"JAX_COORDINATOR_ADDRESS": "localhost:7777"},
     {"coordinator_address": "localhost:7777"}),
    ({"JAX_COORDINATOR_ADDRESS": "localhost:7777", "JAX_NUM_PROCESSES": "2",
      "JAX_PROCESS_ID": "1"},
     {"coordinator_address": "localhost:7777", "num_processes": 2,
      "process_id": 1}),
    ({"PCR_MULTIHOST": "1"}, {}),
    ({}, None),
], ids=["coordinator-only", "explicit", "auto-detect", "single-host"])
def test_maybe_initialize_distributed(monkeypatch, env, want):
    """jax.distributed.initialize gets what the environment gives and lets
    JAX infer the rest; PCR_MULTIHOST=1 calls it with no arguments (cluster
    auto-detection); with neither, nothing is initialized."""
    calls = []
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: calls.append(kw))
    monkeypatch.setattr(mesh_mod, "_distributed_initialized", False)
    for k in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
              "JAX_PROCESS_ID", "PCR_MULTIHOST"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert mesh_mod.maybe_initialize_distributed() is False
    assert calls == ([] if want is None else [want])
