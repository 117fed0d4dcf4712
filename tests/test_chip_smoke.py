"""chip_smoke.py's CPU-testable parts (generator, device refusal), the
compile-cache placement, and the device-independent method choices."""

import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import chip_smoke
from pcr_tpu.models import gicp
from pcr_tpu.ops import knn
from pcr_tpu.ops import normals as normals_ops
from pcr_tpu.utils import cloud, se3

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_generator_fills_the_nclt_bucket():
    """Full-size scans: 20k-31k points each, inside the 32,768 NCLT bucket,
    float32, sensor-frame coordinates tens of metres across."""
    scans, poses = chip_smoke.generate(0)
    assert len(scans) == chip_smoke.N_SCANS and poses.shape == (chip_smoke.N_SCANS, 4, 4)
    assert chip_smoke.BUCKET == cloud.BUCKETS["NCLT"]
    for s in scans:
        assert s.dtype == np.float32 and s.shape[1] == 3
        assert 20000 <= len(s) <= 31000
        assert 20.0 < np.ptp(s[:, 0]) < 200.0


def test_generator_loop_is_closed_with_short_steps():
    """1-2 m between stations, the wraparound pair included, and the
    relative ground truth composes to the identity around the loop."""
    _, poses = chip_smoke.generate(1, n_scans=chip_smoke.N_SCANS, n_azimuth=8)
    rel = chip_smoke.relative_ground_truth(poses)
    steps = np.linalg.norm(rel[:, :3, 3], axis=1)
    assert steps.min() >= 1.0 and steps.max() <= 2.0, steps
    loop = np.eye(4)
    for T in rel:
        loop = loop @ T
    np.testing.assert_allclose(loop, np.eye(4), atol=1e-9)
    np.testing.assert_allclose(rel[3], np.linalg.inv(poses[3]) @ poses[4])


def test_generator_is_deterministic_under_a_seed():
    a, pa = chip_smoke.generate(3, n_scans=3, n_azimuth=64)
    b, pb = chip_smoke.generate(3, n_scans=3, n_azimuth=64)
    c, _ = chip_smoke.generate(4, n_scans=3, n_azimuth=64)
    np.testing.assert_array_equal(pa, pb)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert any(len(x) != len(z) or not np.array_equal(x, z) for x, z in zip(a, c))


def test_pose_errors_reads_translation_and_angle():
    T = np.tile(np.eye(4), (2, 1, 1))
    U = T.copy()
    U[1, :3, :3] = np.asarray(se3.so3_exp(jnp.asarray([0.0, 0.0, np.radians(2.0)])))
    U[1, :3, 3] = [0.3, 0.0, 0.4]
    dt, dr = chip_smoke.pose_errors(U, T)
    np.testing.assert_allclose(dt, [0.0, 0.5], atol=1e-7)
    np.testing.assert_allclose(dr, [0.0, 2.0], atol=1e-4)


def _perturbed(rel, dt_m, seed):
    """rel with each translation moved by dt_m in a random direction and
    each rotation by about dt_m/10 rad."""
    r = np.random.default_rng(seed)
    out = rel.copy()
    for T in out:
        d = r.normal(size=3)
        T[:3, 3] += dt_m * d / np.linalg.norm(d)
        T[:3, :3] = T[:3, :3] @ np.asarray(
            se3.so3_exp(jnp.asarray(r.normal(size=3) * dt_m / 10, jnp.float32)))
    return out


@pytest.mark.parametrize("stage2, passes", [
    ("refined", True),      # stage 2 at ~1 mm, as on the card
    ("unchanged", False),   # GICP returned its FGR init
    ("drifted", False),     # stage 2 within the old 0.05 m median bound
], ids=["refined", "unchanged", "drifted"])
def test_stage2_gate(tmp_path, stage2, passes):
    """The smoke's stage-2 gate fails a stage 2 that left its stage-1 poses
    (~46 mm off, as FGR lands on the card) where they were."""
    from pcr_tpu.utils import poses_io

    _, poses = chip_smoke.generate(2, n_scans=chip_smoke.N_SCANS, n_azimuth=8)
    rel = chip_smoke.relative_ground_truth(poses)
    fgr = _perturbed(rel, 0.046, 0)
    est = {"refined": _perturbed(rel, 0.001, 1), "unchanged": fgr,
           "drifted": _perturbed(rel, 0.03, 2)}[stage2]
    for stage, T in (("FGR", fgr), ("FGR_GICP", est)):
        poses_io.save_relative_circuit(
            str(tmp_path / f"relative_poses_{stage}" / "NCLT"), T)
    if passes:
        chip_smoke._stage2_check("t", str(tmp_path), rel)
    else:
        with pytest.raises(chip_smoke.CheckFailed):
            chip_smoke._stage2_check("t", str(tmp_path), rel)


def test_only_needs_four_chips():
    with pytest.raises(SystemExit):
        chip_smoke.main(["--only", "points"])


def test_smoke_refuses_a_cpu_device():
    """No CPU fallback: a run where JAX finds only the CPU exits non-zero
    and prints no result line."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    p = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       env=env, cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout
    assert "needs a GPU" in p.stderr


@pytest.mark.parametrize("env_set", [True, False], ids=["env", "checkout"])
def test_compile_cache_placement(tmp_path, env_set):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the cache sits at
    the fixed path <checkout>/.jax_cache."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    want = os.path.join(REPO, ".jax_cache")
    if env_set:
        want = str(tmp_path / "cache")
        env["JAX_COMPILATION_CACHE_DIR"] = want
    p = subprocess.run(
        [sys.executable, "-c",
         "import pcr_tpu, jax; print(jax.config.jax_compilation_cache_dir)"],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=300, check=True)
    assert p.stdout.strip().splitlines()[-1] == want


def test_auto_methods_read_no_platform(monkeypatch, rng):
    """'auto' resolves to the exact kNN merge and the hash-grid GICP without
    asking which platform runs them."""
    def no_platform_read():
        raise AssertionError("method choice read the platform")

    monkeypatch.setattr(jax, "default_backend", no_platform_read)
    pts = rng.uniform(-2, 2, size=(300, 3)).astype(np.float32)
    c = cloud.from_numpy(pts, capacity=384)
    d_auto, i_auto = knn.knn(c.points, c.points, c.mask, 5, exclude_self=True)
    d_ex, i_ex = knn.knn_exact(c.points, c.points, c.mask, 5, exclude_self=True)
    np.testing.assert_array_equal(np.asarray(i_auto), np.asarray(i_ex))
    np.testing.assert_array_equal(np.asarray(d_auto), np.asarray(d_ex))

    xy = rng.uniform(-2, 2, size=(800, 2)).astype(np.float32)
    z = 0.3 * np.sin(2 * xy[:, :1]) + 0.2 * np.cos(3 * xy[:, 1:])
    surf = np.concatenate([xy, z], axis=1).astype(np.float32)
    T = np.asarray(se3.se3_exp(jnp.asarray([0.02, -0.01, 0.03, 0.05, 0.0, 0.02])))
    src = normals_ops.with_normals_knn(cloud.from_numpy(surf, capacity=1024), 20)
    tgt = normals_ops.with_normals_knn(cloud.from_numpy(
        (surf @ T[:3, :3].T + T[:3, 3]).astype(np.float32), capacity=1024), 20)
    r_auto = gicp.registration_gicp(src, tgt, 0.3, jnp.eye(4), max_iteration=20)
    r_grid = gicp.registration_gicp(src, tgt, 0.3, jnp.eye(4), corr_method="grid",
                                    max_iteration=20)
    np.testing.assert_array_equal(np.asarray(r_auto.transformation),
                                  np.asarray(r_grid.transformation))
    _, dt = se3.pose_errors(np.asarray(r_auto.transformation, np.float64), T)
    assert float(dt) < 0.01


@pytest.mark.gpu
def test_kernel_phase_on_card(gpu_device):
    """The smoke's kernel checks (phase c) pass on the card at real width."""
    scans, _ = chip_smoke.generate(0, n_scans=2)
    with jax.default_matmul_precision("highest"):
        chip_smoke.kernel_phase(scans)
