"""Native C++ PCD reader (pcr_tpu/native) vs the Python format authority.

The Python parser in utils/pcd.py defines the format semantics; the native
reader must agree bit-for-bit on binary scans (with and without rgb) and on
ascii files, all produced by write_pcd.
"""

import numpy as np
import pytest

from pcr_tpu import native
from pcr_tpu.utils import cloud, pcd

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native toolchain unavailable"
)


def _write_scan(path, n, seed, rgb):
    """A binary PCD scan of ``n`` LiDAR-scale points (+ packed rgb)."""
    rng = np.random.default_rng(seed)
    points = rng.uniform(-40.0, 40.0, size=(n, 3)).astype(np.float32)
    colors = rng.uniform(size=(n, 3)).astype(np.float32) if rgb else None
    pcd.write_pcd(path, points, colors=colors, binary=True)
    return str(path)


@pytest.mark.parametrize("rgb", [False, True], ids=["xyz", "xyz_rgb"])
def test_native_matches_python_parser(tmp_path, rgb):
    path = _write_scan(tmp_path / "s0.pcd", 3001, 0, rgb)
    ref = pcd.read_pcd(path)
    cap = cloud.round_up(ref.points.shape[0])
    pts, mask, cols, n = native.read_pcd_padded(path, cap, cloud.PAD_COORD)
    assert n == ref.points.shape[0]
    assert mask[:n].all() and not mask[n:].any()
    np.testing.assert_array_equal(pts[:n], ref.points)
    assert np.all(pts[n:] == cloud.PAD_COORD)
    if ref.colors is None:
        assert cols is None
    else:
        np.testing.assert_allclose(cols[:n], ref.colors, atol=1e-6)


def test_native_batch_matches_single(tmp_path):
    paths = [_write_scan(tmp_path / f"s{i}.pcd", 2000 + 500 * i, i, False)
             for i in range(3)]
    cap = 4096
    pts, mask, cols, counts = native.read_pcd_batch_padded(paths, cap, cloud.PAD_COORD)
    assert pts.shape == (3, cap, 3) and mask.shape == (3, cap)
    for b, p in enumerate(paths):
        ref = pcd.read_pcd(p)
        assert counts[b] == ref.points.shape[0]
        np.testing.assert_array_equal(pts[b, : counts[b]], ref.points)
        assert mask[b].sum() == counts[b]


def test_native_reads_ascii_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    points = rng.normal(size=(100, 3)).astype(np.float32)
    colors = rng.uniform(size=(100, 3)).astype(np.float32)
    f = tmp_path / "a.pcd"
    pcd.write_pcd(f, points, colors=colors, binary=False)
    ref = pcd.read_pcd(f)
    pts, mask, cols, n = native.read_pcd_padded(str(f), 128, cloud.PAD_COORD)
    assert n == 100
    np.testing.assert_allclose(pts[:n], ref.points, atol=1e-5)
    np.testing.assert_allclose(cols[:n], ref.colors, atol=1e-2)


def test_native_capacity_error(tmp_path):
    points = np.zeros((10, 3), np.float32)
    f = tmp_path / "b.pcd"
    pcd.write_pcd(f, points)
    with pytest.raises(RuntimeError):
        native.read_pcd_padded(str(f), 4, cloud.PAD_COORD)


def test_native_voxel_count_matches_numpy():
    rng = np.random.default_rng(1)
    pts = rng.uniform(-20, 20, size=(5000, 3)).astype(np.float32)
    for v in (0.5, 0.1):
        ijk = np.floor((pts - pts.min(axis=0)) / np.float32(v)).astype(np.int64)
        key = (ijk[:, 0] << 42) + (ijk[:, 1] << 21) + ijk[:, 2]
        assert native.count_voxels(pts, v) == int(np.unique(key).size)
