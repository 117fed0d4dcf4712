"""Fixed-shape, masked point-cloud containers (the device data plane).

The reference passes ragged Open3D ``PointCloud`` objects around; here
everything is a statically-shaped padded array with a validity mask (SURVEY §7
design stance).  ``Cloud`` is a registered pytree so it flows through
jit/vmap/shard_map.  Padded points are parked at a far-away sentinel coordinate
so that distance-based kernels naturally never select them, *and* every kernel
still consults the mask.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, replace

import jax
import jax.numpy as jnp
import numpy as np

# Sentinel coordinate for padding: far enough that no real neighbor query can
# reach it, small enough to keep squared distances finite in float32.
PAD_COORD = 1.0e6

# Per-dataset bucket sizes (SURVEY §7): smallest power-of-two-ish multiple of
# 256 that holds every scan in the dataset.
BUCKETS = {"NCLT": 32768, "Facade": 90112, "Courtyard": 245760}


def round_up(n: int, multiple: int = 256) -> int:
    return ((n + multiple - 1) // multiple) * multiple


@jax.tree_util.register_pytree_node_class
@dataclass
class Cloud:
    """Padded point cloud: points (N, 3) f32, mask (N,) bool, optional attrs."""

    points: jnp.ndarray
    mask: jnp.ndarray
    normals: jnp.ndarray | None = None      # (N, 3)
    covariances: jnp.ndarray | None = None  # (N, 3, 3)
    colors: jnp.ndarray | None = None       # (N, 3)

    # -- pytree protocol ----------------------------------------------------
    def tree_flatten(self):
        children = (self.points, self.mask, self.normals, self.covariances, self.colors)
        return children, None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    # -- convenience --------------------------------------------------------
    @property
    def capacity(self) -> int:
        return self.points.shape[-2]

    def count(self) -> jnp.ndarray:
        """Number of valid points (traced scalar)."""
        return jnp.sum(self.mask.astype(jnp.int32), axis=-1)

    def with_(self, **kwargs) -> "Cloud":
        return replace(self, **kwargs)

    def masked_points(self) -> jnp.ndarray:
        """Points with padding parked at the sentinel coordinate."""
        return jnp.where(self.mask[..., None], self.points, PAD_COORD)


def from_numpy(points: np.ndarray, capacity: int | None = None,
               colors: np.ndarray | None = None) -> Cloud:
    """Pad host points (n, 3) to `capacity` (default: round_up(n))."""
    points = np.asarray(points, dtype=np.float32)
    n = points.shape[0]
    cap = capacity or round_up(n)
    if cap < n:
        raise ValueError(f"capacity {cap} < point count {n}")
    pts = np.full((cap, 3), PAD_COORD, dtype=np.float32)
    pts[:n] = points
    mask = np.zeros((cap,), dtype=bool)
    mask[:n] = True
    cols = None
    if colors is not None:
        cols = np.zeros((cap, 3), dtype=np.float32)
        cols[:n] = colors
    return Cloud(points=jnp.asarray(pts), mask=jnp.asarray(mask),
                 colors=None if cols is None else jnp.asarray(cols))


def load_cloud(path: str, capacity: int | None = None) -> Cloud:
    """Read a PCD file into a padded Cloud (replaces o3d.io.read_point_cloud).

    Uses the C++ reader (pcr_tpu.native) when the toolchain is available;
    falls back to the pure-Python parser otherwise."""
    from .. import native

    if capacity is not None and native.available():
        try:
            pts, mask, cols, _ = native.read_pcd_padded(path, capacity, PAD_COORD)
            return Cloud(points=jnp.asarray(pts), mask=jnp.asarray(mask),
                         colors=None if cols is None else jnp.asarray(cols))
        except RuntimeError:
            pass
    from . import pcd

    data = pcd.read_pcd(path)
    return from_numpy(data.points, capacity=capacity, colors=data.colors)


def available_indices(dataset: str) -> list[int]:
    """Scan indices whose PCD files actually exist (Courtyard ships only
    s2/s4 of its 8-scan circuit — SURVEY §0)."""
    import os

    from . import poses_io

    n = poses_io.CIRCUIT_SIZES[dataset]
    return [
        i for i in range(n)
        if os.path.exists(poses_io.reference_cloud_path(dataset, i))
    ]


def load_dataset(dataset: str, indices=None, capacity: int | None = None) -> list[Cloud]:
    """Load reference dataset scans padded to the dataset bucket size.

    The hot path is the native threaded batch loader (pcr_tpu/native/
    pcd_io.cc): all scans are parsed in a C++ thread pool straight into the
    padded bucket layout, overlapping file I/O across cores.

    Missing scans raise a FileNotFoundError that lists what IS available
    instead of crashing mid-parse (Courtyard ships only 2 of 8 scans)."""
    import os

    from . import poses_io
    from .. import native

    n = poses_io.CIRCUIT_SIZES[dataset]
    if indices is None:
        indices = range(n)
    cap = capacity or BUCKETS[dataset]
    paths = [poses_io.reference_cloud_path(dataset, i) for i in indices]
    missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        raise FileNotFoundError(
            f"{dataset}: {len(missing)} of {len(paths)} requested scans are "
            f"not on disk (e.g. {os.path.basename(missing[0])}); available "
            f"indices: {available_indices(dataset)} — pass indices=[...]"
        )
    if native.available():
        try:
            pts, mask, cols, _ = native.read_pcd_batch_padded(paths, cap, PAD_COORD)
            return [
                Cloud(points=jnp.asarray(pts[b]), mask=jnp.asarray(mask[b]),
                      colors=None if cols is None else jnp.asarray(cols[b]))
                for b in range(len(paths))
            ]
        except RuntimeError:
            pass
    return [load_cloud(p, capacity=cap) for p in paths]


def load_dataset_host(dataset: str, indices=None,
                      capacity: int | None = None) -> list[Cloud]:
    """``load_dataset`` but NUMPY-backed: scans are parsed into padded host
    arrays with zero device traffic.  Host-side consumers (plan_scale_caps,
    LazyClouds) start from here."""
    import os

    from . import poses_io
    from .. import native

    n = poses_io.CIRCUIT_SIZES[dataset]
    if indices is None:
        indices = range(n)
    cap = capacity or BUCKETS[dataset]
    paths = [poses_io.reference_cloud_path(dataset, i) for i in indices]
    missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        raise FileNotFoundError(
            f"{dataset}: {len(missing)} of {len(paths)} requested scans are "
            f"not on disk (e.g. {os.path.basename(missing[0])}); available "
            f"indices: {available_indices(dataset)} — pass indices=[...]"
        )
    if native.available():
        try:
            pts, mask, cols, _ = native.read_pcd_batch_padded(paths, cap, PAD_COORD)
            return [
                Cloud(points=pts[b], mask=mask[b],
                      colors=None if cols is None else cols[b])
                for b in range(len(paths))
            ]
        except RuntimeError:
            pass
    out = []
    from . import pcd

    for p in paths:
        data = pcd.read_pcd(p)
        pp = np.full((cap, 3), PAD_COORD, np.float32)
        pp[: len(data.points)] = data.points
        m = np.zeros((cap,), bool)
        m[: len(data.points)] = True
        cols = None
        if data.colors is not None:
            cols = np.zeros((cap, 3), np.float32)
            cols[: len(data.points)] = data.colors
        out.append(Cloud(points=pp, mask=m, colors=cols))
    return out


@functools.partial(jax.jit, static_argnames=("capacity",))
def _repad_device(prefix_leaves, n_valid, capacity: int):
    """Rebuild a full-capacity cloud on device from a valid-row prefix: points
    pad to PAD_COORD, other attrs to zero, and the mask is synthesized as
    ``iota < n_valid`` (n_valid rides as a traced scalar — no per-scan
    recompile; only the handful of rounded prefix shapes compile)."""
    out = {}
    for k, x in prefix_leaves.items():
        fill = PAD_COORD if k == "points" else 0.0
        pad = jnp.full((capacity - x.shape[0],) + x.shape[1:], fill, x.dtype)
        out[k] = jnp.concatenate([x, pad], axis=0)
    mask = jnp.arange(capacity, dtype=jnp.int32) < n_valid
    return out, mask


def _upload_prefix(h: Cloud, granularity: int = 2048) -> Cloud:
    """Upload a host cloud's VALID rows only and re-pad on device.

    Host scans are padded to the dataset bucket with the valid rows as a
    prefix (load_dataset_host); shipping the pad rows and the bool mask is
    waste — an NCLT scan is ~21k valid points in the 32768 bucket, so the
    prefix upload cuts per-scan transfer ~40% and drops the mask transfer
    entirely (the mask is ``iota < n_valid`` on device).  The prefix length rounds up to ``granularity`` so only a few
    shapes ever compile; rounding rows are host PAD_COORD rows, masked off.
    Exact: the rebuilt device cloud equals jnp.asarray of the host cloud."""
    mask = np.asarray(h.mask)
    n_valid = int(mask.sum())
    if n_valid and not mask[:n_valid].all():
        # Both dataset loaders produce prefix masks, but LazyClouds is a
        # public container — a host cloud whose mask has interior holes
        # (e.g. rows zeroed in place by a host-side filter) would be
        # silently corrupted by the prefix slice, so fall back to the full
        # upload for it.
        return Cloud(
            points=jnp.asarray(h.points), mask=jnp.asarray(h.mask),
            normals=None if h.normals is None else jnp.asarray(h.normals),
            covariances=(None if h.covariances is None
                         else jnp.asarray(h.covariances)),
            colors=None if h.colors is None else jnp.asarray(h.colors))
    rows = min(h.capacity, round_up(max(n_valid, 1), granularity))
    leaves = {"points": np.asarray(h.points)[:rows]}
    for k in ("normals", "covariances", "colors"):
        v = getattr(h, k)
        if v is not None:
            leaves[k] = np.asarray(v)[:rows]
    out, mask = _repad_device(leaves, n_valid, h.capacity)
    return Cloud(points=out["points"], mask=mask,
                 normals=out.get("normals"),
                 covariances=out.get("covariances"),
                 colors=out.get("colors"))


class LazyClouds:
    """Host-resident dataset with lazy per-scan device upload (sliding LRU).

    ``load_dataset`` eagerly uploads every padded scan — ~380 MB for the 901
    NCLT scans at the 32k bucket, a monolithic up-front transfer that
    serializes ahead of any compute.  This container keeps the dataset on the HOST (numpy, from
    the native threaded reader) and uploads a scan on first ``[i]`` access,
    retaining the ``keep`` most recently used on device: the circuit runners
    touch scans in a sliding window, so uploads stream inside the compute
    loop (hidden behind the pipelined dispatch window) instead of blocking
    the start of the run.

    Iteration yields the HOST clouds — host-side planners
    (``plan_scale_caps``, ``bucket_capacity``) read numpy for free; indexing
    returns DEVICE clouds for the compute path.
    """

    def __init__(self, host_clouds: list[Cloud], keep: int = 8):
        self._host = host_clouds
        self._keep = max(int(keep), 2)
        self._cache: dict[int, Cloud] = {}
        self._order: list[int] = []

    def __len__(self) -> int:
        return len(self._host)

    def __iter__(self):
        return iter(self._host)

    def host(self, i: int) -> Cloud:
        return self._host[i]

    def __getitem__(self, i: int) -> Cloud:
        i = int(i)
        if i in self._cache:
            self._order.remove(i)
            self._order.append(i)
            return self._cache[i]
        h = self._host[i]
        dev = _upload_prefix(h)
        self._cache[i] = dev
        self._order.append(i)
        while len(self._order) > self._keep:
            del self._cache[self._order.pop(0)]
        return dev


def load_dataset_lazy(dataset: str, indices=None, capacity: int | None = None,
                      keep: int = 8) -> LazyClouds:
    """Host-parse the dataset and wrap it in a LazyClouds streamer."""
    return LazyClouds(load_dataset_host(dataset, indices, capacity), keep=keep)


def compact(c: Cloud, capacity: int) -> Cloud:
    """Permute valid points to the front and slice to a smaller static capacity.

    Used by the multiscale pyramid: after voxel downsampling at a coarse scale
    only a few % of slots are valid, and neighbor search is O(N_src * N_tgt) in
    the static capacity.  When more than `capacity` points are valid, the
    survivors are a UNIFORM stride over the valid set, not a prefix: Cloud
    points are kept in spatially sorted order (voxel output is cell-sorted),
    so a prefix crop would keep one corner of the scene and silently destroy
    the overlap region a registration needs.  The stride keeps coverage
    spatially uniform (the deterministic analogue of the reference's random
    downsampling, ALL_FUNCTIONS.py:236).

    ``capacity >= c.capacity`` is a no-op (matching pad_to's early return):
    without the guard the arange indices would clamp in JAX's gather and
    silently duplicate the last slot.
    """
    if capacity >= c.capacity:
        return c
    order = jnp.argsort(~c.mask, stable=True)  # valid first, stable
    n_valid = jnp.sum(c.mask.astype(jnp.int32))
    ar = jnp.arange(capacity, dtype=jnp.int32)
    # ratio <= capacity_in/capacity; products stay < 2^24 so f32 is exact
    # enough — indices only need uniformity, clamped below n_valid.
    strided = jnp.minimum(
        jnp.floor(ar.astype(jnp.float32)
                  * (n_valid.astype(jnp.float32) / capacity)).astype(jnp.int32),
        jnp.maximum(n_valid - 1, 0),
    )
    idx = jnp.where(n_valid > capacity, strided, ar)
    order = order[idx]

    def take(x):
        return None if x is None else x[order]

    pts = take(c.points)
    msk = c.mask[order]
    pts = jnp.where(msk[:, None], pts, PAD_COORD)
    return Cloud(
        points=pts,
        mask=msk,
        normals=take(c.normals),
        covariances=take(c.covariances),
        colors=take(c.colors),
    )


def pad_to(c: Cloud, capacity: int) -> Cloud:
    """Pad a cloud back up to a larger static capacity (inverse of compact's
    shrink): appended slots get mask=False / PAD_COORD points, so every masked
    kernel treats them as absent.  Used by the per-cloud capacity bucketing in
    stage 1: each scan is featurized at its own rounded-up bucket, then the
    pair is padded to the max of the two buckets for the matching/GNC step."""
    if capacity == c.capacity:
        return c
    if capacity < c.capacity:
        raise ValueError(f"pad_to({capacity}) below capacity {c.capacity}")

    def take(x, fill):
        if x is None:
            return None
        pad = jnp.full((capacity - x.shape[0],) + x.shape[1:], fill, x.dtype)
        return jnp.concatenate([x, pad], axis=0)

    return Cloud(
        points=take(c.points, PAD_COORD),
        mask=take(c.mask, False),
        normals=take(c.normals, 0.0),
        covariances=take(c.covariances, 0.0),
        colors=take(c.colors, 0.0),
    )


def bucket_capacity(c: Cloud, granularity: int = 4096) -> int:
    """Tightest granularity-multiple static capacity holding the cloud's valid
    points.  Per-query kernel cost (selection, distance tiles, gathers) scales
    with the AREA capacity_q x capacity_r, so running each scan at its own
    bucket instead of the dataset-wide one (NCLT: mean 21k valid in the 32k
    bucket) cuts the stage-1 hot path ~40% at the cost of one XLA compile per
    distinct bucket (cached persistently)."""
    if isinstance(c.mask, np.ndarray):  # host cloud: no device round trip
        nv = int(c.mask.sum())
    else:
        nv = int(np.asarray(jax.device_get(c.count())))
    return min(c.capacity, max(granularity, -(-nv // granularity) * granularity))


def plan_scale_caps(clouds: list[Cloud], scales: list[float],
                    bucket: int = 1024, margin: int = 64) -> tuple[int, ...]:
    """Host-side static-shape planner for the multiscale pyramid.

    For each voxel scale, count the occupied voxels of every cloud (exactly
    the convention of ops/voxel.py: ``floor((p - min_valid) / v)``) and round
    the worst case up to a `bucket` multiple.  Static shapes are the price of
    XLA compilation; this picks the tightest safe capacities per dataset run
    instead of a hand-tuned constant (which can silently truncate — e.g. the
    full NCLT circuit peaks at 9,490 points at scale 0.5).  Host-side numpy:
    ~1 ms per cloud per scale, amortized once per run.
    """
    from .. import native

    full_cap = clouds[0].capacity
    use_native = native.available()
    valid_pts = [np.asarray(c.points, np.float32)[np.asarray(c.mask)] for c in clouds]
    caps = []
    for v in scales:
        worst = 0
        for pts in valid_pts:
            if use_native:
                count = native.count_voxels(pts, v)
            else:
                ijk = np.floor((pts - pts.min(axis=0)) / np.float32(v)).astype(np.int64)
                key = (ijk[:, 0] << 42) + (ijk[:, 1] << 21) + ijk[:, 2]
                count = int(np.unique(key).size)
            worst = max(worst, count)
        caps.append(min(-(-(worst + margin) // bucket) * bucket, full_cap))
    return tuple(caps)


def stack_clouds(clouds: list[Cloud]) -> Cloud:
    """Stack same-capacity clouds into a batched Cloud with leading dim B."""
    def _stack(*xs):
        return None if xs[0] is None else jnp.stack(xs)

    pts = jnp.stack([c.points for c in clouds])
    msk = jnp.stack([c.mask for c in clouds])
    normals = _stack(*[c.normals for c in clouds]) if all(c.normals is not None for c in clouds) else None
    covs = _stack(*[c.covariances for c in clouds]) if all(c.covariances is not None for c in clouds) else None
    cols = _stack(*[c.colors for c in clouds]) if all(c.colors is not None for c in clouds) else None
    return Cloud(points=pts, mask=msk, normals=normals, covariances=covs, colors=cols)
