"""Pair-parallel batched registration over the device mesh.

The replacement for the reference's serial per-pair loops
(``1_...py:134-147``, ``2_...py:187-214``): scan pairs become a batch axis,
``vmap`` batches them on a device, and ``shard_map`` splits the batch across
the ``pairs`` mesh axis so every device registers its own shard of the circuit
concurrently.  Results are gathered back replicated.

The mesh entry points are jitted with the mesh and the configuration static:
each call is one XLA program, compiled once per shape.  An eager (unjitted)
``shard_map`` would instead compile and dispatch every primitive of the body
on its own, once per chunk.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..models import fgr as fgr_mod
from ..models import gicp as gicp_mod
from ..models import multiscale as ms_mod
from ..utils.cloud import Cloud


def batched_gicp(src: Cloud, tgt: Cloud, T_init, max_corr_dist, **kw):
    """vmap of single-pair GICP over a leading batch dim of stacked Clouds."""
    fn = functools.partial(gicp_mod.registration_gicp, **kw)
    return jax.vmap(fn, in_axes=(0, 0, None, 0))(src, tgt, max_corr_dist, T_init)


def batched_mgicp(src: Cloud, tgt: Cloud, T_init, **kw):
    """vmap of the full multiscale pyramid over stacked pairs."""
    fn = functools.partial(ms_mod.multiscale_gicp, **kw)
    return jax.vmap(fn, in_axes=(0, 0, 0))(src, tgt, T_init)


@functools.partial(jax.jit, static_argnames=(
    "mesh", "n_scales", "iterations", "loss", "scale_capacities", "schedule", "fused"))
def sharded_mgicp(mesh: Mesh, src: Cloud, tgt: Cloud, T_init, **kw):
    """shard_map over the 'pairs' axis: each device runs its shard of pairs
    through the vmapped pyramid.  Batch size must be divisible by the mesh
    axis size (pad pairs with duplicates and drop them afterwards)."""
    n_dev = mesh.shape["pairs"]
    B = T_init.shape[0]
    if B % n_dev != 0:
        raise ValueError(f"pair batch {B} not divisible by mesh axis {n_dev}")

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P("pairs"), P("pairs"), P("pairs")),
        out_specs=P("pairs"),
        check_vma=False,  # scan carries inside knn are shard-local constants
    )
    def run(src_shard, tgt_shard, T_shard):
        return batched_mgicp(src_shard, tgt_shard, T_shard, **kw)

    return run(src, tgt, T_init)


@functools.partial(jax.jit, static_argnames=("mesh", "opts", "n_trials"))
def sharded_fgr(mesh: Mesh, src: Cloud, tgt: Cloud, feat_src, feat_tgt,
                seeds, opts, n_trials: int = 16384, max_tuples=None):
    """shard_map of stage-1 FGR over the 'pairs' axis: each device runs its
    shard of the circuit's pairs through the vmapped match/tuple-test/GNC
    (SURVEY §2.4 pair-parallelism row — the reference's hottest serial loop,
    1_...py:134-147).  Pair batch must be divisible by the mesh axis size.
    ``max_tuples``: optional (B,) per-pair tuple-count caps, sharded with the
    pairs (config parity with the serial runner's per-pair-bucket options)."""
    n_dev = mesh.shape["pairs"]
    if seeds.shape[0] % n_dev != 0:
        raise ValueError(f"pair batch {seeds.shape[0]} not divisible by mesh axis {n_dev}")
    if max_tuples is None:
        max_tuples = jnp.full(
            (seeds.shape[0],), opts.maximum_tuple_count, jnp.int32)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P("pairs"),) * 6,
        out_specs=P("pairs"),
        check_vma=False,  # scan carries inside knn are shard-local constants
    )
    def run(src_s, tgt_s, fs_s, ft_s, seed_s, mt_s):
        return fgr_mod.batched_registration_fgr(
            src_s, tgt_s, fs_s, ft_s, opts, seed_s, n_trials, mt_s)

    return run(src, tgt, feat_src, feat_tgt, jnp.asarray(seeds),
               jnp.asarray(max_tuples))


@functools.partial(jax.jit, static_argnames=(
    "mesh", "voxel_size", "features", "band"))
def sharded_fgr_features(mesh: Mesh, clouds: Cloud, voxel_size,
                         features: str = "banded", band: int = 2048):
    """shard_map of per-scan FGR preprocessing (normals + FPFH) over 'pairs':
    the B+1 scans of a pair chunk are featurized one-per-device-slot, then the
    stacked result is returned replicated for src/tgt slicing.  Scan batch
    must be divisible by the mesh axis size (pad by repeating a scan).
    ``features`` selects the banded gather-free path or the selection path
    (PipelineConfig.stage1_features)."""
    from ..ops import fpfh_sorted

    n_dev = mesh.shape["pairs"]
    if clouds.points.shape[0] % n_dev != 0:
        raise ValueError(
            f"scan batch {clouds.points.shape[0]} not divisible by mesh axis {n_dev}")

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P("pairs"),),
        out_specs=P("pairs"),
        check_vma=False,
    )
    def run(c_s):
        if features == "banded":
            return fpfh_sorted.batched_fgr_features_sorted(
                c_s, voxel_size, band=band)
        return fgr_mod.batched_fgr_features(c_s, voxel_size)

    return run(clouds)


def sharded_batched_gicp(mesh: Mesh, src: Cloud, tgt: Cloud, T_init, max_corr_dist, **kw):
    """shard_map + vmap of single-scale GICP (used by the dry-run and tests)."""
    n_dev = mesh.shape["pairs"]
    if T_init.shape[0] % n_dev != 0:
        raise ValueError("pair batch not divisible by mesh axis")

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P("pairs"), P("pairs"), P("pairs")),
        out_specs=P("pairs"),
        check_vma=False,  # scan carries inside knn are shard-local constants
    )
    def run(src_shard, tgt_shard, T_shard):
        return batched_gicp(src_shard, tgt_shard, T_shard, max_corr_dist, **kw)

    return run(src, tgt, T_init)
