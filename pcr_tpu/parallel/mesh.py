"""Device mesh & sharding helpers (SURVEY §2.4 — the layer the reference lacks).

The registration workload has two natural parallel axes:
  * ``pairs`` — scan pairs are embarrassingly parallel (the reference's serial
    Python loop over 901 pairs, ``1_...py:134-147``); data-parallel over devices.
  * ``points`` — within-pair sharding of large clouds for the k-NN tiles
    (Courtyard 240k points), used by the sharded neighbor kernels.

Multi-host initialization goes through ``jax.distributed.initialize`` before
mesh creation; on a single process the same code paths run over the local
devices (or a virtual CPU mesh under xla_force_host_platform_device_count).
"""

from __future__ import annotations

import os

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

_distributed_initialized = False


def maybe_initialize_distributed() -> bool:
    """Multi-host bring-up: call ``jax.distributed.initialize`` when the
    standard coordinator env vars are present (SURVEY §2.4 collectives row).

    Triggers on JAX_COORDINATOR_ADDRESS (+ JAX_NUM_PROCESSES / JAX_PROCESS_ID
    where given; JAX infers what is left out) or, with PCR_MULTIHOST=1, on the
    cluster environment that jax.distributed auto-detects (SLURM, Open MPI,
    ...).  Idempotent; returns True when running multi-process.  On a single
    host this is a no-op and the same mesh code paths run over local (or
    xla_force_host_platform_device_count virtual) devices.
    """
    global _distributed_initialized
    if _distributed_initialized:
        return jax.process_count() > 1
    coord = os.environ.get("JAX_COORDINATOR_ADDRESS")
    want = coord is not None or os.environ.get("PCR_MULTIHOST") == "1"
    if want:
        kw = {}
        if coord:
            kw["coordinator_address"] = coord
            if "JAX_NUM_PROCESSES" in os.environ:
                kw["num_processes"] = int(os.environ["JAX_NUM_PROCESSES"])
            if "JAX_PROCESS_ID" in os.environ:
                kw["process_id"] = int(os.environ["JAX_PROCESS_ID"])
        jax.distributed.initialize(**kw)
        _distributed_initialized = True
    return jax.process_count() > 1


def make_pair_mesh(n_devices: int | None = None, axis: str = "pairs") -> Mesh:
    maybe_initialize_distributed()
    devs = jax.devices()
    n = n_devices or len(devs)
    return jax.make_mesh((n,), (axis,), devices=devs[:n])


def make_2d_mesh(n_pairs: int, n_points: int) -> Mesh:
    """(pairs, points) mesh for pair-parallel + within-pair point sharding
    (the ``points`` axis is consumed by parallel.point_sharding)."""
    maybe_initialize_distributed()
    return jax.make_mesh((n_pairs, n_points), ("pairs", "points"))


def make_point_mesh(n_devices: int | None = None) -> Mesh:
    """1-D 'points' mesh: all devices cooperate on ONE huge cloud pair
    (Courtyard-scale k-NN, parallel.point_sharding)."""
    return make_pair_mesh(n_devices, axis="points")


def pair_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P("pairs"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
