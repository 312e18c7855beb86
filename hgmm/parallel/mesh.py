"""Device mesh + multi-host bootstrap (SURVEY.md §2.3; BASELINE.json:5
"distributed EM shards points across the GPUs of one or more hosts").

The engine uses ONE logical mesh axis, "points": clouds are sharded along
their point dimension, mixture parameters and poses are replicated, and the
only cross-device traffic is the psum of O(K) sufficient statistics /
O(1) pose statistics — which XLA hands to NCCL: over NVLink between the
GPUs of one host (all to all, so the mesh is a flat list whatever its
size) and over the network between hosts. The mesh follows the algorithm
alone. There is no tensor/pipeline parallelism to configure: the
model state is KB-scale by construction (SURVEY.md §2.2 documents why TP/PP
do not apply to this workload).
"""

from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

POINTS_AXIS = "points"


def make_mesh(devices=None) -> Mesh:
    """1-D mesh over all (or the given) devices, axis name "points"."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.array(devices), (POINTS_AXIS,))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def points_sharding(mesh: Mesh) -> NamedSharding:
    """Shard dim 0 (the point axis of [N, 3] / [N] arrays)."""
    return NamedSharding(mesh, P(POINTS_AXIS))


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Multi-host process-group bootstrap. With no args, reads the standard
    JAX env vars / cloud metadata (jax.distributed.initialize()). Gang-
    scheduled: a lost host fails the program — recovery is restart from
    checkpoint (SURVEY.md §6.3), by design."""
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    jax.distributed.initialize(**kwargs)


def shard_points_from_host(points, mesh: Mesh):
    """Build a sharded global array from per-process local point data
    (10M+-point multi-host ingest: each host reads only its slice —
    SURVEY.md §8 'KITTI scale')."""
    return jax.make_array_from_process_local_data(points_sharding(mesh), points)
