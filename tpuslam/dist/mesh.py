"""Device mesh / collectives layer (SURVEY.md §2b N16, §2d).

Reference status: none — the reference is a single CPU process (SURVEY.md
§2d).  This module replaces an MPI backend with `jax.distributed` +
`jax.sharding.Mesh` + `shard_map`: XLA collectives (`psum`, `all_gather`,
`ppermute`, `all_to_all`), which XLA hands to NCCL on a GPU mesh
(provenance [B:5]).  The mesh is a flat 1-D axis: the cards of a host are
joined all to all, so no torus shape applies.

Axis convention: one flat `"shard"` axis is enough for this workload — it
carries *points* during the ICP reduction (the TP analogue of SURVEY.md
§2c), *edges* during distributed pose-graph optimization (SP over the
trajectory), and *frame batches* for evaluation sweeps (DP).  Multi-host
meshes simply enumerate all processes' devices along the same axis.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpuslam.geom.cloud import PointCloud

SHARD_AXIS = "shard"


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Multi-host runtime init (no-op when single-process)."""
    if coordinator is None:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )


def make_mesh(n_devices: Optional[int] = None, axis: str = SHARD_AXIS) -> Mesh:
    """A 1-D mesh over the first `n_devices` (default: all) devices."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), axis_names=(axis,))


def replicate(tree, mesh: Mesh):
    """Fully replicate a pytree over the mesh."""
    sharding = NamedSharding(mesh, P())
    return jax.tree.map(lambda x: jax.device_put(x, sharding), tree)


def shard_leading(x: jnp.ndarray, mesh: Mesh, axis: str = SHARD_AXIS):
    """Shard an array along its leading dimension."""
    spec = P(axis, *([None] * (x.ndim - 1)))
    return jax.device_put(x, NamedSharding(mesh, spec))


def pad_to_multiple(x: jnp.ndarray, multiple: int, axis: int = 0,
                    fill=0) -> jnp.ndarray:
    n = x.shape[axis]
    target = -(-n // multiple) * multiple
    if target == n:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, target - n)
    return jnp.pad(x, widths, constant_values=fill)


def shard_cloud(cloud: PointCloud, mesh: Mesh,
                axis: str = SHARD_AXIS) -> PointCloud:
    """Pad a cloud to a multiple of the mesh size and shard point-wise.

    Padding rows carry mask=False, so every downstream reduction already
    ignores them — sharding changes layout, never semantics.
    """
    n_dev = mesh.shape[axis]
    return PointCloud(
        points=shard_leading(pad_to_multiple(cloud.points, n_dev), mesh, axis),
        normals=shard_leading(pad_to_multiple(cloud.normals, n_dev), mesh, axis),
        mask=shard_leading(
            pad_to_multiple(cloud.mask, n_dev, fill=False), mesh, axis
        ),
    )
