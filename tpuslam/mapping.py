"""Global voxel map (SURVEY.md §2a R10, §2b N4).

Reference status: accumulated voxel map used as ICP target for
frame-to-keyframe/map tracking (SURVEY.md §2a R10; provenance [B:10]).

Design: the map is just a fixed-capacity masked `PointCloud` in world
frame.  Fusion is the sort-based voxel reduction (tpuslam/geom/voxel.py) of
`concat(map, new_points)` — a single static-shape jitted program, no hash
table mutation, no scatter (SURVEY.md §7 "Hard parts": prefer
sort-by-voxel-key + segment reductions).  Lookup for frame-to-map ICP goes
through the grid-hash correspondence index (tpuslam/kernels/correspond.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from tpuslam.config import VoxelConfig
from tpuslam.geom import se3
from tpuslam.geom.cloud import PointCloud
from tpuslam.geom.voxel import voxel_downsample


@partial(jax.jit, static_argnames=("capacity", "voxel_size", "origin", "extent"))
def _fuse(map_cloud: PointCloud, new_cloud: PointCloud, T_world: jnp.ndarray,
          capacity: int, voxel_size: float, origin: float, extent: float
          ) -> PointCloud:
    moved = new_cloud.transform(T_world)
    merged = PointCloud(
        points=jnp.concatenate([map_cloud.points, moved.points], axis=0),
        normals=jnp.concatenate([map_cloud.normals, moved.normals], axis=0),
        mask=jnp.concatenate([map_cloud.mask, moved.mask], axis=0),
    )
    return voxel_downsample(merged, voxel_size, capacity, origin, extent)


class VoxelMap:
    """Host wrapper holding the device-resident world map."""

    def __init__(self, cfg: VoxelConfig):
        self.cfg = cfg
        self.cloud = PointCloud(
            points=jnp.zeros((cfg.map_capacity, 3)),
            normals=jnp.zeros((cfg.map_capacity, 3)),
            mask=jnp.zeros((cfg.map_capacity,), dtype=bool),
        )
        self.num_insertions = 0

    def insert(self, cloud: PointCloud, T_world) -> None:
        """Fuse a (keyframe-local) cloud posed at T_world into the map."""
        self.cloud = _fuse(
            self.cloud, cloud, jnp.asarray(np.asarray(T_world, dtype=np.float32)),
            capacity=self.cfg.map_capacity,
            voxel_size=self.cfg.map_voxel_size,
            origin=self.cfg.origin,
            extent=self.cfg.extent,
        )
        self.num_insertions += 1

    def build_index(self, cell: float):
        """Grid-hash index over the current map (for frame-to-map ICP).

        Rebuilt per map update, not per frame; anchored at the map centroid
        so the 256³ local grid (cell·256 span) covers any room-scale map.
        """
        from tpuslam.kernels.correspond import build_grid_index

        return build_grid_index(self.cloud, cell=cell)

    def size(self) -> int:
        return int(self.cloud.count())

    def points(self) -> np.ndarray:
        """Valid world-frame points (host copy, for viz/eval)."""
        m = np.asarray(self.cloud.mask)
        return np.asarray(self.cloud.points)[m]
