"""Sharded voxel-map fusion via all-to-all owner routing
(SURVEY.md §2c "EP" and "Ulysses" rows; §5 long-context analogue).

Reference status: none — the reference's voxel map lives in one CPU process
(SURVEY.md §2d).  The north-star asks for "partitioning … map voxel blocks
over hosts" ([B:5]); this module is the *fusion* half of that story (the
*tracking* half is dist/ring_map.py).

Design — "spatial experts" + all-to-all re-shard:

  * The global voxel map is sharded over the mesh by a **spatial hash of the
    voxel key**: `owner(voxel) = mix32(key) % D`.  Hashing (rather than
    contiguous spatial blocks) load-balances any camera trajectory — a
    contiguous partition would concentrate the whole working set on one
    device while the camera dwells in one room.  Each device owns a
    fixed-capacity shard holding only voxels whose hash maps to it — the
    "expert" for those cells (SURVEY.md §2c EP row).
  * Fusing a new keyframe cloud is a **re-shard from frame-major to
    owner-major layout** (SURVEY.md §2c Ulysses row): every device holds a
    slice of the incoming points (frame-major = whatever device produced or
    received them), computes each point's owner, buckets points by owner,
    and ONE `lax.all_to_all` over the interconnect routes every bucket to its owner.
    Owners then fuse arrivals into their map shard with the same sort +
    segment-sum voxel reduction used on a single device (geom/voxel.py) — no
    scatter, static shapes throughout.
  * Because every point of a given voxel routes to the same owner, the
    sharded fusion is *exactly* the single-device fusion per voxel (same
    centroid arithmetic, same counts), just computed on D devices: verified
    bit-comparable (up to float summation order) in tests/test_map_fusion.py.

Static-shape discipline: the per-(source→owner) bucket is a fixed
`bucket_cap` rows; arrivals beyond it are dropped (mask=False) and the drop
count is psum-reported so callers can size the cap (with a hash owner and
`bucket_cap = 2·ceil(N_local/D)` drops are ~never observed in practice).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax, shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpuslam.config import VoxelConfig
from tpuslam.dist.mesh import SHARD_AXIS, pad_to_multiple
from tpuslam.geom.cloud import PointCloud
from tpuslam.geom.voxel import voxel_downsample, voxel_keys


def _mix32(key_hi: jnp.ndarray, key_lo: jnp.ndarray) -> jnp.ndarray:
    """Cheap avalanche mix of the two-part voxel key (uint32 lattice hash)."""
    h = key_hi.astype(jnp.uint32) * jnp.uint32(2654435761)
    h = h ^ (key_lo.astype(jnp.uint32) * jnp.uint32(40503))
    h = h ^ (h >> 15)
    h = h * jnp.uint32(2246822519)
    return h ^ (h >> 13)


def voxel_owner(points: jnp.ndarray, mask: jnp.ndarray, n_dev: int,
                cfg: VoxelConfig) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(owner ∈ [0, n_dev), valid) for each point under cfg's world grid."""
    key_hi, key_lo, in_box = voxel_keys(
        points, mask, cfg.map_voxel_size, cfg.origin, cfg.extent)
    owner = (_mix32(key_hi, key_lo) % jnp.uint32(n_dev)).astype(jnp.int32)
    return owner, in_box


class FusionStats(NamedTuple):
    dropped: jnp.ndarray   # () int32 — points lost to bucket_cap overflow
    routed: jnp.ndarray    # () int32 — points exchanged over the mesh


def _bucket_by_owner(pts, nrm, valid, owner, n_dev: int, bucket_cap: int):
    """Pack local points into a (D·B, 7) owner-major bucket table.

    Row layout [px py pz nx ny nz w]; rows beyond a destination's fill level
    carry w=0.  Sort-by-owner + per-destination gather — no scatter.
    """
    n = pts.shape[0]
    o = jnp.where(valid, owner, n_dev)  # invalid rows sort last
    sort_ops = lax.sort(
        (o, pts[:, 0], pts[:, 1], pts[:, 2],
         nrm[:, 0], nrm[:, 1], nrm[:, 2]),
        num_keys=1,
    )
    rows = jnp.stack(sort_ops[1:7], axis=-1)          # (N, 6) owner-sorted
    counts = jnp.bincount(jnp.minimum(o, n_dev), length=n_dev + 1)[:n_dev]
    starts = jnp.cumsum(counts) - counts               # exclusive prefix sum
    j = jnp.arange(bucket_cap, dtype=jnp.int32)
    take = jnp.minimum(counts, bucket_cap)             # rows actually shipped
    idx = starts[:, None] + j[None, :]                 # (D, B)
    w = (j[None, :] < take[:, None])
    idx = jnp.clip(idx, 0, n - 1)
    bucket = rows[idx.reshape(-1)]                     # (D·B, 6)
    bucket = jnp.concatenate(
        [bucket, w.reshape(-1, 1).astype(pts.dtype)], axis=-1)
    dropped = jnp.sum(counts - take)
    return bucket, dropped, jnp.sum(take)


def _fuse_shard(map_pts, map_nrm, map_mask, new_pts, new_nrm, new_mask,
                T_world, *, n_dev: int, bucket_cap: int, shard_cap: int,
                cfg: VoxelConfig, axis: str):
    """shard_map body: route new points to voxel owners, fuse locally."""
    moved = PointCloud(points=new_pts, normals=new_nrm,
                       mask=new_mask).transform(T_world)
    owner, in_box = voxel_owner(moved.points, moved.mask, n_dev, cfg)
    bucket, dropped, routed = _bucket_by_owner(
        moved.points, moved.normals, moved.mask & in_box, owner,
        n_dev, bucket_cap)
    # Frame-major → owner-major: one tiled all-to-all over the mesh.
    arrivals = lax.all_to_all(bucket, axis, split_axis=0, concat_axis=0,
                              tiled=True)               # (D·B, 7)
    merged = PointCloud(
        points=jnp.concatenate([map_pts, arrivals[:, 0:3]], axis=0),
        normals=jnp.concatenate([map_nrm, arrivals[:, 3:6]], axis=0),
        mask=jnp.concatenate([map_mask, arrivals[:, 6] > 0.5], axis=0),
    )
    fused = voxel_downsample(merged, cfg.map_voxel_size, shard_cap,
                             cfg.origin, cfg.extent)
    stats = FusionStats(
        dropped=lax.psum(dropped, axis).astype(jnp.int32),
        routed=lax.psum(routed, axis).astype(jnp.int32),
    )
    return fused.points, fused.normals, fused.mask, stats


def make_fuse_fn(mesh: Mesh, cfg: VoxelConfig, new_capacity: int,
                 axis: str = SHARD_AXIS, bucket_slack: float = 2.0):
    """Build the jitted sharded-fusion step for fixed capacities.

    Returns `fuse(map_shards, new_cloud, T_world) -> (map_shards, stats)`
    where `map_shards` is a PointCloud sharded point-wise over `mesh` (each
    device holds `cfg.map_capacity // D` rows) and `new_cloud` is the
    incoming keyframe cloud sharded point-wise (frame-major), `new_capacity`
    rows total.
    """
    n_dev = mesh.shape[axis]
    local_n = -(-new_capacity // n_dev)
    bucket_cap = max(8, int(np.ceil(local_n / n_dev * bucket_slack)))
    shard_cap = -(-cfg.map_capacity // n_dev)

    pspec = PointCloud(points=P(axis, None), normals=P(axis, None),
                       mask=P(axis))
    body = shard_map(
        partial(_fuse_shard, n_dev=n_dev, bucket_cap=bucket_cap,
                shard_cap=shard_cap, cfg=cfg, axis=axis),
        mesh=mesh,
        in_specs=(pspec.points, pspec.normals, pspec.mask,
                  pspec.points, pspec.normals, pspec.mask, P()),
        out_specs=(P(axis, None), P(axis, None), P(axis),
                   FusionStats(dropped=P(), routed=P())),
    )

    @jax.jit
    def fuse(map_shards: PointCloud, new_cloud: PointCloud, T_world):
        pts, nrm, mask, stats = body(
            map_shards.points, map_shards.normals, map_shards.mask,
            new_cloud.points, new_cloud.normals, new_cloud.mask, T_world)
        return PointCloud(points=pts, normals=nrm, mask=mask), stats

    return fuse, bucket_cap, shard_cap


class ShardedVoxelMap:
    """Host wrapper for a mesh-sharded world voxel map.

    The sharded twin of mapping.VoxelMap: `insert` runs the all-to-all
    owner-routed fusion; `cloud_shards` feeds dist/ring_map.align_to_map_ring
    directly (the map is already point-sharded — tracking needs no reshard);
    `gather()` materializes the full map on every device (tests/viz only).
    """

    def __init__(self, cfg: VoxelConfig, mesh: Mesh, new_capacity: int,
                 axis: str = SHARD_AXIS):
        self.cfg = cfg
        self.mesh = mesh
        self.axis = axis
        n_dev = mesh.shape[axis]
        self.shard_cap = -(-cfg.map_capacity // n_dev)
        cap = self.shard_cap * n_dev
        sh = NamedSharding(mesh, P(axis, None))
        shm = NamedSharding(mesh, P(axis))
        self.cloud_shards = PointCloud(
            points=jax.device_put(jnp.zeros((cap, 3)), sh),
            normals=jax.device_put(jnp.zeros((cap, 3)), sh),
            mask=jax.device_put(jnp.zeros((cap,), bool), shm),
        )
        self.new_capacity = -(-new_capacity // n_dev) * n_dev
        self._fuse, self.bucket_cap, _ = make_fuse_fn(
            mesh, cfg, self.new_capacity, axis)
        self.dropped_total = 0
        self.num_insertions = 0

    def insert(self, cloud: PointCloud, T_world) -> FusionStats:
        """Fuse a (keyframe-local) cloud posed at T_world into the map."""
        n_dev = self.mesh.shape[self.axis]
        sh = NamedSharding(self.mesh, P(self.axis, None))
        shm = NamedSharding(self.mesh, P(self.axis))
        padded = PointCloud(
            points=pad_to_multiple(cloud.points, n_dev),
            normals=pad_to_multiple(cloud.normals, n_dev),
            mask=pad_to_multiple(cloud.mask, n_dev, fill=False),
        )
        if padded.capacity != self.new_capacity:
            raise ValueError(
                f"cloud capacity {padded.capacity} != fusion capacity "
                f"{self.new_capacity} (shapes are static; use one capacity)")
        padded = PointCloud(
            points=jax.device_put(padded.points, sh),
            normals=jax.device_put(padded.normals, sh),
            mask=jax.device_put(padded.mask, shm),
        )
        self.cloud_shards, stats = self._fuse(
            self.cloud_shards, padded,
            jnp.asarray(np.asarray(T_world, dtype=np.float32)))
        self.dropped_total += int(stats.dropped)
        self.num_insertions += 1
        return stats

    def gather(self) -> PointCloud:
        """Full map replicated (host/test path; defeats the sharding)."""
        rep = NamedSharding(self.mesh, P())
        return jax.tree.map(lambda x: jax.device_put(x, rep),
                            self.cloud_shards)

    def size(self) -> int:
        return int(self.cloud_shards.count())

    def points(self) -> np.ndarray:
        """Valid world-frame points (host copy, for viz/eval)."""
        full = self.gather()
        m = np.asarray(full.mask)
        return np.asarray(full.points)[m]
