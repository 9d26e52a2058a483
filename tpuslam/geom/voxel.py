"""Voxel-grid downsampling (SURVEY.md §2a R4; map in tpuslam/mapping.py).

Reference status: C++ hash of points into a voxel grid keeping a centroid per
voxel (SURVEY.md §2a R4; mount empty — provenance [B:5]).

Design: scatter with colliding keys is slow, so we avoid per-voxel hash insertion
entirely (SURVEY.md §7 "Hard parts").  Instead:

  1. quantize each point to integer voxel coords in a fixed world AABB,
  2. lexicographically sort points by a two-part int32 voxel key using
     `lax.sort(num_keys=2)` (keys stay in int32 — no x64 needed),
  3. mark segment boundaries where the key changes, prefix-sum to get dense
     segment ids,
  4. `segment_sum` positions/normals/counts into a fixed-`capacity` output
     (one overflow bin absorbs the tail), then divide by counts.

Everything is static-shape; invalid/out-of-AABB points sort to the end under
an int32-max key and land in a masked-out segment.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from tpuslam.geom.cloud import PointCloud

_INVALID_KEY = jnp.iinfo(jnp.int32).max


def voxel_keys(points: jnp.ndarray, mask: jnp.ndarray, voxel_size: float,
               origin: float, extent: float):
    """Two-part lexicographic voxel key per point.

    Returns (key_hi, key_lo) int32 arrays; invalid points get
    (INT32_MAX, INT32_MAX).  dims³ may exceed int32 so the key is split:
    key_hi = cx·dims + cy, key_lo = cz.
    """
    dims = int(-(-extent // voxel_size))  # ceil
    c = jnp.floor((points - origin) / voxel_size).astype(jnp.int32)
    in_box = jnp.all((c >= 0) & (c < dims), axis=-1) & mask
    c = jnp.clip(c, 0, dims - 1)
    key_hi = c[..., 0] * dims + c[..., 1]
    key_lo = c[..., 2]
    key_hi = jnp.where(in_box, key_hi, _INVALID_KEY)
    key_lo = jnp.where(in_box, key_lo, _INVALID_KEY)
    return key_hi, key_lo, in_box


def voxel_downsample(cloud: PointCloud, voxel_size: float, capacity: int,
                     origin: float = -20.0, extent: float = 40.0) -> PointCloud:
    """Downsample to ≤`capacity` voxel centroids (static output shape).

    Output normals are the renormalized per-voxel mean of input normals.
    """
    pts, nrm, mask = cloud.points, cloud.normals, cloud.mask
    key_hi, key_lo, valid = voxel_keys(pts, mask, voxel_size, origin, extent)

    w = valid.astype(pts.dtype)
    operands = (
        key_hi, key_lo, w,
        pts[..., 0], pts[..., 1], pts[..., 2],
        nrm[..., 0], nrm[..., 1], nrm[..., 2],
    )
    sorted_ops = lax.sort(operands, num_keys=2)
    s_hi, s_lo, s_w = sorted_ops[0], sorted_ops[1], sorted_ops[2]
    s_pts = jnp.stack(sorted_ops[3:6], axis=-1)
    s_nrm = jnp.stack(sorted_ops[6:9], axis=-1)

    new_seg = (
        (s_hi != jnp.roll(s_hi, 1)) | (s_lo != jnp.roll(s_lo, 1))
    ).at[0].set(True)
    seg_id = jnp.cumsum(new_seg.astype(jnp.int32)) - 1
    seg_id = jnp.minimum(seg_id, capacity)  # overflow bin = capacity

    num_segments = capacity + 1
    sum_pts = jax.ops.segment_sum(s_pts * s_w[:, None], seg_id, num_segments)
    sum_nrm = jax.ops.segment_sum(s_nrm * s_w[:, None], seg_id, num_segments)
    counts = jax.ops.segment_sum(s_w, seg_id, num_segments)

    sum_pts, sum_nrm, counts = sum_pts[:capacity], sum_nrm[:capacity], counts[:capacity]
    out_mask = counts > 0
    denom = jnp.maximum(counts, 1.0)[:, None]
    centroids = sum_pts / denom
    nmean = sum_nrm / denom
    nnorm = jnp.linalg.norm(nmean, axis=-1, keepdims=True)
    normals = jnp.where(nnorm > 1e-8, nmean / jnp.maximum(nnorm, 1e-8), 0.0)
    centroids = jnp.where(out_mask[:, None], centroids, 0.0)
    return PointCloud(points=centroids, normals=normals, mask=out_mask)
