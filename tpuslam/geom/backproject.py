"""Depth-image backprojection and pinhole projection (SURVEY.md §2a R2).

Reference status: per-pixel ``p = depth(u,v) · K⁻¹ · (u,v,1)`` loop in C++
(SURVEY.md §2a R2; mount empty — provenance [B:5]).

Design: fully vectorized over the (H, W) image with `broadcasted_iota`
pixel grids — one fused elementwise op, no gather, organized output
``(H, W, 3)`` + validity mask so downstream normal estimation and projective
association can use image-neighborhood structure.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from tpuslam.config import Intrinsics


def backproject(depth: jnp.ndarray, K: Intrinsics, depth_min: float = 0.1,
                depth_max: float = 10.0):
    """Depth image -> organized point cloud.

    Args:
      depth: (H, W) float meters; <=0 or out-of-range marks invalid pixels.
      K: intrinsics.
    Returns:
      points (H, W, 3) float32 camera-frame, mask (H, W) bool.
    """
    h, w = depth.shape[-2], depth.shape[-1]
    v = lax.broadcasted_iota(depth.dtype, (h, w), 0)
    u = lax.broadcasted_iota(depth.dtype, (h, w), 1)
    x = (u - K.cx) / K.fx * depth
    y = (v - K.cy) / K.fy * depth
    points = jnp.stack([x, y, depth], axis=-1)
    mask = (depth > depth_min) & (depth < depth_max) & jnp.isfinite(depth)
    points = jnp.where(mask[..., None], points, 0.0)
    return points, mask


def project(points: jnp.ndarray, K: Intrinsics):
    """Camera-frame points -> continuous pixel coordinates.

    Args:
      points: (..., 3).
    Returns:
      uv (..., 2) float pixel coords, valid (...,) bool (positive depth).
    """
    z = points[..., 2]
    valid = z > 1e-6
    z_safe = jnp.where(valid, z, 1.0)
    u = points[..., 0] / z_safe * K.fx + K.cx
    v = points[..., 1] / z_safe * K.fy + K.cy
    return jnp.stack([u, v], axis=-1), valid
