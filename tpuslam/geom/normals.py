"""Organized-image normal estimation (SURVEY.md §2a R5).

Reference status: point-to-plane ICP implies per-point normals; typical
prototype uses cross products of organized-image neighbors (SURVEY.md §2a R5;
mount empty — provenance [B:5]).

Design: central differences along image rows/cols via `jnp.roll` (pure
shifts — compile to cheap vector moves, no gathers), cross product, normalize,
orient toward the camera.  One fused elementwise pipeline over (H, W).
"""

from __future__ import annotations

import jax.numpy as jnp


def organized_normals(points: jnp.ndarray, mask: jnp.ndarray,
                      depth_disc: float = 0.1):
    """Estimate normals of an organized cloud.

    Args:
      points: (H, W, 3) camera-frame points.
      mask: (H, W) validity.
      depth_disc: m — reject neighbor pairs spanning a depth discontinuity.
    Returns:
      normals (H, W, 3) unit, oriented toward camera (n·p < 0);
      nmask (H, W) bool, subset of `mask`.
    """
    # Central differences with edge-replication via roll + mask fixup.
    right = jnp.roll(points, -1, axis=1)
    left = jnp.roll(points, 1, axis=1)
    down = jnp.roll(points, -1, axis=0)
    up = jnp.roll(points, 1, axis=0)
    m_right = jnp.roll(mask, -1, axis=1)
    m_left = jnp.roll(mask, 1, axis=1)
    m_down = jnp.roll(mask, -1, axis=0)
    m_up = jnp.roll(mask, 1, axis=0)

    du = right - left
    dv = down - up
    # Depth-discontinuity rejection: both neighbors must be close in z.
    z = points[..., 2]
    ok_u = (jnp.abs(right[..., 2] - z) < depth_disc) & (jnp.abs(left[..., 2] - z) < depth_disc)
    ok_v = (jnp.abs(down[..., 2] - z) < depth_disc) & (jnp.abs(up[..., 2] - z) < depth_disc)

    n = jnp.cross(du, dv)
    norm = jnp.linalg.norm(n, axis=-1, keepdims=True)
    good = (
        mask
        & m_right & m_left & m_down & m_up
        & ok_u & ok_v
        & (norm[..., 0] > 1e-12)
    )
    n = n / jnp.maximum(norm, 1e-12)
    # Orient toward the camera (viewing ray is +p from origin).
    flip = jnp.sum(n * points, axis=-1, keepdims=True) > 0
    n = jnp.where(flip, -n, n)
    n = jnp.where(good[..., None], n, 0.0)
    # Zero out the image border (roll wraps around).
    h, w = mask.shape
    border = jnp.zeros((h, w), dtype=bool).at[1:-1, 1:-1].set(True)
    good = good & border
    n = jnp.where(good[..., None], n, 0.0)
    return n, good
