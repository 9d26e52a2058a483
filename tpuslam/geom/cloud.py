"""Point-cloud container (SURVEY.md §2a R3).

Reference status: C++ array-of-points struct with rigid-transform apply
(SURVEY.md §2a R3; mount empty — provenance implied by [B:5]).

Design: a pytree NamedTuple with **fixed-capacity padding discipline** —
`points` is always a static-shape (N, 3) array and `mask` marks which rows are
real.  Every consumer (voxelize, ICP reduction, map fusion) reduces with the
mask; no dynamic shapes ever reach XLA.  Clouds can be "organized" (N = H*W,
row-major pixels) which the projective-association kernel exploits.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp

from tpuslam.geom import se3


class PointCloud(NamedTuple):
    """Fixed-capacity masked point cloud.

    points:  (N, 3) float — padded rows hold zeros.
    normals: (N, 3) float — unit normals, zeros where unknown/padded.
    mask:    (N,)  bool  — True for valid rows.
    """

    points: jnp.ndarray
    normals: jnp.ndarray
    mask: jnp.ndarray

    @property
    def capacity(self) -> int:
        return self.points.shape[-2]

    def count(self) -> jnp.ndarray:
        return jnp.sum(self.mask.astype(jnp.int32), axis=-1)

    def transform(self, T: jnp.ndarray) -> "PointCloud":
        """Rigid transform; rotates normals with the rotation block."""
        return PointCloud(
            points=se3.transform_points(T, self.points),
            normals=se3.rotate_vectors(T, self.normals),
            mask=self.mask,
        )

    def masked_points(self) -> jnp.ndarray:
        return jnp.where(self.mask[..., None], self.points, 0.0)

    def centroid(self) -> jnp.ndarray:
        n = jnp.maximum(self.count().astype(self.points.dtype), 1.0)
        return jnp.sum(self.masked_points(), axis=-2) / n[..., None]

    @classmethod
    def from_points(
        cls,
        points: jnp.ndarray,
        normals: Optional[jnp.ndarray] = None,
        mask: Optional[jnp.ndarray] = None,
        capacity: Optional[int] = None,
    ) -> "PointCloud":
        """Build from raw arrays, optionally padding up to `capacity`."""
        n = points.shape[-2]
        if normals is None:
            normals = jnp.zeros_like(points)
        if mask is None:
            mask = jnp.ones(points.shape[:-1], dtype=bool)
        if capacity is not None and capacity != n:
            if capacity < n:
                raise ValueError(f"capacity {capacity} < point count {n}")
            pad = capacity - n
            widths = [(0, 0)] * (points.ndim - 2) + [(0, pad), (0, 0)]
            points = jnp.pad(points, widths)
            normals = jnp.pad(normals, widths)
            mask = jnp.pad(mask, [(0, 0)] * (mask.ndim - 1) + [(0, pad)])
        return cls(points=points, normals=normals, mask=mask)
