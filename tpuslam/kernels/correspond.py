"""Correspondence search — the k-d-tree replacement (SURVEY.md §2a R6, §2b N7).

Reference status: per-ICP-iteration nearest-neighbor queries against a CPU
k-d tree; the designated hot spot ("Replace the CPU k-d tree", BASELINE.json
north-star; SURVEY.md §2a R6).

Design — three tree-free, fully batched strategies:

  * `projective_correspond` — the production path for organized targets
    (frame-to-frame / frame-to-keyframe): transform source points into the
    target camera, project, and read the target point/normal at that pixel.
    O(1) per point, one gather, no search structure at all.
  * `grid_hash_correspond` — for unorganized targets (voxel maps, keyframe
    clouds): pack voxel coords into a sortable int32 key, sort the target
    once, then probe the 27 neighbor cells per query with `searchsorted` +
    bounded candidate scan.  No pointers, no recursion, static shapes.
  * `brute_force_correspond` — O(N·M) oracle for tests and small clouds.

All return a `Correspondence(q, n, w)` where `w` is a {0,1} validity weight
folded into the GN reduction — rejected matches simply weigh zero, keeping
every shape static (SURVEY.md §7 padding discipline).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
from jax import lax

from tpuslam.config import Intrinsics
from tpuslam.geom.backproject import project
from tpuslam.geom.cloud import PointCloud


class Correspondence(NamedTuple):
    q: jnp.ndarray      # (N, 3) matched target points
    n: jnp.ndarray      # (N, 3) matched target normals
    w: jnp.ndarray      # (N,) validity weight in {0, 1}
    # Index of the match in the target's own storage order (sorted order for
    # grid-hash, flat pixel index for projective) — consumed by map BA to
    # couple observations to control points without any O(N·M) recovery.
    # None where the producer has no meaningful index (brute force oracle
    # returns target-row indices; some wrappers leave it None).
    idx: jnp.ndarray | None = None


def brute_force_correspond(
    x: jnp.ndarray,
    x_mask: jnp.ndarray,
    dst: PointCloud,
    max_dist: float,
) -> Correspondence:
    """Exact NN via a full (N, M) distance matrix. Test oracle; small clouds only."""
    d2 = jnp.sum((x[:, None, :] - dst.points[None, :, :]) ** 2, axis=-1)
    d2 = jnp.where(dst.mask[None, :], d2, jnp.inf)
    j = jnp.argmin(d2, axis=1)
    best = jnp.take_along_axis(d2, j[:, None], axis=1)[:, 0]
    q = dst.points[j]
    n = dst.normals[j]
    has_normal = jnp.sum(n * n, axis=-1) > 0.5
    valid = x_mask & (best < max_dist * max_dist) & jnp.isfinite(best) & has_normal
    return Correspondence(q=q, n=n, w=valid.astype(x.dtype),
                          idx=j.astype(jnp.int32))


def pack_organized_target(dst_points: jnp.ndarray, dst_normals: jnp.ndarray,
                          dst_mask: jnp.ndarray,
                          dtype: jnp.dtype | None = None) -> jnp.ndarray:
    """Pack an organized target into one (H·W, 8) row-major table.

    Row = [qx qy qz nx ny nz mask·has_normal pad].  The per-iteration
    association then needs ONE row gather of contiguous bytes instead of
    three separate gathers.  Pack once per pyramid level, outside the
    iteration loop.

    `dtype=float16` halves the row to 16 bytes; f16's 10-bit mantissa keeps
    the converged pose within 6e-5 of the f32 table (all arithmetic stays
    f32 — only the stored rows are quantized).
    """
    h, w = dst_mask.shape
    has_normal = jnp.sum(dst_normals * dst_normals, axis=-1) > 0.5
    packed = jnp.concatenate(
        [
            dst_points.reshape(h * w, 3),
            dst_normals.reshape(h * w, 3),
            (dst_mask & has_normal).reshape(h * w, 1).astype(dst_points.dtype),
            jnp.zeros((h * w, 1), dtype=dst_points.dtype),
        ],
        axis=1,
    )
    if dtype is not None:
        packed = packed.astype(dtype)
    return packed


def projective_correspond_packed(
    x: jnp.ndarray,
    x_mask: jnp.ndarray,
    packed: jnp.ndarray,
    height: int,
    width: int,
    K: Intrinsics,
    max_dist: float,
    src_normals_in_dst: jnp.ndarray | None = None,
    normal_dot_min: float = 0.0,
) -> Correspondence:
    """Projective association via one row gather from a packed target.

    Args:
      x: (N, 3) source points already transformed into the target camera frame.
      x_mask: (N,) source validity.
      packed: (H·W, 8) table from `pack_organized_target`.
      height/width: target image shape (static).
      K: target camera intrinsics (level-scaled for pyramids).
      max_dist: Euclidean rejection radius.
      src_normals_in_dst: optional (N, 3) source normals rotated into the
        target frame for the compatibility gate.
      normal_dot_min: reject if n_dst · n_src below this cosine.
    """
    uv, in_front = project(x, K)
    ui = jnp.round(uv[..., 0]).astype(jnp.int32)
    vi = jnp.round(uv[..., 1]).astype(jnp.int32)
    in_bounds = (ui >= 0) & (ui < width) & (vi >= 0) & (vi < height)
    flat = jnp.clip(vi, 0, height - 1) * width + jnp.clip(ui, 0, width - 1)
    rows = packed[flat].astype(x.dtype)      # ONE (N, 8) gather
    q = rows[:, :3]
    n = rows[:, 3:6]
    dmask = rows[:, 6] > 0.5
    d2 = jnp.sum((x - q) ** 2, axis=-1)
    valid = (
        x_mask & in_front & in_bounds & dmask & (d2 < max_dist * max_dist)
    )
    if src_normals_in_dst is not None and normal_dot_min > 0.0:
        dot = jnp.sum(n * src_normals_in_dst, axis=-1)
        valid = valid & (dot > normal_dot_min)
    return Correspondence(q=q, n=n, w=valid.astype(x.dtype), idx=flat)


def projective_correspond(
    x: jnp.ndarray,
    x_mask: jnp.ndarray,
    dst_points: jnp.ndarray,
    dst_normals: jnp.ndarray,
    dst_mask: jnp.ndarray,
    K: Intrinsics,
    max_dist: float,
    src_normals_in_dst: jnp.ndarray | None = None,
    normal_dot_min: float = 0.0,
) -> Correspondence:
    """Unpacked-interface wrapper around `projective_correspond_packed`.

    Prefer packing once outside an iteration loop; this convenience form
    re-packs per call (cheap — one concat — but loop-hoisting it is better).
    """
    h, w = dst_mask.shape
    packed = pack_organized_target(dst_points, dst_normals, dst_mask)
    return projective_correspond_packed(
        x, x_mask, packed, h, w, K, max_dist,
        src_normals_in_dst=src_normals_in_dst,
        normal_dot_min=normal_dot_min,
    )


# ---------------------------------------------------------------------------
# Grid-hash NN for unorganized targets (voxel map / keyframe clouds).
# ---------------------------------------------------------------------------

_GRID_DIMS = 256          # per-axis cells; 8 bits each packs into 24-bit int32
_INVALID_KEY = jnp.iinfo(jnp.int32).max


def _pack_keys(points: jnp.ndarray, mask: jnp.ndarray, cell: float,
               origin: jnp.ndarray):
    """Quantize to a local 256³ grid anchored at `origin`; pack to int32."""
    c = jnp.floor((points - origin) / cell).astype(jnp.int32)
    ok = jnp.all((c >= 0) & (c < _GRID_DIMS), axis=-1) & mask
    c = jnp.clip(c, 0, _GRID_DIMS - 1)
    key = (c[..., 0] << 16) | (c[..., 1] << 8) | c[..., 2]
    return jnp.where(ok, key, _INVALID_KEY), c, ok


class GridIndex(NamedTuple):
    """Sorted-by-cell-key target cloud — a static-shape 'hash table'."""

    keys: jnp.ndarray     # (M,) sorted packed cell keys
    points: jnp.ndarray   # (M, 3) sorted
    normals: jnp.ndarray  # (M, 3) sorted
    origin: jnp.ndarray   # (3,) grid anchor
    cell: jnp.ndarray     # () cell edge length


def build_grid_index(dst: PointCloud, cell: float,
                     origin: jnp.ndarray | None = None) -> GridIndex:
    """Sort the target cloud by packed voxel key (one `lax.sort`, no scatter)."""
    if origin is None:
        # Anchor so the cloud sits inside the 256³ local grid.
        origin = dst.centroid() - 0.5 * _GRID_DIMS * cell
    keys, _, _ = _pack_keys(dst.points, dst.mask, cell, origin)
    skeys, px, py, pz, nx, ny, nz = lax.sort(
        (
            keys,
            dst.points[:, 0], dst.points[:, 1], dst.points[:, 2],
            dst.normals[:, 0], dst.normals[:, 1], dst.normals[:, 2],
        ),
        num_keys=1,
    )
    return GridIndex(
        keys=skeys,
        points=jnp.stack([px, py, pz], axis=-1),
        normals=jnp.stack([nx, ny, nz], axis=-1),
        origin=jnp.asarray(origin),
        cell=jnp.asarray(cell),
    )


def grid_hash_correspond(
    x: jnp.ndarray,
    x_mask: jnp.ndarray,
    index: GridIndex,
    max_dist: float,
    candidates_per_cell: int = 16,
) -> Correspondence:
    """Approximate NN by probing the 27 neighbor cells of each query.

    Exact within `max_dist` provided the index cell size ≥ max_dist and no
    cell holds more than `candidates_per_cell` points (otherwise the nearest
    may be truncated — with voxel-downsampled targets cells hold O(1) points).
    """
    kq = candidates_per_cell
    c = jnp.floor((x - index.origin) / index.cell).astype(jnp.int32)
    best_d2 = jnp.full(x.shape[:1], jnp.inf, dtype=x.dtype)
    best_q = jnp.zeros_like(x)
    best_n = jnp.zeros_like(x)
    best_i = jnp.zeros(x.shape[:1], dtype=jnp.int32)
    m = index.keys.shape[0]
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                cc = c + jnp.array([dx, dy, dz], dtype=jnp.int32)
                ok = jnp.all((cc >= 0) & (cc < _GRID_DIMS), axis=-1)
                key = (cc[..., 0] << 16) | (cc[..., 1] << 8) | cc[..., 2]
                start = jnp.searchsorted(index.keys, key)
                idx = start[:, None] + jnp.arange(kq, dtype=start.dtype)[None, :]
                idx = jnp.clip(idx, 0, m - 1)
                cand_key = index.keys[idx]
                cand_ok = (cand_key == key[:, None]) & ok[:, None]
                cq = index.points[idx]                    # (N, kq, 3)
                cn = index.normals[idx]
                d2 = jnp.sum((x[:, None, :] - cq) ** 2, axis=-1)
                d2 = jnp.where(cand_ok, d2, jnp.inf)
                jbest = jnp.argmin(d2, axis=1)
                dbest = jnp.take_along_axis(d2, jbest[:, None], axis=1)[:, 0]
                qbest = jnp.take_along_axis(cq, jbest[:, None, None], axis=1)[:, 0]
                nbest = jnp.take_along_axis(cn, jbest[:, None, None], axis=1)[:, 0]
                ibest = jnp.take_along_axis(idx, jbest[:, None], axis=1)[:, 0]
                better = dbest < best_d2
                best_d2 = jnp.where(better, dbest, best_d2)
                best_q = jnp.where(better[:, None], qbest, best_q)
                best_n = jnp.where(better[:, None], nbest, best_n)
                best_i = jnp.where(better, ibest.astype(jnp.int32), best_i)
    has_normal = jnp.sum(best_n * best_n, axis=-1) > 0.5
    valid = (
        x_mask & jnp.isfinite(best_d2) & (best_d2 < max_dist * max_dist)
        & has_normal
    )
    return Correspondence(q=best_q, n=best_n, w=valid.astype(x.dtype),
                          idx=best_i)
