"""Point-to-plane ICP solver (SURVEY.md §2a R7, §2b N9, call stack §3.2).

Reference status: C++ loop — correspond → residual → Huber → 6×6 GN →
SE(3) update → converge check (SURVEY.md §2a R7; provenance [B:5]).

Design: the whole alignment is one jitted `lax.while_loop` whose body is
correspond (projective gather or grid-hash probe — no k-d tree) → fused GN
reduction → 6×6 solve → left-multiplied `se3.exp` update (`gn_step`: Triton
kernels on the GPU, plain jnp elsewhere).  Coarse-to-fine pyramid levels
are unrolled in Python (static shapes per level, SURVEY.md §7 "Hard
parts").  Early convergence exits via the while_loop predicate — no host
logic inside the loop.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from tpuslam.config import ICPConfig, Intrinsics
from tpuslam.geom import se3
from tpuslam.geom.cloud import PointCloud
from tpuslam.kernels.correspond import (
    GridIndex,
    brute_force_correspond,
    grid_hash_correspond,
    pack_organized_target,
    projective_correspond_packed,
)
from tpuslam.kernels.gn_reduce import gn_reduce, solve_gn_step
from tpuslam.kernels.gn_triton import gn_epilogue, gn_partials


class ICPResult(NamedTuple):
    T: jnp.ndarray               # (4, 4) estimated src→dst transform
    iters: jnp.ndarray           # () int32 iterations executed (last level)
    rms: jnp.ndarray             # () float inlier RMS point-to-plane residual
    inlier_fraction: jnp.ndarray  # () float inliers / valid source points
    converged: jnp.ndarray       # () bool
    H: jnp.ndarray               # (6, 6) final GN information matrix —
    #                              observability diagnostics (loop-closure
    #                              gating reads eig(H[:3,:3]) = Σw·nnᵀ)
    num_inliers: jnp.ndarray     # () float — absolute inlier count (useful
    #                              when the source is a whole map and the
    #                              fraction-in-view is not meaningful)


class FlatICP:
    """Index map of `flat_icp_scalars` — the single-readback protocol.

    Every host↔device round trip stalls the device, so latency-sensitive
    hosts read an ICPResult's scalars as ONE (20,) f32 vector.  Consumers
    must index through these names, never literals (the tracking loop has
    a DIFFERENT layout — frontend.FlatTrack)."""

    T = slice(0, 16)          # (4, 4) row-major
    CONVERGED = 16
    INLIER_FRACTION = 17
    NUM_INLIERS = 18
    RMS = 19
    SIZE = 20


def flat_icp_scalars(res: "ICPResult") -> jnp.ndarray:
    """Pack an ICPResult's scalars per the FlatICP layout (traceable)."""
    return jnp.concatenate([
        res.T.reshape(16).astype(jnp.float32),
        jnp.stack([
            res.converged.astype(jnp.float32),
            res.inlier_fraction.astype(jnp.float32),
            res.num_inliers.astype(jnp.float32),
            res.rms.astype(jnp.float32),
        ]),
    ])


class _CarryState(NamedTuple):
    T: jnp.ndarray
    it: jnp.ndarray
    delta_sq: jnp.ndarray
    rms: jnp.ndarray
    inlier_fraction: jnp.ndarray
    H: jnp.ndarray
    num_inliers: jnp.ndarray


def _gn_step_xla(x, q, n, w, src_mask, T, cfg: ICPConfig):
    """One GN step as plain jnp: reduce → damped 6×6 solve → exp(δ)·T.

    Returns (T_new, H, δ², Σw·r², Σvalid)."""
    with jax.named_scope("icp.gn_reduce"):
        stats = gn_reduce(x, q, n, w, src_mask, cfg.huber_delta)
    with jax.named_scope("icp.solve"):
        delta = solve_gn_step(stats.H, stats.b, cfg.damping, cfg.damping_abs,
                              cfg.max_trans_step, cfg.max_rot_step)
        return (se3.exp(delta) @ T, stats.H, jnp.sum(delta * delta),
                stats.weighted_sq_sum, stats.num_inliers)


def _gn_step_kernels(x, q, n, w, src_mask, T, cfg: ICPConfig,
                     interpret: bool = False):
    """The same GN step as two Triton-route kernels (kernels/gn_triton.py):
    a blocked reduce, then one program for fold + solve + exp + compose.
    On the GPU this replaces XLA's GEMM, LU solve and ~20 small launches
    per step (PERF.md, Findings)."""
    del src_mask        # padding rows already carry w = 0
    with jax.named_scope("icp.gn_reduce"):
        parts = gn_partials(x, q, n, w, cfg.huber_delta, interpret=interpret)
    with jax.named_scope("icp.solve"):
        return gn_epilogue(parts, T, cfg.damping, cfg.damping_abs,
                           cfg.max_trans_step, cfg.max_rot_step,
                           interpret=interpret)


def gn_step(x, q, n, w, src_mask, T, cfg: ICPConfig):
    """One GN step, lowered per platform: the kernels on CUDA, plain jnp
    everywhere else (the kernels have no CPU lowering)."""
    return lax.platform_dependent(
        x, q, n, w, src_mask, T,
        default=partial(_gn_step_xla, cfg=cfg),
        cuda=partial(_gn_step_kernels, cfg=cfg))


def _icp_loop(correspond_fn, src: PointCloud, T0: jnp.ndarray,
              cfg: ICPConfig, max_iters: int,
              inner_steps: int | None = None,
              tol_delta: float | None = None) -> ICPResult:
    """Generic ICP driver; `correspond_fn(x, mask, src_n_rot)` supplies matches.

    `correspond_fn` receives source points already mapped by the current
    transform estimate and returns a `Correspondence`.
    """
    if inner_steps is None:
        inner_steps = cfg.inner_steps
    inner = max(1, int(inner_steps))
    if tol_delta is None:
        tol_delta = cfg.tol_delta
    # Loop-invariant inlier-fraction denominator (hoisted out of the body).
    num_valid_src = jnp.sum(src.mask.astype(src.points.dtype))

    def body(state: _CarryState) -> _CarryState:
        # One correspondence gather per outer iteration (the dominant cost),
        # then `inner` GN solves against the same association with the
        # source re-transformed between solves (inner/outer ICP): the IRLS
        # Huber reweighting still sees fresh residuals each inner step.
        with jax.named_scope("icp.correspond"):
            x = se3.transform_points(state.T, src.points)
            n_rot = se3.rotate_vectors(state.T, src.normals)
            corr = correspond_fn(x, src.mask, n_rot)
        T_new = state.T
        for k in range(inner):
            if k > 0:
                x = se3.transform_points(T_new, src.points)
            T_new, H, delta_sq, wsq, ninl = gn_step(
                x, corr.q, corr.n, corr.w, src.mask, T_new, cfg)
        return _CarryState(
            T=T_new,
            it=state.it + inner,
            delta_sq=delta_sq,
            rms=jnp.sqrt(wsq / jnp.maximum(ninl, 1.0)),
            inlier_fraction=ninl / jnp.maximum(num_valid_src, 1.0),
            H=H,
            num_inliers=ninl,
        )

    def cond(state: _CarryState) -> jnp.ndarray:
        return (state.it < max_iters) & (state.delta_sq > tol_delta ** 2)

    init = _CarryState(
        T=T0,
        it=jnp.zeros((), jnp.int32),
        delta_sq=jnp.full((), jnp.inf),
        rms=jnp.full((), jnp.inf),
        inlier_fraction=jnp.zeros(()),
        H=jnp.zeros((6, 6), dtype=T0.dtype),
        num_inliers=jnp.zeros(()),
    )
    out = lax.while_loop(cond, body, init)
    return ICPResult(
        T=out.T,
        iters=out.it,
        rms=out.rms,
        inlier_fraction=out.inlier_fraction,
        converged=out.delta_sq <= tol_delta ** 2,
        H=out.H,
        num_inliers=out.num_inliers,
    )


def align_clouds(src: PointCloud, dst: PointCloud, T0: jnp.ndarray,
                 cfg: ICPConfig, use_grid: bool = True) -> ICPResult:
    """Align two unorganized clouds (loop closure / map alignment path).

    `use_grid=False` selects the O(N·M) brute-force oracle (tests, tiny clouds).
    """
    if use_grid:
        index = _build_index(dst, cfg)

        def correspond(x, mask, n_rot):
            return grid_hash_correspond(x, mask, index, cfg.max_corr_dist)

    else:

        def correspond(x, mask, n_rot):
            return brute_force_correspond(x, mask, dst, cfg.max_corr_dist)

    return _icp_loop(correspond, src, T0, cfg, cfg.max_iters)


align_clouds_jit = jax.jit(align_clouds, static_argnames=("cfg", "use_grid"))


def align_to_index(src: PointCloud, index: GridIndex, T0: jnp.ndarray,
                   cfg: ICPConfig) -> ICPResult:
    """Align a cloud against a prebuilt grid index (frame-to-map tracking,
    SURVEY.md §2a R10 / BASELINE config 4: ICP against the voxel map).

    The index is built once per map update (keyframe promotion), not per
    frame — the per-iteration cost is pure batched probing."""

    def correspond(x, mask, n_rot):
        return grid_hash_correspond(x, mask, index, cfg.max_corr_dist)

    return _icp_loop(correspond, src, T0, cfg, cfg.max_iters)


align_to_index_jit = jax.jit(align_to_index, static_argnames=("cfg",))


def align_map_to_frame(map_cloud: PointCloud, frame: "Frame", K: Intrinsics,
                       T0_world_cam: jnp.ndarray, cfg: ICPConfig) -> ICPResult:
    """Frame-to-map tracking by REVERSE projective association
    (SURVEY.md §2a R10 / BASELINE config 4).

    Instead of probing a grid-hash index per frame point (27 searchsorted +
    candidate gathers per query), flip the roles: the *map* is the source and
    the organized *frame* is the target.  Each world-frame map point is
    transformed into the camera, projected, and matched to the frame pixel it
    lands on with ONE 16-byte row gather from the frame's packed table —
    exactly the machinery that makes frame-to-frame tracking fast.  No index
    build, no probe; map points outside the frustum simply weigh zero
    (in_front / in_bounds gates), keeping every shape static.

    Solves for S = T_cam←world via point-to-plane GN on the frame normals
    (residual nᶠ·(S·q − p)); returns T_world←cam = S⁻¹ in `.T`.

    `inlier_fraction` is measured against the map points inside the warm-
    start frustum (a whole-map denominator would be meaningless — the camera
    only ever sees a fraction of the map); `num_inliers` is absolute.
    """
    h, w, _ = frame.points.shape
    packed = pack_organized_target(
        frame.points, frame.normals, frame.mask,
        dtype=jnp.dtype(getattr(cfg, "packed_dtype", "float32")),
    )

    def correspond(x, mask, n_rot):
        return projective_correspond_packed(
            x, mask, packed, h, w, K, cfg.max_corr_dist,
            src_normals_in_dst=n_rot,
            normal_dot_min=cfg.normal_dot_min,
        )

    S0 = se3.inv(T0_world_cam)
    # Frustum-cull at the warm start so inlier_fraction has a meaningful
    # denominator (points the camera could plausibly see).
    from tpuslam.geom.backproject import project

    x0 = se3.transform_points(S0, map_cloud.points)
    uv0, in_front0 = project(x0, K)
    margin = 0.1  # fractional frustum slack for warm-start error
    in_view = (
        in_front0
        & (uv0[..., 0] >= -margin * w) & (uv0[..., 0] < (1 + margin) * w)
        & (uv0[..., 1] >= -margin * h) & (uv0[..., 1] < (1 + margin) * h)
        & (x0[..., 2] < cfg.depth_max)
    )
    src = PointCloud(points=map_cloud.points, normals=map_cloud.normals,
                     mask=map_cloud.mask & in_view)
    res = _icp_loop(correspond, src, S0, cfg, cfg.max_iters)
    return res._replace(T=se3.inv(res.T))


align_map_to_frame_jit = jax.jit(align_map_to_frame,
                                 static_argnames=("cfg",))


def align_cloud_to_organized(src: PointCloud, packed: jnp.ndarray,
                             height: int, width: int, K: Intrinsics,
                             T0: jnp.ndarray, cfg: ICPConfig) -> ICPResult:
    """Align an unorganized cloud onto an ORGANIZED target's packed table.

    The backend's verification path (loop closure, relocalization): the
    target keyframe keeps the row-gather table its own tracking already
    built (icp.pack_pyramid), so association is ONE 16-byte row gather per
    source point per iteration — the grid-hash probe gathers 27 cells × 16
    candidates ≈ 430 rows per query instead.  Estimates T s.t.
    target_point ≈ T·src_point
    (the pose of the src cloud's frame in the target camera frame).

    `inlier_fraction` is measured against ALL valid source points (like the
    grid-hash path) so the overlap gates keep their meaning.
    """

    def correspond(x, mask, n_rot):
        return projective_correspond_packed(
            x, mask, packed, height, width, K, cfg.max_corr_dist,
            src_normals_in_dst=n_rot,
            normal_dot_min=cfg.normal_dot_min,
        )

    return _icp_loop(correspond, src, T0, cfg, cfg.max_iters)


def _build_index(dst: PointCloud, cfg: ICPConfig) -> GridIndex:
    from tpuslam.kernels.correspond import build_grid_index

    # Cell edge ≥ max correspondence distance ⇒ 27-cell probe is sufficient.
    return build_grid_index(dst, cell=float(cfg.max_corr_dist))


class Frame(NamedTuple):
    """One organized RGB-D frame at a single pyramid level."""

    points: jnp.ndarray    # (H, W, 3) camera-frame
    normals: jnp.ndarray   # (H, W, 3)
    mask: jnp.ndarray      # (H, W)

    def as_cloud(self) -> PointCloud:
        h, w, _ = self.points.shape
        nm = self.normals.reshape(h * w, 3)
        return PointCloud(
            points=self.points.reshape(h * w, 3),
            normals=nm,
            mask=self.mask.reshape(h * w) & (jnp.sum(nm * nm, axis=-1) > 0.5),
        )


def subsample_frame(frame: Frame, factor: int = 2) -> Frame:
    """Stride-subsample an organized frame (pyramid level down)."""
    return Frame(
        points=frame.points[::factor, ::factor],
        normals=frame.normals[::factor, ::factor],
        mask=frame.mask[::factor, ::factor],
    )


def subsample_source(frame: Frame, factor: int) -> PointCloud:
    """Decimate the SOURCE side of an alignment (see ICPConfig.finest_subsample).

    factor 1 → all pixels; 2 → every other ROW (contiguous row slices keep
    the projective gather's spatial locality, which an interleaved
    checkerboard pattern defeats); 4 → one stride-2 grid.  Static shapes in every case; the
    target table is untouched so association precision is unaffected — only
    the residual count drops.
    """
    if factor == 1:
        return frame.as_cloud()
    if factor == 2:
        return Frame(points=frame.points[0::2], normals=frame.normals[0::2],
                     mask=frame.mask[0::2]).as_cloud()
    if factor == 4:
        return subsample_frame(frame, 2).as_cloud()
    raise ValueError(f"finest_subsample must be 1, 2 or 4; got {factor}")


def select_level_source(src_pyr, li: int, cfg: ICPConfig) -> PointCloud:
    """Per-level SOURCE cloud under the decimation knobs.

    Shared by the single-device (`align_frames_packed`) and point-sharded
    SPMD (`dist/sharded_icp.py`) drivers so their residual sets stay
    identical.  factor 4 uses the next-coarser pyramid frame as the source
    when one exists: the coarser frame IS the stride-2-grid decimation of
    THIS level, already materialized, so no strided slice of the (H, W, 3)
    points is needed.  The target table stays at this
    level's full resolution either way, so association precision is
    unchanged — only source density drops.
    """
    lvl_sub = getattr(cfg, "level_subsample", None)
    if lvl_sub is not None and li < len(lvl_sub):
        factor = int(lvl_sub[li])
    else:
        factor = int(getattr(cfg, "finest_subsample", 1)) if li == 0 else 1
    if factor == 4 and li + 1 < len(src_pyr):
        return src_pyr[li + 1].as_cloud()
    return subsample_source(src_pyr[li], factor)


def build_pyramid(frame: Frame, levels: int):
    """[finest, ..., coarsest] stride-2 pyramid."""
    pyr = [frame]
    for _ in range(levels - 1):
        pyr.append(subsample_frame(pyr[-1]))
    return pyr


def pack_pyramid(pyr, cfg: ICPConfig) -> tuple:
    """Pack every level of an organized pyramid into row-gather tables.

    Packing rewrites every point into 8-wide rows, so the KEYFRAME tables
    are built once per keyframe promotion — not once per tracked frame.  Both
    odometry drivers (host `Odometry` and device `scan_odometry`) carry the
    packed pyramid and re-pack only on promotion.
    """
    dtype = jnp.dtype(getattr(cfg, "packed_dtype", "float32"))
    with jax.named_scope("pack_target"):
        return tuple(
            pack_organized_target(f.points, f.normals, f.mask, dtype=dtype)
            for f in pyr
        )


def align_frames_packed(
    src_pyr,
    dst_packed: tuple,
    K: Intrinsics,
    T0: jnp.ndarray,
    cfg: ICPConfig,
) -> ICPResult:
    """Coarse-to-fine projective ICP against pre-packed target tables.

    `dst_packed[li]` is `pack_pyramid`'s table for level `li`; the target's
    image geometry is taken from `src_pyr` (both sides of a tracking pair
    share the pyramid shapes).
    """
    levels = len(src_pyr)
    T = T0
    result = None
    for li in range(levels - 1, -1, -1):  # coarsest → finest
        src_f: Frame = src_pyr[li]
        K_l = K.scaled(1.0 / (2 ** li))
        src_cloud = select_level_source(src_pyr, li, cfg)
        h, w, _ = src_f.points.shape
        packed = dst_packed[li]
        # The target's image geometry is taken from the source frame — the
        # projective row index is v·w + u, so a differently-shaped target
        # table would be read at WRONG pixels without any runtime error.
        # Shapes are static: fail at trace time instead.
        if packed.shape[0] != h * w:
            raise ValueError(
                f"level {li}: target table has {packed.shape[0]} rows but "
                f"source frame is {h}×{w} — align_frames_packed requires "
                f"both sides of the pair to share pyramid shapes")

        def correspond(x, mask, n_rot, packed=packed, h=h, w=w, K_l=K_l):
            return projective_correspond_packed(
                x, mask, packed, h, w,
                K_l, cfg.max_corr_dist,
                src_normals_in_dst=n_rot,
                normal_dot_min=cfg.normal_dot_min,
            )

        iters = cfg.iters_per_level[li] if li < len(cfg.iters_per_level) else cfg.max_iters
        ipl = getattr(cfg, "inner_steps_per_level", None)
        inner = ipl[li] if ipl is not None and li < len(ipl) else None
        tpl = getattr(cfg, "tol_delta_per_level", None)
        tol = tpl[li] if tpl is not None and li < len(tpl) else None
        result = _icp_loop(correspond, src_cloud, T, cfg, iters,
                           inner_steps=inner, tol_delta=tol)
        T = result.T
    return result


def align_frames(
    src_pyr,
    dst_pyr,
    K: Intrinsics,
    T0: jnp.ndarray,
    cfg: ICPConfig,
) -> ICPResult:
    """Coarse-to-fine projective ICP between two organized frames.

    Estimates T s.t. `dst_point ≈ T · src_point` (pose of the src camera in
    the dst camera frame).  Pyramid levels are unrolled; each level runs a
    jitted while_loop with that level's static shapes.  Packs the target
    per call — loop-hoist with `pack_pyramid` + `align_frames_packed` when
    the same target is tracked against repeatedly (keyframe tracking).
    """
    return align_frames_packed(src_pyr, pack_pyramid(dst_pyr, cfg), K, T0,
                               cfg)


@partial(jax.jit, static_argnames=("cfg",))
def align_frames_jit(src_pyr, dst_pyr, K: Intrinsics, T0: jnp.ndarray,
                     cfg: ICPConfig) -> ICPResult:
    return align_frames(src_pyr, dst_pyr, K, T0, cfg)
