"""Point-sharded SPMD ICP — the workload's tensor-parallel axis
(SURVEY.md §2c "TP" row; provenance [B:5] "each chip reduces its point shard
to partial (H, b); psum ... completes the 6×6 GN system").

Design: the source cloud's *points* are sharded over the mesh; the organized
target frame is replicated (it's small — one depth image per level).  The
entire coarse-to-fine ICP, including its `lax.while_loop`, runs inside one
`shard_map`: every device executes identical iterations on its point shard;
the only cross-device traffic is an 8-float-wide `psum` of the partial
(H, b, stats) per iteration — a latency-bound all-reduce over the interconnect.
The solved 6-DoF update is therefore bit-identical on every device, and the
pose never needs broadcasting.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from tpuslam.config import ICPConfig, Intrinsics
from tpuslam.dist.mesh import SHARD_AXIS, pad_to_multiple
from tpuslam.geom import se3
from tpuslam.geom.cloud import PointCloud
from tpuslam.icp import Frame, ICPResult, _CarryState, select_level_source
from tpuslam.kernels.correspond import (
    pack_organized_target,
    projective_correspond_packed,
)
from tpuslam.kernels.gn_reduce import gn_reduce, solve_gn_step


def _icp_level_spmd(src_cloud: PointCloud, dst_f: Frame, K_l: Intrinsics,
                    T0: jnp.ndarray, cfg: ICPConfig, max_iters: int,
                    axis: str, inner_steps: int | None = None,
                    tol_delta: float | None = None) -> ICPResult:
    """One pyramid level, executing on a point shard inside shard_map."""
    h, w = dst_f.mask.shape
    packed = pack_organized_target(
        dst_f.points, dst_f.normals, dst_f.mask,
        dtype=jnp.dtype(getattr(cfg, "packed_dtype", "float32")),
    )
    inner = max(1, int(inner_steps if inner_steps is not None
                       else getattr(cfg, "inner_steps", 1)))
    tol = float(tol_delta) if tol_delta is not None else cfg.tol_delta

    def body(state: _CarryState) -> _CarryState:
        x = se3.transform_points(state.T, src_cloud.points)
        n_rot = se3.rotate_vectors(state.T, src_cloud.normals)
        corr = projective_correspond_packed(
            x, src_cloud.mask, packed, h, w,
            K_l, cfg.max_corr_dist,
            src_normals_in_dst=n_rot,
            normal_dot_min=cfg.normal_dot_min,
        )
        T_new = state.T
        for k in range(inner):
            if k > 0:
                x = se3.transform_points(T_new, src_cloud.points)
            stats = gn_reduce(x, corr.q, corr.n, corr.w, src_cloud.mask,
                              cfg.huber_delta)
            # THE collective: partial normal equations → global (§2c TP).
            H = lax.psum(stats.H, axis)
            b = lax.psum(stats.b, axis)
            delta = solve_gn_step(H, b, cfg.damping, cfg.damping_abs,
                                  cfg.max_trans_step, cfg.max_rot_step)
            T_new = se3.exp(delta) @ T_new
        inl = lax.psum(stats.num_inliers, axis)
        sq = lax.psum(stats.weighted_sq_sum, axis)
        nv = lax.psum(stats.num_valid_src, axis)
        return _CarryState(
            T=T_new,
            it=state.it + inner,
            delta_sq=jnp.sum(delta * delta),
            rms=jnp.sqrt(sq / jnp.maximum(inl, 1.0)),
            inlier_fraction=inl / jnp.maximum(nv, 1.0),
            H=H,
            num_inliers=inl,
        )

    def cond(state: _CarryState):
        return (state.it < max_iters) & (state.delta_sq > tol ** 2)

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
        converged=out.delta_sq <= tol ** 2,
        H=out.H,
        num_inliers=out.num_inliers,
    )


def align_frames_spmd(src_pyr, dst_pyr, K: Intrinsics, T0: jnp.ndarray,
                      cfg: ICPConfig, mesh: Mesh,
                      axis: str = SHARD_AXIS) -> ICPResult:
    """Coarse-to-fine projective ICP with the source points sharded.

    Same semantics as `tpuslam.icp.align_frames` (padding rows are masked, so
    the psum-ed normal equations match the single-device reduction exactly).
    """
    n_dev = mesh.shape[axis]
    levels = len(src_pyr)
    T = T0
    result = None
    for li in range(levels - 1, -1, -1):
        dst_f: Frame = dst_pyr[li]
        K_l = K.scaled(1.0 / (2 ** li))
        # mirror the single-device per-level source decimation so the
        # SPMD reduction stays bit-comparable to tpuslam.icp.align_frames
        cloud = select_level_source(src_pyr, li, cfg)
        cloud = PointCloud(
            points=pad_to_multiple(cloud.points, n_dev),
            normals=pad_to_multiple(cloud.normals, n_dev),
            mask=pad_to_multiple(cloud.mask, n_dev, fill=False),
        )
        iters = (
            cfg.iters_per_level[li]
            if li < len(cfg.iters_per_level) else cfg.max_iters
        )
        ipl = getattr(cfg, "inner_steps_per_level", None)
        inner = ipl[li] if ipl is not None and li < len(ipl) else None
        tpl = getattr(cfg, "tol_delta_per_level", None)
        tol = tpl[li] if tpl is not None and li < len(tpl) else None

        cloud_specs = PointCloud(
            points=P(axis, None), normals=P(axis, None), mask=P(axis)
        )
        frame_specs = Frame(points=P(), normals=P(), mask=P())

        level_fn = shard_map(
            partial(_icp_level_spmd, cfg=cfg, max_iters=iters, axis=axis,
                    inner_steps=inner, tol_delta=tol),
            mesh=mesh,
            in_specs=(cloud_specs, frame_specs, P(), P()),
            out_specs=ICPResult(
                T=P(), iters=P(), rms=P(), inlier_fraction=P(),
                converged=P(), H=P(), num_inliers=P(),
            ),
            )
        result = level_fn(cloud, dst_f, K_l, T)
        T = result.T
    return result


def make_aligned_spmd_fn(mesh: Mesh, cfg: ICPConfig, axis: str = SHARD_AXIS):
    """jit-wrapped SPMD aligner with replicated-output shardings."""
    out_sharding = NamedSharding(mesh, P())

    @partial(jax.jit, out_shardings=out_sharding)
    def fn(src_pyr, dst_pyr, K, T0):
        return align_frames_spmd(src_pyr, dst_pyr, K, T0, cfg, mesh, axis)

    return fn
