"""Ring-sharded frame-to-map ICP (SURVEY.md §2c "Ring attention" / CP rows).

Reference status: none — single-process CPU (SURVEY.md §2d).  The north-star
scaling dimension is *map size*: when the voxel map exceeds one device's
memory,
partition its points over the mesh and ring-pass shards between neighbors
so every device correlates its frame points against every map shard without
ever all-gathering the map ([B:5]).

Design: frame points AND map points are both sharded.  Each ICP iteration
runs D ring steps: correspond the local frame shard against the currently
held map shard (exact brute-force within the shard pair — each pair is
(N/D)×(M/D), small), min-merge into the running best, then `lax.ppermute`
the map shard to the ring neighbor.  After D steps every frame point has
seen the whole map; the GN reduction over frame shards completes with one
`psum`.  Results are bit-comparable to the unsharded exact-NN path (min and
sum are order-insensitive up to float rounding).

On a GPU mesh XLA hands each `ppermute` hop to NCCL.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
from jax import lax, shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpuslam.config import ICPConfig
from tpuslam.dist.mesh import SHARD_AXIS, pad_to_multiple
from tpuslam.geom import se3
from tpuslam.geom.cloud import PointCloud
from tpuslam.icp import ICPResult, _CarryState
from tpuslam.kernels.gn_reduce import gn_reduce, solve_gn_step


def _ring_best_correspond(x, x_mask, map_pts, map_nrm, map_mask,
                          max_dist: float, axis: str, n_dev: int):
    """Exact NN of local frame points over ALL map shards via ring passes."""

    def ring_step(_, carry):
        best_d2, best_q, best_n, mp, mn, mm = carry
        d2 = jnp.sum((x[:, None, :] - mp[None, :, :]) ** 2, axis=-1)
        d2 = jnp.where(mm[None, :], d2, jnp.inf)
        j = jnp.argmin(d2, axis=1)
        d_loc = jnp.take_along_axis(d2, j[:, None], axis=1)[:, 0]
        q_loc = mp[j]
        n_loc = mn[j]
        better = d_loc < best_d2
        best_d2 = jnp.where(better, d_loc, best_d2)
        best_q = jnp.where(better[:, None], q_loc, best_q)
        best_n = jnp.where(better[:, None], n_loc, best_n)
        perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]
        mp = lax.ppermute(mp, axis, perm)
        mn = lax.ppermute(mn, axis, perm)
        mm = lax.ppermute(mm, axis, perm)
        return best_d2, best_q, best_n, mp, mn, mm

    # carries must be typed as device-varying to match the post-ppermute
    # loop outputs under shard_map's varying-axes checking
    init = (
        lax.pcast(jnp.full(x.shape[:1], jnp.inf, dtype=x.dtype), (axis,),
                  to="varying"),
        jnp.zeros_like(x),
        jnp.zeros_like(x),
        map_pts, map_nrm, map_mask,
    )
    best_d2, best_q, best_n, *_ = lax.fori_loop(0, n_dev, ring_step, init)
    has_normal = jnp.sum(best_n * best_n, axis=-1) > 0.5
    valid = (
        x_mask & jnp.isfinite(best_d2) & (best_d2 < max_dist * max_dist)
        & has_normal
    )
    return best_q, best_n, valid.astype(x.dtype)


def _ring_icp(frame: PointCloud, map_shard: PointCloud, T0,
              cfg: ICPConfig, axis: str, n_dev: int) -> ICPResult:
    """Full ICP loop on one (frame shard, rotating map shard) pair."""

    # Same inner/outer split as tpuslam.icp._icp_loop — here the payoff is
    # even bigger: one "correspondence" costs a FULL D-step ring exchange of
    # the map shards, which now amortizes over `inner_steps` GN solves.
    inner = max(1, int(cfg.inner_steps))

    def body(state: _CarryState) -> _CarryState:
        x = se3.transform_points(state.T, frame.points)
        q, n, w = _ring_best_correspond(
            x, frame.mask, map_shard.points, map_shard.normals,
            map_shard.mask, cfg.max_corr_dist, axis, n_dev,
        )
        T_new = state.T
        for k in range(inner):
            if k > 0:
                x = se3.transform_points(T_new, frame.points)
            stats = gn_reduce(x, q, n, w, frame.mask, cfg.huber_delta)
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

    def cond(state):
        return (state.it < cfg.max_iters) & (state.delta_sq > cfg.tol_delta ** 2)

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
        T=out.T, iters=out.it, rms=out.rms,
        inlier_fraction=out.inlier_fraction,
        converged=out.delta_sq <= cfg.tol_delta ** 2,
        H=out.H,
        num_inliers=out.num_inliers,
    )


@lru_cache(maxsize=32)
def make_ring_align_fn(mesh: Mesh, cfg: ICPConfig, axis: str = SHARD_AXIS):
    """Build (once per mesh/cfg) the jitted ring-ICP callable.

    Rebuilding the shard_map closure per call would make every call a
    fresh jit cache entry — a silent recompile per tracked frame in the
    sharded-map production path.  The returned callable pads its inputs
    and runs the cached program; it ALSO returns the flat icp-scalar vector
    (layout: tpuslam.icp.FlatICP) so latency-sensitive hosts can read every
    gate in one transfer.
    """
    n_dev = mesh.shape[axis]
    specs = PointCloud(points=P(axis, None), normals=P(axis, None),
                       mask=P(axis))
    fn = shard_map(
        partial(_ring_icp, cfg=cfg, axis=axis, n_dev=n_dev),
        mesh=mesh,
        in_specs=(specs, specs, P()),
        out_specs=ICPResult(T=P(), iters=P(), rms=P(), inlier_fraction=P(),
                            converged=P(), H=P(), num_inliers=P()),
    )

    @partial(jax.jit, out_shardings=NamedSharding(mesh, P()))
    def run(f, m, T):
        from tpuslam.icp import flat_icp_scalars

        res = fn(f, m, T)
        return res, flat_icp_scalars(res)

    def padc(c: PointCloud) -> PointCloud:
        # padding rows carry mask=False, so they never match or reduce
        return PointCloud(
            points=pad_to_multiple(c.points, n_dev),
            normals=pad_to_multiple(c.normals, n_dev),
            mask=pad_to_multiple(c.mask, n_dev, fill=False),
        )

    def call(frame: PointCloud, map_cloud: PointCloud, T0):
        return run(padc(frame), padc(map_cloud), T0)

    return call


def align_to_map_ring(frame: PointCloud, map_cloud: PointCloud,
                      T0: jnp.ndarray, cfg: ICPConfig, mesh: Mesh,
                      axis: str = SHARD_AXIS) -> ICPResult:
    """Frame-to-map ICP with BOTH clouds sharded over the mesh.

    Frame points stay put; map shards ring-rotate each iteration — map memory
    footprint per device is M/D, yet correspondences are exact over the whole
    map within `max_corr_dist`."""
    res, _flat = make_ring_align_fn(mesh, cfg, axis)(
        frame, map_cloud, T0)
    return res
