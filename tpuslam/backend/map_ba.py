"""Schur-complement map bundle adjustment (SURVEY.md §2b N13, §2c CP/SP rows).

Reference status: none — the reference is a single-process pose-graph
prototype (SURVEY.md §2d).  The north-star demands it: "keyframes + map
voxel blocks partitioned over hosts; Schur-complement reduction" [B:5]
(SURVEY.md §3.3: "each host owns a keyframe shard, Schur-complement
reduction eliminates map/landmark blocks locally, reduced camera system
psum-ed and solved replicated").

Problem: jointly refine keyframe poses {T_i} and map control points {m_j}
against point-to-plane observations

    r_o = n_j · (T_i · p_o) − n_j · m_j − s_j ,

where p_o is a keyframe-cloud point matched to map point j and s_j is the
map point's offset along its own normal (m_j ← m_j + s_j n_j).  A surface
point is only observable along its normal, so giving each landmark exactly
that 1 DoF makes every landmark block a SCALAR a_j = Σ w — the Schur
complement needs no per-landmark matrix inverse at all:

    H_red = H_pp − Uᵀ diag(1/a) U ,   b_red = b_p − Uᵀ (c / a) ,

with U ∈ R^{M×6N} the pose-landmark coupling (u_j rows), c_j = Σ w r.
H_pp is block-diagonal (each observation touches ONE pose); all pose-pose
fill-in comes from the reduction — assembled as one (6N, M)·(M, 6N)
matmul.  Back-substitution: ds = (c + U δ) / a, applied to the
map points each Gauss-Newton round before re-linearizing.

Distribution (`optimize_map_ba_spmd`): landmarks and their observations are
partitioned over the mesh (map voxel blocks — the CP row of SURVEY §2c);
each device eliminates ITS landmark blocks locally, the reduced (6N, 6N)
pose systems are `psum`-ed together with the edge-sharded
pose-graph contribution, the pose solve is replicated (bit-identical
poses everywhere), and landmark back-substitution stays local.  One
all-reduce per GN round, no landmark data ever crosses devices.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax, shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpuslam.backend.posegraph import (
    PoseGraph,
    _info_vector,
    edge_normal_system,
)
from tpuslam.config import PoseGraphConfig
from tpuslam.dist.mesh import SHARD_AXIS
from tpuslam.geom import se3


class MapBAProblem(NamedTuple):
    """Fixed-capacity frame-to-map BA problem (a pytree; static shapes).

    Observations are the classic BA bipartite structure: each row couples
    one keyframe pose (obs_pose) with one map control point (obs_map).
    Invalid / padding rows carry obs_w = 0 and contribute nothing.
    """

    map_points: jnp.ndarray    # (M, 3) world-frame control points
    map_normals: jnp.ndarray   # (M, 3) unit normals (world frame)
    map_mask: jnp.ndarray      # (M,) bool
    obs_pose: jnp.ndarray      # (O,) int32 keyframe index
    obs_map: jnp.ndarray       # (O,) int32 map control-point index
    obs_p: jnp.ndarray         # (O, 3) observed point in KEYFRAME frame
    obs_w: jnp.ndarray         # (O,) float ≥ 0 (0 = unused slot)


def _huber_w(r: jnp.ndarray, delta: float) -> jnp.ndarray:
    ar = jnp.abs(r)
    return jnp.where(ar <= delta, 1.0, delta / jnp.maximum(ar, 1e-12))


def map_ba_partials(poses: jnp.ndarray, prob: MapBAProblem,
                    huber_delta: float):
    """Per-shard Schur ingredients from one observation set.

    Returns (H_pp (6N,6N) block-diag, b_p (6N,), U (M,6N), a (M,), c (M,),
    cost ()).  Exactly the quantities that sum across landmark shards.
    """
    N = poses.shape[0]
    M = prob.map_points.shape[0]
    T_i = poses[prob.obs_pose]                       # (O, 4, 4)
    x = jnp.einsum("oab,ob->oa", T_i[:, :3, :3], prob.obs_p) + T_i[:, :3, 3]
    n = prob.map_normals[prob.obs_map]               # (O, 3)
    m = prob.map_points[prob.obs_map]
    r = jnp.sum(n * (x - m), axis=-1)                # (O,)
    w = prob.obs_w * _huber_w(r, huber_delta)
    J = jnp.concatenate([n, jnp.cross(x, n)], axis=-1)   # (O, 6) [ρ, φ]
    wJ = J * w[:, None]

    # H_pp: block-diagonal per pose — segment-sum of w·J Jᵀ over obs_pose.
    blocks = jnp.zeros((N, 6, 6), dtype=poses.dtype)
    blocks = blocks.at[prob.obs_pose].add(
        jnp.einsum("oi,oj->oij", wJ, J, precision="highest"))
    H_pp = _embed_block_diag(blocks)
    b_p = jnp.zeros((N, 6), dtype=poses.dtype)
    b_p = b_p.at[prob.obs_pose].add(wJ * r[:, None]).reshape(6 * N)

    # Landmark scalars and pose-landmark coupling U[j, 6i:6i+6] = Σ w·J.
    a = jnp.zeros((M,), dtype=poses.dtype).at[prob.obs_map].add(w)
    c = jnp.zeros((M,), dtype=poses.dtype).at[prob.obs_map].add(w * r)
    flat = prob.obs_map * N + prob.obs_pose
    U = jnp.zeros((M * N, 6), dtype=poses.dtype).at[flat].add(wJ)
    U = U.reshape(M, 6 * N)
    cost = jnp.sum(w * r * r)
    return H_pp, b_p, U, a, c, cost


def _embed_block_diag(blocks: jnp.ndarray) -> jnp.ndarray:
    """(N, 6, 6) per-pose blocks → dense (6N, 6N) block-diagonal matrix."""
    N = blocks.shape[0]
    eye = jnp.eye(N, dtype=blocks.dtype)
    # out[i*6+k, i*6+l] = blocks[i, k, l]
    return (
        jnp.einsum("ij,ikl->ikjl", eye, blocks).reshape(6 * N, 6 * N)
    )


def schur_reduce(H_pp, b_p, U, a, c):
    """Eliminate the per-landmark scalar blocks (guard unobserved ones)."""
    inv_a = jnp.where(a > 1e-9, 1.0 / jnp.maximum(a, 1e-9), 0.0)
    H_red = H_pp - jnp.einsum(
        "mi,m,mj->ij", U, inv_a, U, precision="highest")
    b_red = b_p - U.T @ (inv_a * c)
    return H_red, b_red


def backsub_landmarks(delta_p: jnp.ndarray, U, a, c):
    """ds_j = (c_j + u_jᵀ δ) / a_j (zero where unobserved)."""
    inv_a = jnp.where(a > 1e-9, 1.0 / jnp.maximum(a, 1e-9), 0.0)
    return inv_a * (c + U @ delta_p)


def _solve_gauged(poses, node_mask, H, b, cfg: PoseGraphConfig):
    """Gauge prior on node 0 + LM damping; returns the twist step (N, 6)."""
    N = poses.shape[0]
    diag_scale = jnp.where(node_mask, 1.0, 1e6)
    prior = jnp.zeros((N,)).at[0].set(1e6) + cfg.damping + 1e-6
    prior = (prior * diag_scale).repeat(6)
    H = H + jnp.diag(prior + cfg.damping * jnp.abs(jnp.diagonal(H)))
    delta = -jnp.linalg.solve(H, b)
    ok = jnp.all(jnp.isfinite(delta))
    return jnp.where(ok, delta, 0.0)


@partial(jax.jit, static_argnames=("cfg",))
def optimize_map_ba(graph: PoseGraph, prob: MapBAProblem,
                    cfg: PoseGraphConfig, huber_delta: float = 0.05,
                    edge_huber_delta: float = 0.5):
    """Joint pose-graph + frame-to-map GN via Schur complement (one device).

    Returns (poses (N,4,4), map_points (M,3) refined, final cost ()).
    The pose-graph edges act as odometry/loop-closure priors; the map
    observations tie every keyframe to the shared surface.
    """
    info = _info_vector(cfg)

    def gn_round(_, carry):
        poses, map_pts, _cost = carry
        p = prob._replace(map_points=map_pts)
        H_pp, b_p, U, a, c, cost_map = map_ba_partials(poses, p, huber_delta)
        H_red, b_red = schur_reduce(H_pp, b_p, U, a, c)
        H_e, b_e, cost_e = edge_normal_system(
            poses, graph.edge_i, graph.edge_j, graph.edge_T,
            graph.edge_weight, info, edge_huber_delta)
        delta = _solve_gauged(poses, graph.node_mask,
                              H_red + H_e, b_red + b_e, cfg)
        new_poses = se3.exp(delta.reshape(-1, 6)) @ poses
        ds = backsub_landmarks(delta, U, a, c)
        new_map = map_pts + ds[:, None] * prob.map_normals
        return (new_poses, new_map, cost_map + cost_e)

    poses, map_pts, cost = lax.fori_loop(
        0, cfg.gn_iters, gn_round,
        (graph.poses, prob.map_points, jnp.inf))
    return poses, map_pts, cost


# ---------------------------------------------------------------------------
# Landmark-sharded SPMD variant (map voxel blocks partitioned over the mesh).
# ---------------------------------------------------------------------------


def _spmd_round_fn(graph_poses, node_mask, edge_i, edge_j, edge_T, edge_w,
                   map_pts, map_nrm, map_mask, obs_pose, obs_map_local,
                   obs_p, obs_w, cfg: PoseGraphConfig, huber_delta: float,
                   edge_huber_delta: float, axis: str):
    """Runs on one landmark shard + one edge shard inside shard_map."""
    info = _info_vector(cfg)

    def gn_round(_, carry):
        poses, mpts, _cost = carry
        p = MapBAProblem(
            map_points=mpts, map_normals=map_nrm, map_mask=map_mask,
            obs_pose=obs_pose, obs_map=obs_map_local, obs_p=obs_p,
            obs_w=obs_w)
        H_pp, b_p, U, a, c, cost_map = map_ba_partials(poses, p, huber_delta)
        # local landmark elimination, THEN the one all-reduce
        H_red, b_red = schur_reduce(H_pp, b_p, U, a, c)
        H_e, b_e, cost_e = edge_normal_system(
            poses, edge_i, edge_j, edge_T, edge_w, info, edge_huber_delta)
        H = lax.psum(H_red + H_e, axis)
        b = lax.psum(b_red + b_e, axis)
        cost = lax.psum(cost_map + cost_e, axis)
        delta = _solve_gauged(poses, node_mask, H, b, cfg)
        new_poses = se3.exp(delta.reshape(-1, 6)) @ poses
        # back-substitute OUR landmarks only — never leaves the device
        ds = backsub_landmarks(delta, U, a, c)
        new_map = mpts + ds[:, None] * map_nrm
        return (new_poses, new_map, cost)

    return lax.fori_loop(0, cfg.gn_iters, gn_round,
                         (graph_poses, map_pts, jnp.inf))


def partition_observations(prob: MapBAProblem, n_dev: int,
                           cap_factor: float = 1.5):
    """Host-side: bucket observations by landmark owner (contiguous M/D
    landmark ranges), pad buckets to a common static capacity.

    Returns (prob with reordered obs of shape (n_dev * cap, ...), M padded
    to a multiple of n_dev, obs_map rewritten to OWNER-LOCAL indices).
    Overflowing observations beyond the per-device cap are dropped
    (weight-0 rows are dropped first; logged by the caller if needed).
    """
    M = prob.map_points.shape[0]
    m_per = -(-M // n_dev)
    M_pad = m_per * n_dev
    mp = np.asarray(prob.map_points)
    mn = np.asarray(prob.map_normals)
    mm = np.asarray(prob.map_mask)
    if M_pad != M:
        pad = M_pad - M
        mp = np.concatenate([mp, np.zeros((pad, 3), mp.dtype)])
        mn = np.concatenate([mn, np.zeros((pad, 3), mn.dtype)])
        mm = np.concatenate([mm, np.zeros((pad,), bool)])

    obs_pose = np.asarray(prob.obs_pose)
    obs_map = np.asarray(prob.obs_map)
    obs_p = np.asarray(prob.obs_p)
    obs_w = np.asarray(prob.obs_w)
    live = obs_w > 0
    owner = obs_map // m_per
    O = obs_pose.shape[0]
    cap = int(np.ceil(O / n_dev * cap_factor))
    out_pose = np.zeros((n_dev, cap), np.int32)
    out_map = np.zeros((n_dev, cap), np.int32)
    out_p = np.zeros((n_dev, cap, 3), obs_p.dtype)
    out_w = np.zeros((n_dev, cap), obs_w.dtype)
    dropped = 0
    for d in range(n_dev):
        sel = np.nonzero(live & (owner == d))[0]
        if sel.shape[0] > cap:
            dropped += sel.shape[0] - cap
            sel = sel[:cap]
        k = sel.shape[0]
        out_pose[d, :k] = obs_pose[sel]
        out_map[d, :k] = obs_map[sel] - d * m_per   # owner-local index
        out_p[d, :k] = obs_p[sel]
        out_w[d, :k] = obs_w[sel]
    new_prob = MapBAProblem(
        map_points=jnp.asarray(mp), map_normals=jnp.asarray(mn),
        map_mask=jnp.asarray(mm),
        obs_pose=jnp.asarray(out_pose.reshape(-1)),
        obs_map=jnp.asarray(out_map.reshape(-1)),
        obs_p=jnp.asarray(out_p.reshape(-1, 3)),
        obs_w=jnp.asarray(out_w.reshape(-1)),
    )
    return new_prob, m_per, dropped


def optimize_map_ba_spmd(graph: PoseGraph, prob: MapBAProblem,
                         cfg: PoseGraphConfig, mesh: Mesh,
                         huber_delta: float = 0.05,
                         edge_huber_delta: float = 0.5,
                         axis: str = SHARD_AXIS):
    """Distributed drop-in for `optimize_map_ba`.

    Landmarks (map voxel blocks) + their observations are sharded over the
    mesh; pose-graph edges are edge-sharded with zero-weight padding (same
    scheme as optimize_pose_graph_spmd).  Exact: sums of shard partials
    equal the single-device sums (order-insensitive up to float rounding).
    """
    from tpuslam.dist.mesh import pad_to_multiple

    n_dev = mesh.shape[axis]
    sprob, m_per, _dropped = partition_observations(prob, n_dev)

    edge_i = pad_to_multiple(graph.edge_i, n_dev)
    edge_j = pad_to_multiple(graph.edge_j, n_dev)
    edge_T = pad_to_multiple(graph.edge_T, n_dev)
    pad = edge_T.shape[0] - graph.edge_T.shape[0]
    if pad:
        edge_T = edge_T.at[-pad:].set(jnp.eye(4, dtype=edge_T.dtype))
        edge_i = edge_i.at[-pad:].set(0)
        edge_j = edge_j.at[-pad:].set(0)
    edge_w = pad_to_multiple(graph.edge_weight, n_dev)

    fn = shard_map(
        partial(_spmd_round_fn, cfg=cfg, huber_delta=huber_delta,
                edge_huber_delta=edge_huber_delta, axis=axis),
        mesh=mesh,
        in_specs=(P(), P(), P(axis), P(axis), P(axis, None, None), P(axis),
                  P(axis, None), P(axis, None), P(axis),
                  P(axis), P(axis), P(axis, None), P(axis)),
        out_specs=(P(), P(axis, None), P()),
    )

    @partial(jax.jit,
             out_shardings=(NamedSharding(mesh, P()),
                            NamedSharding(mesh, P(axis, None)),
                            NamedSharding(mesh, P())))
    def run(*args):
        return fn(*args)

    poses, map_pts, cost = run(
        graph.poses, graph.node_mask, edge_i, edge_j, edge_T, edge_w,
        sprob.map_points, sprob.map_normals, sprob.map_mask,
        sprob.obs_pose, sprob.obs_map, sprob.obs_p, sprob.obs_w)
    return poses, map_pts[: prob.map_points.shape[0]], cost


# ---------------------------------------------------------------------------
# Problem construction from SLAM state (keyframe clouds + voxel map).
# ---------------------------------------------------------------------------


def build_map_ba_problem(kf_poses: jnp.ndarray, kf_points: jnp.ndarray,
                         kf_mask: jnp.ndarray, control_points: jnp.ndarray,
                         control_normals: jnp.ndarray,
                         control_mask: jnp.ndarray,
                         max_dist: float,
                         kf_ids: jnp.ndarray | None = None) -> MapBAProblem:
    """Associate every keyframe cloud point with its nearest map control
    point (grid-hash, tree-free) and emit fixed-capacity observations.

    The probe itself returns the match's position in the sorted control
    array (`Correspondence.idx`), so problem construction is O(C · probe) —
    no post-hoc index recovery.

    Args:
      kf_poses: (N, 4, 4) world←keyframe.
      kf_points: (N, C, 3) per-keyframe downsampled clouds (keyframe frame).
      kf_mask: (N, C) validity.
      control_*: (M, ...) map control points/normals in world frame.
      max_dist: association gate (m).
      kf_ids: optional (N,) int32 pose-graph node id of each keyframe row —
        pass when the rows are a SUBSET of the graph's nodes (keyframe
        sparsification drops stored clouds; their poses stay graph-
        constrained but contribute no map observations).  Default arange(N).
    """
    from tpuslam.geom.cloud import PointCloud
    from tpuslam.kernels.correspond import (
        build_grid_index, grid_hash_correspond, _INVALID_KEY)

    N, C, _ = kf_points.shape
    ctrl = PointCloud(points=control_points, normals=control_normals,
                      mask=control_mask)
    index = build_grid_index(ctrl, cell=float(max_dist))

    def per_kf(T, pts, mask):
        x = se3.transform_points(T, pts)
        return grid_hash_correspond(x, mask, index, max_dist)

    # Match each keyframe cloud against the control set; the probe carries
    # the sorted position through its 27-cell scan, so corr.idx IS the
    # control-point index.
    corr = jax.vmap(per_kf)(kf_poses, kf_points, kf_mask)
    idx = jnp.where(corr.w > 0, corr.idx, 0).astype(jnp.int32)

    if kf_ids is None:
        kf_ids = jnp.arange(N, dtype=jnp.int32)
    obs_pose = jnp.repeat(kf_ids.astype(jnp.int32), C)
    return MapBAProblem(
        map_points=index.points,
        map_normals=index.normals,
        map_mask=index.keys != _INVALID_KEY,
        obs_pose=obs_pose,
        obs_map=idx.reshape(-1),
        obs_p=kf_points.reshape(-1, 3),
        obs_w=corr.w.reshape(-1),
    )
