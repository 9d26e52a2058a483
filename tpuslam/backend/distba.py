"""Distributed pose-graph optimization (SURVEY.md §2b N13, §2c SP/CP rows).

Reference status: none — single process (SURVEY.md §2d).  The north-star
demands trajectory-dimension scaling: "keyframes + map voxel blocks
partitioned over hosts ... psum/all_gather collectives over ICI" [B:5].

Design: **edge-sharded** distributed GN.  The trajectory's edges (odometry +
loop closures) are partitioned over the mesh; every device assembles the
normal-system contribution of its edge shard with the *same* code as the
single-device backend (`edge_normal_system`), the (6N, 6N) partial systems
are `psum`-ed over the interconnect, and the reduced system is solved replicated — so
poses stay bit-identical on every device with one all-reduce per GN round.

This is the Schur-style reduction pattern specialized to a landmark-free
graph: with no map-point blocks to eliminate, the "reduced camera system"
IS the psum-ed pose system.  When map-block residuals are added (frame-to-
map BA), their block-diagonal landmark systems are eliminated locally per
shard before the same psum — the hook for that lives in the roadmap notes
(ROADMAP.md).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax, shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpuslam.backend.posegraph import (
    PoseGraph,
    _info_vector,
    edge_normal_system,
    solve_and_update,
)
from tpuslam.config import PoseGraphConfig
from tpuslam.dist.mesh import SHARD_AXIS, pad_to_multiple


def _spmd_optimize(poses, node_mask, edge_i, edge_j, edge_T, edge_w,
                   cfg: PoseGraphConfig, huber_delta: float, axis: str):
    """Runs on one edge shard inside shard_map; poses replicated."""
    info = _info_vector(cfg)

    def gn_round(_, carry):
        poses, _cost = carry
        H, b, cost = edge_normal_system(
            poses, edge_i, edge_j, edge_T, edge_w, info, huber_delta
        )
        H = lax.psum(H, axis)          # ← the all-reduce (SURVEY §2d)
        b = lax.psum(b, axis)
        cost = lax.psum(cost, axis)
        new_poses = solve_and_update(poses, node_mask, H, b, cfg)
        return (new_poses, cost)

    return lax.fori_loop(0, cfg.gn_iters, gn_round, (poses, jnp.inf))


def optimize_pose_graph_spmd(graph: PoseGraph, cfg: PoseGraphConfig,
                             mesh: Mesh, huber_delta: float = 0.5,
                             axis: str = SHARD_AXIS):
    """Distributed drop-in for `optimize_pose_graph`: same inputs/outputs,
    edges sharded over `mesh` (padded with zero-weight slots — exact)."""
    n_dev = mesh.shape[axis]
    edge_i = pad_to_multiple(graph.edge_i, n_dev)
    edge_j = pad_to_multiple(graph.edge_j, n_dev)
    edge_T = pad_to_multiple(
        graph.edge_T, n_dev
    )
    # padded edge_T rows are zero matrices — give them identity instead so
    # log() stays well-defined (their weight is 0, they contribute nothing)
    pad = edge_T.shape[0] - graph.edge_T.shape[0]
    if pad:
        edge_T = edge_T.at[-pad:].set(jnp.eye(4, dtype=edge_T.dtype))
        edge_i = edge_i.at[-pad:].set(0)
        edge_j = edge_j.at[-pad:].set(0)
    edge_w = pad_to_multiple(graph.edge_weight, n_dev)

    fn = shard_map(
        partial(_spmd_optimize, cfg=cfg, huber_delta=huber_delta, axis=axis),
        mesh=mesh,
        in_specs=(P(), P(), P(axis), P(axis), P(axis, None, None), P(axis)),
        out_specs=(P(), P()),
    )

    @partial(jax.jit, out_shardings=NamedSharding(mesh, P()))
    def run(poses, node_mask, ei, ej, eT, ew):
        return fn(poses, node_mask, ei, ej, eT, ew)

    return run(graph.poses, graph.node_mask, edge_i, edge_j, edge_T, edge_w)
