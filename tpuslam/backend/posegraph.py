"""Pose-graph backend (SURVEY.md §2a R11, §2b N11, call stack §3.3).

Reference status: keyframe nodes + odometry/loop-closure edges, GN/LM over
relative-pose residuals (SURVEY.md §2a R11; provenance [B:5], [B:11]).

Design: padded graph (static capacity per compile, masked; the host
builder doubles capacity when full — see GraphHost),
per-edge residual r = log(T_meas⁻¹ · T_i⁻¹ · T_j) with Jacobians from
`jax.jacfwd` of the local-twist parametrization, **vmapped over all edges at
once** — no per-edge host loop.  The normal system is assembled as a dense
(6N, 6N) matrix via batched scatter-add and solved with Cholesky: at
prototype scale (N ≤ a few hundred) dense beats sparse bookkeeping.  Gauge freedom is fixed by a strong prior on node 0.  The whole
optimization (`gn_iters` Gauss-Newton rounds) is one jitted `fori_loop`.

The distributed variant (keyframe-sharded, psum-reduced) lives in
tpuslam/backend/distba.py (SURVEY.md §2b N13).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from tpuslam.config import PoseGraphConfig
from tpuslam.geom import se3


class PoseGraph(NamedTuple):
    """Fixed-capacity pose graph (a pytree; all shapes static)."""

    poses: jnp.ndarray       # (N, 4, 4) node poses (world←node)
    node_mask: jnp.ndarray   # (N,) bool
    edge_i: jnp.ndarray      # (E,) int32 source node
    edge_j: jnp.ndarray      # (E,) int32 target node
    edge_T: jnp.ndarray      # (E, 4, 4) measured T_i⁻¹·T_j
    edge_weight: jnp.ndarray  # (E,) float ≥ 0 (0 = unused slot)

    @classmethod
    def empty(cls, max_nodes: int, max_edges: int) -> "PoseGraph":
        return cls(
            poses=jnp.tile(jnp.eye(4), (max_nodes, 1, 1)),
            node_mask=jnp.zeros((max_nodes,), dtype=bool),
            edge_i=jnp.zeros((max_edges,), dtype=jnp.int32),
            edge_j=jnp.zeros((max_edges,), dtype=jnp.int32),
            edge_T=jnp.tile(jnp.eye(4), (max_edges, 1, 1)),
            edge_weight=jnp.zeros((max_edges,)),
        )


class GraphHost:
    """Host-side mutable builder around the fixed-capacity PoseGraph.

    Capacity is NOT a wall: `cfg.max_nodes`/`cfg.max_edges` are initial
    paddings and storage doubles when full (amortized O(1) per add).  The
    jitted solvers see the padded capacity as their static shape, so each
    doubling costs one recompile — log₂(N) compiles over an arbitrarily
    long trajectory, paid only when the graph actually grows past them.
    """

    def __init__(self, cfg: PoseGraphConfig):
        self.cfg = cfg
        self.num_nodes = 0
        self.num_edges = 0
        self.node_capacity = cfg.max_nodes
        self.edge_capacity = cfg.max_edges
        self._poses = np.tile(np.eye(4, dtype=np.float32),
                              (self.node_capacity, 1, 1))
        self._edge_i = np.zeros((self.edge_capacity,), dtype=np.int32)
        self._edge_j = np.zeros((self.edge_capacity,), dtype=np.int32)
        self._edge_T = np.tile(np.eye(4, dtype=np.float32),
                               (self.edge_capacity, 1, 1))
        self._edge_w = np.zeros((self.edge_capacity,), dtype=np.float32)

    @staticmethod
    def _grown(arr: np.ndarray, new_cap: int, eye: bool) -> np.ndarray:
        out_shape = (new_cap,) + arr.shape[1:]
        if eye:
            out = np.tile(np.eye(4, dtype=arr.dtype), (new_cap, 1, 1))
        else:
            out = np.zeros(out_shape, dtype=arr.dtype)
        out[: arr.shape[0]] = arr
        return out

    def ensure_capacity(self, nodes: int | None = None,
                        edges: int | None = None) -> None:
        """Grow storage (pow-2 doubling) to hold ≥ `nodes`/`edges` entries."""
        if nodes is not None and nodes > self.node_capacity:
            cap = self.node_capacity
            while cap < nodes:
                cap *= 2
            self._poses = self._grown(self._poses, cap, eye=True)
            self.node_capacity = cap
        if edges is not None and edges > self.edge_capacity:
            cap = self.edge_capacity
            while cap < edges:
                cap *= 2
            self._edge_i = self._grown(self._edge_i, cap, eye=False)
            self._edge_j = self._grown(self._edge_j, cap, eye=False)
            self._edge_T = self._grown(self._edge_T, cap, eye=True)
            self._edge_w = self._grown(self._edge_w, cap, eye=False)
            self.edge_capacity = cap

    def add_node(self, T_world: np.ndarray) -> int:
        self.ensure_capacity(nodes=self.num_nodes + 1)
        self._poses[self.num_nodes] = T_world
        self.num_nodes += 1
        return self.num_nodes - 1

    def add_edge(self, i: int, j: int, T_ij: np.ndarray,
                 weight: float = 1.0) -> None:
        self.ensure_capacity(edges=self.num_edges + 1)
        e = self.num_edges
        self._edge_i[e] = i
        self._edge_j[e] = j
        self._edge_T[e] = T_ij
        self._edge_w[e] = weight
        self.num_edges += 1

    @staticmethod
    def _bucket(n: int, floor: int, cap: int) -> int:
        """Smallest power of two ≥ max(n, floor), clamped to `cap`."""
        b = floor
        while b < n:
            b *= 2
        return min(b, cap)

    def graph(self, bucketed: bool = False) -> PoseGraph:
        """Snapshot as a fixed-capacity PoseGraph.

        `bucketed=True` slices the padded storage down to the smallest
        power-of-two bucket holding the LIVE node/edge counts before the
        device sees it: a 260-live-node graph whose storage doubled to 512
        slots dispatches at 512 (pow2 of 260), but a 100-live-node graph in
        the same storage dispatches at 128 — the solver cost tracks the
        trajectory, not its high-water mark, while shapes stay static per
        bucket (log₂ distinct compiles, same as capacity doubling).
        """
        n_cap, e_cap = self.node_capacity, self.edge_capacity
        if bucketed:
            n_cap = self._bucket(self.num_nodes, 32, n_cap)
            e_cap = self._bucket(self.num_edges, 64, e_cap)
        mask = np.zeros((n_cap,), dtype=bool)
        mask[: self.num_nodes] = True
        return PoseGraph(
            poses=jnp.asarray(self._poses[:n_cap]),
            node_mask=jnp.asarray(mask),
            edge_i=jnp.asarray(self._edge_i[:e_cap]),
            edge_j=jnp.asarray(self._edge_j[:e_cap]),
            edge_T=jnp.asarray(self._edge_T[:e_cap]),
            edge_weight=jnp.asarray(self._edge_w[:e_cap]),
        )

    def set_poses(self, poses: np.ndarray) -> None:
        self._poses[: self.num_nodes] = poses[: self.num_nodes]


def edge_residual(T_i, T_j, T_meas):
    """r = log(T_meas⁻¹ · T_i⁻¹ · T_j) ∈ R⁶ (zero when consistent)."""
    return se3.log(se3.inv(T_meas) @ se3.inv(T_i) @ T_j)


def _edge_residual_jacobians(T_i, T_j, T_meas):
    """Residual + Jacobians w.r.t. left-twist updates of nodes i and j."""

    def r_of(delta_i, delta_j):
        return edge_residual(
            se3.exp(delta_i) @ T_i, se3.exp(delta_j) @ T_j, T_meas
        )

    z = jnp.zeros(6, dtype=T_i.dtype)
    r = r_of(z, z)
    Ji = jax.jacfwd(r_of, argnums=0)(z, z)   # (6, 6)
    Jj = jax.jacfwd(r_of, argnums=1)(z, z)   # (6, 6)
    return r, Ji, Jj


def _huber_scale(r_norm_sq: jnp.ndarray, delta: float) -> jnp.ndarray:
    r_norm = jnp.sqrt(jnp.maximum(r_norm_sq, 1e-18))
    return jnp.where(r_norm <= delta, 1.0, delta / r_norm)


def _info_vector(cfg: PoseGraphConfig) -> jnp.ndarray:
    return jnp.concatenate(
        [jnp.full((3,), cfg.trans_weight), jnp.full((3,), cfg.rot_weight)]
    )


def edge_normal_system(poses, edge_i, edge_j, edge_T, edge_weight,
                       info, huber_delta: float):
    """Assemble the (6N, 6N) GN normal system contribution of a set of edges.

    Shared by the single-device solver and the edge-sharded distributed one
    (tpuslam/backend/distba.py) — in the latter each device calls this on its
    edge shard and the outputs are psum-ed (SURVEY.md §3.3).
    Returns (H (6N, 6N), b (6N,), cost ()).
    """
    N = poses.shape[0]
    Hii, Hjj, Hij, bi, bj, cost = edge_blocks(
        poses, edge_i, edge_j, edge_T, edge_weight, info, huber_delta)

    Hb = jnp.zeros((N, N, 6, 6), dtype=poses.dtype)
    Hb = Hb.at[edge_i, edge_i].add(Hii)
    Hb = Hb.at[edge_j, edge_j].add(Hjj)
    Hb = Hb.at[edge_i, edge_j].add(Hij)
    Hb = Hb.at[edge_j, edge_i].add(jnp.swapaxes(Hij, -1, -2))
    b = jnp.zeros((N, 6), dtype=poses.dtype)
    b = b.at[edge_i].add(bi)
    b = b.at[edge_j].add(bj)

    H = jnp.transpose(Hb, (0, 2, 1, 3)).reshape(6 * N, 6 * N)
    return H, b.reshape(6 * N), cost


def solve_and_update(poses, node_mask, H, b, cfg: PoseGraphConfig):
    """Apply gauge prior + damping, solve, and left-update all poses."""
    N = poses.shape[0]
    diag_scale = jnp.where(node_mask, 1.0, 1e6)
    prior = jnp.zeros((N,)).at[0].set(1e6) + cfg.damping + 1e-6
    prior = (prior * diag_scale).repeat(6)
    H = H + jnp.diag(prior + cfg.damping * jnp.abs(jnp.diagonal(H)))
    delta = -jnp.linalg.solve(H, b).reshape(N, 6)
    ok = jnp.all(jnp.isfinite(delta))
    delta = jnp.where(ok, delta, 0.0)
    return se3.exp(delta) @ poses


def edge_blocks(poses, edge_i, edge_j, edge_T, edge_weight, info,
                huber_delta: float):
    """Per-edge GN blocks WITHOUT assembling the dense (6N, 6N) system.

    Returns (Hii, Hjj, Hij (E, 6, 6), bi, bj (E, 6), cost ()) — the
    block-sparse representation consumed by the matrix-free CG solver."""
    T_i = poses[edge_i]
    T_j = poses[edge_j]
    r, Ji, Jj = jax.vmap(_edge_residual_jacobians)(T_i, T_j, edge_T)
    wr2 = jnp.einsum("ek,k,ek->e", r, info, r)
    w = edge_weight * _huber_scale(wr2, huber_delta)
    Wi = Ji * (w[:, None, None] * info[None, :, None])
    Wj = Jj * (w[:, None, None] * info[None, :, None])
    Hii = jnp.einsum("eki,ekj->eij", Wi, Ji)
    Hjj = jnp.einsum("eki,ekj->eij", Wj, Jj)
    Hij = jnp.einsum("eki,ekj->eij", Wi, Jj)
    bi = jnp.einsum("eki,ek->ei", Wi, r)
    bj = jnp.einsum("eki,ek->ei", Wj, r)
    return Hii, Hjj, Hij, bi, bj, jnp.sum(w * wr2)


def _solve_update_cg(poses, node_mask, blocks, b, cfg: PoseGraphConfig,
                     cg_iters: int, cg_tol: float):
    """One GN step via block-Jacobi-preconditioned conjugate gradient.

    The dense path materializes (6N)² floats and pays an O(N³) Cholesky —
    fine for N ≤ a few hundred, hopeless at production trajectory scale.
    Here H is only ever applied: Hx costs O(E) batched 6×6 matmuls + two
    scatter-adds, and the preconditioner is the inverted (N, 6, 6) block
    diagonal (batched).  Same gauge prior + damping as the
    dense path, so both solve the identical regularized system.
    """
    Hii, Hjj, Hij, edge_i, edge_j = blocks
    N = poses.shape[0]

    # block diagonal (incl. gauge prior + damping), as the dense path
    D = jnp.zeros((N, 6, 6), dtype=poses.dtype)
    D = D.at[edge_i].add(Hii)
    D = D.at[edge_j].add(Hjj)
    diag_scale = jnp.where(node_mask, 1.0, 1e6)
    prior = jnp.zeros((N,)).at[0].set(1e6) + cfg.damping + 1e-6
    prior = prior * diag_scale
    dvec = jnp.abs(jnp.diagonal(D, axis1=-2, axis2=-1))      # (N, 6)
    reg = prior[:, None] + cfg.damping * dvec
    D = D + jax.vmap(jnp.diag)(reg)

    def apply_H(x):                                           # x: (N, 6)
        y = reg * x                                           # regularizer
        xi = x[edge_i]
        xj = x[edge_j]
        y = y.at[edge_i].add(
            jnp.einsum("eij,ej->ei", Hii, xi)
            + jnp.einsum("eij,ej->ei", Hij, xj))
        y = y.at[edge_j].add(
            jnp.einsum("eij,ej->ei", Hjj, xj)
            + jnp.einsum("eji,ej->ei", Hij, xi))
        return y

    M_inv = jnp.linalg.inv(D)                                 # (N, 6, 6)

    def precond(x):
        return jnp.einsum("nij,nj->ni", M_inv, x)

    b2 = -b
    x = jnp.zeros_like(b2)
    r = b2
    z = precond(r)
    p = z
    rz = jnp.sum(r * z)
    b_norm = jnp.maximum(jnp.sum(b2 * b2), 1e-30)

    def cond(carry):
        _x, r, _p, _rz, it = carry
        return (it < cg_iters) & (jnp.sum(r * r) > cg_tol ** 2 * b_norm)

    def body(carry):
        x, r, p, rz, it = carry
        Hp = apply_H(p)
        alpha = rz / jnp.maximum(jnp.sum(p * Hp), 1e-30)
        x = x + alpha * p
        r = r - alpha * Hp
        z = precond(r)
        rz_new = jnp.sum(r * z)
        p = z + (rz_new / jnp.maximum(rz, 1e-30)) * p
        return x, r, p, rz_new, it + 1

    x, *_ = jax.lax.while_loop(cond, body,
                               (x, r, p, rz, jnp.zeros((), jnp.int32)))
    ok = jnp.all(jnp.isfinite(x))
    delta = jnp.where(ok, x, 0.0)
    return se3.exp(delta) @ poses


@partial(jax.jit, static_argnames=("cfg", "cg_iters"))
def optimize_pose_graph_cg(graph: PoseGraph, cfg: PoseGraphConfig,
                           huber_delta: float = 0.5,
                           cg_iters: int = 128, cg_tol: float = 1e-6):
    """Gauss-Newton with the matrix-free block-CG inner solver.

    Scales to trajectories far beyond the dense solver's N ≤ few hundred
    (O(E) per CG iteration, no (6N)² materialization); agrees with
    `optimize_pose_graph` to CG tolerance on the same graph."""
    info = _info_vector(cfg)

    def gn_round(_, carry):
        poses, _cost = carry
        with jax.named_scope("posegraph.gn_round_cg"):
            Hii, Hjj, Hij, bi, bj, cost = edge_blocks(
                poses, graph.edge_i, graph.edge_j, graph.edge_T,
                graph.edge_weight, info, huber_delta)
            N = poses.shape[0]
            b = jnp.zeros((N, 6), dtype=poses.dtype)
            b = b.at[graph.edge_i].add(bi)
            b = b.at[graph.edge_j].add(bj)
            new_poses = _solve_update_cg(
                poses, graph.node_mask,
                (Hii, Hjj, Hij, graph.edge_i, graph.edge_j), b, cfg,
                cg_iters, cg_tol)
        return (new_poses, cost)

    poses, cost = jax.lax.fori_loop(
        0, cfg.gn_iters, gn_round, (graph.poses, jnp.inf)
    )
    return poses, cost


@partial(jax.jit, static_argnames=("cfg",))
def optimize_pose_graph(graph: PoseGraph, cfg: PoseGraphConfig,
                        huber_delta: float = 0.5):
    """Gauss-Newton over all node poses; returns (poses, final_cost).

    Node 0 is gauge-fixed with a strong prior.  Edge weights scale a
    diagonal information matrix diag(trans_weight·I₃, rot_weight·I₃); a
    Huber factor on the whole-edge residual norm robustifies bad loop
    closures.
    """
    info = _info_vector(cfg)

    def gn_round(_, carry):
        poses, _cost = carry
        with jax.named_scope("posegraph.gn_round"):
            H, b, cost = edge_normal_system(
                poses, graph.edge_i, graph.edge_j, graph.edge_T,
                graph.edge_weight, info, huber_delta,
            )
            new_poses = solve_and_update(poses, graph.node_mask, H, b, cfg)
        return (new_poses, cost)

    poses, cost = jax.lax.fori_loop(
        0, cfg.gn_iters, gn_round, (graph.poses, jnp.inf)
    )
    return poses, cost


def resolve_solver(cfg: PoseGraphConfig, live_nodes: int | None = None,
                   capacity: int | None = None) -> str:
    """The "auto" solver decision as a host-side predicate (shared by
    `optimize` and callers that bake the choice into a fused jit as a
    static arg — e.g. loopclosure.fused_attempt_jit)."""
    solver = getattr(cfg, "solver", "auto")
    if solver == "auto":
        n = live_nodes if live_nodes is not None else capacity
        solver = ("dense" if n <= getattr(cfg, "dense_max_nodes", 256)
                  else "cg")
    return solver


def optimize(graph: PoseGraph, cfg: PoseGraphConfig,
             huber_delta: float = 0.5, live_nodes: int | None = None):
    """Solver-dispatching entry point: cfg.solver ∈ {"auto", "dense", "cg"}.

    "auto" picks dense Cholesky while the node count is ≤
    cfg.dense_max_nodes and the matrix-free block-CG solver beyond — the
    (6N)² materialization + O(N³) factorization stop paying for themselves
    around a few hundred nodes.  Pass `live_nodes` (the host-known live
    count) so the switch tracks the actual trajectory rather than the
    padded capacity; pair with `GraphHost.graph(bucketed=True)` so the
    dense solve also DISPATCHES at the live bucket, not the high-water
    capacity."""
    solver = resolve_solver(cfg, live_nodes, capacity=graph.poses.shape[0])
    if solver == "cg":
        return optimize_pose_graph_cg(
            graph, cfg, huber_delta,
            cg_iters=int(getattr(cfg, "cg_iters", 128)),
            cg_tol=float(getattr(cfg, "cg_tol", 1e-6)))
    return optimize_pose_graph(graph, cfg, huber_delta)


def graph_cost(graph: PoseGraph, cfg: PoseGraphConfig) -> jnp.ndarray:
    """Unweighted total squared residual (diagnostics)."""
    T_i = graph.poses[graph.edge_i]
    T_j = graph.poses[graph.edge_j]
    r = jax.vmap(edge_residual)(T_i, T_j, graph.edge_T)
    return jnp.sum(graph.edge_weight * jnp.sum(r * r, axis=-1))
