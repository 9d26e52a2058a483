"""Full SLAM orchestration: odometry + keyframe graph + loop closure
(SURVEY.md §3.1 call stack; BASELINE.json config 5).

Reference status: `main()` over a sequence — track, promote keyframes,
attempt loop closures, optimize the pose graph, dump trajectory
(SURVEY.md §2a R14; provenance [B:5]).

Host-driven control loop (the only host logic in the system — everything
compute-heavy underneath is jitted): per frame, one `track_step` call; per
promoted keyframe, graph bookkeeping + a bounded loop-closure
propose/verify pass + a pose-graph GN solve.  The final trajectory
re-anchors every frame on its (optimized) keyframe pose.
"""

from __future__ import annotations

import queue
import threading
from functools import partial
from typing import NamedTuple, Optional

import jax
import numpy as np

from tpuslam.backend.posegraph import GraphHost, optimize
from tpuslam.config import Intrinsics, SLAMConfig
from tpuslam.frontend import Odometry
from tpuslam.mapping import VoxelMap

# Information weight of verified loop-closure / relocalization edges
# relative to odometry edges (1.0).  Used in THREE places that must agree
# or the fused device-side solve silently diverges from later host
# re-solves: the fused optimize's candidate weights
# (_attempt_loop_closure), accepted-closure add_edge, and reloc add_edge.
LC_EDGE_WEIGHT = 2.0


@partial(jax.jit, static_argnames=("cfg",))
def _refine_projective_jit(map_cloud, frame, K, T0, cfg):
    from tpuslam.icp import align_map_to_frame, flat_icp_scalars

    return flat_icp_scalars(align_map_to_frame(map_cloud, frame, K, T0, cfg))


@partial(jax.jit, static_argnames=("cfg",))
def _refine_grid_jit(cloud, index, T0, cfg):
    from tpuslam.icp import align_to_index, flat_icp_scalars

    return flat_icp_scalars(align_to_index(cloud, index, T0, cfg))


class PendingAttempt(NamedTuple):
    """A dispatched-but-unsynced fused loop-closure attempt (the deferred
    backend: rows+poses stay on device until the next chunk boundary)."""

    live: list                  # (i, j, T_init) candidate triples
    attempted: set              # all attempted pairs
    packed: object              # device handle: flat rows ++ poses
    rows_shape: tuple
    poses_shape: tuple
    live_nodes: int             # graph live count at dispatch

    @property
    def size(self) -> int:
        import math

        return (math.prod(self.rows_shape) + math.prod(self.poses_shape))


class SlamSystem:
    """Odometry frontend + pose-graph backend with loop closure."""

    def __init__(self, K: Intrinsics, cfg: SLAMConfig,
                 enable_loop_closure: bool = True,
                 enable_map: bool = False,
                 track_against_map: bool = False,
                 async_backend: bool = False,
                 map_ba: bool = False,
                 map_track_mode: str = "projective",
                 sharded_map: bool = False,
                 mesh_devices: Optional[int] = None,
                 enable_relocalization: bool = True,
                 reloc_after: int = 2,
                 chunk_mode: str = "inline",
                 chunk_sub: int = 8):
        self.cfg = cfg
        self.odo = Odometry(K, cfg, keep_keyframe_clouds=True)
        self.graph = GraphHost(cfg.posegraph)
        self.enable_loop_closure = enable_loop_closure
        self.map_ba = map_ba
        self.map_ba_stats: Optional[dict] = None
        enable_map = enable_map or track_against_map or map_ba
        self.sharded_map = sharded_map
        if enable_map and sharded_map:
            # Mesh-sharded map: fusion via all-to-all owner routing
            # (dist/map_fusion.py), frame-to-map refinement via the ring
            # (dist/ring_map.py) — the map never lives on one device.
            from tpuslam.dist.map_fusion import ShardedVoxelMap
            from tpuslam.dist.mesh import make_mesh

            self._map_mesh = make_mesh(mesh_devices)
            self.map = ShardedVoxelMap(
                cfg.voxel, self._map_mesh, new_capacity=cfg.voxel.capacity)
        elif enable_map:
            self.map = VoxelMap(cfg.voxel)
        else:
            self.map = None
        self.track_against_map = track_against_map
        if map_track_mode not in ("projective", "grid"):
            raise ValueError(f"map_track_mode must be 'projective' or 'grid',"
                             f" got {map_track_mode!r}")
        # "projective" = reverse projective association (map points gathered
        # against the current frame's packed table — one row gather per map
        # point, no index build; tpuslam/icp.py:align_map_to_frame).
        # "grid" = legacy grid-hash probe against a sorted map index.
        self.map_track_mode = map_track_mode
        self._map_index = None
        self._known_edges: set[tuple[int, int]] = set()
        # Pairs that FAILED ICP verification: skipped until the next graph
        # optimization (keyframe clouds are immutable, so only a moved
        # initial guess can change a pair's verdict) — without this memory
        # every promotion re-pays up to max_candidates full ICP alignments
        # on the same hopeless pairs for the rest of the run.
        self._failed_pairs: set[tuple[int, int]] = set()
        self._num_graph_nodes = 0
        self.closures: list = []
        # Relocalization (backend/relocalize.py): after `reloc_after`
        # consecutive lost frames, re-anchor the current frame on the
        # nearest stored keyframe; the new keyframe joins the graph with a
        # verified reloc edge INSTEAD of a (bogus) odometry edge across the
        # loss gap.
        self.enable_relocalization = enable_relocalization
        self.reloc_after = reloc_after
        # exponential backoff on FAILED attempts: each costs up to
        # max_candidates × 2 full ICP alignments, which would otherwise be
        # paid on every frame while the camera stares at unmapped space
        self._reloc_backoff = reloc_after
        self._lost_streak = 0
        self._pending_reloc_edges: dict[int, tuple[int, np.ndarray]] = {}
        self.relocalizations: list = []
        self.map_refine_stats: list[dict] = []
        # Chunked-streaming promotion semantics (frontend.scan_chunk vs
        # scan_superchunk_frozen): "inline" carries the packed keyframe tables
        # through a per-frame lax.cond select (exact per-frame parity, but
        # a table copy per frame);
        # "boundary" tracks each chunk against a frozen keyframe and
        # promotes the sub-chunk's last frame at the boundary — no
        # table in the carry, and the scan output becomes pose-correction-
        # independent, which is what makes the deferred backend (below)
        # bit-deterministic.
        if chunk_mode not in ("inline", "boundary"):
            raise ValueError(f"chunk_mode must be 'inline' or 'boundary', "
                             f"got {chunk_mode!r}")
        self.chunk_mode = chunk_mode
        # Sub-chunk size = the keyframe-promotion cadence FLOOR of boundary
        # mode (a promotion takes effect at most once per `chunk_sub`
        # frames).  8 suits default thresholds; tight-promotion configs
        # (e.g. the config-5 scale settings, which promote every ~5
        # frames) must lower it — chunk_sub=1 reproduces the per-frame
        # promotion cadence exactly while keeping the one-sync-per-call
        # readback and the deferred backend.
        if chunk_sub < 1:
            raise ValueError("chunk_sub must be ≥ 1")
        self.chunk_sub = int(chunk_sub)
        # Deferred backend (boundary chunk mode + async_backend): the fused
        # verify+optimize attempt is DISPATCHED at the chunk boundary but
        # its readback rides the NEXT chunk's scan readback (one fused
        # host sync for both — frontend.fuse_readbacks_jit), draining
        # before that chunk's bookkeeping walk.  Deterministic (no worker
        # thread) and overlapped (the attempt executes while the host
        # walks/dispatches).
        self._pending_attempt: Optional[PendingAttempt] = None
        # PP analogue (SURVEY.md §2c "PP" row): the backend (loop-closure
        # verification + pose-graph GN) runs in a worker thread overlapped
        # with frontend tracking; corrected keyframe poses are applied at
        # the next frame boundary under a lock.
        self.async_backend = async_backend
        self._lock = threading.Lock()
        self._backend_queue: "queue.Queue[int]" = queue.Queue()
        self._backend_thread: Optional[threading.Thread] = None
        self._backend_error: Optional[BaseException] = None
        # In boundary chunk mode async means the DEFERRED pipeline (above),
        # not the worker thread: attempts stay on the main thread so the
        # closure set is bit-deterministic; per-frame stepping (bootstrap
        # chunks, remainders, lost replays) runs its attempts inline.
        if async_backend and chunk_mode == "inline":
            self._backend_thread = threading.Thread(
                target=self._backend_worker, daemon=True
            )
            self._backend_thread.start()

    def _backend_worker(self) -> None:
        while True:
            item = self._backend_queue.get()
            if item is None:
                return
            try:
                if self.enable_loop_closure:
                    # optimization is fused into the attempt (one sync)
                    self._attempt_loop_closure()
            except BaseException as e:  # surfaced on finalize()
                self._backend_error = e

    def finalize(self) -> None:
        """Drain the async backend and run a final global optimization."""
        self._drain_pending()
        if self._backend_thread is not None:
            self._backend_queue.put(None)
            self._backend_thread.join(timeout=120)
            self._backend_thread = None
            if self._backend_error is not None:
                raise self._backend_error
        if self.enable_loop_closure:
            self._attempt_loop_closure()
        if self.graph.num_edges > 0:
            self._optimize()
        if self.map_ba:
            self.refine_map_ba()

    def _sync_graph_with_keyframes(self) -> bool:
        """Add any newly promoted keyframes as nodes + odometry edges."""
        added = False
        while self._num_graph_nodes < len(self.odo.keyframes):
            k = self._num_graph_nodes
            rec = self.odo.keyframes[k]
            self.graph.add_node(rec.T_world_kf)
            if k in self._pending_reloc_edges:
                # keyframe born from relocalization: link it to its anchor
                # with the verified reloc pose — an odometry edge to k-1
                # would confidently encode the unobserved loss-gap motion
                anchor, T_ij = self._pending_reloc_edges.pop(k)
                self.graph.add_edge(anchor, k, T_ij, weight=LC_EDGE_WEIGHT)
                self._known_edges.add((anchor, k))
                self.odo.protect(anchor, k)
                self._bound_protected()
            elif k > 0:
                prev = self.odo.keyframes[k - 1]
                T_ij = np.linalg.inv(prev.T_world_kf.astype(np.float64)) @ (
                    rec.T_world_kf.astype(np.float64)
                )
                self.graph.add_edge(k - 1, k, T_ij, weight=1.0)
                self._known_edges.add((k - 1, k))
            self._num_graph_nodes += 1
            added = True
            if self.map is not None and rec.cloud is not None:
                self.map.insert(rec.cloud, rec.T_world_kf)
                self._map_index = None  # stale — rebuild lazily
        return added

    def _refine_against_map(self) -> None:
        """Frame-to-map refinement (BASELINE config 4): re-align the current
        keyframe-relative estimate against the accumulated voxel map.

        Every path reads its result as ONE flat scalar vector — the gates
        below would otherwise cost five separate device round trips per
        frame."""
        import jax.numpy as jnp

        kf_id, T_rel = self.odo.frame_refs[-1]
        rec = self.odo.keyframes[kf_id]
        if self.odo.last_pyr is None or self.map.num_insertions < 2:
            return
        T0 = jnp.asarray(
            rec.T_world_kf.astype(np.float32) @ T_rel.astype(np.float32)
        )
        if self.sharded_map:
            from tpuslam.dist.ring_map import make_ring_align_fn

            cloud = self.odo._kf_cloud(self.odo.last_pyr)  # current frame, cam
            _res, flat = make_ring_align_fn(self._map_mesh, self.cfg.icp)(
                cloud, self.map.cloud_shards, T0)
        elif self.map_track_mode == "projective":
            flat = _refine_projective_jit(
                self.map.cloud, self.odo.last_pyr[0], self.odo.K, T0,
                self.cfg.icp)
        else:
            if self._map_index is None:
                self._map_index = self.map.build_index(
                    cell=float(self.cfg.icp.max_corr_dist)
                )
            cloud = self.odo._kf_cloud(self.odo.last_pyr)  # current frame, cam
            flat = _refine_grid_jit(cloud, self._map_index, T0, self.cfg.icp)
        from tpuslam.icp import FlatICP

        s = np.asarray(flat)         # the one host sync
        T_est = s[FlatICP.T].reshape(4, 4)
        ok = (
            bool(s[FlatICP.CONVERGED] > 0.5)
            and float(s[FlatICP.INLIER_FRACTION]) > 0.3
            and float(s[FlatICP.NUM_INLIERS]) >= float(
                getattr(self.cfg, "map_refine_min_inliers", 300))
            and np.all(np.isfinite(T_est))
        )
        self.map_refine_stats.append(
            {"ok": ok, "rms": float(s[FlatICP.RMS]),
             "inliers": float(s[FlatICP.INLIER_FRACTION])}
        )
        if not ok:
            return
        T_world_cam = T_est.astype(np.float64)
        # push the correction into the frontend's keyframe-relative state
        T_rel_new = (
            np.linalg.inv(rec.T_world_kf.astype(np.float64)) @ T_world_cam
        )
        self.odo.frame_refs[-1] = (kf_id, T_rel_new)
        self.odo.T_kf_cam = jnp.asarray(T_rel_new.astype(np.float32))
        self.odo.trajectory[-1] = T_world_cam

    def _dispatch_closure_attempt(
            self, max_candidates: int = 4) -> Optional[PendingAttempt]:
        """Propose → verify → optimize, fused on device, WITHOUT syncing.

        The two-sync shape (read verification rows, decide, then optimize
        and read poses) pays two host syncs per attempt, each stalling
        the device.  Instead the pose-graph
        optimization is chained ON DEVICE onto the un-synced verification
        rows: candidate edges enter the solve with weight
        LC_EDGE_WEIGHT·accept — the device-side gate
        (backend.verify.passes_gates_traced) — so rejected candidates
        weigh zero, and verification rows + optimized poses come back in
        one flat readback (`_drain_closure_attempt`, or fused into the
        next chunk's scan readback by the deferred backend).  The host
        then mirrors the same gate decisions from the same f32 values and
        either applies the poses (some closure accepted — matching the
        old attempt-then-optimize semantics) or discards them.

        Returns None when nothing was verifiable (a dry pass costs zero
        device dispatches — proposal is host-side numpy).
        """
        import jax.numpy as jnp

        from tpuslam.backend.loopclosure import (
            fused_attempt_jit,
            propose_attempt,
        )
        from tpuslam.backend.posegraph import resolve_solver
        from tpuslam.backend.verify import ROW_SIZE

        # snapshot under the lock (async backend runs concurrently with
        # tracking); the expensive ICP verification runs outside it
        with self._lock:
            n = self._num_graph_nodes
            kf_poses = [
                self.graph._poses[k].astype(np.float64) for k in range(n)
            ]
            keyframes = list(self.odo.keyframes[:n])
            known = set(self._known_edges) | set(self._failed_pairs)
            g = self.graph.graph(bucketed=True)
            live_nodes = self.graph.num_nodes
        live, padded, attempted, v0 = propose_attempt(
            keyframes, kf_poses, self.cfg.icp, self.cfg.posegraph,
            exclude_pairs=known, K=self.odo.K,
            max_candidates=max_candidates,
        )
        if not live:
            with self._lock:
                self._failed_pairs.update(attempted)
            return None
        b = len(padded)
        cand_i = jnp.asarray([i for i, _, _ in live]
                             + [0] * (b - len(live)), dtype=g.edge_i.dtype)
        cand_j = jnp.asarray([j for _, j, _ in live]
                             + [0] * (b - len(live)), dtype=g.edge_j.dtype)
        T_inits = jnp.asarray(np.stack([T for _, _, T in padded]))
        use_dense = resolve_solver(self.cfg.posegraph, live_nodes,
                                   capacity=g.poses.shape[0]) == "dense"
        if v0 is not None:
            # production path: verification + gates + graph extension +
            # pose-graph solve + readback packing in ONE dispatch
            packed = fused_attempt_jit(
                tuple(keyframes[i].verify.packed for i, _, _ in padded),
                tuple(keyframes[j].cloud.points for _, j, _ in padded),
                tuple(keyframes[j].cloud.normals for _, j, _ in padded),
                tuple(keyframes[j].cloud.mask for _, j, _ in padded),
                self.odo.K.scaled(1.0 / (2 ** v0.level)), T_inits,
                jnp.int32(len(live)), g, cand_i, cand_j,
                v0.height, v0.width, self.cfg.icp, self.cfg.posegraph,
                use_dense, LC_EDGE_WEIGHT)
        else:
            # grid-hash fallback (records restored from pre-table
            # checkpoints): verify, then chain the same gate-weighted
            # solve eagerly — rare, so the extra dispatches don't matter
            packed = self._chain_attempt_fallback(
                keyframes, padded, live, T_inits, g, cand_i, cand_j,
                live_nodes)
        return PendingAttempt(
            live=live, attempted=attempted, packed=packed,
            rows_shape=(b, ROW_SIZE),
            poses_shape=tuple(g.poses.shape), live_nodes=live_nodes)

    def _chain_attempt_fallback(self, keyframes, padded, live, T_inits, g,
                                cand_i, cand_j, live_nodes):
        """Grid-hash attempt chain for records without verify tables."""
        import jax.numpy as jnp

        from tpuslam.backend.loopclosure import _verify_pairs_jit
        from tpuslam.backend.posegraph import optimize
        from tpuslam.backend.verify import passes_gates_traced
        from tpuslam.geom.cloud import PointCloud
        from tpuslam.icp import FlatICP

        def stack(field):
            return jnp.stack([getattr(keyframes[k].cloud, field)
                              for k, _, _ in padded])

        def stack_j(field):
            return jnp.stack([getattr(keyframes[k].cloud, field)
                              for _, k, _ in padded])

        clouds_i = PointCloud(points=stack("points"),
                              normals=stack("normals"), mask=stack("mask"))
        clouds_j = PointCloud(points=stack_j("points"),
                              normals=stack_j("normals"),
                              mask=stack_j("mask"))
        rows_dev = _verify_pairs_jit(clouds_i, clouds_j, T_inits,
                                     self.cfg.icp)
        b = rows_dev.shape[0]
        is_real = (jnp.arange(b) < len(live)).astype(rows_dev.dtype)
        accept = passes_gates_traced(rows_dev, self.cfg.posegraph) * is_real
        cand_T = rows_dev[:, FlatICP.T].reshape(b, 4, 4).astype(
            g.edge_T.dtype)
        finite_T = jnp.all(jnp.isfinite(cand_T), axis=(1, 2))
        cand_T = jnp.where(finite_T[:, None, None], cand_T,
                           jnp.eye(4, dtype=cand_T.dtype))
        g_ext = g._replace(
            edge_i=jnp.concatenate([g.edge_i, cand_i]),
            edge_j=jnp.concatenate([g.edge_j, cand_j]),
            edge_T=jnp.concatenate([g.edge_T, cand_T]),
            edge_weight=jnp.concatenate(
                [g.edge_weight, LC_EDGE_WEIGHT * accept]),
        )
        poses_opt, _cost = optimize(g_ext, self.cfg.posegraph,
                                    live_nodes=live_nodes)
        return jnp.concatenate([
            rows_dev.reshape(-1).astype(jnp.float32),
            poses_opt.reshape(-1).astype(jnp.float32),
        ])

    def _drain_closure_attempt(self, p: PendingAttempt,
                               flat: Optional[np.ndarray] = None) -> bool:
        """Sync (unless `flat` was already read back fused with another
        result) + gate + commit one dispatched attempt."""
        from tpuslam.backend.loopclosure import gate_rows

        import math

        if flat is None:
            flat = np.asarray(p.packed)            # the ONE sync
        rows_size = math.prod(p.rows_shape)
        s = flat[:rows_size].reshape(p.rows_shape)
        poses = flat[rows_size:].reshape(p.poses_shape)
        live, attempted, live_nodes = p.live, p.attempted, p.live_nodes
        closures = gate_rows(live, s, self.cfg.posegraph)
        with self._lock:
            accepted = {(c.i, c.j) for c in closures}
            self._failed_pairs.update(attempted - accepted)
            added = False
            for c in closures:
                if (c.i, c.j) in self._known_edges:
                    continue
                self.graph.add_edge(c.i, c.j, c.T_ij,
                                    weight=LC_EDGE_WEIGHT)
                self._known_edges.add((c.i, c.j))
                # closure anchors keep their clouds through sparsification —
                # a revisited place stays verifiable on the next pass
                self.odo.protect(c.i, c.j)
                self._bound_protected()
                self.closures.append(c)
                added = True
            if added:
                if self.graph.num_nodes == live_nodes:
                    # apply the fused optimization (same system the old
                    # two-step solved: accepted edges at weight 2,
                    # rejected 0) and re-anchor the frontend exactly as
                    # _optimize does — keyframe records and the live
                    # tracking origin must see closure corrections
                    # immediately, not at finalize (relocalization seeds
                    # from record poses)
                    poses = poses.astype(np.float32)
                    self.graph.set_poses(poses)
                    self._failed_pairs.clear()
                    k = self._num_graph_nodes - 1
                    self.odo.T_world_kf = poses[k]
                    for idx in range(self._num_graph_nodes):
                        rec = self.odo.keyframes[idx]
                        self.odo.keyframes[idx] = rec._replace(
                            T_world_kf=poses[idx])
                else:
                    # async tracking grew the graph while the snapshot
                    # solve was in flight — the fused poses are stale
                    # (set_poses would overwrite new nodes or mismatch
                    # the bucket): re-solve on the current graph instead
                    self._optimize()
        return bool(closures)

    def _attempt_loop_closure(self) -> bool:
        """One fused propose → verify → optimize attempt, ONE host sync
        (dispatch + immediate drain — the synchronous shape)."""
        p = self._dispatch_closure_attempt()
        if p is None:
            return False
        return self._drain_closure_attempt(p)

    def _drain_pending(self) -> None:
        """Drain the deferred backend's outstanding attempt, if any (called
        before any path that must observe a sync-equivalent graph state:
        per-frame stepping, inline chunks, finalize, checkpointing)."""
        p, self._pending_attempt = self._pending_attempt, None
        if p is not None:
            self._drain_closure_attempt(p)

    def _bound_protected(self) -> None:
        """Cap the sparsification-protected anchor set so very long runs
        with many closures can't quietly unbound cloud memory: protection
        is a freshness heuristic (spatially diverse retention already keeps
        SOME verifiable cloud near every mapped place), so evict the LEAST
        RECENTLY RE-CONFIRMED anchors — every new closure on a place
        refreshes its anchors via Odometry.protect, so the most-revisited
        keyframes stay protected regardless of how old their ids are."""
        cap = max(4, int(self.cfg.keyframe.max_keyframes) // 2)
        prot = self.odo.protected_kf_ids
        if len(prot) > cap:
            keep = sorted(prot, key=prot.__getitem__)[-cap:]
            self.odo.protected_kf_ids = {k: prot[k] for k in keep}

    def _optimize(self) -> None:
        # bucketed view + live count: solver choice AND dispatch shape track
        # the live trajectory, not the storage high-water mark
        graph = self.graph.graph(bucketed=True)
        poses, _cost = optimize(graph, self.cfg.posegraph,
                                live_nodes=self.graph.num_nodes)
        poses = np.asarray(poses, dtype=np.float32)
        self.graph.set_poses(poses)
        # optimization moved the initial guesses — failed pairs may verify now
        self._failed_pairs.clear()
        # re-anchor the frontend on the corrected keyframe pose
        k = self._num_graph_nodes - 1
        self.odo.T_world_kf = poses[k]
        for idx in range(self._num_graph_nodes):
            rec = self.odo.keyframes[idx]
            self.odo.keyframes[idx] = rec._replace(T_world_kf=poses[idx])

    def refine_map_ba(self, max_control: int = 4096,
                      points_per_kf: int = 512) -> bool:
        """Global Schur-complement map BA over all keyframes (SURVEY §2b N13).

        Re-voxelizes the live map into ≤ `max_control` control points,
        associates a subsample of every keyframe cloud against them, and
        jointly refines keyframe poses + control-point normal offsets
        (tpuslam/backend/map_ba.py).  Corrected poses are written back into
        the graph and keyframe records; the dense map itself is left as the
        running fusion (it is a derived product of the keyframe poses).
        """
        import jax.numpy as jnp

        from tpuslam.backend.map_ba import (
            build_map_ba_problem, optimize_map_ba)
        from tpuslam.geom.voxel import voxel_downsample

        n = self._num_graph_nodes
        if self.map is None or n < 2 or self.map.num_insertions < 2:
            return False
        map_cloud = (self.map.gather() if self.sharded_map
                     else self.map.cloud)
        ctrl = voxel_downsample(
            map_cloud, 2.0 * self.cfg.voxel.map_voxel_size, max_control,
            origin=self.cfg.voxel.origin, extent=self.cfg.voxel.extent,
        )
        # Keyframes whose clouds were sparsified away contribute no map
        # observations — their poses stay constrained by the graph edges.
        kf_points, kf_mask, kf_poses, kf_ids = [], [], [], []
        for kid, rec in enumerate(self.odo.keyframes[:n]):
            if rec.cloud is None:
                continue
            stride = max(1, rec.cloud.points.shape[0] // points_per_kf)
            kf_points.append(rec.cloud.points[::stride][:points_per_kf])
            kf_mask.append(rec.cloud.mask[::stride][:points_per_kf])
            kf_poses.append(rec.T_world_kf.astype(np.float32))
            kf_ids.append(kid)
        if len(kf_ids) < 2:
            return False
        prob = build_map_ba_problem(
            jnp.asarray(np.stack(kf_poses)),
            jnp.stack(kf_points), jnp.stack(kf_mask),
            ctrl.points, ctrl.normals, ctrl.mask,
            max_dist=float(self.cfg.icp.max_corr_dist),
            kf_ids=jnp.asarray(np.asarray(kf_ids, dtype=np.int32)),
        )
        poses, _map_pts, cost = optimize_map_ba(
            self.graph.graph(bucketed=True), prob, self.cfg.posegraph,
            huber_delta=self.cfg.icp.huber_delta,
        )
        poses = np.asarray(poses, dtype=np.float32)
        if not np.all(np.isfinite(poses)):
            return False
        self.map_ba_stats = {
            "cost": float(cost),
            "num_obs": int(float(np.asarray(prob.obs_w).sum())),
            "num_control": int(np.asarray(ctrl.mask).sum()),
        }
        with self._lock:
            self.graph.set_poses(poses)
            # BA moved every initial guess — failed closure pairs may
            # verify now (same invariant as _optimize)
            self._failed_pairs.clear()
            self.odo.T_world_kf = poses[n - 1]
            for idx in range(n):
                rec = self.odo.keyframes[idx]
                self.odo.keyframes[idx] = rec._replace(T_world_kf=poses[idx])
        return True

    def _attempt_relocalization(self) -> Optional[bool]:
        """Re-anchor the current (lost) frame on a stored keyframe.

        Called under self._lock.  On success the current frame is promoted
        to a keyframe at the verified pose and queued to join the graph via
        a reloc edge to its anchor (see _sync_graph_with_keyframes).

        Returns True on success, False on a genuine failed attempt (counts
        toward the retry backoff), None when the frame itself has too few
        valid points to verify anything (occlusion/garbage — skip cheaply
        and retry as soon as real data arrives)."""
        import jax.numpy as jnp

        from tpuslam.backend.relocalize import relocalize

        odo = self.odo
        if odo.last_pyr is None or not odo.keyframes:
            return None
        frame_cloud = odo._kf_cloud(odo.last_pyr)
        if int(frame_cloud.count()) < 100:
            return None
        kf_id, T_rel = odo.frame_refs[-1]
        T_last = odo.keyframes[kf_id].T_world_kf.astype(np.float64) @ T_rel
        r = relocalize(frame_cloud, odo.keyframes, T_last,
                       self.cfg.icp, self.cfg.posegraph, K=odo.K)
        if r is None:
            return False
        anchor = odo.keyframes[r.kf_id]
        T_world_cam = anchor.T_world_kf.astype(np.float64) @ r.T_kf_cam
        odo.T_world_kf = T_world_cam.astype(np.float32)
        odo.T_kf_cam = jnp.eye(4)
        odo.last_delta = jnp.eye(4)   # stale velocity caused/was lost with it
        odo._promote(odo.last_pyr, odo.timestamps[-1])
        # _promote stamps index=frame_idx, which already advanced past the
        # frame being relocalized
        odo.keyframes[-1] = odo.keyframes[-1]._replace(index=odo.frame_idx - 1)
        new_id = len(odo.keyframes) - 1
        odo.frame_refs[-1] = (new_id, np.eye(4))
        odo.trajectory[-1] = T_world_cam
        odo.stats[-1]["relocalized"] = True
        self._pending_reloc_edges[new_id] = (r.kf_id, np.asarray(r.T_kf_cam))
        self.relocalizations.append(r)
        return True

    def _process_chunk_boundary(self, depths, timestamps) -> np.ndarray:
        """Boundary-promotion chunk processing (frontend.scan_superchunk_frozen).

        The chunk tracks against a FROZEN keyframe (no tables in the scan
        carry — VERDICT r4 #1), promotion takes effect at sub-chunk
        boundaries: when any frame flags promotion, the sub-chunk's LAST
        frame becomes the keyframe (exact-identity carry reset — see
        scan_superchunk_frozen's deadband-amplifier note) and the next
        sub-chunk re-seeds from it.  World poses are composed on the
        HOST in f64 from the readback's relative poses — the scan output
        is pose-correction-independent, so the deferred backend
        (async_backend=True) can apply the PREVIOUS boundary's closure
        corrections right before this walk and remain bit-identical to
        the synchronous ordering, while its readback rides this scan's
        readback in ONE fused host sync (frontend.fuse_readbacks_jit).
        """
        import jax.numpy as jnp

        from tpuslam.frontend import (
            FlatFrozen,
            SuperChunkCarry,
            fuse_readbacks_jit,
            pack_pyramid_jit,
            promote_bundle_jit,
            scan_superchunk_frozen_jit,
        )

        odo = self.odo
        n = depths.shape[0]
        if odo.kf_packed is None:        # resumed from a checkpoint
            odo.kf_packed = pack_pyramid_jit(odo.kf_pyr, self.cfg)
        # keyframe cadence stays at `sub` regardless of how many frames
        # the caller hands over in one call (the SUPER-chunk): each
        # additional sub-chunk amortizes the fused-readback sync over `sub`
        # more frames, with promotion
        # running ON DEVICE at sub-chunk boundaries
        sub = (self.chunk_sub
               if n >= self.chunk_sub and n % self.chunk_sub == 0 else n)
        carry = SuperChunkCarry(
            kf_packed=odo.kf_packed,
            T_kf_cam=jnp.asarray(odo.T_kf_cam),
            last_delta=jnp.asarray(odo.last_delta),
        )
        new_carry, ys = scan_superchunk_frozen_jit(depths, odo.K, carry,
                                                   self.cfg, sub)
        pending, self._pending_attempt = self._pending_attempt, None
        if pending is not None:
            # one host sync covers BOTH the deferred attempt and this scan
            combined = np.asarray(fuse_readbacks_jit(pending.packed, ys))
            att = combined[: pending.size]
            s = combined[pending.size:].reshape(n, FlatFrozen.SIZE)
            self._drain_closure_attempt(pending, att)
        else:
            s = np.asarray(ys)           # the ONE host sync of the chunk
        if np.any(s[:, FlatFrozen.LOST] > 0.5):
            # tracking failed mid-chunk: nothing was committed above —
            # replay the whole chunk per-frame so loss accounting and
            # relocalization engage exactly as in streaming mode
            return np.stack([
                self.process(depths[i], float(timestamps[i]))
                for i in range(n)
            ])
        out = []
        with_desc = bool(getattr(self.cfg.posegraph,
                                 "lc_descriptor", False))
        with self._lock:
            base_T = odo.T_world_kf.astype(np.float64)
            for g in range(n // sub):
                g0 = g * sub
                rels = [s[g0 + i][FlatFrozen.REL_T].reshape(4, 4)
                        .astype(np.float64) for i in range(sub)]
                flags = s[g0:g0 + sub, FlatFrozen.PROMOTE] > 0.5
                # promote-LAST, mirroring the device-side boundary cond
                # (see scan_superchunk_frozen: an exact identity carry
                # reset — mid-chunk re-anchoring feeds the deadband
                # amplifier)
                p = sub - 1 if flags.any() else -1
                kf_id = len(odo.keyframes) - 1
                ref_base = len(odo.frame_refs)
                for i in range(sub):
                    row = s[g0 + i]
                    T_world_cam = base_T @ rels[i]
                    odo.frame_refs.append((kf_id, rels[i]))
                    odo.stats.append({
                        "iters": int(row[FlatFrozen.ITERS]),
                        "rms": float(row[FlatFrozen.RMS]),
                        "inliers": float(row[FlatFrozen.INLIER_FRACTION]),
                        "promoted": i == p,
                        "lost": False,
                    })
                    odo.trajectory.append(T_world_cam)
                    odo.timestamps.append(float(timestamps[g0 + i]))
                    odo.frame_idx += 1
                    out.append(T_world_cam)
                if p >= 0:
                    # boundary promotion: the sub-chunk's LAST frame is the
                    # new keyframe; pyramid + tables + cloud + descriptor
                    # derive from the device-resident depth in ONE async
                    # dispatch
                    odo.T_world_kf = (base_T @ rels[p]).astype(np.float32)
                    pyr, packed, cloud, desc = promote_bundle_jit(
                        depths[g0 + p], odo.K, self.cfg, with_desc)
                    odo._promote_from_bundle(pyr, packed, cloud, desc,
                                             float(timestamps[g0 + p]))
                    odo.keyframes[-1] = odo.keyframes[-1]._replace(
                        index=odo.frame_idx - sub + p)
                    new_id = len(odo.keyframes) - 1
                    odo.frame_refs[ref_base + p] = (new_id, np.eye(4))
                    base_T = base_T @ rels[p]
            # the carry's tables/poses ARE the device-side truth — the last
            # host promote_bundle packed the same frame the device packed
            odo.kf_packed = new_carry.kf_packed
            odo.T_kf_cam = new_carry.T_kf_cam
            odo.last_delta = new_carry.last_delta
            odo.last_pyr = None      # per-frame pyramids are not retained
            self._lost_streak = 0
            self._reloc_backoff = self.reloc_after
            new_kf = self._sync_graph_with_keyframes()
        if new_kf and self.enable_loop_closure:
            # ONE coalesced attempt per call at the standard 4-candidate
            # budget.  Scaling the budget with the number of promotions
            # covered was measured at config-5 scale and REJECTED: a
            # 16-lane vmapped verify runs every lane to the slowest
            # convergence while the extra closures are redundant for
            # accuracy (ATE 2.40 vs 1.96 mm);
            # the 4-candidate frontier dominates
            # (_dispatch_closure_attempt's max_candidates remains for
            # experiments).
            att = self._dispatch_closure_attempt()
            if att is not None:
                if self.async_backend:
                    self._pending_attempt = att   # deferred to next chunk
                else:
                    self._drain_closure_attempt(att)
        return np.stack(out)

    def process_chunk(self, depths, timestamps=None) -> np.ndarray:
        """Process a CHUNK of frames with one device dispatch + one readback.

        The per-frame `process` loop pays one dispatch and one readback per
        frame; this drives `frontend.scan_chunk` instead — keyframe
        state carried on device through a `lax.scan`, all per-frame scalars
        read back as one (C, FlatChunk.SIZE) matrix — and then mirrors the
        exact per-frame bookkeeping on the host: keyframe records are
        re-extracted from the (device-resident) promoted frames, the graph
        syncs, loop closures and optimization run at the chunk boundary,
        and pose corrections re-seed the next chunk's carry through
        `odo.T_world_kf`.

        Falls back to per-frame stepping (identical semantics, including
        relocalization) when: the keyframe is not yet seeded, a frame in
        the chunk reports tracking loss (the chunk commits nothing in that
        case), or frame-to-map refinement is enabled (it is per-frame by
        nature).  Keep the chunk length constant across calls — each
        distinct length is a separate compile.

        Returns (C, 4, 4) world←cam poses (as tracked; `trajectory()`
        re-anchors on optimized keyframe poses as usual).
        """
        import jax.numpy as jnp

        from tpuslam.frontend import (
            FlatChunk,
            ScanState,
            pack_pyramid_jit,
            preprocess_jit,
            scan_chunk_jit,
        )

        depths = jnp.asarray(depths)
        n = depths.shape[0]
        if timestamps is None:
            timestamps = [0.0] * n

        def per_frame(i0: int) -> np.ndarray:
            return np.stack([
                self.process(depths[i], float(timestamps[i]))
                for i in range(i0, n)
            ])

        odo = self.odo
        if self.track_against_map or odo.kf_pyr is None:
            sub = self.chunk_sub
            if (self.chunk_mode == "boundary" and odo.kf_pyr is None
                    and not self.track_against_map
                    and n > sub and n % sub == 0):
                # bootstrap exactly ONE sub-chunk per-frame (seeding the
                # keyframe), then scan the tail — a super-chunk's first
                # call must not per-frame the whole thing, or its keyframe
                # decisions diverge across chunk sizes
                head = np.stack([
                    self.process(depths[i], float(timestamps[i]))
                    for i in range(sub)
                ])
                tail = self._process_chunk_boundary(depths[sub:],
                                                    timestamps[sub:])
                return np.concatenate([head, tail])
            # map refinement is per-frame by design; an unseeded keyframe
            # means this is the first chunk — step it per-frame once rather
            # than compile an odd-length scan for the remainder
            # (self.process drains any deferred attempt first)
            return per_frame(0)
        if self.chunk_mode == "boundary":
            return self._process_chunk_boundary(depths, timestamps)
        self._drain_pending()    # mode-mixing safety for the inline path
        if odo.kf_packed is None:        # resumed from a checkpoint
            odo.kf_packed = pack_pyramid_jit(odo.kf_pyr, self.cfg)
        state = ScanState(
            kf_packed=odo.kf_packed,
            T_world_kf=jnp.asarray(odo.T_world_kf.astype(np.float32)),
            T_kf_cam=jnp.asarray(odo.T_kf_cam),
            last_delta=jnp.asarray(odo.last_delta),
        )
        new_state, ys = scan_chunk_jit(depths, odo.K, state, self.cfg)
        s = np.asarray(ys)               # the ONE host sync of the chunk
        if np.any(s[:, FlatChunk.LOST] > 0.5):
            # tracking failed mid-chunk: nothing was committed above —
            # replay the whole chunk per-frame so loss accounting and
            # relocalization engage exactly as in streaming mode
            return per_frame(0)
        out = []
        with self._lock:
            for i in range(n):
                row = s[i]
                T_world_cam = row[FlatChunk.WORLD_T].reshape(4, 4).astype(
                    np.float64)
                promoted = bool(row[FlatChunk.PROMOTE] > 0.5)
                if promoted:
                    odo.T_world_kf = T_world_cam.astype(np.float32)
                    pyr = preprocess_jit(depths[i], odo.K, self.cfg)
                    odo._promote(pyr, float(timestamps[i]))
                    odo.frame_refs.append((len(odo.keyframes) - 1, np.eye(4)))
                else:
                    odo.frame_refs.append((
                        len(odo.keyframes) - 1,
                        row[FlatChunk.REL_T].reshape(4, 4).astype(np.float64),
                    ))
                odo.stats.append({
                    "iters": int(row[FlatChunk.ITERS]),
                    "rms": float(row[FlatChunk.RMS]),
                    "inliers": float(row[FlatChunk.INLIER_FRACTION]),
                    "promoted": promoted,
                    "lost": False,
                })
                odo.trajectory.append(T_world_cam)
                odo.timestamps.append(float(timestamps[i]))
                odo.frame_idx += 1
                out.append(T_world_cam)
            # commit the device-side carry AFTER the walk — _promote set
            # kf_packed to its own (equal) re-pack of the last promotion
            odo.kf_packed = new_state.kf_packed
            odo.T_kf_cam = new_state.T_kf_cam
            odo.last_delta = new_state.last_delta
            odo.last_pyr = None      # per-frame pyramids are not retained
            self._lost_streak = 0
            self._reloc_backoff = self.reloc_after
            kf_before = self._num_graph_nodes
            new_kf = self._sync_graph_with_keyframes()
            num_new = self._num_graph_nodes - kf_before
        if new_kf:
            if self.async_backend and self._backend_thread is not None:
                # opportunity parity with the per-frame path: one queued
                # attempt PER promotion, not per chunk — a single item per
                # chunk was measured to drop verified closures 38 → 34/23
                # on the 120-frame benchmark loop
                for _ in range(num_new):
                    self._backend_queue.put(self._num_graph_nodes)
            elif self.enable_loop_closure:
                # the per-frame path gets one closure-attempt per promotion;
                # give the chunk boundary the same number of opportunities
                # (each is one fused verify+optimize dispatch), stopping
                # when dry
                for _ in range(num_new):
                    if not self._attempt_loop_closure():
                        break
        return np.stack(out)

    def process(self, depth: np.ndarray, timestamp: float = 0.0) -> np.ndarray:
        self._drain_pending()
        with self._lock:
            self.odo.process(depth, timestamp)
            if self.odo.stats[-1].get("lost"):
                self._lost_streak += 1
                if (self.enable_relocalization
                        and self._lost_streak >= self._reloc_backoff):
                    r = self._attempt_relocalization()
                    if r is True:
                        self._lost_streak = 0
                        self._reloc_backoff = self.reloc_after
                    elif r is False:
                        # genuine miss (unmapped space): back off so we
                        # don't pay 8 ICP alignments on every lost frame
                        self._lost_streak = 0
                        self._reloc_backoff = min(2 * self._reloc_backoff, 64)
                    # r is None: frame had no usable data — keep the streak
                    # so the first real frame retries immediately
            else:
                self._lost_streak = 0
                self._reloc_backoff = self.reloc_after
            new_kf = self._sync_graph_with_keyframes()
        if new_kf:
            if self.async_backend and self._backend_thread is not None:
                self._backend_queue.put(self._num_graph_nodes)
            elif self.enable_loop_closure:
                # optimization is fused into the attempt (one sync)
                self._attempt_loop_closure()
        if self.track_against_map:
            with self._lock:
                self._refine_against_map()
        kf_id, T_rel = self.odo.frame_refs[-1]
        T = self.odo.keyframes[kf_id].T_world_kf.astype(np.float64) @ T_rel
        return T

    def trajectory(self) -> tuple[np.ndarray, np.ndarray]:
        """(timestamps (F,), poses (F, 4, 4)) with all frames re-anchored on
        the current (optimized) keyframe poses."""
        poses = np.zeros((len(self.odo.frame_refs), 4, 4))
        for f, (kf_id, T_rel) in enumerate(self.odo.frame_refs):
            poses[f] = (
                self.odo.keyframes[kf_id].T_world_kf.astype(np.float64) @ T_rel
            )
        return np.asarray(self.odo.timestamps), poses
