"""Loop-closure detection + verification (SURVEY.md §2a R12, §2b N12).

Reference status: propose closures between revisited keyframes by geometric
proximity, verify with ICP (SURVEY.md §2a R12; provenance [B:5], [B:11]).

Design: proposal is trivial host-side numpy (pairwise keyframe positions —
K ≤ a few hundred); verification re-uses the jitted grid-hash ICP
(`align_clouds`, SURVEY.md §3.2) on the stored voxel-downsampled keyframe
clouds.  Acceptance gates on converged + residual RMS + inlier fraction.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from tpuslam.backend.verify import (
    flat_verify_scalars,
    passes_gates,
    uniform_verify_table,
)
from tpuslam.config import ICPConfig, Intrinsics, PoseGraphConfig
from tpuslam.geom.cloud import PointCloud
from tpuslam.icp import FlatICP, align_cloud_to_organized, align_clouds


@partial(jax.jit, static_argnames=("icp_cfg",))
def _verify_jit(cloud_j: PointCloud, cloud_i: PointCloud,
                T_init: jnp.ndarray, icp_cfg: ICPConfig) -> jnp.ndarray:
    """Grid-hash ICP + all acceptance-gate scalars in ONE flat vector.

    One readback per verification instead of five separate device fetches
    (rms/converged/inliers/H/T), for every candidate of every promotion."""
    return flat_verify_scalars(
        align_clouds(cloud_j, cloud_i, T_init, icp_cfg, use_grid=True))


@partial(jax.jit, static_argnames=("icp_cfg",))
def _verify_pairs_jit(clouds_i: PointCloud, clouds_j: PointCloud,
                      T_inits: jnp.ndarray, icp_cfg: ICPConfig) -> jnp.ndarray:
    """vmapped `_verify_jit` over B candidate pairs — one dispatch verifies
    every proposal of a promotion (each leaf stacked on a leading B dim).

    Grid-hash fallback, used when records lack verification tables (e.g.
    restored from a pre-table checkpoint): correct, but each probe gathers
    27 cells × 16 candidates per query — prefer the projective batch."""

    def one(pi, ni, mi, pj, nj, mj, T0):
        return _verify_jit(
            PointCloud(points=pj, normals=nj, mask=mj),
            PointCloud(points=pi, normals=ni, mask=mi), T0, icp_cfg)

    return jax.vmap(one)(clouds_i.points, clouds_i.normals, clouds_i.mask,
                         clouds_j.points, clouds_j.normals, clouds_j.mask,
                         T_inits)


@partial(jax.jit, static_argnames=("h", "w", "icp_cfg"))
def _verify_projective_pairs_jit(tables: jnp.ndarray, clouds_j: PointCloud,
                                 K_lvl: Intrinsics, T_inits: jnp.ndarray,
                                 h: int, w: int,
                                 icp_cfg: ICPConfig) -> jnp.ndarray:
    """Projective verification batch: align each candidate's cloud_j onto
    keyframe i's retained ORGANIZED tracking table (one row gather per
    source point per iteration — the production verification path; the
    grid probe gathers ~430 rows per point instead).  One dispatch per
    promotion."""

    def one(table, pts, nrm, msk, T0):
        return flat_verify_scalars(align_cloud_to_organized(
            PointCloud(points=pts, normals=nrm, mask=msk),
            table, h, w, K_lvl, T0, icp_cfg))

    return jax.vmap(one)(tables, clouds_j.points, clouds_j.normals,
                         clouds_j.mask, T_inits)


class ClosureCandidate(NamedTuple):
    i: int                  # earlier keyframe id
    j: int                  # later keyframe id
    dist: float             # metric distance between keyframe origins


class Closure(NamedTuple):
    i: int
    j: int
    T_ij: np.ndarray        # verified relative pose: node_i ← node_j
    rms: float
    inlier_fraction: float


def propose_candidates(
    kf_poses: Sequence[np.ndarray],
    cfg: PoseGraphConfig,
    exclude_pairs: set[tuple[int, int]] | None = None,
    max_candidates: int = 4,
    verifiable: np.ndarray | None = None,
) -> list[ClosureCandidate]:
    """Proximity-gated candidate pairs (i < j − lc_min_gap, |Δt| < radius).

    Returns closest-first, at most `max_candidates` (ICP verification is the
    expensive step — don't flood it).  `verifiable` is an optional per-
    keyframe bool mask: keyframes whose clouds were sparsified away must be
    EXCLUDED BEFORE the max_candidates cap, or the closest few pairs can all
    be unverifiable and starve the pass while verifiable pairs sit just
    beyond the cap."""
    exclude_pairs = exclude_pairs or set()
    pos = np.asarray([T[:3, 3] for T in kf_poses], dtype=np.float32)
    k = len(pos)
    cands: list[ClosureCandidate] = []
    if k < 2:
        return cands
    # Fully vectorized proposal — no Python pair loop (a K² scan at
    # thousands of keyframes).  Eligible pairs: i < j − lc_min_gap and
    # within the proximity radius.  d² via the Gram expansion keeps the
    # peak temporary at one K×K f32 (the K²×3 broadcast would triple it).
    pos = pos - pos.mean(axis=0)     # bound the f32 cancellation error
    sq = np.einsum("kd,kd->k", pos, pos)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (pos @ pos.T)
    d = np.sqrt(np.maximum(d2, 0.0))
    eligible = (
        (d < cfg.lc_max_dist)
        & (np.arange(k)[None, :] - np.arange(k)[:, None] > cfg.lc_min_gap)
    )
    if verifiable is not None:
        v = np.asarray(verifiable, dtype=bool)
        eligible &= v[:, None] & v[None, :]
    ii, jj = np.nonzero(eligible)
    order = np.argsort(d[ii, jj], kind="stable")
    for o in order:
        i, j = int(ii[o]), int(jj[o])
        if (i, j) in exclude_pairs:
            continue
        cands.append(ClosureCandidate(i=i, j=j, dist=float(d[i, j])))
        if len(cands) >= max_candidates:
            break
    return cands


def propose_descriptor_candidates(
    keyframes,
    cfg: PoseGraphConfig,
    exclude_pairs: set[tuple[int, int]],
    verifiable: np.ndarray,
    max_candidates: int,
) -> list[tuple[int, int]]:
    """Pose-free candidate pairs by depth-descriptor similarity
    (frontend.depth_descriptor; PoseGraphConfig.lc_descriptor — the
    drift-robust complement to `propose_candidates`, VERDICT r4 #6).

    Distance between two keyframes: weighted relative block-depth
    difference 2·Σw|za−zb| / Σw(za+zb) over mutually valid blocks
    (w = min of the two valid fractions); pairs with under 25% mutual
    block coverage never match.  Returns up to `max_candidates` closest
    pairs under `lc_desc_max_dist`, gap-gated like proximity proposal —
    but with NO pose term, so an arbitrarily drifted revisit still
    surfaces.  Verification (with identity init) decides; this only
    nominates."""
    ids = [k for k, r in enumerate(keyframes)
           if getattr(r, "desc", None) is not None
           and k < len(verifiable) and verifiable[k]]
    if len(ids) < 2:
        return []
    D = np.stack([np.asarray(keyframes[k].desc, dtype=np.float32)
                  for k in ids])
    n = D.shape[1] // 2
    Z, Fv = D[:, :n], D[:, n:]
    W = np.minimum(Fv[:, None, :], Fv[None, :, :])          # (K, K, n)
    num = (W * np.abs(Z[:, None, :] - Z[None, :, :])).sum(-1)
    den = (W * (Z[:, None, :] + Z[None, :, :])).sum(-1) + 1e-6
    d = 2.0 * num / den
    kf_ids = np.asarray(ids)
    eligible = (
        (d < cfg.lc_desc_max_dist)
        & (W.sum(-1) >= 0.25 * n)
        & (kf_ids[None, :] - kf_ids[:, None] > cfg.lc_min_gap)
    )
    ii, jj = np.nonzero(eligible)
    out: list[tuple[int, int]] = []
    for o in np.argsort(d[ii, jj], kind="stable"):
        pair = (int(kf_ids[ii[o]]), int(kf_ids[jj[o]]))
        if pair in exclude_pairs:
            continue
        out.append(pair)
        if len(out) >= max_candidates:
            break
    return out


def verify_closure(
    cloud_i: PointCloud,
    cloud_j: PointCloud,
    T_init_ij: np.ndarray,
    icp_cfg: ICPConfig,
    pg_cfg: PoseGraphConfig,
) -> Closure | None:
    """ICP-verify candidate: align keyframe-j cloud onto keyframe-i cloud.

    Clouds are in their own keyframe camera frames; `T_init_ij` is the
    current graph estimate of node_i ← node_j (the initial guess).
    """
    s = np.asarray(_verify_jit(
        cloud_j, cloud_i, jnp.asarray(T_init_ij, dtype=jnp.float32),
        icp_cfg))                       # the ONE host sync of the verify
    return _gate_row(s, pg_cfg)


def _gate_row(s: np.ndarray, pg_cfg: PoseGraphConfig) -> Closure | None:
    """Gate one flat verification row (backend.verify.passes_gates) and
    wrap an accepted one as a Closure."""
    if not passes_gates(s, pg_cfg):
        return None
    return Closure(
        i=-1, j=-1,
        T_ij=s[FlatICP.T].reshape(4, 4).astype(np.float64),
        rms=float(s[FlatICP.RMS]),
        inlier_fraction=float(s[FlatICP.INLIER_FRACTION]),
    )


def _pad_batch(live: list, max_candidates: int) -> list:
    """Pad to the next power-of-two batch size (capped at max_candidates)
    with repeats of the first entry: promotions typically propose 1-2
    pairs, and always padding to max_candidates would 2-4× the verification
    compute (the vmapped while_loop runs every lane to the slowest's
    convergence).  Bucketing bounds the distinct compiled batch sizes."""
    assert 0 < len(live) <= max_candidates
    b = 1
    while b < len(live):
        b *= 2
    b = min(b, max_candidates)
    return live + [live[0]] * (b - len(live))


def propose_attempt(
    keyframes,
    kf_poses: Sequence[np.ndarray],
    icp_cfg: ICPConfig,
    pg_cfg: PoseGraphConfig,
    exclude_pairs: set[tuple[int, int]] | None = None,
    max_candidates: int = 4,
    K: Intrinsics | None = None,
):
    """Host-side proposal only — no device dispatch.

    Returns `(live, padded, attempted, v0)`: the live `(i, j, T_init)`
    candidate list, the power-of-two padded candidate list (repeats of
    entry 0), all attempted pairs, and the shared VerifyTable meta (None
    ⇒ the caller must use the grid-hash fallback).  `live` is empty when
    nothing was verifiable."""
    attempted: set[tuple[int, int]] = set()
    verifiable = np.asarray([r.cloud is not None for r in keyframes], bool)
    cands = propose_candidates(kf_poses, pg_cfg, exclude_pairs,
                               max_candidates,
                               verifiable=verifiable[: len(kf_poses)])
    live = []
    for c in cands:
        if keyframes[c.i].cloud is None or keyframes[c.j].cloud is None:
            continue   # defensive; proposal already filters unverifiable
        T_init = np.linalg.inv(np.asarray(kf_poses[c.i])) @ np.asarray(
            kf_poses[c.j])
        live.append((c.i, c.j, T_init.astype(np.float32)))
        attempted.add((c.i, c.j))
    cap = max_candidates
    if getattr(pg_cfg, "lc_descriptor", False):
        desc_pairs = propose_descriptor_candidates(
            keyframes, pg_cfg,
            (exclude_pairs or set()) | attempted,
            verifiable, int(pg_cfg.lc_desc_candidates))
        for (i, j) in desc_pairs:
            # identity init: a descriptor match implies a similar viewpoint
            # — the current (possibly drift-poisoned) pose estimate is
            # deliberately NOT used
            live.append((i, j, np.eye(4, dtype=np.float32)))
            attempted.add((i, j))
        if desc_pairs:
            cap = max_candidates + int(pg_cfg.lc_desc_candidates)
            while cap & (cap - 1):       # keep batch buckets powers of two
                cap += 1
    if not live:
        return live, [], attempted, None
    padded = _pad_batch(live, cap)
    v0 = (uniform_verify_table(keyframes, [i for i, _, _ in live])
          if K is not None else None)
    return live, padded, attempted, v0


def propose_and_verify(
    keyframes,
    kf_poses: Sequence[np.ndarray],
    icp_cfg: ICPConfig,
    pg_cfg: PoseGraphConfig,
    exclude_pairs: set[tuple[int, int]] | None = None,
    max_candidates: int = 4,
    K: Intrinsics | None = None,
):
    """Propose + DISPATCH the verification batch, without syncing.

    Returns `(live, rows_dev, attempted)`: the live `(i, j, T_init)`
    candidate list (host), the (B, verify.ROW_SIZE) DEVICE array of flat
    verification rows (B = power-of-two padded batch; rows ≥ len(live)
    are padding repeats of row 0), and all attempted pairs.  `rows_dev`
    is None when nothing was verifiable.  `find_closures` below is the
    plain sync wrapper; SlamSystem's production attempt instead uses
    `propose_attempt` + `fused_attempt_jit` (verification AND pose-graph
    optimization in ONE dispatch).

    NB: subsampling the candidate clouds here (points[::k] per padded
    candidate) adds ~24 per-candidate slice dispatches per attempt; if the
    attempt is dispatch- and sync-bound rather than verify-compute-bound,
    that costs more than the gather it saves.  Pre-subsample ONCE at
    promotion instead.
    """
    live, padded, attempted, v0 = propose_attempt(
        keyframes, kf_poses, icp_cfg, pg_cfg, exclude_pairs,
        max_candidates, K)
    if not live:
        return live, None, attempted
    clouds_j = PointCloud(
        points=jnp.stack([keyframes[j].cloud.points for _, j, _ in padded]),
        normals=jnp.stack([keyframes[j].cloud.normals for _, j, _ in padded]),
        mask=jnp.stack([keyframes[j].cloud.mask for _, j, _ in padded]),
    )
    T_inits = jnp.asarray(np.stack([T for _, _, T in padded]))
    if v0 is not None:
        tables = jnp.stack([keyframes[i].verify.packed for i, _, _ in padded])
        rows_dev = _verify_projective_pairs_jit(
            tables, clouds_j, K.scaled(1.0 / (2 ** v0.level)), T_inits,
            v0.height, v0.width, icp_cfg)
    else:
        clouds_i = PointCloud(
            points=jnp.stack([keyframes[i].cloud.points
                              for i, _, _ in padded]),
            normals=jnp.stack([keyframes[i].cloud.normals
                               for i, _, _ in padded]),
            mask=jnp.stack([keyframes[i].cloud.mask for i, _, _ in padded]),
        )
        rows_dev = _verify_pairs_jit(clouds_i, clouds_j, T_inits, icp_cfg)
    return live, rows_dev, attempted


@partial(jax.jit, static_argnames=("h", "w", "icp_cfg", "pg_cfg",
                                   "use_dense", "lc_weight"))
def fused_attempt_jit(tables, pts, nrm, msk, K_lvl: Intrinsics,
                      T_inits: jnp.ndarray, n_live: jnp.ndarray,
                      graph, cand_i: jnp.ndarray, cand_j: jnp.ndarray,
                      h: int, w: int, icp_cfg: ICPConfig,
                      pg_cfg: PoseGraphConfig, use_dense: bool,
                      lc_weight: float) -> jnp.ndarray:
    """The ENTIRE loop-closure attempt as ONE device dispatch.

    Projective verification of B candidates (stacked INSIDE the jit —
    `tables`/`pts`/`nrm`/`msk` are tuples of per-candidate arrays, so the
    host issues no per-candidate stack/slice dispatches), the traced
    acceptance gates, candidate-edge extension of the bucketed graph
    (weight = lc_weight·accept — rejected candidates weigh zero), the
    pose-graph solve, and the flat readback packing.  The previous shape
    was ~10-15 separate dispatches per attempt (stacks, eager gate/concat
    chain, solve, pack), each its own launch and host sync.

    `n_live` is TRACED (no recompile per live-candidate count);
    `use_dense` is the host-resolved solver choice
    (posegraph.resolve_solver — static so the solver specializes).
    Returns flat f32: rows.reshape(-1) ++ poses.reshape(-1)
    (rows: (B, verify.ROW_SIZE); poses: graph.poses.shape).
    """
    from tpuslam.backend.posegraph import (
        optimize_pose_graph,
        optimize_pose_graph_cg,
    )
    from tpuslam.backend.verify import flat_verify_scalars, passes_gates_traced

    tb = jnp.stack(tables)
    P = jnp.stack(pts)
    N = jnp.stack(nrm)
    M = jnp.stack(msk)

    def one(table, p, n_, m, T0):
        return flat_verify_scalars(align_cloud_to_organized(
            PointCloud(points=p, normals=n_, mask=m), table, h, w,
            K_lvl, T0, icp_cfg))

    rows = jax.vmap(one)(tb, P, N, M, T_inits)
    b = rows.shape[0]
    is_real = (jnp.arange(b) < n_live).astype(rows.dtype)
    accept = passes_gates_traced(rows, pg_cfg) * is_real
    cand_T = rows[:, FlatICP.T].reshape(b, 4, 4).astype(graph.edge_T.dtype)
    # a diverged verification can return a non-finite pose (its gate
    # weight is 0) but a NaN edge_T would still poison the solve through
    # 0·NaN=NaN in the edge residuals: sanitize to identity
    finite_T = jnp.all(jnp.isfinite(cand_T), axis=(1, 2))
    cand_T = jnp.where(finite_T[:, None, None], cand_T,
                       jnp.eye(4, dtype=cand_T.dtype))
    g_ext = graph._replace(
        edge_i=jnp.concatenate([graph.edge_i, cand_i]),
        edge_j=jnp.concatenate([graph.edge_j, cand_j]),
        edge_T=jnp.concatenate([graph.edge_T, cand_T]),
        edge_weight=jnp.concatenate([graph.edge_weight,
                                     lc_weight * accept]),
    )
    if use_dense:
        poses_opt, _cost = optimize_pose_graph(g_ext, pg_cfg, 0.5)
    else:
        poses_opt, _cost = optimize_pose_graph_cg(
            g_ext, pg_cfg, 0.5,
            cg_iters=int(getattr(pg_cfg, "cg_iters", 128)),
            cg_tol=float(getattr(pg_cfg, "cg_tol", 1e-6)))
    return jnp.concatenate([
        rows.reshape(-1).astype(jnp.float32),
        poses_opt.reshape(-1).astype(jnp.float32),
    ])


def gate_rows(live, s: np.ndarray, pg_cfg: PoseGraphConfig) -> list[Closure]:
    """Host gating of readback rows → accepted Closures (paired with the
    device-side backend.verify.passes_gates_traced — same values, same
    compares, same decisions)."""
    out: list[Closure] = []
    for row_idx, (i, j, _) in enumerate(live):
        v = _gate_row(s[row_idx], pg_cfg)
        if v is not None:
            out.append(Closure(i=i, j=j, T_ij=v.T_ij, rms=v.rms,
                               inlier_fraction=v.inlier_fraction))
    return out


def find_closures(
    keyframes,
    kf_poses: Sequence[np.ndarray],
    icp_cfg: ICPConfig,
    pg_cfg: PoseGraphConfig,
    exclude_pairs: set[tuple[int, int]] | None = None,
    max_candidates: int = 4,
    K: Intrinsics | None = None,
) -> tuple[list[Closure], set[tuple[int, int]]]:
    """Full propose→verify pass over the current keyframe set.

    `keyframes[k].cloud` must hold the stored downsampled cloud of node k
    (None = sparsified away — skipped).  All verifications of the pass run
    as ONE vmapped dispatch: projectively against the keyframes' retained
    tracking tables when available (pass `K` — the production path), else
    grid-hash cloud-to-cloud.  Returns (verified closures, ALL attempted
    pairs) so the caller can remember failures and not re-pay the ICP
    verification for the same pair every promotion — the clouds never
    change, so a failed pair can only start passing after an optimization
    moves the initial guess (SlamSystem clears its failure memory on every
    optimize).
    """
    live, rows_dev, attempted = propose_and_verify(
        keyframes, kf_poses, icp_cfg, pg_cfg, exclude_pairs,
        max_candidates, K)
    if rows_dev is None:
        return [], attempted
    return gate_rows(live, np.asarray(rows_dev), pg_cfg), attempted
