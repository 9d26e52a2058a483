"""Odometry / mapping frontend (SURVEY.md §2a R9-R10, §2b N10, §3.1).

Reference status: frame-to-frame and frame-to-keyframe tracking with motion/
overlap keyframe promotion and an accumulated voxel map (SURVEY.md §2a
R9-R10; provenance [B:5], [B:9-10]).

Design — drivers over one jitted core:

  * `track_step` — the pure, jittable unit of work: preprocess is done,
    pyramids in hand; runs coarse-to-fine projective ICP against the current
    keyframe and computes the keyframe-promotion decision as *flags* (no
    data-dependent Python control flow).
  * `Odometry` — host-driven loop for real dataset streams: one
    `track_step` call per frame; keyframe promotion swaps device arrays on
    the host side (outside jit, zero recompiles — shapes never change).
  * `scan_odometry` — whole sequence as a single `lax.scan` on device:
    keyframe state lives in the scan carry and promotion is a
    `tree_map(where)` select.  This is the benchmark path (SURVEY.md §3.5)
    and the flagship jitted program for the compile-check entry point.
  * `scan_superchunk_frozen` — the production CHUNKED streaming scan
    (SlamSystem.process_chunk, boundary mode): G sub-chunks per dispatch
    against a frozen keyframe with ON-DEVICE boundary promotion; emits
    only keyframe-relative poses so the host composes world poses in f64
    and the deferred backend stays bit-deterministic.

Keyframe criterion: relative motion (translation/rotation) beyond threshold
OR inlier fraction below threshold (overlap loss) — SURVEY.md §2a R9.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from tpuslam.config import Intrinsics, SLAMConfig
from tpuslam.geom import se3
from tpuslam.geom.backproject import backproject
from tpuslam.geom.cloud import PointCloud
from tpuslam.geom.normals import organized_normals
from tpuslam.geom.voxel import voxel_downsample
from tpuslam.icp import (
    Frame,
    ICPResult,
    align_frames,
    align_frames_packed,
    pack_pyramid,
)


def damped_velocity(delta: jnp.ndarray, gamma: float) -> jnp.ndarray:
    """Scale an inter-frame motion twist for the warm start (see
    SLAMConfig.cv_damping for why γ < 1 is required for stability)."""
    if gamma == 0.0:
        return jnp.eye(4, dtype=delta.dtype)
    if gamma == 1.0:
        return delta
    return se3.exp(gamma * se3.log(delta))


def preprocess(depth: jnp.ndarray, K: Intrinsics, cfg: SLAMConfig):
    """depth (H, W) → organized pyramid [finest..coarsest] of Frames.

    The DEPTH image is decimated first and each level is backprojected with
    its own scaled intrinsics, rather than decimating a full-resolution
    point pyramid: a strided slice of one (H, W) plane moves a third of the
    bytes of the (H, W, 3) point images.  It is also *more*
    self-consistent: level-l points
    satisfy project(p, K.scaled(2^-l)) == their own pixel exactly, and
    coarse normals use the coarse neighbor baseline (standard pyramid
    practice).
    Accepts three input dtypes (all geometry math runs in float32):
      * float32 — metres, the canonical path;
      * uint16 — RAW TUM depth counts, divided by `cfg.depth_scale` here
        on device.  Same 2 bytes/px as float16 over the wire but ZERO
        quantization: the division is the identical IEEE f32 divide the
        host decode performs (data/tum.py _decode_depth_png), so the
        trajectory is bit-equal to the f32-upload path (VERDICT r4 #3;
        CLI --upload-raw, tests/test_odometry.py bit-equality test);
      * float16 — metres, pre-quantized (~1.5 mm at 3 m); kept only for
        sources whose native format isn't uint16 (CLI --upload-f16).
    Halving the host→device transfer matters where the link is narrow.
    """
    levels = cfg.icp.pyramid_levels
    pyr = []
    d = depth.astype(jnp.float32)
    if depth.dtype == jnp.uint16:
        # The barrier keeps XLA from strength-reducing the constant divide
        # into a reciprocal multiply (measured 1-ulp drift on CPU) — the
        # bit-equality claim above requires the true IEEE divide.
        d = d / jax.lax.optimization_barrier(jnp.float32(cfg.depth_scale))
    for li in range(levels):
        with jax.named_scope(f"preprocess.backproject_l{li}"):
            pts, mask = backproject(
                d, K.scaled(1.0 / (2 ** li)),
                depth_min=cfg.icp.depth_min, depth_max=cfg.icp.depth_max,
            )
        with jax.named_scope(f"preprocess.normals_l{li}"):
            nrm, nmask = organized_normals(pts, mask)
        pyr.append(Frame(points=pts, normals=nrm, mask=mask & nmask))
        if li + 1 < levels:
            with jax.named_scope(f"preprocess.decimate_l{li}"):
                d = d[::2, ::2]
    return tuple(pyr)


@partial(jax.jit, static_argnames=("cfg",))
def preprocess_jit(depth, K, cfg: SLAMConfig):
    return preprocess(depth, K, cfg)


class TrackResult(NamedTuple):
    T_kf_cam: jnp.ndarray      # (4, 4) camera pose in keyframe frame
    icp: ICPResult
    promote: jnp.ndarray       # () bool — should current frame become keyframe
    lost: jnp.ndarray          # () bool — tracking failure


def _promote_flags(res: ICPResult, T0: jnp.ndarray, cfg: SLAMConfig):
    T = res.T
    lost = ((res.inlier_fraction < cfg.keyframe.lost_inlier_fraction)
            | ~jnp.all(jnp.isfinite(T)))
    T = jnp.where(lost, T0, T)
    promote = (
        (se3.translation_norm(T) > cfg.keyframe.max_translation)
        | (se3.rotation_angle(T) > cfg.keyframe.max_rotation)
        | (res.inlier_fraction < cfg.keyframe.min_inlier_fraction)
    ) & ~lost
    return TrackResult(T_kf_cam=T, icp=res, promote=promote, lost=lost)


def track_step_packed(kf_packed: tuple, cur_pyr, K: Intrinsics,
                      T0: jnp.ndarray, cfg: SLAMConfig) -> TrackResult:
    """`track_step` against a pre-packed keyframe (see icp.pack_pyramid —
    packing is paid once per promotion here, not per frame)."""
    res = align_frames_packed(cur_pyr, kf_packed, K, T0, cfg.icp)
    return _promote_flags(res, T0, cfg)


@partial(jax.jit, static_argnames=("cfg",))
def track_step_packed_jit(kf_packed, cur_pyr, K, T0,
                          cfg: SLAMConfig) -> TrackResult:
    return track_step_packed(kf_packed, cur_pyr, K, T0, cfg)


@partial(jax.jit, static_argnames=("cfg",))
def pack_pyramid_jit(pyr, cfg: SLAMConfig):
    return pack_pyramid(pyr, cfg.icp)


class FlatTrack:
    """Index map of process_frame_jit's flat scalar vector (single-readback
    protocol for the streaming loop — NOT the same layout as icp.FlatICP)."""

    T = slice(0, 16)          # T_kf_cam, row-major
    PROMOTE = 16
    LOST = 17
    ITERS = 18
    RMS = 19
    INLIER_FRACTION = 20
    SIZE = 21


@partial(jax.jit, static_argnames=("cfg",))
def process_frame_jit(depth, kf_packed: tuple, K: Intrinsics,
                      T_kf_cam: jnp.ndarray, last_delta: jnp.ndarray,
                      cfg: SLAMConfig):
    """Fused warm-start + preprocess + track for the host-driven loop.

    Every host↔device round trip stalls the device, so the streaming loop
    makes exactly ONE dispatch and ONE readback per frame.  Everything the
    host would otherwise do eagerly (constant-velocity warm start) or read
    back piecemeal (pose, promote/lost flags, per-frame stats — six
    separate device fetches) is fused here: the chained state (pose,
    velocity) stays on device, and every scalar the host needs comes back
    in one flat (FlatTrack.SIZE,) vector indexed through FlatTrack.
    """
    T0 = T_kf_cam @ damped_velocity(last_delta, cfg.cv_damping)
    pyr = preprocess(depth, K, cfg)
    out = track_step_packed(kf_packed, pyr, K, T0, cfg)
    delta = se3.relative(T_kf_cam, out.T_kf_cam)
    flat = jnp.concatenate([
        out.T_kf_cam.reshape(16).astype(jnp.float32),
        jnp.stack([
            out.promote.astype(jnp.float32),
            out.lost.astype(jnp.float32),
            out.icp.iters.astype(jnp.float32),
            out.icp.rms.astype(jnp.float32),
            out.icp.inlier_fraction.astype(jnp.float32),
        ]),
    ])
    return pyr, out.T_kf_cam, delta, flat


def track_step(kf_pyr, cur_pyr, K: Intrinsics, T0: jnp.ndarray,
               cfg: SLAMConfig) -> TrackResult:
    """Track current frame against keyframe; decide promotion (pure/jittable)."""
    res = align_frames(cur_pyr, kf_pyr, K, T0, cfg.icp)
    return _promote_flags(res, T0, cfg)


@partial(jax.jit, static_argnames=("cfg",))
def track_step_jit(kf_pyr, cur_pyr, K, T0, cfg: SLAMConfig) -> TrackResult:
    return track_step(kf_pyr, cur_pyr, K, T0, cfg)


@partial(jax.jit, static_argnames=("voxel_size", "capacity", "origin",
                                   "extent"))
def _kf_cloud_jit(frame: Frame, voxel_size: float, capacity: int,
                  origin: float, extent: float) -> PointCloud:
    """Jitted keyframe-cloud extraction (eager voxel_downsample is ~15
    separate dispatches)."""
    return voxel_downsample(frame.as_cloud(), voxel_size, capacity,
                            origin, extent)


@partial(jax.jit, static_argnames=("cfg", "with_desc"))
def promote_bundle_jit(depth, K: Intrinsics, cfg: SLAMConfig,
                       with_desc: bool):
    """Everything a keyframe promotion derives from its depth frame —
    pyramid, packed gather tables, downsampled cloud, (optional)
    descriptor — in ONE dispatch (the boundary chunk driver promotes from
    a device-resident depth at the chunk boundary instead of issuing four
    separate jit calls)."""
    pyr = preprocess(depth, K, cfg)
    packed = pack_pyramid(pyr, cfg.icp)
    cloud = voxel_downsample(pyr[0].as_cloud(), cfg.voxel.voxel_size,
                             cfg.voxel.capacity, cfg.voxel.origin,
                             cfg.voxel.extent)
    desc = (depth_descriptor(pyr[-1].points, pyr[-1].mask)
            if with_desc else None)
    return pyr, packed, cloud, desc


def prefetch_to_device(frames, lookahead: int = 2):
    """Re-yield a TumFrame stream with depth arrays device_put ahead.

    Uploading 1.2 MB per 640×480 frame inside process() serializes the
    transfer with the compute readback; putting `lookahead` frames ahead
    lets the (async) transfer overlap the previous frame's execution.
    `jnp.asarray` on an already-device array is a no-op, so consumers are
    unchanged.
    """
    from collections import deque

    pending: deque = deque()
    for f in frames:
        pending.append(f._replace(depth=jax.device_put(f.depth)))
        if len(pending) >= max(1, lookahead):
            yield pending.popleft()
    while pending:
        yield pending.popleft()


class VerifyTable(NamedTuple):
    """Packed row-gather table a keyframe retains for projective backend
    verification (loop closure / relocalization) — a byproduct of its own
    tracking tables (icp.pack_pyramid), kept at KeyframeConfig.verify_level."""

    packed: "jnp.ndarray"       # (h·w, 8) table (pack_organized_target)
    height: int                 # static — level image dims
    width: int
    level: int                  # pyramid level (scales the intrinsics)


DESC_GRID = (6, 8)              # (gh, gw) blocks of the coarsest level


@partial(jax.jit, static_argnames=("gh", "gw"))
def depth_descriptor(points: jnp.ndarray, mask: jnp.ndarray,
                     gh: int = DESC_GRID[0],
                     gw: int = DESC_GRID[1]) -> jnp.ndarray:
    """Pose-FREE per-keyframe appearance descriptor (VERDICT r4 #6).

    Proximity-only loop-closure proposal is drift-bounded: a revisit whose
    accumulated drift exceeds `lc_max_dist` is never proposed — the exact
    regime loop closure exists for.  This descriptor is the pose-free
    candidate source: a gh×gw grid of mean-depth + valid-fraction blocks
    over the COARSEST pyramid level (a tracking byproduct — one tiny
    reduction per promotion, stored as 2·gh·gw floats).  Similar
    descriptors ⇒ similar viewpoint of the same structure ⇒ the existing
    projective ICP verification converges from an IDENTITY initial guess,
    which is precisely the subset of revisits that are verifiable at all.
    Matching is host-side numpy (backend.loopclosure
    propose_descriptor_candidates) against `PoseGraphConfig.lc_desc_*`.
    """
    z = points[..., 2]
    h, w = z.shape
    hc, wc = (h // gh) * gh, (w // gw) * gw
    zb = jnp.where(mask, z, 0.0)[:hc, :wc].reshape(
        gh, hc // gh, gw, wc // gw)
    mb = mask[:hc, :wc].reshape(gh, hc // gh, gw, wc // gw).astype(z.dtype)
    cnt = mb.sum(axis=(1, 3))
    mean_z = zb.sum(axis=(1, 3)) / jnp.maximum(cnt, 1.0)
    frac = cnt / float((hc // gh) * (wc // gw))
    return jnp.concatenate([mean_z.reshape(-1),
                            frac.reshape(-1)]).astype(jnp.float32)


class KeyframeRecord(NamedTuple):
    """Host-side record of a promoted keyframe (for the backend)."""

    index: int                  # frame index in the sequence
    timestamp: float
    T_world_kf: np.ndarray      # (4, 4)
    cloud: Optional[PointCloud]  # voxel-downsampled cloud in KF camera frame
    # retained verification table; dropped together with `cloud` by
    # sparsification; None on records restored from old checkpoints
    # (verification then falls back to the grid-hash path)
    verify: Optional[VerifyTable] = None
    # pose-free appearance descriptor (depth_descriptor) — only computed
    # when PoseGraphConfig.lc_descriptor is on; survives sparsification
    # only alongside the cloud (an unverifiable candidate is useless)
    desc: Optional[np.ndarray] = None


class Odometry:
    """Host-driven frame-to-keyframe visual odometry (SURVEY.md §3.1 loop)."""

    def __init__(self, K: Intrinsics, cfg: SLAMConfig,
                 keep_keyframe_clouds: bool = True):
        self.K = K
        self.cfg = cfg
        self.keep_keyframe_clouds = keep_keyframe_clouds
        self.T_world_kf = np.eye(4, dtype=np.float32)
        self.T_kf_cam = jnp.eye(4)
        self.last_delta = jnp.eye(4)      # constant-velocity model
        self.kf_pyr = None
        self.kf_packed = None             # row-gather tables, built per promote
        self.frame_idx = 0
        self.trajectory: list[np.ndarray] = []
        self.timestamps: list[float] = []
        self.keyframes: list[KeyframeRecord] = []
        self.stats: list[dict] = []
        # per-frame (keyframe id, T_kf_cam) so the backend can re-anchor the
        # full trajectory after pose-graph optimization (SURVEY.md §3.1)
        self.frame_refs: list[tuple[int, np.ndarray]] = []
        self.last_pyr = None  # most recent preprocessed frame (map tracking)
        # keyframe ids whose clouds must survive sparsification (the SLAM
        # backend registers loop-closure / relocalization anchors here),
        # mapped to a recency sequence so the bound evicts the LEAST
        # RECENTLY RE-CONFIRMED anchor — anchors are old keyframes by
        # construction, so evicting by id would drop exactly the
        # most-revisited places first
        self.protected_kf_ids: dict[int, int] = {}
        self._protect_seq = 0

    def protect(self, *ids: int) -> None:
        """Mark keyframes as sparsification-protected, refreshing recency."""
        for k in ids:
            self._protect_seq += 1
            self.protected_kf_ids[k] = self._protect_seq

    def _kf_cloud(self, pyr) -> PointCloud:
        return _kf_cloud_jit(
            pyr[0], self.cfg.voxel.voxel_size, self.cfg.voxel.capacity,
            self.cfg.voxel.origin, self.cfg.voxel.extent,
        )

    def _promote(self, pyr, timestamp: float) -> None:
        packed = pack_pyramid_jit(pyr, self.cfg)
        cloud = None
        desc = None
        if self.keep_keyframe_clouds:
            cloud = self._kf_cloud(pyr)
            if getattr(self.cfg.posegraph, "lc_descriptor", False):
                # device handle; materialized lazily at proposal time
                desc = depth_descriptor(pyr[-1].points, pyr[-1].mask)
        self._promote_from_bundle(pyr, packed, cloud, desc, timestamp)

    def _promote_from_bundle(self, pyr, packed, cloud, desc,
                             timestamp: float) -> None:
        """Promotion bookkeeping from pre-computed derived state (the
        boundary chunk driver computes everything in one dispatch —
        promote_bundle_jit; `_promote` is the multi-dispatch form)."""
        self.kf_pyr = pyr
        self.kf_packed = packed
        verify = None
        if self.keep_keyframe_clouds:
            # retain the tracking table at verify_level for the backend's
            # projective verification — already computed, memory only
            lvl = min(int(getattr(self.cfg.keyframe, "verify_level", 1)),
                      len(pyr) - 1)
            h, w, _ = pyr[lvl].points.shape
            verify = VerifyTable(packed=packed[lvl],
                                 height=h, width=w, level=lvl)
        else:
            cloud = None
            desc = None
        self.keyframes.append(
            KeyframeRecord(
                index=self.frame_idx,
                timestamp=timestamp,
                T_world_kf=self.T_world_kf.copy(),
                cloud=cloud,
                verify=verify,
                desc=desc,
            )
        )
        if self.keep_keyframe_clouds:
            self._enforce_cloud_budget()

    def _enforce_cloud_budget(self) -> None:
        """Keyframe sparsification: bound stored-cloud memory on long runs.

        Keyframe POSES always stay (graph nodes are 16 floats and the pose
        graph grows amortized — backend/posegraph.py GraphHost); what is
        sparsified is the per-keyframe CLOUD (~0.5 MB each), used only by
        loop-closure verification, relocalization, map rebuild, and map BA.
        Past `cfg.keyframe.max_keyframes` retained clouds, drop the cloud
        whose keyframe is most spatially redundant — smallest distance to
        another retained-cloud keyframe — keeping a spatially diverse cover
        so revisits still find a verifiable anchor.  Protected: the newest
        `sparsify_protect_recent` (active tracking neighborhood), id 0 (the
        origin anchor), and anything in `protected_kf_ids` (loop-closure /
        reloc anchors registered by the SLAM backend).
        """
        budget = int(self.cfg.keyframe.max_keyframes)
        recent = int(getattr(self.cfg.keyframe, "sparsify_protect_recent", 8))
        retained = [k for k, r in enumerate(self.keyframes)
                    if r.cloud is not None]
        if len(retained) <= budget:
            return
        protected = set(self.protected_kf_ids)
        protected.add(0)
        if recent > 0:           # -0 would slice the WHOLE list (protect all)
            protected.update(retained[-recent:])
        pos = np.stack([
            self.keyframes[k].T_world_kf[:3, 3].astype(np.float64)
            for k in retained
        ])
        while len(retained) > budget:
            d = np.linalg.norm(pos[:, None, :] - pos[None, :, :], axis=-1)
            np.fill_diagonal(d, np.inf)
            nearest = d.min(axis=1)
            drop_at = None
            for idx in np.argsort(nearest):
                if retained[int(idx)] not in protected:
                    drop_at = int(idx)
                    break
            if drop_at is None:
                return  # everything protected — bounded by the protections
            k = retained[drop_at]
            self.keyframes[k] = self.keyframes[k]._replace(
                cloud=None, verify=None, desc=None)
            retained.pop(drop_at)
            pos = np.delete(pos, drop_at, axis=0)

    def process(self, depth: np.ndarray, timestamp: float = 0.0) -> np.ndarray:
        """Feed one depth frame (H, W) metres; returns world←cam pose (4, 4)."""
        if self.kf_pyr is None:
            pyr = preprocess_jit(jnp.asarray(depth), self.K, self.cfg)
            self.last_pyr = pyr
            self._promote(pyr, timestamp)
            T_world_cam = self.T_world_kf
            self.stats.append({"iters": 0, "rms": 0.0, "inliers": 1.0,
                               "promoted": True})
            self.frame_refs.append((len(self.keyframes) - 1, np.eye(4)))
        else:
            if self.kf_packed is None:  # resumed from a checkpoint
                self.kf_packed = pack_pyramid_jit(self.kf_pyr, self.cfg)
            pyr, T_new, delta, flat = process_frame_jit(
                jnp.asarray(depth), self.kf_packed, self.K,
                self.T_kf_cam, self.last_delta, self.cfg)
            self.last_pyr = pyr
            s = np.asarray(flat)     # the ONE host sync of the frame
            T_rel = s[FlatTrack.T].reshape(4, 4)
            promoted = s[FlatTrack.PROMOTE] > 0.5
            self.last_delta = delta  # device-resident; never read back
            self.T_kf_cam = T_new
            T_world_cam = (self.T_world_kf @ T_rel).astype(np.float32)
            if promoted:
                self.T_world_kf = T_world_cam
                self.T_kf_cam = jnp.eye(4)
                self._promote(pyr, timestamp)
                self.frame_refs.append((len(self.keyframes) - 1, np.eye(4)))
            else:
                self.frame_refs.append((len(self.keyframes) - 1, T_rel))
            self.stats.append(
                {
                    "iters": int(s[FlatTrack.ITERS]),
                    "rms": float(s[FlatTrack.RMS]),
                    "inliers": float(s[FlatTrack.INLIER_FRACTION]),
                    "promoted": bool(promoted),
                    "lost": bool(s[FlatTrack.LOST] > 0.5),
                }
            )
        self.trajectory.append(np.asarray(T_world_cam, dtype=np.float64))
        self.timestamps.append(timestamp)
        self.frame_idx += 1
        return self.trajectory[-1]


class ScanState(NamedTuple):
    kf_packed: tuple            # keyframe row-gather tables (per level)
    T_world_kf: jnp.ndarray
    T_kf_cam: jnp.ndarray
    last_delta: jnp.ndarray


class FlatChunk:
    """Per-frame column layout of `scan_chunk`'s (C, SIZE) readback matrix
    (the chunked streaming protocol — one flat transfer per CHUNK).  Index
    through these names, never literals (FlatTrack/FlatICP differ)."""

    WORLD_T = slice(0, 16)     # T_world_cam, row-major
    REL_T = slice(16, 32)      # T_kf_cam (pre-promotion, vs the frame's kf)
    PROMOTE = 32
    LOST = 33
    ITERS = 34
    RMS = 35
    INLIER_FRACTION = 36
    SIZE = 37


def scan_chunk(depths: jnp.ndarray, K: Intrinsics, state: ScanState,
               cfg: SLAMConfig):
    """Track a fixed-size CHUNK of frames in one `lax.scan` dispatch.

    The host-driven per-frame loop pays one dispatch and one readback per
    frame by construction (frontend.process_frame_jit is already minimal).
    This amortizes that floor over C frames: keyframe state (packed gather
    tables, poses, velocity) lives in the scan carry exactly as in
    `scan_odometry`, promotion is a cond-gated re-pack, and everything the
    host needs to mirror the bookkeeping comes back as ONE
    (C, FlatChunk.SIZE) matrix.  The carry
    returns device-resident so the next chunk chains without any upload
    except the (host-corrected) keyframe pose.

    Unlike `scan_odometry` (whole sequence, benchmark path) the chunk
    driver keeps the HOST in the loop at chunk boundaries, so the pose
    graph, loop closures, relocalization, and sparsification all run
    unchanged between chunks (tpuslam/slam.py process_chunk).
    """

    def step(st: ScanState, depth):
        pyr = preprocess(depth, K, cfg)
        T0 = st.T_kf_cam @ damped_velocity(st.last_delta, cfg.cv_damping)
        out = track_step_packed(st.kf_packed, pyr, K, T0, cfg)
        T_world_cam = st.T_world_kf @ out.T_kf_cam
        promote = out.promote

        def sel(new, old):
            return jnp.where(promote, new, old)

        new_packed = jax.lax.cond(
            promote,
            lambda: pack_pyramid(pyr, cfg.icp),
            lambda: st.kf_packed,
        )
        new_state = ScanState(
            kf_packed=new_packed,
            T_world_kf=sel(T_world_cam, st.T_world_kf),
            T_kf_cam=sel(jnp.eye(4), out.T_kf_cam),
            last_delta=se3.relative(st.T_kf_cam, out.T_kf_cam),
        )
        flat = jnp.concatenate([
            T_world_cam.reshape(16).astype(jnp.float32),
            out.T_kf_cam.reshape(16).astype(jnp.float32),
            jnp.stack([
                promote.astype(jnp.float32),
                out.lost.astype(jnp.float32),
                out.icp.iters.astype(jnp.float32),
                out.icp.rms.astype(jnp.float32),
                out.icp.inlier_fraction.astype(jnp.float32),
            ]),
        ])
        return new_state, flat

    return jax.lax.scan(step, state, depths)


@partial(jax.jit, static_argnames=("cfg",))
def scan_chunk_jit(depths, K, state: ScanState, cfg: SLAMConfig):
    return scan_chunk(depths, K, state, cfg)


class FrozenState(NamedTuple):
    """Carry of the frozen-keyframe chunk scan — poses only, no tables."""

    T_kf_cam: jnp.ndarray       # (4, 4) pose vs the FROZEN keyframe
    last_delta: jnp.ndarray     # (4, 4) last inter-frame motion


class FlatFrozen:
    """Per-frame column layout of `scan_superchunk_frozen`'s (N, SIZE)
    readback.  No world pose — the host composes world = T_world_kf ·
    REL_T in f64, which is what makes the deferred backend
    bit-deterministic (the scan output is pose-correction-independent)."""

    REL_T = slice(0, 16)       # T_kf_cam vs the frozen keyframe, row-major
    PROMOTE = 16
    LOST = 17
    ITERS = 18
    RMS = 19
    INLIER_FRACTION = 20
    SIZE = 21


class SuperChunkCarry(NamedTuple):
    """Device-resident carry of `scan_superchunk_frozen` across calls."""

    kf_packed: tuple            # packed tables of the CURRENT keyframe
    T_kf_cam: jnp.ndarray       # (4, 4) pose vs that keyframe
    last_delta: jnp.ndarray     # (4, 4) last inter-frame motion


def scan_superchunk_frozen(depths: jnp.ndarray, K: Intrinsics,
                           carry: SuperChunkCarry, cfg: SLAMConfig,
                           sub: int):
    """G sub-chunks of `sub` frames in ONE dispatch, promotion ON DEVICE
    at sub-chunk boundaries — the host syncs once per G·sub frames.

    The single fused readback is a host sync per chunk; promoting on device
    between sub-chunks lets the host sync at super-chunk granularity
    while the keyframe cadence stays at `sub`.  Structure is `scan_odometry_boundary`'s two-level scan, but
    every emitted quantity is RELATIVE to the emitting sub-chunk's entry
    keyframe (no world pose on device): the host composes world poses in
    f64, chaining `base ← base @ rel_p` at each promoted sub-chunk — so
    the output stays pose-correction-independent and the deferred
    backend's bit-determinism is preserved at any super-chunk size.

    Returns (new_carry, ys) with ys of shape (G·sub, FlatFrozen.SIZE);
    row semantics per FlatFrozen, REL_T relative to the sub-chunk-entry
    keyframe, PROMOTE flags resolved by the host (any flag in a sub-chunk
    promotes that sub-chunk's LAST frame — see the promote-last note in
    the body).
    """
    n = depths.shape[0]
    if n % sub:
        raise ValueError(f"superchunk length {n} not divisible by {sub}")
    chunks = depths.reshape(n // sub, sub, *depths.shape[1:])

    def outer(c: SuperChunkCarry, depth_chunk):
        def inner(st: FrozenState, depth):
            pyr = preprocess(depth, K, cfg)
            T0 = st.T_kf_cam @ damped_velocity(st.last_delta,
                                               cfg.cv_damping)
            out = track_step_packed(c.kf_packed, pyr, K, T0, cfg)
            new_st = FrozenState(
                T_kf_cam=out.T_kf_cam,
                last_delta=se3.relative(st.T_kf_cam, out.T_kf_cam),
            )
            flat = jnp.concatenate([
                out.T_kf_cam.reshape(16).astype(jnp.float32),
                jnp.stack([
                    out.promote.astype(jnp.float32),
                    out.lost.astype(jnp.float32),
                    out.icp.iters.astype(jnp.float32),
                    out.icp.rms.astype(jnp.float32),
                    out.icp.inlier_fraction.astype(jnp.float32),
                ]),
            ])
            return new_st, flat

        st_end, rows = jax.lax.scan(
            inner, FrozenState(T_kf_cam=c.T_kf_cam,
                               last_delta=c.last_delta), depth_chunk)
        any_p = jnp.any(rows[:, FlatFrozen.PROMOTE] > 0.5)

        # Promote the LAST frame of the sub-chunk (not the first flagged):
        # the carry reset is then EXACT — T_kf_cam becomes the identity
        # with no relative-pose computation.  Re-anchoring on a mid-chunk
        # frame (`relative(rel_p, rel_end)`) leaves ~1e-7 of f32 inversion
        # noise in the warm start, and the nearest-pixel association's
        # sub-pixel deadband AMPLIFIES a per-promotion injection ~2× per
        # frame (measured: 2.4e-7 → 3.3e-3 over 14 frames at per-frame
        # promotion cadence — the same feedback mechanism as the
        # cv_damping divergence; at tight config-5 thresholds it wrecked
        # the trajectory, 0.75 mm → 0.33 m ATE).  Promote-last is also
        # the FRESHEST anchor for the next sub-chunk.
        def promote_branch():
            return pack_pyramid(preprocess(depth_chunk[-1], K, cfg),
                                cfg.icp)

        new_packed = jax.lax.cond(any_p, promote_branch,
                                  lambda: c.kf_packed)
        new_T_kf_cam = jnp.where(any_p, jnp.eye(4, dtype=rows.dtype),
                                 st_end.T_kf_cam)
        return SuperChunkCarry(kf_packed=new_packed,
                               T_kf_cam=new_T_kf_cam,
                               last_delta=st_end.last_delta), rows

    new_carry, ys = jax.lax.scan(outer, carry, chunks)
    return new_carry, ys.reshape(n, FlatFrozen.SIZE)


@partial(jax.jit, static_argnames=("cfg", "sub"))
def scan_superchunk_frozen_jit(depths, K, carry: SuperChunkCarry,
                               cfg: SLAMConfig, sub: int):
    return scan_superchunk_frozen(depths, K, carry, cfg, sub)


@jax.jit
def fuse_readbacks_jit(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Concatenate two device results into ONE flat f32 vector so the host
    pays a single readback for both (the deferred backend's closure-attempt
    rows ride the next chunk's scan readback)."""
    return jnp.concatenate([a.reshape(-1).astype(jnp.float32),
                            b.reshape(-1).astype(jnp.float32)])


def scan_odometry(depths: jnp.ndarray, K: Intrinsics, cfg: SLAMConfig):
    """Full-sequence odometry as one jitted `lax.scan` over frames.

    The keyframe lives in the carry as its PACKED gather tables, not as raw
    pyramids: tracking only ever reads the tables, and re-packing is gated
    behind `lax.cond(promote, ...)` so its cost is paid only on the
    ~1-in-10 frames that actually promote.

    Args:
      depths: (F, H, W) float32 metres (pre-decoded, device-resident).
    Returns:
      poses (F, 4, 4) world←cam, promote flags (F,), inlier fractions (F,).
    """

    def step(state: ScanState, depth):
        pyr = preprocess(depth, K, cfg)
        T0 = state.T_kf_cam @ damped_velocity(state.last_delta,
                                              cfg.cv_damping)
        out = track_step_packed(state.kf_packed, pyr, K, T0, cfg)
        T_world_cam = state.T_world_kf @ out.T_kf_cam
        promote = out.promote

        def sel(new, old):
            return jnp.where(promote, new, old)

        new_packed = jax.lax.cond(
            promote,
            lambda: pack_pyramid(pyr, cfg.icp),
            lambda: state.kf_packed,
        )
        new_state = ScanState(
            kf_packed=new_packed,
            T_world_kf=sel(T_world_cam, state.T_world_kf),
            T_kf_cam=sel(jnp.eye(4), out.T_kf_cam),
            last_delta=se3.relative(state.T_kf_cam, out.T_kf_cam),
        )
        return new_state, (T_world_cam, promote, out.icp.inlier_fraction)

    pyr0 = preprocess(depths[0], K, cfg)
    init = ScanState(
        kf_packed=pack_pyramid(pyr0, cfg.icp),
        T_world_kf=jnp.eye(4),
        T_kf_cam=jnp.eye(4),
        last_delta=jnp.eye(4),
    )
    _, (poses, promotes, inliers) = jax.lax.scan(step, init, depths)
    return poses, promotes, inliers


@partial(jax.jit, static_argnames=("cfg",))
def scan_odometry_jit(depths, K, cfg: SLAMConfig):
    return scan_odometry(depths, K, cfg)


def scan_odometry_boundary(depths: jnp.ndarray, K: Intrinsics,
                           cfg: SLAMConfig, chunk: int = 8):
    """Full-sequence odometry with BOUNDARY keyframe promotion — the
    carry-copy-free variant of `scan_odometry` (VERDICT r4 #1).

    Two-level scan: the inner scan tracks `chunk` frames against a FROZEN
    keyframe (carry = two 4×4 poses — no table select, no per-frame carry
    copies); the outer scan holds the packed keyframe tables and promotes
    at most once per chunk boundary: if any frame flagged promotion, the
    chunk's LAST frame becomes the keyframe (exact-identity carry reset
    — see scan_superchunk_frozen's deadband-amplifier note),
    re-preprocessed+packed inside the `lax.cond` so that cost is paid only
    on promoting chunks.  The inline scan pays a per-frame `lax.cond`
    table select on every unpromoted frame; here the same select costs
    once per `chunk` frames.

    Semantics delta vs `scan_odometry`: frames after the promotion flag
    within a chunk track against the OLD keyframe (up to chunk−1 frames
    farther — still inside `max_corr_dist` at default thresholds), and the
    keyframe's world pose anchors on the flagged frame's tracked pose.
    Trajectories agree to ATE noise on the synthetic fixtures
    (tests/test_odometry.py boundary parity test).

    Args:
      depths: (F, H, W) float32 metres, F divisible by `chunk`.
    Returns:
      poses (F, 4, 4) world←cam, promote flags (F,), inlier fractions (F,).
    """
    F = depths.shape[0]
    if F % chunk:
        raise ValueError(f"frames ({F}) must be divisible by chunk ({chunk})")
    chunks = depths.reshape(F // chunk, chunk, *depths.shape[1:])

    def outer(carry, depth_chunk):
        kf_packed, T_world_kf, T_kf_cam, last_delta = carry

        def inner(st: FrozenState, depth):
            pyr = preprocess(depth, K, cfg)
            T0 = st.T_kf_cam @ damped_velocity(st.last_delta, cfg.cv_damping)
            out = track_step_packed(kf_packed, pyr, K, T0, cfg)
            new_st = FrozenState(
                T_kf_cam=out.T_kf_cam,
                last_delta=se3.relative(st.T_kf_cam, out.T_kf_cam),
            )
            return new_st, (out.T_kf_cam, out.promote,
                            out.icp.inlier_fraction)

        st_end, (rels, promotes, inliers) = jax.lax.scan(
            inner, FrozenState(T_kf_cam=T_kf_cam, last_delta=last_delta),
            depth_chunk)
        world = jnp.einsum("ij,fjk->fik", T_world_kf, rels)
        any_promote = jnp.any(promotes)

        # Promote the LAST frame of the chunk: the carry reset is EXACT
        # (identity, no relative-pose computation) — re-anchoring on a
        # mid-chunk frame injects ~1e-7 of f32 inversion noise per
        # promotion which the nearest-pixel deadband amplifies ~2×/frame
        # (see scan_superchunk_frozen).
        def promote_branch():
            return pack_pyramid(preprocess(depth_chunk[-1], K, cfg),
                                cfg.icp)

        new_packed = jax.lax.cond(any_promote, promote_branch,
                                  lambda: kf_packed)
        new_T_world_kf = jnp.where(any_promote, world[-1], T_world_kf)
        new_T_kf_cam = jnp.where(any_promote, jnp.eye(4, dtype=rels.dtype),
                                 st_end.T_kf_cam)
        new_carry = (new_packed, new_T_world_kf, new_T_kf_cam,
                     st_end.last_delta)
        return new_carry, (world, promotes, inliers)

    pyr0 = preprocess(depths[0], K, cfg)
    init = (pack_pyramid(pyr0, cfg.icp), jnp.eye(4), jnp.eye(4), jnp.eye(4))
    _, (poses, promotes, inliers) = jax.lax.scan(outer, init, chunks)
    return (poses.reshape(F, 4, 4), promotes.reshape(F),
            inliers.reshape(F))


@partial(jax.jit, static_argnames=("cfg", "chunk"))
def scan_odometry_boundary_jit(depths, K, cfg: SLAMConfig, chunk: int = 8):
    return scan_odometry_boundary(depths, K, cfg, chunk)
