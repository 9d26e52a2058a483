"""Sequence odometry tests on the synthetic rendered scene.

BASELINE.json config 3 analogue (full-sequence frame-to-keyframe odometry +
ATE RMSE) — run on the ray-traced fixture instead of TUM fr1/desk since the
dataset can't be downloaded in CI (SURVEY.md §4).
"""

import jax.numpy as jnp
import numpy as np

from tpuslam.config import ICPConfig, Intrinsics, KeyframeConfig, SLAMConfig
from tpuslam.data.synthetic import orbit_trajectory, render_depth
from tpuslam.eval.ate import ate_rmse
from tpuslam.frontend import Odometry, scan_odometry_jit

K = Intrinsics(160.0, 160.0, 79.5, 59.5)
H, W = 120, 160
NUM_FRAMES = 12

CFG = SLAMConfig(
    height=H,
    width=W,
    icp=ICPConfig(pyramid_levels=3, iters_per_level=(12, 8, 8),
                  max_corr_dist=0.25, huber_delta=0.05),
    keyframe=KeyframeConfig(max_translation=0.10, max_rotation=0.15),
)


def render_sequence(num_frames=NUM_FRAMES, noise=0.0):
    poses = orbit_trajectory(num_frames)
    depths = np.stack(
        [render_depth(poses[i], K, H, W, noise=noise, seed=i)
         for i in range(num_frames)]
    )
    return poses, depths


def check_trajectory(gt_poses, est_poses, tol_rmse):
    ts = np.arange(len(gt_poses)) / 30.0
    metrics = ate_rmse(ts, est_poses, ts, gt_poses, max_difference=0.005)
    assert metrics["rmse"] < tol_rmse, metrics
    return metrics


def test_host_odometry_tracks_sequence():
    gt, depths = render_sequence()
    odo = Odometry(K, CFG)
    for i in range(len(depths)):
        odo.process(depths[i], timestamp=i / 30.0)
    est = np.stack(odo.trajectory)
    m = check_trajectory(gt, est, tol_rmse=0.01)
    assert len(odo.keyframes) >= 1
    assert all(s.get("lost", False) is False for s in odo.stats[1:])


def test_scan_odometry_matches_host():
    gt, depths = render_sequence()
    poses, promotes, inliers = scan_odometry_jit(jnp.asarray(depths), K, CFG)
    est = np.asarray(poses)
    check_trajectory(gt, est, tol_rmse=0.01)
    assert np.all(np.asarray(inliers)[1:] > 0.3)


def test_decimate2_matches_strided_slice():
    """Each pyramid level backprojects the stride-2^l decimated depth with
    the scaled intrinsics — NaN pixels included: they stay invalid at every
    level, and their points are zeroed rather than carried."""
    from tpuslam.frontend import preprocess
    from tpuslam.geom.backproject import backproject

    _, depths = render_sequence(num_frames=1)
    d = depths[0].copy()
    d[10:14, 20:30] = np.nan
    d[50, 80] = np.nan
    pyr = preprocess(jnp.asarray(d), K, CFG)
    for li, lvl in enumerate(pyr):
        s = 2 ** li
        d_l = d[::s, ::s]
        pts, mask = backproject(jnp.asarray(d_l), K.scaled(1.0 / s),
                                depth_min=CFG.icp.depth_min,
                                depth_max=CFG.icp.depth_max)
        np.testing.assert_array_equal(np.asarray(lvl.points),
                                      np.asarray(pts))
        assert not np.asarray(lvl.mask)[np.isnan(d_l)].any()
        assert np.isfinite(np.asarray(lvl.points)).all()
        assert np.asarray(lvl.mask).sum() > 0.5 * d_l.size


def test_raw_uint16_upload_bit_equals_f32(tmp_path=None):
    """--upload-raw (VERDICT r4 #3): shipping RAW uint16 depth counts and
    dividing by depth_scale ON DEVICE must be BIT-EQUAL to uploading the
    host-divided f32 depth — both perform the identical IEEE f32 divide,
    so unlike --upload-f16 there is zero quantization at half the
    transfer size."""
    import dataclasses

    poses, depths = render_sequence()
    scale = 5000.0
    raw = np.round(depths * scale).astype(np.uint16)      # TUM PNG counts
    host_divided = raw.astype(np.float32) / scale         # loader's path
    cfg = dataclasses.replace(CFG, depth_scale=scale)
    out_f32 = scan_odometry_jit(jnp.asarray(host_divided), K, cfg)
    out_u16 = scan_odometry_jit(jnp.asarray(raw), K, cfg)
    np.testing.assert_array_equal(np.asarray(out_f32[0]),
                                  np.asarray(out_u16[0]))


def test_boundary_scan_matches_classic():
    """scan_odometry_boundary (VERDICT r4 #1): the two-level scan with
    frozen-keyframe chunks and boundary promotion must track the same
    trajectory as the per-frame-promotion scan to ATE noise."""
    from tpuslam.frontend import scan_odometry_boundary_jit

    gt, depths = render_sequence(num_frames=16)
    p_classic, _, _ = scan_odometry_jit(jnp.asarray(depths), K, CFG)
    p_boundary, _, inl = scan_odometry_boundary_jit(
        jnp.asarray(depths), K, CFG, 8)
    check_trajectory(gt, np.asarray(p_classic), tol_rmse=0.01)
    check_trajectory(gt, np.asarray(p_boundary), tol_rmse=0.01)
    assert np.all(np.asarray(inl)[1:] > 0.3)
    d = np.linalg.norm(
        np.asarray(p_boundary)[:, :3, 3] - np.asarray(p_classic)[:, :3, 3],
        axis=-1)
    assert d.max() < 5e-3, d.max()


def test_f16_depth_upload_tracks_sequence():
    """Reduced-precision depth INPUT (the --upload-f16 bandwidth feature):
    all math stays f32, so tracking must hold with only a quantization-
    level ATE penalty (f16 ≈ 1.5 mm at 3 m depth)."""
    poses, depths = render_sequence()
    out_f32 = scan_odometry_jit(jnp.asarray(depths, jnp.float32), K, CFG)
    out_f16 = scan_odometry_jit(jnp.asarray(depths, jnp.float16), K, CFG)
    ts = np.arange(len(poses)) / 30.0
    m32 = ate_rmse(ts, np.asarray(out_f32[0]), ts, np.asarray(poses),
                   max_difference=0.005)
    m16 = ate_rmse(ts, np.asarray(out_f16[0]), ts, np.asarray(poses),
                   max_difference=0.005)
    assert m16["rmse"] < max(5e-3, 10 * m32["rmse"]), (m16, m32)
