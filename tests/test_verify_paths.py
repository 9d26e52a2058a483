"""Backend verification plumbing (backend/verify.py) and its edge cases:
gate semantics, the projective/grid fallback on mixed retained tables, and
NaN depth containment in the pyramid that verification tables come from."""

import dataclasses

import jax.numpy as jnp
import numpy as np

from tpuslam.backend.verify import COVERAGE_COL, ROW_SIZE, passes_gates
from tpuslam.config import PoseGraphConfig
from tpuslam.icp import FlatICP


def _good_row(pg: PoseGraphConfig) -> np.ndarray:
    row = np.zeros((ROW_SIZE,), np.float32)
    row[FlatICP.T] = np.eye(4, dtype=np.float32).reshape(16)
    row[FlatICP.CONVERGED] = 1.0
    row[FlatICP.RMS] = pg.lc_max_residual * 0.5
    row[FlatICP.INLIER_FRACTION] = pg.lc_min_inliers + 0.1
    row[FlatICP.NUM_INLIERS] = 500.0
    row[COVERAGE_COL] = pg.lc_min_normal_coverage * 2
    return row


def test_each_gate_rejects_independently():
    pg = PoseGraphConfig()
    assert passes_gates(_good_row(pg), pg)
    for col, bad in (
        (FlatICP.CONVERGED, 0.0),
        (FlatICP.RMS, pg.lc_max_residual * 2),
        (FlatICP.INLIER_FRACTION, pg.lc_min_inliers * 0.5),
        (COVERAGE_COL, pg.lc_min_normal_coverage * 0.5),
    ):
        row = _good_row(pg)
        row[col] = bad
        assert not passes_gates(row, pg), col
    row = _good_row(pg)
    row[0] = np.nan            # non-finite pose
    assert not passes_gates(row, pg)


def test_mixed_verify_tables_fall_back_to_grid(monkeypatch):
    """Records whose retained tables differ in level/shape (e.g. restored
    from a checkpoint written under another verify_level) must take the
    grid path — never stack ragged tables or mis-scale intrinsics."""
    import tpuslam.backend.loopclosure as lc
    from tests.test_slam import CFG, H, K, W, loop_trajectory
    from tpuslam.data.synthetic import render_depth
    from tpuslam.slam import SlamSystem

    n = 14
    gt = loop_trajectory(30)[:n]
    depths = np.stack([render_depth(gt[i], K, H, W, seed=i)
                       for i in range(n)])
    slam = SlamSystem(K, CFG, enable_loop_closure=False)
    for i in range(n):
        slam.process(depths[i], timestamp=i / 30.0)
    kfs = slam.odo.keyframes
    assert len(kfs) >= 4 and all(r.verify is not None for r in kfs)

    calls = {"grid": 0, "proj": 0}
    real_grid = lc._verify_pairs_jit
    real_proj = lc._verify_projective_pairs_jit
    monkeypatch.setattr(lc, "_verify_pairs_jit", lambda *a, **k: (
        calls.__setitem__("grid", calls["grid"] + 1), real_grid(*a, **k))[1])
    monkeypatch.setattr(
        lc, "_verify_projective_pairs_jit", lambda *a, **k: (
            calls.__setitem__("proj", calls["proj"] + 1),
            real_proj(*a, **k))[1])

    pg = dataclasses.replace(CFG.posegraph, lc_min_gap=1, lc_max_dist=2.0)
    poses = [r.T_world_kf.astype(np.float64) for r in kfs]

    # uniform tables → projective path
    lc.find_closures(kfs, poses, CFG.icp, pg, K=K)
    assert calls["proj"] == 1 and calls["grid"] == 0

    # corrupt one candidate's table meta → grid fallback, no crash
    v = kfs[0].verify
    kfs[0] = kfs[0]._replace(verify=v._replace(level=v.level + 1))
    lc.find_closures(kfs, poses, CFG.icp, pg, K=K)
    assert calls["grid"] == 1

    # missing K → grid fallback
    lc.find_closures(kfs, poses, CFG.icp, pg, K=None)
    assert calls["grid"] == 2


def test_mxu_decimation_contains_nan():
    """A NaN depth pixel must not poison its neighbours at any pyramid
    level: normals stay finite everywhere, and outside the NaN pixel's
    3×3 neighbourhood the valid set equals the clean frame's."""
    from tests.test_slam import CFG, H, K, W
    from tpuslam.data.synthetic import render_depth
    from tpuslam.frontend import preprocess

    d = render_depth(np.eye(4), K, H, W, seed=0)
    bad = d.copy()
    bad[40, 60] = np.nan              # even indices: survives decimation
    clean = preprocess(jnp.asarray(d), K, CFG)
    dirty = preprocess(jnp.asarray(bad), K, CFG)
    for li, (c, f) in enumerate(zip(clean, dirty)):
        assert np.isfinite(np.asarray(f.normals)).all()
        r, k = 40 >> li, 60 >> li
        keep = np.ones(np.asarray(f.mask).shape, bool)
        keep[r - 1:r + 2, k - 1:k + 2] = False
        assert not np.asarray(f.mask)[r, k]
        np.testing.assert_array_equal(np.asarray(f.mask)[keep],
                                      np.asarray(c.mask)[keep])


def test_traced_gates_match_host_gates(rng):
    """passes_gates_traced must make the same decision as passes_gates on
    every row — the fused verify+optimize dispatch weights candidate edges
    by the traced mask and the host mirrors it from the readback."""
    from tpuslam.backend.verify import passes_gates_traced

    pg = PoseGraphConfig()
    rows = []
    rows.append(_good_row(pg))
    for col, bad in (
        (FlatICP.CONVERGED, 0.0),
        (FlatICP.RMS, pg.lc_max_residual * 2),
        (FlatICP.INLIER_FRACTION, pg.lc_min_inliers * 0.5),
        (COVERAGE_COL, pg.lc_min_normal_coverage * 0.5),
        (3, np.nan),
        (7, np.inf),
    ):
        r = _good_row(pg)
        r[col] = bad
        rows.append(r)
    # knife-edge: exactly at the thresholds (host uses <=/>=)
    r = _good_row(pg)
    r[FlatICP.RMS] = pg.lc_max_residual
    r[FlatICP.INLIER_FRACTION] = pg.lc_min_inliers
    r[COVERAGE_COL] = pg.lc_min_normal_coverage
    rows.append(r)
    mat = np.stack(rows).astype(np.float32)
    traced = np.asarray(passes_gates_traced(jnp.asarray(mat), pg))
    host = np.asarray([passes_gates(r, pg) for r in mat], np.float32)
    np.testing.assert_array_equal(traced, host)


def test_fused_attempt_race_falls_back_to_fresh_solve(monkeypatch):
    """If the graph grows between the fused attempt's snapshot and its
    application (async tracking), the stale bucketed poses must NOT be
    applied — the attempt re-solves on the current graph instead, so the
    concurrently-added node keeps a real pose."""
    import jax

    # Compiling the (large) fused-attempt program on top of the FULL
    # suite's accumulated in-process executables segfaulted XLA:CPU twice
    # at exactly this point (passes standalone and in every half-suite
    # bisect — a cumulative-state native crash, not a logic failure).
    # Start from a clean executable cache; only the cheap viz/voxel tests
    # follow, so the recompile cost is local.
    jax.clear_caches()
    from tpuslam.backend import posegraph as pg_mod
    from tpuslam.config import (
        ICPConfig,
        Intrinsics,
        KeyframeConfig,
        SLAMConfig,
        VoxelConfig,
    )
    from tpuslam.data.synthetic import loop_trajectory, render_depth
    from tpuslam.slam import SlamSystem

    K = Intrinsics(160.0, 160.0, 79.5, 59.5)
    cfg = SLAMConfig(
        height=120, width=160,
        keyframe=KeyframeConfig(max_translation=0.03, max_rotation=0.06),
        posegraph=dataclasses.replace(PoseGraphConfig(), lc_min_gap=3,
                                      lc_max_dist=0.6),
        voxel=VoxelConfig(capacity=1 << 12),
        icp=ICPConfig(),
    )
    n = 40
    gt = loop_trajectory(n, cycles=2, radius=0.35)
    depths = np.stack([render_depth(gt[i], K, 120, 160, seed=i)
                       for i in range(n)]).astype(np.float32)
    slam = SlamSystem(K, cfg, enable_loop_closure=False)
    for i in range(n):
        slam.process(depths[i], timestamp=i / 30.0)
    assert slam.graph.num_nodes >= 6
    slam.enable_loop_closure = True

    import tpuslam.backend.loopclosure as lc_mod

    orig_optimize = pg_mod.optimize
    orig_fused = lc_mod.fused_attempt_jit
    intruder_pose = np.eye(4, dtype=np.float32)
    intruder_pose[0, 3] = 7.0
    state = {"raced": False, "fallback_calls": 0}

    def racing_fused(*a, **kw):
        # simulate a concurrent promotion while the fused verify+solve is
        # in flight: the graph grows AFTER the snapshot was taken (with
        # its keyframe record, exactly as _sync_graph_with_keyframes
        # would).  The fused attempt is one dispatch, so the injection
        # point is the dispatch itself — after the live_nodes snapshot.
        if not state["raced"]:
            state["raced"] = True
            from tpuslam.frontend import KeyframeRecord

            slam.graph.add_node(intruder_pose)
            slam.odo.keyframes.append(KeyframeRecord(
                index=999, timestamp=99.0, T_world_kf=intruder_pose,
                cloud=None, verify=None))
            slam._num_graph_nodes += 1
        return orig_fused(*a, **kw)

    def counting_optimize(graph, cfg_, **kw):
        state["fallback_calls"] += 1
        return orig_optimize(graph, cfg_, **kw)

    import tpuslam.slam as slam_mod

    monkeypatch.setattr(lc_mod, "fused_attempt_jit", racing_fused)
    monkeypatch.setattr(slam_mod, "optimize", counting_optimize)
    found = slam._attempt_loop_closure()
    if found:
        # the guard must have re-solved on the grown graph...
        assert state["fallback_calls"] >= 1
    # ...and in every case the intruder node's pose must survive — a stale
    # bucketed set_poses would have overwritten it with padding (identity)
    got = slam.graph._poses[slam.graph.num_nodes - 1]
    np.testing.assert_allclose(got[0, 3], 7.0, atol=1e-4)
