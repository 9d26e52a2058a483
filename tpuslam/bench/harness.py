"""Benchmark harness (SURVEY.md §2b N17, §3.5).

Measures the BASELINE.json-pinned metrics:
  * ICP frames/s/chip — full frame-to-keyframe odometry throughput via the
    all-on-device `lax.scan` path (decode excluded: the reference metric is
    ICP throughput, and the host loader is benchmarked separately),
  * per-ICP-iteration latency,
  * multi-device scaling efficiency of the point-sharded SPMD ICP.

Depth input is the synthetic ray-traced scene at TUM resolution — identical
compute shape to a real sequence (the ICP cost is data-independent: static
shapes, masked reductions).
"""

from __future__ import annotations

import time

import numpy as np


def device_record() -> dict:
    """Platform, kind and count of the attached devices, as JAX reports
    them.  Every number the harness reports is a device number, so it
    refuses to run without a GPU instead of timing the CPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(
            f"the benchmark needs a GPU; JAX found {devs[0].platform!r}")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def _render_sequence(frames: int, height: int, width: int):
    from tpuslam.config import Intrinsics
    from tpuslam.data.synthetic import orbit_trajectory, render_depth

    K = Intrinsics(
        525.0 * width / 640.0,
        525.0 * height / 480.0,
        width / 2 - 0.5,
        height / 2 - 0.5,
    )
    poses = orbit_trajectory(frames)
    depths = np.stack(
        [render_depth(poses[i], K, height, width, seed=i) for i in range(frames)]
    )
    return K, poses, depths.astype(np.float32)


def bench_loader(height: int, width: int, frames: int = 40) -> dict:
    """Decode throughput of the host TUM pipeline (SURVEY.md §7 Stage 7:
    the loader must not bottleneck the device at 60+ fps)."""
    import tempfile

    from tpuslam.config import Intrinsics
    from tpuslam.data.synthetic import write_tum_sequence
    from tpuslam.data.tum import TumSequence, _tum_native

    with tempfile.TemporaryDirectory() as root:
        K = Intrinsics(525.0, 525.0, width / 2 - 0.5, height / 2 - 0.5)
        write_tum_sequence(root, frames, K, height, width)
        seq = TumSequence(root, depth_cache=False)
        # warm the page cache
        for f in seq.frames():
            pass
        t0 = time.perf_counter()
        n = 0
        for f in seq.frames():
            n += 1
        wall = time.perf_counter() - t0
        # decode-once sidecar path (VERDICT r3 #5): first full pass of a
        # cache-enabled sequence publishes raw f32 depth; repeat runs
        # memmap-stream it, bypassing PNG decode entirely
        seq_c = TumSequence(root)
        for f in seq_c.frames():       # build + publish
            pass
        t0 = time.perf_counter()
        nc = 0
        for f in TumSequence(root).frames():
            nc += 1
        wall_c = time.perf_counter() - t0
    return {
        "decode_fps": n / wall,
        "cached_fps": nc / wall_c,
        "native": _tum_native is not None,
    }


def bench_slam(frames: int = 120, height: int = 480, width: int = 640,
               cfg=None, cycles: int = 2) -> dict:
    """Full-SYSTEM throughput: SlamSystem.process (tracking + keyframe graph
    + loop-closure verify + pose-graph optimization), async backend off/on.

    The headline scan_odometry number is pure device tracking throughput;
    this measures what a user of `run_slam` actually gets — including the
    host-driven dispatch latency and the backend work.  `async_gain`
    quantifies the PP analogue (SURVEY.md §2c): backend verification/optimization overlapped
    with tracking in a worker thread vs inline.
    """
    import jax

    from tpuslam.config import Intrinsics, SLAMConfig
    from tpuslam.data.synthetic import loop_trajectory, render_depth
    from tpuslam.eval.ate import ate_rmse
    from tpuslam.slam import SlamSystem

    import dataclasses

    if cfg is None:
        cfg = SLAMConfig()
    # the 2-lap loop promotes ~15 keyframes per lap — the default
    # lc_min_gap=20 would gate every revisit and the "with loop closure"
    # claim would silently measure a closure-free run
    cfg = cfg.replace(
        height=height, width=width,
        posegraph=dataclasses.replace(cfg.posegraph, lc_min_gap=8))
    K = Intrinsics(
        525.0 * width / 640.0, 525.0 * height / 480.0,
        width / 2 - 0.5, height / 2 - 0.5,
    )
    gt = loop_trajectory(frames, cycles=cycles, radius=0.35)
    depths = np.stack(
        [render_depth(gt[i], K, height, width, seed=i) for i in range(frames)]
    ).astype(np.float32)

    import jax.numpy as jnp

    # Input-boundary discipline: the system is measured on DEVICE-RESIDENT
    # depth (same boundary as the scan-odometry headline).  Host→device
    # depth transfer is an independently-measured stage, reported as
    # `upload_fps_equiv`.
    t0 = time.perf_counter()
    dev = jax.block_until_ready(jnp.asarray(depths))
    upload_s = time.perf_counter() - t0
    handles = [dev[i] for i in range(frames)]
    jax.block_until_ready(handles)
    ts_all = np.arange(frames) / 30.0

    def one_pass(async_backend: bool) -> tuple[float, object]:
        slam = SlamSystem(K, cfg, enable_loop_closure=True,
                          async_backend=async_backend)
        t0 = time.perf_counter()
        for i, d in enumerate(handles):
            slam.process(d, timestamp=ts_all[i])
        slam.finalize()
        return time.perf_counter() - t0, slam

    def one_pass_chunked(chunk: int, async_backend: bool,
                         chunk_mode: str = "boundary") -> tuple[float, object]:
        # device-side chunked streaming (VERDICT r3 #1): one dispatch + one
        # readback per CHUNK of frames instead of per frame — the host-loop
        # dispatch floor amortizes over `chunk` frames.  "boundary" mode
        # (the production default, VERDICT r4 #1) tracks each chunk against a frozen
        # keyframe (no tables in the scan carry) and runs at most ONE
        # fused verify+optimize attempt per chunk; with async_backend the
        # attempt's readback rides the next chunk's scan sync (the
        # deferred deterministic backend — VERDICT r4 #4/#5).  "inline"
        # is the legacy per-frame-parity path (threaded async worker).
        # chunk_sub=4 ≈ this loop's per-frame promotion cadence (the
        # default floor of 8 would halve the keyframe count and starve
        # the lc_min_gap=8 proposal gate — closures 20 → 5, measured)
        slam = SlamSystem(K, cfg, enable_loop_closure=True,
                          async_backend=async_backend, chunk_mode=chunk_mode,
                          chunk_sub=4)
        t0 = time.perf_counter()
        for i in range(0, frames - frames % chunk, chunk):
            slam.process_chunk(dev[i:i + chunk], ts_all[i:i + chunk])
        for i in range(frames - frames % chunk, frames):
            slam.process(dev[i], timestamp=ts_all[i])
        slam.finalize()
        return time.perf_counter() - t0, slam

    def best_of(fn, reps: int = 3):
        # Best-of-N like the odometry headline; all reps are reported.
        walls, best = [], None
        for _ in range(reps):
            w, s = fn()
            if not walls or w < min(walls):
                best = s
            walls.append(w)
        return min(walls), best, [round(frames / w, 1) for w in walls]

    chunk = 8
    # one uncounted pass per variant: compiles (scan flavors, attempt batch
    # buckets, fuse shapes) must not land inside timed reps
    one_pass(False)
    one_pass_chunked(chunk, False, "inline")
    one_pass_chunked(chunk, False, "boundary")
    one_pass_chunked(chunk, True, "boundary")
    wall_sync, slam, reps_sync = best_of(lambda: one_pass(False))
    wall_async, _, reps_async = best_of(lambda: one_pass(True))
    wall_chunked, slam_c, reps_c = best_of(
        lambda: one_pass_chunked(chunk, False, "boundary"), reps=5)
    wall_chunked_a, slam_ca, reps_ca = best_of(
        lambda: one_pass_chunked(chunk, True, "boundary"), reps=5)
    wall_inline, slam_ci, reps_ci = best_of(
        lambda: one_pass_chunked(chunk, False, "inline"))

    def _ate(s):
        t, est = s.trajectory()
        return ate_rmse(t, est, np.arange(frames) / 30.0, gt,
                        max_difference=0.005)["rmse"]

    return {
        "slam_fps": frames / wall_sync,
        "slam_fps_async": frames / wall_async,
        "async_gain": wall_sync / wall_async,
        "slam_fps_chunked": frames / wall_chunked,
        "slam_fps_chunked_async": frames / wall_chunked_a,
        "slam_fps_chunked_inline": frames / wall_inline,
        "slam_fps_reps": {"sync": reps_sync, "async": reps_async,
                          "chunked": reps_c, "chunked_async": reps_ca,
                          "chunked_inline": reps_ci},
        "upload_fps_equiv": frames / upload_s,
        "chunk": chunk,
        "slam_ate_rmse_m": _ate(slam),
        "slam_chunked_ate_rmse_m": _ate(slam_c),
        "slam_chunked_async_ate_rmse_m": _ate(slam_ca),
        "slam_chunked_inline_ate_rmse_m": _ate(slam_ci),
        "loop_closures": len(slam.closures),
        "loop_closures_chunked": len(slam_c.closures),
        "loop_closures_chunked_async": len(slam_ca.closures),
        "loop_closures_chunked_inline": len(slam_ci.closures),
        "keyframes": len(slam.odo.keyframes),
        "keyframes_chunked": len(slam_c.odo.keyframes),
        "frames": frames,
    }


def bench_scale(frames: int = 2000, height: int = 240, width: int = 320,
                chunk: int = 32, chunk_mode: str = "boundary",
                async_backend: bool = True, chunk_sub: int = 1) -> dict:
    # Default chunk=32: closure count tracks attempt frequency while ATE
    # stays flat (closures beyond coverage are redundant), so the default
    # takes the throughput end.
    """BASELINE config-5 SCALE on the real device (VERDICT r3 item 3).

    The 2,000-frame capacity proof (tests/test_config5_scale.py) has only
    ever run on the fake CPU mesh; this pushes the same multi-lap loop —
    tight promotion thresholds, deliberately tiny initial graph capacity
    so node storage must double repeatedly, cloud sparsification under
    budget — through the production `SlamSystem` chunked path on whatever
    backend is attached, and reports the capacity/closure/ATE outcomes
    next to throughput.  Uses SlamSystem directly on pre-rendered depths
    (the run_slam CLI adds only PNG decode, benchmarked separately).
    """
    import dataclasses
    import time as _time

    from tpuslam.config import (
        Intrinsics,
        KeyframeConfig,
        PoseGraphConfig,
        SLAMConfig,
        VoxelConfig,
    )
    from tpuslam.data.synthetic import loop_trajectory, render_depth
    from tpuslam.eval.ate import ate_rmse
    from tpuslam.slam import SlamSystem

    device = device_record()
    K = Intrinsics(
        525.0 * width / 640.0, 525.0 * height / 480.0,
        width / 2 - 0.5, height / 2 - 0.5,
    )
    cfg = SLAMConfig(
        height=height, width=width,
        keyframe=KeyframeConfig(max_translation=0.015, max_rotation=0.03,
                                max_keyframes=48, sparsify_protect_recent=4),
        posegraph=PoseGraphConfig(max_nodes=32, max_edges=64, gn_iters=15,
                                  solver="auto", dense_max_nodes=256,
                                  lc_min_gap=20, lc_max_dist=0.08,
                                  lc_max_residual=0.05, lc_min_inliers=0.3),
        voxel=VoxelConfig(capacity=1 << 12, map_capacity=1 << 15),
    )
    gt = loop_trajectory(frames, cycles=5)
    render_t0 = _time.perf_counter()
    depths = np.stack([
        render_depth(gt[i], K, height, width, seed=i) for i in range(frames)
    ]).astype(np.float32)
    render_s = _time.perf_counter() - render_t0

    import jax
    import jax.numpy as jnp

    # Boundary chunk mode + the deferred backend are the defaults: the
    # deferred pipeline folds each attempt's readback into the next chunk's
    # scan sync and coalesces a chunk's promotions into ONE attempt.
    # chunk_sub=1 keeps the PER-FRAME promotion cadence (this config's
    # tight thresholds promote every ~5 frames — a cadence floor of 8
    # would under-promote, starve the lc_min_gap=20 proposal gate, and
    # let drift run uncorrected; measured round 5).
    slam = SlamSystem(K, cfg, enable_loop_closure=True,
                      chunk_mode=chunk_mode, async_backend=async_backend,
                      chunk_sub=chunk_sub)
    dev = jax.block_until_ready(jnp.asarray(depths))  # device-resident input
    ts_all = np.arange(frames) / 30.0
    t0 = _time.perf_counter()
    for i in range(0, frames - frames % chunk, chunk):
        slam.process_chunk(dev[i:i + chunk], ts_all[i:i + chunk])
    for i in range(frames - frames % chunk, frames):
        slam.process(dev[i], timestamp=ts_all[i])
    slam.finalize()
    wall = _time.perf_counter() - t0
    ts, est = slam.trajectory()
    m = ate_rmse(ts, est, ts_all, gt, max_difference=0.005)
    retained = sum(1 for r in slam.odo.keyframes if r.cloud is not None)
    return {
        "device": device,
        "frames": frames,
        "resolution": [height, width],
        "chunk_mode": chunk_mode,
        "async_backend": async_backend,
        "fps": frames / wall,
        "wall_s": wall,
        "render_s": render_s,
        "graph_nodes": slam._num_graph_nodes,
        "node_capacity": int(slam.graph._poses.shape[0])
        if hasattr(slam.graph, "_poses") else None,
        "keyframes": len(slam.odo.keyframes),
        "retained_clouds": retained,
        "loop_closures": len(slam.closures),
        "ate_rmse_m": m["rmse"],
        "lost_frames": sum(1 for s in slam.odo.stats if s.get("lost")),
    }


def bench_pathology(frames: int = 60, height: int = 480,
                    width: int = 640) -> dict:
    """VGA sensor-pathology smoke on the real device (VERDICT r3 item 7).

    The Kinect z²-noise / dropout-hole / rotation-burst fixtures
    (tests/test_pathology.py) run at 120×160 on CPU; this promotes them to
    full 640×480 production shapes: degraded odometry throughput, ATE and
    loss count on the attached backend.
    """
    import time as _time

    import jax
    import jax.numpy as jnp

    from tpuslam.config import Intrinsics, SLAMConfig
    from tpuslam.data.synthetic import (
        burst_trajectory,
        degrade_depth,
        render_depth,
    )
    from tpuslam.eval.ate import ate_rmse
    from tpuslam.slam import SlamSystem

    KINECT_NOISE = 0.0019
    device = device_record()
    K = Intrinsics(
        525.0 * width / 640.0, 525.0 * height / 480.0,
        width / 2 - 0.5, height / 2 - 0.5,
    )
    cfg = SLAMConfig(height=height, width=width)
    gt = burst_trajectory(frames, burst_start=frames // 2, burst_len=8,
                          burst_rate=0.05)
    depths = np.stack([
        degrade_depth(render_depth(gt[i], K, height, width, seed=i),
                      seed=100 + i, z_noise_coeff=KINECT_NOISE,
                      dropout_holes=3, edge_dropout=0.02)
        for i in range(frames)
    ]).astype(np.float32)

    chunk = 8
    dev = jax.block_until_ready(jnp.asarray(depths))  # device-resident input
    ts_all = np.arange(frames) / 30.0

    def run():
        # boundary chunk mode — the production default; a burst chunk that
        # degrades to LOST replays per-frame with inline semantics
        slam = SlamSystem(K, cfg, enable_loop_closure=True,
                          chunk_mode="boundary", async_backend=True)
        t0 = _time.perf_counter()
        # chunked streaming; a chunk reporting tracking loss automatically
        # replays per-frame so relocalization semantics are unchanged
        for i in range(0, frames - frames % chunk, chunk):
            slam.process_chunk(dev[i:i + chunk], ts_all[i:i + chunk])
        for i in range(frames - frames % chunk, frames):
            slam.process(dev[i], timestamp=ts_all[i])
        slam.finalize()
        return _time.perf_counter() - t0, slam

    run()                                         # compile warmup
    wall, slam = run()
    ts, est = slam.trajectory()
    m = ate_rmse(ts, est, ts_all, gt, max_difference=0.005)
    return {
        "device": device,
        "frames": frames,
        "resolution": [height, width],
        "fps": frames / wall,
        "ate_rmse_m": m["rmse"],
        "lost_frames": sum(1 for s in slam.odo.stats if s.get("lost")),
        "loop_closures": len(slam.closures),
    }


def run_bench(frames: int = 120, height: int = 480, width: int = 640,
              config_path: str | None = None, devices: int | None = None,
              warmup: int = 1, slam_frames: int | None = 120) -> dict:
    import jax
    import jax.numpy as jnp

    from tpuslam.config import SLAMConfig
    from tpuslam.frontend import scan_odometry_jit
    from tpuslam.icp import align_frames_jit, build_pyramid
    from tpuslam.frontend import preprocess_jit

    device = device_record()
    if config_path:
        with open(config_path) as f:
            cfg = SLAMConfig.from_json(f.read())
    else:
        cfg = SLAMConfig()
    cfg = cfg.replace(height=height, width=width)

    K, _poses, depths_np = _render_sequence(frames, height, width)
    depths = jnp.asarray(depths_np)
    jax.block_until_ready(depths)

    result: dict = {
        "device": device,
        "frames": frames,
        "resolution": [height, width],
    }

    # --- full-sequence odometry throughput (the headline number) ---
    t0 = time.perf_counter()
    out = scan_odometry_jit(depths, K, cfg)
    jax.block_until_ready(out)
    result["compile_plus_first_run_s"] = time.perf_counter() - t0
    for _ in range(warmup):
        jax.block_until_ready(scan_odometry_jit(depths, K, cfg))
    # Best-of-3; all reps are reported.
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = scan_odometry_jit(depths, K, cfg)
        jax.block_until_ready(out)
        walls.append(time.perf_counter() - t0)
    wall = min(walls)
    result["fps_per_chip"] = frames / wall
    result["ms_per_frame"] = wall / frames * 1e3
    result["fps_reps"] = [round(frames / w, 1) for w in walls]

    # accuracy guard on the same run: ATE vs the synthetic ground truth —
    # a perf number from a diverged tracker is meaningless
    from tpuslam.eval.ate import ate_rmse

    ts = np.arange(frames, dtype=np.float64)
    m = ate_rmse(ts, np.asarray(out[0]), ts, np.asarray(_poses))
    result["ate_rmse_m"] = m["rmse"]

    # --- boundary-promotion scan (VERDICT r4 #1): same odometry, keyframe
    # tables held in the OUTER chunk-level carry instead of selected per
    # frame — measured against the classic scan with its own ATE guard;
    # the headline is whichever passing variant is faster ---
    from tpuslam.frontend import scan_odometry_boundary_jit

    bchunk = 8
    fb = frames - frames % bchunk       # trim to a whole number of chunks
    depths_b = depths[:fb]
    jax.block_until_ready(
        scan_odometry_boundary_jit(depths_b, K, cfg, bchunk))
    walls_b = []
    for _ in range(3):
        t0 = time.perf_counter()
        out_b = scan_odometry_boundary_jit(depths_b, K, cfg, bchunk)
        jax.block_until_ready(out_b)
        walls_b.append(time.perf_counter() - t0)
    wall_b = min(walls_b)
    result["fps_per_chip_boundary"] = fb / wall_b
    result["ms_per_frame_boundary"] = wall_b / fb * 1e3
    result["fps_reps_boundary"] = [round(fb / w, 1) for w in walls_b]
    m_b = ate_rmse(ts[:fb], np.asarray(out_b[0]), ts[:fb],
                   np.asarray(_poses)[:fb])
    result["ate_rmse_m_boundary"] = m_b["rmse"]
    # headline selection: fastest variant whose ATE stays at the noise
    # floor (≤ 1 mm on this clean synthetic orbit — both sit ~3e-5)
    if m_b["rmse"] < 1e-3 and (m["rmse"] >= 1e-3
                               or wall_b / fb < wall / frames):
        result["headline_variant"] = "boundary"
        result["fps_headline"] = result["fps_per_chip_boundary"]
    else:
        result["headline_variant"] = "classic"
        result["fps_headline"] = result["fps_per_chip"]

    # --- per-ICP-iteration latency: run a fixed 50-iteration finest-level
    # alignment in ONE dispatch so the dispatch overhead amortizes ---
    pyr_a = preprocess_jit(depths[0], K, cfg)
    pyr_b = preprocess_jit(depths[1], K, cfg)
    import dataclasses

    iter_loops = 50
    one_level_cfg = dataclasses.replace(
        cfg.icp, pyramid_levels=1, iters_per_level=(iter_loops,),
        tol_delta=0.0,
    )
    pa1, pb1 = (pyr_a[0],), (pyr_b[0],)
    T0 = jnp.eye(4)
    jax.block_until_ready(align_frames_jit(pb1, pa1, K, T0, one_level_cfg))
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        r = align_frames_jit(pb1, pa1, K, T0, one_level_cfg)
    jax.block_until_ready(r)
    result["icp_iter_latency_ms"] = (
        (time.perf_counter() - t0) / reps / iter_loops * 1e3
    )

    # --- host loader throughput (PNG decode must outrun the tracker) ---
    result["loader"] = bench_loader(height=height, width=width, frames=40)

    # --- full SLAM system throughput + async-backend delta (VERDICT r2
    # weak #7/#8: the PP-overlap claim and system-level fps, measured) ---
    if slam_frames:
        result["slam"] = bench_slam(frames=slam_frames, height=height,
                                    width=width, cfg=cfg)

    # --- multi-device scaling (only when >1 device is attached) ---
    n_dev = len(jax.devices()) if devices is None else devices
    if n_dev > 1:
        from tpuslam.dist.mesh import make_mesh
        from tpuslam.dist.sharded_icp import make_aligned_spmd_fn

        pyr_a_full = tuple(build_pyramid(pyr_a[0], cfg.icp.pyramid_levels))
        pyr_b_full = tuple(build_pyramid(pyr_b[0], cfg.icp.pyramid_levels))
        mesh = make_mesh(n_dev)
        fn = make_aligned_spmd_fn(mesh, cfg.icp)
        jax.block_until_ready(fn(pyr_b_full, pyr_a_full, K, T0))
        t0 = time.perf_counter()
        for _ in range(reps):
            r = fn(pyr_b_full, pyr_a_full, K, T0)
        jax.block_until_ready(r)
        sharded_ms = (time.perf_counter() - t0) / reps * 1e3
        jax.block_until_ready(
            align_frames_jit(pyr_b_full, pyr_a_full, K, T0, cfg.icp))
        t0 = time.perf_counter()
        for _ in range(reps):
            r = align_frames_jit(pyr_b_full, pyr_a_full, K, T0, cfg.icp)
        jax.block_until_ready(r)
        single_ms = (time.perf_counter() - t0) / reps * 1e3
        result["spmd_align_ms"] = sharded_ms
        result["single_align_ms"] = single_ms
        result["scaling_efficiency"] = single_ms / (sharded_ms * n_dev)
        result["n_devices"] = n_dev
    return result
