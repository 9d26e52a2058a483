"""Command-line driver (SURVEY.md §2a R14, §2b N15, §3.1).

Reference status: C++ `main()` — parse args, run pipeline over a TUM
sequence, report fps + ATE (SURVEY.md §2a R14; provenance [B:2]).

Subcommands:
  run_odometry  — frame-to-keyframe visual odometry over a sequence
  run_slam      — odometry + pose graph + loop closure
  bench         — throughput/latency benchmark (SURVEY.md §3.5)
  make_synthetic — write a synthetic TUM-format sequence (fixtures/demos)
  eval          — ATE/RPE of a trajectory file vs groundtruth

Observability (SURVEY.md §5): per-frame JSONL records (pose, ICP iters,
inlier fraction, residual, ms/frame) via --log-jsonl; summary table with
fps, ATE RMSE at exit.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--sequence", required=True, help="TUM sequence directory")
    p.add_argument("--start", type=int, default=0)
    p.add_argument("--stop", type=int, default=None)
    p.add_argument("--config", default=None, help="JSON config file (SLAMConfig)")
    p.add_argument("--intrinsics", default=None, metavar="FX,FY,CX,CY",
                   help="override camera intrinsics (otherwise: the "
                        "sequence's intrinsics.txt if present, else guessed "
                        "from the freiburg1/2/3 sequence name)")
    p.add_argument("--traj-out", default=None, help="write TUM trajectory here")
    p.add_argument("--log-jsonl", default=None, help="per-frame JSONL metrics")
    p.add_argument("--resume", default=None, help="checkpoint file to resume from")
    p.add_argument("--checkpoint", default=None, help="write checkpoints here")
    p.add_argument("--checkpoint-every", type=int, default=50)
    p.add_argument("--viz-dir", default=None,
                   help="write trajectory/map PNG artifacts here")
    p.add_argument("--track-against-map", action="store_true",
                   help="refine every frame against the voxel map")
    p.add_argument("--map-track-mode", default="projective",
                   choices=("projective", "grid"),
                   help="frame-to-map association: reverse projective "
                        "(one row gather per map point, default) or "
                        "grid-hash index probe")
    p.add_argument("--sharded-map", action="store_true",
                   help="shard the voxel map over all devices: all-to-all "
                        "owner-routed fusion + ring frame-to-map tracking")
    p.add_argument("--mesh-devices", type=int, default=None,
                   help="number of devices the --sharded-map mesh spans "
                        "(default: all)")
    p.add_argument("--map-ba", action="store_true",
                   help="final Schur-complement map bundle adjustment over "
                        "all keyframes (backend/map_ba.py)")
    p.add_argument("--progress", action="store_true",
                   help="print a live per-frame status line to stderr")
    p.add_argument("--async-backend", action="store_true",
                   help="run loop closure + pose-graph optimization in a "
                        "worker thread overlapped with tracking")
    p.add_argument("--chunk", type=int, default=0,
                   help="process frames in device-side chunks of this size "
                        "(one dispatch + one readback per chunk via "
                        "lax.scan; amortizes host dispatch latency; "
                        "run_slam only — backend work runs at chunk "
                        "boundaries, remainder frames step per-frame)")
    p.add_argument("--upload-raw", action="store_true",
                   help="upload depth as RAW uint16 counts and divide by "
                        "depth_scale on device: same 2 bytes/px as "
                        "--upload-f16 but ZERO quantization — the "
                        "trajectory is bit-equal to the f32 upload "
                        "(recommended for 16-bit sources like TUM)")
    p.add_argument("--upload-f16", action="store_true",
                   help="upload depth to the device as float16 (halves the "
                        "host->device transfer — the streaming bottleneck "
                        "on narrow links; ~1.5 mm quantization at 3 m, all "
                        "geometry math stays float32).  Prefer "
                        "--upload-raw for uint16 sources — same transfer "
                        "size, no quantization")
    p.add_argument("--lc-descriptor", action="store_true",
                   help="enable pose-free loop-closure candidates from "
                        "per-keyframe depth descriptors (drift-robust "
                        "proposal: closes revisits whose accumulated "
                        "drift exceeds lc_max_dist; identity-init "
                        "verification through the same gates)")
    p.add_argument("--chunk-sub", type=int, default=8,
                   help="boundary-mode sub-chunk size: the keyframe-"
                        "promotion cadence floor (a promotion applies at "
                        "most once per this many frames).  Lower it for "
                        "tight promotion thresholds / fast motion; 1 "
                        "reproduces per-frame promotion cadence exactly "
                        "while keeping one readback per --chunk frames")
    p.add_argument("--chunk-mode", default="boundary",
                   choices=("boundary", "inline"),
                   help="chunked-streaming promotion semantics (with "
                        "--chunk): 'boundary' tracks each chunk against a "
                        "frozen keyframe and promotes at the chunk "
                        "boundary (no keyframe tables in the scan carry — "
                        "fastest, and with --async-backend the backend "
                        "defers deterministically); 'inline' promotes "
                        "mid-chunk exactly like per-frame stepping")
    _add_distributed(p)


def _add_distributed(p: argparse.ArgumentParser) -> None:
    """Multi-host launch flags (SURVEY.md §2d: one process per host, same
    SPMD program; jax.distributed runtime)."""
    p.add_argument("--coordinator", default=None,
                   help="host:port of process 0 (enables jax.distributed)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)


def _init_distributed(args) -> None:
    if getattr(args, "coordinator", None):
        from tpuslam.dist.mesh import initialize_distributed

        initialize_distributed(args.coordinator, args.num_processes,
                               args.process_id)


def _load_config(path):
    from tpuslam.config import SLAMConfig

    if path is None:
        return SLAMConfig().validate()
    with open(path) as f:
        return SLAMConfig.from_json(f.read()).validate()


def _run_pipeline(args, use_slam: bool) -> int:
    from tpuslam.data.tum import TumSequence, write_trajectory
    from tpuslam.eval.ate import ate_rmse
    from tpuslam.frontend import Odometry
    from tpuslam.slam import SlamSystem
    from tpuslam.utils.checkpoint import load_checkpoint, save_checkpoint
    from tpuslam.utils.metrics import JsonlLogger

    if getattr(args, "viz_dir", None):
        import importlib.util

        if importlib.util.find_spec("matplotlib") is None:
            raise ValueError("--viz-dir needs matplotlib, which is not "
                             "installed")
    _init_distributed(args)
    cfg = _load_config(args.config)
    if getattr(args, "lc_descriptor", False):
        import dataclasses

        cfg = cfg.replace(posegraph=dataclasses.replace(
            cfg.posegraph, lc_descriptor=True))
    seq = TumSequence(args.sequence)
    if getattr(args, "intrinsics", None):
        from tpuslam.config import Intrinsics

        try:
            vals = [float(v) for v in args.intrinsics.split(",")]
        except ValueError:
            vals = []
        if len(vals) != 4 or vals[0] <= 0 or vals[1] <= 0:
            raise ValueError(
                f"--intrinsics must be FX,FY,CX,CY with FX,FY > 0 "
                f"(got {args.intrinsics!r})")
        K = Intrinsics(*vals)
    else:
        K = seq.intrinsics
    system = (
        SlamSystem(K, cfg,
                   track_against_map=getattr(args, "track_against_map", False),
                   map_ba=getattr(args, "map_ba", False),
                   map_track_mode=getattr(args, "map_track_mode", "projective"),
                   async_backend=getattr(args, "async_backend", False),
                   sharded_map=getattr(args, "sharded_map", False),
                   mesh_devices=getattr(args, "mesh_devices", None),
                   chunk_mode=getattr(args, "chunk_mode", "boundary"),
                   chunk_sub=getattr(args, "chunk_sub", 8))
        if use_slam
        else Odometry(K, cfg, keep_keyframe_clouds=False)
    )
    start = args.start
    if args.resume:
        start = load_checkpoint(args.resume, system)
        print(f"resumed at frame {start}", file=sys.stderr)

    logger = JsonlLogger(args.log_jsonl) if args.log_jsonl else None
    chunk = int(getattr(args, "chunk", 0) or 0)
    if chunk > 1 and not use_slam:
        raise ValueError("--chunk requires run_slam")
    t_start = time.perf_counter()
    n_done = 0
    from tpuslam.frontend import prefetch_to_device

    # Steady-state marker: everything before the SECOND processed batch is
    # dominated by one-time costs (jit compiles or compile-cache loads) —
    # `fps` alone would misread a short run as far slower than the
    # pipeline actually is.
    t_steady = {"t": None, "frames": 0}

    def after_frames(frames_done, per_frame_ms):
        nonlocal n_done
        if t_steady["t"] is None:
            t_steady["t"] = time.perf_counter()     # end of first batch
        else:
            t_steady["frames"] += len(frames_done)
        odo = system.odo if use_slam else system
        frame_base = odo.frame_idx - len(frames_done)
        stat_base = len(odo.stats) - len(frames_done)
        for k, frame in enumerate(frames_done):
            n_done += 1
            if logger:
                logger.write(frame=frame_base + k, timestamp=frame.timestamp,
                             ms=per_frame_ms, **odo.stats[stat_base + k])
        if args.checkpoint and (n_done % args.checkpoint_every
                                < len(frames_done)):
            save_checkpoint(args.checkpoint, system, odo.frame_idx)
        if getattr(args, "progress", False):
            s = odo.stats[-1]
            print(
                f"\rframe {odo.frame_idx - 1}  {per_frame_ms:6.1f} ms  "
                f"inl {s.get('inliers', 0):.2f}  kf {len(odo.keyframes)}",
                end="", file=sys.stderr,
            )

    frame_iter = seq.frames(depth_scale=cfg.depth_scale, start=start,
                            stop=args.stop,
                            raw=getattr(args, "upload_raw", False))
    if getattr(args, "upload_f16", False) and not getattr(
            args, "upload_raw", False):
        frame_iter = (f._replace(depth=f.depth.astype(np.float16))
                      for f in frame_iter)
    stream = prefetch_to_device(frame_iter)
    if chunk > 1:
        # device-side chunked streaming (SlamSystem.process_chunk): one
        # dispatch + one readback per chunk; trailing remainder frames
        # (and any chunk with tracking loss) step per-frame inside
        buf: list = []

        def flush():
            if not buf:
                return
            t0 = time.perf_counter()
            if len(buf) == chunk:
                system.process_chunk([f.depth for f in buf],
                                     [f.timestamp for f in buf])
            else:              # remainder — avoid an odd-length compile
                for f in buf:
                    system.process(f.depth, f.timestamp)
            ms = (time.perf_counter() - t0) * 1e3 / len(buf)
            after_frames(buf, ms)
            buf.clear()

        for frame in stream:
            buf.append(frame)
            if len(buf) == chunk:
                flush()
        flush()
    else:
        for frame in stream:
            t0 = time.perf_counter()
            system.process(frame.depth, frame.timestamp)
            ms = (time.perf_counter() - t0) * 1e3
            after_frames([frame], ms)
    if getattr(args, "progress", False):
        print(file=sys.stderr)
    wall = time.perf_counter() - t_start

    odo = system.odo if use_slam else system
    if use_slam:
        # drain the async backend, run the final loop-closure pass + global
        # optimization (+ map BA when enabled) BEFORE dumping the trajectory
        system.finalize()
        ts, poses = system.trajectory()
    else:
        ts = np.asarray(odo.timestamps)
        poses = np.stack(odo.trajectory)
    if args.traj_out:
        write_trajectory(args.traj_out, ts, poses)

    summary = {
        "frames": int(len(ts)),
        "keyframes": len(odo.keyframes),
        "fps": len(ts) / wall if wall > 0 else 0.0,
        "wall_s": wall,
    }
    if t_steady["t"] is not None and t_steady["frames"] > 0:
        steady_wall = wall - (t_steady["t"] - t_start)
        if steady_wall > 0:
            summary["fps_steady"] = t_steady["frames"] / steady_wall
    if use_slam:
        summary["loop_closures"] = len(system.closures)
        summary["graph_nodes"] = system.graph.num_nodes
        # bounded by KeyframeConfig.max_keyframes + protected anchors
        # (frontend._enforce_cloud_budget)
        summary["retained_clouds"] = sum(
            1 for r in odo.keyframes if r.cloud is not None)
        if system.map_ba_stats is not None:
            summary["map_ba"] = system.map_ba_stats
    if seq.groundtruth:
        gt_ts, gt_poses = [], []
        for i in range(len(seq)):
            T = seq.gt_pose(i)
            if T is not None:
                gt_ts.append(seq.depth_list[i][0])
                gt_poses.append(T)
        try:
            m = ate_rmse(ts, poses, np.asarray(gt_ts), np.asarray(gt_poses))
            summary["ate_rmse_m"] = m["rmse"]
            summary["ate_pairs"] = m["num_pairs"]
        except ValueError as e:
            summary["ate_error"] = str(e)
    if getattr(args, "viz_dir", None):
        from tpuslam.viz import write_run_report

        gt_for_viz = None
        if seq.groundtruth:
            gt_for_viz = [T for T in (seq.gt_pose(i) for i in range(len(seq)))
                          if T is not None]
        summary["viz_files"] = write_run_report(args.viz_dir, system,
                                                gt_for_viz)
    print(json.dumps(summary))
    if logger:
        logger.close()
    return 0


def cmd_run_odometry(args) -> int:
    return _run_pipeline(args, use_slam=False)


def cmd_run_slam(args) -> int:
    return _run_pipeline(args, use_slam=True)


def cmd_make_synthetic(args) -> int:
    from tpuslam.config import Intrinsics
    from tpuslam.data.synthetic import write_tum_sequence

    K = Intrinsics(args.fx, args.fx, args.width / 2 - 0.5, args.height / 2 - 0.5)
    write_tum_sequence(args.out, args.frames, K, args.height, args.width,
                       noise=args.noise, rgb=args.rgb)
    print(json.dumps({"out": args.out, "frames": args.frames}))
    return 0


def cmd_eval(args) -> int:
    from tpuslam.data.tum import read_trajectory
    from tpuslam.eval.ate import ate_rmse, rpe

    est_ts, est = read_trajectory(args.trajectory)
    gt_ts, gt = read_trajectory(args.groundtruth)
    out = {
        "ate": ate_rmse(est_ts, est, gt_ts, gt),
        "rpe": rpe(est_ts, est, gt_ts, gt),
    }
    print(json.dumps(out))
    return 0


def cmd_bench(args) -> int:
    from tpuslam.bench.harness import bench_pathology, bench_scale, run_bench

    _init_distributed(args)
    if getattr(args, "coldstart", False):
        # per-program trace/compile-load/first-run breakdown for a fresh
        # process (the minutes-long cache-load mystery — VERDICT r4 #7)
        from tpuslam.bench.coldstart import profile_coldstart

        print(json.dumps(profile_coldstart(
            frames=min(args.frames, 32), height=args.height,
            width=args.width)))
        return 0
    if getattr(args, "scale", False):
        # BASELINE config-5 capacity run on the attached backend
        result = bench_scale(frames=args.frames, height=args.height,
                             width=args.width)
    elif getattr(args, "pathology", False):
        # degraded-sensor (z²-noise + holes + rotation burst) smoke
        result = bench_pathology(frames=args.frames, height=args.height,
                                 width=args.width)
    else:
        result = run_bench(
            frames=args.frames, height=args.height, width=args.width,
            config_path=args.config, devices=args.devices,
        )
    print(json.dumps(result))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tpuslam")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run_odometry", help="frame-to-keyframe odometry")
    _add_common(p)
    p.set_defaults(fn=cmd_run_odometry)

    p = sub.add_parser("run_slam", help="full SLAM with loop closure")
    _add_common(p)
    p.set_defaults(fn=cmd_run_slam)

    p = sub.add_parser("make_synthetic", help="write synthetic TUM sequence")
    p.add_argument("--out", required=True)
    p.add_argument("--frames", type=int, default=30)
    p.add_argument("--height", type=int, default=120)
    p.add_argument("--width", type=int, default=160)
    p.add_argument("--fx", type=float, default=160.0)
    p.add_argument("--noise", type=float, default=0.0)
    p.add_argument("--rgb", action="store_true",
                   help="also write rgb/ PNGs + rgb.txt")
    p.set_defaults(fn=cmd_make_synthetic)

    p = sub.add_parser("eval", help="evaluate a trajectory file")
    p.add_argument("--trajectory", required=True)
    p.add_argument("--groundtruth", required=True)
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("bench", help="throughput benchmark")
    p.add_argument("--frames", type=int, default=120)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--config", default=None)
    p.add_argument("--devices", type=int, default=None)
    p.add_argument("--scale", action="store_true",
                   help="run the BASELINE config-5 capacity benchmark "
                        "instead (multi-lap loop, tight promotion, tiny "
                        "initial graph capacity; pass --frames 2000 "
                        "--height 240 --width 320 for the recorded "
                        "artifact)")
    p.add_argument("--pathology", action="store_true",
                   help="run the degraded-sensor smoke instead (Kinect "
                        "z²-noise + dropout holes + rotation burst)")
    p.add_argument("--coldstart", action="store_true",
                   help="profile fresh-process cold start instead: per-"
                        "program trace / compile-or-cache-load / first-run "
                        "breakdown (run twice to compare miss vs hit)")
    _add_distributed(p)
    p.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    try:
        return args.fn(args)
    except FileNotFoundError as e:
        print(f"error: file not found: {e.filename or e}", file=sys.stderr)
        return 2
    except json.JSONDecodeError as e:
        print(f"error: invalid JSON in config/trajectory file: {e}",
              file=sys.stderr)
        return 2
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
