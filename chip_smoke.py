#!/usr/bin/env python
"""End-to-end smoke test of tpuslam on one NVIDIA GPU.

    python chip_smoke.py            # one card: device, kernels, odometry, slam
    python chip_smoke.py --multi    # four cards: the sharded paths only

Runs in ONE process (a second JAX process would find the card's memory
already reserved) and fails — non-zero exit, no result line — when JAX
finds no GPU or any phase fails.  The phases, in order:

  device    pin JAX to CUDA, print the card (nvidia-smi), precision, cache
  kernels   the Triton GN kernels, compiled, against the plain jnp chain on
            the card and float64 numpy on the host, at the source-point
            counts of a 640×480 frame (153,600 / 76,800 / 19,200)
  odometry  scan_odometry over 240 synthetic 640×480 frames (ATE ≤ 1 mm)
  slam      write a 240-frame 640×480 loop sequence with the repo's own
            writer, then `run_slam` per-frame and `--chunk 8 --async-backend
            --upload-raw` and `eval`, all through tpuslam.cli.main
            (ATE ≤ 5 mm and ≥ 1 verified loop closure each)
  multi     (--multi) every sharded stage against its one-device run, and
            `run_slam --sharded-map --track-against-map` on the 4-device
            mesh against the same on a 1-device mesh (≤ 1 mm: the same
            algorithm, summed in another order) and against projective
            `--track-against-map` on one device (ATE each)

The last line of standard output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WIDTHS = (153600, 76800, 19200)     # finest (finest_subsample=2) → coarsest
FRAMES = 240
VGA = (480, 640)

H_REL_TOL = 1e-4    # f32 sums over ~1.5e5 terms, in another order than f64
POSE_T_TOL = 1e-6   # m, kernel step vs plain step on the card
POSE_R_TOL = 1e-6   # rad
ODO_ATE_TOL = 1e-3  # m; the clean synthetic orbit tracks at ~3e-5
SLAM_ATE_TOL = 5e-3
MULTI_POSE_TOL = 1e-3   # m and rad, sharded vs one-device trajectories


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def phases_for(multi: bool) -> list:
    return ["device", "multi"] if multi else [
        "device", "kernels", "odometry", "slam"]


def result_line(devices) -> str:
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def gpu_devices():
    """Pin JAX to CUDA before its first backend use — a CUDA plugin that
    fails to start then raises instead of falling back to the CPU — and
    return the GPU devices."""
    import jax

    jax.config.update("jax_platforms", "cuda")
    try:
        devs = jax.devices()
    except (RuntimeError, AssertionError) as e:
        # JAX raises either, by version, when no CUDA backend starts
        raise SmokeFailure(f"JAX found no CUDA GPU: {e!r}") from e
    check(bool(devs) and devs[0].platform == "gpu",
          f"no GPU: JAX reports {devs[0].platform if devs else 'nothing'}")
    return devs


def card_line() -> str:
    """The card's name and power limit, from nvidia-smi (a non-JAX child)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def pose_delta(Ta, Tb) -> tuple:
    """(translation m, rotation rad) of Ta⁻¹·Tb, in float64; the angle from
    the antisymmetric part, which stays accurate for tiny rotations."""
    D = np.linalg.inv(np.asarray(Ta, np.float64)) @ np.asarray(Tb, np.float64)
    A = 0.5 * (D[:3, :3] - D[:3, :3].T)
    return (float(np.linalg.norm(D[:3, 3])),
            float(np.arcsin(min(1.0, np.linalg.norm([A[2, 1], A[0, 2],
                                                      A[1, 0]])))))


def phase_device(devices, card: str) -> None:
    import jax

    import tpuslam

    d = devices[0]
    print(f"device: {d.platform} {d.device_kind} x{len(devices)}")
    print(f"card: {card}")
    print(f"matmul precision: {jax.config.jax_default_matmul_precision}")
    print(f"compile cache: {tpuslam.compile_cache_dir()}")
    check(jax.config.jax_default_matmul_precision == "highest",
          "default matmul precision is not 'highest'")


def _gn_inputs(rng, n):
    x = rng.normal(size=(n, 3)).astype(np.float32)
    q = x + rng.normal(scale=0.03, size=(n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3))
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(np.float32)
    w = (rng.uniform(size=n) < 0.8).astype(np.float32)
    return x, q, nrm, w


def _hb_float64(x, q, nrm, w, delta):
    x, q, n = (a.astype(np.float64) for a in (x, q, nrm))
    r = np.sum(n * (x - q), -1)
    ar = np.abs(r)
    wt = w * np.where(ar <= delta, 1.0, delta / np.maximum(ar, 1e-12))
    J = np.concatenate([n, np.cross(x, n)], -1)
    return (J * wt[:, None]).T @ J, (J * wt[:, None]).T @ r


def phase_kernels(widths=WIDTHS, interpret: bool = False) -> None:
    """Kernel GN step vs the plain chain on the same device, and the
    kernel reduce vs float64 numpy, at each source-point count."""
    import jax
    import jax.numpy as jnp

    from tpuslam.config import ICPConfig
    from tpuslam.geom import se3
    from tpuslam.icp import _gn_step_kernels, _gn_step_xla
    from tpuslam.kernels.gn_triton import gn_partials

    cfg = ICPConfig()
    rng = np.random.default_rng(0)
    T = se3.exp(jnp.asarray([0.02, -0.01, 0.03, 0.01, -0.02, 0.01]))
    kern = jax.jit(lambda *a: _gn_step_kernels(*a, cfg=cfg,
                                               interpret=interpret))
    plain = jax.jit(lambda *a: _gn_step_xla(*a, cfg=cfg))
    parts = jax.jit(lambda *a: gn_partials(*a, cfg.huber_delta,
                                           interpret=interpret))
    iu, ju = np.triu_indices(6)
    for n in widths:
        x, q, nrm, w = _gn_inputs(rng, n)
        args = (x, q, nrm, w, w > 0, T)
        Tk, Hk = (np.asarray(a) for a in kern(*args)[:2])
        Tp, Hp = (np.asarray(a) for a in plain(*args)[:2])
        s = np.asarray(parts(x, q, nrm, w), np.float64).sum(0)
        H = np.zeros((6, 6))
        H[iu, ju] = s[:21]
        H[ju, iu] = s[:21]
        H64, b64 = _hb_float64(x, q, nrm, w, cfg.huber_delta)
        h_rel = np.linalg.norm(H - H64) / np.linalg.norm(H64)
        b_rel = np.linalg.norm(s[21:27] - b64) / np.linalg.norm(b64)
        hk_rel = np.linalg.norm(Hk - H64) / np.linalg.norm(H64)
        hp_rel = np.linalg.norm(Hp - H64) / np.linalg.norm(H64)
        dt, dr = pose_delta(Tp, Tk)
        print(f"kernels n={n}: reduce vs f64 H {h_rel:.2e} b {b_rel:.2e} "
              f"(tol {H_REL_TOL:.0e}); step H vs f64 kernel {hk_rel:.2e} "
              f"plain {hp_rel:.2e}; pose kernel vs plain {dt:.2e} m "
              f"{dr:.2e} rad (tol {POSE_T_TOL:.0e})")
        check(max(h_rel, b_rel, hk_rel, hp_rel) <= H_REL_TOL,
              f"GN reduce off float64 at n={n}")
        check(dt <= POSE_T_TOL and dr <= POSE_R_TOL,
              f"kernel GN step differs from the plain chain at n={n}")


def _synthetic_K(h, w):
    from tpuslam.config import Intrinsics

    return Intrinsics(525.0 * w / 640.0, 525.0 * h / 480.0,
                      w / 2 - 0.5, h / 2 - 0.5)


def phase_odometry(card: str, frames: int = FRAMES, hw=VGA) -> None:
    import jax
    import jax.numpy as jnp

    from tpuslam.config import SLAMConfig
    from tpuslam.data.synthetic import orbit_trajectory, render_depth
    from tpuslam.eval.ate import ate_rmse
    from tpuslam.frontend import scan_odometry_jit

    h, w = hw
    K = _synthetic_K(h, w)
    gt = orbit_trajectory(frames)
    depths = jax.block_until_ready(jnp.asarray(np.stack(
        [render_depth(gt[i], K, h, w, seed=i) for i in range(frames)])))
    cfg = SLAMConfig(height=h, width=w)
    t0 = time.perf_counter()
    out = jax.block_until_ready(scan_odometry_jit(depths, K, cfg))
    first = time.perf_counter() - t0
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = jax.block_until_ready(scan_odometry_jit(depths, K, cfg))
        walls.append(time.perf_counter() - t0)
    ts = np.arange(frames, dtype=np.float64)
    ate = ate_rmse(ts, np.asarray(out[0]), ts, gt)["rmse"]
    ms = [1e3 * t / frames for t in walls]
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    print(f"odometry {frames}x{h}x{w}: ATE {ate:.3e} m (tol "
          f"{ODO_ATE_TOL:.0e}); ms/frame {np.median(ms):.4f} runs "
          f"{[round(m, 4) for m in ms]}; compile+first run {first:.1f} s; "
          f"peak_bytes_in_use {peak} [{card}]")
    check(bool(np.isfinite(np.asarray(out[0])).all()), "non-finite poses")
    check(ate <= ODO_ATE_TOL, f"odometry ATE {ate:.3e} m over tolerance")


def _cli(argv) -> list:
    """Run tpuslam.cli.main in this process; return its stdout lines."""
    from tpuslam.cli import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    lines = buf.getvalue().strip().splitlines()
    check(rc == 0, f"tpuslam {' '.join(argv[:1])} exited {rc}: {lines[-1:]}")
    return lines


def write_loop_sequence(root: str, frames: int, hw) -> str:
    """The bench's 2-lap loop (returns to its start each lap), written as a
    TUM sequence, plus the bench's config (lc_min_gap=8: a lap promotes
    ~15 keyframes, so the default gap of 20 would gate every revisit)."""
    from tpuslam.data.synthetic import loop_trajectory, write_tum_sequence

    h, w = hw
    write_tum_sequence(root, frames, _synthetic_K(h, w), h, w,
                       poses=loop_trajectory(frames, cycles=2, radius=0.35))
    cfg_path = os.path.join(root, "slam_config.json")
    with open(cfg_path, "w") as f:
        json.dump({"height": h, "width": w,
                   "posegraph": {"lc_min_gap": 8}}, f)
    return cfg_path


def run_slam_mode(seq: str, cfg_path: str, tag: str, extra: list) -> dict:
    traj = os.path.join(seq, f"traj_{tag}.txt")
    log = os.path.join(seq, f"log_{tag}.jsonl")
    summary = json.loads(_cli(
        ["run_slam", "--sequence", seq, "--config", cfg_path,
         "--traj-out", traj, "--log-jsonl", log] + extra)[-1])
    ev = json.loads(_cli(["eval", "--trajectory", traj, "--groundtruth",
                          os.path.join(seq, "groundtruth.txt")])[-1])
    with open(log) as f:
        recs = [json.loads(line) for line in f]
    ms = np.array([r["ms"] for r in recs[1:]])
    summary["eval_ate_m"] = ev["ate"]["rmse"]
    summary["iters_per_frame"] = float(np.mean([r.get("iters", 0)
                                                for r in recs[1:]]))
    # per-frame host latency (ms/frame of its batch); the first frame's
    # compile is excluded, later compiles show up in the tail
    summary["ms_p50_p99_max"] = [float(np.percentile(ms, 50)),
                                 float(np.percentile(ms, 99)),
                                 float(ms.max())]
    summary["traj"] = traj
    return summary


def phase_slam(card: str, frames: int = FRAMES, hw=VGA) -> None:
    seq = tempfile.mkdtemp(prefix=".smoke_seq_", dir=ROOT)
    try:
        t0 = time.perf_counter()
        cfg_path = write_loop_sequence(seq, frames, hw)
        print(f"slam: wrote {frames} frames {hw[0]}x{hw[1]} in "
              f"{time.perf_counter() - t0:.1f} s")
        for tag, extra in (("per_frame", []),
                           ("chunked", ["--chunk", "8", "--async-backend",
                                        "--upload-raw"])):
            s = run_slam_mode(seq, cfg_path, tag, extra)
            print(f"slam {tag}: ATE {s['eval_ate_m']:.3e} m (tol "
                  f"{SLAM_ATE_TOL:.0e}); loop closures {s['loop_closures']}; "
                  f"keyframes {s['keyframes']}; fps {s['fps']:.1f} steady "
                  f"{s.get('fps_steady', 0.0):.1f}; ms/frame p50/p99/max "
                  f"{'/'.join(f'{m:.2f}' for m in s['ms_p50_p99_max'])}; "
                  f"finest-level GN steps per frame "
                  f"{s['iters_per_frame']:.2f} [{card}]")
            check(s["frames"] == frames, f"{tag}: {s['frames']} frames")
            check(s["eval_ate_m"] <= SLAM_ATE_TOL,
                  f"{tag}: ATE over tolerance")
            check(s["loop_closures"] >= 1, f"{tag}: no verified loop closure")
    finally:
        shutil.rmtree(seq, ignore_errors=True)


def phase_multi(card: str, n_dev: int = 4, frames: int = 120, hw=VGA,
                dry_cfg=None) -> None:
    """Every sharded stage against its one-device run, then the sharded-map
    SLAM system against the one-device map-tracking system, on the
    bench's 120-frame two-lap loop."""
    import jax

    from tpuslam.config import SLAMConfig
    from tpuslam.data.tum import read_trajectory

    check(len(jax.devices()) >= n_dev,
          f"--multi needs {n_dev} devices, JAX has {len(jax.devices())}")
    from __graft_entry__ import dryrun_multichip

    deltas = dryrun_multichip(
        n_dev, cfg=dry_cfg or SLAMConfig(height=hw[0], width=hw[1]),
        graph_nodes=64)
    print(f"multi dry run deltas (sharded vs one device): {deltas} "
          f"[{card}]")
    seq = tempfile.mkdtemp(prefix=".smoke_seq_", dir=ROOT)
    try:
        cfg_path = write_loop_sequence(seq, frames, hw)
        sharded = ["--track-against-map", "--sharded-map", "--mesh-devices"]
        runs = {}
        for tag, extra in (("one_device", ["--track-against-map"]),
                           ("mesh_1", sharded + ["1"]),
                           (f"mesh_{n_dev}", sharded + [str(n_dev)])):
            s = run_slam_mode(seq, cfg_path, tag, extra)
            _, runs[tag] = read_trajectory(s["traj"])
            print(f"multi slam {tag}: ATE {s['eval_ate_m']:.3e} m; loop "
                  f"closures {s['loop_closures']}; fps {s['fps']:.1f} "
                  f"[{card}]")
            check(s["eval_ate_m"] <= SLAM_ATE_TOL,
                  f"{tag}: ATE over tolerance")
        b = runs[f"mesh_{n_dev}"]
        for ref, tol in (("mesh_1", MULTI_POSE_TOL), ("one_device", None)):
            a = runs[ref]
            check(a.shape == b.shape, f"{ref}: trajectory length differs")
            d = np.array([pose_delta(x, y) for x, y in zip(a, b)])
            print(f"multi slam mesh_{n_dev} vs {ref}: max Δt "
                  f"{d[:, 0].max():.3e} m, max Δr {d[:, 1].max():.3e} rad "
                  f"(tol {tol if tol else 'none: another algorithm'})")
            check(tol is None or d.max() <= tol,
                  f"sharded-map trajectory differs from the {ref} run")
    finally:
        shutil.rmtree(seq, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-device sharded phase")
    args = ap.parse_args(argv)
    devices = gpu_devices()
    card = card_line()
    for name in phases_for(args.multi):
        t0 = time.perf_counter()
        print(f"== phase {name}", flush=True)
        if name == "device":
            phase_device(devices, card)
        elif name == "kernels":
            phase_kernels()
        elif name == "odometry":
            phase_odometry(card)
        elif name == "slam":
            phase_slam(card)
        else:
            phase_multi(card)
        print(f"== phase {name} ok in {time.perf_counter() - t0:.1f} s",
              flush=True)
    print(result_line(devices))
    return 0


if __name__ == "__main__":
    sys.exit(main())
