"""Fault injection / recovery (SURVEY.md §5 "Failure detection / elastic
recovery"): kill a SLAM run mid-sequence, restart from the last snapshot,
and require the recovered trajectory to match an uninterrupted run.

A fixed device mesh has no true elasticity; the honest
mechanism is checkpoint + full restart (documented in SURVEY.md §5), which
is exactly what this exercises at the process level.
"""

import os
import subprocess
import sys

import numpy as np

_RUNNER = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, os.getcwd())
import numpy as np
from tpuslam.config import ICPConfig, Intrinsics, KeyframeConfig, SLAMConfig
from tpuslam.data.synthetic import orbit_trajectory, render_depth
from tpuslam.slam import SlamSystem
from tpuslam.utils.checkpoint import load_checkpoint, save_checkpoint

ckpt, out_path, crash_at = sys.argv[1], sys.argv[2], int(sys.argv[3])
K = Intrinsics(160.0, 160.0, 79.5, 59.5)
H, W = 120, 160
CFG = SLAMConfig(height=H, width=W,
                 icp=ICPConfig(pyramid_levels=3, iters_per_level=(12, 8, 8),
                               max_corr_dist=0.25, huber_delta=0.05),
                 keyframe=KeyframeConfig(max_translation=0.10,
                                         max_rotation=0.15))
poses = orbit_trajectory(10)
depths = np.stack([render_depth(poses[i], K, H, W, seed=i)
                   for i in range(10)])
slam = SlamSystem(K, CFG, enable_loop_closure=False)
start = 0
if os.path.exists(ckpt):
    start = load_checkpoint(ckpt, slam)
for i in range(start, 10):
    slam.process(depths[i], timestamp=i / 30.0)
    save_checkpoint(ckpt, slam, slam.odo.frame_idx)
    if crash_at >= 0 and slam.odo.frame_idx == crash_at:
        os._exit(42)   # simulated hard crash — no cleanup, no flush
ts, traj = slam.trajectory()
np.save(out_path, traj)
"""


def _run(tmp_path, name, crash_at):
    ckpt = str(tmp_path / f"{name}.npz")
    out = str(tmp_path / f"{name}.npy")
    runner = tmp_path / "runner.py"
    runner.write_text(_RUNNER)
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rc = subprocess.run(
        [sys.executable, str(runner), ckpt, out, str(crash_at)],
        cwd=repo, env=env, capture_output=True, text=True,
    )
    return rc, ckpt, out


def test_crash_and_recover_matches_uninterrupted(tmp_path):
    # uninterrupted reference
    rc, _, out_ref = _run(tmp_path, "ref", crash_at=-1)
    assert rc.returncode == 0, rc.stderr[-2000:]

    # crashing run: hard-exits after frame 5's snapshot
    rc, ckpt, out_crash = _run(tmp_path, "crash", crash_at=5)
    assert rc.returncode == 42
    assert os.path.exists(ckpt)
    assert not os.path.exists(out_crash)

    # recovery run resumes from the snapshot and finishes
    rc, _, out_rec = _run(tmp_path, "crash", crash_at=-1)
    assert rc.returncode == 0, rc.stderr[-2000:]

    ref = np.load(out_ref)
    rec = np.load(str(tmp_path / "crash.npy"))
    assert rec.shape == ref.shape
    np.testing.assert_allclose(rec, ref, atol=1e-5)
