"""Multi-host died-host recovery (SURVEY.md §5 "Failure detection /
elastic recovery"; VERDICT r2 missing #3).

Two real processes run a phased distributed pose-graph BA over a loopback
`jax.distributed` mesh, snapshotting the keyframe poses after every
completed phase.  Process 1 is hard-killed (`os._exit`) MID-BA — after the
phase-1 snapshot, before phase 2 completes.  The survivor is reaped (a died
host stalls the collective; on a real slice the coordinator's missing
heartbeat kills the job the same way), both processes restart with a fresh
coordinator, rejoin via `jax.distributed.initialize`, reload the snapshot,
and finish.  The recovered poses must match an uninterrupted 2-process run.

A fixed device mesh has no true elasticity; checkpoint + full
restart + rejoin IS the honest recovery story (SURVEY.md §5), exercised
here at the process level with real cross-process collectives.
"""

import os
import socket
import subprocess
import sys
import time

import numpy as np

_CHILD = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
coordinator = sys.argv[1]
pid = int(sys.argv[2])
ckpt = sys.argv[3]
out_path = sys.argv[4]
crash_phase = int(sys.argv[5])
jax.distributed.initialize(coordinator_address=coordinator,
                           num_processes=2, process_id=pid)
import numpy as np
from jax.sharding import Mesh
sys.path.insert(0, os.getcwd())
from tpuslam.backend.distba import optimize_pose_graph_spmd
from tpuslam.backend.posegraph import GraphHost
from tpuslam.config import PoseGraphConfig

mesh = Mesh(np.array(jax.devices()), ("shard",))
cfg = PoseGraphConfig(max_nodes=16, max_edges=32, gn_iters=4)

# deterministic noisy 10-node loop — identical on both processes (SPMD)
rng = np.random.default_rng(3)
g = GraphHost(cfg)
true_step = np.eye(4, dtype=np.float32); true_step[0, 3] = 0.1
prev = np.eye(4, dtype=np.float32)
g.add_node(prev)
for k in range(1, 10):
    noisy = prev @ true_step
    noisy[:3, 3] += rng.normal(scale=0.02, size=3).astype(np.float32)
    g.add_node(noisy)
    g.add_edge(k - 1, k, true_step)
    prev = noisy
loop = np.eye(4, dtype=np.float32); loop[0, 3] = 0.9
g.add_edge(0, 9, loop, weight=2.0)

PHASES = 3
start_phase = 0
if os.path.exists(ckpt):
    z = np.load(ckpt)
    start_phase = int(z["phase"])
    g.set_poses(z["poses"].astype(np.float32))
    print(f"RESUMED phase={start_phase}", flush=True)

for phase in range(start_phase, PHASES):
    if phase == crash_phase and pid == 1:
        os._exit(42)        # died host: no cleanup, mid-BA
    poses, cost = optimize_pose_graph_spmd(g.graph(), cfg, mesh)
    poses = np.asarray(poses.addressable_data(0)).astype(np.float32)
    g.set_poses(poses)
    if pid == 0:            # snapshot after every completed phase
        tmp = ckpt + ".tmp.npz"
        np.savez(tmp[:-4], phase=phase + 1, poses=g._poses[: g.num_nodes])
        os.replace(tmp, ckpt)
    print(f"PHASE {phase} cost {float(cost):.6e}", flush=True)

if pid == 0:
    np.save(out_path, g._poses[: g.num_nodes])
print("DONE", flush=True)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch(child_path, ckpt, out, crash_phase):
    coordinator = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return [
        subprocess.Popen(
            [sys.executable, str(child_path), coordinator, str(pid),
             ckpt, out, str(crash_phase)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            cwd=repo, env=env, text=True,
        )
        for pid in range(2)
    ]


def _finish_all(procs, timeout=150):
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, out, err))
    return outs


def test_died_host_mid_ba_recovers_from_snapshot(tmp_path):
    child = tmp_path / "child.py"
    child.write_text(_CHILD)

    # --- uninterrupted 2-process reference run ---
    ck_ref = str(tmp_path / "ref.npz")
    out_ref = str(tmp_path / "ref_poses.npy")
    outs = _finish_all(_launch(child, ck_ref, out_ref, crash_phase=-1))
    for rc, out, err in outs:
        assert rc == 0, err[-3000:]
        assert "PHASE 2" in out

    # --- crashing run: process 1 dies mid-BA (before phase 2 completes) ---
    ck = str(tmp_path / "crash.npz")
    out_crash = str(tmp_path / "crash_poses.npy")
    procs = _launch(child, ck, out_crash, crash_phase=2)
    # reap the dying host first
    rc1 = procs[1].wait(timeout=150)
    assert rc1 == 42
    # the survivor is now stalled in (or heading into) a collective with a
    # dead peer — exactly what a real died host looks like.  Failure
    # detection on a fixed slice is the coordinator/job layer killing the
    # survivors; emulate it, with a grace period for a natural error exit.
    try:
        procs[0].wait(timeout=10)
    except subprocess.TimeoutExpired:
        procs[0].kill()
    procs[0].communicate()
    assert not os.path.exists(out_crash)
    # the phase-1 snapshot survived the crash
    assert os.path.exists(ck)
    z = np.load(ck)
    assert int(z["phase"]) >= 1

    # --- restart both processes: rejoin + reload + finish ---
    outs = _finish_all(_launch(child, ck, out_crash, crash_phase=-1))
    for rc, out, err in outs:
        assert rc == 0, err[-3000:]
        assert "RESUMED" in out
        assert "DONE" in out

    ref = np.load(out_ref)
    rec = np.load(out_crash)
    assert rec.shape == ref.shape
    np.testing.assert_allclose(rec, ref, atol=1e-5)
