"""Tracing/profiling (SURVEY.md §5; VERDICT r2 missing #5).

The pipeline stages are annotated with `jax.named_scope`, which XLA carries
into every op's `op_name` metadata — the string XProf groups the trace
timeline by.  The compiled-HLO check below is backend-independent proof the
annotation wiring is live (the CPU *runtime* trace only records host-level
events, so scope visibility is asserted at the metadata layer; a GPU
trace carries the same names as each kernel's `tf_op`).  A second test checks `profiling.trace` actually captures an
XProf-loadable artifact.
"""

import glob
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from tpuslam.config import Intrinsics, SLAMConfig
from tpuslam.data.synthetic import render_depth
from tpuslam.frontend import preprocess, preprocess_jit, track_step
from tpuslam.utils import profiling

K = Intrinsics(160.0, 160.0, 79.5, 59.5)
H, W = 120, 160
CFG = SLAMConfig(height=H, width=W)


def test_pipeline_scopes_reach_compiled_hlo():
    d0 = jnp.asarray(render_depth(np.eye(4), K, H, W, seed=0))
    txt = (jax.jit(partial(preprocess, K=K, cfg=CFG)).lower(d0)
           .compile().as_text())
    for scope in ("preprocess.backproject_l0", "preprocess.normals_l0",
                  "preprocess.backproject_l2"):
        assert scope in txt, f"scope {scope} missing from compiled HLO"

    pyr = preprocess_jit(d0, K, CFG)
    txt = (jax.jit(lambda a, b, T: track_step(a, b, K, T, CFG))
           .lower(pyr, pyr, jnp.eye(4)).compile().as_text())
    for scope in ("pack_target", "icp.correspond", "icp.gn_reduce",
                  "icp.solve"):
        assert scope in txt, f"scope {scope} missing from compiled HLO"


def test_posegraph_scope_reaches_compiled_hlo():
    from tpuslam.backend.posegraph import PoseGraph, optimize_pose_graph
    from tpuslam.config import PoseGraphConfig

    cfg = PoseGraphConfig(max_nodes=4, max_edges=4, gn_iters=2)
    g = PoseGraph.empty(4, 4)
    txt = (jax.jit(partial(optimize_pose_graph, cfg=cfg)).lower(g)
           .compile().as_text())
    assert "posegraph.gn_round" in txt


def test_trace_capture_produces_xplane(tmp_path):
    d0 = jnp.asarray(render_depth(np.eye(4), K, H, W, seed=0))
    np.asarray(preprocess_jit(d0, K, CFG)[0].points)  # compile outside
    with profiling.trace(str(tmp_path)) as trace_dir:
        np.asarray(preprocess_jit(d0, K, CFG)[0].points)
    planes = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                       recursive=True)
    assert planes, f"no xplane captured under {trace_dir}"
    assert os.path.getsize(planes[0]) > 0
