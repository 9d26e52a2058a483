"""tpuslam — a dense RGB-D SLAM engine in JAX, running on NVIDIA GPUs.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the
``BenniG123/icp-slam-prototype`` reference (a single-process CPU C++ ICP-SLAM
prototype; see SURVEY.md §1-2 — the reference mount was empty, so provenance
is the driver-pinned BASELINE.json north-star rather than file:line cites).

Pipeline (reference parity, SURVEY.md §2a R1-R15):
  depth → backprojection → normals → voxel downsample → point-to-plane ICP
  (projective/grid-hash correspondence, Huber-weighted 6x6 Gauss-Newton)
  → keyframes + voxel map → pose graph + loop closure → ATE evaluation.

Accelerator additions (SURVEY.md §2b-2d): fixed-shape/masked data
discipline, Triton-route Pallas kernels for the ICP Gauss-Newton step, a
`jax.sharding` mesh with point-sharded ICP reduction, a sharded voxel map
and edge-sharded distributed pose-graph BA.
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax

# A float32 matmul on the GPU runs in TF32 by default (about three decimal
# digits): a 3x3 `W @ W` then differs from fp32 by ~1e-3, which silently
# wrecks SE(3) math and GN normal equations.  Geometry is metric (mm-scale
# accuracy at metre range), so full fp32 matmuls are the package default.
_jax.config.update("jax_default_matmul_precision", "highest")


def compile_cache_dir() -> str:
    """Where compiled programs persist: `JAX_COMPILATION_CACHE_DIR` when it
    is set (JAX reads it itself), else `<checkout>/.jax_cache`.  The path
    is fixed: it is part of the cache key, so a moving directory never
    hits."""
    env = _os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    return _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache")


if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.3)

from tpuslam.config import (  # noqa: F401
    Intrinsics,
    ICPConfig,
    VoxelConfig,
    KeyframeConfig,
    PoseGraphConfig,
    SLAMConfig,
)
