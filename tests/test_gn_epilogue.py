"""GN epilogue kernel (kernels/gn_triton.gn_epilogue, Triton route, run in
interpret mode here) vs its jnp twin `epilogue_math` and the plain
solve_gn_step + se3.exp chain; plus the per-platform choice of GN step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpuslam.geom import se3
from tpuslam.kernels.gn_reduce import gn_reduce, solve_gn_step
from tpuslam.kernels.gn_triton import epilogue_math, gn_epilogue, gn_partials


def make_partials(rng, n=5000, valid_frac=0.8):
    x = jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32))
    q = x + jnp.asarray(rng.normal(scale=0.03, size=(n, 3)).astype(np.float32))
    nn = rng.normal(size=(n, 3))
    nn /= np.linalg.norm(nn, axis=1, keepdims=True)
    nrm = jnp.asarray(nn.astype(np.float32))
    w = jnp.asarray((rng.uniform(size=n) < valid_frac).astype(np.float32))
    partials = gn_partials(x, q, nrm, w, 0.05, interpret=True)
    return partials, (x, q, nrm, w)


ARGS = (1e-6, 1e-4, 0.3, 0.3)   # damping, damping_abs, max_trans, max_rot


def test_epilogue_kernel_matches_reference(rng):
    partials, _ = make_partials(rng)
    T = se3.exp(jnp.asarray([0.02, -0.01, 0.03, 0.01, -0.02, 0.01]))
    T_ref, H_ref, stats = epilogue_math(partials.sum(0), T, *ARGS)
    T_new, H, dsq, wsq, ninl = gn_epilogue(partials, T, *ARGS,
                                           interpret=True)
    np.testing.assert_allclose(np.asarray(T_new), np.asarray(T_ref),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(H), np.asarray(H_ref)[:6, :6],
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose([float(dsq), float(wsq), float(ninl)],
                               np.asarray(stats)[:3], rtol=1e-5, atol=1e-12)


def test_epilogue_matches_legacy_solve_chain(rng):
    """Fold + Gauss solve + exp + compose must reproduce the jnp
    gn_reduce → solve_gn_step → se3.exp pipeline (different algorithms —
    Gauss vs LU, generator-matrix vs series exp — same math)."""
    partials, (x, q, nrm, w) = make_partials(rng)
    T = se3.exp(jnp.asarray([0.02, -0.01, 0.03, 0.01, -0.02, 0.01]))
    T_new, H, dsq, wsq, ninl = gn_epilogue(partials, T, *ARGS,
                                           interpret=True)
    stats = gn_reduce(x, q, nrm, w, w > 0, 0.05)
    delta = solve_gn_step(stats.H, stats.b, *ARGS)
    np.testing.assert_allclose(np.asarray(T_new),
                               np.asarray(se3.exp(delta) @ T), atol=1e-6)
    np.testing.assert_allclose(np.asarray(H), np.asarray(stats.H),
                               rtol=1e-5, atol=1e-3)
    assert float(dsq) == pytest.approx(float(jnp.sum(delta * delta)),
                                       rel=1e-4, abs=1e-12)
    assert float(ninl) == pytest.approx(float(stats.num_inliers))
    assert float(wsq) == pytest.approx(float(stats.weighted_sq_sum), rel=1e-4)


def test_epilogue_trust_region_clamps(rng):
    """A huge b must produce a clamped step, exactly like solve_gn_step."""
    partials, (x, q, nrm, w) = make_partials(rng)
    boost = jnp.where((jnp.arange(32) >= 21) & (jnp.arange(32) < 27),
                      500.0, 1.0)
    T = jnp.eye(4)
    T_new, _, dsq, *_ = gn_epilogue(partials * boost, T, *ARGS,
                                    interpret=True)
    stats = gn_reduce(x, q, nrm, w, w > 0, 0.05)
    delta = solve_gn_step(stats.H, stats.b * 500.0, *ARGS)
    np.testing.assert_allclose(np.asarray(T_new),
                               np.asarray(se3.exp(delta) @ T), atol=1e-5)
    d = np.asarray(delta)
    assert np.linalg.norm(d[:3]) <= 0.3 + 1e-6
    assert np.linalg.norm(d[3:]) <= 0.3 + 1e-6
    assert float(dsq) > 0


def test_epilogue_all_invalid_is_identity(rng):
    """Zero partials (no correspondences) must leave the pose unchanged
    and report zero inliers — the rank-collapse guard path."""
    partials = jnp.zeros((3, 32), jnp.float32)
    T = se3.exp(jnp.asarray([0.1, 0.2, -0.1, 0.05, 0.0, 0.1]))
    T_new, H, dsq, wsq, ninl = gn_epilogue(partials, T, *ARGS,
                                           interpret=True)
    np.testing.assert_allclose(np.asarray(T_new), np.asarray(T), atol=1e-6)
    np.testing.assert_allclose(np.asarray(H), 0.0)
    assert float(ninl) == 0.0 and float(wsq) == 0.0
    assert float(dsq) == pytest.approx(0.0, abs=1e-12)


def test_epilogue_nonfinite_solve_keeps_pose(rng):
    """A non-finite system (inf in a b entry → inf/NaN through the unpivoted
    Gauss solve) must yield a ZERO step — pose unchanged, no NaN anywhere —
    matching solve_gn_step's where(ok, delta, 0) guard."""
    partials, _ = make_partials(rng)
    bad = np.array(partials)
    bad[0, 22] = np.inf                   # a b component of row 0
    T = se3.exp(jnp.asarray([0.05, -0.02, 0.01, 0.02, 0.01, -0.03]))
    T_new, _, dsq, *_ = gn_epilogue(jnp.asarray(bad), T, *ARGS,
                                    interpret=True)
    assert np.all(np.isfinite(np.asarray(T_new)))
    np.testing.assert_allclose(np.asarray(T_new), np.asarray(T), atol=1e-6)
    assert float(dsq) == 0.0


def test_icp_loop_epilogue_path_matches_jnp(rng, monkeypatch):
    """End-to-end: _icp_loop with the kernel GN step (reduce + epilogue,
    interpret mode) converges to the jnp path's pose."""
    import dataclasses
    from functools import partial

    import tpuslam.icp as icp
    from tpuslam.config import ICPConfig
    from tpuslam.geom.cloud import PointCloud

    n = 4000
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    pts[:, 2] += 3.0
    nn = rng.normal(size=(n, 3))
    nn /= np.linalg.norm(nn, axis=1, keepdims=True)
    dst = PointCloud(points=jnp.asarray(pts),
                     normals=jnp.asarray(nn.astype(np.float32)),
                     mask=jnp.ones(n, bool))
    T_true = se3.exp(jnp.asarray([0.02, -0.015, 0.01, 0.01, 0.005, -0.01]))
    src = PointCloud(points=se3.transform_points(se3.inv(T_true), dst.points),
                     normals=se3.rotate_vectors(se3.inv(T_true), dst.normals),
                     mask=dst.mask)
    cfg = dataclasses.replace(ICPConfig(), max_iters=12, normal_dot_min=0.0)
    r_jnp = icp.align_clouds(src, dst, jnp.eye(4), cfg, use_grid=False)
    monkeypatch.setattr(icp, "_gn_step_xla",
                        partial(icp._gn_step_kernels, interpret=True))
    r_pal = icp.align_clouds(src, dst, jnp.eye(4), cfg, use_grid=False)
    np.testing.assert_allclose(np.asarray(r_pal.T), np.asarray(r_jnp.T),
                               atol=5e-5)
    np.testing.assert_allclose(np.asarray(r_pal.T), np.asarray(T_true),
                               atol=5e-4)
    assert float(r_pal.num_inliers) == pytest.approx(
        float(r_jnp.num_inliers), rel=1e-3)


@pytest.mark.parametrize("platform", ["cpu", "cuda"])
def test_gn_step_lowers_kernels_only_for_cuda(rng, platform):
    """icp.gn_step picks its implementation from the lowering platform:
    the Triton kernels for CUDA, the plain chain (LU solve) elsewhere."""
    from tpuslam.config import ICPConfig
    from tpuslam.icp import gn_step

    _, (x, q, nrm, w) = make_partials(rng, n=300)
    fn = jax.jit(lambda *a: gn_step(*a, cfg=ICPConfig()))
    txt = fn.trace(x, q, nrm, w, w > 0, jnp.eye(4)).lower(
        lowering_platforms=(platform,)).as_text()
    assert ("gn_reduce_partials" in txt) == (platform == "cuda")
    assert ("gn_epilogue" in txt) == (platform == "cuda")


@pytest.mark.gpu
def test_kernels_compiled_on_gpu_match_plain_chain(rng, gpu):
    """On the card: the compiled kernels against the plain chain."""
    from tpuslam.config import ICPConfig
    from tpuslam.icp import _gn_step_kernels, _gn_step_xla

    _, (x, q, nrm, w) = make_partials(rng, n=153600)
    T = se3.exp(jnp.asarray([0.02, -0.01, 0.03, 0.01, -0.02, 0.01]))
    args = [jax.device_put(a, gpu) for a in (x, q, nrm, w, w > 0, T)]
    cfg = ICPConfig()
    kern = jax.jit(lambda *a: _gn_step_kernels(*a, cfg=cfg))(*args)
    plain = jax.jit(lambda *a: _gn_step_xla(*a, cfg=cfg))(*args)
    np.testing.assert_allclose(np.asarray(kern[0]), np.asarray(plain[0]),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(kern[1]), np.asarray(plain[1]),
                               rtol=1e-4, atol=1e-2)
