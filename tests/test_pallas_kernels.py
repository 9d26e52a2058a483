"""The GN reduce kernel (kernels/gn_triton.gn_partials, Triton route, run
in interpret mode here) against the plain jnp reduce and float64 numpy."""

import jax.numpy as jnp
import numpy as np
import pytest

from tpuslam.kernels.gn_reduce import gn_reduce
from tpuslam.kernels.gn_triton import gn_partials


def random_inputs(rng, n, valid_frac=0.8):
    x = jnp.asarray(rng.normal(size=(n, 3)), dtype=jnp.float32)
    q = x + jnp.asarray(rng.normal(scale=0.05, size=(n, 3)), dtype=jnp.float32)
    nrm = jnp.asarray(rng.normal(size=(n, 3)), dtype=jnp.float32)
    nrm = nrm / jnp.linalg.norm(nrm, axis=-1, keepdims=True)
    w = jnp.asarray(rng.uniform(size=n) < valid_frac, dtype=jnp.float32)
    return x, q, nrm, w


def folded(x, q, nrm, w, delta=0.05):
    """Kernel partial rows folded into (H, b, Σwr², Σvalid)."""
    s = np.asarray(gn_partials(x, q, nrm, w, delta, interpret=True),
                   np.float64).sum(0)
    H = np.zeros((6, 6))
    iu, ju = np.triu_indices(6)
    H[iu, ju] = s[:21]
    H[ju, iu] = s[:21]
    return H, s[21:27], s[27], s[28]


def float64_reference(x, q, nrm, w, delta=0.05):
    x, q, n = (np.asarray(a, np.float64) for a in (x, q, nrm))
    r = np.sum(n * (x - q), -1)
    ar = np.abs(r)
    wt = np.asarray(w) * np.where(ar <= delta, 1.0,
                                  delta / np.maximum(ar, 1e-12))
    J = np.concatenate([n, np.cross(x, n)], -1)
    return (J * wt[:, None]).T @ J, (J * wt[:, None]).T @ r


@pytest.mark.parametrize("n", [128, 4096, 5000])
def test_gn_reduce_pallas_matches_oracle(rng, n):
    x, q, nrm, w = random_inputs(rng, n)
    rows = gn_partials(x, q, nrm, w, 0.05, interpret=True)
    assert rows.shape == (-(-n // 2048), 32)       # one row per block
    H, b, wsq, inliers = folded(x, q, nrm, w)
    ref = gn_reduce(x, q, nrm, w, w > 0, 0.05)
    np.testing.assert_allclose(H, np.asarray(ref.H), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(b, np.asarray(ref.b), rtol=1e-4, atol=1e-4)
    assert inliers == pytest.approx(float(ref.num_inliers))
    assert wsq == pytest.approx(float(ref.weighted_sq_sum), rel=1e-4)
    H64, b64 = float64_reference(x, q, nrm, w)
    assert np.linalg.norm(H - H64) / np.linalg.norm(H64) < 1e-5
    assert np.linalg.norm(b - b64) / np.linalg.norm(b64) < 1e-5


def test_gn_reduce_pallas_huber_kicks_in(rng):
    """Outliers must be downweighted identically to the oracle."""
    x, q, nrm, w = random_inputs(rng, 1024, valid_frac=1.0)
    q = q.at[:100].add(10.0)
    ref = gn_reduce(x, q, nrm, w, w > 0, 0.05)
    H, b, *_ = folded(x, q, nrm, w)
    np.testing.assert_allclose(H, np.asarray(ref.H), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(b, np.asarray(ref.b), rtol=1e-4, atol=1e-4)


def test_gn_reduce_pallas_all_invalid(rng):
    x, q, nrm, _ = random_inputs(rng, 256)
    w = jnp.zeros((256,))
    H, b, wsq, inliers = folded(x, q, nrm, w)
    np.testing.assert_allclose(H, 0.0)
    np.testing.assert_allclose(b, 0.0)
    assert inliers == 0.0 and wsq == 0.0


def test_icp_with_forced_pallas_matches(rng, monkeypatch):
    """End-to-end: ICP with the kernel GN step (interpret mode standing in
    for the CUDA lowering) converges to the same pose as the jnp path."""
    from functools import partial

    import tpuslam.icp as icp
    from tests.test_icp_synthetic import make_clouds, pose_error
    from tpuslam.config import ICPConfig
    from tpuslam.geom import se3

    src_world, dst = make_clouds(n=1024)
    tau = jnp.array([0.03, -0.02, 0.04, 0.015, -0.02, 0.02])
    T_true = se3.exp(tau)
    src = src_world.transform(se3.inv(T_true))
    cfg = ICPConfig(max_iters=25, max_corr_dist=0.3, huber_delta=0.1)
    ref = icp.align_clouds(src, dst, se3.identity(), cfg, use_grid=False)
    monkeypatch.setattr(icp, "_gn_step_xla",
                        partial(icp._gn_step_kernels, interpret=True))
    res = icp.align_clouds(src, dst, se3.identity(), cfg, use_grid=False)
    t_err, r_err = pose_error(res.T, T_true)
    assert t_err < 8e-3 and r_err < 8e-3
    np.testing.assert_allclose(np.asarray(res.T), np.asarray(ref.T),
                               atol=5e-5)
