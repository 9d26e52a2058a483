"""Ring-sharded frame-to-map ICP vs the unsharded exact path
(SURVEY.md §2c ring/CP rows; 8 fake devices, real ppermute)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.test_icp_synthetic import make_clouds, pose_error
from tpuslam.config import ICPConfig
from tpuslam.dist.mesh import make_mesh
from tpuslam.dist.ring_map import align_to_map_ring
from tpuslam.geom import se3
from tpuslam.icp import align_clouds

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 2, reason="needs multi-device backend"
)


def test_ring_map_icp_matches_exact():
    src_world, dst = make_clouds(n=1024)
    tau = jnp.array([0.03, -0.02, 0.04, 0.015, -0.02, 0.02])
    T_true = se3.exp(tau)
    src = src_world.transform(se3.inv(T_true))
    cfg = ICPConfig(max_iters=25, max_corr_dist=0.3, huber_delta=0.1)

    ref = align_clouds(src, dst, se3.identity(), cfg, use_grid=False)
    mesh = make_mesh()
    out = align_to_map_ring(src, dst, se3.identity(), cfg, mesh)

    # both are exact-NN point-to-plane; they should land on the same pose
    np.testing.assert_allclose(np.asarray(out.T), np.asarray(ref.T),
                               atol=5e-4)
    t_err, r_err = pose_error(out.T, T_true)
    assert t_err < 8e-3 and r_err < 8e-3


def test_ring_map_handles_empty_shards():
    """Map smaller than the device count still works (masked padding)."""
    src_world, dst = make_clouds(n=512)
    # keep only 5 valid map points — most shards end up empty
    mask = np.zeros(dst.points.shape[0], dtype=bool)
    mask[:5] = True
    tiny_map = dst._replace(mask=jnp.asarray(mask & np.asarray(dst.mask)))
    cfg = ICPConfig(max_iters=3, max_corr_dist=0.3)
    mesh = make_mesh()
    out = align_to_map_ring(src_world, tiny_map, se3.identity(), cfg, mesh)
    assert np.all(np.isfinite(np.asarray(out.T)))

