"""Config system round trip (SURVEY.md §5 "Config / flag system"): configs
are static jit arguments, so JSON loading must restore hashable tuples."""

import pytest

from tpuslam.config import ICPConfig, SLAMConfig


def test_json_roundtrip_restores_tuples():
    cfg = SLAMConfig().replace(
        icp=ICPConfig(iters_per_level=(10, 6, 4),
                      inner_steps_per_level=(2, 4, 4),
                      finest_subsample=2),
    )
    back = SLAMConfig.from_json(cfg.to_json())
    assert back == cfg
    assert isinstance(back.icp.iters_per_level, tuple)
    assert isinstance(back.icp.inner_steps_per_level, tuple)
    hash(back.icp)  # must stay usable as a static jit arg


def test_partial_json_overrides_defaults():
    cfg = SLAMConfig.from_json(
        '{"icp": {"inner_steps": 1, "packed_dtype": "float32"}}'
    )
    assert cfg.icp.inner_steps == 1
    assert cfg.icp.packed_dtype == "float32"
    # untouched knobs keep their defaults
    assert cfg.icp.max_corr_dist == ICPConfig().max_corr_dist
    assert cfg.height == SLAMConfig().height


def test_validate_accepts_defaults_and_rejects_bad():
    import pytest

    from tpuslam.config import ICPConfig, SLAMConfig

    SLAMConfig().validate()          # defaults are valid

    with pytest.raises(ValueError, match="iters_per_level"):
        SLAMConfig(icp=ICPConfig(pyramid_levels=4)).validate()
    with pytest.raises(ValueError, match="finest_subsample"):
        SLAMConfig(icp=ICPConfig(finest_subsample=3)).validate()
    with pytest.raises(ValueError, match="solver"):
        import dataclasses

        from tpuslam.config import PoseGraphConfig
        SLAMConfig(posegraph=PoseGraphConfig(solver="qr")).validate()
    with pytest.raises(ValueError, match="under 8 px"):
        SLAMConfig(height=24, width=24,
                   icp=ICPConfig(pyramid_levels=3)).validate()
    with pytest.raises(ValueError, match="cv_damping"):
        SLAMConfig(cv_damping=1.0).validate()


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_placement(tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR, when set, is where the cache lands and
    the package sets nothing else; unset, the cache is <checkout>/.jax_cache
    — a fixed path, so later processes hit it."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = root
    expect = os.path.join(root, ".jax_cache")
    if env_dir:
        expect = str(tmp_path / env_dir)
        env["JAX_COMPILATION_CACHE_DIR"] = expect
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax, tpuslam; "
         "print(jax.config.jax_compilation_cache_dir); "
         "print(tpuslam.compile_cache_dir())"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=120, check=True)
    assert out.stdout.split() == [expect, expect]
