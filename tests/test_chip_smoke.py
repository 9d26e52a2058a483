"""chip_smoke.py on the CPU: it must refuse to run without a GPU, `--multi`
must select only the sharded phase, and the last line must be the device
record the harness reads.  The phases themselves run on the card."""

import json
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import pytest

import chip_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_fails_without_gpu_and_prints_no_result(tmp_path, where):
    script = os.path.join(ROOT, "chip_smoke.py")
    if where == "alone":
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    out = subprocess.run([sys.executable, str(script)], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_multi_selects_only_its_phase():
    assert chip_smoke.phases_for(multi=True) == ["device", "multi"]
    assert chip_smoke.phases_for(multi=False) == [
        "device", "kernels", "odometry", "slam"]


@pytest.mark.parametrize("count", [1, 4])
def test_last_line_format(count):
    dev = SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
    line = chip_smoke.result_line([dev] * count)
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": count}}


def test_pose_delta_resolves_tiny_rotations():
    import numpy as np

    a = np.eye(4)
    b = np.eye(4)
    th = 3e-7
    b[:2, :2] = [[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]]
    b[0, 3] = 2e-7
    dt, dr = chip_smoke.pose_delta(a, b)
    assert dt == pytest.approx(2e-7, rel=1e-6)
    assert dr == pytest.approx(th, rel=1e-6)


def test_kernel_phase_interpret_mode():
    """The kernel-parity phase itself, on the Pallas interpreter."""
    chip_smoke.phase_kernels(widths=(3000,), interpret=True)
