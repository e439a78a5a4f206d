"""chip_smoke.py's phases on the CPU at tiny sizes, its refusal to run
without a GPU, and the import closure of the path it drives."""
import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(width=160, height=120, n_features=150, n_levels=4, n_slice=256,
            local_ba=(4, 64, 256), global_ba=(6, 128, 512), cg_iters=8, eg=(12, 32))


def _run_script(cwd, *args):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable, "chip_smoke.py", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _no_ok_line(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            if json.loads(line).get("ok"):
                return False
        except (ValueError, AttributeError):
            pass
    return True


def test_device_phase_refuses_cpu():
    with pytest.raises(RuntimeError, match="needs a gpu"):
        chip_smoke.phase_device("gpu")


def test_device_phase_returns_requested_devices():
    devs = chip_smoke.phase_device("cpu", count=4)
    assert [d.platform for d in devs] == ["cpu"] * 4


def test_script_fails_without_gpu():
    res = _run_script(REPO)
    assert res.returncode != 0 and _no_ok_line(res.stdout), res.stdout[-2000:]
    assert "needs a gpu" in res.stderr


def test_script_fails_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    res = _run_script(tmp_path)
    assert res.returncode != 0 and _no_ok_line(res.stdout), res.stdout[-2000:]


def test_kernels_phase_tiny():
    dev, ref = jax.devices()[:2]
    chip_smoke.phase_kernels(dev, ref, TINY)


def test_four_cards_phase_tiny():
    chip_smoke.phase_four_cards(jax.devices()[:4], global_ba=TINY["global_ba"],
                                eg=TINY["eg"])


def test_end_to_end_phase_short():
    res = chip_smoke.phase_end_to_end(frames=40, warmup=False)
    assert res["keyframes"] >= 3


def test_failure_phases():
    assert chip_smoke.phase_forced_loss() is not None
    assert chip_smoke.phase_save_load() is not None


def test_smoke_path_imports_only_jax_numpy_scipy():
    """With cv2 blocked, rendering a frame and building the shipping Slam
    imports nothing beyond JAX (and what JAX itself loads), numpy, scipy,
    the standard library and this repository."""
    code = """
import sys
sys.modules["cv2"] = None  # any `import cv2` now raises ImportError
import jax, jax.numpy, numpy, scipy, scipy.linalg, scipy.spatial.transform
jax.devices()
before = {m.split(".")[0] for m in sys.modules}
import chip_smoke
from orbslam_jpminipc import run
from orbslam_jpminipc.io.dataset import SyntheticSequence
img = SyntheticSequence(n_frames=2).render(0)
slam = chip_smoke._shipping_slam()()
assert img.shape == (480, 640) and slam.n_keyframes == 0
new = {m.split(".")[0] for m in sys.modules} - before
own = {"chip_smoke", "__graft_entry__", "orbslam_jpminipc"}
print(sorted(m for m in new - own - set(sys.stdlib_module_names)))
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().splitlines()[-1] == "[]", res.stdout
