"""The port stands without JAX: importing every module of
mitsuba_tpu_torch and rendering leaves `jax` out of sys.modules.

This file's own process has jax loaded (tests/conftest.py imports it), so
the checks run in fresh interpreters.
"""
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(1)
import mitsuba_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    mitsuba_tpu_torch.__path__, "mitsuba_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from mitsuba_tpu_torch.integrators.path import PathConfig, render
from mitsuba_tpu_torch.render.scene import cornell_box
img, aux = render(cornell_box(4, 4), PathConfig(max_depth=3, spp=1))
assert img.shape == (4, 4, 3) and bool(torch.isfinite(img).all())
assert int(aux["rays_traced"]) > 16
print(len(names), "jax" in sys.modules,
      sorted(m for m in sys.modules if m.startswith("jax")))
"""


def _run(args, cwd, timeout=300):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_port_imports_and_renders_without_jax():
    proc = _run(["-c", _PROBE, ROOT], cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    n_modules, jax_loaded, jax_mods = proc.stdout.split(maxsplit=2)
    assert int(n_modules) >= 15
    assert jax_loaded == "False", jax_mods


def test_chip_smoke_refuses_without_the_repo_or_a_card(tmp_path):
    """chip_smoke.py alone in a directory (or on a machine without CUDA)
    exits non-zero and prints no result line."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    proc = _run(["chip_smoke.py"], cwd=tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
