"""The port stands without JAX and without the JAX package: importing
every module of mitsuba_tpu_torch (media/, the volumetric path tracer,
guiding, io/volio.py, ops/probes.py and the probe drivers of probes/,
core/spectral.py, parallel/, graft_entry.py, the preview and gui.py
among them) and rendering a brute and an instanced cluster scene (which
builds BVHs with the port's own native builder) and the brute scene in a
medium; rendering, guided, in a Gaussian-flake grid medium and a grid
medium inside a shape; and rendering
scenes/cornell.xml through `python -m mitsuba_tpu_torch`, leave `jax`, every
`mitsuba_tpu` module and the reference's `scripts` out of sys.modules,
and no source file of the port, chip_smoke.py or the case inputs it
loads (tests/torch_*_cases.py) imports the JAX package or the
reference's scripts.

This file's own process has jax loaded (tests/conftest.py imports it), so
the checks run in fresh interpreters.
"""
import glob
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the spectra, the sharded render, the render service, the graft entry
# points and the preview
NEW_MODULES = (
    "mitsuba_tpu_torch.core.spectral", "mitsuba_tpu_torch.parallel",
    "mitsuba_tpu_torch.parallel.mesh", "mitsuba_tpu_torch.parallel.multihost",
    "mitsuba_tpu_torch.parallel.scaling", "mitsuba_tpu_torch.parallel.server",
    "mitsuba_tpu_torch.graft_entry", "mitsuba_tpu_torch.utils.checkpoint",
    "mitsuba_tpu_torch.utils.tonemap", "mitsuba_tpu_torch.render.preview",
    "mitsuba_tpu_torch.gui")

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
from mitsuba_tpu_torch.render.scene import cornell_box, instanced_scene
for scene in (cornell_box(4, 4, device="cpu"),
              instanced_scene(4, 4, 6, 12, device="cpu")):
    img, aux = render(scene, PathConfig(max_depth=2, spp=1))
    assert img.shape == (4, 4, 3) and bool(torch.isfinite(img).all())
    assert int(aux["rays_traced"]) > 16
assert scene.geom.backend == "cluster" and scene.geom.has_instances
from mitsuba_tpu_torch.integrators.volpath import render_volpath
from mitsuba_tpu_torch.media import make_homogeneous
img, aux = render_volpath(cornell_box(4, 4, device="cpu"),
                          make_homogeneous((0.002,) * 3, (0.0,) * 3, g=0.4),
                          PathConfig(max_depth=3, spp=2))
assert img.shape == (4, 4, 3) and bool(torch.isfinite(img).all())
assert {"mitsuba_tpu_torch.media.medium", "mitsuba_tpu_torch.media.phase",
        "mitsuba_tpu_torch.integrators.guiding", "mitsuba_tpu_torch.io.volio",
        "mitsuba_tpu_torch.integrators.volpath",
        "mitsuba_tpu_torch.integrators.direct",
        "mitsuba_tpu_torch.ops.cluster", "mitsuba_tpu_torch.ops.probes",
        "mitsuba_tpu_torch.probes.kernel_cost",
        "mitsuba_tpu_torch.probes.r3_kernel", "mitsuba_tpu_torch.probes.r3_mt",
        "mitsuba_tpu_torch.probes.r3_refinebits",
        "mitsuba_tpu_torch.probes.r5_megakernel"} <= set(names)
assert set(NEW_MODULES) <= set(names)
# the exact cull's L1 walks and the v1 cluster intersector
from mitsuba_tpu_torch.ops import cluster as cp
from mitsuba_tpu_torch.ops import exact as ep
from mitsuba_tpu_torch.render.intersect import build_geometry
from mitsuba_tpu_torch.render.mesh import make_sphere_mesh
geom = build_geometry([(make_sphere_mesh([0, 0, 0], 1.0, 12, 24), 0, -1)],
                      backend="cluster")
o = torch.tensor([[0.0, 0.0, -3.0], [0.0, 3.0, 0.0]])
d = torch.tensor([[0.0, 0.0, 1.0], [0.0, -1.0, 0.0]])
mint, maxt = torch.full((2,), 1e-4), torch.full((2,), 1e30)
for walk in ep.WALKS:
    hit = ep.exact_closest(geom.ex_tables, o, d, mint, maxt,
                           geom.ex_caps[0], walk=walk)
    assert bool(hit[4].all()) and torch.allclose(hit[0], torch.tensor(2.0),
                                                 atol=0.02)
hit = cp.cluster_closest(cp.table_dict(cp.geometry_tables(geom), "cpu"), o,
                         d, mint, maxt)
assert bool(hit[4].all()) and torch.allclose(hit[0], torch.tensor(2.0),
                                             atol=0.02)
ref = sorted(m for m in sys.modules
             if m in ("mitsuba_tpu", "scripts")
             or m.startswith(("mitsuba_tpu.", "scripts.")))
print(len(names), "jax" in sys.modules,
      sorted(m for m in sys.modules if m.startswith("jax")) + ref)
"""


_MEDIA_PROBE = r"""
import sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
torch.set_num_threads(1)
from mitsuba_tpu_torch.integrators.path import PathConfig
from mitsuba_tpu_torch.integrators.volpath import (
    render_volpath_guided, render_volpath_media)
from mitsuba_tpu_torch.media import make_heterogeneous
from mitsuba_tpu_torch.render import mesh as mesh_mod
from mitsuba_tpu_torch.render.scene import SceneBuilder, cornell_box
grid = np.ones((2, 2, 2), np.float32)
med = make_heterogeneous(grid, np.eye(4) * 1e-3, (0.002,) * 3, (0.0,) * 3,
                         flake_stddev=0.3)
img, _ = render_volpath_guided(cornell_box(2, 2, device="cpu"), med,
                               PathConfig(max_depth=2, spp=2), res=2)
assert bool(torch.isfinite(img).all())
b = SceneBuilder()
b.width = b.height = 4
m = b.add_medium((0.5,) * 3, (0.1,) * 3, density=grid,
                 world_to_grid=np.eye(4))
b.add_shape(mesh_mod.make_box([-1, -1, -1], [1, 1, 1]), b.materials.null(),
            interior_medium=m)
b.add_area_emitter_shape(mesh_mod.make_quad([-1, 3, -1], [1, 3, -1],
                                            [1, 3, 1], [-1, 3, 1]),
                         b.materials.lambertian((0.0,) * 3), (5.0,) * 3)
img, _ = render_volpath_media(b.build(device="cpu"),
                              PathConfig(max_depth=2, spp=2))
assert bool(torch.isfinite(img).all())
print(sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "mitsuba_tpu", "scripts")))
"""


def _run(args, cwd, timeout=300):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_port_imports_and_renders_without_jax():
    proc = _run(["-c", f"NEW_MODULES = {NEW_MODULES!r}\n" + _PROBE, ROOT],
                cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    n_modules, jax_loaded, loaded = proc.stdout.split(maxsplit=2)
    assert int(n_modules) >= 20
    assert jax_loaded == "False" and loaded.strip() == "[]", loaded


def test_media_render_without_jax():
    """A guided render in a Gaussian-flake grid medium and a grid medium
    inside a shape, in a fresh interpreter: no JAX module is loaded."""
    proc = _run(["-c", _MEDIA_PROBE, ROOT], cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]", proc.stdout


# `import mitsuba_tpu...` or `from mitsuba_tpu... import`, not the port
_REF_IMPORT = re.compile(
    r"^\s*(from\s+mitsuba_tpu(\.|\s)|import\s+mitsuba_tpu(\.|\s|,|$))",
    re.MULTILINE)


def test_no_source_of_the_port_imports_the_reference():
    # the port, chip_smoke.py and the case inputs chip_smoke.py loads
    files = glob.glob(os.path.join(ROOT, "mitsuba_tpu_torch", "**", "*.py"),
                      recursive=True) + [os.path.join(ROOT, "chip_smoke.py")]
    files += glob.glob(os.path.join(ROOT, "tests", "torch_*_cases.py"))
    assert len(files) >= 20
    scanned = {os.path.relpath(f, ROOT) for f in files}
    for name in NEW_MODULES:
        path = name.replace(".", os.sep)
        assert (path + ".py" in scanned
                or os.path.join(path, "__init__.py") in scanned), name
    assert {os.path.join("tests", f"torch_{c}_cases.py")
            for c in ("spectral", "parallel")} <= scanned
    offenders = []
    for path in files:
        with open(path, encoding="utf-8") as f:
            src = f.read()
        offenders += [f"{os.path.relpath(path, ROOT)}: {m.group(0).strip()}"
                      for m in _REF_IMPORT.finditer(src)]
        if re.search(r"^\s*(import|from)\s+jax\b", src, re.MULTILINE):
            offenders.append(f"{os.path.relpath(path, ROOT)}: jax")
        if re.search(r"^\s*(import|from)\s+scripts\b", src, re.MULTILINE):
            offenders.append(f"{os.path.relpath(path, ROOT)}: scripts")
    assert not offenders, offenders
    # the pattern itself catches the reference's imports, not the port's
    assert _REF_IMPORT.search("from mitsuba_tpu.render import mesh")
    assert _REF_IMPORT.search("import mitsuba_tpu")
    assert not _REF_IMPORT.search("from mitsuba_tpu_torch.ops import bvh")


def test_cli_renders_a_scene_file_without_jax(tmp_path):
    """`python -m mitsuba_tpu_torch --cpu scenes/cornell.xml` at 8x8x1, as
    a user runs it; `-X importtime` lists every module it imports."""
    out = tmp_path / "cornell.exr"
    proc = _run(["-X", "importtime", "-m", "mitsuba_tpu_torch", "--cpu",
                 "scenes/cornell.xml", "-D", "depth=2", "-D", "spp=1", "-D",
                 "width=8", "-D", "height=8", "-o", str(out)], cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "wrote" in proc.stdout and out.stat().st_size > 0
    imported = {ln.rsplit("|", 1)[-1].strip()
                for ln in proc.stderr.splitlines()
                if ln.startswith("import time:")}
    assert "mitsuba_tpu_torch.io.xml" in imported
    assert not {m for m in imported if m.split(".")[0] in (
        "jax", "mitsuba_tpu", "scripts")}


def test_chip_smoke_refuses_without_the_repo_or_a_card(tmp_path):
    """chip_smoke.py alone in a directory (or on a machine without CUDA)
    exits non-zero and prints no result line."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    proc = _run(["chip_smoke.py"], cwd=tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
