"""The port's hair and height-span loaders (`mitsuba_tpu_torch/io/hairio.py`)
and their scene-file routes against the JAX package's, on the cases of
tests/test_shapes_extra.py:9,20,29.

- `load_hair`, `tessellate_fiber`, `load_hspan` (versions 1 and 2, a
  second span in some cells, cells in a shuffled order): vertices and
  normals bit for bit, faces (the topology and its order) exactly.
- `<shape type="hspan">` and `<shape type="hair">` under
  `tessellate="true"` (and a hair carrying subsurface, which the
  reference tessellates too) in a scene file: every table equal to
  `from_jax_scene` of the reference's load, bit for bit; the analytic
  hair (the reference's default) raises, naming ROADMAP A.12.
"""
import dataclasses

import numpy as np
import pytest
import torch

from mitsuba_tpu.io import hairio as jhair
from mitsuba_tpu.io import xml as jxml
from mitsuba_tpu_torch.interop import from_jax_scene
from mitsuba_tpu_torch.io import hairio as thair
from mitsuba_tpu_torch.io import xml as txml
from tests import torch_leftover_cases as lc
from tests.test_torch_xml import _same

torch.set_num_threads(1)


def _same_mesh(a, b):
    assert a.vertices.dtype == b.vertices.dtype
    assert np.array_equal(a.vertices, b.vertices)
    assert a.faces.dtype == b.faces.dtype and np.array_equal(a.faces,
                                                             b.faces)
    assert (a.normals is None) == (b.normals is None)
    if a.normals is not None:
        assert np.array_equal(a.normals, b.normals)


def test_hair_tube_equals_reference(tmp_path):
    p = str(tmp_path / "strand.hair")
    with open(p, "w") as f:
        f.write("0 0 0\n0 1 0\n0.3 2 0\n\n1 0 0\n1 1 0.2\n\n\n2 2 2\n")
    mesh = thair.load_hair(p, radius=0.1, n_sides=6)
    _same_mesh(mesh, jhair.load_hair(p, radius=0.1, n_sides=6))
    assert mesh.n_faces == (2 + 1) * 6 * 2
    lc.write_hair(p, 12, n_pts=8, seed=3)
    _same_mesh(thair.load_hair(p, radius=0.02, n_sides=5),
               jhair.load_hair(p, radius=0.02, n_sides=5))
    with open(p, "w") as f:
        f.write("1 2 3\n\n")
    with pytest.raises(ValueError, match="no fibers"):
        thair.load_hair(p)


@pytest.mark.parametrize("case", ["wave", "straight_x"])
def test_fiber_tessellation_equals_reference(case):
    s = np.linspace(0, 5, 20)
    if case == "wave":
        pts = np.stack([np.zeros(20), s, np.sin(s * 0.6)], -1)
    else:       # a fibre along x takes the other helper axis
        pts = np.stack([s, 0.01 * s ** 2, np.zeros(20)], -1)
    mesh = thair.tessellate_fiber(pts, 0.05, 8)
    _same_mesh(mesh, jhair.tessellate_fiber(pts, 0.05, 8))
    assert mesh.n_faces == 19 * 8 * 2


def _write_v1(path, n, rng):
    cells = [(x, y) for x in range(n) for y in range(n)]
    rng.shuffle(cells)
    with open(path, "w") as f:
        f.write("# a version-1 map\n\nnot a cell\n")
        for x, y in cells:
            h = 1.0 + 0.1 * (x + y) + 0.01 * rng.standard_normal()
            extra = f" {h - 0.8:.4f} {h - 0.5:.4f}" if (x + y) % 3 == 0 \
                else ""
            f.write(f"{x} {y} 0.0 {h:.4f}{extra}\n")


@pytest.mark.parametrize("version", [1, 2])
def test_hspan_equals_reference(tmp_path, version):
    rng = np.random.default_rng(version)
    if version == 2:
        p = lc.write_hspan(str(tmp_path / "snow.hspans2"), 9, seed=4)
    else:
        p = str(tmp_path / "snow.hspans1")
        _write_v1(p, 7, rng)
    mesh = thair.load_hspan(p, cell_size=0.5)
    _same_mesh(mesh, jhair.load_hspan(p, cell_size=0.5))
    n = 9 if version == 2 else 7
    # every span top of a cell joins its +x, +y and +xy cells' nearest
    # tops: the overhang spans add their own quads
    assert mesh.n_faces >= (n - 1) ** 2 * 2
    # one cell joins no neighbour; a line of the wrong width is skipped
    with open(p, "w") as f:
        f.write("0 0 0 1" + " 0" * 8 * (version - 1) + "\n1 1 0\n")
    with pytest.raises(ValueError, match="no triangles"):
        thair.load_hspan(p)


_SCENE = """<scene>
 <integrator type="path"><integer name="maxDepth" value="3"/></integrator>
 <camera type="perspective"><float name="fov" value="45"/>
  <transform name="toWorld"><lookAt ox="0" oy="2" oz="-4" tx="0" ty="0"
   tz="0" ux="0" uy="1" uz="0"/></transform>
  <film type="exrfilm"><integer name="width" value="8"/>
   <integer name="height" value="8"/></film></camera>
 <luminaire type="point"><point name="position" x="0" y="4" z="0"/>
  <rgb name="intensity" value="30"/></luminaire>
 {body}
</scene>"""

_HSPAN = """<shape type="hspan"><string name="filename" value="f.hspans2"/>
  <transform name="toWorld"><translate x="-4" z="-4"/><scale value="0.25"/>
  </transform><bsdf type="diffuse"/></shape>"""
_HAIR = """<shape type="hair"><string name="filename" value="h.hair"/>
  <boolean name="tessellate" value="{tess}"/>
  <float name="radius" value="0.02"/>{sub}
  <transform name="toWorld"><rotate y="1" angle="20"/></transform>
  <bsdf type="roughconductor"/></shape>"""
CASES = {
    "hspan": _HSPAN,
    "hair": _HAIR.format(tess="true", sub=""),
    "both": _HSPAN + _HAIR.format(tess="true", sub=""),
    "hair_subsurface": _HAIR.format(
        tess="false", sub='<subsurface type="dipole"><integer '
        'name="irrSamples" value="16"/></subsurface>'),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_scene_file_routes_equal_reference(tmp_path, case):
    lc.write_hspan(str(tmp_path / "f.hspans2"), 9, seed=1)
    lc.write_hair(str(tmp_path / "h.hair"), 6, n_pts=5, seed=2)
    xml = _SCENE.replace("{body}", CASES[case])
    port, _ = txml.load_scene_string(xml, base_dir=str(tmp_path),
                                     device="cpu")
    ref, _ = jxml.load_scene_string(xml, base_dir=str(tmp_path))
    conv = from_jax_scene(ref, device="cpu")
    # a subsurface entry's irradiance points are drawn by each package's
    # own sampler on the host (tests/test_torch_subsurface.py holds them)
    for f in dataclasses.fields(port):
        if f.name != "subsurface":
            _same(getattr(port, f.name), getattr(conv, f.name), f.name)
    want = {"hspan": 8 * 8 * 2, "hair": 6 * 4 * 6 * 2}
    want["both"] = want["hspan"] + want["hair"]
    want["hair_subsurface"] = want["hair"]
    assert port.geom.n_tris >= want[case]


def test_analytic_hair_raises(tmp_path):
    lc.write_hair(str(tmp_path / "h.hair"), 2, n_pts=3)
    xml = _SCENE.replace("{body}", _HAIR.format(tess="false", sub=""))
    with pytest.raises(NotImplementedError, match="A.12"):
        txml.load_scene_string(xml, base_dir=str(tmp_path), device="cpu")
    # the same file loads in full under tessellate="true"
    scene, _ = txml.load_scene_string(
        xml.replace('value="false"', 'value="true"'),
        base_dir=str(tmp_path), device="cpu")
    assert scene.geom.n_tris == 2 * 2 * 6 * 2
