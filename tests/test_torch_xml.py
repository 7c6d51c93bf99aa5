"""The port's scene-file front end against the JAX package's: the XML
loader (`mitsuba_tpu_torch.io.xml`), its shape, BSDF, texture, luminaire
and camera plugins, the mesh files (`io/meshio.py`), the resolver, the
transforms, the sRGB curve and the Welch t-test.

A scene that the reference loads from a file, converted by
`from_jax_scene`, must equal the scene that the port loads from the same
file: every table, field by field, integers exactly and floats bit for
bit, except a Preetham sky's baked tables, which each package bakes with
its own float32 transcendentals (within 1e-4 relative, as
tests/test_torch_env.py holds the bake). The port's renders of the two
scenes (16 x 16 px, 2 spp, depth 3, seed 0; both with the port's sky)
must then be equal bit for bit. The sRGB curve is compared within 4
float32 ulps, the most measured: XLA's float32 pow rounds differently
from numpy's and PyTorch's (an `<srgb>` value is compared the same way).

The reference is never rendered here; each test takes well under 5 s.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import mitsuba_tpu.render.camera  # noqa: F401  (camera plugins)
from mitsuba_tpu.core import spectrum as jspec
from mitsuba_tpu.core import transform as jtf
from mitsuba_tpu.io import meshio as jmeshio
from mitsuba_tpu.io import resolver as JR
from mitsuba_tpu.io import xml as jxml
from mitsuba_tpu.render import mesh as jmesh
from mitsuba_tpu.utils import ttest as jttest
from mitsuba_tpu_torch.core import registry
from mitsuba_tpu_torch.core import spectrum as tspec
from mitsuba_tpu_torch.core import transform as ttf
from mitsuba_tpu_torch.integrators import PathConfig, render, render_volpath
from mitsuba_tpu_torch.interop import from_jax_medium, from_jax_scene
from mitsuba_tpu_torch.io import meshio
from mitsuba_tpu_torch.io import resolver as TR
from mitsuba_tpu_torch.io import xml as txml
from mitsuba_tpu_torch.render import mesh as tmesh
from mitsuba_tpu_torch.utils import ttest as tttest
import torch_xml_cases as xc

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORNELL = os.path.join(REPO, "scenes", "cornell.xml")
SMALL = dict(depth=3, spp=2, width=16, height=16)

_CAMERA = """
 <camera type="perspective">
  <float name="fov" value="{fov}"/>
  <transform name="toWorld">{xf}</transform>
  <sampler type="independent"><integer name="sampleCount" value="2"/></sampler>
  <film type="exrfilm"><integer name="width" value="16"/>
   <integer name="height" value="16"/></film>
 </camera>"""
_SKY = """
 <luminaire type="sky"><float name="turbidity" value="3"/>
  <vector name="sunDirection" x="0.35" y="0.6" z="-0.5"/></luminaire>"""


def _scene(body, fov=40, xf='<lookAt ox="0" oy="1.4" oz="-3.2" tx="0" '
           'ty="0.7" tz="0" ux="0" uy="1" uz="0"/>', light=_SKY):
    return (f"<scene><integrator type='path'>"
            f"<integer name='maxDepth' value='3'/></integrator>"
            f"{_CAMERA.format(fov=fov, xf=xf)}{light}{body}</scene>")


# bench config 2's materials on a floor, an analytic glass sphere
CONFIG2 = _scene("""
 <bsdf id="white" type="diffuse"><rgb name="reflectance" value="0.725 0.71 0.68"/></bsdf>
 <shape type="obj"><string name="filename" value="floor.obj"/><ref id="white"/></shape>
 <shape type="obj"><string name="filename" value="box.obj"/>
  <transform name="toWorld"><translate x="-1" y="0" z="0.5"/></transform>
  <bsdf type="roughconductor"><float name="alpha" value="0.15"/>
   <string name="distribution" value="ggx"/></bsdf></shape>
 <shape type="obj"><string name="filename" value="box.obj"/>
  <transform name="toWorld"><rotate y="1" angle="30"/><translate x="0.6" y="0" z="0.8"/></transform>
  <bsdf type="mirror"><rgb name="specularReflectance" value="0.95"/></bsdf></shape>
 <shape type="sphere"><point name="center" x="0" y="0.45" z="-0.4"/>
  <float name="radius" value="0.45"/>
  <bsdf type="dielectric"><float name="intIOR" value="1.5"/></bsdf></shape>
 <shape type="obj"><string name="filename" value="light.obj"/>
  <bsdf type="diffuse"><rgb name="reflectance" value="0"/></bsdf>
  <luminaire type="area"><rgb name="intensity" value="18.4 15.6 8.0"/></luminaire></shape>
""", light="")

# a few hundred triangles in an OBJ (cluster under auto), a checkerboard
# floor (phong body, sRGB colours) under the sky
MESH = _scene("""
 <shape type="obj"><string name="filename" value="ball.obj"/>
  <bsdf type="phong"><srgb name="diffuseReflectance" value="#a08060"/>
   <spectrum name="specularReflectance" value="0.3"/>
   <float name="exponent" value="40"/></bsdf></shape>
 <shape type="ply"><string name="filename" value="floor.ply"/>
  <bsdf type="diffuse"><texture type="checkerboard" name="reflectance">
   <rgb name="brightColor" value="0.7"/><rgb name="darkColor" value="0.2 0.2 0.25"/>
   <float name="uscale" value="8"/><float name="vscale" value="8"/>
   <float name="uoffset" value="0.25"/></texture></bsdf></shape>
""")

# a shapegroup placed twice (flattened, as the reference flattens it)
GROUP = _scene("""
 <shape type="shapegroup" id="pair">
  <shape type="serialized"><string name="filename" value="box.serialized"/>
   <bsdf type="diffuse"><rgb name="reflectance" value="0.6 0.2 0.1"/></bsdf></shape>
  <shape type="sphere"><float name="radius" value="0.3"/>
   <transform name="toWorld"><translate y="1.2"/></transform>
   <bsdf type="twosided"><bsdf type="diffuse"/></bsdf></shape>
 </shape>
 <shape type="instance"><ref id="pair"/>
  <transform name="toWorld"><scale value="0.5"/><translate x="-0.8"/></transform></shape>
 <shape type="instance"><ref id="pair"/>
  <transform name="toWorld"><rotate y="1" angle="45"/><scale value="0.7"/>
   <translate x="0.8" z="0.3"/></transform></shape>
 <shape type="obj"><string name="filename" value="floor.obj"/></shape>
""")

# tests/test_xml.py:22-117, with the sky (the port builds no scene
# without an emitter) and a floor under the spheres
REFS = _scene("""
 <bsdf id="m" type="lambertian"><rgb name="reflectance" value="#ff0000"/></bsdf>
 <shape type="sphere"><point name="center" x="0" y="0" z="5"/>
   <float name="radius" value="1"/><ref id="m"/></shape>
""", fov=45, xf='<translate x="1" y="2" z="3"/>')
ORDER = _scene("""
 <shape type="sphere"><float name="radius" value="1"/>
  <bsdf type="lambertian"/></shape>
 <shape type="obj"><string name="filename" value="floor.obj"/>
  <transform name="toWorld"><translate x="1"/><scale value="2"/>
   <rotate x="1" y="1" angle="10"/><matrix value="1 0 0 0.5 0 1 0 0 0 0 1 0 0 0 0 1"/>
  </transform></shape>
""", xf='<translate x="1"/><scale value="2"/>'
        '<lookAt ox="0" oy="1" oz="-4" tx="0" ty="0" tz="0"/>')
VARS = _scene("""
 <shape type="sphere"><float name="radius" value="$r"/>
  <bsdf type="lambertian"/></shape>
""", xf='<lookAt ox="0" oy="1" oz="-8" tx="0" ty="0" tz="0" ux="0" '
        'uy="1" uz="0"/>').replace("value='3'", "value='$d'")
BSDFS = _scene("""
 <shape type="sphere"><bsdf type="dielectric">
   <float name="intIOR" value="1.33"/></bsdf></shape>
 <shape type="sphere"><bsdf type="roughmetal">
   <float name="alphaB" value="0.2"/></bsdf></shape>
 <shape type="sphere"><bsdf type="twosided">
   <bsdf type="lambertian"/></bsdf></shape>
""")


def _write_assets(d):
    meshio.save_obj(os.path.join(d, "floor.obj"), tmesh.make_quad(
        [-3, 0, -3], [-3, 0, 3], [3, 0, 3], [3, 0, -3]))
    meshio.save_obj(os.path.join(d, "light.obj"), tmesh.make_quad(
        [-0.5, 2.5, -0.5], [0.5, 2.5, -0.5], [0.5, 2.5, 0.5],
        [-0.5, 2.5, 0.5]))
    meshio.save_obj(os.path.join(d, "box.obj"),
                    tmesh.make_box([-0.3, 0, -0.3], [0.3, 0.9, 0.3]))
    meshio.save_serialized(os.path.join(d, "box.serialized"),
                           tmesh.make_box([-0.4, 0, -0.4], [0.4, 0.6, 0.4]))
    meshio.save_obj(os.path.join(d, "ball.obj"), tmesh.make_sphere_mesh(
        [0, 0.8, 0], 0.8, 12, 16))
    with open(os.path.join(d, "floor.ply"), "w") as f:
        f.write("ply\nformat ascii 1.0\nelement vertex 4\n"
                "property float x\nproperty float y\nproperty float z\n"
                "property float u\nproperty float v\n"
                "element face 1\nproperty list uchar int vertex_indices\n"
                "end_header\n-6 0 -6 0 0\n-6 0 6 1 0\n6 0 6 1 1\n"
                "6 0 -6 0 1\n4 0 1 2 3\n")
    xc.write_config3_twin(d, 24, 48)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("xml_assets"))
    _write_assets(d)
    return d


# case: (scene source, params, backend)
CASES = {
    "cornell": (CORNELL, dict(depth=4, spp=8, width=24, height=24), "auto"),
    "config2": (CONFIG2, {}, "auto"),
    "mesh_cluster": (MESH, {}, "auto"),
    "mesh_bvh": (MESH, {}, "bvh"),
    "shapegroup": (GROUP, {}, "auto"),
    "refs": (REFS, {}, "auto"),
    "transform_order": (ORDER, {}, "auto"),
    "variables": (VARS, {"d": 3, "r": 2.5}, "auto"),
    "bsdf_map": (BSDFS, {}, "auto"),
    # tests/torch_xml_cases.py's twin of config 3 (binary PLY), a
    # 2,210-triangle body
    "config3_twin": ("config3.xml", SMALL, "auto"),
}


def _load(mod, case, assets, **kw):
    src, params, backend = CASES[case]
    if src.endswith(".xml"):
        return mod.load_scene(os.path.join(assets, src), params=params,
                              backend=backend, **kw)
    return mod.load_scene_string(src, params=params, base_dir=assets,
                                 backend=backend, **kw)


@pytest.fixture(scope="module", params=sorted(CASES))
def loaded(request, assets):
    jscene, jcfg = _load(jxml, request.param, assets)
    port, cfg = _load(txml, request.param, assets, device="cpu")
    return (request.param, port, cfg,
            from_jax_scene(jscene, device="cpu"), jcfg)


def _same(a, b, where, rtol=0.0):
    """Field by field: tensors by their bytes (floats within rtol where it
    is given), tables recursively."""
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype \
            and a.shape == b.shape, where
        if rtol and a.is_floating_point():
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=rtol,
                                       atol=1e-6, err_msg=where)
        else:
            assert np.array_equal(a.numpy().reshape(-1).view(np.uint8),
                                  b.numpy().reshape(-1).view(np.uint8)), where
    elif dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a) is type(b), where
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name),
                  f"{where}.{f.name}", rtol)
    elif isinstance(a, (tuple, list)):
        assert isinstance(b, (tuple, list)) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]", rtol)
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f"{where}[{k}]", rtol)
    else:
        assert a == b, (where, a, b)


def _with_sky(scene):
    return scene.emitters.env_id >= 0


# the alias table of a baked sky: a discontinuous function of the bake
# (a pairing flips when two texels' weights cross), so two packages'
# bakes equal within 1e-4 give different tables
_ALIAS = ("env_prob", "env_alias")


def _same_scene(port, conv, where):
    """Every table bit for bit; a sky's baked tables (the emitter table's
    floats) within the bake's own 1e-4 (tests/test_torch_env.py), its
    alias table left out."""
    for f in dataclasses.fields(port):
        a, b = getattr(port, f.name), getattr(conv, f.name)
        rtol = 0.0
        if f.name == "emitters" and _with_sky(port):
            rtol = 1e-4
            a, b = (dataclasses.replace(x, **{k: None for k in _ALIAS})
                    for x in (a, b))
        _same(a, b, f"{where}.{f.name}", rtol)


def test_scene_tables_equal_reference(loaded):
    case, port, _cfg, conv, _jcfg = loaded
    _same_scene(port, conv, case)
    want = {"cornell": "brute", "mesh_cluster": "cluster", "mesh_bvh": "bvh",
            "config3_twin": "cluster"}
    if case in want:
        assert port.geom.backend == want[case]
    if case == "shapegroup":
        # two instances of a 12-triangle box and a sphere, and the floor
        assert port.geom.n_tris == 2 * 12 + 2
        assert port.geom.sph_r.shape[0] == 2


def test_config_equals_reference(loaded):
    _case, _port, cfg, _conv, jcfg = loaded
    assert cfg == jcfg


def test_render_equals_converted_reference(loaded):
    case, port, _cfg, conv, _jcfg = loaded
    port = dataclasses.replace(port, width=16, height=16)
    # a sky is baked by each package (equal within 1e-4, above): both
    # renders take the port's bake, so that what is compared is the rest
    conv = dataclasses.replace(conv, width=16, height=16,
                               emitters=port.emitters)
    pc = PathConfig(max_depth=3, spp=2, remat=False)
    a, _ = render(port, pc, seed=0)
    b, _ = render(conv, pc, seed=0)
    assert bool(torch.isfinite(a).all()) and float(a.mean()) > 0, case
    assert torch.equal(a, b), case


def test_config3_twin_equals_textured_mesh_scene(assets, monkeypatch):
    """The twin's tables are `textured_mesh_scene`'s (its body cut to the
    twin's 24 x 48) with the two material rows in the other order, and
    its render is the same bit for bit."""
    from mitsuba_tpu_torch.render import scene as scene_mod

    class _Small:
        make_quad = staticmethod(tmesh.make_quad)

        @staticmethod
        def make_sphere_mesh(c, r, *_n):
            return tmesh.make_sphere_mesh(c, r, 24, 48)

    monkeypatch.setattr(scene_mod, "mesh_mod", _Small)
    ref = scene_mod.textured_mesh_scene(16, 16, backend="cluster",
                                        device="cpu")
    twin, _ = txml.load_scene(os.path.join(assets, "config3.xml"),
                              params=SMALL, device="cpu")
    assert twin.geom.backend == "cluster"
    assert set(xc.table_diffs(twin, ref)) == {
        "geom.material_id", "geom.shade_pack", "materials.kind",
        "materials.reflectance", "materials.specular", "materials.exponent",
        "materials.tex_id"}
    assert xc.table_diffs(twin, xc.with_material_order(ref)) == []
    pc = PathConfig(max_depth=3, spp=2, remat=False)
    assert torch.equal(render(twin, pc)[0], render(ref, pc)[0])


def test_reference_cases_read_as_in_test_xml(assets):
    """tests/test_xml.py's own assertions on the port's loader."""
    scene, cfg = _load(txml, "refs", assets, device="cpu")
    np.testing.assert_allclose(scene.camera.to_world.numpy()[:3, 3],
                               [1, 2, 3], atol=1e-6)
    np.testing.assert_allclose(scene.materials.reflectance.numpy()[0],
                               [1, 0, 0], atol=1e-6)
    scene, _ = txml.load_scene_string(_scene(
        '<shape type="sphere"><float name="radius" value="1"/>'
        '<bsdf type="lambertian"/></shape>',
        xf='<translate x="1"/><scale value="2"/>'), device="cpu")
    np.testing.assert_allclose(scene.camera.to_world.numpy()[:3, 3],
                               [2, 0, 0], atol=1e-6)
    _, cfg = _load(txml, "variables", assets, device="cpu")
    assert cfg["maxDepth"] == 3
    scene, _ = _load(txml, "bsdf_map", assets, device="cpu")
    from mitsuba_tpu_torch.bsdfs.table import (
        DIELECTRIC, LAMBERTIAN, ROUGH_CONDUCTOR,
    )
    assert scene.materials.kind.tolist() == [DIELECTRIC, ROUGH_CONDUCTOR,
                                             LAMBERTIAN]
    np.testing.assert_allclose(float(scene.materials.eta[0]), 1.33,
                               atol=1e-5)
    assert bool(scene.materials.two_sided[2])


def test_undefined_variable_raises():
    with pytest.raises(txml.SceneParseError, match="nope"):
        txml.load_scene_string(
            "<scene><integrator type='path'>"
            "<integer name='maxDepth' value='$nope'/></integrator>"
            "<shape type='sphere'><bsdf type='lambertian'/></shape>"
            "<luminaire type='sky'/></scene>", device="cpu")
    with pytest.raises(txml.SceneParseError, match="not found"):
        txml.load_scene_string("<scene><shape type='sphere'><ref id='x'/>"
                               "</shape></scene>", device="cpu")


def test_loader_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        txml.load_scene(CORNELL, params=SMALL)


MEDIUM = _scene("""
 <medium type="homogeneous">
  <rgb name="sigmaS" value="0.02 0.03 0.04"/><rgb name="sigmaA" value="0.01"/>
  <phase type="hg"><float name="g" value="0.4"/></phase></medium>
 <shape type="obj"><string name="filename" value="floor.obj"/></shape>
""", light="""<shape type="obj"><string name="filename" value="light.obj"/>
  <luminaire type="area"><rgb name="intensity" value="10"/></luminaire></shape>""")
MEDIUM_T = MEDIUM.replace(
    '<rgb name="sigmaS" value="0.02 0.03 0.04"/><rgb name="sigmaA" '
    'value="0.01"/>', '<float name="sigmaT" value="0.05"/>'
    '<rgb name="albedo" value="0.9 0.8 0.7"/>').replace(
    '<phase type="hg"><float name="g" value="0.4"/></phase>',
    '<phase type="isotropic"/>')


@pytest.mark.parametrize("src", [MEDIUM, MEDIUM_T], ids=["sigma", "albedo"])
def test_medium_equals_reference(assets, src):
    scene, cfg = txml.load_scene_string(src, base_dir=assets, device="cpu")
    jscene, jcfg = jxml.load_scene_string(src, base_dir=assets)
    _same(cfg["medium"], from_jax_medium(jcfg["medium"]), "medium")
    _same_scene(scene, from_jax_scene(jscene, device="cpu"), "scene")
    pc = PathConfig(max_depth=3, spp=2, remat=False)
    a, _ = render_volpath(scene, cfg["medium"], pc, seed=0)
    b, _ = render_volpath(from_jax_scene(jscene, device="cpu"),
                          from_jax_medium(jcfg["medium"]), pc, seed=0)
    assert float(a.mean()) > 0 and torch.equal(a, b)


# (feature, the scene body or a whole scene): each case named a feature
# that raised NotImplementedError, and then, once that was ported, the
# same feature beside an analytic hair, the last shape the port refused;
# with the hair ported (ROADMAP A.12) every case loads as the reference
# loads it
_SPH = '<shape type="sphere"><bsdf type="diffuse"/></shape>'
_HAIR = ('<shape type="hair"><string name="filename" value="h.hair"/>'
         '</shape>')
UNPORTED = {
    "cylinder": _HAIR + '<shape type="cylinder"/>',
    "hair": _HAIR,
    # animated instances, subsurface and an open shutter are ported
    # (tests/test_torch_motion.py, test_torch_subsurface.py), and so are
    # cylinders, the woven cloth, <blackbody>, JPEG and hspan
    # (tests/test_torch_cylinders.py, test_torch_cloth.py,
    # test_torch_spectrum.py, test_torch_jpeg.py, test_torch_hairio.py):
    # each case keeps its name with its feature beside an analytic hair,
    # which raises first
    "animatedinstance": '<shape type="shapegroup" id="g">' + _HAIR
                        + '</shape><shape type="animatedinstance"><ref '
                        'id="g"/></shape>',
    "subsurface": _HAIR + '<shape type="cylinder"><subsurface '
                  'type="dipole"/></shape>',
    "irawan": _HAIR + '<shape type="sphere"><bsdf type="irawan"/></shape>',
    "blackbody": _HAIR + '<shape type="sphere"><luminaire type="area">'
                 '<blackbody name="intensity" temperature="3000"/>'
                 '</luminaire></shape>',
    "shutter": '<camera type="perspective"><float name="shutterClose" '
               'value="0.5"/></camera>' + _HAIR,
    # the cases below named features that are ported now (sphere
    # emitters, bitmaps, the scene-level luminaires, the orthographic
    # camera, the aperture, a scene without emitters: PORTED_LIGHTS); each
    # keeps its name with the feature beside an analytic hair
    "sphere_emitter": _HAIR + '<shape type="sphere"><luminaire '
                      'type="area"/></shape>',
    "bitmap": _HAIR + '<shape type="sphere"><bsdf type="diffuse"><texture '
              'type="bitmap"><string name="filename" value="t.jpg"/>'
              '</texture></bsdf></shape>',
    "point": '<luminaire type="point"/>' + _HAIR,
    "spot": '<luminaire type="spot"/>' + _HAIR + '<shape type="hspan">'
            '<string name="filename" value="h.hspan"/></shape>',
    "directional": '<luminaire type="directional"/>' + _HAIR,
    "constant": '<luminaire type="constant"/>' + _HAIR,
    "envmap": _HAIR + '<luminaire type="envmap"><string name="filename" '
              'value="e.exr"/></luminaire>',
    "orthographic": '<camera type="orthographic"/>' + _HAIR,
    "aperture": '<camera type="perspective"><float name="apertureRadius" '
                'value="0.1"/><float name="shutterClose" value="0.5"/>'
                '</camera>' + _HAIR,
    "no_emitter": _HAIR + '<shape type="sphere"><bsdf type="diffuse">'
                  '<texture type="ldrtexture"><string name="filename" '
                  'value="t.jpeg"/></texture></bsdf></shape>',
}


@pytest.mark.parametrize("feature", sorted(UNPORTED))
def test_unported_features_raise(feature, tmp_path, monkeypatch):
    """Every case keeps its name: with the files it names written (the
    hair, the bitmaps, the envmap's image, the hspan file, which both
    packages open from the working directory), its scene loads in the
    port as in the reference, table for table (the subsurface points,
    drawn by each package's own sampler, left out; an ldrtexture within
    its decode's 4 ulps), and raises nothing."""
    from mitsuba_tpu_torch.io.bitmap import write_exr

    import torch_leftover_cases as lc

    monkeypatch.chdir(tmp_path)
    write_exr(str(tmp_path / "e.exr"), np.ones((4, 8, 3), np.float32))
    lc.write_hair(str(tmp_path / "h.hair"), 3, n_pts=4)
    lc.write_hspan(str(tmp_path / "h.hspan"), 6)
    for name in ("t.jpg", "t.jpeg"):
        lc.write_ground_jpeg(str(tmp_path / name), 16)
    body = UNPORTED[feature]
    light = "" if feature == "no_emitter" else _SKY
    src = f"<scene>{light}{body}</scene>"
    scene, _ = txml.load_scene_string(src, base_dir=str(tmp_path),
                                      device="cpu")
    jscene, _ = jxml.load_scene_string(src, base_dir=str(tmp_path))
    conv = from_jax_scene(jscene, device="cpu")
    if feature == "subsurface":
        scene = dataclasses.replace(scene, subsurface=None)
        conv = dataclasses.replace(conv, subsurface=None)
    if feature == "no_emitter":
        # an ldrtexture's sRGB decode: 4 float32 ulps (the module's note)
        for a, b in zip(scene.textures.images, conv.textures.images):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-7,
                                       atol=0)
        conv = dataclasses.replace(conv, textures=scene.textures)
    _same_scene(scene, conv, feature)
    assert scene.geom.n_hair == jscene.geom.n_hair == 9


# features that raised until they were ported (ROADMAP A.7 and A.8): each
# scene body, now with the file it names, loads as the reference loads it
PORTED_MEDIA = {
    "interior_medium": '<shape type="sphere"><medium type="homogeneous" '
                       'name="interior"/></shape>',
    "heterogeneous": '<medium type="heterogeneous"><volume type="gridvolume"'
                     ' name="density"><string name="filename" value="d.vol"'
                     '/></volume></medium>' + _SPH,
}


@pytest.mark.parametrize("feature", sorted(PORTED_MEDIA))
def test_ported_media_features_equal_reference(tmp_path, feature):
    from mitsuba_tpu_torch.io import volio

    volio.save_vol(str(tmp_path / "d.vol"), np.linspace(
        0, 1, 27, dtype=np.float32).reshape(3, 3, 3), (-1,) * 3, (1,) * 3)
    src = f"<scene>{_SKY}{PORTED_MEDIA[feature]}</scene>"
    scene, cfg = txml.load_scene_string(src, base_dir=str(tmp_path),
                                        device="cpu")
    jscene, jcfg = jxml.load_scene_string(src, base_dir=str(tmp_path))
    _same_scene(scene, from_jax_scene(jscene, device="cpu"), feature)
    if feature == "heterogeneous":
        _same(cfg["medium"], from_jax_medium(jcfg["medium"]), "medium")
        assert cfg["medium"].kind == 1
    else:
        # the sphere's medium, and none for the far triangle that a
        # spheres-only scene's tables get (scene.py:263)
        assert scene.shape_interior.tolist() == [0, -1]
        # an interior and no BSDF: the pass-through null() material
        assert scene.materials.opacity.tolist() == [0.0]


# features that raised until they were ported (ROADMAP A.11, the lights,
# textures and cameras): each scene body, with the files it names, loads
# as the reference loads it (tables bit for bit; an ldrtexture's sRGB
# decode within 4 float32 ulps, XLA's pow against numpy's), and the
# port's own tables render as the converted ones within 1e-4
_POINT = ('<luminaire type="point"><point name="position" x="0.5" y="3" '
          'z="-1"/><rgb name="intensity" value="12"/></luminaire>')
_FILM = ('<sampler type="independent"><integer name="sampleCount" '
         'value="2"/></sampler><film type="exrfilm"><integer name="width" '
         'value="16"/><integer name="height" value="16"/></film>')
_FLOOR = ('<shape type="obj"><string name="filename" value="floor.obj"/>'
          '</shape>')


def _tex(kind, extra=""):
    return (f'<shape type="sphere"><point name="center" x="0" y="0.6" '
            f'z="0"/><float name="radius" value="0.6"/><bsdf '
            f'type="diffuse"><texture type="{kind}" name="reflectance">'
            f'{extra}</texture></bsdf></shape>' + _FLOOR)


PORTED_LIGHTS = {
    "sphere_emitter": ('<shape type="sphere"><point name="center" x="0.4" '
                       'y="1.6" z="-0.3"/><float name="radius" value="0.25"'
                       '/><luminaire type="area"><rgb name="intensity" '
                       'value="9 8 7"/></luminaire></shape>' + _SPH
                       + _FLOOR, ""),
    "point": (_POINT + _SPH + _FLOOR, ""),
    "point_to_world": ('<luminaire type="point"><transform name="toWorld">'
                       '<translate x="0.3" y="2.5" z="-1.2"/></transform>'
                       '<rgb name="intensity" value="10"/></luminaire>'
                       + _SPH + _FLOOR, ""),
    "spot": ('<luminaire type="spot"><transform name="toWorld"><lookAt '
             'ox="0.5" oy="3" oz="-1" tx="0" ty="0" tz="0" ux="0" uy="1" '
             'uz="0"/></transform><float name="cutoffAngle" value="25"/>'
             '<rgb name="intensity" value="20"/></luminaire>' + _SPH
             + _FLOOR, ""),
    "spot_beam_width": ('<luminaire type="spot"><transform name="toWorld">'
                        '<rotate x="1" angle="80"/><translate y="3"/>'
                        '</transform><float name="beamWidth" value="10"/>'
                        '<rgb name="intensity" value="20"/></luminaire>'
                        + _SPH + _FLOOR, ""),
    "directional": ('<luminaire type="directional"><vector name="direction"'
                    ' x="0.3" y="-1" z="0.2"/><rgb name="intensity" '
                    'value="1.5"/></luminaire>' + _SPH + _FLOOR, ""),
    "directional_to_world": ('<luminaire type="directional"><transform '
                             'name="toWorld"><rotate x="1" angle="100"/>'
                             '</transform><rgb name="intensity" value="2"/>'
                             '</luminaire>' + _SPH + _FLOOR, ""),
    "constant": ('<luminaire type="constant"><rgb name="intensity" '
                 'value="0.7 0.8 0.9"/></luminaire>' + _SPH + _FLOOR, ""),
    "envmap": ('<luminaire type="envmap"><string name="filename" '
               'value="e.exr"/><float name="intensityScale" value="0.5"/>'
               '<transform name="toWorld"><rotate x="1" angle="-90"/>'
               '</transform></luminaire>' + _SPH + _FLOOR, ""),
    "ldrtexture": (_tex("ldrtexture", '<string name="filename" '
                        'value="t.png"/>'), _POINT),
    "exrtexture": (_tex("exrtexture", '<string name="filename" '
                        'value="t.exr"/><float name="uscale" value="3"/>'
                        '<float name="voffset" value="0.2"/>'), _POINT),
    "bitmap_clamp": (_tex("bitmap", '<string name="filename" value="t.exr"'
                          '/><string name="wrapMode" value="clamp"/><float '
                          'name="uscale" value="2"/>'), _POINT),
    "diffusiontexture": (_tex("diffusiontexture", '<string name="filename" '
                              'value="t.exr"/>'), _POINT),
    "gridtexture": (_tex("gridtexture", '<float name="lineWidth" '
                         'value="0.08"/><float name="uscale" value="6"/>'
                         '<float name="vscale" value="6"/>'), _POINT),
    "vertexcolors": (_tex("vertexcolors"), _POINT),
    "orthographic": ('<camera type="orthographic"><transform name="toWorld">'
                     '<scale x="1.5" y="1.5"/><lookAt ox="0" oy="1.4" '
                     'oz="-3.2" tx="0" ty="0.7" tz="0" ux="0" uy="1" uz="0"/>'
                     '</transform>' + _FILM + '</camera>' + _SPH + _FLOOR,
                     _POINT),
    "aperture": ('<camera type="perspective"><float name="apertureRadius" '
                 'value="0.1"/><float name="focusDistance" value="3"/>'
                 '<transform name="toWorld"><lookAt ox="0" oy="1.4" '
                 'oz="-3.2" tx="0" ty="0.7" tz="0" ux="0" uy="1" uz="0"/>'
                 '</transform>' + _FILM + '</camera>' + _SPH + _FLOOR,
                 _POINT),
    "no_emitter": (_SPH + _FLOOR, ""),
}


def _light_files(tmp_path):
    from mitsuba_tpu_torch.io import bitmap

    rng = np.random.default_rng(7)
    bitmap.write_png(str(tmp_path / "t.png"), rng.integers(
        0, 256, (8, 12, 3)).astype(np.uint8))
    bitmap.write_exr(str(tmp_path / "t.exr"), rng.uniform(
        0.05, 0.9, (6, 10, 3)).astype(np.float32))
    bitmap.write_exr(str(tmp_path / "e.exr"), rng.uniform(
        0.1, 3.0, (8, 16, 3)).astype(np.float32))
    with open(tmp_path / "floor.obj", "w") as f:
        f.write("v -3 0 -3\nv 3 0 -3\nv 3 0 3\nv -3 0 3\nvt 0 0\nvt 1 0\n"
                "vt 1 1\nvt 0 1\nf 1/1 4/4 3/3\nf 1/1 3/3 2/2\n")


@pytest.mark.parametrize("feature", sorted(PORTED_LIGHTS))
def test_ported_lights_textures_cameras_equal_reference(tmp_path, feature):
    _light_files(tmp_path)
    body, light = PORTED_LIGHTS[feature]
    if feature in ("orthographic", "aperture"):
        src = f"<scene>{light}{body}</scene>"
    else:
        src = _scene(body, light=light)
    scene, cfg = txml.load_scene_string(src, base_dir=str(tmp_path),
                                        device="cpu")
    jscene, jcfg = jxml.load_scene_string(src, base_dir=str(tmp_path))
    conv = from_jax_scene(jscene, device="cpu")
    if feature == "ldrtexture":
        # the sRGB decode: 4 float32 ulps (the module's note)
        for a, b in zip(scene.textures.images, conv.textures.images):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-7,
                                       atol=0)
        conv = dataclasses.replace(conv, textures=scene.textures)
    _same_scene(scene, conv, feature)
    assert cfg == jcfg
    kinds = {"sphere_emitter": 8, "point": 1, "point_to_world": 1,
             "spot": 2, "spot_beam_width": 2, "directional": 3,
             "directional_to_world": 3, "constant": 5, "envmap": 6}
    if feature in kinds:
        assert kinds[feature] in scene.emitters.kinds_present
    if feature == "orthographic":
        assert scene.camera.kind == 1
    pc = PathConfig(max_depth=3, spp=2, remat=False)
    a, _ = render(scene, pc, seed=0)
    b, _ = render(conv, pc, seed=0)
    assert bool(torch.isfinite(a).all())
    if feature != "no_emitter":
        assert float(a.mean()) > 0
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-6)


# features that raised until they were ported (ROADMAP A.11, the
# materials): each scene body loads as the reference loads it, and the
# port's own tables render as the converted ones
PORTED_BSDFS = {
    "roughglass": '<shape type="sphere"><bsdf type="roughglass"/></shape>',
    "ward": '<shape type="sphere"><bsdf type="ward"/></shape>',
    "mask": '<shape type="sphere"><bsdf type="mask"><bsdf type="diffuse"/>'
            '</bsdf></shape>',
    "phong_distribution": '<shape type="sphere"><bsdf type="roughmetal">'
                          '<string name="distribution" value="phong"/>'
                          '</bsdf></shape>',
    "composite": '<shape type="sphere"><bsdf type="composite"><string '
                 'name="weights" value="0.3, 0.6"/><bsdf type="ward"/><bsdf '
                 'type="difftrans"/></bsdf></shape>',
    "hk_twosided": '<shape type="sphere"><bsdf type="twosided"><bsdf '
                   'type="hk"/></bsdf></shape>',
}


@pytest.mark.parametrize("feature", sorted(PORTED_BSDFS))
def test_ported_bsdfs_equal_reference(feature):
    src = _scene(PORTED_BSDFS[feature])
    scene, cfg = txml.load_scene_string(src, device="cpu")
    jscene, jcfg = jxml.load_scene_string(src)
    conv = from_jax_scene(jscene, device="cpu")
    _same_scene(scene, conv, feature)
    assert cfg == jcfg
    pc = PathConfig(max_depth=3, spp=2, remat=False)
    a, _ = render(scene, pc, seed=0)
    b, _ = render(conv, pc, seed=0)
    assert float(a.mean()) > 0
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-6)


def test_snow_scene_equals_reference():
    """scenes/snow.xml, which named the Wiscombe BSDF it lacked until the
    materials were ported: its tables are the reference's."""
    path = os.path.join(REPO, "scenes", "snow.xml")
    scene, cfg = txml.load_scene(path, params=SMALL, device="cpu")
    jscene, jcfg = jxml.load_scene(path, params=SMALL)
    _same_scene(scene, from_jax_scene(jscene, device="cpu"), "snow")
    assert cfg == jcfg and cfg["pattern"] == "ldsampler"
    assert scene.materials.kind.tolist() == [8]


# ---------------------------------------------------------------------------
# mesh files
# ---------------------------------------------------------------------------

def _same_mesh(a, b):
    for k in ("vertices", "faces", "normals", "uvs"):
        x, y = getattr(a, k), getattr(b, k)
        assert (x is None) == (y is None), k
        if x is not None:
            assert x.dtype == y.dtype and np.array_equal(x, y), k


@pytest.mark.parametrize("fmt", ["obj", "obj_no_normals", "ply_ascii",
                                 "ply_le", "ply_be", "serialized"])
def test_mesh_loaders_equal_reference(tmp_path, fmt):
    m = tmesh.make_sphere_mesh([1, 2, 3], 2.0, 8, 12)
    p = str(tmp_path / f"m.{fmt.split('_')[0]}")
    if fmt == "obj":
        meshio.save_obj(p, m)
    elif fmt == "obj_no_normals":
        meshio.save_obj(p, tmesh.TriMesh(m.vertices, m.faces))
    elif fmt == "ply_ascii":
        with open(p, "w") as f:
            f.write(f"ply\nformat ascii 1.0\nelement vertex "
                    f"{len(m.vertices)}\nproperty float x\nproperty float y"
                    f"\nproperty float z\nproperty float s\nproperty float t"
                    f"\nelement face {m.n_faces}\nproperty list uchar int "
                    f"vertex_indices\nend_header\n")
            for (x, y, z), (s, t) in zip(m.vertices, m.uvs):
                f.write(f"{x:.9g} {y:.9g} {z:.9g} {s:.9g} {t:.9g}\n")
            for a, b, c in m.faces:
                f.write(f"3 {a} {b} {c}\n")
    elif fmt.startswith("ply"):
        xc.write_binary_ply(p, m, "<" if fmt == "ply_le" else ">")
    else:
        meshio.save_serialized(p, [m, tmesh.make_box([0, 0, 0], [1, 2, 3])])
    load = {"obj": "load_obj", "ply": "load_ply",
            "serialized": "load_serialized"}[fmt.split("_")[0]]
    _same_mesh(getattr(meshio, load)(p), getattr(jmeshio, load)(p))
    if fmt == "serialized":
        _same_mesh(meshio.load_serialized(p, 1), jmeshio.load_serialized(p, 1))
    if fmt in ("ply_le", "ply_be"):
        _same_mesh(meshio.load_ply(p), m)


@pytest.mark.parametrize("writer", ["obj", "serialized"])
def test_mesh_writers_equal_reference(tmp_path, writer):
    m = tmesh.make_sphere_mesh([1, 2, 3], 2.0, 6, 8)
    jm = jmesh.make_sphere_mesh([1, 2, 3], 2.0, 6, 8)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    getattr(meshio, f"save_{writer}")(a, m)
    getattr(jmeshio, f"save_{writer}")(b, jm)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def test_mesh_round_trips(tmp_path):
    """tests/test_xml.py:119-168 on the port's loaders and writers."""
    m = tmesh.make_sphere_mesh([1, 2, 3], 2.0, 8, 12)
    p = str(tmp_path / "s.obj")
    meshio.save_obj(p, m)
    m2 = meshio.load_obj(p)
    assert m2.faces.shape == m.faces.shape
    np.testing.assert_allclose(m2.face_areas().sum(), m.face_areas().sum(),
                               rtol=1e-5)
    np.testing.assert_allclose(m2.vertices.min(0), m.vertices.min(0),
                               atol=1e-5)
    np.testing.assert_allclose(m2.vertices.max(0), m.vertices.max(0),
                               atol=1e-5)
    np.testing.assert_allclose(
        (m2.face_normals() * m2.face_areas()[:, None]).sum(0),
        (m.face_normals() * m.face_areas()[:, None]).sum(0), atol=1e-4)
    b = tmesh.make_box([0, 0, 0], [1, 2, 3])
    p = str(tmp_path / "m.serialized")
    meshio.save_serialized(p, b)
    b2 = meshio.load_serialized(p)
    np.testing.assert_allclose(b2.vertices, b.vertices, atol=1e-6)
    np.testing.assert_array_equal(b2.faces, b.faces)
    _same_mesh(b, jmesh.make_box([0, 0, 0], [1, 2, 3]))
    with pytest.raises(IndexError):
        meshio.load_serialized(p, 3)


def test_file_resolver(tmp_path, monkeypatch):
    """tests/test_xml.py's FileResolver checks on the port's copy, and the
    same answers as the reference's."""
    d1, d2 = tmp_path / "a", tmp_path / "b"
    d1.mkdir()
    d2.mkdir()
    (d2 / "mesh.obj").write_text("o x\n")
    for R in (TR, JR):
        r = R.FileResolver([str(d1), str(d2)])
        assert r.resolve("mesh.obj") == str(d2 / "mesh.obj")
    (d1 / "mesh.obj").write_text("o y\n")
    r = TR.FileResolver([str(d1), str(d2)])
    assert r.resolve("mesh.obj") == str(d1 / "mesh.obj")
    assert r.resolve("absent.obj") == "absent.obj"
    assert r.resolve(str(d2 / "mesh.obj")) == str(d2 / "mesh.obj")
    assert r.resolve_all("mesh.obj") == JR.FileResolver(
        [str(d1), str(d2)]).resolve_all("mesh.obj")
    r2 = r.clone()
    r2.prepend(str(d2))
    assert r2.resolve("mesh.obj") == str(d2 / "mesh.obj")
    assert r.paths[0] == str(d1)
    monkeypatch.setenv("MITSUBA_TPU_PATH", str(d2))
    monkeypatch.setattr(TR, "_default", None)
    assert TR.default_resolver().resolve("mesh.obj") == str(d2 / "mesh.obj")


def test_xml_mesh_found_via_search_path(tmp_path, monkeypatch):
    meshdir = tmp_path / "assets"
    meshdir.mkdir()
    meshio.save_obj(str(meshdir / "walls.obj"),
                    tmesh.make_box([0, 0, 0], [1, 1, 1]))
    monkeypatch.setenv("MITSUBA_TPU_PATH", str(meshdir))
    monkeypatch.setattr(TR, "_default", None)
    scene, _ = txml.load_scene_string(
        "<scene><luminaire type='sky'/><shape type='obj'><string "
        "name='filename' value='walls.obj'/></shape></scene>",
        base_dir=str(tmp_path), device="cpu")
    assert scene.geom.n_tris == 12


# ---------------------------------------------------------------------------
# transforms, sRGB, registry, t-test
# ---------------------------------------------------------------------------

def test_transforms_equal_reference():
    rng = np.random.default_rng(3)
    for _ in range(20):
        v = rng.normal(size=3) * 5
        a = rng.uniform(-180, 180)
        for name, args in (("translate", (v,)), ("scale", (np.abs(v),)),
                           ("rotate", (v, a)),
                           ("look_at", (v, v + rng.normal(size=3),
                                        (0, 1, 0)))):
            x = getattr(ttf, name)(*args)
            y = np.asarray(getattr(jtf, name)(*args))
            assert x.dtype == y.dtype == np.float32
            assert np.array_equal(x, y), name
        ms = [ttf.translate(v), ttf.rotate(v, a), ttf.scale(np.abs(v) + 1)]
        jms = [jtf.translate(v), jtf.rotate(v, a), jtf.scale(np.abs(v) + 1)]
        assert np.array_equal(ttf.compose(*ms), np.asarray(jtf.compose(*jms)))
        p = rng.normal(size=3).astype(np.float32)
        assert np.array_equal(ttf.apply_point_np(ttf.compose(*ms), p),
                              np.asarray(jtf.apply_point(
                                  jtf.compose(*jms), p)))
    assert np.array_equal(ttf.identity(), np.eye(4, dtype=np.float32))


def test_srgb_equals_reference():
    x = np.linspace(-0.1, 1.2, 4097, dtype=np.float32)
    for name in ("to_srgb", "from_srgb"):
        a = getattr(tspec, name)(x)
        b = np.asarray(getattr(jspec, name)(x))
        assert a.dtype == np.float32
        np.testing.assert_array_max_ulp(a, b, maxulp=4)


def test_registry():
    assert registry.has_plugin("camera", "perspective")
    assert registry.plugin_names("camera") == ["orthographic", "perspective"]
    with pytest.raises(KeyError, match="pinhole"):
        registry.create_plugin("camera", "pinhole", {})
    cam = registry.create_plugin("camera", "perspective",
                                 {"fov": 30.0, "fovAxis": "y"}, aspect=2.0)
    ref = mitsuba_tpu.render.camera._make_perspective_plugin(
        {"fov": 30.0, "fovAxis": "y"}, aspect=2.0)
    assert cam.tan_half_fov_x == float(ref.tan_half_fov_x)
    assert cam.tan_half_fov_y == float(ref.tan_half_fov_y)


def test_welch_ttest_equals_reference():
    rng = np.random.default_rng(0)
    m1, m2 = rng.uniform(0, 1, (2, 12, 12, 3))
    v1, v2 = rng.uniform(0.01, 0.2, (2, 12, 12, 3))
    m2[:2] = m1[:2]
    a = tttest.welch_ttest_images(m1, v1, 64, m2, v2, 128)
    b = jttest.welch_ttest_images(m1, v1, 64, m2, v2, 128)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert tttest.relative_error_test(m1, m2) == jttest.relative_error_test(
        m1, m2)

