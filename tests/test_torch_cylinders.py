"""The port's analytic cylinders (`SceneBuilder.add_cylinder`, the `cyl_*`
tables, `_cylinder_closest` and the merge after the triangles' query in
`mitsuba_tpu_torch/render/intersect.py`, the scene file's `cylinder`)
against the JAX package's, on the cases of
tests/test_analytic_shapes.py:53,99.

- Records of `ray_intersect` and `ray_test` on brute (the reference on
  its kernel path, tests/torch_kernel_path.py), bvh and cluster
  geometries holding a sphere and three cylinders, and on an instanced
  cluster geometry beside them (whose virtual prims share the ids at and
  above n_tris with the analytic ones): prim, shape, material and
  emitter ids and the valid and occluded flags equal; t, p, the normals,
  uv, dp_du and wi within 1e-5. Rays in random directions, rays along
  the cylinders' axes (A clamps at 1e-12) and rays from inside them.
- The exact root and the open ends (test_analytic_shapes.py:53).
- A path render's lanes (brute, 8 x 8 px, 2 spp, depth 4) and a medium
  held in a cylinder through `volpath_media_trace`, lane by lane against
  the reference's kernel path: >= 99% of lanes within rtol 1e-4, the
  mean within 1e-3 (tests/test_torch_hetero.py assert_lanes_match).
- Scene files: analytic cylinders (`toWorld`, an interior medium) and a
  `<subsurface>` cylinder's tessellated mesh: every table equal to
  `from_jax_scene` of the reference's load, bit for bit (the subsurface
  points, drawn by each package's own sampler, left out); a cylinder
  with a luminaire raises the reference's ValueError.
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.core import transform as jtf
from mitsuba_tpu.integrators.path import PathConfig as JaxPathConfig
from mitsuba_tpu.integrators.path import path_trace as jax_path_trace
from mitsuba_tpu.integrators.volpath import (
    volpath_media_trace as jax_media_trace,
)
from mitsuba_tpu.io import xml as jxml
from mitsuba_tpu.render import intersect as jri
from mitsuba_tpu.render import mesh as jmesh
from mitsuba_tpu.render.camera import make_perspective as j_persp
from mitsuba_tpu.render.records import Ray as JaxRay
from mitsuba_tpu.render.sampler import Sampler as JaxSampler
from mitsuba_tpu.render.scene import SceneBuilder as JaxSceneBuilder
from mitsuba_tpu_torch.core import transform as ttf
from mitsuba_tpu_torch.integrators.path import (
    PathConfig, camera_wavefront, path_trace,
)
from mitsuba_tpu_torch.integrators.volpath import volpath_media_trace
from mitsuba_tpu_torch.interop import from_jax_scene
from mitsuba_tpu_torch.io import xml as txml
from mitsuba_tpu_torch.render import intersect as tri
from mitsuba_tpu_torch.render import mesh as tmesh
from mitsuba_tpu_torch.render.camera import make_perspective as t_persp
from mitsuba_tpu_torch.render.records import Ray
from mitsuba_tpu_torch.render.scene import SceneBuilder
from tests import torch_leftover_cases as lc
from tests.test_torch_hetero import assert_lanes_match
from tests.test_torch_xml import _same
from tests.torch_kernel_path import kernel_path, lanes

torch.set_num_threads(1)
JAX = SimpleNamespace(SceneBuilder=JaxSceneBuilder, mesh=jmesh,
                      look_at=jtf.look_at, make_perspective=j_persp)
PORT = SimpleNamespace(SceneBuilder=SceneBuilder, mesh=tmesh,
                       look_at=ttf.look_at, make_perspective=t_persp)
ATOL = 1e-5
W = H = 8
SPP, DEPTH = 2, 4


def _rays(n=3000, seed=0):
    """Random rays through the scene's box, rays along the first two
    cylinders' axes and rays from inside the first one."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    k = n // 10
    # along the y axis through the first (tilted 0.1 rad) cylinder, along
    # z inside the second (exactly parallel)
    o[:k, 0] = rng.uniform(-0.7, 0.7, k)
    o[:k, 2] = rng.uniform(-0.7, 0.7, k)
    d[:k] = (0.0, rng.choice([-1.0, 1.0]), 0.0)
    o[k:2 * k] = np.stack([rng.uniform(-1.8, -1.2, k),
                           rng.uniform(-0.3, 0.3, k),
                           rng.uniform(-2, 2, k)], -1)
    d[k:2 * k] = (0.0, 0.0, 1.0)
    # from inside the first cylinder, every direction
    o[2 * k:3 * k] = np.stack([rng.uniform(-0.3, 0.3, k),
                               rng.uniform(-0.8, 0.8, k),
                               rng.uniform(-0.3, 0.3, k)], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    maxt = np.where(rng.uniform(size=n) < 0.3, 1.5, np.inf)
    return o, d, np.full(n, 1e-4, np.float32), maxt.astype(np.float32)


def _reference(jgeom, o, d, mint, maxt):
    ray = JaxRay.make(jnp.asarray(o), jnp.asarray(d), mint=jnp.asarray(mint),
                      maxt=jnp.asarray(maxt))
    return jri.ray_intersect(jgeom, ray), jri.ray_test(jgeom, ray)


def _port(geom, o, d, mint, maxt):
    t = torch.from_numpy
    ray = Ray.make(t(o), t(d), mint=t(mint), maxt=t(maxt))
    return tri.ray_intersect(geom, ray), tri.ray_test(geom, ray)


def _same_records(ji, jocc, ti, tocc, n_tris):
    for f in ("valid", "prim_id", "shape_id", "material_id", "emitter_id"):
        assert np.array_equal(np.asarray(getattr(ji, f)),
                              getattr(ti, f).numpy()), f
    assert np.array_equal(np.asarray(jocc), tocc.numpy())
    v = np.asarray(ji.valid)
    for f in ("t", "p", "geo_n", "sh_n", "uv", "dp_du", "wi"):
        np.testing.assert_allclose(getattr(ti, f).numpy()[v],
                                   np.asarray(getattr(ji, f))[v], rtol=0,
                                   atol=ATOL, err_msg=f)
    # every analytic kind was hit
    prim = np.asarray(ji.prim_id)
    return {int(p) - n_tris for p in prim[prim >= n_tris]}


@pytest.mark.parametrize("backend", ["brute", "bvh", "cluster"])
def test_records_equal_reference(backend, monkeypatch):
    jscene = lc.cylinders_scene(JAX, backend)
    if backend == "brute":
        kernel_path(monkeypatch, jscene.geom)
    rays = _rays(1500)
    ref = _reference(jscene.geom, *rays)
    for scene in (from_jax_scene(jscene, device="cpu"),
                  lc.cylinders_scene(PORT, backend, device="cpu")):
        assert scene.geom.backend == backend
        assert (scene.geom.n_spheres, scene.geom.n_cylinders) == (1, 3)
        got = _same_records(*ref, *_port(scene.geom, *rays),
                            jscene.geom.n_tris)
        assert got == {0, 1, 2, 3}


def _instanced(mods, device=None):
    """Three instances of a tessellated ball beside a sphere and a
    cylinder (cluster backend)."""
    b = mods.SceneBuilder()
    lm = b.materials.lambertian((0.6, 0.6, 0.6))
    red = b.materials.lambertian((0.7, 0.2, 0.2))
    b.add_shape(mods.mesh.make_quad([-4, -1, -4], [-4, -1, 4], [4, -1, 4],
                                    [4, -1, -4]), lm)
    gid = b.add_instanced_group([(mods.mesh.make_sphere_mesh(
        [0, 0, 0], 0.5, 8, 16), red)])
    for x in (-2.0, 0.0, 2.0):
        m4 = np.eye(4)
        m4[:3, 3] = (x, 0.0, 1.5)
        b.add_instance(gid, m4)
    b.add_sphere((1.0, 0.0, -1.0), 0.4, red)
    b.add_cylinder((-1.0, -1.0, -1.0), (-1.0, 1.0, -0.8), 0.4, lm)
    kw = {} if device is None else dict(device=device)
    return b.build(backend="cluster", **kw)


def test_instanced_records_equal_reference():
    jscene = _instanced(JAX)
    o, d, mint, maxt = _rays(1000, seed=1)
    o[:, 2] = -4.0              # towards the instances, sphere, cylinder
    d[:, 2] = np.abs(d[:, 2]) + 0.5
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ref = _reference(jscene.geom, o, d, mint, maxt)
    for scene in (from_jax_scene(jscene, device="cpu"),
                  _instanced(PORT, device="cpu")):
        assert scene.geom.has_instances and scene.geom.n_cylinders == 1
        got = _same_records(*ref, *_port(scene.geom, o, d, mint, maxt),
                            jscene.geom.n_tris)
        # virtual (instanced) prims and both analytic shapes were hit
        assert len(got) > 2


def test_exact_root_and_open_ends():
    """test_analytic_shapes.py:53: the root 2.5 exactly, no end caps."""
    b = SceneBuilder()
    b.add_cylinder((0, 0, -1), (0, 0, 1), 0.5,
                   b.materials.lambertian((0.5, 0.5, 0.5)))
    geom = b.build(backend="brute", device="cpu").geom
    assert geom.n_tris == 2      # the far, degenerate quad
    o = torch.tensor([[3.0, 0.0, 0.0], [3.0, 0.0, 2.0], [0.0, 0.0, 3.0]])
    d = torch.tensor([[-1.0, 0.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 0.0, -1.0]])
    its = tri.ray_intersect(geom, Ray.make(o, d, mint=torch.full((3,),
                                                                 1e-4)))
    assert float(its.t[0]) == 2.5
    assert its.valid.tolist() == [True, False, False]   # no caps
    assert its.geo_n[0].tolist() == [1.0, 0.0, 0.0]
    assert int(its.prim_id[0]) == geom.n_tris


def _reference_lanes(jscene, media):
    @jax.jit
    def run(scene):
        pid, sid, px, py = lanes(W, H, SPP, jnp)
        sampler = JaxSampler(0, pid, sid)
        off = sampler.next_2d()
        uv = jnp.stack([(px + off[:, 0]) / W, (py + off[:, 1]) / H], -1)
        cfg = JaxPathConfig(max_depth=DEPTH, spp=SPP, remat=False)
        trace = jax_media_trace if media else jax_path_trace
        return trace(scene, scene.camera.sample_ray(uv), sampler, cfg)

    L, aux = run(jscene)
    return np.asarray(L), float(aux["avg_path_length"])


@pytest.mark.parametrize("media", [False, True], ids=["path", "media"])
def test_render_matches_kernel_path_per_lane(media, monkeypatch):
    jscene = lc.cylinders_scene(JAX, "brute", width=W, height=H,
                                media=media)
    kernel_path(monkeypatch, jscene.geom)
    L_ref, apl = _reference_lanes(jscene, media)
    scene = from_jax_scene(jscene, device="cpu")
    own = lc.cylinders_scene(PORT, "brute", device="cpu", width=W, height=H,
                             media=media)
    for f in dataclasses.fields(scene):
        _same(getattr(own, f.name), getattr(scene, f.name), f.name)
    cfg = PathConfig(max_depth=DEPTH, spp=SPP)
    ray, sampler, _ = camera_wavefront(scene, cfg, 0, morton=False)
    trace = volpath_media_trace if media else path_trace
    L, aux = trace(scene, ray, sampler, cfg)
    assert L_ref.mean() > 0
    assert_lanes_match(L.numpy(), L_ref)
    assert abs(float(aux["avg_path_length"]) - apl) <= 0.02


_FILE = """<scene>
 <integrator type="path"><integer name="maxDepth" value="3"/></integrator>
 <camera type="perspective"><float name="fov" value="40"/>
  <transform name="toWorld"><lookAt ox="0" oy="0" oz="6" tx="0" ty="0"
   tz="0" ux="0" uy="1" uz="0"/></transform>
  <film type="exrfilm"><integer name="width" value="8"/>
   <integer name="height" value="8"/></film></camera>
 <shape type="sphere"><float name="radius" value="1"/>
  <bsdf type="lambertian"/></shape>
 <shape type="sphere"><point name="center" x="-2" y="0" z="2"/>
  <float name="radius" value="0.4"/>
  <luminaire type="area"><spectrum name="intensity" value="10"/>
  </luminaire></shape>
 {body}
</scene>"""
FILES = {
    # test_analytic_shapes.py:99's cylinder
    "analytic": """<shape type="cylinder">
  <point name="p1" x="2" y="0" z="-1"/><point name="p2" x="2" y="0" z="1"/>
  <float name="radius" value="0.3"/><bsdf type="lambertian"/></shape>""",
    "to_world": """<shape type="cylinder"><float name="radius" value="0.5"/>
  <transform name="toWorld"><rotate x="1" angle="30"/><scale value="1.5"/>
   <translate x="1" y="-0.5"/></transform>
  <bsdf type="roughconductor"/></shape>
  <shape type="cylinder"><point name="p2" x="0" y="2" z="0"/>
  <bsdf type="dielectric"/></shape>""",
    "interior": """<shape type="cylinder"><point name="p1" x="0" y="-1" z="0"/>
  <point name="p2" x="0" y="1" z="0"/><float name="radius" value="0.6"/>
  <medium type="homogeneous" name="interior">
   <rgb name="sigmaS" value="0.5 0.4 0.3"/><rgb name="sigmaA" value="0.1"/>
   <phase type="hg"><float name="g" value="0.3"/></phase></medium>
  </shape>""",
    "subsurface": """<shape type="cylinder"><point name="p2" x="0" y="1"
  z="0"/><float name="radius" value="0.4"/>
  <transform name="toWorld"><translate x="1.5"/></transform>
  <bsdf type="lambertian"/>
  <subsurface type="dipole"><integer name="irrSamples" value="16"/>
  </subsurface></shape>""",
}


@pytest.mark.parametrize("case", sorted(FILES))
def test_scene_files_equal_reference(case):
    xml = _FILE.replace("{body}", FILES[case])
    port, _ = txml.load_scene_string(xml, device="cpu")
    ref, _ = jxml.load_scene_string(xml)
    conv = from_jax_scene(ref, device="cpu")
    for f in dataclasses.fields(port):
        if f.name != "subsurface":
            _same(getattr(port, f.name), getattr(conv, f.name), f.name)
    cyl = {"analytic": 1, "to_world": 2, "interior": 1, "subsurface": 0}
    assert port.geom.n_cylinders == cyl[case]
    if case == "subsurface":
        # _make_cylinder_mesh: 64 quads, capless
        assert port.geom.n_tris == 128
        assert port.subsurface is not None
    if case == "interior":
        assert port.shape_interior.tolist() == [-1, -1, 0, -1]


def test_cornell_files_equal_reference(tmp_path):
    for media in (False, True):
        path = lc.write_cylinders_xml(str(tmp_path), media=media)
        port, _ = txml.load_scene(path, params=dict(
            depth=3, spp=2, width=8, height=8), device="cpu")
        ref, _ = jxml.load_scene(path, params=dict(
            depth=3, spp=2, width=8, height=8))
        conv = from_jax_scene(ref, device="cpu")
        for f in dataclasses.fields(port):
            _same(getattr(port, f.name), getattr(conv, f.name), f.name)
        assert port.geom.n_cylinders == (1 if media else 3)
        assert port.geom.backend == "brute"


def test_cylinder_luminaire_raises():
    xml = _FILE.replace("{body}", """<shape type="cylinder">
  <luminaire type="area"><rgb name="intensity" value="1"/></luminaire>
  </shape>""")
    with pytest.raises(ValueError, match="cylinder area emitters"):
        txml.load_scene_string(xml, device="cpu")
    with pytest.raises(ValueError, match="cylinder area emitters"):
        jxml.load_scene_string(xml)
