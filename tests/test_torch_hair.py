"""The port's analytic hair (io/hairio.py `load_hair_segments`,
render/bvh.py `build_bvh_boxes`, the `hair_*` tables, `_hair_walk` and
the merge after the triangles and the analytic shapes in
render/intersect.py, `SceneBuilder.add_hair`, the scene file's `hair`)
against the JAX package's, on the cases of tests/test_shapes_extra.py:
77,127.

- The segments, the box BVH (perm, bounds, first, count, skip) and the
  packed `hair_nodes` and `hair_segs` tables: bit for bit.
- `_hair_walk` on 2,048 seeded rays, closest and any hit: every valid
  flag equal, and every segment id but at a tie (two segments of a fibre
  meeting at a joint, both hit within 1e-5 of the same t, where the last
  bits of t pick one; at most 1% of the hits). t within 1e-5 (relative,
  absolute below 1) on >= 90% of the hits and within 1e-4 on all, the
  axial fraction within 1e-4 and 1e-3: XLA fuses the reference's
  multiply-adds on the CPU and PyTorch's kernels do not, and the
  quadratic of a thin cylinder (r = 0.04 over rays from 3 units away)
  cancels those last bits up to ~30 ulps of t (median 1.8e-6, 99th
  percentile 2.6e-5), more at grazing hits (disc / B^2 ~ 1e-4); the
  fraction divides by a segment's length.
- Merged records of `ray_intersect`, `ray_test` and
  `ray_intersect_and_test` on brute (the reference on its kernel path),
  bvh and cluster geometries with hair, a sphere and a cylinder, and on
  an instanced cluster geometry (the reference lets hair and instancing
  meet): shape, material and emitter ids and the valid and occluded
  flags equal, prim ids but at the ties above; t and p within 1e-5
  (relative, absolute below the scene's size 3) on >= 97% of the lanes
  that hit and 1e-3 on all; the normals, uv, dp_du and wi within 1e-3 on
  >= 97% and 1e-2 on all (a normal's error is the hit point's over the
  radius).
- A path render's lanes (brute, 8 x 8 px, 2 spp, depth 4) against the
  reference's kernel path: >= 97% of lanes within rtol 1e-4, the mean
  within 1e-3 (tests/test_torch_hetero.py's rule takes 99%; a lane that
  meets a fibre carries the normal's error above into its next bounce).
- Scene files: every table of the port's load equal to `from_jax_scene`
  of the reference's load, bit for bit, with and without `toWorld`; a
  hair with a luminaire raises the reference's ValueError.
- tests/test_shapes_extra.py:127: the analytic fibres' render and the
  tessellated tubes' agree in the mean within 8%.
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
from mitsuba_tpu.io import hairio as jhairio
from mitsuba_tpu.io import xml as jxml
from mitsuba_tpu.render import bvh as jbvh
from mitsuba_tpu.render import intersect as jri
from mitsuba_tpu.render import mesh as jmesh
from mitsuba_tpu.render.camera import make_perspective as j_persp
from mitsuba_tpu.render.records import Ray as JaxRay
from mitsuba_tpu.render.sampler import Sampler as JaxSampler
from mitsuba_tpu.render.scene import SceneBuilder as JaxSceneBuilder
from mitsuba_tpu_torch.core import transform as ttf
from mitsuba_tpu_torch.integrators.path import (
    PathConfig, camera_wavefront, path_trace, render,
)
from mitsuba_tpu_torch.interop import from_jax_scene
from mitsuba_tpu_torch.io import hairio as thairio
from mitsuba_tpu_torch.io import xml as txml
from mitsuba_tpu_torch.render import bvh as tbvh
from mitsuba_tpu_torch.render import intersect as tri
from mitsuba_tpu_torch.render import mesh as tmesh
from mitsuba_tpu_torch.render.camera import make_perspective as t_persp
from mitsuba_tpu_torch.render.records import Ray
from mitsuba_tpu_torch.render.scene import SceneBuilder
from tests import torch_leftover_cases as lc
from tests.test_torch_xml import _same
from tests.torch_kernel_path import kernel_path, lanes

torch.set_num_threads(1)
JAX = SimpleNamespace(SceneBuilder=JaxSceneBuilder, mesh=jmesh,
                      look_at=jtf.look_at, make_perspective=j_persp,
                      hairio=jhairio)
PORT = SimpleNamespace(SceneBuilder=SceneBuilder, mesh=tmesh,
                       look_at=ttf.look_at, make_perspective=t_persp,
                       hairio=thairio)
TOL = 1e-5
W = H = 8
SPP, DEPTH = 2, 4


@pytest.fixture(scope="module")
def hair_file(tmp_path_factory):
    """tests/test_shapes_extra.py:60's 12 random fibres of 8 points
    (84 segments)."""
    from tests.test_shapes_extra import _rand_fibers_file

    path = str(tmp_path_factory.mktemp("hair") / "f.hair")
    _rand_fibers_file(path)
    return path


def _close(a, b, tol, loose, share, scale=1.0, what=""):
    """Within tol (relative, absolute below `scale`) on >= share of the
    rows, within loose on all."""
    err = np.abs(a - b) / np.maximum(np.abs(b), scale)
    row = err.reshape(err.shape[0], -1).max(axis=1)
    assert (row <= tol).mean() >= share, (what, (row <= tol).mean())
    assert row.max() <= loose, (what, row.max())


def _same_ids(got, ref, t_got, t_ref):
    """Equal ids but at ties: there both t agree within 1e-5, on at most
    1% of the lanes."""
    diff = got != ref
    assert diff.mean() <= 0.01, diff.mean()
    tie = np.abs(t_got - t_ref) <= TOL * np.maximum(np.abs(t_ref), 1.0)
    assert tie[diff].all()


def test_segments_and_tables_bit_for_bit(hair_file):
    seg_j = jhairio.load_hair_segments(hair_file, radius=0.04)
    seg_t = thairio.load_hair_segments(hair_file, radius=0.04)
    assert seg_j.keys() == seg_t.keys()
    for k in seg_j:
        assert seg_t[k].dtype == seg_j[k].dtype
        np.testing.assert_array_equal(seg_t[k], seg_j[k], err_msg=k)
    assert seg_t["a"].shape == (84, 3)
    pmin = np.minimum(seg_t["a"], seg_t["b"]) - 0.04
    pmax = np.maximum(seg_t["a"], seg_t["b"]) + 0.04
    bj, bt = jbvh.build_bvh_boxes(pmin, pmax), tbvh.build_bvh_boxes(pmin,
                                                                    pmax)
    for f in ("bounds_min", "bounds_max", "first", "count", "skip", "perm"):
        np.testing.assert_array_equal(getattr(bt, f), getattr(bj, f),
                                      err_msg=f)
    h = seg_t["a"].shape[0]
    ids = dict(mid=np.full(h, 2, np.int32), eid=np.full(h, -1, np.int32),
               sid=np.arange(h, dtype=np.int32) % 5)
    pj = jri._pack_hair(dict(seg_j, **ids))
    pt = tri._pack_hair(dict(seg_t, **ids))
    for k in ("hair_nodes", "hair_segs"):
        np.testing.assert_array_equal(pt[k], np.asarray(pj[k]), err_msg=k)


def _geoms(hair_file, backend, monkeypatch=None):
    jscene = lc.hair_scene(JAX, backend, hair_file)
    if backend == "brute" and monkeypatch is not None:
        kernel_path(monkeypatch, jscene.geom)
    return jscene, (from_jax_scene(jscene, device="cpu"),
                    lc.hair_scene(PORT, backend, hair_file, device="cpu"))


def _rays(n=2048, seed=0):
    """Rays from the scene's box towards random points of the fibres'
    region (half of them) or in random directions; a third end at 1.5."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    tgt = rng.uniform(-1.5, 1.5, (n, 3))
    d = np.where((np.arange(n) % 2 == 0)[:, None], tgt - o,
                 rng.normal(size=(n, 3)))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    maxt = np.where(rng.uniform(size=n) < 0.3, 1.5, np.inf)
    return o, d, np.full(n, 1e-4, np.float32), maxt.astype(np.float32)


def _jray(o, d, mint, maxt):
    return JaxRay.make(jnp.asarray(o), jnp.asarray(d),
                       mint=jnp.asarray(mint), maxt=jnp.asarray(maxt))


def _tray(o, d, mint, maxt):
    t = torch.from_numpy
    return Ray.make(t(o), t(d), mint=t(mint), maxt=t(maxt))


def test_hair_walk_matches_reference(hair_file):
    jscene, (conv, own) = _geoms(hair_file, "bvh")
    rays = _rays()
    jr = _jray(*rays)
    for any_hit in (False, True):
        ref = [np.asarray(x) for x in jax.jit(
            lambda g, r: jri._hair_walk(g, r, any_hit))(jscene.geom, jr)]
        for scene in (conv, own):
            got = [x.numpy() for x in tri._hair_walk(scene.geom,
                                                     _tray(*rays), any_hit)]
            v = ref[3]
            np.testing.assert_array_equal(got[3], v)
            assert v.sum() > 100
            if any_hit:
                continue
            _same_ids(got[2][v], ref[2][v], got[0][v], ref[0][v])
            _close(got[0][v], ref[0][v], 1e-5, 1e-4, 0.9)
            _close(got[1][v], ref[1][v], 1e-4, 1e-3, 0.9)


def _same_records(ref, got, n_base):
    (ji, jocc), (ti, tocc) = ref, got
    for f in ("valid", "shape_id", "material_id", "emitter_id"):
        np.testing.assert_array_equal(getattr(ti, f).numpy(),
                                      np.asarray(getattr(ji, f)), f)
    np.testing.assert_array_equal(tocc.numpy(), np.asarray(jocc))
    v = np.asarray(ji.valid)
    _same_ids(ti.prim_id.numpy()[v], np.asarray(ji.prim_id)[v],
              ti.t.numpy()[v], np.asarray(ji.t)[v])
    for f in ("t", "p", "geo_n", "sh_n", "uv", "dp_du", "wi"):
        pos = f in ("t", "p")
        _close(getattr(ti, f).numpy()[v], np.asarray(getattr(ji, f))[v],
               1e-5 if pos else 1e-3, 1e-3 if pos else 1e-2, 0.97,
               scale=3.0 if pos else 1.0, what=f)
    prim = np.asarray(ji.prim_id)
    return int((prim >= n_base).sum())


@jax.jit
def _reference_queries(geom, jr, jsr):
    return ((jri.ray_intersect(geom, jr), jri.ray_test(geom, jr)),
            jri.ray_intersect_and_test(geom, jr, jsr))


def _queries(geom_j, geom_t, rays):
    """Both packages' closest and any hit of the rays, and their fused
    query with the reversed rays as the shadow rays."""
    tr = _tray(*rays)
    sr = list(rays)
    sr[1] = -rays[1]
    tsr = _tray(*sr)
    ref, fused_ref = _reference_queries(geom_j, _jray(*rays), _jray(*sr))
    got = (tri.ray_intersect(geom_t, tr), tri.ray_test(geom_t, tr))
    fused = tri.ray_intersect_and_test(geom_t, tr, tsr)
    return ref, got, fused_ref, fused


@pytest.mark.parametrize("backend", ["brute", "bvh", "cluster"])
def test_records_equal_reference(hair_file, backend, monkeypatch):
    jscene, scenes = _geoms(hair_file, backend, monkeypatch)
    g = jscene.geom
    base = g.n_tris + g.n_spheres + g.n_cylinders
    rays = _rays(1500, seed=1)
    for scene in scenes:
        assert scene.geom.backend == backend
        assert scene.geom.n_hair == 84
        ref, got, fref, fgot = _queries(g, scene.geom, rays)
        assert _same_records(ref, got, base) > 20
        _same_records(fref, fgot, base)


def _instanced(mods, path, device=None):
    """Three instances of a tessellated ball beside the fibres (cluster
    backend)."""
    b = mods.SceneBuilder()
    lm = b.materials.lambertian((0.6, 0.6, 0.6))
    red = b.materials.lambertian((0.7, 0.2, 0.2))
    b.add_shape(mods.mesh.make_quad([-4, -1, -4], [-4, -1, 4], [4, -1, 4],
                                    [4, -1, -4]), lm)
    gid = b.add_instanced_group([(mods.mesh.make_sphere_mesh(
        [0, 0, 0], 0.5, 8, 16), red)])
    for x in (-2.0, 0.0, 2.0):
        m4 = np.eye(4)
        m4[:3, 3] = (x, 0.0, 2.0)
        b.add_instance(gid, m4)
    b.add_hair(mods.hairio.load_hair_segments(path, radius=0.04), lm)
    kw = {} if device is None else dict(device=device)
    return b.build(backend="cluster", **kw)


def test_instanced_records_equal_reference(hair_file):
    jscene = _instanced(JAX, hair_file)
    o, d, mint, maxt = _rays(1000, seed=2)
    o[:, 2] = -4.0
    d[:, 2] = np.abs(d[:, 2]) + 0.5
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = (o, d, mint, maxt)
    g = jscene.geom
    for scene in (from_jax_scene(jscene, device="cpu"),
                  _instanced(PORT, hair_file, device="cpu")):
        assert scene.geom.has_instances and scene.geom.n_hair == 84
        ref, got, _, _ = _queries(g, scene.geom, rays)
        n_hair = _same_records(ref, got, g.n_tris)
        # instanced hits and hair hits both above n_tris
        assert n_hair > 20


def _reference_lanes(jscene):
    @jax.jit
    def run(scene):
        pid, sid, px, py = lanes(W, H, SPP, jnp)
        sampler = JaxSampler(0, pid, sid)
        off = sampler.next_2d()
        uv = jnp.stack([(px + off[:, 0]) / W, (py + off[:, 1]) / H], -1)
        cfg = JaxPathConfig(max_depth=DEPTH, spp=SPP, remat=False)
        return jax_path_trace(scene, scene.camera.sample_ray(uv), sampler,
                              cfg)

    L, aux = run(jscene)
    return np.asarray(L), float(aux["avg_path_length"])


def test_render_matches_kernel_path_per_lane(hair_file, monkeypatch):
    jscene = lc.hair_scene(JAX, "brute", hair_file, width=W, height=H)
    kernel_path(monkeypatch, jscene.geom)
    L_ref, apl = _reference_lanes(jscene)
    scene = from_jax_scene(jscene, device="cpu")
    own = lc.hair_scene(PORT, "brute", hair_file, device="cpu", width=W,
                        height=H)
    for f in dataclasses.fields(scene):
        _same(getattr(own, f.name), getattr(scene, f.name), f.name)
    cfg = PathConfig(max_depth=DEPTH, spp=SPP)
    ray, sampler, _ = camera_wavefront(scene, cfg, 0, morton=False)
    L, aux = path_trace(scene, ray, sampler, cfg)
    assert L_ref.mean() > 0
    L = L.numpy()
    close = np.isclose(L, L_ref, rtol=1e-4, atol=1e-6).all(axis=-1)
    assert close.mean() >= 0.97, close.mean()
    assert np.isfinite(L).all()
    assert abs(L.mean() - L_ref.mean()) <= 1e-3 * abs(L_ref.mean())
    assert abs(float(aux["avg_path_length"]) - apl) <= 0.02


_FILE = """<scene>
 <integrator type="path"><integer name="maxDepth" value="3"/></integrator>
 <camera type="perspective"><float name="fov" value="40"/>
  <transform name="toWorld"><lookAt ox="0" oy="0" oz="8" tx="0" ty="0"
   tz="0" ux="0" uy="1" uz="0"/></transform>
  <sampler type="independent"><integer name="sampleCount" value="4"/>
  </sampler>
  <film type="exrfilm"><integer name="width" value="{res}"/>
   <integer name="height" value="{res}"/></film></camera>
 <luminaire type="constant"><spectrum name="intensity" value="1.0"/>
 </luminaire>
 <shape type="hair"><string name="filename" value="{path}"/>
  <float name="radius" value="0.08"/>{extra}
  <bsdf type="lambertian"><spectrum name="reflectance" value="0.7"/>
  </bsdf></shape>
</scene>"""
_TO_WORLD = """<transform name="toWorld"><rotate x="1" angle="30"/>
  <scale value="1.5"/><translate x="0.5" y="-0.5"/></transform>"""


@pytest.mark.parametrize("extra", ["", _TO_WORLD], ids=["plain", "to_world"])
def test_scene_files_equal_reference(hair_file, extra):
    xml = _FILE.format(res=8, path=hair_file, extra=extra)
    port, _ = txml.load_scene_string(xml, device="cpu")
    conv = from_jax_scene(jxml.load_scene_string(xml)[0], device="cpu")
    for f in dataclasses.fields(port):
        _same(getattr(port, f.name), getattr(conv, f.name), f.name)
    assert port.geom.n_hair == 84 and port.geom.n_tris == 2


def test_cornell_file_equals_reference(tmp_path):
    path = lc.write_hair_cornell_xml(str(tmp_path), 20)
    params = dict(depth=3, spp=2, width=8, height=8)
    port, _ = txml.load_scene(path, params=params, device="cpu")
    conv = from_jax_scene(jxml.load_scene(path, params=params)[0],
                          device="cpu")
    for f in dataclasses.fields(port):
        _same(getattr(port, f.name), getattr(conv, f.name), f.name)
    assert port.geom.backend == "brute" and port.geom.n_hair == 300


def test_hair_luminaire_raises(hair_file):
    xml = _FILE.format(res=8, path=hair_file, extra="").replace(
        "</bsdf></shape>", '</bsdf><luminaire type="area"><rgb '
        'name="intensity" value="1"/></luminaire></shape>')
    with pytest.raises(ValueError, match="hair emitters"):
        txml.load_scene_string(xml, device="cpu")
    with pytest.raises(ValueError, match="hair emitters"):
        jxml.load_scene_string(xml)


def test_analytic_matches_tessellated(tmp_path):
    """tests/test_shapes_extra.py:127 on the port: 6 fibres of 8 points
    at radius 0.08, 48 x 48 px, 8 spp, depth 3, seed 0."""
    from tests.test_shapes_extra import _rand_fibers_file

    path = str(tmp_path / "f.hair")
    _rand_fibers_file(path, n_fibers=6)
    tess = '\n  <boolean name="tessellate" value="true"/>'
    s_a, _ = txml.load_scene_string(_FILE.format(res=48, path=path,
                                                 extra=""), device="cpu")
    s_t, _ = txml.load_scene_string(_FILE.format(res=48, path=path,
                                                 extra=tess),
                                    backend="bvh", device="cpu")
    assert s_a.geom.n_hair > 0
    assert s_t.geom.n_hair == 0 and s_t.geom.n_tris > 100
    cfg = PathConfig(max_depth=3, spp=8)
    ma = float(render(s_a, cfg, seed=0)[0].mean())
    mt = float(render(s_t, cfg, seed=0)[0].mean())
    assert np.isfinite(ma) and np.isfinite(mt)
    assert abs(ma - mt) / max(mt, 1e-6) < 0.08, (ma, mt)
