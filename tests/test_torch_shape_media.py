"""The port's shape-interior media against the JAX package: the medium
stack, the opacity column and `null()`, the builders and the scene file,
`boundary_transmittance` and `volpath_media_trace`.

- Tables (the stack, each shape's medium, the opacity column): equal
  field by field to `from_jax_scene` of the reference's scene, from the
  builders and from the scene file.
- The stack functions on numpy-seeded lanes: the grid lookups bit for
  bit; the closed forms rtol 1e-6; the ray march rtol 1e-5 (XLA reorders
  the 16-step mean); Woodcock flips (u < ρ σ_max / σ̄ within an ulp)
  counted and held under 0.1% of the lanes.
- The mask's pass-through in bsdf_sample: rtol 1e-5 (the cosine lobe's
  sqrt, sin and cos round differently in the last bits).
- boundary_transmittance on the tank's shadow rays: the same
  transmittance on the brute, bvh and cluster backends (its walk reads
  each hit's shape id and material), rtol 1e-5.
- volpath_media_trace with a homogeneous and with a grid interior, lane
  by lane against the reference's kernel path (#2 in interpret mode):
  >= 99% of lanes within rtol 1e-4, the mean within 1e-3 relative.
- The interior σ gradient against central differences, as
  tests/test_grad.py:76-97 holds the reference's (h = 0.02, within 8%; 4
  seeds here, 12 there).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba_tpu.render.intersect as jax_intersect
import tests.golden_scenes as golden_scenes
from mitsuba_tpu.bsdfs import bsdf_sample as j_sample
from mitsuba_tpu.bsdfs.table import MaterialBuilder as JaxMaterialBuilder
from mitsuba_tpu.integrators.path import PathConfig as JaxPathConfig
from mitsuba_tpu.integrators.volpath import (
    volpath_media_trace as jax_media_trace,
)
from mitsuba_tpu.io import xml as jxml
from mitsuba_tpu.media import medium as jmed
from mitsuba_tpu.ops import intersect_pallas
from mitsuba_tpu.render import mesh as jmesh
from mitsuba_tpu.render.sampler import Sampler as JaxSampler
from mitsuba_tpu.render.sampler import sample_position as jax_sample_position
from mitsuba_tpu.render.scene import SceneBuilder as JaxSceneBuilder
from mitsuba_tpu_torch.bsdfs import MaterialBuilder, bsdf_sample
from mitsuba_tpu_torch.integrators import (
    PathConfig, render_volpath_media, volpath_media_trace,
)
from mitsuba_tpu_torch.integrators.path import camera_wavefront
from mitsuba_tpu_torch.integrators.volpath import boundary_transmittance
from mitsuba_tpu_torch.interop import from_jax_scene
from mitsuba_tpu_torch.io import volio
from mitsuba_tpu_torch.io import xml as txml
from mitsuba_tpu_torch.media import medium as tmed
from mitsuba_tpu_torch.render import mesh as tmesh
from mitsuba_tpu_torch.render import sampler as rs
from mitsuba_tpu_torch.render.scene import SceneBuilder
from tests import torch_media_cases as mc
from tests.test_torch_xml import _same, _same_scene

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x))


def _media_list(rng):
    """Three media: homogeneous, a 5x4x6 grid and a 3x7x2 grid (padded to
    a common shape in the stack)."""
    def grid(shape, lo, hi):
        return dict(density=rng.uniform(0, 1, shape).astype(np.float32),
                    world_to_grid=mc.grid_to_box(shape, lo, hi))

    return [((0.4, 0.5, 0.6), (0.15, 0.1, 0.05), 0.3),
            dict(sigma_s=(0.8,) * 3, sigma_a=(0.2, 0.1, 0.3), g=-0.2,
                 density_scale=1.5, **grid((5, 4, 6), (-1,) * 3, (1,) * 3)),
            dict(sigma_s=(1.0, 0.5, 0.2), sigma_a=(0.1,) * 3, g=0.0,
                 **grid((3, 7, 2), (-2, -1, -1), (1, 2, 0.5)))]


def test_medium_stack_equals_reference():
    media = _media_list(np.random.default_rng(0))
    for subset in (media[:1], media):
        port = tmed.make_medium_stack(subset)
        ref = jmed.make_medium_stack(subset)
        for f in ("sigma_s", "sigma_a", "phase_g", "grid_id", "grids",
                  "grid_dims", "world_to_grid", "density_scale",
                  "max_density"):
            a, b = getattr(port, f), getattr(ref, f)
            assert (a is None) == (b is None), f
            if a is not None:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                              err_msg=f)
        assert port.has_hetero == ref.has_hetero
    assert tmed.make_medium_stack([]).n_media == 0


def test_stack_functions_match_reference():
    rng = np.random.default_rng(1)
    media = _media_list(rng)
    port, ref = tmed.make_medium_stack(media), jmed.make_medium_stack(media)
    n = 6000
    cur = rng.integers(-1, 3, n).astype(np.int32)
    p = rng.uniform(-2.5, 2.5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    np.testing.assert_array_equal(
        tmed.stack_lookup_density(port, _t(cur), _t(p)).numpy(),
        np.asarray(jmed.stack_lookup_density(ref, cur, p)))
    np.testing.assert_array_equal(tmed.stack_is_hetero(port, _t(cur)),
                                  jmed.stack_is_hetero(ref, cur))
    got = tmed.stack_params(port, _t(cur))
    want = jmed.stack_params(ref, cur)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ss, sa = got[0], got[1]
    dist = rng.uniform(0, 3, n).astype(np.float32)
    u = rng.uniform(0, 1, (2, n)).astype(np.float32)
    kw = dict(rtol=1e-6, atol=1e-7)
    a = tmed.stack_sample_distance(ss, sa, _t(dist), _t(u[0]), _t(u[1]))
    b = jmed.stack_sample_distance(want[0], want[1], dist, u[0], u[1])
    for k in a:
        np.testing.assert_allclose(a[k].numpy(), np.asarray(b[k]), **kw)
    np.testing.assert_allclose(tmed.stack_transmittance(ss, sa, _t(dist)),
                               jmed.stack_transmittance(want[0], want[1],
                                                        dist), **kw)
    np.testing.assert_allclose(
        tmed.stack_transmittance_het(port, _t(cur), ss, sa, _t(p), _t(d),
                                     _t(dist)),
        jmed.stack_transmittance_het(ref, cur, want[0], want[1], p, d,
                                     dist), rtol=1e-5, atol=1e-6)
    a = tmed.stack_sample_distance_het(port, _t(cur), ss, sa, _t(p), _t(d),
                                       _t(dist), _t(u[0]), _t(u[1]),
                                       rs.key(17))
    b = jmed.stack_sample_distance_het(ref, cur, want[0], want[1], p, d,
                                       dist, u[0], u[1], jax.random.key(17))
    va, vb = a["valid"].numpy(), np.asarray(b["valid"])
    assert int((va != vb).sum()) <= n // 1000
    same = va == vb
    for k in ("t", "weight", "surface_weight"):
        np.testing.assert_allclose(a[k].numpy()[same],
                                   np.asarray(b[k])[same], rtol=1e-5)


def test_null_material_passes_through_as_reference():
    jb, tb = JaxMaterialBuilder(), MaterialBuilder()
    for b in (jb, tb):
        b.lambertian((0.6, 0.5, 0.4))
        b.null()
        b.dielectric(int_ior=1.33)
    jt, tt = jb.build(), tb.build()
    assert tt.has_mask and not MaterialBuilder().build().has_mask
    np.testing.assert_array_equal(tt.opacity.numpy(), np.asarray(jt.opacity))
    rng = np.random.default_rng(5)
    n = 3000
    mid = rng.integers(0, 3, n).astype(np.int32)
    wi = rng.normal(size=(n, 3)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    u2 = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    u1 = rng.uniform(0, 1, n).astype(np.float32)
    got = bsdf_sample(tt, _t(mid), _t(wi), _t(u2), _t(u1))
    ref = j_sample(jt, mid, wi, u2, u1)
    for k in ("wo", "weight", "pdf", "delta", "transmission", "valid"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5, atol=2e-6, err_msg=k)
    assert bool(got["transmission"][mid == 1].all())


def _builders(vol=None):
    """The tank with a homogeneous interior, a sphere with a grid interior
    and a media-only (null) box, in both packages."""
    out = []
    for sb, msh in ((JaxSceneBuilder, jmesh), (SceneBuilder, tmesh)):
        b = sb()
        glass = b.materials.dielectric(int_ior=1.0, ext_ior=1.0)
        grey = b.materials.lambertian((0.5, 0.5, 0.5))
        null = b.materials.null()
        m0 = b.add_medium(**mc.TANK_MEDIUM)
        m1 = b.add_medium((0.3,) * 3, (0.1,) * 3, g=0.2,
                          density=mc.noise_grid(6, 3),
                          world_to_grid=mc.grid_to_box((6, 6, 6), (2, -1, -1),
                                                       (4, 1, 1)),
                          density_scale=2.0)
        b.add_shape(msh.make_box([-1, -1, -1], [1, 1, 1]), glass,
                    interior_medium=m0)
        b.add_sphere([3, 0, 0], 1.0, glass, interior_medium=m1)
        b.add_shape(msh.make_box([-1, -1, 2], [1, 1, 3]), null,
                    interior_medium=m0)
        b.add_shape(msh.make_quad([-6, -1.05, -6], [6, -1.05, -6],
                                  [6, -1.05, 6], [-6, -1.05, 6]), grey)
        b.add_area_emitter_shape(msh.make_quad(
            [-1, 3.0, -1], [1, 3.0, -1], [1, 3.0, 1], [-1, 3.0, 1]),
            b.materials.lambertian((0.0,) * 3), (14.0, 13.0, 12.0))
        out.append(b)
    return out


def test_builder_tables_equal_reference():
    jb, tb = _builders()
    jscene = jb.build(backend="brute")
    port = tb.build(backend="brute", device="cpu")
    _same_scene(port, from_jax_scene(jscene, device="cpu"), "builder")
    assert port.shape_interior.tolist() == [0, 1, 0, -1, -1]
    assert port.media.has_hetero and port.materials.has_mask


_XML = """<scene>
 <camera type="perspective"><float name="fov" value="40"/>
  <transform name="toWorld"><lookAt ox="0" oy="1.5" oz="4" tx="0" ty="0.5"
   tz="0" ux="0" uy="1" uz="0"/></transform>
  <sampler type="independent"><integer name="sampleCount" value="2"/>
  </sampler>
  <film type="exrfilm"><integer name="width" value="8"/>
   <integer name="height" value="8"/></film></camera>
 <shape type="obj"><string name="filename" value="floor.obj"/>
  <medium type="homogeneous" name="interior">
   <rgb name="sigmaS" value="0.4 0.5 0.6"/><rgb name="sigmaA" value="0.1"/>
   <phase type="hg"><float name="g" value="0.3"/></phase></medium>
  <bsdf type="dielectric"><float name="intIOR" value="1.0"/></bsdf></shape>
 <shape type="sphere"><point name="center" x="0" y="1" z="0"/>
  <float name="radius" value="0.5"/>
  <medium type="heterogeneous" name="interior">
   <float name="sigmaT" value="2"/><rgb name="albedo" value="0.9 0.8 0.7"/>
   <float name="densityMultiplier" value="1.5"/>
   <volume type="gridvolume" name="density">
    <string name="filename" value="d.vol"/></volume></medium></shape>
 <shape type="obj"><string name="filename" value="light.obj"/>
  <luminaire type="area"><rgb name="intensity" value="10"/></luminaire>
 </shape>
</scene>"""


@pytest.fixture
def xml_assets(tmp_path):
    from mitsuba_tpu_torch.io import meshio

    meshio.save_obj(str(tmp_path / "floor.obj"), tmesh.make_quad(
        [-3, 0, -3], [-3, 0, 3], [3, 0, 3], [3, 0, -3]))
    meshio.save_obj(str(tmp_path / "light.obj"), tmesh.make_quad(
        [-0.5, 2.5, -0.5], [0.5, 2.5, -0.5], [0.5, 2.5, 0.5],
        [-0.5, 2.5, 0.5]))
    volio.save_vol(str(tmp_path / "d.vol"), mc.noise_grid(5, 4),
                   (-0.5, 0.5, -0.5), (0.5, 1.5, 0.5))
    return str(tmp_path)


def test_xml_interior_media_equal_reference(xml_assets):
    scene, _ = txml.load_scene_string(_XML, base_dir=xml_assets,
                                      device="cpu")
    jscene, _ = jxml.load_scene_string(_XML, base_dir=xml_assets)
    conv = from_jax_scene(jscene, device="cpu")
    _same_scene(scene, conv, "xml")
    assert scene.shape_interior.tolist() == [0, 1, -1]
    assert scene.media.has_hetero and scene.media.n_media == 2
    # the sphere without a BSDF gets the pass-through null() material
    assert float(scene.materials.opacity.min()) == 0.0
    cfg = PathConfig(max_depth=3, spp=2)
    a, _ = render_volpath_media(scene, cfg, seed=1)
    b, _ = render_volpath_media(conv, cfg, seed=1)
    assert torch.equal(a, b) and bool(torch.isfinite(a).all())


def test_boundary_transmittance_is_the_same_on_every_backend():
    """The tank's shadow walk reads each hit's shape id and material: the
    same transmittance, and the same shape ids, on brute, bvh and cluster
    (the tank's 16 triangles; cluster built for them)."""
    jb, tb = _builders()
    scenes = {bk: tb.build(backend=bk, device="cpu")
              for bk in ("brute", "bvh", "cluster")}
    rng = np.random.default_rng(7)
    n = 2000
    o = rng.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
    o[: n // 2, 0] += 3.0                    # half inside the sphere's box
    tgt = rng.uniform(-1, 1, (n, 3)).astype(np.float32) + np.float32(
        [0, 3.0, 0])
    d = tgt - o
    dist = np.linalg.norm(d, axis=-1).astype(np.float32)
    d = (d / dist[:, None]).astype(np.float32)
    cur = np.where(np.arange(n) < n // 2, 1, 0).astype(np.int32)
    out = {}
    from mitsuba_tpu_torch.render.intersect import ray_intersect
    from mitsuba_tpu_torch.render.records import Ray

    for bk, sc in scenes.items():
        tr = boundary_transmittance(sc, _t(o), _t(d), _t(dist), _t(cur))
        its = ray_intersect(sc.geom, Ray.make(_t(o), _t(d)))
        out[bk] = (tr.numpy(), its.shape_id.numpy())
    for bk in ("bvh", "cluster"):
        np.testing.assert_allclose(out[bk][0], out["brute"][0], rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_array_equal(out[bk][1], out["brute"][1])
    tr = out["brute"][0]
    assert 0.0 < tr.mean() < 1.0 and (tr.max(-1) < 1.0).mean() > 0.5


def _jax_lanes(w, h, spp, seed):
    lane = jnp.arange(w * h * spp)
    pid, sid = lane // spp, (lane % spp).astype(jnp.int32)
    sampler = JaxSampler(seed, pid, sid)
    off = jax_sample_position("independent", sid, spp, sampler.next_2d())
    uv = jnp.stack([((pid % w).astype(jnp.float32) + off[:, 0]) / w,
                    ((pid // w).astype(jnp.float32) + off[:, 1]) / h], -1)
    return sampler, uv


def _jax_tank(res, density=None):
    """tests/golden_scenes.py's tank at res x res, its interior optionally
    a grid spanning the box."""
    old = golden_scenes.RES
    golden_scenes.RES = res
    try:
        if density is None:
            return golden_scenes.scene_volumetric_tank()[0]
        b = JaxSceneBuilder()
        glass = b.materials.dielectric(int_ior=1.0, ext_ior=1.0)
        lm = b.materials.lambertian((0.0, 0.0, 0.0))
        grey = b.materials.lambertian((0.5, 0.5, 0.5))
        med = b.add_medium(**mc.TANK_MEDIUM, density=density,
                           world_to_grid=mc.grid_to_box(
                               density.shape, (-1,) * 3, (1,) * 3))
        b.add_shape(jmesh.make_box([-1, -1, -1], [1, 1, 1]), glass,
                    interior_medium=med)
        b.add_shape(jmesh.make_quad([-4, -1.05, -4], [4, -1.05, -4],
                                    [4, -1.05, 4], [-4, -1.05, 4]), grey)
        b.add_area_emitter_shape(jmesh.make_quad(
            [-1, 3.0, -1], [1, 3.0, -1], [1, 3.0, 1], [-1, 3.0, 1]), lm,
            (14.0, 13.0, 12.0))
        golden_scenes._camera(b, (0, 0.8, 4.2), (0, 0, 0))
        return b.build(backend="brute")
    finally:
        golden_scenes.RES = old


RES, SPP, DEPTH = 12, 2, 6


@pytest.fixture(scope="module")
def reference_lanes():
    """The reference's lanes of the tank, homogeneous and gridded, through
    its kernel path (one interpreted compile each)."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_intersect, "_use_pallas", lambda: True)
        mp.setattr(intersect_pallas, "_UNROLL_LIMIT", 0)
        for name in ("closest_hit_shaded", "any_hit"):
            mp.setattr(intersect_pallas, name, functools.partial(
                getattr(intersect_pallas, name), interpret=True))
        for kind in ("homogeneous", "grid"):
            jscene = _jax_tank(RES, mc.noise_grid(8, 6)
                               if kind == "grid" else None)

            @jax.jit
            def lanes(scene):
                sampler, uv = _jax_lanes(RES, RES, SPP, 2)
                return jax_media_trace(scene, scene.camera.sample_ray(uv),
                                       sampler, JaxPathConfig(
                                           max_depth=DEPTH, spp=SPP,
                                           remat=False))

            L, aux = lanes(jscene)
            out[kind] = (jscene, np.asarray(L), float(aux["avg_path_length"]))
    return out


@pytest.mark.parametrize("kind", ["homogeneous", "grid"])
def test_media_trace_matches_kernel_path_per_lane(reference_lanes, kind):
    from tests.test_torch_hetero import assert_lanes_match

    jscene, L_ref, apl = reference_lanes[kind]
    scene = from_jax_scene(jscene, device="cpu")
    cfg = PathConfig(max_depth=DEPTH, spp=SPP)
    ray, sampler, _ = camera_wavefront(scene, cfg, seed=2, morton=False)
    L, aux = volpath_media_trace(scene, ray, sampler, cfg)
    assert L_ref.mean() > 0
    assert_lanes_match(L.numpy(), L_ref)
    assert abs(float(aux["avg_path_length"]) - apl) <= 0.02
    # the port's own builder gives the same scene and lanes
    own = mc.tank_scene(RES, mc.noise_grid(8, 6) if kind == "grid" else
                        None, device="cpu")
    _same(own.media, scene.media, "media")
    ray, sampler, _ = camera_wavefront(own, cfg, seed=2, morton=False)
    assert torch.equal(volpath_media_trace(own, ray, sampler, cfg)[0], L)


@pytest.mark.parametrize("field,base", [("sigma_a", 0.5), ("sigma_s", 0.4)])
def test_interior_sigma_gradient_matches_central_differences(field, base):
    """The reference's FD gate (test_grad.py:76-97): seed-matched central
    differences of the image mean, h = 0.02, against the reverse-mode
    gradient through stack_params' gather; within 8%. Seeds 20-23 here
    (the reference's test and chip_smoke.py's tank_grad take 20-31): a
    seed's difference is exact up to the discrete events that h flips."""
    scene = mc.fd_tank_scene(8, device="cpu")
    cfg = PathConfig(max_depth=6, spp=32, remat=False)

    def mean(v, seed):
        media = dataclasses.replace(scene.media, **{field: v.expand(1, 3)})
        img, _ = render_volpath_media(dataclasses.replace(scene,
                                                          media=media),
                                      cfg, seed=seed)
        return img.mean()

    h = 0.02
    seeds = range(20, 24)
    with torch.no_grad():
        fd = np.mean([(float(mean(torch.tensor(base + h), s))
                       - float(mean(torch.tensor(base - h), s))) / (2 * h)
                      for s in seeds])
    ads = []
    for s in seeds:
        v = torch.tensor(base, requires_grad=True)
        mean(v, s).backward()
        ads.append(float(v.grad))
    ad = np.mean(ads)
    assert np.isfinite(ad) and np.isfinite(fd)
    assert abs(ad - fd) / max(abs(fd), 1e-6) < 0.08, (field, ad, fd)
