"""The port's lights against the JAX package: point, spot, directional,
collimated, constant, image-envmap and analytic sphere emitters beside
area triangles (emitters/table.py, emitters/envmap.py, the sphere's MIS
counterweight in integrators/path.py).

(a) Tables: each kind's rows, records and environment tables, built by
    both packages' SceneBuilders, equal bit for bit through interop.py.
(b) `sample_direct` lane by lane with the same numpy uniforms from
    seeded reference points: integers and booleans exactly, values and
    pdfs within 1e-5 relative and 1e-6 absolute; sampled directions (the
    sphere's cone, the constant light's sphere, the envmap's texel) and
    what follows from them, 999 lanes in 1,000 within 1e-4 / 1e-5 and
    every lane within 1e-3 / 1e-4 (XLA's CPU sin, cos, sqrt round
    differently from PyTorch's in the last bits, as in
    tests/test_torch_bsdf_zoo.py).
(c) `pdf_direct_area` on triangles and on spheres, and the environment
    functions, within 1e-5 / 1e-6.
(d) The JAX package's own checks on the port: tests/test_delta_emitters.py
    (inverse square, directional cosine, spot cone, collimated beam) and
    tests/test_envmap.py (chi^2 of the envmap sampler, its pdf's
    integral, the furnace), with their tolerances.
(e) The scene's render through every light, the port's path tracer
    against the JAX package's kernel path (tests/torch_kernel_path.py),
    lane by lane.
"""
import os
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.core import transform as jtf
from mitsuba_tpu.core.chi2 import chi2_test
from mitsuba_tpu.core.quad import sphere_bin_integrate
from mitsuba_tpu.emitters import envmap as jenv
from mitsuba_tpu.emitters import table as jtab
from mitsuba_tpu.integrators.path import PathConfig as JaxPathConfig
from mitsuba_tpu.integrators.path import path_trace as jax_path_trace
from mitsuba_tpu.render import mesh as jmesh
from mitsuba_tpu.render.camera import make_perspective as j_persp
from mitsuba_tpu.render.sampler import Sampler as JaxSampler
from mitsuba_tpu.render.scene import SceneBuilder as JaxSceneBuilder
from mitsuba_tpu_torch.core import transform as ttf
from mitsuba_tpu_torch.emitters import envmap
from mitsuba_tpu_torch.emitters import table as tab
from mitsuba_tpu_torch.integrators.path import PathConfig, path_trace
from mitsuba_tpu_torch.interop import from_jax_scene
from mitsuba_tpu_torch.render import mesh as tmesh
from mitsuba_tpu_torch.render.camera import make_perspective as t_persp
from mitsuba_tpu_torch.render.records import Ray
from mitsuba_tpu_torch.render.sampler import Sampler
from mitsuba_tpu_torch.render.scene import SceneBuilder

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_kernel_path as kp  # noqa: E402

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-6
JAX = SimpleNamespace(SceneBuilder=JaxSceneBuilder, mesh=jmesh,
                      look_at=jtf.look_at, make_perspective=j_persp)
PORT = SimpleNamespace(SceneBuilder=SceneBuilder, mesh=tmesh,
                       look_at=ttf.look_at, make_perspective=t_persp)
EMITTER_FIELDS = ("kind", "radiance", "position", "direction", "cutoff_cos",
                  "falloff_cos", "tri_pdf_area", "rec_cdf", "rec_pmf",
                  "rec_emitter", "rec_prim", "radius", "env_image",
                  "env_prob", "env_alias", "env_pdf_img", "env_to_world",
                  "env_to_env")


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol,
                               atol=atol)


def _close_sampled(a, b, share=0.999):
    a, b = a.numpy(), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4)
    ok = np.isclose(a, b, rtol=1e-4, atol=1e-5)
    ok = ok.reshape(len(ok), -1).all(-1)
    assert ok.mean() >= share, ok.mean()


def env_image(h=8, w=16, seed=11):
    img = np.random.default_rng(seed).uniform(0.1, 2.0, (h, w, 3))
    img[2:4, 5:8] *= 15.0
    return img.astype(np.float32)


ENV_TO_WORLD = np.array([[1, 0, 0, 0], [0, 0, 1, 0], [0, -1, 0, 0],
                         [0, 0, 0, 1]], np.float32)


def lights_scene(mods, env, w=8, h=8):
    """A floor, a small area light, a sphere light and every other kind;
    env 'constant' or 'envmap'."""
    b = mods.SceneBuilder()
    floor = b.materials.lambertian((0.7, 0.6, 0.5))
    black = b.materials.lambertian((0.0, 0.0, 0.0))
    quad = mods.mesh.make_quad
    b.add_shape(quad([-4, 0, -4], [-4, 0, 4], [4, 0, 4], [4, 0, -4]), floor)
    b.add_area_emitter_shape(quad([-0.5, 3, -0.5], [0.5, 3, -0.5],
                                  [0.5, 3, 0.5], [-0.5, 3, 0.5]), black,
                             (6.0, 5.0, 4.0))
    b.add_sphere_emitter([1.2, 1.5, 0.3], 0.3, black, (9.0, 8.0, 7.0))
    b.emitters.point((-1.0, 2.0, 0.5), (8.0, 8.0, 8.0))
    b.emitters.spot((0.5, 2.5, -1.0), (0.1, -1.0, 0.3), (20.0, 18.0, 16.0),
                    cutoff_deg=30.0, falloff_deg=20.0)
    b.emitters.directional((0.3, -1.0, 0.2), (0.8, 0.8, 0.8))
    b.emitters.collimated((0.0, 4.0, 0.0), (0.0, -1.0, 0.1), (2.0,) * 3,
                          radius=1.5)
    if env == "constant":
        b.emitters.constant((0.3, 0.35, 0.4))
    else:
        b.emitters.envmap(env_image(), to_world=ENV_TO_WORLD, scale=0.5)
    b.set_camera(mods.make_perspective(mods.look_at(
        [0, 3, -6], [0, 0.5, 0], [0, 1, 0]), 45, w / h), w, h)
    return b.build(backend="brute", **({} if mods is JAX
                                       else dict(device="cpu")))


@pytest.fixture(scope="module", params=["constant", "envmap"])
def scenes(request):
    js = lights_scene(JAX, request.param)
    return js, from_jax_scene(js, device="cpu"), \
        lights_scene(PORT, request.param)


def test_tables_equal_reference(scenes):
    _js, conv, own = scenes
    for name in EMITTER_FIELDS:
        a, b = getattr(own.emitters, name), getattr(conv.emitters, name)
        assert a.dtype == b.dtype and np.array_equal(a.numpy(), b.numpy()), \
            name
    for name in ("n_tri_records", "kinds_present", "env_id", "env_kind"):
        assert getattr(own.emitters, name) == getattr(conv.emitters, name)
    assert own.geom.sph_eid.tolist() == conv.geom.sph_eid.tolist() == [1]
    assert set(own.emitters.kinds_present) >= {0, 1, 2, 3, 4, 8}


def test_builder_rows_and_defaults():
    """Record weights: luminance x 4 pi r^2 for a sphere, x 4 pi for the
    others; a scene without emitters gets one dead point row."""
    rows = []
    for eb in (jtab.EmitterBuilder(), tab.EmitterBuilder()):
        eb.point((0, 1, 0), (2.0, 2.0, 2.0))
        eb.sphere_area((0, 0, 0), 0.5, (1.0, 1.0, 1.0))
        eb.spot((0, 2, 0), (0, -1, 0), (3.0,) * 3)
        rows.append(eb.build(np.full(2, -1, np.int32), np.ones(2)))
    jem, tem = rows
    np.testing.assert_array_equal(tem.rec_pmf.numpy(),
                                  np.asarray(jem.rec_pmf))
    w = np.array([2.0 * 4 * np.pi, 4 * np.pi * 0.25, 3.0 * 4 * np.pi])
    np.testing.assert_allclose(tem.rec_pmf.numpy(), w / w.sum(), rtol=1e-6)
    jdead = jtab.EmitterBuilder().build(np.zeros(1, np.int32), np.ones(1))
    tdead = tab.EmitterBuilder().build(np.zeros(1, np.int32), np.ones(1))
    assert tdead.kind.tolist() == np.asarray(jdead.kind).tolist() == [1]
    assert tdead.rec_pmf.tolist() == [0.0] and tdead.env_id == -1


def _ref_points(n, seed):
    rng = np.random.default_rng(seed)
    p = np.stack([rng.uniform(-3, 3, n), rng.uniform(0.0, 1.2, n),
                  rng.uniform(-3, 3, n)], -1).astype(np.float32)
    u_sel = rng.uniform(size=n).astype(np.float32)
    u_pos = rng.uniform(size=(n, 2)).astype(np.float32)
    return p, u_sel, u_pos


def test_sample_direct_matches_reference(scenes):
    js, conv, _own = scenes
    n = 4000
    p, u_sel, u_pos = _ref_points(n, 5)
    ref = jax.jit(lambda a, b, c: jtab.sample_direct(
        js.emitters, js.geom, a, b, c))(p, u_sel, u_pos)
    got = tab.sample_direct(conv.emitters, conv.geom, _t(p), _t(u_sel),
                            _t(u_pos))
    for k in ("emitter_id", "delta", "valid"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(ref, k)), k)
    kinds = conv.emitters.kind[got.emitter_id.long()]
    assert set(kinds.tolist()) == set(conv.emitters.kinds_present)
    for k in ("d", "n", "value", "pdf"):
        _close_sampled(getattr(got, k), getattr(ref, k))
    fin = np.isfinite(np.asarray(ref.dist))
    np.testing.assert_array_equal(np.isfinite(got.dist.numpy()), fin)
    np.testing.assert_allclose(got.dist.numpy()[fin],
                               np.asarray(ref.dist)[fin], rtol=1e-3,
                               atol=1e-4)


def test_pdf_direct_area_matches_reference(scenes):
    """Triangle hits (emitter_id or not) and sphere hits, from seeded
    reference points."""
    js, conv, _own = scenes
    n = 2000
    rng = np.random.default_rng(9)
    p_ref, _, _ = _ref_points(n, 10)
    g = conv.geom
    prim = rng.integers(0, g.n_tris + 1, n).astype(np.int32)
    tri = np.minimum(prim, g.n_tris - 1)
    bary = rng.dirichlet((1, 1, 1), n).astype(np.float32)
    v0, e1, e2 = (getattr(g, k).numpy()[tri] for k in ("v0", "e1", "e2"))
    p_tri = v0 + e1 * bary[:, 1:2] + e2 * bary[:, 2:3]
    n_tri = np.cross(e1, e2)
    n_tri /= np.linalg.norm(n_tri, axis=-1, keepdims=True)
    # the last prim id is the sphere light
    c, r = g.sph_c.numpy()[0], float(g.sph_r.numpy()[0])
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    is_sph = prim == g.n_tris
    p_hit = np.where(is_sph[:, None], c + r * nrm, p_tri).astype(np.float32)
    n_hit = np.where(is_sph[:, None], nrm, n_tri).astype(np.float32)
    eid = np.where(is_sph, 1, g.emitter_id.numpy()[tri]).astype(np.int32)
    ref = jtab.pdf_direct_area(js.emitters, prim, p_ref, p_hit, n_hit,
                               emitter_id=eid)
    got = tab.pdf_direct_area(conv.emitters, _t(prim), _t(p_ref),
                              _t(p_hit), _t(n_hit), emitter_id=_t(eid))
    _close(got, ref)
    assert float(got[torch.from_numpy(is_sph)].min()) > 0
    ref0 = jtab.pdf_direct_area(js.emitters, prim, p_ref, p_hit, n_hit)
    _close(tab.pdf_direct_area(conv.emitters, _t(prim), _t(p_ref),
                               _t(p_hit), _t(n_hit)), ref0)


def test_environment_functions_match_reference(scenes):
    js, conv, _own = scenes
    d = np.random.default_rng(4).normal(size=(3000, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    em, jem = conv.emitters, js.emitters
    _close(tab.eval_environment(em, _t(d)), jtab.eval_environment(jem, d))
    _close(tab.pdf_environment(em, _t(d)), jtab.pdf_environment(jem, d))
    v, p = tab.eval_and_pdf_environment(em, _t(d))
    jv, jp = jtab.eval_and_pdf_environment(jem, d)
    _close(v, jv)
    _close(p, jp)
    # the fused pair and the two halves give the same bits
    assert torch.equal(v, tab.eval_environment(em, _t(d)))
    if em.env_kind == tab.ENVMAP:
        _close(envmap.env_eval(em.env_image, _t(d), em.env_to_env, 2.0),
               jenv.env_eval(jem.env_image, d, jem.env_to_env, 2.0))


def test_env_eval_pdf_other_shape_matches_reference():
    """env_eval_pdf where the pdf image has another shape than the map's
    (envmap.py:210)."""
    img = env_image()
    pdf_img = np.random.default_rng(2).uniform(0.1, 1, (4, 6)).astype(
        np.float32)
    d = np.random.default_rng(3).normal(size=(500, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    eye = np.eye(4, dtype=np.float32)
    v, p = envmap.env_eval_pdf(_t(img), _t(pdf_img), _t(d), _t(eye))
    jv, jp = jenv.env_eval_pdf(img, pdf_img, d, to_env=eye)
    _close(v, jv)
    assert (p.numpy() == np.asarray(jp)).mean() >= 0.99


# ---------------------------------------------------------------------------
# the JAX package's checks (tests/test_delta_emitters.py, test_envmap.py)
# ---------------------------------------------------------------------------

def floor_scene(add_emitter, albedo=0.8):
    b = SceneBuilder()
    mat = b.materials.lambertian((albedo,) * 3)
    b.add_shape(tmesh.make_quad([-20, 0, -20], [-20, 0, 20], [20, 0, 20],
                                [20, 0, -20]), mat)
    add_emitter(b)
    b.set_camera(t_persp(ttf.look_at([0, 5, -5], [0, 0, 0], [0, 1, 0]), 40,
                         1.0), 8, 8)
    return b.build(backend="brute", device="cpu")


def _down_rays(n=256, height=3.0, spread=0.2):
    rng = np.random.default_rng(0)
    o = np.stack([(rng.uniform(size=n) - 0.5) * spread,
                  np.full(n, height),
                  (rng.uniform(size=n) - 0.5) * spread], -1)
    d = np.broadcast_to(np.array([0.0, -1.0, 0.0]), (n, 3))
    return Ray.make(_t(o.astype(np.float32)), _t(d.astype(np.float32)))


def radiance_at_origin(scene, depth=2, seed=5, n=256):
    sampler = Sampler(seed, torch.arange(n, dtype=torch.int32),
                      torch.zeros(n, dtype=torch.int32))
    L, _ = path_trace(scene, _down_rays(n), sampler,
                      PathConfig(max_depth=depth, spp=1, remat=False))
    return float(L[:, 0].mean())


def test_point_light_inverse_square():
    h = 4.0
    scene = floor_scene(lambda b: b.emitters.point((0, h, 0), (10.0,) * 3))
    expect = 0.8 / np.pi * 10.0 / (h * h)
    np.testing.assert_allclose(radiance_at_origin(scene), expect, rtol=0.03)


def test_directional_light():
    d = np.array([0.0, -1.0, 0.3], np.float32)
    d /= np.linalg.norm(d)
    scene = floor_scene(lambda b: b.emitters.directional(tuple(d),
                                                         (2.0,) * 3))
    expect = 0.8 / np.pi * 2.0 * float(-d[1])
    np.testing.assert_allclose(radiance_at_origin(scene), expect, rtol=0.03)


def test_spot_light_cone():
    h = 4.0
    scene = floor_scene(lambda b: b.emitters.spot(
        (0, h, 0), (0, -1, 0), (10.0,) * 3, cutoff_deg=25.0,
        falloff_deg=24.0))
    np.testing.assert_allclose(radiance_at_origin(scene),
                               0.8 / np.pi * 10.0 / (h * h), rtol=0.05)
    n = 64
    o = torch.tensor([8.0, 3.0, 0.0]).expand(n, 3)
    d = torch.tensor([0.0, -1.0, 0.0]).expand(n, 3)
    sampler = Sampler(3, torch.arange(n, dtype=torch.int32),
                      torch.zeros(n, dtype=torch.int32))
    L, _ = path_trace(scene, Ray.make(o, d), sampler,
                      PathConfig(max_depth=2, spp=1, remat=False))
    assert float(L.mean()) < 1e-6


def test_collimated_beam():
    scene = floor_scene(lambda b: b.emitters.collimated(
        (0, 5, 0), (0, -1, 0), (4.0,) * 3, radius=1.0))
    np.testing.assert_allclose(radiance_at_origin(scene), 0.8 / np.pi * 4.0,
                               rtol=0.03)


def _env(seed, h=16, w=32):
    img = np.random.default_rng(seed).uniform(0.1, 2.0, (h, w, 3)).astype(
        np.float32)
    img[3:6, 10:14] *= 20.0
    return img


def test_env_sampling_chi2():
    prob, alias, pdf_img = (_t(x) for x in envmap.build_env_cdfs(_env(1)))

    def sample_fn(key, n):
        u2 = _t(np.asarray(jax.random.uniform(key, (n, 2))))
        return jnp.asarray(envmap.env_sample(prob, alias, pdf_img, None,
                                             u2)[0].numpy())

    def pdf_fn(d):
        sh = d.shape[:-1]
        p = envmap.env_pdf(pdf_img, _t(np.asarray(d).reshape(-1, 3)))
        return jnp.asarray(p.numpy()).reshape(sh)

    res = chi2_test(jax.random.key(2), sample_fn, pdf_fn, n_samples=400_000,
                    theta_res=16, phi_res=32)
    assert res.passed, f"chi2={res.chi2:.1f} p={res.p_value:.2e}"


def test_env_pdf_integrates_to_one():
    _, _, pdf_img = envmap.build_env_cdfs(_env(3))
    pi = _t(pdf_img)

    def pdf(d):
        p = envmap.env_pdf(pi, _t(np.asarray(d).reshape(-1, 3)))
        return jnp.asarray(p.numpy()).reshape(d.shape[:-1])

    total = float(sphere_bin_integrate(pdf, 32, 64, sub=4).sum())
    assert abs(total - 1.0) < 2e-2, total


def test_envmap_furnace():
    """A uniform envmap over a lambertian plane: L = albedo."""
    b = SceneBuilder()
    mat = b.materials.lambertian((0.6, 0.6, 0.6))
    b.add_shape(tmesh.make_quad([-1, 0, -1], [-1, 0, 1], [1, 0, 1],
                                [1, 0, -1]), mat)
    b.emitters.envmap(np.ones((8, 16, 3), np.float32))
    b.set_camera(t_persp(ttf.look_at([0, 3, 0.01], [0, 0, 0], [0, 1, 0]),
                         40, 1.0), 8, 8)
    scene = b.build(backend="brute", device="cpu")
    n = 1024
    o = torch.tensor([0.0, 2.0, 0.0]).expand(n, 3)
    d = torch.tensor([0.0, -1.0, 0.0]).expand(n, 3)
    sampler = Sampler(4, torch.arange(n, dtype=torch.int32),
                      torch.zeros(n, dtype=torch.int32))
    L, _ = path_trace(scene, Ray.make(o, d), sampler,
                      PathConfig(max_depth=3, spp=1, remat=False))
    assert abs(float(L[:, 0].mean()) - 0.6) < 0.02, float(L[:, 0].mean())


# ---------------------------------------------------------------------------
# renders through every light, lane by lane
# ---------------------------------------------------------------------------

def test_lights_render_matches_kernel_path_per_lane(scenes, monkeypatch):
    """The scene at 8 x 8 px, 2 spp, depth 3 through the fused kernel
    (#1), against the reference's kernel path (its plain queries, the
    kernel path's frame: tests/torch_kernel_path.py): NEE toward every
    kind, the sphere light's MIS counterweight, the environment on
    escape. Radiance within the sampled-direction tolerances."""
    js, conv, _own = scenes
    kp.kernel_path(monkeypatch, js.geom)
    w = h = 8
    spp = 2
    cfg = JaxPathConfig(max_depth=3, spp=spp, remat=False)

    @jax.jit
    def jax_lanes():
        pid, sid, px, py = kp.lanes(w, h, spp, jnp)
        sampler = JaxSampler(0, pid, sid)
        off = sampler.next_2d()
        uv = jnp.stack([(px + off[:, 0]) / w, (py + off[:, 1]) / h], -1)
        return jax_path_trace(js, js.camera.sample_ray(uv), sampler, cfg)[0]

    L_ref = jax_lanes()
    pid, sid, px, py = kp.lanes(w, h, spp, torch)
    sampler = Sampler(0, pid, sid)
    off = sampler.next_2d()
    uv = torch.stack([(px + off[:, 0]) / w, (py + off[:, 1]) / h], -1)
    L, _ = path_trace(conv, conv.camera.sample_ray(uv), sampler,
                      PathConfig(max_depth=3, spp=spp, remat=False))
    assert float(L.mean()) > 0
    _close_sampled(L, L_ref, share=0.99)
