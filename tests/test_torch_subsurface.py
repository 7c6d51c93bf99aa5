"""The port's subsurface scattering against the JAX package.

- The profiles (dipole_rd, multipole_rd, adipole_rd) on the same
  distances: rtol 1e-5 (the libraries' exp and sqrt may differ by an ulp).
- The stacked tables of the slab of tests/golden_scenes.py:144 under each
  profile, built by each package's SceneBuilder: bit for bit, the sampled
  points (numpy default_rng(123 + entry)) included.
- scene_ss_lo on the same points, irradiance and hits, per profile: within
  1e-5 of the largest lane (each lane sums 256-point chunks in the
  reference's order; a chunk's sum is reduced in another order);
  scene_ss_lo_hier within 1e-6 of the reference's and within 2% of the
  dense gather (its far clusters stand in for their points).
- compute_irradiance's direct NEE (on the slab) and _indirect_irradiance
  (on Cornell box points, sample_irradiance_points bit for bit), point by
  point against the reference's on its kernel path (the kernels' plain
  references, tests/torch_kernel_path.py): within 1e-5 of the largest.
- The slab's lanes at 16x16x4, depth 4 (the cache at seed 99, the lanes
  at seed 777, as tests/golden_scenes.py:203 renders it): >= 99% of lanes
  within rtol 1e-4, the mean within 1e-3 of it.
- The loader's <subsurface> forms against the reference loader's tables,
  bit for bit; render fills the cache at its own seed; a subsurface scene
  that requires grad raises naming ROADMAP A.14.
"""
import dataclasses
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from mitsuba_tpu.core import track as jtrack
from mitsuba_tpu.core import transform as jtf
from mitsuba_tpu.integrators.path import PathConfig as JaxPathConfig
from mitsuba_tpu.integrators.path import path_trace as jax_path_trace
from mitsuba_tpu.io import xml as jxml
from mitsuba_tpu.render import mesh as jmesh
from mitsuba_tpu.render.camera import make_perspective as jpersp
from mitsuba_tpu.render.sampler import Sampler as JaxSampler
from mitsuba_tpu.render.scene import SceneBuilder as JaxSceneBuilder
from mitsuba_tpu.render.scene import cornell_box as jax_cornell_box
from mitsuba_tpu.subsurface import dipole as jd
from mitsuba_tpu_torch.integrators.path import (
    PathConfig, camera_wavefront, path_trace, render,
)
from mitsuba_tpu_torch.interop import from_jax_scene
from mitsuba_tpu_torch.io import xml as txml
from mitsuba_tpu_torch.subsurface import dipole as td
from tests import torch_sss_cases as sc
from tests.test_torch_hetero import assert_lanes_match
from tests.torch_kernel_path import kernel_path, lanes

torch.set_num_threads(1)
JMODS = SimpleNamespace(SceneBuilder=JaxSceneBuilder, mesh=jmesh,
                        look_at=jtf.look_at, track=jtrack,
                        make_perspective=jpersp)
PROFILES = sorted(sc.PROFILES)
W = H = 16
SPP = 4
K = 64           # points per entry of the small slabs


def _t(x):
    return torch.from_numpy(np.array(x))


def _params():
    return (jd.make_dipole(sc.SLAB["sigma_s"], sc.SLAB["sigma_a"], g=0.1,
                           eta=1.3),
            td.make_dipole(sc.SLAB["sigma_s"], sc.SLAB["sigma_a"], g=0.1,
                           eta=1.3))


def test_dipole_params_equal_reference():
    jp, tp = _params()
    for f in dataclasses.fields(tp):
        np.testing.assert_array_equal(getattr(tp, f.name).numpy(),
                                      np.asarray(getattr(jp, f.name)),
                                      err_msg=f.name)


def test_profiles_match_reference():
    jp, tp = _params()
    rng = np.random.default_rng(0)
    r = rng.exponential(0.5, 4000).astype(np.float32)
    r[:10] = 0.0
    close = dict(rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(td.dipole_rd(tp, _t(r)).numpy(),
                               np.asarray(jd.dipole_rd(jp, r)), **close)
    np.testing.assert_allclose(
        td.multipole_rd(tp, _t(r), 0.3, 2).numpy(),
        np.asarray(jd.multipole_rd(jp, r, 0.3, 2)), **close)
    rv = rng.normal(size=(4000, 3)).astype(np.float32)
    ad = np.asarray([0.6, 0.0, 0.8], np.float32)
    np.testing.assert_allclose(
        td.adipole_rd(tp, _t(rv), _t(ad), 3.0).numpy(),
        np.asarray(jd.adipole_rd(jp, rv, ad, 3.0)), **close)


@pytest.fixture(scope="module", params=PROFILES)
def slabs(request):
    """Each package's slab under one profile, with the same random
    irradiance in both caches."""
    jscene = sc.slab_scene(JMODS, W, request.param, n_points=K)
    port = sc.slab_scene(sc.port_modules(), W, request.param, n_points=K,
                         device="cpu")
    irr = np.random.default_rng(1).exponential(
        2.0, jscene.subsurface.points.shape).astype(np.float32)
    jss = dataclasses.replace(jscene.subsurface, irradiance=irr)
    tss = dataclasses.replace(port.subsurface, irradiance=_t(irr))
    return request.param, jscene, port, jss, tss


def test_tables_and_points_equal_reference(slabs):
    profile, jscene, port, _, _ = slabs
    conv = from_jax_scene(jscene, device="cpu").subsurface
    for f in dataclasses.fields(conv):
        a, b = getattr(port.subsurface, f.name), getattr(conv, f.name)
        if f.name == "irradiance":
            assert a is None and b is None
            continue
        assert a.dtype == b.dtype and torch.equal(a, b), (profile, f.name)
    assert port.subsurface.zri.shape[1] == (7 if profile == "multipole"
                                            else 1)


def _hits(jss, n=600, seed=2):
    """Points on and around the slab's top face, and |cos wo|."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.2, 1.2, (n, 3)).astype(np.float32)
    x[: n // 2, 1] = 0.25
    return x, rng.uniform(0.0, 1.0, n).astype(np.float32)


def test_scene_ss_lo_matches_reference(slabs):
    profile, _, _, jss, tss = slabs
    x, wc = _hits(jss)
    want = np.asarray(jd.scene_ss_lo(jss, 0, x, wc))
    got = td.scene_ss_lo(tss, 0, _t(x), _t(wc), block=128).numpy()
    assert want.max() > 0, profile
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * float(want.max()))


def test_hierarchical_gather_matches(slabs):
    profile, _, _, jss, tss = slabs
    if profile == "adipole":
        with pytest.raises(ValueError):
            td.scene_ss_lo_hier(tss, 0, np.zeros((1, 3)), np.ones(1))
        return
    x, wc = _hits(jss, 24)
    got = td.scene_ss_lo_hier(tss, 0, x, wc)
    np.testing.assert_allclose(got, jd.scene_ss_lo_hier(jss, 0, x, wc),
                               rtol=1e-6, atol=1e-12)
    dense = td.scene_ss_lo(tss, 0, _t(x), _t(wc)).numpy().astype(np.float64)
    np.testing.assert_allclose(got, dense, rtol=0,
                               atol=0.02 * float(dense.max()))


def test_direct_irradiance_matches_reference(monkeypatch):
    jscene = sc.slab_scene(JMODS, W, n_points=K)
    kernel_path(monkeypatch, jscene.geom)
    ss = jscene.subsurface
    pts, nrm = ss.points.reshape(-1, 3), ss.normals.reshape(-1, 3)
    want = np.asarray(jax.jit(lambda s, p, n: jd.compute_irradiance(
        s, p, n, n_samples=3, seed=5, indirect_depth=0))(jscene, pts, nrm))
    port = from_jax_scene(jscene, device="cpu")
    got = td.compute_irradiance(port, _t(pts), _t(nrm), n_samples=3, seed=5,
                                indirect_depth=0).numpy()
    assert want.max() > 0
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * float(want.max()))


def test_indirect_irradiance_matches_reference(monkeypatch):
    """On points of the Cornell box (sample_irradiance_points, bit for
    bit): the slab's floor faces away from the light (one-sided), so
    light reaches its cache only directly."""
    jscene = jax_cornell_box(W, H)
    kernel_path(monkeypatch, jscene.geom)
    port = from_jax_scene(jscene, device="cpu")
    jpts, jnrm, jarea = jd.sample_irradiance_points(jscene.geom, K, seed=4)
    pts, nrm, area = td.sample_irradiance_points(port.geom, K, seed=4)
    for a, b in ((pts, jpts), (nrm, jnrm), (area, jarea)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    want = np.asarray(jax.jit(
        lambda s, p, n: jd._indirect_irradiance(s, p, n, 2, 2, 11))(
        jscene, jpts, jnrm))
    got = td._indirect_irradiance(port, pts, nrm, 2, 2, 11).numpy()
    assert want.max() > 0
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * float(want.max()))


@pytest.fixture(scope="module")
def slab_lanes():
    """The reference's slab lanes on its kernel path: the cache filled at
    seed 99, then 16x16x4 lanes at seed 777, depth 4."""
    jscene = sc.slab_scene(JMODS, W, n_points=K)
    cfg = JaxPathConfig(max_depth=sc.SLAB_DEPTH, spp=SPP, remat=False)
    with pytest.MonkeyPatch.context() as mp:
        kernel_path(mp, jscene.geom)

        @jax.jit
        def run(scene):
            import jax.numpy as jnp

            scene = dataclasses.replace(scene, subsurface=(
                jd.prepare_scene_irradiance(scene, seed=99)))
            pid, sid, px, py = lanes(W, H, SPP, jnp)
            sampler = JaxSampler(777, pid, sid)
            off = sampler.next_2d()
            uv = jnp.stack([(px + off[:, 0]) / W, (py + off[:, 1]) / H], -1)
            L, _ = jax_path_trace(scene, scene.camera.sample_ray(uv),
                                  sampler, cfg)
            return L, scene.subsurface.irradiance

        L, irr = run(jscene)
    return jscene, np.asarray(L), np.asarray(irr)


def test_slab_cache_matches_reference(slab_lanes):
    jscene, _, irr_ref = slab_lanes
    port = from_jax_scene(jscene, device="cpu")
    irr = td.prepare_scene_irradiance(port, seed=99).irradiance.numpy()
    np.testing.assert_allclose(irr, irr_ref, rtol=0,
                               atol=1e-5 * float(irr_ref.max()))


def test_slab_lanes_match_reference(slab_lanes):
    jscene, L_ref, _ = slab_lanes
    port = from_jax_scene(jscene, device="cpu")
    port = dataclasses.replace(port, subsurface=td.prepare_scene_irradiance(
        port, seed=99))
    cfg = PathConfig(max_depth=sc.SLAB_DEPTH, spp=SPP)
    ray, sampler, _ = camera_wavefront(port, cfg, seed=777, morton=False)
    L, _ = path_trace(port, ray, sampler, cfg)
    assert_lanes_match(L.numpy(), L_ref)
    # the gather adds light: without the entries the slab is darker
    plain, _ = path_trace(dataclasses.replace(port, subsurface=None),
                          *camera_wavefront(port, cfg, seed=777,
                                            morton=False)[:2], cfg)
    assert float(L.mean()) > float(plain.mean())


def test_render_fills_the_cache_at_its_seed():
    scene = sc.slab_scene(sc.port_modules(), 8, n_points=K, device="cpu")
    cfg = PathConfig(max_depth=3, spp=2)
    img, _ = render(scene, cfg, seed=3)
    filled = dataclasses.replace(scene, subsurface=td.prepare_scene_irradiance(
        scene, seed=3))
    assert torch.equal(img, render(filled, cfg, seed=3)[0])
    assert scene.subsurface.irradiance is None


def test_subsurface_gradient_refused():
    scene = sc.slab_scene(sc.port_modules(), 4, n_points=K, device="cpu")
    refl = scene.materials.reflectance.clone().requires_grad_(True)
    grad_scene = dataclasses.replace(scene, materials=dataclasses.replace(
        scene.materials, reflectance=refl))
    with pytest.raises(NotImplementedError, match="A.14"):
        render(grad_scene, PathConfig(max_depth=2, spp=1))


FORMS = sorted(sc.SLAB_SUBSURFACE)


@pytest.fixture(scope="module")
def slab_files(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("sss_xml"))
    return {form: sc.write_slab_xml(d, form) for form in FORMS}


@pytest.mark.parametrize("form", FORMS)
def test_loader_forms_equal_reference(slab_files, form):
    params = dict(depth=3, spp=2, width=8, height=8, irr=K)
    jscene, jcfg = jxml.load_scene(slab_files[form], params=params)
    port, cfg = txml.load_scene(slab_files[form], params=params,
                                device="cpu")
    conv = from_jax_scene(jscene, device="cpu")
    assert cfg == jcfg
    if form == "marschner":
        # the reference's marschner stub adds nothing (xml_shapes.py:286)
        assert port.subsurface is None and conv.subsurface is None
        return
    for f in dataclasses.fields(conv.subsurface):
        a, b = getattr(port.subsurface, f.name), getattr(conv.subsurface,
                                                         f.name)
        assert (a is None and b is None) or torch.equal(a, b), (form, f.name)
    assert torch.equal(port.materials.reflectance, conv.materials.reflectance)
    assert torch.equal(port.geom.v0, conv.geom.v0)
    # the entry binds to a fresh copy of the slab's BSDF
    assert int((port.subsurface.mat_ss >= 0).sum()) == 1
