"""Bench config 2 in the port against the JAX package: the mirror,
dielectric and rough-conductor BSDFs with their microfacet and Fresnel
terms, the analytic sphere, and `cornell_box_specular` end to end.

(a) Elementwise on the same seeded numpy inputs: values within 1e-5
    relative and 1e-6 absolute (both sides run the same float32 formulas;
    XLA may contract or reorder them, and its exp, log, sin, cos, atan2
    and arccos may round differently from PyTorch's in the last bits);
    booleans and ids exactly. Sampled directions and what follows from
    them within 1e-4 relative and 1e-5 absolute: XLA's CPU sin and cos
    differ from PyTorch's by up to 4e-6 (measured), and a microfacet
    normal's sine, sqrt(1 - cos^2), amplifies an ulp of its cosine.
(b) Lane by lane against the reference's TPU kernel path, with the Pallas
    kernel in interpret mode (monkeypatched for this test; nothing in the
    package changes), as tests/test_torch_path.py does for config 1.
(c) The golden gate of bench.py for config 2: 16-pixel blocks, relative
    RMSE <= 0.15, mean in (0.09, 0.21), against the committed 64x64 CPU
    golden.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba_tpu.render.intersect as jax_intersect
from mitsuba_tpu.bsdfs import bsdf_eval as j_eval
from mitsuba_tpu.bsdfs import bsdf_pdf as j_pdf
from mitsuba_tpu.bsdfs import bsdf_sample as j_sample
from mitsuba_tpu.bsdfs.table import MaterialBuilder as JaxMaterialBuilder
from mitsuba_tpu.core import fresnel as j_fresnel
from mitsuba_tpu.core import microfacet as j_mf
from mitsuba_tpu.integrators.path import PathConfig as JaxPathConfig
from mitsuba_tpu.integrators.path import path_trace as jax_path_trace
from mitsuba_tpu.ops import intersect_pallas
from mitsuba_tpu.render.records import Ray as JaxRay
from mitsuba_tpu.render.sampler import Sampler as JaxSampler
from mitsuba_tpu.render.scene import cornell_box_specular as jax_specular
from mitsuba_tpu_torch.bsdfs import MaterialBuilder, bsdf_eval, bsdf_pdf
from mitsuba_tpu_torch.bsdfs import bsdf_sample
from mitsuba_tpu_torch.core import fresnel, microfacet
from mitsuba_tpu_torch.integrators.path import PathConfig, path_trace, render
from mitsuba_tpu_torch.interop import from_jax_scene
from mitsuba_tpu_torch.render import intersect as ri
from mitsuba_tpu_torch.render.records import Intersection, Ray
from mitsuba_tpu_torch.render.sampler import Sampler
from mitsuba_tpu_torch.render.scene import cornell_box_specular

torch.set_num_threads(1)
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "goldens", "bench_cfg2.npz")
RTOL, ATOL = 1e-5, 1e-6
SAMPLED = (1e-4, 1e-5)          # (rtol, atol) of sampled directions


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol,
                               atol=atol)


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _materials():
    """Every kind of config 2 and more, from the same builder calls in both
    packages: GGX and Beckmann conductors, a dielectric with tints, and
    two-sided rows (the dielectric's flip is skipped)."""
    tables = []
    for builder, mf in ((JaxMaterialBuilder(), j_mf),
                        (MaterialBuilder(), microfacet)):
        builder.lambertian((0.725, 0.71, 0.68))
        builder.mirror((0.95, 0.9, 0.85))
        builder.dielectric(int_ior=1.5)
        builder.dielectric(int_ior=1.33, ext_ior=1.1,
                           specular=(0.9, 0.8, 0.7),
                           transmittance=(0.6, 0.7, 0.8))
        builder.rough_conductor(alpha=0.15, dist=mf.GGX)
        builder.rough_conductor(alpha=0.3, cond_eta=(0.15, 0.4, 1.2),
                                cond_k=(3.5, 2.4, 1.8))
        builder.mirror()
        builder.rows[-1]["two_sided"] = True
        builder.dielectric(int_ior=1.5)
        builder.rows[-1]["two_sided"] = True
        builder.rough_conductor(alpha=0.2, dist=mf.GGX)
        builder.rows[-1]["two_sided"] = True
        tables.append(builder.build())
    return tables


def test_material_tables_match():
    jt, pt = _materials()
    assert pt.kinds_present == tuple(jt.kinds_present)
    for name in ("kind", "reflectance", "specular", "transmittance", "eta",
                 "cond_eta", "cond_k", "alpha_u", "alpha_v", "exponent",
                 "dist_type", "tex_id", "two_sided"):
        np.testing.assert_array_equal(getattr(pt, name).numpy(),
                                      np.asarray(getattr(jt, name)), name)


@pytest.mark.parametrize("part", ["eval", "pdf", "sample"])
def test_bsdfs_match(part):
    jt, pt = _materials()
    rng = np.random.default_rng(5)
    n = 4000
    mid = rng.integers(-1, pt.n_materials, n).astype(np.int32)
    wi, wo = _unit(rng, n), _unit(rng, n)
    # a quarter of the pairs near the mirror direction, where the
    # microfacet lobes peak
    near = np.stack([-wi[:, 0], -wi[:, 1], wi[:, 2]], -1) \
        + 0.05 * rng.normal(size=(n, 3)).astype(np.float32)
    near /= np.linalg.norm(near, axis=-1, keepdims=True)
    wo[: n // 4] = near[: n // 4]
    u2 = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    u1 = rng.uniform(0, 1, n).astype(np.float32)
    if part == "eval":
        _close(bsdf_eval(pt, _t(mid), _t(wi), _t(wo)),
               j_eval(jt, jnp.asarray(mid), wi, wo))
    elif part == "pdf":
        _close(bsdf_pdf(pt, _t(mid), _t(wi), _t(wo)),
               j_pdf(jt, jnp.asarray(mid), wi, wo))
    else:
        s = bsdf_sample(pt, _t(mid), _t(wi), _t(u2), _t(u1))
        r = j_sample(jt, jnp.asarray(mid), wi, u2, u1)
        for k in ("wo", "weight", "pdf", "eta"):
            _close(s[k], r[k], *SAMPLED)
        for k in ("delta", "transmission", "valid"):
            np.testing.assert_array_equal(s[k].numpy(), np.asarray(r[k]), k)
        # every kind sampled something, the delta kinds as deltas
        for kind in (1, 2, 3):
            sel = np.asarray(pt.kind[np.clip(mid, 0, None)]) == kind
            assert s["valid"].numpy()[sel].any()
        glass = np.asarray(pt.kind[np.clip(mid, 0, None)]) == 2
        assert s["transmission"].numpy()[glass].any()


@pytest.mark.parametrize("dist", [0, 1])
def test_microfacet_matches(dist):
    rng = np.random.default_rng(7 + dist)
    n = 4000
    alpha = rng.uniform(0.05, 0.8, n).astype(np.float32)
    wi, wo = _unit(rng, n), _unit(rng, n)
    u2 = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    wh, pdf = microfacet.sample_wh(dist, _t(alpha), _t(u2))
    jwh, jpdf = j_mf.sample_wh(dist, jnp.asarray(alpha), u2)
    _close(wh, jwh, *SAMPLED)
    _close(pdf, jpdf, *SAMPLED)
    whn = wi + wo
    whn /= np.linalg.norm(whn, axis=-1, keepdims=True)
    # D through exp: 1e-4 relative
    _close(microfacet.eval_d(dist, _t(alpha), _t(whn)),
           j_mf.eval_d(dist, jnp.asarray(alpha), whn), rtol=1e-4)
    _close(microfacet.smith_g(dist, _t(alpha), _t(wi), _t(wo), _t(whn)),
           j_mf.smith_g(dist, jnp.asarray(alpha), wi, wo, whn))


def test_fresnel_matches():
    rng = np.random.default_rng(11)
    n = 4000
    ci = rng.uniform(-1, 1, n).astype(np.float32)
    ci[:8] = (0.0, -0.0, 1.0, -1.0, 1e-7, -1e-7, 0.5, -0.5)
    eta = rng.uniform(1.01, 2.5, n).astype(np.float32)
    fr, ct = fresnel.fresnel_dielectric_ext(_t(ci), _t(eta))
    jfr, jct = j_fresnel.fresnel_dielectric_ext(jnp.asarray(ci),
                                                jnp.asarray(eta))
    _close(fr, jfr)
    _close(ct, jct)
    ceta = rng.uniform(0.1, 2.0, (n, 3)).astype(np.float32)
    ck = rng.uniform(0.5, 5.0, (n, 3)).astype(np.float32)
    _close(fresnel.fresnel_conductor(_t(ci), _t(ceta), _t(ck)),
           j_fresnel.fresnel_conductor(jnp.asarray(ci), ceta, ck))


@pytest.fixture(scope="module")
def scenes():
    jscene = jax_specular(8, 8)
    return jscene, from_jax_scene(jscene, device="cpu")


def test_scene_builder_matches_reference(scenes):
    """The port's cornell_box_specular builds the reference's tables."""
    jscene, conv = scenes
    own = cornell_box_specular(8, 8, backend="auto", device="cpu")
    assert own.geom.backend == "brute" and own.geom.n_spheres == 1
    for name in ("v0", "e1", "e2", "material_id", "emitter_id", "shape_id",
                 "bvh_min", "bvh_max", "sph_c", "sph_r", "sph_mid",
                 "sph_eid", "sph_sid"):
        np.testing.assert_array_equal(getattr(own.geom, name).numpy(),
                                      getattr(conv.geom, name).numpy(), name)
    for name in ("kind", "specular", "transmittance", "eta", "alpha_u",
                 "dist_type"):
        np.testing.assert_array_equal(getattr(own.materials, name).numpy(),
                                      getattr(conv.materials, name).numpy())
    assert own.materials.kinds_present == conv.materials.kinds_present


def _sphere_rays(n, seed):
    """Rays from inside the box: half aimed at the sphere (grazing ones
    included), a tenth dead, some with a finite maxt or a large mint."""
    rng = np.random.default_rng(seed)
    o = (rng.uniform(0, 1, (n, 3)) * [556, 548, 559]).astype(np.float32)
    d = _unit(rng, n)
    c = np.array([160, 280, 170], np.float32)
    aim = c + rng.normal(size=(n, 3)).astype(np.float32) * 45.0 - o
    aim /= np.linalg.norm(aim, axis=-1, keepdims=True)
    d[: n // 2] = aim[: n // 2]
    mint = np.full(n, 1e-4, np.float32)
    mint[n // 2: n // 2 + n // 20] = 300.0
    maxt = np.full(n, np.inf, np.float32)
    maxt[-n // 5:] = rng.uniform(10, 600, n // 5)
    maxt[-n // 10:] = -1.0
    return o, d, mint, maxt


def test_sphere_queries_match(scenes):
    jscene, scene = scenes
    o, d, mint, maxt = _sphere_rays(4000, 13)
    jray = JaxRay(jnp.asarray(o), jnp.asarray(d), jnp.asarray(mint),
                  jnp.asarray(maxt))
    ray = Ray(_t(o), _t(d), _t(mint), _t(maxt))
    t, i, v = ri._sphere_closest(scene.geom, ray)
    jt_, ji, jv = jax_intersect._sphere_closest(jscene.geom, jray)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    assert 0.2 < v.numpy().mean() < 0.6
    np.testing.assert_array_equal(i.numpy()[v.numpy()],
                                  np.asarray(ji)[np.asarray(jv)])
    _close(t, jt_)
    np.testing.assert_array_equal(
        ri._analytic_any(scene.geom, ray).numpy(),
        np.asarray(jax_intersect._analytic_any(jscene.geom, jray)))


def test_sphere_merge_matches(scenes):
    """The merged record over the triangles' record (the reference's CPU
    triangle query, given to both merges)."""
    jscene, scene = scenes
    o, d, mint, maxt = _sphere_rays(4000, 17)
    jray = JaxRay(jnp.asarray(o), jnp.asarray(d), jnp.asarray(mint),
                  jnp.asarray(maxt))
    jits = jax_intersect._ray_intersect_tri(jscene.geom, jray)
    its = Intersection(**{f: _t(getattr(jits, f))
                          for f in Intersection.__dataclass_fields__})
    got = ri._merge_analytic(scene.geom, Ray(_t(o), _t(d), _t(mint),
                                             _t(maxt)), its)
    ref = jax_intersect._merge_analytic(jscene.geom, jray, jits)
    sphere = got.prim_id.numpy() == scene.geom.n_tris
    assert 0.1 < sphere.mean() < 0.6
    for f in ("valid", "prim_id", "shape_id", "material_id", "emitter_id"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), f)
    for f in ("t", "p", "geo_n", "sh_n", "dp_du"):
        _close(getattr(got, f), getattr(ref, f))
    # uv and wi through atan2 and arccos, and a frame from them
    for f in ("uv", "wi"):
        _close(getattr(got, f), getattr(ref, f), *SAMPLED)


def _lanes(w, h, spp, xp):
    lane = xp.arange(w * h * spp)
    pixel_id, sample_id = lane // spp, lane % spp
    return pixel_id, sample_id, (pixel_id % w), (pixel_id // w)


def test_config2_matches_kernel_path_per_lane(monkeypatch):
    """Config 2 through the fused kernel (#1) with the sphere merged after
    it, lane by lane against the reference's kernel path."""
    w = h = 16
    spp, depth = 2, 3
    jscene = jax_specular(w, h, backend="auto")
    monkeypatch.setattr(jax_intersect, "_use_pallas", lambda: True)
    monkeypatch.setattr(
        intersect_pallas, "closest_hit_shaded_and_any",
        functools.partial(intersect_pallas.closest_hit_shaded_and_any,
                          interpret=True))
    jcfg = JaxPathConfig(max_depth=depth, spp=spp, remat=False)

    @jax.jit
    def jax_lanes(scene):
        pid, sid, px, py = _lanes(w, h, spp, jnp)
        sampler = JaxSampler(0, pid, sid.astype(jnp.int32))
        off = sampler.next_2d()
        uv = jnp.stack([(px.astype(jnp.float32) + off[:, 0]) / w,
                        (py.astype(jnp.float32) + off[:, 1]) / h], -1)
        L, aux = jax_path_trace(scene, scene.camera.sample_ray(uv), sampler,
                                jcfg)
        return L, aux["rays_traced"]

    L_ref, rays_ref = jax_lanes(jscene)
    L_ref = np.asarray(L_ref)

    scene = from_jax_scene(jscene, device="cpu")
    pid, sid, px, py = _lanes(w, h, spp, torch)
    sampler = Sampler(0, pid, sid)
    off = sampler.next_2d()
    uv = torch.stack([(px.float() + off[:, 0]) / w,
                      (py.float() + off[:, 1]) / h], -1)
    L, aux = path_trace(scene, scene.camera.sample_ray(uv), sampler,
                        PathConfig(max_depth=depth, spp=spp))
    L = L.numpy()

    # >= 99% of lanes within 1e-4 relative, as for config 1: a ray that
    # grazes an edge may pick the neighbouring triangle and diverge
    close = np.isclose(L, L_ref, rtol=1e-4, atol=1e-6).all(axis=-1)
    assert close.mean() >= 0.99, close.mean()
    assert np.isfinite(L).all()
    assert abs(L.mean() - L_ref.mean()) <= 1e-3 * L_ref.mean()
    assert int(aux["rays_traced"]) == int(rays_ref)


def test_config2_passes_bench_golden_gate():
    ref = np.load(GOLDEN)["mean"]
    img, _ = render(cornell_box_specular(64, 64, backend="auto",
                                         device="cpu"),
                    PathConfig(max_depth=5, spp=16), seed=0)
    img = img.numpy()
    assert img.shape == ref.shape and np.isfinite(img).all()

    def blocks(a, b=16):
        hh, ww, c = a.shape
        return a.reshape(hh // b, b, ww // b, b, c).mean(axis=(1, 3))

    rb, ib = blocks(ref), blocks(img)
    rel = np.sqrt(np.mean((ib - rb) ** 2)) / rb.mean()
    assert rel <= 0.15, rel                  # bench.py, config 2
    assert 0.09 < img.mean() < 0.21, img.mean()
