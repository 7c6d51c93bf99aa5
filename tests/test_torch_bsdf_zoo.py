"""The port's materials against the JAX package: the Ward, rough-glass,
diffuse-transmitter, Wiscombe, Hanrahan-Krueger, composite and mask
BSDFs, the Phong microfacet distribution, Fresnel and refraction, the
"bsdf_zoo" scene of tests/torch_bsdf_cases.py, and the shading-frame
decision of ROADMAP C.

(a) Lane by lane on the same seeded numpy inputs: both hemispheres,
    grazing angles, pairs near the mirror direction, total internal
    reflection in rough glass. Values within 1e-5 relative and 1e-6
    absolute, booleans exactly. A sampled direction and what follows from
    it: 999 lanes in 1,000 within 1e-4 relative and 1e-5 absolute, as
    tests/test_torch_specular.py holds them, and every lane within 1e-3
    relative and 1e-4 absolute (XLA's CPU sin, cos, atan2, log and pow
    round differently from PyTorch's in the last bits; a microfacet
    normal's sine, sqrt(1 - cos^2), and the transmission Jacobian near
    its pole amplify that: at most 2 lanes in 4,000 of a model exceed
    1e-4, by at most 1.1e-4).
(b) The zoo's tables, built by both packages' SceneBuilders and loaded
    from the same scene file by both XML loaders, equal through
    interop.py; its first bounces lane by lane against the reference's
    kernel path (the Pallas kernel in interpret mode, monkeypatched for
    this test as tests/test_torch_specular.py does).
(c) The shading frame (ROADMAP C, decided): a brute triangle takes
    Frame.from_normal of its shading normal, a bvh one the uv tangent, as
    the reference's kernel and CPU paths build them. So an anisotropic
    Ward quad renders differently on the two backends, while a lambertian
    quad agrees within its Monte Carlo error.
"""
import os
import sys
import zlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba_tpu.render.intersect as jax_intersect
from mitsuba_tpu.bsdfs import bsdf_eval as j_eval
from mitsuba_tpu.bsdfs import bsdf_pdf as j_pdf
from mitsuba_tpu.bsdfs import bsdf_sample as j_sample
from mitsuba_tpu.bsdfs import models as j_md
from mitsuba_tpu.bsdfs.table import MaterialBuilder as JaxMaterialBuilder
from mitsuba_tpu.core import fresnel as j_fresnel
from mitsuba_tpu.core import math as j_m
from mitsuba_tpu.core import microfacet as j_mf
from mitsuba_tpu.core import transform as j_tf
from mitsuba_tpu.io import xml as jxml
from mitsuba_tpu.ops import intersect_pallas
from mitsuba_tpu.render import mesh as j_mesh
from mitsuba_tpu.render.camera import make_perspective as j_perspective
from mitsuba_tpu.render.records import Ray as JaxRay
from mitsuba_tpu.render.sampler import Sampler as JaxSampler
from mitsuba_tpu.render.scene import SceneBuilder as JaxSceneBuilder
from mitsuba_tpu_torch.bsdfs import MaterialBuilder, bsdf_eval, bsdf_pdf
from mitsuba_tpu_torch.bsdfs import bsdf_sample
from mitsuba_tpu_torch.bsdfs import models as md
from mitsuba_tpu_torch.core import fresnel, microfacet
from mitsuba_tpu_torch.core import math as m
from mitsuba_tpu_torch.integrators.path import PathConfig, path_trace
from mitsuba_tpu_torch.interop import from_jax_scene
from mitsuba_tpu_torch.io import xml as txml
from mitsuba_tpu_torch.render import intersect as ri
from mitsuba_tpu_torch.render.sampler import Sampler

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_bsdf_cases as bc  # noqa: E402

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-6
SAMPLED = (1e-4, 1e-5)          # (rtol, atol) of sampled directions
JAX_MODS = SimpleNamespace(SceneBuilder=JaxSceneBuilder, mesh=j_mesh,
                           mf=j_mf, look_at=j_tf.look_at,
                           make_perspective=j_perspective)
MATERIAL_COLUMNS = ("kind", "reflectance", "specular", "transmittance",
                    "eta", "cond_eta", "cond_k", "alpha_u", "alpha_v",
                    "exponent", "dist_type", "tex_id", "two_sided",
                    "opacity", "child_ids", "child_weights")


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol,
                               atol=atol)


def _close_sampled(a, b, share=0.999):
    a, b = a.numpy(), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4)
    ok = np.isclose(a, b, rtol=SAMPLED[0], atol=SAMPLED[1])
    ok = ok.reshape(len(ok), -1).all(-1)
    assert ok.mean() >= share, ok.mean()


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _directions(rng, n):
    """wi, wo over both hemispheres: a quarter of the pairs near the
    mirror direction, a quarter near the refracted one of eta 1.5 (or
    the mirror below), an eighth grazing (|cos| < 1e-3)."""
    wi, wo = _unit(rng, n), _unit(rng, n)
    q = n // 4
    jitter = 0.05 * rng.normal(size=(n, 3)).astype(np.float32)
    near = np.stack([-wi[:, 0], -wi[:, 1], wi[:, 2]], -1) + jitter
    wo[:q] = near[:q]
    refr = np.stack([-wi[:, 0] / 1.5, -wi[:, 1] / 1.5, -wi[:, 2]], -1) \
        + jitter
    wo[q:2 * q] = refr[q:2 * q]
    g = slice(2 * q, 2 * q + n // 8)
    wi[g, 2] = rng.uniform(-1e-3, 1e-3, n // 8).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    return wi, wo


def _tables(extra=None):
    """The zoo's rows in both packages, plus `extra(builder, mf)` rows."""
    out = []
    for mb, mf in ((JaxMaterialBuilder(), j_mf), (MaterialBuilder(),
                                                  microfacet)):
        ids = bc.zoo_materials(mb, mf)
        if extra is not None:
            ids.update(extra(mb, mf))
        out.append((mb.build(), ids))
    return out


def _more_rows(mb, mf):
    """Options the zoo's scene leaves out: twosided rough glass (never
    flipped), a mask over Ward, a three-lobe composite, Phong-distribution
    glass at a low exponent, HK without its diffuse term, difftrans
    twosided."""
    ids = {"glass_twosided": mb.rough_glass(alpha=0.25, dist=mf.BECKMANN)}
    mb.rows[-1]["two_sided"] = True
    ids["ward_mask"] = mb.ward(alpha_u=0.05, alpha_v=0.4)
    mb.rows[-1]["opacity"] = 0.3
    a = mb.phong(diffuse=(0.3, 0.2, 0.1), specular=(0.3, 0.3, 0.3))
    b = mb.ward(alpha_u=0.3, alpha_v=0.1)
    c = mb.diff_trans((0.3, 0.6, 0.2))
    ids["composite3"] = mb.composite([a, b, c], [0.2, 0.3, 0.4])
    ids["glass_phong_low"] = mb.rough_glass(alpha=4.0, int_ior=1.2,
                                            dist=mf.PHONG)
    ids["hk_nodiffuse"] = mb.hanrahan_krueger(g=0.5, use_diffuse=False)
    ids["difftrans_twosided"] = mb.diff_trans()
    mb.rows[-1]["two_sided"] = True
    return ids


def test_material_tables_match():
    (jt, jids), (pt, pids) = _tables(_more_rows)
    assert jids == pids
    assert pt.kinds_present == tuple(jt.kinds_present)
    assert pt.has_composite == jt.has_composite is True
    assert pt.has_mask
    for name in MATERIAL_COLUMNS:
        np.testing.assert_array_equal(getattr(pt, name).numpy(),
                                      np.asarray(getattr(jt, name)), name)


# (kind name in the zoo, its model's prefix in both packages)
MODELS = {"ward": "ward", "glass_beckmann": "roughglass",
          "glass_ggx": "roughglass", "glass_phong": "roughglass",
          "metal_phong": "rough_conductor", "difftrans": "difftrans",
          "wiscombe": "wiscombe", "hk": "hk"}


@pytest.mark.parametrize("part", ["eval", "pdf", "sample"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_models_match(name, part):
    (jt, ids), (pt, _) = _tables()
    rng = np.random.default_rng(zlib.crc32(f"{name} {part}".encode()))
    n = 4000
    mid = np.full(n, ids[name], np.int32)
    p = dict(pt.gather(_t(mid)),
             _dist_static=int(pt.dist_type[ids[name]]))
    jp = dict(jt.gather(jnp.asarray(mid)), _dist_static=p["_dist_static"])
    wi, wo = _directions(rng, n)
    fn = getattr(md, f"{MODELS[name]}_{part}")
    jfn = getattr(j_md, f"{MODELS[name]}_{part}")
    if part != "sample":
        got, ref = fn(p, _t(wi), _t(wo)), np.asarray(jfn(jp, wi, wo))
        _close(got, ref)
        assert (ref != 0).any(), "no lane with a nonzero value"
        return
    u2 = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    u1 = rng.uniform(0, 1, n).astype(np.float32)
    s, r = fn(p, _t(wi), _t(u2), _t(u1)), jfn(jp, wi, u2, u1)
    for k in ("delta", "transmission", "valid"):
        np.testing.assert_array_equal(s[k].numpy(), np.asarray(r[k]), k)
    for k in ("wo", "weight", "pdf", "eta"):
        _close_sampled(s[k], r[k])
    assert s["valid"].numpy().mean() > 0.2
    if MODELS[name] in ("roughglass", "difftrans"):
        assert s["transmission"].numpy().any()


def test_rough_glass_total_internal_reflection():
    """Inside the glass at grazing incidence most refractions are total:
    the lanes reflect instead, the same in both packages, and eval and pdf
    agree there."""
    tables = []
    for mb, mf in ((JaxMaterialBuilder(), j_mf),
                   (MaterialBuilder(), microfacet)):
        mb.rough_glass(alpha=0.2, dist=mf.BECKMANN)
        tables.append(mb.build())
    jt, pt = tables
    n = 4000
    rng = np.random.default_rng(3)
    ct = -rng.uniform(0.0, 0.95, n).astype(np.float32)   # inside
    phi = rng.uniform(0, 2 * np.pi, n).astype(np.float32)
    st = np.sqrt(1 - ct * ct)
    wi = np.stack([st * np.cos(phi), st * np.sin(phi), ct], -1)
    wi = wi.astype(np.float32)
    mid = np.zeros(n, np.int32)
    u2 = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    u1 = np.full(n, 0.999, np.float32)              # pick refraction
    s = bsdf_sample(pt, _t(mid), _t(wi), _t(u2), _t(u1))
    r = j_sample(jt, jnp.asarray(mid), wi, u2, u1)
    for k in ("valid", "transmission", "delta"):
        np.testing.assert_array_equal(s[k].numpy(), np.asarray(r[k]), k)
    _, tir = m.refract(_t(wi), _t(np.tile([[0, 0, 1.0]], (n, 1)).astype(
        np.float32)), 1.0 / 1.5)
    tir = tir.numpy()
    assert tir.mean() > 0.3          # past the macro normal's critical angle
    # there, most micronormals reflect totally: u1 = 0.999 picks the
    # reflection where F > 0.999
    tr, ok = s["transmission"].numpy(), s["valid"].numpy()
    assert tr[tir].mean() < 0.5 * tr[~tir].mean()
    assert (ok & ~tr)[tir].mean() > 0.3
    wo = _unit(rng, n)
    _close(bsdf_eval(pt, _t(mid), _t(wi), _t(wo)),
           j_eval(jt, jnp.asarray(mid), wi, wo))
    _close(bsdf_pdf(pt, _t(mid), _t(wi), _t(wo)),
           j_pdf(jt, jnp.asarray(mid), wi, wo))


@pytest.mark.parametrize("part", ["eval", "pdf", "sample"])
def test_dispatch_matches(part):
    """Every row of the zoo and of _more_rows at once: composite lobes,
    masks, twosided Ward and difftrans flipped, rough glass unflipped."""
    (jt, _), (pt, _) = _tables(_more_rows)
    rng = np.random.default_rng(29)
    n = 4000
    mid = rng.integers(-1, pt.n_materials, n).astype(np.int32)
    wi, wo = _directions(rng, n)
    albedo = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    if part == "eval":
        _close(bsdf_eval(pt, _t(mid), _t(wi), _t(wo), albedo=_t(albedo)),
               j_eval(jt, jnp.asarray(mid), wi, wo, albedo=albedo))
    elif part == "pdf":
        _close(bsdf_pdf(pt, _t(mid), _t(wi), _t(wo)),
               j_pdf(jt, jnp.asarray(mid), wi, wo))
    else:
        u2 = rng.uniform(0, 1, (n, 2)).astype(np.float32)
        u1 = rng.uniform(0, 1, n).astype(np.float32)
        s = bsdf_sample(pt, _t(mid), _t(wi), _t(u2), _t(u1),
                        albedo=_t(albedo))
        r = j_sample(jt, jnp.asarray(mid), wi, u2, u1, albedo=albedo)
        for k in ("delta", "transmission", "valid"):
            np.testing.assert_array_equal(s[k].numpy(), np.asarray(r[k]), k)
        for k in ("wo", "weight", "pdf", "eta"):
            _close_sampled(s[k], r[k])
        kind = pt.kind.numpy()[np.clip(mid, 0, None)]
        for k in range(11):
            if k in (1, 2):                 # no mirror or dielectric rows
                continue
            assert s["valid"].numpy()[kind == k].any(), k


@pytest.mark.parametrize("dist", [0, 1, 2])
def test_microfacet_matches(dist):
    """Each distribution, Phong's exponent (2-200) in place of alpha."""
    rng = np.random.default_rng(41 + dist)
    n = 4000
    alpha = (rng.uniform(2.0, 200.0, n) if dist == 2
             else rng.uniform(0.05, 0.8, n)).astype(np.float32)
    wi, wo = _unit(rng, n), _unit(rng, n)
    u2 = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    wh, pdf = microfacet.sample_wh(dist, _t(alpha), _t(u2))
    jwh, jpdf = j_mf.sample_wh(dist, jnp.asarray(alpha), u2)
    _close_sampled(wh, jwh)
    _close_sampled(pdf, jpdf)
    whn = (wi + wo) / np.linalg.norm(wi + wo, axis=-1, keepdims=True)
    _close(microfacet.eval_d(dist, _t(alpha), _t(whn)),
           j_mf.eval_d(dist, jnp.asarray(alpha), whn), rtol=1e-4)
    _close(microfacet.smith_g(dist, _t(alpha), _t(wi), _t(wo), _t(whn)),
           j_mf.smith_g(dist, jnp.asarray(alpha), wi, wo, whn))
    rough = rng.uniform(0.05, 1.0, n).astype(np.float32)
    _close(microfacet.roughness_to_alpha(dist, _t(rough)),
           j_mf.roughness_to_alpha(dist, jnp.asarray(rough)))


def test_fresnel_refract_and_rcp_match():
    rng = np.random.default_rng(43)
    n = 4000
    ci = rng.uniform(-1, 1, n).astype(np.float32)
    ci[:6] = (0.0, -0.0, 1.0, -1.0, 1e-7, -1e-7)
    eta_int = rng.uniform(1.01, 2.5, n).astype(np.float32)
    eta_ext = rng.uniform(1.0, 1.2, n).astype(np.float32)
    _close(fresnel.fresnel(_t(ci), _t(eta_ext), _t(eta_int)),
           j_fresnel.fresnel(jnp.asarray(ci), eta_ext, eta_int))
    wi, nrm = _unit(rng, n), _unit(rng, n)
    rel = rng.uniform(0.4, 2.5, n).astype(np.float32)
    wt, tir = m.refract(_t(wi), _t(nrm), _t(rel))
    jwt, jtir = j_m.refract(wi, nrm, rel)
    np.testing.assert_array_equal(tir.numpy(), np.asarray(jtir))
    assert 0.1 < tir.numpy().mean() < 0.9
    _close(wt, jwt)
    x = rng.normal(size=n).astype(np.float32) * 10.0 ** rng.integers(
        -30, 30, n)
    x[:3] = (0.0, -0.0, 1e-30)
    _close(m.safe_rcp(_t(x)), j_m.safe_rcp(jnp.asarray(x)))


@pytest.fixture(scope="module")
def zoo():
    jscene = bc.zoo_scene(JAX_MODS, 8)
    return jscene, from_jax_scene(jscene, device="cpu")


def test_zoo_tables_equal_reference(zoo):
    """The zoo built by the port's SceneBuilder is the reference's."""
    _, conv = zoo
    own = bc.zoo_scene(bc.port_modules(), 8, device="cpu")
    for name in MATERIAL_COLUMNS:
        np.testing.assert_array_equal(getattr(own.materials, name).numpy(),
                                      getattr(conv.materials, name).numpy(),
                                      name)
    for name in ("kinds_present", "has_composite", "has_mask"):
        assert getattr(own.materials, name) == getattr(conv.materials, name)
    for name in ("v0", "e1", "e2", "n0", "material_id", "emitter_id",
                 "sph_c", "sph_r", "sph_mid", "bvh_min", "bvh_max"):
        np.testing.assert_array_equal(getattr(own.geom, name).numpy(),
                                      getattr(conv.geom, name).numpy(), name)
    np.testing.assert_array_equal(own.camera.to_world.numpy(),
                                  conv.camera.to_world.numpy())


def test_zoo_xml_equals_reference():
    """Every new plugin name and property spelling, through both XML
    loaders, gives the same material table."""
    scene, cfg = txml.load_scene_string(bc.ZOO_XML, device="cpu")
    jscene, jcfg = jxml.load_scene_string(bc.ZOO_XML)
    conv = from_jax_scene(jscene, device="cpu")
    for name in MATERIAL_COLUMNS:
        np.testing.assert_array_equal(getattr(scene.materials, name).numpy(),
                                      getattr(conv.materials, name).numpy(),
                                      name)
    assert scene.materials.kinds_present == conv.materials.kinds_present
    assert scene.materials.has_composite and scene.materials.has_mask
    assert set(scene.materials.kind.tolist()) == {0, 3, 4, 5, 6, 7, 8, 9, 10}
    for key in ("pattern", "rfilter", "sampleCount", "maxDepth"):
        assert cfg[key] == jcfg[key], key


def _lanes(w, h, spp, xp):
    lane = xp.arange(w * h * spp)
    pixel_id, sample_id = lane // spp, lane % spp
    return pixel_id, sample_id, (pixel_id % w), (pixel_id // w)


def test_zoo_matches_kernel_path_per_lane(zoo, monkeypatch):
    """The zoo's first bounce at 8x8 px, 2 spp through the fused kernel
    (#1), the spheres merged after it: each lane's hit, its local wi and
    the BSDF sample of its material (every kind reached), against the
    reference's kernel path. That path's kernel is
    its plain reference here, the CPU queries that
    tests/test_pallas_intersect.py holds it to (its interpret mode takes
    ~50 s to compile); the frame is the kernel path's."""
    jscene, scene = zoo
    w = h = 8
    spp = 2
    pallas = {"on": True}

    def plain_shaded_and_any(table, o, d, mint, maxt, so, sd, smint, smaxt,
                             interpret=False):
        pallas["on"] = False
        its = jax_intersect._ray_intersect_tri(
            jscene.geom, JaxRay(o, d, mint, maxt))
        occ = jax_intersect._ray_test_tri(
            jscene.geom, JaxRay(so, sd, smint, smaxt))
        pallas["on"] = True
        return dict(t=its.t, prim=its.prim_id, valid=its.valid,
                    geo_n=its.geo_n, sh_n=its.sh_n, uv=its.uv,
                    material_id=its.material_id,
                    emitter_id=its.emitter_id, shape_id=its.shape_id), occ

    monkeypatch.setattr(jax_intersect, "_use_pallas", lambda: pallas["on"])
    monkeypatch.setattr(intersect_pallas, "closest_hit_shaded_and_any",
                        plain_shaded_and_any)

    def camera(xp, sampler_cls, scene_):
        pid, sid, px, py = _lanes(w, h, spp, xp)
        if xp is jnp:
            sid = sid.astype(jnp.int32)
            px, py = px.astype(jnp.float32), py.astype(jnp.float32)
        else:
            px, py = px.float(), py.float()
        sampler = sampler_cls(0, pid, sid)
        off = sampler.next_2d()
        uv = xp.stack([(px + off[:, 0]) / w, (py + off[:, 1]) / h], -1)
        return scene_.camera.sample_ray(uv), sampler

    # the scene is closed over, not an argument: the reference decides
    # its mask pass-through from the opacity column's values on the host
    # (dispatch.py:168), which a traced table does not have
    @jax.jit
    def jax_first_bounce():
        scene_ = jscene
        ray, sampler = camera(jnp, JaxSampler, scene_)
        its, _ = jax_intersect.ray_intersect_and_test(scene_.geom, ray, ray)
        u = sampler.next_2d()
        s = j_sample(scene_.materials, its.material_id, its.wi, u, u[:, 0],
                     albedo=scene_.materials.reflectance[
                         jnp.clip(its.material_id, 0)])
        return its.material_id, its.wi, s

    jmid, jwi, js = jax_first_bounce()
    ray, sampler = camera(torch, Sampler, scene)
    its, _ = ri.ray_intersect_and_test(scene.geom, ray, ray)
    u = sampler.next_2d()
    s = bsdf_sample(scene.materials, its.material_id, its.wi, u, u[:, 0],
                    albedo=scene.materials.reflectance[
                        torch.clamp(its.material_id, min=0).long()])
    hit = its.material_id.numpy()
    np.testing.assert_array_equal(hit, np.asarray(jmid))
    ids = bc.zoo_materials(MaterialBuilder(), microfacet)
    assert {ids[k] for k in ids if k != "black"} <= set(hit.tolist()), \
        sorted(set(hit.tolist()))
    _close_sampled(its.wi, jwi)
    for k in ("delta", "transmission", "valid"):
        np.testing.assert_array_equal(s[k].numpy(), np.asarray(js[k]), k)
    # 127 of the 128 lanes within 1e-4 (one Phong-metal lane's wo.x,
    # 0.0307, is 1.8e-5 off), every one within 1e-3
    for k in ("wo", "weight", "pdf", "eta"):
        _close_sampled(s[k], js[k], share=0.99)


def _frame_scene(backend, ward):
    """One quad lit by a small light at a grazing angle."""
    mods = bc.port_modules()
    b = mods.SceneBuilder()
    mat = b.materials.ward(diffuse=(0.0, 0.0, 0.0), specular=(0.8,) * 3,
                           alpha_u=0.05, alpha_v=0.6) if ward \
        else b.materials.lambertian((0.6, 0.6, 0.6))
    black = b.materials.lambertian((0.0, 0.0, 0.0))
    quad = mods.mesh.make_quad
    # turned 45 degrees about its normal, so that its uv tangent is not
    # the normal's frame's s axis, (1, 0, 0)
    b.add_shape(quad([0, -1.4, 0], [1.4, 0, 0], [0, 1.4, 0], [-1.4, 0, 0]),
                mat)
    b.add_area_emitter_shape(quad([1.6, -0.2, 1.2], [1.6, 0.2, 1.2],
                                  [2.0, 0.2, 1.4], [2.0, -0.2, 1.4]),
                             black, (40.0, 40.0, 40.0))
    b.set_camera(mods.make_perspective(mods.look_at(
        (-1.0, 0.3, 2.5), (0, 0, 0), (0, 1, 0)), 50.0, 1.0), 16, 16)
    return b.build(backend=backend, device="cpu")


@pytest.mark.parametrize("bsdf", ["ward", "lambertian"])
def test_shading_frame_differs_by_backend(bsdf):
    """ROADMAP C, decided: the port keeps each backend's frame as the
    reference builds it. Per pixel (16x16, 64 spp, depth 2), Welch's t
    between the brute and the bvh render: a Ward quad's highlight turns
    with the tangent, a lambertian quad does not."""
    from mitsuba_tpu_torch.integrators.path import camera_wavefront

    spp = 64
    stats = []
    for backend in ("brute", "bvh"):
        scene = _frame_scene(backend, bsdf == "ward")
        cfg = PathConfig(max_depth=2, spp=spp)
        ray, sampler, _ = camera_wavefront(scene, cfg, seed=0)
        its = ri.ray_intersect(scene.geom, ray)
        stats.append(its.dp_du.numpy()[its.valid.numpy()])
        L, _ = path_trace(scene, ray, sampler, cfg)
        Ls = L.reshape(16, 16, spp, 3).double()
        stats[-1] = (stats[-1], Ls.mean(2).numpy(), Ls.var(2).numpy())
    (tb, mb_, vb), (tv, mv, vv) = stats
    # the tangents differ (the brute one is the normal's frame)
    assert np.abs(tb - tv).max() > 0.5
    t = (mb_ - mv) / np.maximum(np.sqrt((vb + vv) / spp), 1e-6)
    frac = float((np.abs(t) > 3.9).any(-1).mean())
    if bsdf == "ward":
        assert frac > 0.05, frac
        assert abs(mb_.mean() - mv.mean()) > 0.05 * mv.mean()
    else:
        assert frac < 0.01, frac
        assert mb_.mean() > 0
