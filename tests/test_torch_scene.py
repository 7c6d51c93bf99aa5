"""The port's scene, camera, BSDF and emitter modules against the JAX
package, elementwise on the same inputs (numpy, fixed seeds).

Tolerance 1e-6 (absolute, on values of order 1): both sides run the same
float32 formulas, but XLA may contract or reorder them and its sin, cos
and sqrt may round differently from PyTorch's in the last bit.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.bsdfs import bsdf_eval as j_eval
from mitsuba_tpu.bsdfs import bsdf_pdf as j_pdf
from mitsuba_tpu.bsdfs import bsdf_sample as j_sample
from mitsuba_tpu.bsdfs.table import MaterialBuilder as JaxMaterialBuilder
from mitsuba_tpu.emitters import eval_emitter_hit as j_emit_hit
from mitsuba_tpu.emitters import pdf_direct_area as j_pdf_area
from mitsuba_tpu.emitters import sample_direct as j_sample_direct
from mitsuba_tpu.integrators.path import mi_weight as j_mi_weight
from mitsuba_tpu.render import mesh as mesh_mod
from mitsuba_tpu.render.scene import SceneBuilder as JaxSceneBuilder
from mitsuba_tpu.render.scene import cornell_box as jax_cornell_box
from mitsuba_tpu_torch.bsdfs import bsdf_eval, bsdf_pdf, bsdf_sample
from mitsuba_tpu_torch.emitters import (
    eval_emitter_hit, pdf_direct_area, sample_direct,
)
from mitsuba_tpu_torch.integrators.path import PathConfig, mi_weight, render
from mitsuba_tpu_torch.interop import from_jax_scene
from mitsuba_tpu_torch.render.scene import SceneBuilder as TorchSceneBuilder
from mitsuba_tpu_torch.render.scene import cornell_box

torch.set_num_threads(1)
TOL = 1e-6


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=tol)


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def scenes():
    j = jax_cornell_box(16, 12)
    return j, from_jax_scene(j, device="cpu")


def test_cornell_box_equals_interop_conversion(scenes):
    jscene, conv = scenes
    port = cornell_box(16, 12, device="cpu")
    assert (port.width, port.height) == (conv.width, conv.height) == (16, 12)
    for part in ("geom", "materials", "emitters"):
        a, b = getattr(port, part), getattr(conv, part)
        for k, v in vars(a).items():
            w = getattr(b, k)
            if isinstance(v, torch.Tensor):
                assert v.dtype == w.dtype, (part, k)
                np.testing.assert_array_equal(v.numpy(), w.numpy(),
                                              err_msg=f"{part}.{k}")
            else:
                assert v == w, (part, k)
    np.testing.assert_array_equal(port.camera.to_world.numpy(),
                                  conv.camera.to_world.numpy())
    assert port.camera.tan_half_fov_x == conv.camera.tan_half_fov_x
    assert port.camera.tan_half_fov_y == conv.camera.tan_half_fov_y


def test_camera_rays_match(scenes):
    jscene, port = scenes
    uv = np.random.default_rng(0).uniform(0, 1, (500, 2)).astype(np.float32)
    ref = jscene.camera.sample_ray(jnp.asarray(uv))
    ray = port.camera.sample_ray(_t(uv))
    _close(ray.d, ref.d)
    np.testing.assert_allclose(ray.o.numpy(), np.asarray(ref.o), rtol=1e-6)
    _close(ray.mint, ref.mint)
    assert np.isinf(ray.maxt.numpy()).all()


def _materials_with_twosided():
    """Cornell's lambertian rows plus a two-sided one, built by both
    packages' builders from the same rows."""
    jb = JaxMaterialBuilder()
    for refl in ((0.725, 0.71, 0.68), (0.63, 0.065, 0.05), (0.2, 0.5, 0.9)):
        jb.lambertian(refl)
    jb.rows[-1]["two_sided"] = True
    jt = jb.build()
    from mitsuba_tpu_torch.bsdfs import MaterialBuilder

    pb = MaterialBuilder()
    for r in jb.rows:
        pb.lambertian(r["reflectance"], two_sided=r["two_sided"])
    return jt, pb.build()


def test_lambertian_dispatch_matches():
    jt, pt = _materials_with_twosided()
    rng = np.random.default_rng(1)
    n = 1000
    mid = rng.integers(-1, 3, n).astype(np.int32)
    wi, wo = _unit(rng, n), _unit(rng, n)
    u2 = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    u1 = rng.uniform(0, 1, n).astype(np.float32)
    _close(bsdf_eval(pt, _t(mid), _t(wi), _t(wo)),
           j_eval(jt, jnp.asarray(mid), wi, wo))
    _close(bsdf_pdf(pt, _t(mid), _t(wi), _t(wo)),
           j_pdf(jt, jnp.asarray(mid), wi, wo))
    s = bsdf_sample(pt, _t(mid), _t(wi), _t(u2), _t(u1))
    r = j_sample(jt, jnp.asarray(mid), wi, u2, u1)
    for k in ("wo", "weight", "pdf", "eta"):
        _close(s[k], r[k])
    for k in ("delta", "transmission", "valid"):
        np.testing.assert_array_equal(s[k].numpy(), np.asarray(r[k]))
    # the two-sided row answers from behind, the others do not
    back = (wi[:, 2] < 0) & (mid == 2)
    assert s["valid"].numpy()[back].all()
    assert not s["valid"].numpy()[(wi[:, 2] < 0) & (mid == 0)].any()


def _many_lights_scene():
    """A floor under a tessellated emissive sphere: more than 128 emitter
    records, which takes the reference's searchsorted record choice."""
    b = JaxSceneBuilder()
    white = b.materials.lambertian((0.5, 0.5, 0.5))
    b.add_shape(mesh_mod.make_quad([-600, 0, -600], [-600, 0, 600],
                                   [600, 0, 600], [600, 0, -600]), white)
    b.add_area_emitter_shape(
        mesh_mod.make_sphere_mesh([278, 400, 280], 60.0, 10, 20), white,
        (4.0, 3.0, 2.0))
    return b.build(backend="brute")


@pytest.mark.parametrize("which", ["cornell", "many_lights"])
def test_emitter_sampling_matches(scenes, which):
    jscene, port = scenes
    if which == "many_lights":
        jscene = _many_lights_scene()
        port = from_jax_scene(jscene, device="cpu")
        assert port.emitters.rec_pmf.shape[0] > 128
    rng = np.random.default_rng(2)
    n = 1000
    p_ref = rng.uniform([0, 0, 0], [556, 548, 559], (n, 3)).astype(np.float32)
    u_sel = rng.uniform(0, 1, n).astype(np.float32)
    u_sel[:4] = np.asarray(jscene.emitters.rec_cdf)[0]   # on a CDF step
    u_pos = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    ds = sample_direct(port.emitters, port.geom, _t(p_ref), _t(u_sel),
                       _t(u_pos))
    rs = j_sample_direct(jscene.emitters, jscene.geom, jnp.asarray(p_ref),
                         jnp.asarray(u_sel), jnp.asarray(u_pos))
    ok = np.array(rs.valid)
    np.testing.assert_array_equal(ds.valid.numpy(), ok)
    np.testing.assert_array_equal(ds.emitter_id.numpy(),
                                  np.asarray(rs.emitter_id))
    np.testing.assert_array_equal(ds.delta.numpy(), np.asarray(rs.delta))
    for k in ("d", "n", "value"):
        _close(getattr(ds, k)[ok], np.asarray(getattr(rs, k))[ok])
    # distances and pdfs scale with the scene (hundreds of units), so they
    # are held relatively; the pdf (pdf_area * dist^2 / cos) chains five
    # rounded operations, each of which may differ by an ulp: 2e-6
    for k, rtol in (("dist", 1e-6), ("pdf", 2e-6)):
        np.testing.assert_allclose(getattr(ds, k).numpy()[ok],
                                   np.asarray(getattr(rs, k))[ok],
                                   rtol=rtol)
    assert ok.mean() > 0.3      # a sphere light shows ~half its records

    prim = rng.integers(-1, 32, n).astype(np.int32)
    p_hit = rng.uniform([0, 0, 0], [556, 548, 559], (n, 3)).astype(np.float32)
    n_hit = _unit(rng, n)
    np.testing.assert_allclose(
        pdf_direct_area(port.emitters, _t(prim), _t(p_ref), _t(p_hit),
                        _t(n_hit)).numpy(),
        np.asarray(j_pdf_area(jscene.emitters, jnp.asarray(prim),
                              p_ref, p_hit, n_hit)), rtol=1e-6)
    eid = rng.integers(-1, 1, n).astype(np.int32)
    wi = _unit(rng, n)
    _close(eval_emitter_hit(port.emitters, _t(eid), _t(wi), _t(n_hit)),
           j_emit_hit(jscene.emitters, jnp.asarray(eid), wi, n_hit))


def test_mi_weight_matches():
    rng = np.random.default_rng(3)
    a = rng.exponential(size=1000).astype(np.float32)
    b = rng.exponential(size=1000).astype(np.float32)
    a[:100] = 0.0
    b[100:200] = 0.0
    _close(mi_weight(_t(a), _t(b)), j_mi_weight(a, b))


def test_unported_features_raise():
    jb = JaxSceneBuilder()
    jb.add_shape(mesh_mod.make_quad([0, 0, 0], [1, 0, 0], [1, 1, 0],
                                    [0, 1, 0]), jb.materials.lambertian())
    jb.add_cylinder([0, 0, 1], [0, 0, 2], 0.5, 0)
    # a cylinder, which this case held refused until it was ported
    # (ROADMAP A.11), converts with its tables
    # (tests/test_torch_cylinders.py holds its records)
    geom = from_jax_scene(jb.build(backend="brute"), device="cpu").geom
    assert geom.n_cylinders == 1 and geom.cyl_r.tolist() == [0.5]
    assert geom.cyl_a.tolist() == [[0.0, 0.0, 1.0]]
    # hair (ROADMAP A.12); an open shutter, which this case held until
    # motion blur was ported, converts (tests/test_torch_motion.py)
    from mitsuba_tpu.core import transform as jtf
    from mitsuba_tpu.render.camera import make_perspective as j_persp
    jb = JaxSceneBuilder()
    jb.add_sphere_emitter([0, 0, 0], 1.0, jb.materials.lambertian(),
                          (1.0, 1.0, 1.0))
    jb.set_camera(j_persp(jtf.identity(), 45.0, 1.0, shutter_time=0.5),
                  4, 4)
    assert from_jax_scene(jb.build(backend="brute"),
                          device="cpu").camera.shutter_time == 0.5
    jb.add_hair(dict(a=np.zeros((1, 3), np.float32),
                     b=np.ones((1, 3), np.float32),
                     r=np.full(1, 0.05, np.float32),
                     u0=np.zeros(1, np.float32), u1=np.ones(1, np.float32)),
                0)
    with pytest.raises(NotImplementedError, match="A.12"):
        from_jax_scene(jb.build(backend="brute"), device="cpu")
    scene = cornell_box(4, 4, device="cpu")
    # every PathConfig option is ported (tests/test_torch_path_options.py
    # holds them against the reference); the gradients of the particle
    # tracer and of a subsurface scene, which this case held refused
    # until they were ported (ROADMAP A.14), are finite
    # (tests/test_torch_grad_ptracer.py, tests/test_torch_grad_sss.py)
    from mitsuba_tpu_torch.integrators.ptracer import ptracer_render
    refl = scene.materials.reflectance.clone().requires_grad_(True)
    grad_scene = dataclasses.replace(scene, materials=dataclasses.replace(
        scene.materials, reflectance=refl))
    ptracer_render(grad_scene, PathConfig(max_depth=1), 16)[0].sum() \
        .backward()
    assert torch.isfinite(refl.grad).all()
    tb = TorchSceneBuilder()
    lam = tb.materials.lambertian((0.5, 0.5, 0.5))
    tb.add_shape(mesh_mod.make_box([0, 0, 0], [1, 1, 1]), lam)
    tb.add_subsurface(lam, (1.0, 1.0, 1.0), (0.1, 0.1, 0.1), n_points=8)
    tb.add_area_emitter_shape(mesh_mod.make_quad(
        [0, 3, 0], [1, 3, 0], [1, 3, 1], [0, 3, 1]), lam, (1.0,) * 3)
    tb.width = tb.height = 8
    ss_scene = tb.build(backend="brute", device="cpu")
    refl = ss_scene.materials.reflectance.clone().requires_grad_(True)
    ss_scene = dataclasses.replace(ss_scene, materials=dataclasses.replace(
        ss_scene.materials, reflectance=refl))
    render(ss_scene, PathConfig(max_depth=1, spp=1))[0].sum().backward()
    assert torch.isfinite(refl.grad).all()


def test_ported_features_convert():
    """What raised above until it was ported (ROADMAP A.11): a scene with
    Phong-distribution microfacets converts to the reference's tables,
    and renders under the stratified pattern and the gaussian filter."""
    jb = JaxSceneBuilder()
    jb.add_area_emitter_shape(mesh_mod.make_quad(
        [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]),
        jb.materials.rough_conductor(alpha=20.0, dist=2), (1.0, 1.0, 1.0))
    jscene = jb.build(backend="brute")
    scene = from_jax_scene(jscene, device="cpu")
    assert scene.materials.kinds_present == ((3, 2),)
    assert scene.materials.dist_type.tolist() == [2]
    # a sphere emitter (ROADMAP A.11, ported with the lights)
    jb = JaxSceneBuilder()
    jb.add_sphere_emitter([0, 0, 2], 0.5, jb.materials.lambertian(),
                          (4.0, 4.0, 4.0))
    jb.add_shape(mesh_mod.make_quad([-1, -1, 0], [1, -1, 0], [1, 1, 0],
                                    [-1, 1, 0]), jb.materials.lambertian())
    own = TorchSceneBuilder()
    own.add_sphere_emitter([0, 0, 2], 0.5, own.materials.lambertian(),
                           (4.0, 4.0, 4.0))
    from mitsuba_tpu_torch.render import mesh as tmesh
    own.add_shape(tmesh.make_quad([-1, -1, 0], [1, -1, 0], [1, 1, 0],
                                  [-1, 1, 0]), own.materials.lambertian())
    conv = from_jax_scene(jb.build(backend="brute"), device="cpu")
    own = own.build(backend="brute", device="cpu")
    assert conv.geom.sph_eid.tolist() == own.geom.sph_eid.tolist() == [0]
    assert conv.emitters.kinds_present == own.emitters.kinds_present == (8,)
    scene = cornell_box(4, 4, device="cpu")
    for kw in (dict(pattern="stratified"), dict(rfilter="gaussian")):
        img, _ = render(scene, PathConfig(max_depth=2, spp=4, **kw))
        assert img.shape == (4, 4, 3) and bool(torch.isfinite(img).all())


@pytest.mark.parametrize("fn", ["textured_mesh_scene", "SceneBuilder.build",
                                "build_geometry"])
def test_scene_defaults_equal_reference(fn):
    """The same call builds the same scene in both packages: the default
    backends are the reference's ("bvh" for textured_mesh_scene, "auto"
    elsewhere)."""
    import inspect

    import mitsuba_tpu.render.intersect as j_intersect
    import mitsuba_tpu.render.scene as j_scene
    import mitsuba_tpu_torch.render.intersect as t_intersect
    import mitsuba_tpu_torch.render.scene as t_scene

    def default(mod):
        obj = mod
        for part in fn.split("."):
            obj = getattr(obj, part)
        return inspect.signature(obj).parameters["backend"].default

    jmod, tmod = ((j_intersect, t_intersect) if fn == "build_geometry"
                  else (j_scene, t_scene))
    assert default(tmod) == default(jmod)


@pytest.mark.parametrize("n_tris", [64, 66])
def test_auto_backend_rule_equals_reference(n_tris):
    """"auto" is brute up to 64 triangles and cluster above, in both."""
    from mitsuba_tpu.render.intersect import build_geometry as j_build
    from mitsuba_tpu_torch.render.intersect import build_geometry

    rng = np.random.default_rng(n_tris)
    tri = rng.uniform(-1, 1, (n_tris, 3, 3)).astype(np.float32)
    mesh = mesh_mod.TriMesh(tri.reshape(-1, 3),
                            np.arange(3 * n_tris).reshape(-1, 3))
    jg, tg = j_build([(mesh, 0, -1)]), build_geometry([(mesh, 0, -1)])
    assert tg.backend == jg.backend == ("brute" if n_tris <= 64
                                        else "cluster")
