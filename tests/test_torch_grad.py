"""Reverse-mode gradients of the port's path tracer (bench config 4's
recipe: the loss is the image mean, the gradient is with respect to the
material reflectance), as tests/test_grad.py holds the JAX package's.

(a) Against central differences through the same seed (the estimator's
    samples are detached, so a fixed seed makes it a deterministic
    function of the reflectance): within 2e-2 relative, with and without
    a checkpoint a bounce, on config 1 and on config 2.
(b) Linearity in emitter radiance: loss = <grad, radiance> within rtol
    1e-4.
(c) Against the reference's `jax.grad` at the same seed on configs 1
    and 2, the reference's brute kernel in interpret mode behind
    stop_gradient (monkeypatched for these tests, as in
    tests/test_torch_path.py; nothing in the package changes): the loss
    within 1e-6 relative, each entry within 1e-5 of the largest (measured
    1.0e-7 and 1.7e-7: the lanes agree to rounding at this size).
(d) A kernel wrapper refuses a float input that requires grad
    (NotImplementedError), on every backend's query and on the wrappers
    that no render runs.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba_tpu.render.intersect as jax_intersect
from mitsuba_tpu.core.types import replace as jax_replace
from mitsuba_tpu.integrators.path import PathConfig as JaxPathConfig
from mitsuba_tpu.integrators.path import render as jax_render
from mitsuba_tpu.ops import intersect_pallas
from mitsuba_tpu.render.scene import cornell_box as jax_cornell_box
from mitsuba_tpu.render.scene import (
    cornell_box_specular as jax_cornell_box_specular,
)
from mitsuba_tpu_torch.integrators.path import (
    PathConfig, camera_wavefront, render,
)
from mitsuba_tpu_torch.integrators.volpath import render_volpath
from mitsuba_tpu_torch.interop import from_jax_scene
from mitsuba_tpu_torch.media import make_homogeneous
from mitsuba_tpu_torch.ops import cluster as cp
from mitsuba_tpu_torch.ops import intersect as ip
from mitsuba_tpu_torch.ops import probes as pr
from mitsuba_tpu_torch.ops import stream as sp
from mitsuba_tpu_torch.render import mesh as mesh_mod
from mitsuba_tpu_torch.render.intersect import ray_intersect, ray_test
from mitsuba_tpu_torch.render.records import Ray
from mitsuba_tpu_torch.render.scene import (
    SceneBuilder, cornell_box, cornell_box_specular, instanced_scene,
)

torch.set_num_threads(1)
FD_EPS, FD_RTOL = 2e-3, 2e-2          # tests/test_grad.py
REF_RTOL = 1e-5
JAX_SCENES = {"cornell_box": jax_cornell_box,
              "cornell_box_specular": jax_cornell_box_specular}


def _with(scene, table, **fields):
    return dataclasses.replace(scene, **{table: dataclasses.replace(
        getattr(scene, table), **fields)})


def _loss(scene, refl, cfg, seed=0):
    img, _ = render(_with(scene, "materials", reflectance=refl), cfg,
                    seed=seed)
    return img.mean()


def _grad(scene, cfg, seed=0):
    refl = scene.materials.reflectance.clone().requires_grad_(True)
    loss = _loss(scene, refl, cfg, seed)
    loss.backward()
    return loss.detach(), refl.grad


def _check_fd(scene, cfg, entries=((0, 0), (1, 1), (2, 2))):
    _, g = _grad(scene, cfg)
    assert torch.isfinite(g).all()
    assert g[0].abs().max() > 0          # the white walls
    refl = scene.materials.reflectance
    with torch.no_grad():
        for idx in entries:
            e = torch.zeros_like(refl)
            e[idx] = 1.0
            fd = float(_loss(scene, refl + FD_EPS * e, cfg)
                       - _loss(scene, refl - FD_EPS * e, cfg)) / (2 * FD_EPS)
            an = float(g[idx])
            assert abs(fd - an) / max(abs(fd), abs(an), 1e-6) < FD_RTOL, \
                (idx, fd, an)
    return g


@pytest.mark.parametrize("remat", [False, True])
def test_grad_matches_fd_albedo(remat):
    _check_fd(cornell_box(12, 12, device="cpu"),
              PathConfig(max_depth=3, spp=4, remat=remat))


def test_remat_gives_the_same_gradient():
    scene = cornell_box(12, 12, device="cpu")
    l0, g0 = _grad(scene, PathConfig(max_depth=4, spp=2, remat=False))
    l1, g1 = _grad(scene, PathConfig(max_depth=4, spp=2, remat=True))
    assert torch.equal(l0, l1)
    torch.testing.assert_close(g1, g0, rtol=1e-6, atol=0)


def test_forward_render_is_unchanged_by_remat():
    """Without a tensor that requires grad, remat takes the plain loop."""
    scene = cornell_box(8, 8, device="cpu")
    a, _ = render(scene, PathConfig(max_depth=3, spp=2, remat=True))
    b, _ = render(scene, PathConfig(max_depth=3, spp=2, remat=False))
    assert torch.equal(a, b)


def test_grad_emitter_radiance():
    """The render is linear in emitter radiance, so the gradient is exact."""
    scene = cornell_box(10, 10, device="cpu")
    cfg = PathConfig(max_depth=2, spp=2, remat=False)
    rad = scene.emitters.radiance.clone().requires_grad_(True)
    img, _ = render(_with(scene, "emitters", radiance=rad), cfg, seed=1)
    loss = img.mean()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()),
                               float((rad.grad * rad).sum()), rtol=1e-4)


@pytest.mark.parametrize("remat", [False, True])
def test_grad_matches_fd_specular_box(remat):
    """Config 2: the gradient through the mirror, glass and rough-metal
    bounces to the lambertian walls."""
    _check_fd(cornell_box_specular(12, 12, device="cpu"),
              PathConfig(max_depth=4, spp=4, remat=remat))


def test_grad_of_every_material_field_is_finite():
    """No NaN from a masked branch: the gradient with respect to each
    material field that moves no ray, on config 2, finite and nonzero."""
    scene = cornell_box_specular(10, 10, device="cpu")
    cfg = PathConfig(max_depth=5, spp=2)
    for name in ("reflectance", "specular", "transmittance", "cond_eta",
                 "cond_k"):
        x = getattr(scene.materials, name).clone().requires_grad_(True)
        img, _ = render(_with(scene, "materials", **{name: x}), cfg)
        img.mean().backward()
        assert torch.isfinite(x.grad).all(), name
        assert x.grad.abs().sum() > 0, name


def test_volpath_grad_with_and_without_remat():
    scene = cornell_box(10, 10, device="cpu")
    med = make_homogeneous((0.0015,) * 3, (0.0003,) * 3, g=0.4)
    grads = []
    for remat in (False, True):
        refl = scene.materials.reflectance.clone().requires_grad_(True)
        img, _ = render_volpath(_with(scene, "materials", reflectance=refl),
                                med, PathConfig(max_depth=3, spp=2,
                                                remat=remat))
        img.mean().backward()
        grads.append(refl.grad)
    assert torch.isfinite(grads[0]).all() and grads[0].abs().max() > 0
    torch.testing.assert_close(grads[1], grads[0], rtol=1e-6, atol=0)


@pytest.fixture(scope="module", params=["cornell_box",
                                        "cornell_box_specular"])
def reference_grad(request):
    """The reference's loss and jax.grad at 8x8, 2 spp, depth 3, through
    its TPU kernel path with the kernel interpreted and its inputs behind
    stop_gradient: the hit records are constants, as in the port, and
    JAX cannot linearize the interpreted kernel on config 2's rays."""
    jscene = JAX_SCENES[request.param](8, 8)
    cfg = JaxPathConfig(max_depth=3, spp=2, remat=False)
    kernel = intersect_pallas.closest_hit_shaded_and_any

    def interpreted(*args, **kw):
        return kernel(*(jax.lax.stop_gradient(a) for a in args),
                      interpret=True, **kw)

    def loss(refl):
        sc = jax_replace(jscene, materials=jax_replace(jscene.materials,
                                                       reflectance=refl))
        return jnp.mean(jax_render(sc, cfg, seed=0)[0])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_intersect, "_use_pallas", lambda: True)
        mp.setattr(intersect_pallas, "closest_hit_shaded_and_any",
                   interpreted)
        val, g = jax.jit(jax.value_and_grad(loss))(
            jscene.materials.reflectance)
    return jscene, float(val), np.asarray(g)


@pytest.mark.parametrize("remat", [False, True])
def test_grad_matches_reference(reference_grad, remat):
    jscene, val, g_ref = reference_grad
    scene = from_jax_scene(jscene, device="cpu")
    loss, g = _grad(scene, PathConfig(max_depth=3, spp=2, remat=remat))
    assert np.isfinite(g.numpy()).all()
    np.testing.assert_allclose(float(loss), val, rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), g_ref, rtol=0,
                               atol=REF_RTOL * np.abs(g_ref).max())


def _small_mesh_scene(backend):
    b = SceneBuilder()
    mat = b.materials.lambertian()
    b.add_shape(mesh_mod.make_sphere_mesh([0, 0, 3], 1.0, 8, 16), mat)
    b.add_area_emitter_shape(mesh_mod.make_quad(
        [-1, 2, 2], [1, 2, 2], [1, 2, 4], [-1, 2, 4]), mat, (5.0,) * 3)
    return b.build(backend=backend, device="cpu")


@pytest.mark.parametrize("backend", ["brute", "bvh", "cluster",
                                     "instanced"])
@pytest.mark.parametrize("query", ["closest", "any"])
def test_queries_refuse_a_ray_that_requires_grad(backend, query):
    scene = (cornell_box(4, 4, device="cpu") if backend == "brute"
             else instanced_scene(4, 4, 4, 8, device="cpu")
             if backend == "instanced" else _small_mesh_scene(backend))
    ray, _, _ = camera_wavefront(scene, PathConfig(spp=1), morton=False)
    d = ray.d.detach().clone().requires_grad_(True)
    ray = Ray(ray.o, d, ray.mint, ray.maxt)
    with pytest.raises(NotImplementedError):
        (ray_intersect if query == "closest" else ray_test)(scene.geom, ray)


def test_render_refuses_a_gradient_through_the_geometry():
    """The camera moves every ray: its gradient would be zero on the card,
    so the CPU refuses it too."""
    scene = cornell_box(4, 4, device="cpu")
    cam = scene.camera
    to_world = cam.to_world.clone().requires_grad_(True)
    scene = dataclasses.replace(scene, camera=dataclasses.replace(
        cam, to_world=to_world))
    with pytest.raises(NotImplementedError):
        render(scene, PathConfig(max_depth=2, spp=1))


@pytest.mark.parametrize("wrapper", ["brute_table", "stream", "cluster",
                                     "probe"])
def test_wrappers_refuse_grad(wrapper):
    """The wrappers that no query above reaches with a ray of its own."""
    f32, i32 = torch.float32, torch.int32
    if wrapper == "brute_table":
        table = torch.zeros((4, ip.TRI_COLS), requires_grad=True)
        o = torch.zeros((8, 3))
        args = (o, torch.ones((8, 3)), torch.zeros(8), torch.ones(8))
        call = functools.partial(ip.any_hit, table, *args)
    elif wrapper == "stream":
        rays = torch.zeros((2, 8, 128), dtype=f32, requires_grad=True)
        call = functools.partial(
            sp.stream_rows, rays, torch.zeros((2, 1), dtype=i32),
            torch.zeros((2, 1), dtype=f32),
            torch.zeros((1, 8, sp.SC_GROUP * 16), dtype=f32), False)
    elif wrapper == "cluster":
        rays = torch.zeros((cp.BM, 8, 128), dtype=f32, requires_grad=True)
        call = functools.partial(
            cp.cluster_rows, rays, torch.zeros((1, 1), dtype=i32),
            torch.zeros(1, dtype=i32),
            torch.zeros((1, sp.SC_GROUP * cp.RPC, 16), dtype=f32),
            torch.zeros((1, sp.SC_GROUP, 8), dtype=f32),
            torch.zeros(sp.SC_GROUP, dtype=i32), False)
    else:
        rays = torch.zeros((pr.ROWS, 128), requires_grad=True)
        call = functools.partial(pr.v0, rays, 1)
    with pytest.raises(NotImplementedError):
        call()
