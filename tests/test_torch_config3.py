"""The config-3 slice end to end: the port's cluster path tracer against
the JAX package's, on a small scene with the slice's features (a
2,210-triangle phong sphere on a checkerboard-textured floor under the
Preetham sky, cluster backend), 16 x 16 px, 2 spp, depth 3, seed 0.

The reference runs on the CPU, where it walks its XLA BVH instead of the
exact-cull kernels; both find the same closest hits. The port converts
the reference's scene (`from_jax_scene`), so both render the same
tables, sky sampling tables included.

Tolerances: first-bounce records within 1e-5 (1e-4 on the frame-derived
wi) on >= 99% of lanes; per-lane radiance within 1e-4 relative on >= 99%
of lanes (float32 rounding differs in the last bits, and a ray grazing an
edge may then take the neighbouring triangle and diverge); the images'
8 x 8 block means within 1e-3 relative and a per-pixel Welch t-test
(mitsuba_tpu/utils/ttest.py) passing.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.core import transform as jtf
from mitsuba_tpu.integrators.path import PathConfig as JaxPathConfig
from mitsuba_tpu.integrators.path import path_trace as jax_path_trace
from mitsuba_tpu.render import intersect as jri
from mitsuba_tpu.render.camera import make_perspective
from mitsuba_tpu.render.mesh import make_quad, make_sphere_mesh
from mitsuba_tpu.render.sampler import Sampler as JaxSampler
from mitsuba_tpu.render.scene import SceneBuilder as JaxSceneBuilder
from mitsuba_tpu.utils.ttest import welch_ttest_images
from mitsuba_tpu_torch.integrators.path import PathConfig, path_trace, render
from mitsuba_tpu_torch.interop import from_jax_scene
from mitsuba_tpu_torch.render import intersect as ri
from mitsuba_tpu_torch.render.sampler import Sampler

torch.set_num_threads(1)
W = H = 16
SPP, DEPTH = 2, 3


def jax_scene():
    b = JaxSceneBuilder()
    tex = b.textures.checkerboard(bright=(0.7,) * 3, dark=(0.2, 0.2, 0.25),
                                  uv_scale=(8.0, 8.0))
    floor = b.materials.lambertian((1.0, 1.0, 1.0), tex_id=tex)
    body = b.materials.phong(diffuse=(0.4, 0.3, 0.2), specular=(0.3,) * 3,
                             exponent=40.0)
    b.add_shape(make_sphere_mesh([0, 0.8, 0], 0.8, 24, 48), body)
    b.add_shape(make_quad([-6, 0, -6], [-6, 0, 6], [6, 0, 6], [6, 0, -6]),
                floor)
    b.emitters.sky(turbidity=3.0, sun_dir=(0.35, 0.6, -0.5), scale=1.0)
    b.set_camera(make_perspective(
        jtf.look_at([0, 1.4, -3.2], [0, 0.7, 0], [0, 1, 0]), fov_deg=40.0,
        aspect=W / H), W, H)
    return b.build(backend="cluster")


@pytest.fixture(scope="module")
def scenes():
    js = jax_scene()
    return js, from_jax_scene(js, device="cpu")


def _lanes(xp):
    lane = xp.arange(W * H * SPP)
    pid, sid = lane // SPP, lane % SPP
    return pid, sid, pid % W, pid // W


def _camera_rays(scene, xp):
    """Scanline lanes: pixel * spp + sample, both packages' samplers."""
    pid, sid, px, py = _lanes(xp)
    if xp is torch:
        sampler = Sampler(0, pid.to(torch.int32), sid.to(torch.int32))
        off = sampler.next_2d()
        uv = torch.stack([(px.float() + off[:, 0]) / W,
                          (py.float() + off[:, 1]) / H], -1)
    else:
        sampler = JaxSampler(0, pid, sid.astype(jnp.int32))
        off = sampler.next_2d()
        uv = jnp.stack([(px.astype(jnp.float32) + off[:, 0]) / W,
                        (py.astype(jnp.float32) + off[:, 1]) / H], -1)
    return scene.camera.sample_ray(uv), sampler


def test_first_bounce_records_match(scenes):
    js, ts = scenes
    jray, _ = _camera_rays(js, jnp)
    tray, _ = _camera_rays(ts, torch)
    ref = jri._ray_intersect_tri(js.geom, jray)
    its = ri.ray_intersect(ts.geom, tray, coherent=True)
    ok = np.asarray(ref.valid)
    assert np.array_equal(its.valid.numpy(), ok) and ok.mean() > 0.5
    same = ok & (its.prim_id.numpy() == np.asarray(ref.prim_id))
    assert same.sum() >= 0.99 * ok.sum()
    for k, tol in (("t", 1e-5), ("p", 1e-5), ("geo_n", 1e-5),
                   ("sh_n", 1e-5), ("uv", 1e-5), ("dp_du", 1e-4),
                   ("wi", 1e-4)):
        close = np.isclose(getattr(its, k).numpy(),
                           np.asarray(getattr(ref, k)), rtol=tol,
                           atol=tol).reshape(ok.shape[0], -1).all(-1)
        assert close[same].mean() >= 0.99, k
    for k in ("material_id", "shape_id"):
        assert np.array_equal(getattr(its, k).numpy()[same],
                              np.asarray(getattr(ref, k))[same]), k


@pytest.fixture(scope="module")
def reference_lanes(scenes):
    """The reference's per-lane radiance and ray count (scanline lanes)."""
    js, _ts = scenes
    jcfg = JaxPathConfig(max_depth=DEPTH, spp=SPP, remat=False)

    @jax.jit
    def run(scene):
        ray, sampler = _camera_rays(scene, jnp)
        L, aux = jax_path_trace(scene, ray, sampler, jcfg)
        return L, aux["rays_traced"]

    return tuple(np.asarray(x) for x in run(js))


def test_path_trace_matches_reference_per_lane(scenes, reference_lanes):
    _js, ts = scenes
    L_ref, rays_ref = reference_lanes
    ray, sampler = _camera_rays(ts, torch)
    L, aux = path_trace(ts, ray, sampler,
                        PathConfig(max_depth=DEPTH, spp=SPP))
    L = L.numpy()
    assert np.isfinite(L).all()
    close = np.isclose(L, L_ref, rtol=1e-4, atol=1e-6).all(axis=-1)
    assert close.mean() >= 0.99, close.mean()
    assert int(aux["rays_traced"]) == int(rays_ref)


def test_render_matches_reference_image(scenes, reference_lanes):
    """`render` orders its lanes by pixel Morton code and un-permutes the
    radiance before the film; each (pixel, sample) draws the same numbers
    in any lane order, so its image is the reference's per-pixel mean:
    8 x 8 block means and a per-pixel Welch t-test against it."""
    _js, ts = scenes
    m_ref = reference_lanes[0].reshape(H, W, SPP, 3)
    img = render(ts, PathConfig(max_depth=DEPTH, spp=SPP), seed=0)[0]
    img = img.numpy()
    assert img.shape == (H, W, 3) and np.isfinite(img).all()
    ref = m_ref.mean(2)
    assert np.isclose(img, ref, rtol=1e-4, atol=1e-6).all(-1).mean() >= 0.99

    def blocks(a, b=8):
        return a.reshape(H // b, b, W // b, b, 3).mean(axis=(1, 3))

    np.testing.assert_allclose(blocks(img), blocks(ref), rtol=1e-3)
    var = m_ref.var(2, ddof=1) + 1e-8
    res = welch_ttest_images(img, var, SPP, ref, var, SPP)
    assert res.passed, res


def test_config3_scene_renders():
    """Bench config 3's own scene (101,762 triangles) through the port's
    render on the CPU, at a tiny size: finite, in bench.py's band."""
    from mitsuba_tpu_torch.render.scene import textured_mesh_scene

    scene = textured_mesh_scene(8, 8, backend="cluster", device="cpu")
    assert scene.geom.n_tris == 101762
    img, aux = render(scene, PathConfig(max_depth=2, spp=1), seed=0)
    assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())
    assert 0.17 < float(img.mean()) < 0.41
    assert int(aux["rays_traced"]) > 64
