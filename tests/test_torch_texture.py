"""The port's textures against the JAX package: the constant,
checkerboard, grid, vertex-colour and bitmap kinds (render/texture.py),
the MIP pyramid and its trilinear, footprint and EWA lookups
(render/mipmap.py), the ray-cone filters of the path tracer
(`mip_filter`, `aniso_filter`), and the texel gradient.

Tolerances (tests/test_torch_bsdf_zoo.py's): tables and pyramid levels
bit for bit; lookups on the same tables within 1e-5 relative and 1e-6
absolute (a float32 sRGB
decode within 4 ulps, XLA's pow against numpy's); what follows from a
sampled direction 999 lanes in 1,000 within 1e-4 / 1e-5 and every lane
within 1e-3 / 1e-4. The first bounce of the receding checker floor of
tests/test_mipmap.py runs through the fused kernel (#1) against the
reference's kernel path (tests/torch_kernel_path.py): the ray-cone
footprint and the filtered albedo lane by lane, and the depth-2 radiance.
The JAX package's own checks of tests/test_mipmap.py run on the port's
lookups and renders. The texel gradient (tests/test_grad.py:100's
scene, 12 x 12 px, 4 spp, depth 2, seed 5) against central differences
(within 1e-3 relative, the JAX test's bound) and against `jax.grad`
(each entry within 1e-5 of the largest), on the brute backend and, the
first gradient off brute, on the bvh backend.
"""
import dataclasses
import os
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba_tpu.integrators.path as jpath
from mitsuba_tpu.core import math as jm
from mitsuba_tpu.core import transform as jtf
from mitsuba_tpu.core.types import replace as jax_replace
from mitsuba_tpu.render import mesh as jmesh
from mitsuba_tpu.render import mipmap as jmip
from mitsuba_tpu.render import texture as jtex
from mitsuba_tpu.render.camera import make_perspective as j_persp
from mitsuba_tpu.render.intersect import ray_intersect as j_intersect
from mitsuba_tpu.render.sampler import Sampler as JaxSampler
from mitsuba_tpu.render.scene import SceneBuilder as JaxSceneBuilder
from mitsuba_tpu_torch.core import transform as ttf
from mitsuba_tpu_torch.integrators import path as tpath
from mitsuba_tpu_torch.integrators.path import PathConfig, render
from mitsuba_tpu_torch.interop import from_jax_scene
from mitsuba_tpu_torch.render import mesh as tmesh
from mitsuba_tpu_torch.render import mipmap
from mitsuba_tpu_torch.render import texture as tex
from mitsuba_tpu_torch.render.camera import make_perspective as t_persp
from mitsuba_tpu_torch.render.intersect import ray_intersect
from mitsuba_tpu_torch.render.sampler import Sampler
from mitsuba_tpu_torch.render.scene import SceneBuilder

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_kernel_path as kp  # noqa: E402
import torch_light_cases as lc  # noqa: E402

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-6
JAX = SimpleNamespace(SceneBuilder=JaxSceneBuilder, mesh=jmesh,
                      look_at=jtf.look_at, make_perspective=j_persp)
PORT = SimpleNamespace(SceneBuilder=SceneBuilder, mesh=tmesh,
                       look_at=ttf.look_at, make_perspective=t_persp)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=rtol,
                               atol=atol)


def _close_sampled(a, b, share=0.999):
    a, b = a.detach().numpy(), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4)
    ok = np.isclose(a, b, rtol=1e-4, atol=1e-5)
    ok = ok.reshape(len(ok), -1).all(-1)
    assert ok.mean() >= share, ok.mean()


def _rows(tb, rng, mips):
    """Every kind and option, in either package's TextureBuilder."""
    tb.constant((0.3, 0.5, 0.7))
    tb.checkerboard((0.9, 0.8, 0.7), (0.1, 0.2, 0.3), uv_scale=(3.0, 2.0),
                    uv_offset=(0.25, -0.5))
    tb.grid((0.8,) * 3, (0.2, 0.1, 0.0), line_width=0.07,
            uv_scale=(4.0, 4.0))
    tb.vertex_colors()
    img = rng.uniform(0.0, 1.0, (12, 20, 3)).astype(np.float32)
    ldr = (rng.uniform(0.0, 1.0, (8, 8, 3)) * 255).astype(np.uint8)
    gray = rng.uniform(0.0, 1.0, (6, 10)).astype(np.float32)
    tb.bitmap(img, gamma=1.0, tint=(0.9, 1.0, 0.8), uv_scale=(2.5, 1.5),
              uv_offset=(0.1, 0.3))
    tb.bitmap(img, gamma=1.0, wrap="clamp", uv_scale=(1.7, 1.3),
              uv_offset=(-0.2, 0.0))
    tb.bitmap(ldr)                      # sRGB decode (gamma -1)
    tb.bitmap(gray, gamma=2.2)
    return tb.build()


@pytest.fixture(scope="module", params=[False, True], ids=["bilinear",
                                                           "mips"])
def tables(request):
    mips = request.param
    jt = _rows(jtex.TextureBuilder(build_mips=mips),
               np.random.default_rng(1), mips)
    tt = _rows(tex.TextureBuilder(build_mips=mips),
               np.random.default_rng(1), mips)
    return jt, tt


def test_tables_match(tables):
    """The rows bit for bit; the images within the sRGB decode's 4 ulps
    (bit for bit but the ldr image); the pyramids from those images bit
    for bit."""
    jt, tt = tables
    from mitsuba_tpu_torch.interop import _textures

    conv = _textures(jt)
    for f in ("kind", "color0", "color1", "line_width", "uv_scale",
              "uv_offset", "image_slot", "wrap_clamp"):
        a, b = getattr(tt, f), getattr(conv, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f
    assert tt.kinds_present == conv.kinds_present == (0, 1, 2, 3, 4)
    assert tt.wraps_present == conv.wraps_present == (False, True)
    for i, (a, b) in enumerate(zip(tt.images, conv.images)):
        if i == 2:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-7,
                                       atol=0)
        else:
            assert torch.equal(a, b), i
    assert len(tt.mips) == len(conv.mips)
    for i, (a, b) in enumerate(zip(tt.mips, conv.mips)):
        if i != 2:
            assert a.n_levels == b.n_levels
            for la, lb in zip(a.levels, b.levels):
                assert torch.equal(la, lb), i


def _uv(n, rng, w=20, h=12):
    """uv inside and outside [0, 1), a quarter on texel centres and edges
    of a (h, w) image, where floor() decides the texel."""
    uv = rng.uniform(-1.5, 2.5, (n, 2)).astype(np.float32)
    q = n // 4
    k = rng.integers(-w, 2 * w, (q, 2))
    uv[:q, 0] = (k[:, 0] + rng.choice([0.0, 0.5], q)) / w
    uv[:q, 1] = (k[:, 1] + rng.choice([0.0, 0.5], q)) / h
    return uv


@pytest.mark.parametrize("aniso", [False, True])
def test_eval_texture_matches(tables, aniso):
    """Every kind and wrap mode; with mips, the footprint lookups
    (trilinear, or EWA with aniso); without, the bilinear texel."""
    jt, tt = tables
    rng = np.random.default_rng(2)
    n = 3000
    uv = _uv(n, rng)
    ids = rng.integers(0, jt.kind.shape[0], n).astype(np.int32)
    vc = rng.uniform(size=(n, 3)).astype(np.float32)
    # a footprint; without mips (the "bilinear" tables) it is ignored
    dx = (rng.normal(size=(n, 2)) * 10 ** rng.uniform(-3, 0, (n, 1)))
    dy = (rng.normal(size=(n, 2)) * 10 ** rng.uniform(-3, 0, (n, 1)))
    kw = dict(duv_dx=dx.astype(np.float32), duv_dy=dy.astype(np.float32),
              aniso=aniso)
    ref = jtex.eval_texture(jt, jnp.asarray(ids), jnp.asarray(uv),
                            vertex_color=jnp.asarray(vc),
                            **{k: (jnp.asarray(v) if k != "aniso" else v)
                               for k, v in kw.items()})
    got = tex.eval_texture(tt, _t(ids), _t(uv), vertex_color=_t(vc),
                           **{k: (_t(v) if k != "aniso" else v)
                              for k, v in kw.items()})
    _close(got, ref)
    # no vertex colours: the row's color0
    ref0 = jtex.eval_texture(jt, jnp.asarray(ids), jnp.asarray(uv))
    _close(tex.eval_texture(tt, _t(ids), _t(uv)), ref0)


@pytest.mark.parametrize("shape", [(64, 64), (48, 20), (7, 33), (1, 5)])
def test_build_mipmap_levels_bit_for_bit(shape):
    img = np.random.default_rng(sum(shape)).uniform(
        0, 1, shape + (3,)).astype(np.float32)
    a, b = mipmap.build_mipmap(img), jmip.build_mipmap(img)
    assert a.n_levels == b.n_levels
    for la, lb in zip(a.levels, b.levels):
        assert la.dtype == torch.float32
        assert np.array_equal(la.numpy(), np.asarray(lb))


@pytest.mark.parametrize("clamp", [False, True])
def test_mip_lookups_match(clamp):
    img = np.random.default_rng(4).uniform(0, 1, (32, 16, 3)).astype(
        np.float32)
    a, b = mipmap.build_mipmap(img), jmip.build_mipmap(img)
    rng = np.random.default_rng(5)
    n = 2000
    uv = _uv(n, rng, 16, 32)
    lod = rng.uniform(-1, a.n_levels + 1, n).astype(np.float32)
    _close(mipmap.eval_trilinear(a, _t(uv), _t(lod), clamp),
           jmip.eval_trilinear(b, jnp.asarray(uv), jnp.asarray(lod), clamp))
    dx = (rng.normal(size=(n, 2)) * 0.05).astype(np.float32)
    dy = (rng.normal(size=(n, 2)) * 0.002).astype(np.float32)
    _close(mipmap.lod_from_duv(a, _t(dx), _t(dy)),
           jmip.lod_from_duv(b, jnp.asarray(dx), jnp.asarray(dy)))
    _close(mipmap.eval_aniso(a, _t(uv), _t(dx), _t(dy), clamp_wrap=clamp),
           jmip.eval_aniso(b, jnp.asarray(uv), jnp.asarray(dx),
                           jnp.asarray(dy), clamp_wrap=clamp))


def test_vertex_colours_never_reach_a_render():
    """ROADMAP C: the render path passes no vertex colours to
    eval_texture (the reference's path.py:783-806, the port's _albedo),
    so a vertexcolors texture renders as its color0, white."""
    imgs = []
    for kind in ("vertex_colors", "constant"):
        b = SceneBuilder()
        tb = b.textures
        tid = tb.vertex_colors() if kind == "vertex_colors" \
            else tb.constant((1.0, 1.0, 1.0))
        b.add_shape(tmesh.make_quad([-2, 0, -2], [-2, 0, 2], [2, 0, 2],
                                    [2, 0, -2]),
                    b.materials.lambertian((0.3, 0.3, 0.3), tex_id=tid))
        b.emitters.point((0, 2, 0), (5.0, 5.0, 5.0))
        b.set_camera(t_persp(ttf.look_at([0, 2, -3], [0, 0, 0], [0, 1, 0]),
                             50, 1.0), 8, 8)
        imgs.append(render(b.build(device="cpu"), PathConfig(
            max_depth=2, spp=2))[0])
    assert float(imgs[0].mean()) > 0 and torch.equal(imgs[0], imgs[1])
    tb = jtex.TextureBuilder()
    tb.vertex_colors()
    ref = jtex.eval_texture(tb.build(), jnp.zeros(4, jnp.int32),
                            jnp.zeros((4, 2)))
    np.testing.assert_array_equal(np.asarray(ref), 1.0)


# ---------------------------------------------------------------------------
# tests/test_mipmap.py on the port
# ---------------------------------------------------------------------------

def test_pyramid_structure_and_energy():
    mip = mipmap.build_mipmap(lc.checker(64))
    assert mip.n_levels == 7
    assert tuple(mip.levels[0].shape) == (64, 64, 3)
    assert tuple(mip.levels[-1].shape) == (1, 1, 3)
    means = [float(lv.mean()) for lv in mip.levels]
    np.testing.assert_allclose(means, means[0], rtol=1e-6)
    np.testing.assert_allclose(means[-1], 0.5, atol=1e-6)
    assert tuple(mipmap.build_mipmap(np.ones((48, 20, 3), np.float32))
                 .levels[0].shape) == (64, 32, 3)


def test_trilinear_level_selection_and_footprint():
    mip = mipmap.build_mipmap(lc.checker(64))
    uv = torch.tensor([[6.0 / 64, 1.0 - 2.0 / 64]])

    def at(lod):
        return float(mipmap.eval_trilinear(mip, uv,
                                           torch.tensor([lod]))[0, 0])

    assert at(0.0) > 0.9 and abs(at(6.0) - 0.5) < 1e-5
    lo, hi = sorted((at(3.0), at(4.0)))
    assert lo - 1e-6 <= at(3.5) <= hi + 1e-6
    zero = torch.zeros((1, 2))
    assert abs(float(mipmap.lod_from_duv(
        mip, torch.tensor([[1.0 / 64, 0.0]]), zero)[0])) < 1e-5
    assert abs(float(mipmap.lod_from_duv(
        mip, torch.tensor([[8.0 / 64, 0.0]]), zero)[0]) - 3.0) < 1e-5


def test_aniso_sharper_than_isotropic():
    n = 64
    mip = mipmap.build_mipmap(lc.stripes(n, 8))
    dx = torch.tensor([[16.0 / n, 0.0]])
    dy = torch.tensor([[0.0, 1.0 / n]])
    bright = torch.tensor([[0.5, 1.0 - 12.5 / n]])
    dark = torch.tensor([[0.5, 1.0 - 4.5 / n]])
    a_b = float(mipmap.eval_aniso(mip, bright, dx, dy, taps=8)[0, 0])
    a_d = float(mipmap.eval_aniso(mip, dark, dx, dy, taps=8)[0, 0])
    lod = mipmap.lod_from_duv(mip, dx, dy)
    i_b = float(mipmap.eval_trilinear(mip, bright, lod)[0, 0])
    i_d = float(mipmap.eval_trilinear(mip, dark, lod)[0, 0])
    assert (a_b - a_d) > 2.0 * (i_b - i_d) and (a_b - a_d) > 0.5


def test_eval_texture_mip_integration():
    tb = tex.TextureBuilder(build_mips=True)
    tid = tb.bitmap(lc.checker(64), gamma=1.0)
    table = tb.build()
    uv = torch.tensor([[6.0 / 64, 1.0 - 2.0 / 64], [2.0 / 64, 1.0 - 2.0 / 64]])
    ids = torch.tensor([tid, tid], dtype=torch.int32)
    sharp = tex.eval_texture(table, ids, uv)
    wide = torch.full((2, 2), 0.5)
    blurred = tex.eval_texture(table, ids, uv, duv_dx=wide, duv_dy=wide)
    assert abs(float(sharp[0, 0]) - float(sharp[1, 0])) > 0.5
    np.testing.assert_allclose(blurred.numpy(), 0.5, atol=0.05)


def test_path_tracer_ewa_aniso():
    """tests/test_mipmap.py's EWA render check on the port: on the
    grazing stripe floor the anisotropic filter keeps more contrast than
    the isotropic one, and the energy of the unfiltered render."""
    scene = lc.mip_floor(PORT, 32, 32, image=lc.stripes(128, 4),
                         uv_scale=(8.0, 8.0), device="cpu")
    base = dict(max_depth=2, spp=4, remat=False)
    img_n, img_m, img_a = (render(scene, PathConfig(**base, **kw), seed=0)[0]
                           .numpy() for kw in (
                               {}, dict(mip_filter=True),
                               dict(aniso_filter=True)))
    assert np.isfinite(img_a).all()
    assert abs(img_a.mean() - img_n.mean()) / img_n.mean() < 0.12
    mid = slice(18, 30)

    def contrast(img):
        return float(np.std(img[mid, :, 0], axis=1).mean())

    assert contrast(img_a) > 1.3 * contrast(img_m)
    assert abs(img_a[mid].mean() - img_m[mid].mean()) \
        / img_m[mid].mean() < 0.12


def test_path_tracer_ray_cone_mip():
    """tests/test_mipmap.py's ray-cone check on the port: the mip filter
    de-aliases the far rows and keeps the energy."""
    scene = lc.mip_floor(PORT, 32, 32, device="cpu")
    img_n, img_m = (render(scene, PathConfig(max_depth=2, spp=2, remat=False,
                                             mip_filter=m), seed=0)[0]
                    .numpy() for m in (False, True))
    assert np.isfinite(img_m).all()
    assert abs(img_m.mean() - img_n.mean()) / img_n.mean() < 0.12
    far = slice(18, 30)
    assert img_m[far].std() < 0.5 * img_n[far].std()
    assert abs(img_m[far].mean() - img_n[far].mean()) \
        / img_n[far].mean() < 0.12


# ---------------------------------------------------------------------------
# the filters in the path tracer, lane by lane
# ---------------------------------------------------------------------------

W = H = 16
SPP = 2


@pytest.fixture(scope="module")
def floors():
    js = lc.mip_floor(JAX, W, H)
    return js, from_jax_scene(js, device="cpu")


def _camera(xp, sampler_cls, scene):
    pid, sid, px, py = kp.lanes(W, H, SPP, xp)
    sampler = sampler_cls(0, pid, sid)
    off = sampler.next_2d()
    uv = xp.stack([(px + off[:, 0]) / W, (py + off[:, 1]) / H], -1)
    return scene.camera.sample_ray(uv), sampler


@pytest.mark.parametrize("mode", ["mip_filter", "aniso_filter"])
def test_first_bounce_filters_match_kernel_path(floors, monkeypatch, mode):
    """The first hits' ray-cone footprints and filtered albedo (the
    texture block of path.py:783-806), and the depth-2 radiance, against
    the reference's kernel path."""
    js, scene = floors
    kp.kernel_path(monkeypatch, js.geom)
    alpha = float(np.float32(2.0) * np.float32(scene.camera.tan_half_fov_y)
                  / np.float32(H))

    @jax.jit
    def jax_first():
        ray, _ = _camera(jnp, JaxSampler, js)
        its = j_intersect(js.geom, ray)
        width = alpha * its.t
        tid = js.materials.tex_id[jnp.clip(its.material_id, 0)]
        if mode == "aniso_filter":
            dx, dy = jpath._cone_duv_aniso(js.geom, its, ray.d, width)
            val = jtex.eval_texture(js.textures, tid, its.uv, duv_dx=dx,
                                    duv_dy=dy, aniso=True)
        else:
            dens = jnp.maximum(jm.length(its.dp_du), 1e-6)
            f = (width / (dens * jnp.maximum(jnp.abs(its.wi[:, 2]),
                                             0.1)))[:, None]
            dx = jnp.concatenate([f, jnp.zeros_like(f)], -1)
            dy = dx[:, ::-1]
            val = jtex.eval_texture(js.textures, tid, its.uv, duv_dx=dx,
                                    duv_dy=dy)
        return its.valid, dx, dy, val

    valid, jdx, jdy, jval = jax_first()
    ray, _ = _camera(torch, Sampler, scene)
    its = ray_intersect(scene.geom, ray)
    cfg = PathConfig(**{mode: True})
    if mode == "aniso_filter":
        dx, dy = tpath._cone_duv_aniso(scene.geom, its, ray.d, alpha * its.t)
        _close(dx, jdx, rtol=1e-4, atol=1e-7)
        _close(dy, jdy, rtol=1e-4, atol=1e-7)
    albedo = tpath._albedo(scene, cfg, its, ray.d, its.t, alpha)
    v = np.asarray(valid)
    np.testing.assert_array_equal(its.valid.numpy(), v)
    assert 0.5 < v.mean() < 1
    _close_sampled(albedo[torch.from_numpy(v)], np.asarray(jval)[v])

    jcfg = jpath.PathConfig(max_depth=2, spp=SPP, remat=False,
                            **{mode: True})

    @jax.jit
    def jax_L():
        ray, sampler = _camera(jnp, JaxSampler, js)
        return jpath.path_trace(js, ray, sampler, jcfg)[0]

    ray, sampler = _camera(torch, Sampler, scene)
    L, _ = tpath.path_trace(scene, ray, sampler,
                            PathConfig(max_depth=2, spp=SPP, remat=False,
                                       **{mode: True}))
    _close_sampled(L, jax_L(), share=0.99)


# ---------------------------------------------------------------------------
# the texel gradient (tests/test_grad.py:100)
# ---------------------------------------------------------------------------

GRAD_CFG = dict(max_depth=2, spp=4, remat=False)
GRAD_SEED = 5


def _loss(scene, img, cfg=None):
    t = scene.textures
    sc = dataclasses.replace(scene, textures=dataclasses.replace(
        t, images=(img,) + t.images[1:]))
    return render(sc, cfg or PathConfig(**GRAD_CFG), seed=GRAD_SEED)[0].mean()


@pytest.fixture(scope="module", params=["brute", "bvh"])
def grad_case(request):
    """The port's scene, its gradient, and the reference's jax.grad (on
    brute through its kernel path)."""
    backend = request.param
    mp = pytest.MonkeyPatch()
    try:
        js = lc.grad_quad(JAX, backend=backend)
        if backend == "brute":
            kp.kernel_path(mp, js.geom)
        jcfg = jpath.PathConfig(**GRAD_CFG)

        def jloss(img):
            t = js.textures
            sc = jax_replace(js, textures=jax_replace(
                t, images=(img,) + t.images[1:]))
            return jnp.mean(jpath.render(sc, jcfg, seed=GRAD_SEED)[0])

        img0 = jnp.asarray(lc.grad_image())
        jl, jg = jax.jit(jax.value_and_grad(jloss))(img0)
    finally:
        mp.undo()
    scene = lc.grad_quad(PORT, backend=backend, device="cpu")
    assert scene.geom.backend == backend
    img = scene.textures.images[0].clone().requires_grad_(True)
    loss = _loss(scene, img)
    loss.backward()
    return scene, float(loss), img.grad.clone(), float(jl), np.asarray(jg)


def test_texel_gradient_matches_reference(grad_case):
    _scene, loss, g, jl, jg = grad_case
    assert np.isfinite(g.numpy()).all() and float(g.abs().max()) > 0
    np.testing.assert_allclose(loss, jl, rtol=1e-5)
    assert np.abs(g.numpy() - jg).max() <= 1e-5 * np.abs(jg).max()


def test_texel_gradient_matches_fd(grad_case):
    scene, _loss0, g, _jl, _jg = grad_case
    img0 = scene.textures.images[0]
    eps = 1e-2
    for idx in [(1, 1, 0), (2, 3, 1), (0, 0, 2)]:
        e = torch.zeros_like(img0)
        e[idx] = 1.0
        with torch.no_grad():
            fd = (float(_loss(scene, img0 + eps * e))
                  - float(_loss(scene, img0 - eps * e))) / (2 * eps)
        an = float(g[idx])
        assert abs(fd - an) / max(abs(fd), abs(an), 1e-6) < 1e-3, \
            (idx, fd, an)


def test_texel_gradient_with_remat():
    """A checkpoint a bounce recomputes the same gradient: the texel
    images are scene tensors that require grad (path.py requires_grad)."""
    scene = lc.grad_quad(PORT, device="cpu")
    grads = []
    for remat in (False, True):
        img = scene.textures.images[0].clone().requires_grad_(True)
        _loss(scene, img, PathConfig(**dict(GRAD_CFG, remat=remat))) \
            .backward()
        grads.append(img.grad)
    assert tpath.requires_grad(dataclasses.replace(
        scene.textures, images=(img,)))
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-6, atol=1e-9)
