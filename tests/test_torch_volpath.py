"""The port's volumetric path tracer, direct integrator and sorted brute
bounces end to end against the JAX package, and the scene entry points'
default device.

(a) Lane by lane against the reference's TPU kernel path: the brute
    queries run the Pallas kernels #2 (closest_hit_shaded) and #3
    (any_hit), and the fused #1 for the unsorted path tracer, in
    interpret mode, monkeypatched for these tests as
    tests/test_torch_path.py does (nothing in the package changes). The
    JAX package's CPU path builds another shading frame (ROADMAP C), so
    it is not the lane-level reference. At least 99% of lanes within
    rtol 1e-4 and the means within 1e-3 relative: float32 rounding
    differs in the last bits (XLA contracts and reorders), and a ray that
    grazes an edge may then pick the neighbouring triangle and diverge.
(b) bench.py's golden gate (8x8-block relative RMSE <= 0.10) of the
    port's CPU render of "fog" against the JAX package's CPU render of
    the same lanes (tests/torch_goldens/volpath_fog.npz, "spp16").
(c) Without a CUDA device the scene entry points raise unless the caller
    asks for the CPU.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba_tpu.render.intersect as jax_intersect
from mitsuba_tpu.integrators.direct import direct_trace as jax_direct_trace
from mitsuba_tpu.integrators.path import PathConfig as JaxPathConfig
from mitsuba_tpu.integrators.path import path_trace as jax_path_trace
from mitsuba_tpu.integrators.volpath import volpath_trace as jax_volpath
from mitsuba_tpu.media import make_homogeneous as jax_make_homogeneous
from mitsuba_tpu.ops import intersect_pallas
from mitsuba_tpu.render.sampler import Sampler as JaxSampler
from mitsuba_tpu.render.sampler import sample_position as jax_sample_position
from mitsuba_tpu.render.scene import cornell_box as jax_cornell_box
from mitsuba_tpu_torch.integrators import (
    PathConfig, direct_trace, path_trace, render, render_volpath,
    volpath_trace,
)
from mitsuba_tpu_torch.integrators.path import camera_wavefront
from mitsuba_tpu_torch.interop import from_jax_medium, from_jax_scene
from mitsuba_tpu_torch.media import make_homogeneous
from mitsuba_tpu_torch.render import scene as scene_mod

torch.set_num_threads(1)
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_goldens", "volpath_fog.npz")
FOG = dict(sigma_s=(0.0015,) * 3, sigma_a=(0.0003,) * 3, g=0.4)
W = H = 8


@pytest.fixture
def kernel_path(monkeypatch):
    """The reference's TPU branches of the brute queries, with its Pallas
    kernels in interpret mode and their triangle loops rolled (the same
    arithmetic, compiled in a fraction of the time)."""
    monkeypatch.setattr(jax_intersect, "_use_pallas", lambda: True)
    monkeypatch.setattr(intersect_pallas, "_UNROLL_LIMIT", 0)
    for name in ("closest_hit_shaded", "any_hit",
                 "closest_hit_shaded_and_any"):
        monkeypatch.setattr(intersect_pallas, name, functools.partial(
            getattr(intersect_pallas, name), interpret=True))


def _jax_camera(spp):
    """render_volpath's wavefront (volpath.py:285-296): scanline lanes."""
    lane = jnp.arange(W * H * spp)
    pid, sid = lane // spp, (lane % spp).astype(jnp.int32)
    sampler = JaxSampler(0, pid, sid)
    off = jax_sample_position("independent", sid, spp, sampler.next_2d())
    uv = jnp.stack([((pid % W).astype(jnp.float32) + off[:, 0]) / W,
                    ((pid // W).astype(jnp.float32) + off[:, 1]) / H], -1)
    return sampler, uv


def _assert_lanes_match(L, L_ref):
    close = np.isclose(L, L_ref, rtol=1e-4, atol=1e-6).all(axis=-1)
    assert close.mean() >= 0.99, close.mean()
    assert np.isfinite(L).all()
    assert abs(L.mean() - L_ref.mean()) <= 1e-3 * L_ref.mean()


def _port_lanes(jscene, spp):
    scene = from_jax_scene(jscene, device="cpu")
    ray, sampler, _ = camera_wavefront(scene, PathConfig(spp=spp),
                                       morton=False)
    return scene, ray, sampler


@pytest.mark.parametrize("mis", [True, False])
def test_volpath_matches_kernel_path_per_lane(kernel_path, mis):
    spp, depth = 2, 3
    jscene = jax_cornell_box(W, H)
    jmed = jax_make_homogeneous(**FOG)
    jcfg = JaxPathConfig(max_depth=depth, spp=spp, remat=False)

    @jax.jit
    def jax_lanes(scene, med):
        sampler, uv = _jax_camera(spp)
        return jax_volpath(scene, med, scene.camera.sample_ray(uv), sampler,
                           jcfg, mis=mis)

    L_ref, aux_ref = jax_lanes(jscene, jmed)
    scene, ray, sampler = _port_lanes(jscene, spp)
    L, aux = volpath_trace(scene, from_jax_medium(jmed), ray, sampler,
                           PathConfig(max_depth=depth, spp=spp), mis=mis)
    _assert_lanes_match(L.numpy(), np.asarray(L_ref))
    assert abs(float(aux["avg_path_length"])
               - float(aux_ref["avg_path_length"])) <= 0.02


@pytest.mark.parametrize("integrator", ["sorted_path", "direct"])
def test_brute_integrators_match_kernel_path_per_lane(kernel_path,
                                                      integrator):
    """Sorted brute bounces (the peeled first bounce through #2, then
    sorted #2 and #3) and the direct integrator (depth 2, fused #1)."""
    spp, depth = 2, 3
    jscene = jax_cornell_box(W, H)
    jcfg = JaxPathConfig(max_depth=depth, spp=spp, remat=False,
                         sort_rays=True)

    @jax.jit
    def jax_lanes(scene):
        sampler, uv = _jax_camera(spp)
        ray = scene.camera.sample_ray(uv)
        if integrator == "direct":
            return jax_direct_trace(scene, ray, sampler)
        return jax_path_trace(scene, ray, sampler, jcfg)

    L_ref, aux_ref = jax_lanes(jscene)
    scene, ray, sampler = _port_lanes(jscene, spp)
    if integrator == "direct":
        L, aux = direct_trace(scene, ray, sampler)
    else:
        L, aux = path_trace(scene, ray, sampler,
                            PathConfig(max_depth=depth, spp=spp,
                                       sort_rays=True))
    _assert_lanes_match(L.numpy(), np.asarray(L_ref))
    assert int(aux["rays_traced"]) == int(aux_ref["rays_traced"])


def _blocks(a, b=8):
    h, w, c = a.shape
    return a.reshape(h // b, b, w // b, b, c).mean(axis=(1, 3))


def test_render_volpath_passes_golden_gate():
    golden = np.load(GOLDEN)
    ref, ref_hi = golden["spp16"], golden["mean"]
    img, aux = render_volpath(cornell_box_cpu(64), make_homogeneous(**FOG),
                              PathConfig(max_depth=5, spp=16), seed=0)
    img = img.numpy()
    assert img.shape == ref.shape == (64, 64, 3) and np.isfinite(img).all()
    rb, ib = _blocks(ref), _blocks(img)
    rel = np.sqrt(np.mean((ib - rb) ** 2)) / rb.mean()
    assert rel <= 0.10, rel          # bench.py validate_golden
    # the image mean, against the 1,024-spp render: within 5%
    assert abs(img.mean() - ref_hi.mean()) <= 0.05 * ref_hi.mean()
    assert 1.0 < float(aux["avg_path_length"]) <= 5.0


def cornell_box_cpu(px):
    return scene_mod.cornell_box(px, px, device="cpu")


def test_render_volpath_is_deterministic_and_simple_differs():
    scene = cornell_box_cpu(8)
    med = make_homogeneous(**FOG)
    cfg = PathConfig(max_depth=4, spp=2)
    a, _ = render_volpath(scene, med, cfg, seed=3)
    b, _ = render_volpath(scene, med, cfg, seed=3)
    c, _ = render_volpath(scene, med, cfg, seed=3, mis=False)
    assert torch.equal(a, b) and not torch.equal(a, c)
    # with no medium (or one too thin to matter), volpath is the path
    # tracer's estimator: the same image mean within the noise
    thin = make_homogeneous((1e-12,) * 3, (0.0,) * 3)
    v, _ = render_volpath(cornell_box_cpu(16), thin,
                          PathConfig(max_depth=5, spp=8), seed=1)
    p, _ = render(cornell_box_cpu(16), PathConfig(max_depth=5, spp=8),
                  seed=1)
    assert abs(float(v.mean()) - float(p.mean())) <= 0.05 * float(p.mean())


def test_volpath_unported_options_raise():
    """The guide options run now (tests/test_torch_guiding.py holds them
    against the reference): without a guide, learn_guide and
    guide_sampling are no-ops, as in the reference (volpath.py:68-70). A
    phase kind the medium cannot evaluate raises: MICROFLAKE_GAUSS without
    its fitted coefficients, and an unknown kind."""
    from mitsuba_tpu_torch.integrators.volpath import scene_guide

    scene = cornell_box_cpu(4)
    med = make_homogeneous(**FOG)
    cfg = PathConfig(max_depth=2, spp=1)
    plain, _ = render_volpath(scene, med, cfg)
    for kw in (dict(learn_guide=True), dict(guide_sampling=True)):
        assert torch.equal(render_volpath(scene, med, cfg, **kw)[0], plain)
    _, aux = render_volpath(scene, med, cfg, guide=scene_guide(scene, 4),
                            learn_guide=True)
    img, _ = render_volpath(scene, med, cfg, guide=aux["guide"])
    assert bool(torch.isfinite(img).all())
    for kind in (4, 9):               # MICROFLAKE_GAUSS, unknown
        bad = make_homogeneous(**FOG)
        bad.phase_kind = kind
        with pytest.raises(ValueError):
            render_volpath(scene, bad, cfg)


@pytest.mark.parametrize("entry", ["cornell_box", "textured_mesh_scene",
                                   "instanced_scene", "SceneBuilder.build",
                                   "from_jax_scene"])
def test_scene_entry_points_default_to_the_card(entry, monkeypatch):
    """The default device is "cuda": without a CUDA device a call that
    does not ask for the CPU raises and never falls back to it."""
    import inspect

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if entry == "from_jax_scene":
        fn = from_jax_scene
        call = functools.partial(fn, jax_cornell_box(4, 4))
    elif entry == "SceneBuilder.build":
        fn = scene_mod.SceneBuilder.build
        b = scene_mod.SceneBuilder()
        b.materials.lambertian()
        b.add_area_emitter_shape(
            scene_mod.mesh_mod.make_quad([0, 0, 0], [1, 0, 0], [1, 1, 0],
                                         [0, 1, 0]), 0, (1.0,) * 3)
        call = b.build
    else:
        fn = getattr(scene_mod, entry)
        args = {"cornell_box": (4, 4), "textured_mesh_scene": (4, 4),
                "instanced_scene": (4, 4, 4, 8)}[entry]
        call = functools.partial(fn, *args)
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call(device="cuda:0")
    if entry in ("cornell_box", "SceneBuilder.build", "from_jax_scene"):
        assert call(device="cpu").device == torch.device("cpu")
