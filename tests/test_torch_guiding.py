"""The port's volumetric path guiding against the JAX package: the guide
grid's functions, volpath_trace's learning pass and its guided pass, and
render_volpath_guided.

- _cell_of and _bin_of: equal indices. guide_update's mass: within 1e-6
  of the largest bin (a scatter-add sums a bin's deposits in another
  order on each side; on the card in atomic order). guide_pdf and
  guide_sample given the same mass (from_jax_guide): rtol 1e-5 (XLA
  contracts the cumsum and the product rows differently in the last
  bits); the sampled bins equal on >= 99.9% of lanes.
- The learning pass, lane by lane against the reference's kernel path
  (#2 and #3 interpreted, as tests/test_torch_volpath.py runs them): >=
  99% of lanes within rtol 1e-4, the mean within 1e-3; the learned mass
  within 1e-4 of its largest bin.
- The guided pass on the reference's learned guide, carried across by
  from_jax_guide: lane by lane, as above.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba_tpu.render.intersect as jax_intersect
from mitsuba_tpu.integrators import guiding as jg
from mitsuba_tpu.integrators.path import PathConfig as JaxPathConfig
from mitsuba_tpu.integrators.volpath import volpath_trace as jax_volpath
from mitsuba_tpu.media import make_homogeneous as jax_make_homogeneous
from mitsuba_tpu.ops import intersect_pallas
from mitsuba_tpu.render.sampler import Sampler as JaxSampler
from mitsuba_tpu.render.sampler import sample_position as jax_sample_position
from mitsuba_tpu.render.scene import cornell_box as jax_cornell_box
from mitsuba_tpu_torch.integrators import (
    PathConfig, render_volpath, render_volpath_guided, volpath_trace,
)
from mitsuba_tpu_torch.integrators import guiding as tg
from mitsuba_tpu_torch.integrators.path import camera_wavefront
from mitsuba_tpu_torch.integrators.volpath import scene_guide
from mitsuba_tpu_torch.interop import (
    from_jax_guide, from_jax_medium, from_jax_scene,
)
from mitsuba_tpu_torch.media import make_homogeneous
from mitsuba_tpu_torch.render.scene import cornell_box
from tests.test_torch_hetero import assert_lanes_match

torch.set_num_threads(1)
FOG = dict(sigma_s=(0.0015,) * 3, sigma_a=(0.0003,) * 3, g=0.4)
W = H = 16
SPP, DEPTH, RES = 4, 4, 6


def _t(x):
    return torch.from_numpy(np.array(x))


def _guides(seed=0):
    """A JAX guide with random mass over the Cornell box, and the port's
    copy of it."""
    rng = np.random.default_rng(seed)
    jgd = jg.make_guide((-5, -5, -5), (560, 555, 565), res=RES)
    mass = rng.exponential(size=jgd.mass.shape).astype(np.float32)
    mass[rng.uniform(size=mass.shape[0]) < 0.2] = 0.0     # empty cells
    jgd = jg.GuideGrid(mass=jnp.asarray(mass), bmin=jgd.bmin, bmax=jgd.bmax,
                       res=RES)
    return jgd, from_jax_guide(jgd, device="cpu")


def _lanes(rng, n):
    p = rng.uniform(-20, 580, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return p, d


def test_guide_functions_match_reference():
    jgd, tgd = _guides(1)
    rng = np.random.default_rng(2)
    n = 5000
    p, d = _lanes(rng, n)
    np.testing.assert_array_equal(tg._cell_of(tgd, _t(p)).numpy(),
                                  np.asarray(jg._cell_of(jgd, p)))
    np.testing.assert_array_equal(tg._bin_of(_t(d)).numpy(),
                                  np.asarray(jg._bin_of(d)))
    normal = _lanes(rng, n)[1]
    for nrm in (None, normal):
        tn = None if nrm is None else _t(nrm)
        np.testing.assert_allclose(
            tg.guide_pdf(tgd, _t(p), _t(d), tn).numpy(),
            np.asarray(jg.guide_pdf(jgd, p, d, nrm)), rtol=1e-5, atol=1e-7)
        u2 = rng.uniform(0, 1, (n, 2)).astype(np.float32)
        ub = rng.uniform(0, 1, n).astype(np.float32)
        dt, pt, okt = tg.guide_sample(tgd, _t(p), _t(u2), _t(ub), tn)
        dj, pj, okj = jg.guide_sample(jgd, p, u2, ub, nrm)
        np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
        same = (tg._bin_of(dt).numpy() == np.asarray(jg._bin_of(dj)))
        assert same.mean() >= 0.999, same.mean()
        np.testing.assert_allclose(dt.numpy()[same], np.asarray(dj)[same],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(pt.numpy()[same], np.asarray(pj)[same],
                                   rtol=1e-5, atol=1e-7)
    rad = rng.exponential(size=n).astype(np.float32)
    act = rng.uniform(size=n) < 0.7
    mt = tg.guide_update(tgd, _t(p), _t(d), _t(rad), _t(act)).mass
    mj = np.asarray(jg.guide_update(jgd, p, d, rad, act).mass)
    np.testing.assert_allclose(mt.numpy(), mj, rtol=0,
                               atol=1e-6 * float(mj.max()))


def test_scene_guide_box_equals_reference():
    jscene = jax_cornell_box(W, H)
    v0 = np.asarray(jscene.geom.v0)
    ext = v0.max(0) - v0.min(0)
    ref = jg.make_guide(v0.min(0) - 0.01 * ext, v0.max(0) + 0.01 * ext,
                        res=RES)
    got = scene_guide(from_jax_scene(jscene, device="cpu"), res=RES)
    np.testing.assert_array_equal(got.bmin.numpy(), np.asarray(ref.bmin))
    np.testing.assert_array_equal(got.bmax.numpy(), np.asarray(ref.bmax))
    assert got.mass.shape == ref.mass.shape and float(got.mass.sum()) == 0


@pytest.fixture(scope="module")
def reference_passes():
    """The reference's learning pass (seed 0) and guided pass (seed 7507)
    at 16x16 px, 4 spp, depth 4 through its kernel path."""
    jscene = jax_cornell_box(W, H)
    jmed = jax_make_homogeneous(**FOG)
    v0 = np.asarray(jscene.geom.v0)
    ext = v0.max(0) - v0.min(0)
    guide0 = jg.make_guide(v0.min(0) - 0.01 * ext, v0.max(0) + 0.01 * ext,
                           res=RES)
    jcfg = JaxPathConfig(max_depth=DEPTH, spp=SPP, remat=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_intersect, "_use_pallas", lambda: True)
        mp.setattr(intersect_pallas, "_UNROLL_LIMIT", 0)
        for name in ("closest_hit_shaded", "any_hit"):
            mp.setattr(intersect_pallas, name, functools.partial(
                getattr(intersect_pallas, name), interpret=True))

        def lanes(scene, med, guide, seed, learn):
            lane = jnp.arange(W * H * SPP)
            pid, sid = lane // SPP, (lane % SPP).astype(jnp.int32)
            sampler = JaxSampler(seed, pid, sid)
            off = jax_sample_position("independent", sid, SPP,
                                      sampler.next_2d())
            uv = jnp.stack([((pid % W).astype(jnp.float32) + off[:, 0]) / W,
                            ((pid // W).astype(jnp.float32) + off[:, 1])
                            / H], -1)
            return jax_volpath(scene, med, scene.camera.sample_ray(uv),
                               sampler, jcfg, seed=seed, guide=guide,
                               learn_guide=learn)

        L1, aux1 = jax.jit(functools.partial(lanes, seed=0, learn=True))(
            jscene, jmed, guide0)
        guide = aux1["guide"]
        L2, _ = jax.jit(functools.partial(lanes, seed=7507, learn=False))(
            jscene, jmed, guide)
    return jscene, jmed, np.asarray(L1), guide, np.asarray(L2)


def test_learning_pass_matches_kernel_path(reference_passes):
    jscene, jmed, L_ref, guide_ref, _ = reference_passes
    scene = from_jax_scene(jscene, device="cpu")
    cfg = PathConfig(max_depth=DEPTH, spp=SPP)
    ray, sampler, _ = camera_wavefront(scene, cfg, seed=0, morton=False)
    L, aux = volpath_trace(scene, from_jax_medium(jmed), ray, sampler, cfg,
                           seed=0, guide=scene_guide(scene, RES),
                           learn_guide=True)
    assert_lanes_match(L.numpy(), L_ref)
    ref_mass = np.asarray(guide_ref.mass)
    assert ref_mass.max() > 0
    np.testing.assert_allclose(aux["guide"].mass.numpy(), ref_mass, rtol=0,
                               atol=1e-4 * float(ref_mass.max()))
    # learning changes nothing in the image: it is the unguided render's
    plain, _ = volpath_trace(scene, from_jax_medium(jmed), *camera_wavefront(
        scene, cfg, seed=0, morton=False)[:2], cfg, seed=0)
    assert torch.equal(plain, L)


def test_guided_pass_matches_kernel_path(reference_passes):
    jscene, jmed, _, guide_ref, L_ref = reference_passes
    scene = from_jax_scene(jscene, device="cpu")
    cfg = PathConfig(max_depth=DEPTH, spp=SPP)
    ray, sampler, _ = camera_wavefront(scene, cfg, seed=7507, morton=False)
    L, _ = volpath_trace(scene, from_jax_medium(jmed), ray, sampler, cfg,
                         seed=7507, guide=from_jax_guide(guide_ref, "cpu"))
    assert_lanes_match(L.numpy(), L_ref)
    # the guide moved the estimate: the unguided lanes differ
    plain, _ = volpath_trace(scene, from_jax_medium(jmed), *camera_wavefront(
        scene, cfg, seed=7507, morton=False)[:2], cfg, seed=7507)
    assert not torch.equal(plain, L)


def test_render_volpath_guided_composes_its_passes():
    """render_volpath_guided is the spp-weighted mean of a learning render
    and a guided render from seed + 7507 on the learned guide; with
    learn_frac 1 it is the learning pass alone, with the guide in aux."""
    scene = cornell_box(16, 16, device="cpu")
    med = make_homogeneous(**FOG)
    cfg = PathConfig(max_depth=3, spp=4)
    img, aux = render_volpath_guided(scene, med, cfg, seed=2, res=RES)
    a, aux_a = render_volpath(scene, med, PathConfig(max_depth=3, spp=2),
                              seed=2, guide=scene_guide(scene, RES),
                              learn_guide=True)
    b, _ = render_volpath(scene, med, PathConfig(max_depth=3, spp=2),
                          seed=2 + 7507, guide=aux_a["guide"])
    assert torch.allclose(img, (a * 2 + b * 2) / 4, rtol=1e-6, atol=0)
    only, aux1 = render_volpath_guided(scene, med, cfg, seed=2,
                                       learn_frac=1.0, res=RES)
    assert "guide" in aux1 and float(aux1["guide"].mass.sum()) > 0
    assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0
