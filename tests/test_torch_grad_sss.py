"""Reverse-mode gradients of a subsurface scene: through the irradiance
cache (its NEE through #3 and its indirect `path_trace` passes through
#1), the dense dipole gather `scene_ss_lo` and the compaction of the
slab's lanes, for the dipole, multipole and adipole profiles.

Scenes: tests/torch_sss_cases.py `slab_scene` (tests/golden_scenes.py:144's
slab) with 64 points an entry.

- Against the reference's `jax.grad` of the slab at 16 x 16, 2 spp,
  depth 3, seed 3, on its kernel path (tests/torch_kernel_path.py: the
  kernels' plain references behind stop_gradient), with respect to the
  reflectance, the radiance and the entry's sigma_tr, alpha_p, zri and
  zvi: the cache filled inside the loss by `compute_irradiance` (2 NEE
  samples, one indirect pass of depth 2: the reference's compile of the
  default cache takes twice as long), then `path_trace`. The loss within
  1e-6 relative, each entry within 1e-4 of its table's largest (the
  lanes sum 256-point chunks in another order; measured <= 4.1e-6).
- Through `render` at 8 x 8, 2 spp, depth 3, the cache filled by render
  at its seed inside the gradient: linearity in emitter radiance (the
  cache and the gather are linear in it) within 1e-5; central
  differences on sigma_tr and alpha_p (eps 1e-3 of the value) within
  2e-2 relative; a checkpoint a bounce against none within 1e-5.
- `_gather`'s backward (a checkpoint a block of lanes against a chunk of
  points) against plain autograd of the same sums, on a tiny case with
  ragged blocks: every input's gradient within 1e-5 relative.
- The host-side hierarchical gather refuses tensors that require grad.
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

from mitsuba_tpu.core import track as jtrack
from mitsuba_tpu.core import transform as jtf
from mitsuba_tpu.core.types import replace as jax_replace
from mitsuba_tpu.integrators.path import PathConfig as JaxPathConfig
from mitsuba_tpu.integrators.path import path_trace as jax_path_trace
from mitsuba_tpu.render import mesh as jmesh
from mitsuba_tpu.render.camera import make_perspective as jpersp
from mitsuba_tpu.render.sampler import Sampler as JaxSampler
from mitsuba_tpu.render.scene import SceneBuilder as JaxSceneBuilder
from mitsuba_tpu.subsurface import dipole as jd
from mitsuba_tpu_torch.integrators.path import (
    PathConfig, camera_wavefront, path_trace, render,
)
from mitsuba_tpu_torch.interop import from_jax_scene
from mitsuba_tpu_torch.subsurface import dipole as td

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_grad_cases as gc  # noqa: E402
import torch_sss_cases as sc  # noqa: E402
from torch_kernel_path import kernel_path, lanes  # noqa: E402

torch.set_num_threads(1)
JMODS = SimpleNamespace(SceneBuilder=JaxSceneBuilder, mesh=jmesh,
                        look_at=jtf.look_at, track=jtrack,
                        make_perspective=jpersp)
PROFILES = sorted(sc.PROFILES)
K = 64
W = 16
SPP = 2
SEED = 3
REF_RTOL = 1e-4
# (table, field) of each gradient held against the reference
FIELDS = (("materials", "reflectance"), ("emitters", "radiance"),
          ("subsurface", "sigma_tr"), ("subsurface", "alpha_p"),
          ("subsurface", "zri"), ("subsurface", "zvi"))
CACHE = dict(n_samples=2, seed=SEED, indirect_depth=2, n_indirect=1)


def _with_all(scene, xs, replace):
    """The scene with each FIELDS entry replaced by xs[i]."""
    tables = {}
    for (table, field), x in zip(FIELDS, xs):
        tables.setdefault(table, {})[field] = x
    return replace(scene, **{t: replace(getattr(scene, t), **f)
                             for t, f in tables.items()})


def _port_loss(scene):
    """The cache filled inside the loss, then the slab's lanes."""
    ss = scene.subsurface
    irr = td.compute_irradiance(scene, ss.points.reshape(-1, 3),
                                ss.normals.reshape(-1, 3), **CACHE)
    scene = dataclasses.replace(scene, subsurface=dataclasses.replace(
        ss, irradiance=irr.reshape(ss.points.shape)))
    cfg = PathConfig(max_depth=3, spp=SPP)
    ray, sampler, _ = camera_wavefront(scene, cfg, seed=SEED, morton=False)
    return path_trace(scene, ray, sampler, cfg)[0].mean()


@pytest.fixture(scope="module", params=PROFILES)
def reference_grad(request):
    """The reference's slab under one profile, its loss and its jax.grad
    of every FIELDS entry."""
    js = sc.slab_scene(JMODS, W, request.param, n_points=K)
    cfg = JaxPathConfig(max_depth=3, spp=SPP, remat=False)

    def loss(*xs):
        scene = _with_all(js, xs, lambda t, **kw: (
            dataclasses.replace(t, **kw) if hasattr(t, "mat_ss")
            else jax_replace(t, **kw)))
        ss = scene.subsurface
        irr = jd.compute_irradiance(scene, ss.points.reshape(-1, 3),
                                    ss.normals.reshape(-1, 3), **CACHE)
        scene = jax_replace(scene, subsurface=dataclasses.replace(
            ss, irradiance=irr.reshape(ss.points.shape)))
        pid, sid, px, py = lanes(W, W, SPP, jnp)
        sampler = JaxSampler(SEED, pid, sid)
        off = sampler.next_2d()
        uv = jnp.stack([(px + off[:, 0]) / W, (py + off[:, 1]) / W], -1)
        return jnp.mean(jax_path_trace(scene, scene.camera.sample_ray(uv),
                                       sampler, cfg)[0])

    x0 = [getattr(getattr(js, t), f) for t, f in FIELDS]
    with pytest.MonkeyPatch.context() as mp:
        kernel_path(mp, js.geom)
        val, grads = jax.jit(jax.value_and_grad(
            loss, tuple(range(len(FIELDS)))))(*x0)
    return js, float(val), [np.asarray(g) for g in grads]


def test_slab_gradient_matches_reference(reference_grad):
    js, val, want = reference_grad
    scene = from_jax_scene(js, device="cpu")
    xs = [getattr(getattr(scene, t), f).clone().requires_grad_(True)
          for t, f in FIELDS]
    loss = _port_loss(_with_all(scene, xs, dataclasses.replace))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), val, rtol=1e-6)
    for (table, field), x, w in zip(FIELDS, xs, want):
        g = x.grad.numpy()
        assert np.isfinite(g).all() and np.abs(w).max() > 0, field
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=REF_RTOL * np.abs(w).max(),
                                   err_msg=field)


def _slab(profile, res=8):
    return sc.slab_scene(sc.port_modules(), res, profile, n_points=K,
                         device="cpu")


def _render_loss(scene, cfg, seed=SEED):
    return render(scene, cfg, seed=seed)[0].mean()


CFG = PathConfig(max_depth=3, spp=2)


@pytest.mark.parametrize("profile", PROFILES)
def test_render_gradient_is_linear_in_radiance(profile):
    scene = _slab(profile)
    assert scene.subsurface.irradiance is None
    loss, g = gc.value_and_grad(_render_loss, scene, CFG, "emitters",
                                "radiance")
    assert torch.isfinite(g).all() and g.abs().max() > 0
    np.testing.assert_allclose(
        float((g * scene.emitters.radiance).sum()), loss, rtol=1e-5)


@pytest.mark.parametrize("profile", PROFILES)
def test_render_gradient_matches_fd_in_the_profile(profile):
    scene = _slab(profile)
    for field in ("sigma_tr", "alpha_p"):
        x0 = getattr(scene.subsurface, field)
        _, g = gc.value_and_grad(_render_loss, scene, CFG, "subsurface",
                                 field, seed=SEED)
        assert torch.isfinite(g).all() and g.abs().max() > 0, field
        for c in range(3):
            eps = 1e-3 * float(x0[0, c])
            r, = gc.central_differences(_render_loss, scene, CFG, g,
                                        [(0, c)], "subsurface", field, eps,
                                        seed=SEED)
            assert r["rel"] < gc.FD_RTOL, (field, r)


@pytest.mark.parametrize("profile", PROFILES)
def test_render_remat_gives_the_same_gradient(profile):
    scene = _slab(profile)
    grads = []
    for remat in (False, True):
        cfg = dataclasses.replace(CFG, remat=remat)
        grads.append([gc.value_and_grad(_render_loss, scene, cfg, t, f)[1]
                      for t, f in FIELDS[:4]])
    for (_, field), a, b in zip(FIELDS, *grads):
        torch.testing.assert_close(b, a, rtol=gc.REMAT_RTOL, atol=0,
                                   msg=field)


def _gather_inputs(aniso):
    """A tiny gather: 37 lanes against 2 chunks of 8 points, 3 pole
    pairs, every input requiring grad."""
    rng = np.random.default_rng(5)

    def t(*shape, lo=0.0, hi=1.0):
        return torch.from_numpy(rng.uniform(lo, hi, shape).astype(
            np.float32)).requires_grad_(True)

    x = t(37, 3, lo=-1, hi=1)
    pts = t(2, 8, 3, lo=-1, hi=1)
    irr = t(2, 8, 3, lo=0.1, hi=2)
    adir = torch.tensor([0.6, 0.0, 0.8], requires_grad=True)
    ratio = torch.tensor(3.0 if aniso else 1.0, requires_grad=True)
    zri = t(3, 3, lo=0.1, hi=0.8)
    zvi = t(3, 3, lo=-1.5, hi=-0.2)
    sigma_tr = t(3, lo=0.2, hi=2)
    alpha_p = t(3, lo=0.5, hi=1)
    return [x, pts, irr, adir, ratio, zri, zvi, sigma_tr, alpha_p]


@pytest.mark.parametrize("aniso", [False, True])
def test_blockwise_backward_equals_autograd(aniso):
    grads = []
    for blockwise in (True, False):
        xs = _gather_inputs(aniso)
        x, pts, irr, adir, ratio, *prof = xs
        stretch = 1.0 / (ratio * ratio) - 1.0
        if blockwise:
            mo = td._gather(6, x, pts, irr, adir, stretch, *prof)
        else:
            mo = sum(td._chunk_rd_sum(x, cp, ce, adir, stretch, *prof)
                     for cp, ce in zip(pts, irr))
        w = torch.from_numpy(np.random.default_rng(6).uniform(
            0.5, 1.5, mo.shape).astype(np.float32))
        (mo * w).sum().backward()
        grads.append([v.grad for v in xs])
    for k, (a, b) in enumerate(zip(*grads)):
        # an isotropic metric (stretch 0) gives aniso_dir no gradient
        assert torch.isfinite(a).all() and (
            b.abs().max() > 0 or (k == 3 and not aniso)), k
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * float(
            b.abs().max()), msg=str(k))


def test_blockwise_forward_is_unchanged():
    """The gather's forward under grad gives the bits it gives without."""
    xs = _gather_inputs(True)
    x, pts, irr, adir, ratio, *prof = xs
    stretch = 1.0 / (ratio * ratio) - 1.0
    a = td._gather(6, x, pts, irr, adir, stretch, *prof)
    with torch.no_grad():
        b = td._gather(6, x, pts, irr, adir, stretch, *prof)
        c = td._gather(64, x, pts, irr, adir, stretch, *prof)
    assert torch.equal(a, b) and torch.equal(a, c)


def test_hierarchical_gather_refuses_grad():
    ss = dataclasses.replace(
        _slab("dipole", 4).subsurface,
        irradiance=torch.ones((1, K, 3), requires_grad=True))
    with pytest.raises(ValueError, match="no gradient"):
        td.scene_ss_lo_hier(ss, 0, np.zeros((1, 3)), np.ones(1))
