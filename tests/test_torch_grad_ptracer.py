"""Reverse-mode gradients of the particle tracer (integrators/ptracer.py):
its exact fixed-point splat as a `torch.autograd.Function` (the forward
unchanged, the backward a gather of the film's gradient), a checkpoint
a bounce under remat.

- Against the reference's `jax.grad` of `ptracer_render` at the size of
  tests/test_torch_ptracer.py (16 x 16 px, depth 3, 4,000 particles, seed
  3) on the Cornell box through its kernel path, with respect to the
  radiance and the reflectance: the loss within 1e-5 relative (the
  reference adds its splats in float32), each entry within 1e-5 of its
  table's largest (measured 0 and 1.7e-6).
- Linearity in emitter radiance: loss = <grad, radiance> within 1e-5.
- The image with grad enabled equals the image without, bit for bit, remat
  on and off; remat on against off within 1e-5 relative of each entry.
- The splat's backward against autograd of a float64 `index_add` on
  random contributions: equal.
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.core.types import replace as jax_replace
from mitsuba_tpu.integrators import ptracer as jpt
from mitsuba_tpu.integrators.path import PathConfig as JaxPathConfig
from mitsuba_tpu.render.scene import cornell_box as jax_cornell_box
from mitsuba_tpu_torch.integrators import ptracer
from mitsuba_tpu_torch.integrators.path import PathConfig
from mitsuba_tpu_torch.interop import from_jax_scene

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_grad_cases as gc  # noqa: E402
import torch_kernel_path as kp  # noqa: E402

torch.set_num_threads(1)
N_PARTICLES = 4000
SEED = 3
REF_RTOL = 1e-5


def _loss(scene, cfg, seed=SEED):
    return ptracer.ptracer_render(scene, cfg, N_PARTICLES, seed=seed)[0] \
        .mean()


def _cfg(remat=True):
    return PathConfig(max_depth=3, remat=remat)


@pytest.fixture(scope="module")
def reference_grad():
    """The reference's loss and jax.grad on its kernel path."""
    js = jax_cornell_box(16, 16)
    cfg = JaxPathConfig(max_depth=3, remat=False)

    def loss(rad, refl):
        sc = jax_replace(js, emitters=jax_replace(js.emitters, radiance=rad),
                         materials=jax_replace(js.materials,
                                               reflectance=refl))
        return jnp.mean(jpt.ptracer_render(sc, cfg, n_particles=N_PARTICLES,
                                           seed=SEED)[0])

    with pytest.MonkeyPatch.context() as mp:
        kp.kernel_path(mp, js.geom)
        val, (g_rad, g_refl) = jax.jit(jax.value_and_grad(loss, (0, 1)))(
            js.emitters.radiance, js.materials.reflectance)
    return (from_jax_scene(js, device="cpu"), float(val), np.asarray(g_rad),
            np.asarray(g_refl))


@pytest.mark.parametrize("remat", [False, True])
def test_gradient_matches_reference(reference_grad, remat):
    scene, val, g_rad, g_refl = reference_grad
    for (table, field), want in ((("emitters", "radiance"), g_rad),
                                 (("materials", "reflectance"), g_refl)):
        loss, g = gc.value_and_grad(_loss, scene, _cfg(remat), table, field,
                                    seed=SEED)
        assert np.isfinite(g.numpy()).all() and np.abs(want).max() > 0
        np.testing.assert_allclose(loss, val, rtol=1e-5)
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=REF_RTOL * np.abs(want).max(),
                                   err_msg=field)


def test_gradient_is_linear_in_radiance(reference_grad):
    scene = reference_grad[0]
    loss, g = gc.value_and_grad(_loss, scene, _cfg(), "emitters",
                                "radiance", seed=SEED)
    np.testing.assert_allclose(float((g * scene.emitters.radiance).sum()),
                               loss, rtol=1e-5)


@pytest.mark.parametrize("remat", [False, True])
def test_forward_with_grad_is_bit_equal(reference_grad, remat):
    scene = reference_grad[0]
    cfg = _cfg(remat)
    plain, _ = ptracer.ptracer_render(scene, cfg, N_PARTICLES, seed=SEED)
    assert not plain.requires_grad
    rad = scene.emitters.radiance.clone().requires_grad_(True)
    img, _ = ptracer.ptracer_render(gc.with_field(scene, "emitters",
                                                  radiance=rad),
                                    cfg, N_PARTICLES, seed=SEED)
    assert img.requires_grad
    assert torch.equal(img.detach(), plain)


def test_remat_gives_the_same_gradient(reference_grad):
    scene = reference_grad[0]
    grads = [gc.value_and_grad(_loss, scene, _cfg(remat), seed=SEED)[1]
             for remat in (False, True)]
    torch.testing.assert_close(grads[1], grads[0], rtol=gc.REMAT_RTOL,
                               atol=0)


def test_splat_backward_is_the_gather():
    rng = np.random.default_rng(1)
    n, pixels = 3000, 29
    pix = torch.from_numpy(rng.integers(0, pixels, n).astype(np.int32))
    c = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
    ok = torch.from_numpy(rng.uniform(size=n) < 0.7)
    w = torch.from_numpy(rng.normal(size=(pixels, 3)))
    grads = []
    for exact in (True, False):
        film = torch.zeros((pixels, 3), dtype=torch.float64,
                           requires_grad=True)
        x = c.clone().requires_grad_(True)
        if exact:
            out = ptracer.splat(film, pix, x, ok)
        else:
            out = film.index_add(0, pix.long(), torch.where(
                ok[:, None], x, 0.0).to(torch.float64))
        (out * w).sum().backward()
        grads.append((film.grad, x.grad))
    assert torch.equal(grads[0][0], grads[1][0])
    assert torch.equal(grads[0][1], grads[1][1])
    assert grads[0][1][~ok].abs().max() == 0


def test_splat_forward_is_unchanged_under_grad():
    rng = np.random.default_rng(2)
    pix = torch.from_numpy(rng.integers(0, 17, 500).astype(np.int32))
    c = torch.from_numpy(rng.lognormal(0, 2, (500, 3)).astype(np.float32))
    ok = torch.from_numpy(rng.uniform(size=500) < 0.9)
    film = torch.zeros((17, 3), dtype=torch.float64)
    a = ptracer.splat(film, pix, c.clone().requires_grad_(True), ok)
    assert a.requires_grad
    assert torch.equal(a.detach(), ptracer.splat(film, pix, c, ok))


def test_ptracer_refuses_a_gradient_through_the_camera(reference_grad):
    """The camera moves every connection ray: the kernels' wrappers
    refuse it, as in the path tracer."""
    scene = reference_grad[0]
    cam = scene.camera
    scene = dataclasses.replace(scene, camera=dataclasses.replace(
        cam, to_world=cam.to_world.clone().requires_grad_(True)))
    with pytest.raises(NotImplementedError):
        _loss(scene, _cfg())
