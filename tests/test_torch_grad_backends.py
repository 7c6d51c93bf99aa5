"""Reverse-mode material and emitter gradients off the brute backend: the
bvh kernel (#11), the cluster backend's exact cull and walks (#5, #6, #7
on the CPU's v5 walk, #10) and the instanced walks (#12, #11), through
`render` and `path_trace`, with and without a checkpoint a bounce (whose
backward re-runs the Morton sort, the exact cull and the instance walks).

Scenes: tests/torch_grad_cases.py `mesh_scene` (tests/test_torch_grad.py's
`_small_mesh_scene` on a floor) at 16 x 16 on bvh and cluster, and
`instanced_scene(4, 4, 4, 8)`; 2 spp, depth 3. The loss is bench.py
bench_backward's, the mean of L.

- Central differences on three reflectance entries (eps 2e-3), within
  2e-2 relative (tests/test_grad.py).
- Linearity in emitter radiance: loss = <grad, radiance> within 1e-4.
- A checkpoint a bounce against none, through `render`: within 1e-5
  relative of each entry (measured: equal).
- The same mesh on bvh and on cluster: the gradients within 1e-5 of the
  largest entry (the same hits; the cluster render sums Morton lanes).
- The reference's `jax.grad` on bvh (its CPU queries; the hit records
  are constants in both), reflectance and radiance: the loss within 1e-5
  relative, each entry within 1e-5 of the largest (REF_RTOL of
  tests/test_torch_grad.py; measured 7e-8 and 1.7e-7).
"""
import os
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.core import transform as jtf
from mitsuba_tpu.core.types import replace as jax_replace
from mitsuba_tpu.integrators.path import PathConfig as JaxPathConfig
from mitsuba_tpu.integrators.path import render as jax_render
from mitsuba_tpu.render import mesh as jmesh
from mitsuba_tpu.render.camera import make_perspective as j_persp
from mitsuba_tpu.render.scene import SceneBuilder as JaxSceneBuilder
from mitsuba_tpu_torch.integrators.path import PathConfig, render
from mitsuba_tpu_torch.interop import from_jax_scene
from mitsuba_tpu_torch.render.scene import instanced_scene

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_grad_cases as gc  # noqa: E402

torch.set_num_threads(1)
RES = 16
REF_RTOL = 1e-5
JAX = SimpleNamespace(SceneBuilder=JaxSceneBuilder, mesh=jmesh,
                      look_at=jtf.look_at, make_perspective=j_persp)
BACKENDS = ["bvh", "cluster", "instanced"]
# reflectance entries with light on them: the sphere and the floor (the
# instanced scene: the floor and the instances)
ENTRIES = [(0, 0), (1, 1), (1, 2)]


def _cfg(remat=True):
    return PathConfig(max_depth=3, spp=2, remat=remat)


def _scene(backend):
    if backend == "instanced":
        return instanced_scene(4, 4, 4, 8, device="cpu")
    return gc.mesh_scene(gc.port_modules(), RES, backend, device="cpu")


def _render_loss(scene, cfg, seed=0):
    return render(scene, cfg, seed=seed)[0].mean()


@pytest.fixture(scope="module")
def scenes():
    out = {b: _scene(b) for b in BACKENDS}
    assert out["bvh"].geom.backend == "bvh"
    assert out["cluster"].geom.backend == "cluster"
    assert out["instanced"].geom.inst_groups
    return out


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("backend", BACKENDS)
def test_path_trace_gradient_matches_fd(scenes, backend, remat):
    scene = scenes[backend]
    cfg = _cfg(remat)
    _, g = gc.value_and_grad(gc.mean_l, scene, cfg)
    assert torch.isfinite(g).all() and g.abs().max() > 0
    for r in gc.central_differences(gc.mean_l, scene, cfg, g, ENTRIES):
        assert r["rel"] < gc.FD_RTOL, r


@pytest.mark.parametrize("backend", BACKENDS)
def test_render_gradient_is_linear_in_radiance(scenes, backend):
    scene = scenes[backend]
    loss, g = gc.value_and_grad(_render_loss, scene, _cfg(), "emitters",
                                "radiance")
    assert torch.isfinite(g).all() and g.abs().max() > 0
    np.testing.assert_allclose(
        float((g * scene.emitters.radiance).sum()), loss, rtol=gc.LIN_RTOL)


@pytest.mark.parametrize("backend", BACKENDS)
def test_render_remat_gives_the_same_gradient(scenes, backend):
    scene = scenes[backend]
    l0, g0 = gc.value_and_grad(_render_loss, scene, _cfg(False))
    l1, g1 = gc.value_and_grad(_render_loss, scene, _cfg(True))
    assert l0 == l1
    torch.testing.assert_close(g1, g0, rtol=gc.REMAT_RTOL, atol=0)


def test_bvh_and_cluster_gradients_agree(scenes):
    for table, field in (("materials", "reflectance"),
                         ("emitters", "radiance")):
        grads = [gc.value_and_grad(_render_loss, scenes[b], _cfg(), table,
                                   field)[1] for b in ("bvh", "cluster")]
        np.testing.assert_allclose(
            grads[1].numpy(), grads[0].numpy(), rtol=0,
            atol=REF_RTOL * float(grads[0].abs().max()))


@pytest.fixture(scope="module")
def reference_grad():
    """The reference's loss and jax.grad of `mesh_scene` on bvh, with
    respect to the reflectance and the radiance."""
    js = gc.mesh_scene(JAX, RES, "bvh")
    jcfg = JaxPathConfig(max_depth=3, spp=2, remat=False)

    def loss(refl, rad):
        sc = jax_replace(js, materials=jax_replace(js.materials,
                                                   reflectance=refl),
                         emitters=jax_replace(js.emitters, radiance=rad))
        return jnp.mean(jax_render(sc, jcfg, seed=0)[0])

    val, (g_refl, g_rad) = jax.jit(jax.value_and_grad(loss, (0, 1)))(
        js.materials.reflectance, js.emitters.radiance)
    return js, float(val), np.asarray(g_refl), np.asarray(g_rad)


@pytest.mark.parametrize("remat", [False, True])
def test_bvh_gradient_matches_reference(scenes, reference_grad, remat):
    js, val, g_refl, g_rad = reference_grad
    scene = scenes["bvh"]
    conv = from_jax_scene(js, device="cpu")
    assert torch.equal(scene.materials.reflectance,
                       conv.materials.reflectance)
    assert torch.equal(scene.geom.v0, conv.geom.v0)
    for (table, field), want in ((("materials", "reflectance"), g_refl),
                                 (("emitters", "radiance"), g_rad)):
        loss, g = gc.value_and_grad(_render_loss, scene, _cfg(remat), table,
                                    field)
        np.testing.assert_allclose(loss, val, rtol=1e-5)
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=REF_RTOL * np.abs(want).max())
