"""The port's particle tracer (integrators/ptracer.py) against the JAX
package's (mitsuba_tpu/integrators/ptracer.py).

(a) `ptracer_render` at 16 x 16 px, depth 3, 4,000 particles, seed 3, on
    the Cornell box (an area light) and on a scene of point, spot and
    sphere lights, against the reference's image through its kernel path
    (tests/torch_kernel_path.py: the port's brute backend builds the
    kernel path's shading frame): each pixel within 1e-4 relative and
    1e-5 absolute. The reference adds each bounce's splats in float32 in
    its scatter's order; the port adds them exactly (64-bit fixed point),
    so the two differ by the reference's float32 rounding alone.
(b) The emission samples lane by lane (the sampled-direction tolerances
    of tests/test_torch_emitters.py).
(c) The JAX package's two tests (tests/test_ptracer.py) on the port:
    light tracing against path tracing (the mean within 6%, the
    correlation of the pixels over 0.9), and two runs giving equal
    images.
(d) The splat does not depend on the order of its adds.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.core import transform as jtf
from mitsuba_tpu.integrators import ptracer as jpt
from mitsuba_tpu.integrators.path import PathConfig as JaxPathConfig
from mitsuba_tpu.render import mesh as jmesh
from mitsuba_tpu.render.camera import make_perspective as j_persp
from mitsuba_tpu.render.sampler import Sampler as JaxSampler
from mitsuba_tpu.render.scene import SceneBuilder as JaxSceneBuilder
from mitsuba_tpu.render.scene import cornell_box as jax_cornell_box
from mitsuba_tpu_torch.integrators import ptracer
from mitsuba_tpu_torch.integrators.path import PathConfig, render
from mitsuba_tpu_torch.interop import from_jax_scene
from mitsuba_tpu_torch.render.sampler import Sampler
from mitsuba_tpu_torch.render.scene import cornell_box

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_kernel_path as kp  # noqa: E402

torch.set_num_threads(1)


def light_scene(w=16, h=16):
    """A floor and a block under a point, a spot and a sphere light (the
    kinds ptracer emits from besides area triangles)."""
    b = JaxSceneBuilder()
    white = b.materials.lambertian((0.7, 0.7, 0.7))
    red = b.materials.lambertian((0.7, 0.2, 0.1))
    quad = jmesh.make_quad
    b.add_shape(quad([-4, 0, -4], [-4, 0, 4], [4, 0, 4], [4, 0, -4]), white)
    b.add_shape(jmesh.make_box([-0.8, 0, -0.5], [0.2, 1.2, 0.5]), red)
    b.add_sphere_emitter([1.0, 1.8, 0.0], 0.3, white, (6.0, 5.0, 4.0))
    b.emitters.point((-1.5, 2.0, -0.5), (10.0, 10.0, 10.0))
    b.emitters.spot((0.5, 3.0, -1.5), (0.0, -1.0, 0.4), (30.0,) * 3,
                    cutoff_deg=35.0)
    b.set_camera(j_persp(jtf.look_at([0, 2.5, -5], [0, 0.6, 0], [0, 1, 0]),
                         45, w / h), w, h)
    return b.build(backend="brute")


CASES = {"cornell": lambda: jax_cornell_box(16, 16), "lights": light_scene}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """The reference's image through its kernel path, and the scene."""
    mp = pytest.MonkeyPatch()
    try:
        js = CASES[request.param]()
        kp.kernel_path(mp, js.geom)
        img, _ = jpt.ptracer_render(js, JaxPathConfig(max_depth=3,
                                                      remat=False),
                                    n_particles=4000, seed=3)
        img = np.asarray(img)
    finally:
        mp.undo()
    return js, from_jax_scene(js, device="cpu"), img


def test_image_matches_reference(case):
    _js, scene, ref = case
    img, aux = ptracer.ptracer_render(scene, PathConfig(max_depth=3), 4000,
                                      seed=3)
    assert aux["n_particles"] == 4000 and img.dtype == torch.float32
    assert float(img.mean()) > 0
    np.testing.assert_allclose(img.numpy(), ref, rtol=1e-4, atol=1e-5)


def test_emission_matches_reference(case):
    js, scene, _ref = case
    n = 4000
    js_s = JaxSampler(3, jnp.arange(n), jnp.zeros(n, jnp.int32))
    ju = [js_s.next_1d(), js_s.next_2d(), js_s.next_2d()]
    ts = Sampler(3, torch.arange(n, dtype=torch.int32),
                 torch.zeros(n, dtype=torch.int32))
    tu = [ts.next_1d(), ts.next_2d(), ts.next_2d()]
    for a, b in zip(ju, tu):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    ref = jax.jit(lambda *u: jpt._sample_emission(js, *u))(*ju)
    got = ptracer._sample_emission(scene, *tu)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(ref[4]))
    for a, b in zip(got[:4], ref[:4]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3,
                                   atol=1e-4)
        ok = np.isclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5)
        assert ok.reshape(n, -1).all(-1).mean() >= 0.999


def test_ptracer_matches_path_tracer():
    """tests/test_ptracer.py:11 on the port."""
    scene = cornell_box(24, 24, device="cpu")
    a = render(scene, PathConfig(max_depth=4, spp=48, remat=False),
               seed=0)[0].numpy()
    b = ptracer.ptracer_render(scene, PathConfig(max_depth=4, remat=False),
                               n_particles=400_000, seed=1)[0].numpy()
    assert np.isfinite(b).all()
    assert abs(a.mean() - b.mean()) / a.mean() < 0.06, (a.mean(), b.mean())
    corr = np.corrcoef(a.mean(-1).ravel(), b.mean(-1).ravel())[0, 1]
    assert corr > 0.9, corr


def test_ptracer_deterministic():
    """tests/test_ptracer.py:32 on the port."""
    scene = cornell_box(12, 12, device="cpu")
    cfg = PathConfig(max_depth=3, remat=False)
    i1, _ = ptracer.ptracer_render(scene, cfg, n_particles=20_000, seed=7)
    i2, _ = ptracer.ptracer_render(scene, cfg, n_particles=20_000, seed=7)
    assert torch.equal(i1, i2)


def test_splat_is_order_free():
    """The fixed-point splat gives the same bits for any order of its
    adds, and the sum within float64 rounding of the exact one."""
    rng = np.random.default_rng(0)
    n, pixels = 5000, 37
    pix = torch.from_numpy(rng.integers(0, pixels, n).astype(np.int32))
    c = torch.from_numpy((rng.lognormal(0, 3, (n, 3))
                          * rng.choice([1, -1], (n, 3))).astype(np.float32))
    ok = torch.from_numpy(rng.uniform(size=n) < 0.8)
    film = torch.zeros((pixels, 3), dtype=torch.float64)
    a = ptracer.splat(film, pix, c, ok)
    perm = torch.from_numpy(rng.permutation(n))
    b = ptracer.splat(film, pix[perm], c[perm], ok[perm])
    assert torch.equal(a, b)
    want = np.zeros((pixels, 3))
    np.add.at(want, pix.numpy()[ok.numpy()],
              c.numpy()[ok.numpy()].astype(np.float64))
    np.testing.assert_allclose(a.numpy(), want, rtol=1e-9,
                               atol=1e-12 * np.abs(c.numpy()).max() * n)
    assert torch.equal(ptracer.splat(film, pix, c, torch.zeros_like(ok)),
                       film)
