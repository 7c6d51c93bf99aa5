"""The port's virtual point lights (mitsuba_tpu_torch/integrators/vpl.py)
against the JAX package's, on `cornell_box(16, 16)` with the reference on
its kernel path (tests/torch_kernel_path.py).

- `generate_vpls`, 32 paths, depth 3, seed 0: tests/test_vpl.py:10's
  structure (32 luminaire VPLs on the light, then 3 x 32 surface VPLs,
  finite non-negative flux), the flags and material ids equal, directions
  within 1e-5 and flux within 1e-5 relative; on the valid VPLs positions
  within 1e-5 of the box's size (556) and normals within 1e-5 (a dead
  walk's record holds a miss).
- `render_vpl`, 16 paths, depth 2, 2 spp, seed 1: every pixel within
  1e-4 relative (1e-6 absolute); two runs equal (tests/test_vpl.py:48).
- tests/test_vpl.py:26 on the port: the VPL image's mean within 35% of
  the path tracer's at 128 paths.
"""
import numpy as np
import pytest
import torch

from mitsuba_tpu.integrators import vpl as jvpl
from mitsuba_tpu.integrators.path import PathConfig as JaxPathConfig
from mitsuba_tpu.render.scene import cornell_box as jax_cornell_box
from mitsuba_tpu_torch.integrators import vpl
from mitsuba_tpu_torch.integrators.path import PathConfig, render
from mitsuba_tpu_torch.interop import from_jax_scene
from mitsuba_tpu_torch.render.scene import cornell_box
from tests import torch_kernel_path as kp

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def reference():
    mp = pytest.MonkeyPatch()
    try:
        js = jax_cornell_box(16, 16)
        kp.kernel_path(mp, js.geom)
        vs = jvpl.generate_vpls(js, n_paths=32, max_depth=3, seed=0)
        img, _ = jvpl.render_vpl(js, JaxPathConfig(max_depth=2, spp=2,
                                                   remat=False),
                                 n_paths=16, vpl_depth=2, seed=1)
        yield dict(scene=js, vpls=vs, img=np.asarray(img))
    finally:
        mp.undo()


def test_generate_vpls_matches_reference(reference):
    scene = from_jax_scene(reference["scene"], device="cpu")
    vs = vpl.generate_vpls(scene, n_paths=32, max_depth=3, seed=0)
    ref = reference["vpls"]
    v = 32 * (1 + 3)
    assert vs.p.shape == (v, 3)
    assert bool(vs.is_lum[:32].all()) and not bool(vs.is_lum[32:].any())
    assert (vs.p[:32, 1].numpy() > 540).all()
    fl = vs.flux.numpy()
    assert np.isfinite(fl).all() and (fl[vs.valid.numpy()] >= 0).all()
    for f in ("material_id", "is_lum", "valid"):
        np.testing.assert_array_equal(getattr(vs, f).numpy(),
                                      np.asarray(getattr(ref, f)), f)
    ok = np.asarray(ref.valid)
    np.testing.assert_allclose(vs.p.numpy()[ok], np.asarray(ref.p)[ok],
                               rtol=0, atol=1e-5 * 556)
    np.testing.assert_allclose(vs.n.numpy()[ok], np.asarray(ref.n)[ok],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(vs.d_in.numpy(), np.asarray(ref.d_in),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(fl, np.asarray(ref.flux), rtol=1e-5)
    assert float(vs.n_paths) == float(ref.n_paths)


def test_render_matches_reference(reference):
    scene = from_jax_scene(reference["scene"], device="cpu")
    cfg = PathConfig(max_depth=2, spp=2)
    img, _ = vpl.render_vpl(scene, cfg, n_paths=16, vpl_depth=2, seed=1)
    assert reference["img"].mean() > 0
    np.testing.assert_allclose(img.numpy(), reference["img"], rtol=1e-4,
                               atol=1e-6)
    again, _ = vpl.render_vpl(scene, cfg, n_paths=16, vpl_depth=2, seed=1)
    assert torch.equal(img, again)


def test_vpl_matches_path_tracer():
    """tests/test_vpl.py:26: the mean within 35% of the path tracer's (the
    clamp removes some near-field energy)."""
    scene = cornell_box(16, 16, device="cpu")
    img, _ = vpl.render_vpl(scene, PathConfig(max_depth=2, spp=2),
                            n_paths=128, vpl_depth=2, clamp_dist=10.0,
                            seed=1)
    ref, _ = render(scene, PathConfig(max_depth=3, spp=128), seed=2)
    a, b = float(img.mean()), float(ref.mean())
    assert np.isfinite(img.numpy()).all() and a > 0
    assert abs(a - b) / b < 0.35, (a, b)
