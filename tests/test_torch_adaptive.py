"""The port's adaptive sampling (mitsuba_tpu_torch/integrators/
adaptive.py) against the JAX package's, on `cornell_box(16, 16)` with
the reference on its kernel path (tests/torch_kernel_path.py).

- `adaptive_render`, 4 spp a pass, depth 3, at most 6 passes, max_error
  0.25 and 0.1, seeds 0 and 1: the pass count and every pixel's sample
  count equal (the host decides each block's convergence from the same
  sums), every pixel within 1e-4 relative (1e-6 absolute).
- tests/test_adaptive.py on the port: at least min_passes of samples a
  pixel, the mean below the brightest 2% of pixels within 8% of a 64-spp
  render, and the sample counts varying over the image.
"""
import numpy as np
import pytest
import torch

from mitsuba_tpu.integrators import adaptive as jad
from mitsuba_tpu.integrators.path import PathConfig as JaxPathConfig
from mitsuba_tpu.render.scene import cornell_box as jax_cornell_box
from mitsuba_tpu_torch.integrators import adaptive as ad
from mitsuba_tpu_torch.integrators.path import PathConfig, render
from mitsuba_tpu_torch.interop import from_jax_scene
from mitsuba_tpu_torch.render.scene import cornell_box

torch.set_num_threads(1)
CASES = {"loose": dict(max_error=0.25, max_sample_factor=6, seed=0),
         "tight": dict(max_error=0.1, max_sample_factor=6, seed=1)}


@pytest.fixture(scope="module")
def reference():
    from tests import torch_kernel_path as kp

    mp = pytest.MonkeyPatch()
    try:
        js = jax_cornell_box(16, 16)
        kp.kernel_path(mp, js.geom)
        out = dict(scene=js)
        for name, kw in CASES.items():
            img, aux = jad.adaptive_render(js, JaxPathConfig(
                max_depth=3, spp=4, remat=False), **kw)
            out[name] = (np.asarray(img), aux["passes"],
                         np.asarray(aux["sample_count"]))
        yield out
    finally:
        mp.undo()


@pytest.mark.parametrize("case", sorted(CASES))
def test_adaptive_matches_reference(reference, case):
    scene = from_jax_scene(reference["scene"], device="cpu")
    img, aux = ad.adaptive_render(scene, PathConfig(max_depth=3, spp=4),
                                  **CASES[case])
    ref_img, passes, count = reference[case]
    assert aux["passes"] == passes
    np.testing.assert_array_equal(aux["sample_count"].numpy(), count)
    np.testing.assert_allclose(img.numpy(), ref_img, rtol=1e-4, atol=1e-6)


def test_adaptive_converges_and_matches():
    """tests/test_adaptive.py:9 and :31."""
    scene = cornell_box(16, 16, device="cpu")
    cfg = PathConfig(max_depth=3, spp=8)
    img, aux = ad.adaptive_render(scene, cfg, max_error=0.25,
                                  max_sample_factor=6, seed=0)
    img = img.numpy()
    assert np.isfinite(img).all() and 2 <= aux["passes"] <= 6
    cnt = aux["sample_count"].numpy()
    assert cnt.min() >= 2 * cfg.spp
    ref, _ = render(scene, PathConfig(max_depth=3, spp=64), seed=9)
    lum_a = img.mean(-1).ravel()
    lum_r = ref.numpy().mean(-1).ravel()
    sel = lum_r < np.quantile(lum_r, 0.98)
    a, r = lum_a[sel].mean(), lum_r[sel].mean()
    assert abs(a - r) / r < 0.08, (a, r)
    _, aux = ad.adaptive_render(scene, PathConfig(max_depth=3, spp=4),
                                max_error=0.1, max_sample_factor=8, seed=1)
    cnt = aux["sample_count"].numpy()
    assert cnt.max() > cnt.min()
