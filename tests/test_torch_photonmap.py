"""The port's photon-map family (mitsuba_tpu_torch/integrators/
photonmap.py) against the JAX package's, on `cornell_box(16, 16)` with
the reference on its kernel path (tests/torch_kernel_path.py: the port's
brute backend builds the kernel path's shading frame, and a photon's
bounce depends on it).

- `shoot_photons`, 4,096 photons, depth 4, seed 0: the deposit count
  equal; positions within 1e-5 of the box's size (556), powers within
  1e-5 relative, directions and normals within 1e-5 absolute. A
  photon's t differs from the reference's in its last bits (XLA fuses the
  reference's multiply-adds on the CPU), which its later bounces carry.
- `photon_estimate` per lane on one grid built from the same deposits,
  at the reference's first hits: within 1e-5.
- `photonmap_render`, `ppm_render`, `photonmapper_render` and
  `sppm_render` at small counts, the same seeds: every pixel within 1e-4
  relative (1e-6 absolute); the deposit and caustic counts and pass
  counts equal; the radii (from the deposits' extent, whose last bits
  follow the positions') within 1e-6 relative, SPPM's per-pixel radii
  and mean N within 1e-5. No photon's path diverged at these counts.
- The port's own energy checks, tests/test_photonmap.py:15-79 and
  tests/test_sppm.py:13-33, at the smaller counts a CPU test affords
  (the photon map 60,000 photons at radius 8 on 16 x 16 px, the mapper
  30,000 and 4 gather rays, SPPM 4 passes of 30,000): the first bounce's
  deposits carry the light's power, and the photon map, the final-gather
  mapper and SPPM agree with `render`'s path tracer on the image's
  brightness within the reference's bounds.
"""
import numpy as np
import pytest
import torch

from mitsuba_tpu.integrators import photonmap as jpm
from mitsuba_tpu.integrators.path import PathConfig as JaxPathConfig
from mitsuba_tpu.render.scene import cornell_box as jax_cornell_box
from mitsuba_tpu_torch.integrators import photonmap as pm
from mitsuba_tpu_torch.integrators.path import PathConfig, render
from mitsuba_tpu_torch.interop import from_jax_scene
from mitsuba_tpu_torch.render.intersect import ray_intersect
from mitsuba_tpu_torch.render.scene import cornell_box
from tests import torch_kernel_path as kp

torch.set_num_threads(1)
RTOL = 1e-4
# (call, keyword arguments) of each render, the reference's own tests'
# cases at smaller counts
RENDERS = {
    "photonmap": ("photonmap_render", dict(n_photons=20_000, seed=0),
                  dict(max_depth=4, spp=2, remat=False)),
    "ppm": ("ppm_render", dict(n_photons_per_pass=10_000, n_passes=2,
                               seed=2), dict(max_depth=4, spp=2,
                                             remat=False)),
    "photonmapper": ("photonmapper_render", dict(
        n_photons=10_000, gather_samples=4, seed=2),
        dict(max_depth=4, spp=2, remat=False)),
    "sppm": ("sppm_render", dict(n_photons_per_pass=10_000, n_passes=2,
                                 seed=1), dict(max_depth=4, spp=1)),
}


@pytest.fixture(scope="module")
def reference():
    """The reference's deposits, grid inputs and renders, on its kernel
    path."""
    mp = pytest.MonkeyPatch()
    try:
        js = jax_cornell_box(16, 16)
        kp.kernel_path(mp, js.geom)
        out = {"scene": js,
               "shoot": jpm.shoot_photons(js, 4096, 4, seed=0)}
        for name, (fn, kw, cfg) in RENDERS.items():
            img, aux = getattr(jpm, fn)(js, JaxPathConfig(**cfg), **kw)
            out[name] = (np.asarray(img), aux)
        yield out
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def scene(reference):
    return from_jax_scene(reference["scene"], device="cpu")


def test_shoot_photons_matches_reference(reference, scene):
    ref = reference["shoot"]
    got = pm.shoot_photons(scene, 4096, 4, seed=0)
    assert len(got[0]) == len(ref[0]) > 4096
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=1e-5 * 556)
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-5)
    for a, b in zip(got, ref):
        assert a.dtype == np.float32
    for a, b in zip(got[2:], ref[2:]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_photon_estimate_per_lane(reference, scene):
    from mitsuba_tpu_torch.integrators.path import camera_samples

    pos, power, din, nrm = reference["shoot"]
    grid = pm.build_photon_grid(pos, power, din, nrm)
    jgrid = jpm.build_photon_grid(pos, power, din, nrm)
    cfg = PathConfig(max_depth=4, spp=2)
    ray, _, _, _ = camera_samples(scene, cfg, 0, morton=False)
    its = ray_intersect(scene.geom, ray)
    got = pm.photon_estimate(scene, grid, its, 20.0, 4096).numpy()
    # the reference's estimate at the same records
    import jax.numpy as jnp

    from mitsuba_tpu.render.records import Intersection

    jits = Intersection(**{k: jnp.asarray(getattr(its, k).numpy())
                           for k in Intersection.__dataclass_fields__})
    ref = np.asarray(jpm.photon_estimate(reference["scene"], jgrid, jits,
                                         20.0, 4096))
    assert ref.max() > 0
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name", sorted(RENDERS))
def test_render_matches_reference(reference, scene, name):
    fn, kw, cfg = RENDERS[name]
    img, aux = getattr(pm, fn)(scene, PathConfig(**cfg), **kw)
    ref_img, ref_aux = reference[name]
    img = img.numpy()
    assert img.shape == ref_img.shape and np.isfinite(img).all()
    assert ref_img.mean() > 0
    np.testing.assert_allclose(img, ref_img, rtol=RTOL, atol=1e-6)
    for k, v in ref_aux.items():
        if k == "radius_map":
            np.testing.assert_allclose(aux[k], np.asarray(v), rtol=1e-5)
        elif isinstance(v, float):
            np.testing.assert_allclose(aux[k], v, rtol=1e-5 if k in (
                "mean_N", "mean_radius", "min_radius") else 1e-6, err_msg=k)
        else:
            assert aux[k] == v, k


def test_first_bounce_carries_the_lights_power():
    """tests/test_photonmap.py:15: bounce 0's deposits carry Le pi A."""
    scene = cornell_box(16, 16, device="cpu")
    pos, power, _, _ = pm.shoot_photons(scene, 20_000, max_depth=4, seed=0)
    assert len(pos) > 20_000 and np.isfinite(power).all()
    em_power = 18.4 * (130 * 105) * np.pi
    first = power[:10_000, 0]
    assert abs(first.mean() - em_power) / em_power < 0.05


def _lum(img):
    return img.numpy().mean(-1)


def test_photonmap_matches_path_tracer():
    """tests/test_photonmap.py:27: brightness within 20%, structure
    correlated, below the brightest 2% of the path tracer's pixels."""
    scene = cornell_box(16, 16, device="cpu")
    a, aux = pm.photonmap_render(scene, PathConfig(max_depth=4, spp=4),
                                 n_photons=60_000, radius=8.0, seed=0)
    b, _ = render(scene, PathConfig(max_depth=6, spp=32), seed=1)
    a, b = _lum(a), _lum(b)
    assert aux["n_deposits"] > 100_000
    sel = b < np.quantile(b, 0.98)
    assert 0.8 < a[sel].mean() / b[sel].mean() < 1.2
    assert np.corrcoef(a[sel], b[sel])[0, 1] > 0.7


def test_photonmapper_matches_path_tracer():
    """tests/test_photonmap.py:60: the image mean within 30%."""
    scene = cornell_box(16, 16, device="cpu")
    img, aux = pm.photonmapper_render(scene, PathConfig(max_depth=4, spp=2),
                                      n_photons=30_000, gather_samples=4,
                                      seed=2)
    ref, _ = render(scene, PathConfig(max_depth=5, spp=64), seed=7)
    a, b = float(img.mean()), float(ref.mean())
    assert a > 0 and abs(a - b) / b < 0.30, (a, b)


def test_sppm_matches_path_tracer():
    """tests/test_sppm.py:13,26: the image mean within 20%, N gathered,
    some radii shrunk."""
    scene = cornell_box(12, 12, device="cpu")
    ref, _ = render(scene, PathConfig(max_depth=4, spp=256), seed=3)
    img, aux = pm.sppm_render(scene, PathConfig(max_depth=4, spp=1),
                              n_photons_per_pass=30_000, n_passes=4, seed=1)
    r, s = float(ref.mean()), float(img.mean())
    assert abs(s - r) / r < 0.2, (s, r)
    assert aux["mean_N"] > 0 and aux["min_radius"] < aux["mean_radius"]
