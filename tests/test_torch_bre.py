"""The port's volume photons and beam radiance estimate
(mitsuba_tpu_torch/integrators/bre.py) against the JAX package's, on
`cornell_box(16, 16)` in tests/test_bre.py's fog, the reference on its
kernel path (tests/torch_kernel_path.py).

- `shoot_photons_media`, 4,000 photons, depth 4, seed 0: the surface
  and volume deposit counts and the caustic flags equal; positions
  within 1e-5 of the box's size (556), powers within 1e-5 relative,
  directions and normals within 1e-5 absolute.
- `build_volume_grid`: the grid's tables bit for bit, the radius equal.
- `bre_render`, 10,000 photons, 8 march steps, seed 3: every pixel within
  1e-4 relative (1e-6 absolute), the counts equal, the volume radius
  within 1e-6.
- tests/test_bre.py's checks on the port: volume deposits grow with
  sigma, none without a medium; no caustic photons in the diffuse box,
  some over a mirror floor.
"""
import numpy as np
import pytest
import torch

from mitsuba_tpu.integrators import bre as jbre
from mitsuba_tpu.integrators.path import PathConfig as JaxPathConfig
from mitsuba_tpu.media import make_homogeneous as jax_homogeneous
from mitsuba_tpu.render.scene import cornell_box as jax_cornell_box
from mitsuba_tpu_torch.core import transform as tf
from mitsuba_tpu_torch.integrators import bre
from mitsuba_tpu_torch.integrators.path import PathConfig
from mitsuba_tpu_torch.interop import from_jax_scene
from mitsuba_tpu_torch.media import make_homogeneous, no_medium
from mitsuba_tpu_torch.render import mesh as mesh_mod
from mitsuba_tpu_torch.render.camera import make_perspective
from mitsuba_tpu_torch.render.scene import SceneBuilder, cornell_box
from tests import torch_kernel_path as kp

torch.set_num_threads(1)
FOG = ((0.0012,) * 3, (0.0002,) * 3)


@pytest.fixture(scope="module")
def reference():
    mp = pytest.MonkeyPatch()
    try:
        js = jax_cornell_box(16, 16)
        kp.kernel_path(mp, js.geom)
        med = jax_homogeneous(*FOG)
        shot = jbre.shoot_photons_media(js, med, 4000, 4, seed=0)
        img, aux = jbre.bre_render(js, med, JaxPathConfig(
            max_depth=4, spp=1, remat=False), n_photons=10_000, n_march=8,
            seed=3)
        yield dict(scene=js, shot=shot, img=np.asarray(img), aux=aux)
    finally:
        mp.undo()


def _same_deposits(got, ref):
    assert len(got[0]) == len(ref[0])
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=1e-5 * 556)
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-5)
    for a, b in zip(got[2:], ref[2:]):
        if a.dtype == bool:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_shoot_photons_media_matches_reference(reference):
    scene = from_jax_scene(reference["scene"], device="cpu")
    surf, vol = bre.shoot_photons_media(scene, make_homogeneous(*FOG), 4000,
                                        4, seed=0)
    rs, rv = reference["shot"]
    assert len(vol[0]) > 500 and len(surf[0]) > 1000
    _same_deposits(surf, rs)
    _same_deposits(vol, rv)
    grid, radius = bre.build_volume_grid(*vol)
    jgrid, jradius = jbre.build_volume_grid(*rv)
    assert radius == pytest.approx(jradius, rel=1e-6)
    assert grid.max_per_query == jgrid.max_per_query
    np.testing.assert_array_equal(grid.cell_start.numpy(),
                                  np.asarray(jgrid.cell_start))
    np.testing.assert_array_equal(grid.perm.numpy(), np.asarray(jgrid.perm))


def test_bre_render_matches_reference(reference):
    scene = from_jax_scene(reference["scene"], device="cpu")
    img, aux = bre.bre_render(scene, make_homogeneous(*FOG),
                              PathConfig(max_depth=4, spp=1),
                              n_photons=10_000, n_march=8, seed=3)
    img = img.numpy()
    assert np.isfinite(img).all() and reference["img"].mean() > 0
    np.testing.assert_allclose(img, reference["img"], rtol=1e-4, atol=1e-6)
    ref = reference["aux"]
    assert aux["n_volume_photons"] == ref["n_volume_photons"]
    assert aux["n_surface_photons"] == ref["n_surface_photons"]
    assert aux["volume_radius"] == pytest.approx(ref["volume_radius"],
                                                 rel=1e-6)


def test_volume_deposits_scale_with_sigma():
    """tests/test_bre.py:14."""
    scene = cornell_box(8, 8, device="cpu")
    thin = make_homogeneous((0.0005,) * 3, (0.0001,) * 3)
    thick = make_homogeneous((0.002,) * 3, (0.0001,) * 3)
    _, vol_thin = bre.shoot_photons_media(scene, thin, 2000, 4, seed=0)
    _, vol_thick = bre.shoot_photons_media(scene, thick, 2000, 4, seed=0)
    assert len(vol_thin[0]) > 0
    assert len(vol_thick[0]) > 1.2 * len(vol_thin[0])
    surf, vol0 = bre.shoot_photons_media(scene, no_medium(), 2000, 4,
                                         seed=0)
    assert len(vol0[0]) == 0 and len(surf[0]) > 1000


def test_caustic_classification():
    """tests/test_bre.py:30: no caustic photons in the diffuse box; light
    -> mirror floor -> diffuse wall deposits flagged."""
    surf, _ = bre.shoot_photons_media(cornell_box(8, 8, device="cpu"),
                                      no_medium(), 4000, 4, seed=0)
    assert surf[4].sum() == 0
    b = SceneBuilder()
    white = b.materials.lambertian((0.7, 0.7, 0.7))
    mirror = b.materials.mirror((0.95, 0.95, 0.95))
    lm = b.materials.lambertian((0.0, 0.0, 0.0))
    q = mesh_mod.make_quad
    b.add_shape(q([-1, 0, -1], [-1, 0, 1], [1, 0, 1], [1, 0, -1]), mirror)
    b.add_shape(q([-1, 0, -1], [-1, 2, -1], [-1, 2, 1], [-1, 0, 1]), white)
    b.add_shape(q([1, 0, -1], [1, 0, 1], [1, 2, 1], [1, 2, -1]), white)
    b.add_shape(q([-1, 2, -1], [1, 2, -1], [1, 2, 1], [-1, 2, 1]), white)
    b.add_area_emitter_shape(q([-0.3, 1.99, -0.3], [0.3, 1.99, -0.3],
                               [0.3, 1.99, 0.3], [-0.3, 1.99, 0.3]), lm,
                             (10.0, 10.0, 10.0))
    b.set_camera(make_perspective(tf.look_at([0, 1, 3.5], [0, 1, 0],
                                             [0, 1, 0]), 50, 1.0), 8, 8)
    scene = b.build(backend="brute", device="cpu")
    surf, _ = bre.shoot_photons_media(scene, no_medium(), 4000, 4, seed=0)
    assert surf[4].sum() > 10
