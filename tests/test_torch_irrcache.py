"""The port's irradiance cache (mitsuba_tpu_torch/integrators/irrcache.py)
against the JAX package's, on `cornell_box(16, 16)` with the reference on
its kernel path (tests/torch_kernel_path.py).

- `build_irradiance_cache`, plain and with gradients (cache_res 12,
  hemi_samples 16, depth 3, seed 0): the HashGrid's cells and order bit
  for bit (the same first hits), the points within 1e-5 of the box's
  size (556; a hit's t differs in its last bits); the normals, E and the
  Ward gradients within 1e-4 relative (1e-6 absolute): E is a mean of
  short path traces, lane by lane the reference's within float32
  rounding.
- `interpolate_irradiance` at the reference's own records: within 1e-5
  relative.
- `irrcache_render`, plain and with gradients, 2 spp: every pixel within
  1e-4 relative (1e-6 absolute); the record count, radius and coverage
  equal.
- `stratified_hemisphere` and `ward_gradients` on seeded cells: within
  1e-6 and 1e-5 relative; and tests/test_irrcache.py:67 on the port: the
  gradients of an unoccluded rectangle light against its exact contour
  integral, translational within 5%, rotational within 10%.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.integrators import irrcache as jic
from mitsuba_tpu.integrators.path import PathConfig as JaxPathConfig
from mitsuba_tpu.render.scene import cornell_box as jax_cornell_box
from mitsuba_tpu_torch.integrators import irrcache as ic
from mitsuba_tpu_torch.integrators.path import PathConfig
from mitsuba_tpu_torch.interop import from_jax_scene
from tests import torch_kernel_path as kp

torch.set_num_threads(1)
CACHE = dict(cache_res=12, hemi_samples=16, seed=0)


@pytest.fixture(scope="module")
def reference():
    mp = pytest.MonkeyPatch()
    try:
        js = jax_cornell_box(16, 16)
        kp.kernel_path(mp, js.geom)
        cfg = JaxPathConfig(max_depth=3, spp=2, remat=False)
        out = dict(scene=js)
        for g in (False, True):
            out["grid", g] = jic.build_irradiance_cache(js, cfg, **CACHE,
                                                        gradients=g)
            img, aux = jic.irrcache_render(js, cfg, **CACHE, gradients=g)
            out["render", g] = (np.asarray(img), aux)
        yield out
    finally:
        mp.undo()


@pytest.mark.parametrize("gradients", [False, True])
def test_cache_matches_reference(reference, gradients):
    scene = from_jax_scene(reference["scene"], device="cpu")
    grid = ic.build_irradiance_cache(scene, PathConfig(max_depth=3, spp=2),
                                     **CACHE, gradients=gradients)
    ref = reference["grid", gradients]
    for f in ("cell_start", "perm"):
        np.testing.assert_array_equal(getattr(grid, f).numpy(),
                                      np.asarray(getattr(ref, f)), f)
    for f in ("bmin", "points"):
        np.testing.assert_allclose(getattr(grid, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=0,
                                   atol=1e-5 * 556, err_msg=f)
    pay, rpay = grid.payload.numpy(), np.asarray(ref.payload)
    assert pay.shape == rpay.shape == (rpay.shape[0],
                                       24 if gradients else 6)
    np.testing.assert_allclose(pay, rpay, rtol=1e-4, atol=1e-6)
    # interpolation at the reference's records
    x, n = np.asarray(ref.points)[:40], rpay[:40, 3:6]
    e, w = ic.interpolate_irradiance(grid, torch.from_numpy(x),
                                     torch.from_numpy(n), 60.0)
    je, jw = jic.interpolate_irradiance(ref, jnp.asarray(x), jnp.asarray(n),
                                        60.0)
    np.testing.assert_allclose(e.numpy(), np.asarray(je), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-5)


@pytest.mark.parametrize("gradients", [False, True])
def test_render_matches_reference(reference, gradients):
    scene = from_jax_scene(reference["scene"], device="cpu")
    img, aux = ic.irrcache_render(scene, PathConfig(max_depth=3, spp=2),
                                  **CACHE, gradients=gradients)
    ref_img, ref_aux = reference["render", gradients]
    assert ref_img.mean() > 0
    np.testing.assert_allclose(img.numpy(), ref_img, rtol=1e-4, atol=1e-6)
    assert aux["cache_points"] == ref_aux["cache_points"]
    assert aux["coverage"] == ref_aux["coverage"]
    assert aux["radius"] == pytest.approx(ref_aux["radius"], rel=1e-6)


def test_ward_pieces_match_reference():
    rng = np.random.default_rng(0)
    m_t, n_p = 6, 12
    u1, u2 = rng.uniform(size=(2, 5, m_t, n_p)).astype(np.float32)
    d = ic.stratified_hemisphere(m_t, n_p, torch.from_numpy(u1),
                                 torch.from_numpy(u2)).numpy()
    jd = np.asarray(jic.stratified_hemisphere(m_t, n_p, jnp.asarray(u1),
                                              jnp.asarray(u2)))
    np.testing.assert_allclose(d, jd, rtol=1e-6, atol=1e-7)
    L = rng.uniform(size=(5, m_t, n_p, 3)).astype(np.float32)
    r = rng.uniform(0.1, 5.0, size=(5, m_t, n_p)).astype(np.float32)
    got = ic.ward_gradients(torch.from_numpy(L), torch.from_numpy(r), m_t,
                            n_p)
    ref = jic.ward_gradients(jnp.asarray(L), jnp.asarray(r), m_t, n_p)
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)


def test_ward_gradients_match_analytic_rectangle_light():
    """tests/test_irrcache.py:67 on the port's ward_gradients."""
    le = 10.0
    corners = np.array([[-0.5, 2.0, -0.5], [0.5, 2.0, -0.5],
                        [0.5, 2.0, 0.5], [-0.5, 2.0, 0.5]])

    def e_vec(x):
        d = corners - x
        d = d / np.linalg.norm(d, axis=1, keepdims=True)
        v = np.zeros(3)
        for i in range(4):
            a, b = d[i], d[(i + 1) % 4]
            th = np.arccos(np.clip(a @ b, -1, 1))
            u = np.cross(a, b)
            v += th * u / np.linalg.norm(u)
        v *= 0.5 * le
        return v if v[1] > 0 else -v

    m_t, n_p = 32, 64
    u = torch.full((m_t, n_p), 0.5)
    d_loc = ic.stratified_hemisphere(m_t, n_p, u, u).numpy()
    d_world = np.stack([d_loc[..., 0], d_loc[..., 2], d_loc[..., 1]], -1)
    for x0 in ([0.3, 0.0, 0.2], [-0.6, 0.0, 0.1], [0.0, 0.5, -0.4]):
        x0 = np.array(x0)
        t = (2.0 - x0[1]) / np.where(d_world[..., 1] > 1e-6,
                                     d_world[..., 1], np.nan)
        hp = x0 + t[..., None] * d_world
        on = ((np.abs(hp[..., 0]) <= 0.5) & (np.abs(hp[..., 2]) <= 0.5)
              & np.isfinite(t))
        L = np.where(on, le, 0.0)[..., None] * np.ones(3)
        r = np.where(on, t, 1e6)
        gt, gr = ic.ward_gradients(torch.tensor(L, dtype=torch.float32),
                                   torch.tensor(r, dtype=torch.float32),
                                   m_t, n_p)
        gt = gt.numpy()[0]
        gw = np.array([gt[0], 0.0, gt[1]])
        h = 1e-3
        fd = np.array([
            (e_vec(x0 + [h, 0, 0])[1] - e_vec(x0 - [h, 0, 0])[1]) / (2 * h),
            0.0,
            (e_vec(x0 + [0, 0, h])[1] - e_vec(x0 - [0, 0, h])[1]) / (2 * h),
        ])
        assert np.linalg.norm(gw - fd) / np.linalg.norm(fd) < 0.05
        gr0 = gr.numpy()[0]
        grw = np.array([gr0[0], 0.0, gr0[1]])
        ev = e_vec(x0)
        nw = np.array([0.0, 1.0, 0.0])
        for aw in (np.array([1.0, 0.0, 0.0]), np.array([0.0, 0.0, 1.0])):
            exact = ev @ np.cross(aw, nw)
            assert abs(grw @ aw - exact) < 0.10 * (abs(exact) + 0.05)
