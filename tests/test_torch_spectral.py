"""The port's n-channel spectra (`mitsuba_tpu_torch/core/spectral.py`, the
material table's widening, the render path at n = 8) against the JAX
package's.

- Every function of core/spectral.py on numpy-seeded inputs: the float64
  matrices and the float32 tables bit for bit, the conversions within
  1e-6 relative.
- The reference's own checks (tests/test_spectral.py): the RGB round trip
  at n = 8, 16 and 32 (rtol 2e-4), a flat spectrum's luminance, the CIE
  fit's peaks, Wien's shift, a flat `from_continuous`.
- `MaterialBuilder.build` on a table that mixes 3-wide greys and 8-wide
  rows equals the reference's, column by column, and refuses a
  non-uniform 3-wide row in the reference's words. A rough conductor at
  n = 8 is refused by both packages, at different places: its cond_eta
  and cond_k stay 3-wide, so the reference fails at render with a
  TypeError (the shapes (N, 8) and (N, 3) do not broadcast) and the port
  raises a ValueError at build (ROADMAP C).
- The n = 8 furnace (depth 3, rtol 0.05) and the RGB-upsampled furnace
  (rtol 0.06, atol 0.01) at the reference's sizes and seeds. The port
  renders them on the bvh backend: its plain brute version takes ~54 s
  for the 24,576 lanes against 2,208 triangles on one CPU thread; the
  furnace's closed form holds on any backend, and the brute path at
  n = 8 is held lane by lane below.
- One scene at n = 8 lane by lane: config 1's Cornell box with every
  colour upsampled (tests/torch_spectral_cases.py `cornell_n`), 16x16 px,
  2 spp, depth 3, brute, against the reference's kernel path
  (tests/torch_kernel_path.py), >= 99% of lanes within rtol 1e-4.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.core import spectral as jsp
from mitsuba_tpu.core import transform as jtf
from mitsuba_tpu.integrators.path import PathConfig as JaxPathConfig
from mitsuba_tpu.integrators.path import path_trace as jax_path_trace
from mitsuba_tpu.integrators.path import render as jax_render
from mitsuba_tpu.render import mesh as jmesh
from mitsuba_tpu.render.camera import make_perspective as jax_perspective
from mitsuba_tpu.render.sampler import Sampler as JaxSampler
from mitsuba_tpu.render.scene import SceneBuilder as JaxSceneBuilder
from mitsuba_tpu_torch.core import spectral as sp
from mitsuba_tpu_torch.integrators.path import (
    PathConfig, camera_wavefront, path_trace, render,
)
from mitsuba_tpu_torch.interop import from_jax_scene
from tests import torch_spectral_cases as sc
from tests.test_torch_bsdf_zoo import JAX_MODS, MATERIAL_COLUMNS
from tests.test_torch_hetero import assert_lanes_match
from tests.torch_bsdf_cases import port_modules
from tests.torch_kernel_path import kernel_path, lanes

torch.set_num_threads(1)
RTOL = 1e-6
PORT_MODS = port_modules()


@pytest.mark.parametrize("n", [3, 8, 16, 32, 64])
def test_matrices_equal_reference(n):
    spec, jspec = sp.SpectralBins(n), jsp.SpectralBins(n)
    assert np.array_equal(spec.edges, jspec.edges)
    assert np.array_equal(spec.centers, jspec.centers)
    assert np.array_equal(spec._xyz_weights(), jspec._xyz_weights())
    assert np.array_equal(spec._rgb_basis(), jspec._rgb_basis())
    for got, want in ((spec.to_xyz_matrix(), jspec.to_xyz_matrix()),
                      (spec.rgb_basis(), jspec.rgb_basis())):
        assert got.dtype == torch.float32
        assert np.array_equal(got.numpy(), np.asarray(want))
    lam = np.random.default_rng(n).uniform(300.0, 900.0, 257)
    assert np.array_equal(sp.cie_xyz_bar(lam), jsp.cie_xyz_bar(lam))


@pytest.mark.parametrize("n", [8, 16])
def test_conversions_equal_reference(n):
    rng = np.random.default_rng(n)
    spec, jspec = sp.SpectralBins(n), jsp.SpectralBins(n)
    bins = rng.uniform(0.0, 2.0, (64, 5, n)).astype(np.float32)
    rgb = rng.uniform(0.0, 1.0, (257, 3)).astype(np.float32)
    for fn, x in (("to_xyz", bins), ("to_rgb", bins), ("luminance", bins),
                  ("from_rgb", rgb)):
        got = getattr(sp, fn)(torch.from_numpy(x), spec)
        want = np.asarray(getattr(jsp, fn)(jnp.asarray(x), jspec))
        assert got.dtype == torch.float32 and got.shape == want.shape, fn
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                                   atol=RTOL * np.abs(want).max(), err_msg=fn)
    fn = lambda lam: 1.0 + np.sin(lam / 37.0) ** 2      # noqa: E731
    for got, want in (
            (sp.from_continuous(fn, spec, device="cpu"),
             jsp.from_continuous(fn, jspec)),
            (sp.blackbody(5500.0, spec, device="cpu"),
             jsp.blackbody(5500.0, jspec))):
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=0.0)


def test_rgb_round_trip_exact():
    rng = np.random.default_rng(0)
    rgb = torch.from_numpy(rng.random((32, 3)).astype(np.float32))
    for n in (8, 16, 32):
        back = sp.to_rgb(sp.from_rgb(rgb, sp.SpectralBins(n)),
                         sp.SpectralBins(n))
        np.testing.assert_allclose(back.numpy(), rgb.numpy(), rtol=2e-4,
                                   atol=2e-5)


def test_reference_checks():
    """tests/test_spectral.py's flat luminance, CIE peaks, Wien's shift
    and flat from_continuous, on the port."""
    for n in (8, 64):
        y = sp.luminance(torch.ones(n), sp.SpectralBins(n))
        assert abs(float(y) - 1.0) < 1e-5
    lam = np.linspace(380, 780, 2001)
    bar = sp.cie_xyz_bar(lam)
    assert abs(lam[np.argmax(bar[:, 1])] - 555) < 15
    assert abs(lam[np.argmax(bar[:, 2])] - 447) < 15
    spec = sp.SpectralBins(32)
    b3000 = sp.blackbody(3000.0, spec, device="cpu").numpy()
    b8000 = sp.blackbody(8000.0, spec, device="cpu").numpy()
    assert (b3000 > 0).all() and (b8000 > 0).all()
    assert spec.centers[np.argmax(b8000)] < spec.centers[np.argmax(b3000)]
    assert (b8000 > b3000).all()
    v = sp.from_continuous(lambda lam: np.full_like(lam, 2.5),
                           sp.SpectralBins(8), device="cpu")
    np.testing.assert_allclose(v.numpy(), 2.5, rtol=1e-6)


def _mixed_rows(mb, wide):
    mb.lambertian((0.5, 0.5, 0.5))
    mb.lambertian(tuple(wide))
    mb.mirror()
    mb.dielectric(int_ior=1.33, transmittance=tuple(wide * 0.9))
    mb.phong(diffuse=(0.3,) * 3, specular=tuple(wide * 0.1))
    mb.diff_trans((0.25,) * 3)


def test_widened_table_equals_reference():
    wide = np.random.default_rng(3).uniform(0.1, 0.9, 8).astype(np.float32)
    jb, tb = JaxSceneBuilder(), PORT_MODS.SceneBuilder()
    _mixed_rows(jb.materials, wide)
    _mixed_rows(tb.materials, wide)
    want, got = jb.materials.build(), tb.materials.build()
    for name in MATERIAL_COLUMNS:
        w = np.asarray(getattr(want, name))
        g = getattr(got, name).numpy()
        assert g.dtype == w.dtype and np.array_equal(g, w), name
    assert got.reflectance.shape == (6, 8)
    assert np.array_equal(got.reflectance[0].numpy(), np.full(8, 0.5))
    assert got.kinds_present == want.kinds_present


def test_nonuniform_narrow_row_refused_as_reference():
    wide = np.linspace(0.1, 0.8, 8)
    msgs = []
    for b in (JaxSceneBuilder(), PORT_MODS.SceneBuilder()):
        b.materials.lambertian(tuple(wide))
        b.materials.lambertian((0.5, 0.4, 0.3))
        with pytest.raises(ValueError) as err:
            b.materials.build()
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    assert "cannot widen to the scene's 8 spectral channels" in msgs[1]


def test_conductor_at_n8_refused_by_both():
    """The reference builds the table and fails when the render reaches
    the conductor's Fresnel term; the port refuses at build."""
    a, le = sc.furnace_colours()
    tb = PORT_MODS.SceneBuilder()
    tb.materials.lambertian(tuple(a))
    tb.materials.rough_conductor(alpha=0.2)
    with pytest.raises(ValueError, match="ROADMAP C"):
        tb.materials.build()

    jb = JaxSceneBuilder()
    jb.materials.lambertian(tuple(a))
    mat = jb.materials.rough_conductor(alpha=0.2)
    sph = jmesh.make_sphere_mesh([0, 0, 0], 10.0, 6, 12)
    sph.faces = sph.faces[:, ::-1].copy()
    sph.normals = -sph.normals
    jb.add_area_emitter_shape(sph, mat, tuple(le))
    jb.set_camera(jax_perspective(jtf.look_at([0, 0, 0.01], [0, 0, 5],
                                              [0, 1, 0]), 40.0, 1.0), 4, 4)
    jscene = jb.build(backend="brute")
    assert jscene.materials.reflectance.shape[-1] == 8
    with pytest.raises(TypeError, match="incompatible shapes"):
        jax_render(jscene, JaxPathConfig(max_depth=1, spp=1, remat=False))


def test_furnace_render_n8():
    """tests/test_spectral.py:83 on the port: each of 8 channels within
    5% of Le_c (1 + a_c + a_c^2)."""
    a, le = sc.furnace_colours()
    scene = sc.furnace(PORT_MODS, a, le, backend="bvh", device="cpu")
    assert scene.materials.reflectance.shape[-1] == sc.N_CH
    assert scene.emitters.radiance.shape[-1] == sc.N_CH
    img, _ = render(scene, PathConfig(max_depth=3, spp=96), seed=11)
    assert img.shape == (16, 16, sc.N_CH)
    np.testing.assert_allclose(img.numpy().mean(axis=(0, 1)),
                               sc.furnace_expected(a, le, 3), rtol=0.05)


def test_rgb_scene_to_spectral_tables():
    """tests/test_spectral.py:101 on the port: the furnace built from
    upsampled RGB develops back through to_rgb to the RGB result."""
    spec = sp.SpectralBins(sc.N_CH)
    a, le = sc.upsampled_furnace(sp)
    scene = sc.furnace(PORT_MODS, a, le, backend="bvh", device="cpu")
    img, _ = render(scene, PathConfig(max_depth=2, spp=64), seed=3)
    got = sp.to_rgb(img.mean(dim=(0, 1)), spec).numpy()
    want = sp.to_rgb(torch.from_numpy(le * (1.0 + a)), spec).numpy()
    np.testing.assert_allclose(got, want, rtol=0.06, atol=0.01)


W = H = 16
SPP, DEPTH = 2, 3


@pytest.fixture(scope="module")
def reference_lanes():
    """The reference's lanes of the n = 8 Cornell box on its kernel
    path, seed 0."""
    jscene = sc.cornell_n(JAX_MODS, sp, width=W, height=H)
    with pytest.MonkeyPatch.context() as mp:
        kernel_path(mp, jscene.geom)
        jcfg = JaxPathConfig(max_depth=DEPTH, spp=SPP, remat=False)

        @functools.partial(jax.jit, static_argnums=1)
        def run(scene, jcfg):
            pid, sid, px, py = lanes(W, H, SPP, jnp)
            sampler = JaxSampler(0, pid, sid)
            off = sampler.next_2d()
            uv = jnp.stack([(px + off[:, 0]) / W, (py + off[:, 1]) / H], -1)
            return jax_path_trace(scene, scene.camera.sample_ray(uv),
                                  sampler, jcfg)

        L, aux = run(jscene, jcfg)
    return jscene, np.asarray(L), float(aux["avg_path_length"])


def test_cornell_n8_matches_kernel_path_per_lane(reference_lanes):
    jscene, L_ref, apl = reference_lanes
    scene = sc.cornell_n(PORT_MODS, sp, width=W, height=H, device="cpu")
    conv = from_jax_scene(jscene, device="cpu")
    for name in MATERIAL_COLUMNS:
        assert torch.equal(getattr(scene.materials, name),
                           getattr(conv.materials, name)), name
    assert torch.equal(scene.emitters.radiance, conv.emitters.radiance)
    cfg = PathConfig(max_depth=DEPTH, spp=SPP)
    L, aux = path_trace(scene, *camera_wavefront(scene, cfg, 0,
                                                 morton=False)[:2], cfg)
    assert L.shape == (W * H * SPP, sc.N_CH) and L_ref.mean() > 0
    assert_lanes_match(L.numpy(), L_ref)
    assert abs(float(aux["avg_path_length"]) - apl) <= 0.02
