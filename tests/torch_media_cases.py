"""Media inputs shared by the port's media tests and chip_smoke.py (numpy
and the port only, no JAX): band-limited density and fiber fields made
from a seed, their `.vol` files, the heterogeneous Cornell-box scene file
and the volumetric tank of tests/golden_scenes.py:118 rebuilt with the
port's SceneBuilder.
"""
from __future__ import annotations

import os

import numpy as np

# the Cornell box of scenes/cornell.xml and bench config 1
BOX_MIN = (0.0, 0.0, 0.0)
BOX_MAX = (556.0, 548.8, 559.2)
# the tank's medium (tests/golden_scenes.py:128)
TANK_MEDIUM = dict(sigma_s=(0.4, 0.5, 0.6), sigma_a=(0.15, 0.1, 0.05),
                   g=0.3)


def _upsample(coarse, n):
    """Separable linear interpolation of a (c, c, c) grid to (n, n, n)."""
    c = coarse.shape[0]
    x = np.linspace(0.0, c - 1.0, n)
    i0 = np.clip(np.floor(x).astype(np.int64), 0, max(c - 2, 0))
    f = (x - i0).astype(np.float32)
    i1 = np.minimum(i0 + 1, c - 1)
    out = coarse
    for axis in range(3):
        a = np.take(out, i0, axis=axis)
        b = np.take(out, i1, axis=axis)
        shape = [1, 1, 1] + [1] * (out.ndim - 3)
        shape[axis] = n
        w = f.reshape(shape)
        out = a * (1.0 - w) + b * w
    return out.astype(np.float32)


def noise_grid(n: int, seed: int = 0, cells: int = 12):
    """(n, n, n) band-limited noise in [0, 1]: uniform noise on a cells³
    lattice, linearly interpolated (no frequency above the lattice's)."""
    rng = np.random.default_rng(seed)
    g = _upsample(rng.uniform(0.0, 1.0, (cells,) * 3).astype(np.float32), n)
    g -= g.min()
    return (g / max(float(g.max()), 1e-12)).astype(np.float32)


def fiber_field(n: int, seed: int = 1, cells: int = 6):
    """(n, n, n, 3) fiber axes, smooth and unnormalised (the medium
    normalises them)."""
    rng = np.random.default_rng(seed)
    coarse = rng.normal(size=(cells,) * 3 + (3,)).astype(np.float32)
    coarse[..., 2] += 1.0          # lean towards +z
    return _upsample(coarse, n)


def grid_to_box(shape_zyx, bmin=BOX_MIN, bmax=BOX_MAX):
    """world -> grid index map of a grid spanning the box (volio.py)."""
    zres, yres, xres = shape_zyx[:3]
    ext = np.asarray(bmax, np.float64) - np.asarray(bmin, np.float64)
    scale = np.asarray([(xres - 1) / ext[0], (yres - 1) / ext[1],
                        (zres - 1) / ext[2]])
    m = np.eye(4)
    m[0, 0], m[1, 1], m[2, 2] = scale
    m[:3, 3] = -np.asarray(bmin) * scale
    return m


def const_grid_transform(extent: float = 1e5):
    """A 2³ grid of density 1 covering ±extent: a heterogeneous medium that
    Woodcock-tracks the homogeneous one (tests/test_media.py:140)."""
    m = np.eye(4)
    m[0, 0] = m[1, 1] = m[2, 2] = 1.0 / (2.0 * extent)
    m[:3, 3] = 0.5
    return np.ones((2, 2, 2), np.float32), m


def hetero_cornell_xml(out_dir: str, n: int = 32, seed: int = 0,
                       sigma_t: float = 0.004, albedo: float = 0.8,
                       g: float = 0.4) -> str:
    """scenes/cornell.xml under `volpath` with a scene-level heterogeneous
    medium: an n³ float32 `.vol` of noise_grid(n, seed) spanning the box
    (optical depth ~1-3 across it at the default sigma_t), HG g. Writes
    density.vol and hetero.xml into out_dir and returns the XML's path;
    it keeps cornell.xml's parameters ($depth, $spp, $width, $height)."""
    from mitsuba_tpu_torch.io.volio import save_vol

    save_vol(os.path.join(out_dir, "density.vol"), noise_grid(n, seed),
             BOX_MIN, BOX_MAX)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "scenes", "cornell.xml")) as f:
        text = f.read()
    text = text.replace('"meshes/', '"' + os.path.join(
        root, "scenes", "meshes") + "/")
    text = text.replace('<integrator type="path">',
                        '<integrator type="volpath">', 1)
    medium = (
        '<medium type="heterogeneous">'
        f'<float name="sigmaT" value="{sigma_t}"/>'
        f'<float name="albedo" value="{albedo}"/>'
        '<volume type="gridvolume" name="density">'
        '<string name="filename" value="density.vol"/></volume>'
        f'<phase type="hg"><float name="g" value="{g}"/></phase>'
        '</medium>')
    text = text.replace("<scene>", "<scene>\n\t" + medium, 1)
    path = os.path.join(out_dir, "hetero.xml")
    with open(path, "w") as f:
        f.write(text)
    return path


def tank_scene(res: int, density=None, device="cuda", sigma_s=None,
               sigma_a=None):
    """The volumetric tank of tests/golden_scenes.py:118-141 with the
    port's SceneBuilder: an index-matched glass box holding a homogeneous
    medium (or, with `density` (D, H, W), a grid spanning the box), over a
    grey floor under an area light; 16 triangles, brute backend."""
    from mitsuba_tpu_torch.core import transform as tf
    from mitsuba_tpu_torch.render import mesh as mesh_mod
    from mitsuba_tpu_torch.render.camera import make_perspective
    from mitsuba_tpu_torch.render.scene import SceneBuilder

    b = SceneBuilder()
    glass = b.materials.dielectric(int_ior=1.0, ext_ior=1.0)
    lm = b.materials.lambertian((0.0, 0.0, 0.0))
    grey = b.materials.lambertian((0.5, 0.5, 0.5))
    kw = dict(TANK_MEDIUM)
    if sigma_s is not None:
        kw["sigma_s"] = sigma_s
    if sigma_a is not None:
        kw["sigma_a"] = sigma_a
    if density is not None:
        kw.update(density=density, world_to_grid=grid_to_box(
            density.shape, (-1, -1, -1), (1, 1, 1)))
    med = b.add_medium(**kw)
    b.add_shape(mesh_mod.make_box([-1, -1, -1], [1, 1, 1]), glass,
                interior_medium=med)
    b.add_shape(mesh_mod.make_quad([-4, -1.05, -4], [4, -1.05, -4],
                                   [4, -1.05, 4], [-4, -1.05, 4]), grey)
    light = mesh_mod.make_quad([-1, 3.0, -1], [1, 3.0, -1],
                               [1, 3.0, 1], [-1, 3.0, 1])
    b.add_area_emitter_shape(light, lm, (14.0, 13.0, 12.0))
    cam = make_perspective(tf.look_at([0, 0.8, 4.2], [0, 0, 0],
                                      [0, 1, 0]), 35, 1.0)
    b.set_camera(cam, res, res)
    return b.build(backend="brute", device=device)


def fd_tank_scene(res: int, sigma_a=(0.5,) * 3, sigma_s=(0.4,) * 3,
                  device="cuda"):
    """tests/test_shape_media.py's _tank_scene, the scene of the
    reference's interior-sigma gradient gate (tests/test_grad.py:76-97):
    camera -> index-matched glass box holding an HG-free medium ->
    emissive wall; 14 triangles, brute."""
    from mitsuba_tpu_torch.core import transform as tf
    from mitsuba_tpu_torch.render import mesh as mesh_mod
    from mitsuba_tpu_torch.render.camera import make_perspective
    from mitsuba_tpu_torch.render.scene import SceneBuilder

    b = SceneBuilder()
    glass = b.materials.dielectric(int_ior=1.0, ext_ior=1.0)
    lm = b.materials.lambertian((0.0, 0.0, 0.0))
    med = b.add_medium(sigma_s, sigma_a, g=0.0)
    b.add_shape(mesh_mod.make_box([-1, -1, -1], [1, 1, 1]), glass,
                interior_medium=med)
    b.add_area_emitter_shape(mesh_mod.make_quad(
        [-3, -3, -2.5], [3, -3, -2.5], [3, 3, -2.5], [-3, 3, -2.5]), lm,
        (5.0, 5.0, 5.0))
    b.set_camera(make_perspective(tf.look_at([0, 0, 4], [0, 0, 0],
                                             [0, 1, 0]), 30, 1.0), res, res)
    return b.build(backend="brute", device=device)
