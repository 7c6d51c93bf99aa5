"""Scenes of n spectral channels, for either package (numpy only: pass the
package's builder modules, as tests/torch_bsdf_cases.py `port_modules`
gives them, and its `core.spectral` module).

- `furnace(mods, albedo, radiance, res)`: tests/test_spectral.py:56's
  closed emitting lambertian sphere with the camera inside; channel c
  reads Le_c * sum_{k < D} a_c^k at depth D.
- `upsampled_furnace(sp, n)`: the RGB albedo and emission of
  tests/test_spectral.py:101 upsampled to n bins (clipped as there).
- `cornell_n(mods, sp, n, width, height)`: bench config 1's Cornell box
  (render/scene.py `cornell_box`) with every colour upsampled to n bins
  by `sp.from_rgb`, the albedos clipped to [0, 0.95] and the radiance at
  0 from below, as tests/test_spectral.py clips its furnace.
"""
import numpy as np

N_CH = 8
FURNACE_SEED = 5        # tests/test_spectral.py:91


def furnace_colours(n=N_CH, seed=FURNACE_SEED):
    """tests/test_spectral.py:91-93's distinct per-channel albedo and
    emission."""
    rng = np.random.default_rng(seed)
    a = 0.2 + 0.6 * rng.random(n)
    le = 0.5 + rng.random(n)
    return a, le


def furnace_expected(a, le, depth):
    """Le_c * sum_{k < depth} a_c^k."""
    return le * sum(a ** k for k in range(depth))


def furnace(mods, albedo, radiance, res=16, backend="brute", **build_kw):
    b = mods.SceneBuilder()
    mat = b.materials.lambertian(tuple(albedo))
    sph = mods.mesh.make_sphere_mesh([0, 0, 0], 10.0, 24, 48)
    sph.faces = sph.faces[:, ::-1].copy()
    sph.normals = -sph.normals
    b.add_area_emitter_shape(sph, mat, tuple(radiance))
    cam = mods.make_perspective(
        mods.look_at([0, 0, 0.01], [0, 0, 5], [0, 1, 0]), 40.0, 1.0)
    b.set_camera(cam, res, res)
    return b.build(backend=backend, **build_kw)


def upsample(sp, rgb, n):
    """sp.from_rgb of rgb at n bins, as a float32 numpy array."""
    out = sp.from_rgb(np.asarray(rgb, np.float32), sp.SpectralBins(n))
    if hasattr(out, "detach"):
        out = out.detach().cpu()
    return np.asarray(out, np.float32)


def upsampled_furnace(sp, n=N_CH):
    """(a, le) of tests/test_spectral.py:106-111: RGB (0.7, 0.5, 0.3) and
    (1.0, 0.8, 0.6) upsampled, the albedo clipped to [0, 0.95]."""
    a = np.clip(upsample(sp, (0.7, 0.5, 0.3), n), 0.0, 0.95)
    le = np.maximum(upsample(sp, (1.0, 0.8, 0.6), n), 0.0)
    return a, le


def cornell_n(mods, sp, n=N_CH, width=256, height=256, backend="brute",
              **build_kw):
    def albedo(rgb):
        return tuple(np.clip(upsample(sp, rgb, n), 0.0, 0.95).tolist())

    b = mods.SceneBuilder()
    white = b.materials.lambertian(albedo((0.725, 0.71, 0.68)))
    red = b.materials.lambertian(albedo((0.63, 0.065, 0.05)))
    green = b.materials.lambertian(albedo((0.14, 0.45, 0.091)))
    light_mat = b.materials.lambertian((0.0,) * n)
    mq = mods.mesh.make_quad
    for quad, mat in (
            (([552.8, 0, 0], [0, 0, 0], [0, 0, 559.2], [549.6, 0, 559.2]),
             white),
            (([556, 548.8, 0], [556, 548.8, 559.2], [0, 548.8, 559.2],
              [0, 548.8, 0]), white),
            (([549.6, 0, 559.2], [0, 0, 559.2], [0, 548.8, 559.2],
              [556, 548.8, 559.2]), white),
            (([0, 0, 559.2], [0, 0, 0], [0, 548.8, 0], [0, 548.8, 559.2]),
             green),
            (([552.8, 0, 0], [549.6, 0, 559.2], [556, 548.8, 559.2],
              [556, 548.8, 0]), red)):
        b.add_shape(mq(*quad), mat)
    for quad in (
            ([130, 165, 65], [82, 165, 225], [240, 165, 272],
             [290, 165, 114]),
            ([290, 0, 114], [290, 165, 114], [240, 165, 272], [240, 0, 272]),
            ([130, 0, 65], [130, 165, 65], [290, 165, 114], [290, 0, 114]),
            ([82, 0, 225], [82, 165, 225], [130, 165, 65], [130, 0, 65]),
            ([240, 0, 272], [240, 165, 272], [82, 165, 225], [82, 0, 225]),
            ([423, 330, 247], [265, 330, 296], [314, 330, 456],
             [472, 330, 406]),
            ([423, 0, 247], [423, 330, 247], [472, 330, 406], [472, 0, 406]),
            ([472, 0, 406], [472, 330, 406], [314, 330, 456], [314, 0, 456]),
            ([314, 0, 456], [314, 330, 456], [265, 330, 296], [265, 0, 296]),
            ([265, 0, 296], [265, 330, 296], [423, 330, 247],
             [423, 0, 247])):
        b.add_shape(mq(*quad), white)
    light = mq([343, 548.7, 227], [343, 548.7, 332], [213, 548.7, 332],
               [213, 548.7, 227])
    radiance = np.maximum(upsample(sp, (18.4, 15.6, 8.0), n), 0.0)
    b.add_area_emitter_shape(light, light_mat, tuple(radiance.tolist()))
    cam = mods.make_perspective(
        mods.look_at([278, 273, -800], [278, 273, 0], [0, 1, 0]),
        fov_deg=39.3077, aspect=width / height)
    b.set_camera(cam, width, height)
    return b.build(backend=backend, **build_kw)
