"""Generate goldens of the PyTorch port: the JAX package's CPU renders,
committed to tests/torch_goldens/. The instanced ones render the layout
of tests/test_instancing.py (a floor, an area light, three instances of
one sphere group).

* instanced.npz: the group is bench config 3's body, a 160 x 320 sphere
  (101,760 triangles; 305,280 through the instances), 64 x 64 px, 16 spp,
  depth 5, seed 0 (scripts/gen_bench_goldens.py's recipe). chip_smoke.py
  gates the port's render of the same scene on it.
* instanced_32.npz: the 10 x 20 sphere of tests/test_instancing.py,
  32 x 32 px, 2 spp, depth 3, seed 0. tests/test_torch_instancing.py
  holds the port's CPU render to it per pixel.
* bvh_16.npz: bench config 3's scene (`textured_mesh_scene`, the sphere
  fallback) on the bvh backend, 16 x 16 px, 2 spp, depth 3, seed 0.
  tests/test_torch_bvh.py holds the port's CPU render to it per pixel.
* volpath_fog.npz: "fog", the Cornell box of bench config 1 (brute) in the
  homogeneous medium of tests/test_guiding.py (sigma_s 0.0015, sigma_a
  0.0003, HG g = 0.4: optical depth ~1 across the box), rendered by
  `render_volpath` (mis=True), 64 x 64 px, depth 5, seed 0, at 1,024 spp
  under "mean" (chip_smoke.py gates the port's render at the same size on
  it) and at 16 spp under "spp16" (the same lanes as the port's CPU render
  in tests/test_torch_volpath.py). The script also renders seed 1 at 1,024
  spp and prints the 8x8-block relative RMSE between the two seeds, the
  noise floor of the gate (0.22 at 16 spp, 0.053 at 512, so "mean" has
  1,024).

* snow.npz: scenes/snow.xml loaded by the JAX package's XML loader (the
  Wiscombe snow BRDF on four analytic spheres under the Preetham sky),
  48 x 48 px, depth 5, 256 spp, seed 1234, the scene's ldsampler pattern,
  per-pixel mean and sample variance ("mean", "var", "spp", "depth"), as
  tests/goldens/*.npz hold them for tests/test_goldens.py's |t| > 3.9
  rule; also the same at 32 x 32 px ("mean32", "var32", "spp32"), which
  tests/test_torch_snow.py holds the port's CPU render's mean to.
  chip_smoke.py's `golden_snow` gates the port's 48 x 48 x 128 render.
* bsdf_zoo.npz: tests/torch_bsdf_cases.py's zoo built by the JAX
  package's SceneBuilder, 48 x 48 px, depth 5, 256 spp, seed 1234,
  mean and variance as snow.npz; chip_smoke.py's `bsdf_zoo` gates the
  port's 48 x 48 x 128 render.
* lights.npz: the lights file of tests/torch_light_cases.py
  (`write_lights_scene`, its 1,024^2 floor EXR and 512 x 1,024 sky EXR:
  point, spot, directional, sphere and envmap lights on the two Cornell
  blocks), loaded by the JAX package's XML loader, 48 x 48 px, depth 5,
  256 spp, seed 1234, mean and variance as snow.npz; chip_smoke.py's
  `golden_lights` gates the port's 48 x 48 x 128 render.
* texture_mip.npz: tests/torch_light_cases.py's `mip_floor` (the
  receding checker floor of tests/test_mipmap.py:154, built with mips)
  rendered with `aniso_filter`, 48 x 48 px, depth 5, 256 spp, seed 1234,
  mean and variance; chip_smoke.py's `golden_textured` gates the port's
  48 x 48 x 128 render.

* cylinders.npz, cloth.npz: the files of tests/torch_leftover_cases.py
  `write_cylinders_xml` (scenes/cornell.xml's box with three analytic
  cylinders) and `write_cloth_xml` (a weave-file irawan floor and a
  procedural twill panel in the box), loaded by the JAX package's XML
  loader, 48 x 48 px, depth 5, 256 spp, seed 1234, mean and variance as
  snow.npz. Both are brute scenes: the JAX package renders them on its
  kernel path (the kernels' plain references, tests/torch_kernel_path.py),
  whose shading frame the port's brute backend builds (ROADMAP C, "two
  shading frames"; the cloth's yarns turn with it). chip_smoke.py's
  `golden_cylinders` and `golden_cloth` gate the port's 48 x 48 x 128
  renders.
* leftovers.npz: `write_leftovers_xml` at LEFT_CELLS^2 hspan cells and
  LEFT_FIBERS hair fibres (fewer than chip_smoke.py's leftovers_xml
  phase renders: the JAX package's CPU cluster path takes too long at
  full size) with its LEFT_TEX^2 JPEG ground and blackbody light, 48 x 48
  px, depth 5, 256 spp, seed 1234, mean and variance, and the counts
  ("cells", "fibers", "tex"); chip_smoke.py's `golden_leftovers` writes
  the same files and gates the port's 48 x 48 x 128 render.

* hair_cornell.npz: tests/torch_leftover_cases.py
  `write_hair_cornell_xml` (scenes/cornell.xml's box with analytic hair
  fibres of 16 points standing on its floor) at HAIR_FIBERS fibres, the
  count chip_smoke.py's hair_xml phase renders (15,000 segments; ~3 min
  on the CPU), loaded by the JAX package's XML loader and rendered on its
  kernel path, 48 x 48 px, depth 5, 256 spp,
  seed 1234, mean and variance, and the count ("fibers");
  chip_smoke.py's `golden_hair` writes the same file and gates the port's
  48 x 48 x 128 render by the |t| rule.
* integrators.npz: the images of the integrators outside the CLI
  (photonmap, ppm, photonmapper, sppm, irrcache, vpl, adaptive on
  `cornell_box(48, 48)`, bre in the fog of tests/test_guiding.py), each
  at its own defaults (photon counts, passes, cache and VPL counts),
  PathConfig(max_depth=5, spp=4), seed 0, the JAX package on its kernel
  path, one array a name; chip_smoke.py's `golden_integrators` renders
  the port's the same way and gates each by the relative RMSE of its
  8 x 8-block means.

`python scripts/gen_torch_goldens.py integrators_port` writes nothing: it
renders the port's eight integrator images the same way on the CPU and
prints each one's 8 x 8-block relative RMSE against integrators.npz (the
reading chip_smoke.py's limit is set from).

All store the image under "mean". Regenerate only after an intentional
change of the JAX package's estimator:

    python scripts/gen_torch_goldens.py [name ...]
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

DIR = os.path.join(ROOT, "tests", "torch_goldens")
PLACES = ((-2.0, 0.0, 1.0, 1.0), (2.0, 0.5, 1.2, 0.7), (0.0, 2.0, 0.8, 1.3))
GOLDENS = {
    # name: (px, n_theta, n_phi, spp, depth); n_theta None: config 3 bvh,
    # "fog": the volumetric Cornell box
    "instanced": (64, 160, 320, 16, 5),
    "instanced_32": (32, 10, 20, 2, 3),
    "bvh_16": (16, None, None, 2, 3),
    "volpath_fog": (64, "fog", None, 1024, 5),
    "snow": (48, "snow", None, 256, 5),
    "bsdf_zoo": (48, "zoo", None, 256, 5),
    "lights": (48, "lights", None, 256, 5),
    "texture_mip": (48, "mip", None, 256, 5),
    "cylinders": (48, "cylinders", None, 256, 5),
    "cloth": (48, "cloth", None, 256, 5),
    "leftovers": (48, "leftovers", None, 256, 5),
    "hair_cornell": (48, "hair_cornell", None, 256, 5),
    "integrators": (48, "integrators", None, 4, 5),
    "integrators_port": (48, "integrators_port", None, 4, 5),
}
HAIR_FIBERS = 1000                       # hair_cornell.npz
# the integrators' calls, each a function of (module, scene, cfg) with
# the package's own integrator modules; bre in FOG
INTEGRATORS = {
    "photonmap": lambda m, s, c: m.photonmap.photonmap_render(s, c),
    "ppm": lambda m, s, c: m.photonmap.ppm_render(s, c),
    "photonmapper": lambda m, s, c: m.photonmap.photonmapper_render(s, c),
    "sppm": lambda m, s, c: m.photonmap.sppm_render(s, c),
    "irrcache": lambda m, s, c: m.irrcache.irrcache_render(s, c),
    "vpl": lambda m, s, c: m.vpl.render_vpl(s, c),
    "adaptive": lambda m, s, c: m.adaptive.adaptive_render(s, c),
    "bre": lambda m, s, c: m.bre.bre_render(s, m.fog, c),
}
LEFT_CELLS, LEFT_FIBERS, LEFT_TEX = 64, 200, 1024   # leftovers.npz
LIGHTS_TEX, LIGHTS_ENV = 1024, 512      # the lights file's image sizes
STATS_SEED = 1234
FOG = dict(sigma_s=(0.0015,) * 3, sigma_a=(0.0003,) * 3, g=0.4)


def block_rel_rmse(img, ref, b=8):
    """bench.py's gate: relative RMSE of the 8x8-block means."""
    def blocks(a):
        h, w, c = a.shape
        return a.reshape(h // b, b, w // b, b, c).mean(axis=(1, 3))

    rb, ib = blocks(ref), blocks(img)
    return float(np.sqrt(np.mean((ib - rb) ** 2)) / rb.mean())


def render_fog(res, spp, depth, seed):
    from mitsuba_tpu.integrators.path import PathConfig
    from mitsuba_tpu.integrators.volpath import render_volpath
    from mitsuba_tpu.media import make_homogeneous
    from mitsuba_tpu.render.scene import cornell_box

    img, _ = render_volpath(
        cornell_box(res, res, backend="brute"), make_homogeneous(**FOG),
        PathConfig(max_depth=depth, spp=spp, remat=False), seed=seed)
    return np.asarray(img)


def instanced_scene(res, n_theta, n_phi):
    from mitsuba_tpu.core import transform as tf
    from mitsuba_tpu.render import mesh as mesh_mod
    from mitsuba_tpu.render.camera import make_perspective
    from mitsuba_tpu.render.scene import SceneBuilder

    b = SceneBuilder()
    white = b.materials.lambertian((0.7, 0.7, 0.7))
    red = b.materials.lambertian((0.7, 0.2, 0.2))
    b.add_shape(mesh_mod.make_quad([-6, -6, 0], [6, -6, 0], [6, 6, 0],
                                   [-6, 6, 0]), white)
    light_mat = b.materials.lambertian((0.0, 0.0, 0.0))
    b.add_area_emitter_shape(
        mesh_mod.make_quad([-2, -2, 8], [-2, 2, 8], [2, 2, 8], [2, -2, 8]),
        light_mat, (25.0,) * 3)
    b.set_camera(make_perspective(
        tf.look_at([0, -7, 4], [0, 0, 1], [0, 0, 1]), 50, 1.0), res, res)
    ball = mesh_mod.make_sphere_mesh([0, 0, 0], 1.0, n_theta, n_phi)
    gid = b.add_instanced_group([(ball, red)])
    for x, y, z, s in PLACES:
        m4 = np.diag([s, s, s, 1.0])
        m4[:3, 3] = (x, y, z)
        b.add_instance(gid, m4)
    return b.build(backend="cluster")


def render_stats(scene, depth, spp, seed, pattern="independent", **cfg):
    """Per-pixel mean and sample variance over spp samples, lanes in
    scanline order (tests/golden_scenes.py render_stats, with a
    pattern and PathConfig options)."""
    import jax.numpy as jnp

    from mitsuba_tpu.integrators.path import PathConfig, path_trace
    from mitsuba_tpu.render.sampler import Sampler, sample_position

    w, h = scene.width, scene.height
    lane = jnp.arange(w * h * spp)
    pixel_id = lane // spp
    sample_id = (lane % spp).astype(jnp.int32)
    sampler = Sampler(seed, pixel_id, sample_id)
    offset = sample_position(pattern, sample_id, spp, sampler.next_2d())
    uv = jnp.stack([((pixel_id % w) + offset[:, 0]) / w,
                    ((pixel_id // w) + offset[:, 1]) / h], -1)
    L, _ = path_trace(scene, scene.camera.sample_ray(uv), sampler,
                      PathConfig(max_depth=depth, spp=spp, remat=False,
                                 **cfg))
    Ls = np.asarray(L).reshape(h, w, spp, 3)
    return Ls.mean(axis=2), Ls.var(axis=2, ddof=1)


def snow_scene(res, spp, depth):
    from mitsuba_tpu.io.xml import load_scene

    return load_scene(os.path.join(ROOT, "scenes", "snow.xml"), params=dict(
        depth=depth, spp=spp, width=res, height=res))


def zoo_scene(res):
    from types import SimpleNamespace

    from mitsuba_tpu.core import microfacet as mf
    from mitsuba_tpu.core import transform as tf
    from mitsuba_tpu.render import mesh
    from mitsuba_tpu.render.camera import make_perspective
    from mitsuba_tpu.render.scene import SceneBuilder

    sys.path.insert(0, os.path.dirname(DIR))
    import torch_bsdf_cases as bc

    return bc.zoo_scene(SimpleNamespace(
        SceneBuilder=SceneBuilder, mesh=mesh, mf=mf, look_at=tf.look_at,
        make_perspective=make_perspective), res)


def light_cases():
    sys.path.insert(0, os.path.dirname(DIR))
    import torch_light_cases as lc

    return lc


def lights_scene(res, spp, depth):
    import tempfile

    from mitsuba_tpu.io.xml import load_scene

    with tempfile.TemporaryDirectory() as tmp:
        path = light_cases().write_lights_scene(tmp, LIGHTS_TEX, LIGHTS_ENV)
        return load_scene(path, params=dict(depth=depth, spp=spp,
                                             width=res, height=res))[0]


def mip_scene(res):
    from types import SimpleNamespace

    from mitsuba_tpu.core import transform as tf
    from mitsuba_tpu.render import mesh
    from mitsuba_tpu.render.camera import make_perspective
    from mitsuba_tpu.render.scene import SceneBuilder

    return light_cases().mip_floor(SimpleNamespace(
        SceneBuilder=SceneBuilder, mesh=mesh, look_at=tf.look_at,
        make_perspective=make_perspective), res, res)


def leftover_scene(name, res, spp, depth, tmp):
    """A file of tests/torch_leftover_cases.py written into tmp, loaded by
    the JAX package's XML loader."""
    from mitsuba_tpu.io.xml import load_scene

    sys.path.insert(0, os.path.dirname(DIR))
    import torch_leftover_cases as lc

    if name == "cylinders":
        path = lc.write_cylinders_xml(tmp)
    elif name == "cloth":
        path = lc.write_cloth_xml(tmp)
    else:
        path = lc.write_leftovers_xml(tmp, LEFT_CELLS, LEFT_FIBERS,
                                      LEFT_TEX)
    return load_scene(path, params=dict(depth=depth, spp=spp, width=res,
                                        height=res))


def leftover_golden(name, res, spp, depth):
    """cylinders.npz, cloth.npz and leftovers.npz: mean and variance; the
    brute scenes on the JAX package's kernel path."""
    import tempfile

    from _pytest.monkeypatch import MonkeyPatch

    sys.path.insert(0, os.path.dirname(DIR))
    import torch_kernel_path as kp

    with tempfile.TemporaryDirectory() as tmp:
        scene, cfg = leftover_scene(name, res, spp, depth, tmp)
        mp = MonkeyPatch()
        try:
            if scene.geom.backend == "brute":
                kp.kernel_path(mp, scene.geom)
            mean, var = render_stats(scene, depth, spp, STATS_SEED,
                                     cfg["pattern"])
        finally:
            mp.undo()
    extra = {}
    if name == "leftovers":
        extra = dict(cells=LEFT_CELLS, fibers=LEFT_FIBERS, tex=LEFT_TEX)
    np.savez_compressed(os.path.join(DIR, name + ".npz"), depth=depth,
                        mean=mean.astype(np.float32),
                        var=var.astype(np.float32), spp=spp, **extra)
    print(f"{name}: {res}x{res} px, {spp} spp, backend "
          f"{scene.geom.backend}, {scene.geom.n_tris} triangles, "
          f"mean={mean.mean():.6f}", flush=True)


def hair_golden(res, spp, depth):
    """hair_cornell.npz: mean and variance on the kernel path."""
    import tempfile

    from _pytest.monkeypatch import MonkeyPatch

    from mitsuba_tpu.io.xml import load_scene

    sys.path.insert(0, os.path.dirname(DIR))
    import torch_kernel_path as kp
    import torch_leftover_cases as lc

    with tempfile.TemporaryDirectory() as tmp:
        path = lc.write_hair_cornell_xml(tmp, HAIR_FIBERS)
        scene, cfg = load_scene(path, params=dict(depth=depth, spp=spp,
                                                  width=res, height=res))
        mp = MonkeyPatch()
        try:
            kp.kernel_path(mp, scene.geom)
            mean, var = render_stats(scene, depth, spp, STATS_SEED,
                                     cfg["pattern"])
        finally:
            mp.undo()
    np.savez_compressed(os.path.join(DIR, "hair_cornell.npz"), depth=depth,
                        mean=mean.astype(np.float32),
                        var=var.astype(np.float32), spp=spp,
                        fibers=HAIR_FIBERS)
    print(f"hair_cornell: {res}x{res} px, {spp} spp, {HAIR_FIBERS} fibres, "
          f"{scene.geom.n_hair} segments, mean={mean.mean():.6f}",
          flush=True)


def integrators_golden(res, spp, depth):
    """integrators.npz: each integrator's image at its defaults."""
    import time
    from types import SimpleNamespace

    from _pytest.monkeypatch import MonkeyPatch

    from mitsuba_tpu.integrators import (
        adaptive, bre, irrcache, photonmap, vpl,
    )
    from mitsuba_tpu.integrators.path import PathConfig
    from mitsuba_tpu.media import make_homogeneous
    from mitsuba_tpu.render.scene import cornell_box

    sys.path.insert(0, os.path.dirname(DIR))
    import torch_kernel_path as kp

    mods = SimpleNamespace(photonmap=photonmap, irrcache=irrcache, vpl=vpl,
                           adaptive=adaptive, bre=bre,
                           fog=make_homogeneous(**FOG))
    scene = cornell_box(res, res)
    cfg = PathConfig(max_depth=depth, spp=spp, remat=False)
    out = {}
    mp = MonkeyPatch()
    try:
        kp.kernel_path(mp, scene.geom)
        for name, fn in INTEGRATORS.items():
            t0 = time.perf_counter()
            out[name] = np.asarray(fn(mods, scene, cfg)[0], np.float32)
            print(f"integrators/{name}: mean={out[name].mean():.6f} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
    finally:
        mp.undo()
    np.savez_compressed(os.path.join(DIR, "integrators.npz"), depth=depth,
                        spp=spp, **out)


def integrators_port_reading(res, spp, depth):
    """The port's CPU images against integrators.npz, by block_rel_rmse."""
    from types import SimpleNamespace

    from mitsuba_tpu_torch.integrators import (
        adaptive, bre, irrcache, photonmap, vpl,
    )
    from mitsuba_tpu_torch.integrators.path import PathConfig
    from mitsuba_tpu_torch.media import make_homogeneous
    from mitsuba_tpu_torch.render.scene import cornell_box

    golden = np.load(os.path.join(DIR, "integrators.npz"))
    mods = SimpleNamespace(photonmap=photonmap, irrcache=irrcache, vpl=vpl,
                           adaptive=adaptive, bre=bre,
                           fog=make_homogeneous(**FOG))
    scene = cornell_box(res, res, device="cpu")
    cfg = PathConfig(max_depth=depth, spp=spp)
    for name, fn in INTEGRATORS.items():
        img = fn(mods, scene, cfg)[0].numpy()
        print(f"integrators_port/{name}: block rel RMSE "
              f"{block_rel_rmse(img, golden[name]):.3e}", flush=True)


def stats_golden(name, res, spp, depth):
    """snow.npz, bsdf_zoo.npz, lights.npz and texture_mip.npz: mean and
    variance, as tests/goldens."""
    out = {}
    sizes = ((res, ""), (32, "32")) if name == "snow" else ((res, ""),)
    for r, key in sizes:
        cfg = {}
        pattern = "independent"
        if name == "snow":
            scene, scfg = snow_scene(r, spp, depth)
            pattern = scfg["pattern"]
        elif name == "lights":
            scene = lights_scene(r, spp, depth)
        elif name == "texture_mip":
            scene, cfg = mip_scene(r), dict(aniso_filter=True)
        else:
            scene = zoo_scene(r)
        mean, var = render_stats(scene, depth, spp, STATS_SEED, pattern,
                                 **cfg)
        out.update({f"mean{key}": mean.astype(np.float32),
                    f"var{key}": var.astype(np.float32),
                    f"spp{key}": spp})
        print(f"{name}{key}: {r}x{r} px, {spp} spp, pattern {pattern}, "
              f"mean={mean.mean():.6f}", flush=True)
    np.savez_compressed(os.path.join(DIR, name + ".npz"), depth=depth,
                        **out)


def main():
    from mitsuba_tpu.integrators.path import PathConfig, render

    names = sys.argv[1:] or [k for k in GOLDENS if k != "integrators_port"]
    for name in names:
        res, n_theta, n_phi, spp, depth = GOLDENS[name]
        if n_theta in ("snow", "zoo", "lights", "mip"):
            stats_golden(name, res, spp, depth)
            continue
        if n_theta in ("cylinders", "cloth", "leftovers"):
            leftover_golden(name, res, spp, depth)
            continue
        if n_theta == "hair_cornell":
            hair_golden(res, spp, depth)
            continue
        if n_theta == "integrators":
            integrators_golden(res, spp, depth)
            continue
        if n_theta == "integrators_port":
            integrators_port_reading(res, spp, depth)
            continue
        if n_theta == "fog":
            img = render_fog(res, spp, depth, seed=0)
            spread = block_rel_rmse(render_fog(res, spp, depth, seed=1), img)
            img16 = render_fog(res, 16, depth, seed=0)
            np.savez_compressed(os.path.join(DIR, name + ".npz"), mean=img,
                                spp16=img16)
            print(f"{name}: mean={img.mean():.6f} ({spp} spp), "
                  f"{img16.mean():.6f} (16 spp); seed 1 vs seed 0 block rel "
                  f"RMSE at {spp} spp {spread:.4f} -> {name}.npz",
                  flush=True)
            continue
        if n_theta is None:
            from mitsuba_tpu.render.scene import textured_mesh_scene

            scene = textured_mesh_scene(res, res, backend="bvh")
        else:
            scene = instanced_scene(res, n_theta, n_phi)
        img, _ = render(scene, PathConfig(max_depth=depth, spp=spp,
                                          remat=False), seed=0)
        img = np.asarray(img)
        np.savez_compressed(os.path.join(DIR, name + ".npz"), mean=img)
        print(f"{name}: mean={img.mean():.6f} -> {name}.npz", flush=True)


if __name__ == "__main__":
    main()
