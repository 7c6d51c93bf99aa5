"""Inputs of the lights, textures and cameras tests and of chip_smoke.py's
`lights_xml`, `textured_mip`, `textured_bvh` and `golden_*` phases
(numpy only; the images are made from a seed).

`write_lights_scene(dir)` writes `lights.xml` beside its files: the
Cornell box's two blocks (scenes/meshes/cbox_short.obj and cbox_tall.obj)
on a textured floor quad, 22 triangles, so the brute backend; a bitmap
EXR on the floor; one analytic sphere light; a point, a spot and a
directional light; and a lat-long EXR environment map with `toWorld` and
`intensityScale`. `camera="orthographic"` gives the same file with an
orthographic camera.

`mip_floor(mods, ...)` builds tests/test_mipmap.py's receding floor with
either package's modules (`stripes` gives the image of its EWA test);
`grad_quad` the scene of tests/test_grad.py's texel gradient;
`textured_bvh_scene` bench config 3's scene with a bitmap floor.
"""
from __future__ import annotations

import os

import numpy as np

from mitsuba_tpu_torch.io.bitmap import write_exr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = os.path.join(REPO, "scenes", "meshes")

FLOOR_OBJ = """v -100 0 -100
v 656 0 -100
v 656 0 660
v -100 0 660
vt 0 0
vt 1 0
vt 1 1
vt 0 1
f 1/1 4/4 3/3
f 1/1 3/3 2/2
"""

LIGHTS_XML = """<?xml version="1.0" encoding="utf-8"?>
<scene>
 <integrator type="path"><integer name="maxDepth" value="$depth"/></integrator>
 {camera}
 <luminaire type="point">
  <point name="position" x="150" y="420" z="120"/>
  <rgb name="intensity" value="30000 26000 22000"/>
 </luminaire>
 <luminaire type="spot">
  <transform name="toWorld"><lookAt ox="460" oy="480" oz="60" tx="330"
   ty="0" tz="330" ux="0" uy="1" uz="0"/></transform>
  <float name="cutoffAngle" value="28"/>
  <rgb name="intensity" value="60000 70000 90000"/>
 </luminaire>
 <luminaire type="directional">
  <vector name="direction" x="0.35" y="-1" z="0.25"/>
  <rgb name="intensity" value="0.6 0.55 0.5"/>
 </luminaire>
 <luminaire type="envmap">
  <string name="filename" value="sky.exr"/>
  <float name="intensityScale" value="0.4"/>
  <transform name="toWorld"><rotate x="1" angle="-90"/>
   <rotate y="1" angle="35"/></transform>
 </luminaire>
 <bsdf id="white" type="diffuse"><rgb name="reflectance" value="0.725 0.71 0.68"/></bsdf>
 <shape type="obj"><string name="filename" value="floor.obj"/>
  <bsdf type="diffuse"><texture type="exrtexture" name="reflectance">
   <string name="filename" value="floor.exr"/>
   <float name="uscale" value="4"/><float name="vscale" value="4"/>
  </texture></bsdf></shape>
 <shape type="obj"><string name="filename" value="{meshes}/cbox_short.obj"/><ref id="white"/></shape>
 <shape type="obj"><string name="filename" value="{meshes}/cbox_tall.obj"/>
  <bsdf type="diffuse"><rgb name="reflectance" value="0.63 0.4 0.3"/></bsdf></shape>
 <shape type="sphere"><point name="center" x="300" y="420" z="250"/>
  <float name="radius" value="35"/>
  <luminaire type="area"><rgb name="intensity" value="40 36 30"/></luminaire></shape>
</scene>
"""

PERSPECTIVE = """<camera type="perspective">
  <float name="fov" value="39.3077"/>
  <transform name="toWorld"><lookAt ox="278" oy="273" oz="-800" tx="278"
   ty="273" tz="0" ux="0" uy="1" uz="0"/></transform>
  <sampler type="independent"><integer name="sampleCount" value="$spp"/></sampler>
  <film type="exrfilm"><integer name="width" value="$width"/>
   <integer name="height" value="$height"/><rfilter type="box"/></film>
 </camera>"""

ORTHOGRAPHIC = """<camera type="orthographic">
  <transform name="toWorld"><scale x="320" y="320"/><lookAt ox="278"
   oy="600" oz="-500" tx="278" ty="100" tz="300" ux="0" uy="1" uz="0"/>
  </transform>
  <sampler type="independent"><integer name="sampleCount" value="$spp"/></sampler>
  <film type="exrfilm"><integer name="width" value="$width"/>
   <integer name="height" value="$height"/><rfilter type="box"/></film>
 </camera>"""


def floor_image(n, seed=0):
    """An (n, n, 3) floor texture: tiles of seeded colours under a fine
    grid of lines, so that it has detail at every MIP level."""
    rng = np.random.default_rng(seed)
    tiles = rng.uniform(0.15, 0.85, (8, 8, 3)).astype(np.float32)
    yy, xx = np.mgrid[0:n, 0:n]
    img = tiles[(yy * 8) // n, (xx * 8) // n]
    lines = ((xx % max(n // 32, 2)) == 0) | ((yy % max(n // 32, 2)) == 0)
    img = np.where(lines[..., None], 0.05, img)
    return img.astype(np.float32)


def sky_image(h, w, seed=0):
    """An (h, 2h) lat-long map: a bright seeded sun blob on a smooth
    gradient from the pole to the horizon, and a dim ground."""
    rng = np.random.default_rng(seed)
    theta = (np.arange(h) + 0.5) / h * np.pi
    phi = (np.arange(w) + 0.5) / w * 2.0 * np.pi
    tt, pp = np.meshgrid(theta, phi, indexing="ij")
    base = np.where(tt < np.pi / 2,
                    0.3 + 0.7 * np.cos(tt), 0.05)[..., None] \
        * np.array([0.5, 0.7, 1.0], np.float32)
    st, sp = rng.uniform(0.3, 1.0), rng.uniform(0.0, 2.0 * np.pi)
    cosg = (np.sin(tt) * np.sin(st) * np.cos(pp - sp)
            + np.cos(tt) * np.cos(st))
    sun = 60.0 * np.exp((cosg - 1.0) * 400.0)[..., None]
    return (base + sun * np.array([1.0, 0.9, 0.7])).astype(np.float32)


def write_lights_scene(dirname, tex_res=64, env_h=16,
                       camera="perspective"):
    """Write lights.xml, floor.obj, floor.exr (tex_res^2) and sky.exr
    (env_h x 2 env_h) into dirname; returns the XML's path."""
    with open(os.path.join(dirname, "floor.obj"), "w") as f:
        f.write(FLOOR_OBJ)
    write_exr(os.path.join(dirname, "floor.exr"), floor_image(tex_res))
    write_exr(os.path.join(dirname, "sky.exr"), sky_image(env_h, 2 * env_h))
    cam = ORTHOGRAPHIC if camera == "orthographic" else PERSPECTIVE
    path = os.path.join(dirname, "lights.xml" if camera == "perspective"
                        else f"lights_{camera}.xml")
    with open(path, "w") as f:
        f.write(LIGHTS_XML.format(camera=cam, meshes=MESHES))
    return path


def checker(n=64, cell=4):
    """tests/test_mipmap.py's (n, n, 3) 0/1 checker of cell-texel cells."""
    yy, xx = np.mgrid[0:n, 0:n]
    img = (((xx // cell) + (yy // cell)) % 2).astype(np.float32)
    return np.repeat(img[:, :, None], 3, 2)


def stripes(n=128, period=4):
    """Stripes along v only (tests/test_mipmap.py's EWA floor)."""
    yy = np.mgrid[0:n, 0:n][0]
    return np.repeat(((yy // period) % 2).astype(np.float32)[:, :, None],
                     3, 2)


def mip_floor(mods, width, height, image=None, uv_scale=(40.0, 40.0),
              build_mips=True, backend="brute", **build_kw):
    """tests/test_mipmap.py:154's receding floor: a 100 x 100 quad under
    one overhead area light, a bitmap (the 128^2 checker by default) at
    `uv_scale`. mods: SceneBuilder, mesh, look_at, make_perspective of
    either package."""
    b = mods.SceneBuilder(build_mips=build_mips)
    tid = b.textures.bitmap(checker(128) if image is None else image,
                            gamma=1.0, uv_scale=uv_scale)
    floor = b.materials.lambertian((1.0, 1.0, 1.0), tex_id=tid)
    lm = b.materials.lambertian((0.0, 0.0, 0.0))
    quad = mods.mesh.make_quad
    b.add_shape(quad([-50, 0, -50], [-50, 0, 50], [50, 0, 50],
                     [50, 0, -50]), floor)
    b.add_area_emitter_shape(quad([-2, 8, -2], [2, 8, -2], [2, 8, 2],
                                  [-2, 8, 2]), lm, (30.0, 30.0, 30.0))
    b.set_camera(mods.make_perspective(mods.look_at(
        [0, 1.2, 6], [0, 0.6, 0], [0, 1, 0]), 55, width / height),
        width, height)
    return b.build(backend=backend, **build_kw)


def grad_image(seed=3, n=4):
    """tests/test_grad.py:112's (n, n, 3) texel values."""
    return np.random.default_rng(seed).uniform(
        0.2, 0.8, (n, n, 3)).astype(np.float32)


def grad_quad(mods, width=12, height=12, backend="auto", **build_kw):
    """tests/test_grad.py:100's scene: a bitmap-textured quad facing the
    camera and an area light behind it. Returns the scene."""
    b = mods.SceneBuilder()
    tid = b.textures.bitmap(grad_image(), gamma=1.0)
    mat = b.materials.lambertian((1.0, 1.0, 1.0), tex_id=tid)
    quad = mods.mesh.make_quad
    b.add_shape(quad([-1, 1, 0], [1, 1, 0], [1, -1, 0], [-1, -1, 0]), mat)
    lm = b.materials.lambertian((0.0, 0.0, 0.0))
    b.add_area_emitter_shape(quad([-1, -1, -3], [1, -1, -3], [1, 1, -3],
                                  [-1, 1, -3]), lm, (8.0,) * 3)
    b.set_camera(mods.make_perspective(mods.look_at(
        [0, 0, -2.5], [0, 0, 0], [0, 1, 0]), 45, width / height),
        width, height)
    return b.build(backend=backend, **build_kw)


def textured_bvh_scene(mods, width, height, tex_res=1024, **build_kw):
    """Bench config 3's scene (`textured_mesh_scene`: the 160 x 320
    sphere, 101,762 triangles, under the sky) with its floor's
    checkerboard replaced by a tex_res^2 bitmap (`floor_image`) at uv
    scale 8, built with mips, on the bvh backend."""
    b = mods.SceneBuilder(build_mips=True)
    tex = b.textures.bitmap(floor_image(tex_res), gamma=1.0,
                            uv_scale=(8.0, 8.0))
    floor_mat = b.materials.lambertian((1.0, 1.0, 1.0), tex_id=tex)
    body_mat = b.materials.phong(diffuse=(0.4, 0.3, 0.2),
                                 specular=(0.3,) * 3, exponent=40.0)
    b.add_shape(mods.mesh.make_sphere_mesh([0, 0.8, 0], 0.8, 160, 320),
                body_mat)
    b.add_shape(mods.mesh.make_quad([-6, 0, -6], [-6, 0, 6], [6, 0, 6],
                                    [6, 0, -6]), floor_mat)
    b.emitters.sky(turbidity=3.0, sun_dir=(0.35, 0.6, -0.5), scale=1.0)
    b.set_camera(mods.make_perspective(mods.look_at(
        [0, 1.4, -3.2], [0, 0.7, 0], [0, 1, 0]), 40.0, width / height),
        width, height)
    return b.build(backend="bvh", **build_kw)
