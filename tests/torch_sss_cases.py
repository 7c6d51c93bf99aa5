"""Scenes of the port's subsurface, guiding and motion slice, shared by its
tests and chip_smoke.py (numpy only: the caller passes either package's
builder modules, so nothing here imports JAX).

* `slab_scene`: tests/golden_scenes.py:144 `scene_sss_slab`, a dipole
  slab on a grey floor under an area light, brute backend; `profile`
  makes it the multipole twin (thickness 0.3, 3 extra dipoles) or the
  adipole one (anisotropy ratio 3 along x).
* `write_slab_xml`: the same scene as a scene file (OBJ meshes), its
  <subsurface> in one of `SLAB_SUBSURFACE`'s forms.
* `moving_box_builder`: tests/test_motion.py:25's moving box (a track
  from x = -1 to x = +1 across the shutter), as a builder.
* `write_motion_xml`: the same as a scene file, the box an
  `animatedinstance` of a shapegroup whose binary track the given
  package's `save_animated_transform` writes, shutterClose 1.
"""
from __future__ import annotations

import os
from types import SimpleNamespace

import numpy as np

SLAB_DEPTH = 4
SLAB = dict(sigma_s=(2.6, 3.2, 3.9), sigma_a=(0.002, 0.003, 0.01), eta=1.3)
# the twins' profile options (chip_smoke.py's sss_multipole, sss_adipole)
PROFILES = {"dipole": {},
            "multipole": dict(thickness=0.3, n_poles=3),
            "adipole": dict(aniso_ratio=3.0)}
# <subsurface> forms of the slab file: each gives SLAB's coefficients
# (sigmaT and albedo: sigma_s + sigma_a and sigma_s / sigma_t, so the
# rounding of their products is the loader's own)
SLAB_SUBSURFACE = {
    "dipole": '<subsurface type="dipole"><rgb name="sigmaS" '
              'value="2.6 3.2 3.9"/><rgb name="sigmaA" value="0.002 0.003 '
              '0.01"/><float name="eta" value="1.3"/>'
              '<integer name="irrSamples" value="$irr"/></subsurface>',
    "sigma_t": '<subsurface type="dipole"><rgb name="sigmaT" '
               'value="2.602 3.203 3.91"/><rgb name="albedo" value="0.99923'
               ' 0.99906 0.99744"/><float name="intIOR" value="1.3"/>'
               '<integer name="irrSamples" value="$irr"/></subsurface>',
    "int_ior": '<subsurface type="dipole"><rgb name="sigmaS" '
               'value="2.6 3.2 3.9"/><rgb name="sigmaA" value="0.002 0.003 '
               '0.01"/><float name="intIOR" value="1.69"/><float '
               'name="extIOR" value="1.3"/><float name="g" value="0.2"/>'
               '<spectrum name="ssFactor" value="0.8"/>'
               '<integer name="irrSamples" value="$irr"/></subsurface>',
    "marschner": '<subsurface type="marschner"/>',
    "multipole": '<subsurface type="multipole"><rgb name="sigmaS" '
                 'value="2.6 3.2 3.9"/><rgb name="sigmaA" value="0.002 '
                 '0.003 0.01"/><float name="eta" value="1.3"/><float '
                 'name="thickness" value="0.3"/><integer '
                 'name="extraDipoles" value="3"/><integer name="irrSamples"'
                 ' value="$irr"/></subsurface>',
    "adipole": '<subsurface type="adipole"><rgb name="sigmaS" '
               'value="2.6 3.2 3.9"/><rgb name="sigmaA" value="0.002 0.003 '
               '0.01"/><float name="eta" value="1.3"/><float '
               'name="anisoRatio" value="3"/><vector name="anisoDirection" '
               'x="1" y="0" z="0"/><integer name="irrSamples" '
               'value="$irr"/></subsurface>',
}


def port_modules():
    """The port's builder modules, as `slab_scene` takes them."""
    from mitsuba_tpu_torch.core import track
    from mitsuba_tpu_torch.core import transform as tf
    from mitsuba_tpu_torch.render import mesh
    from mitsuba_tpu_torch.render.camera import make_perspective
    from mitsuba_tpu_torch.render.scene import SceneBuilder

    return SimpleNamespace(SceneBuilder=SceneBuilder, mesh=mesh,
                           look_at=tf.look_at, track=track,
                           make_perspective=make_perspective)


def slab_scene(mods, res: int, profile: str = "dipole", n_points=512,
               **build_kw):
    """tests/golden_scenes.py:144 at res x res, under `profile`."""
    b = mods.SceneBuilder()
    skin = b.materials.lambertian((0.3, 0.25, 0.2))
    grey = b.materials.lambertian((0.5, 0.5, 0.5))
    black = b.materials.lambertian((0.0, 0.0, 0.0))
    b.add_shape(mods.mesh.make_box([-1, -0.25, -1], [1, 0.25, 1]), skin)
    b.add_subsurface(skin, n_points=n_points, profile=profile, **SLAB,
                     **PROFILES[profile])
    b.add_shape(mods.mesh.make_quad([-4, -0.3, -4], [4, -0.3, -4],
                                    [4, -0.3, 4], [-4, -0.3, 4]), grey)
    light = mods.mesh.make_quad([-0.8, 2.5, -0.8], [0.8, 2.5, -0.8],
                                [0.8, 2.5, 0.8], [-0.8, 2.5, 0.8])
    b.add_area_emitter_shape(light, black, (16.0, 15.0, 14.0))
    b.set_camera(mods.make_perspective(
        mods.look_at([0, 1.5, 3.4], [0, 0, 0], [0, 1, 0]), 35, 1.0),
        res, res)
    return b.build(backend="brute", **build_kw)


def _write_obj(path, quads):
    """Quads (4 points each, counter-clockwise from the normal's side) as
    an OBJ of two triangles each, as render/mesh.py make_quad splits."""
    lines = []
    for qi, q in enumerate(quads):
        for p in q:
            lines.append("v %r %r %r" % tuple(float(c) for c in p))
    for qi in range(len(quads)):
        a = 4 * qi + 1
        lines.append(f"f {a} {a + 1} {a + 2}")
        lines.append(f"f {a} {a + 2} {a + 3}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def box_quads(pmin, pmax):
    """render/mesh.py make_box's six quads."""
    x0, y0, z0 = pmin
    x1, y1, z1 = pmax
    return [
        [[x0, y0, z0], [x0, y1, z0], [x1, y1, z0], [x1, y0, z0]],
        [[x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1]],
        [[x0, y0, z0], [x1, y0, z0], [x1, y0, z1], [x0, y0, z1]],
        [[x0, y1, z0], [x0, y1, z1], [x1, y1, z1], [x1, y1, z0]],
        [[x0, y0, z0], [x0, y0, z1], [x0, y1, z1], [x0, y1, z0]],
        [[x1, y0, z0], [x1, y1, z0], [x1, y1, z1], [x1, y0, z1]],
    ]


_HEADER = """<?xml version="1.0" encoding="utf-8"?>
<scene>
 <integrator type="path"><integer name="maxDepth" value="$depth"/>
 </integrator>
 <camera type="perspective">
  <float name="fov" value="{fov}"/>{shutter}
  <transform name="toWorld"><lookAt {look}/></transform>
  <sampler type="independent"><integer name="sampleCount" value="$spp"/>
  </sampler>
  <film type="exrfilm"><integer name="width" value="$width"/>
   <integer name="height" value="$height"/><rfilter type="box"/></film>
 </camera>
"""


def write_slab_xml(dirname, form: str = "dipole") -> str:
    """`slab_scene` as dirname/sss_<form>.xml (and its OBJ meshes), the
    slab's <subsurface> SLAB_SUBSURFACE[form]; parameters $depth, $spp,
    $width, $height, $irr (irrSamples). Returns the file's path."""
    _write_obj(os.path.join(dirname, "slab.obj"),
               box_quads([-1, -0.25, -1], [1, 0.25, 1]))
    _write_obj(os.path.join(dirname, "floor.obj"), [
        [[-4, -0.3, -4], [4, -0.3, -4], [4, -0.3, 4], [-4, -0.3, 4]]])
    _write_obj(os.path.join(dirname, "light.obj"), [
        [[-0.8, 2.5, -0.8], [0.8, 2.5, -0.8], [0.8, 2.5, 0.8],
         [-0.8, 2.5, 0.8]]])
    body = _HEADER.format(
        fov=35, shutter="", look='ox="0" oy="1.5" oz="3.4" tx="0" ty="0" '
        'tz="0" ux="0" uy="1" uz="0"') + f"""
 <shape type="obj"><string name="filename" value="slab.obj"/>
  <boolean name="faceNormals" value="true"/>
  <bsdf type="diffuse"><rgb name="reflectance" value="0.3 0.25 0.2"/>
  </bsdf>{SLAB_SUBSURFACE[form]}</shape>
 <shape type="obj"><string name="filename" value="floor.obj"/>
  <boolean name="faceNormals" value="true"/>
  <bsdf type="diffuse"><rgb name="reflectance" value="0.5 0.5 0.5"/>
  </bsdf></shape>
 <shape type="obj"><string name="filename" value="light.obj"/>
  <boolean name="faceNormals" value="true"/>
  <luminaire type="area"><rgb name="intensity" value="16 15 14"/>
  </luminaire></shape>
</scene>
"""
    path = os.path.join(dirname, f"sss_{form}.xml")
    with open(path, "w") as f:
        f.write(body)
    return path


def _translate(x):
    m = np.eye(4)
    m[0, 3] = x
    return m


def moving_track(track_mod):
    """tests/test_motion.py:33's track: x from -1 at 0 to +1 at 1."""
    track = track_mod.AnimatedTransform()
    track.append_transform(0.0, _translate(-1.0))
    track.append_transform(1.0, _translate(1.0))
    return track


def moving_box_builder(mods, res: int, shutter_time: float):
    """tests/test_motion.py:25's moving box at res x res (a builder)."""
    b = mods.SceneBuilder()
    white = b.materials.lambertian((0.8, 0.8, 0.8))
    dark = b.materials.lambertian((0.05, 0.05, 0.05))
    b.add_shape(mods.mesh.make_quad([-5, -5, 0], [5, -5, 0], [5, 5, 0],
                                    [-5, 5, 0]), dark)
    box = mods.mesh.make_box([-0.3, -0.3, 0.2], [0.3, 0.3, 0.8])
    b.add_animated_shape(box, white, moving_track(mods.track))
    lm = b.materials.lambertian((0.0, 0.0, 0.0))
    b.add_area_emitter_shape(mods.mesh.make_quad(
        [-2, -2, 6], [-2, 2, 6], [2, 2, 6], [2, -2, 6]), lm, (20.0,) * 3)
    b.set_camera(mods.make_perspective(
        mods.look_at([0, -6, 3], [0, 0, 0.5], [0, 0, 1]), 45, 1.0,
        shutter_open=0.0, shutter_time=shutter_time), res, res)
    return b


def write_motion_xml(dirname, track_mod, shutter_close: float = 1.0) -> str:
    """`moving_box_builder` as dirname/motion.xml: the box an
    animatedinstance of a shapegroup, its track written by
    track_mod.save_animated_transform to dirname/box.track; parameters
    $depth, $spp, $width, $height. Returns the file's path."""
    _write_obj(os.path.join(dirname, "mfloor.obj"), [
        [[-5, -5, 0], [5, -5, 0], [5, 5, 0], [-5, 5, 0]]])
    _write_obj(os.path.join(dirname, "box.obj"),
               box_quads([-0.3, -0.3, 0.2], [0.3, 0.3, 0.8]))
    _write_obj(os.path.join(dirname, "mlight.obj"), [
        [[-2, -2, 6], [-2, 2, 6], [2, 2, 6], [2, -2, 6]]])
    track_mod.save_animated_transform(os.path.join(dirname, "box.track"),
                                      moving_track(track_mod))
    body = _HEADER.format(
        fov=45, shutter=f'\n  <float name="shutterOpen" value="0"/>'
        f'<float name="shutterClose" value="{shutter_close}"/>',
        look='ox="0" oy="-6" oz="3" tx="0" ty="0" tz="0.5" ux="0" uy="0" '
        'uz="1"') + """
 <shape type="obj"><string name="filename" value="mfloor.obj"/>
  <boolean name="faceNormals" value="true"/>
  <bsdf type="diffuse"><rgb name="reflectance" value="0.05 0.05 0.05"/>
  </bsdf></shape>
 <shape type="shapegroup" id="box">
  <shape type="obj"><string name="filename" value="box.obj"/>
   <boolean name="faceNormals" value="true"/>
   <bsdf type="diffuse"><rgb name="reflectance" value="0.8 0.8 0.8"/>
   </bsdf></shape>
 </shape>
 <shape type="animatedinstance"><ref id="box"/>
  <string name="filename" value="box.track"/></shape>
 <shape type="obj"><string name="filename" value="mlight.obj"/>
  <boolean name="faceNormals" value="true"/>
  <luminaire type="area"><rgb name="intensity" value="20 20 20"/>
  </luminaire></shape>
</scene>
"""
    path = os.path.join(dirname, "motion.xml")
    with open(path, "w") as f:
        f.write(body)
    return path
