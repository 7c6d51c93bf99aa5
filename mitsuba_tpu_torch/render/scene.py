"""Scene container and builder (port of the parts of
mitsuba_tpu/render/scene.py that build bench configs 1 and 3).

A `Scene` holds the geometry, material, emitter and texture tables and the
camera, all on one device. `SceneBuilder` assembles them on the host;
shapes bind lambertian or phong materials (optionally checkerboard-
textured) and area emitters, and the builder's emitters may hold a
Preetham sky. Every other scene feature of the reference (analytic shapes,
media, instancing, other BSDFs, emitters and texture kinds) is not ported
yet.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from mitsuba_tpu.render import mesh as mesh_mod  # numpy only, jax-free
from mitsuba_tpu_torch.bsdfs import MaterialBuilder, MaterialTable
from mitsuba_tpu_torch.core import transform as tf
from mitsuba_tpu_torch.emitters import EmitterBuilder, EmitterTable
from mitsuba_tpu_torch.render.camera import Camera, make_perspective
from mitsuba_tpu_torch.render.intersect import GeometryTables, build_geometry
from mitsuba_tpu_torch.render.texture import TextureBuilder, TextureTable


@dataclass
class Scene:
    geom: GeometryTables
    materials: MaterialTable
    emitters: EmitterTable
    camera: Camera
    textures: TextureTable
    width: int = 256
    height: int = 256

    @property
    def device(self) -> torch.device:
        return self.geom.v0.device

    def to(self, device) -> "Scene":
        """The scene with every table moved to `device`."""
        def move(table):
            return dataclasses.replace(table, **{
                f.name: getattr(table, f.name).to(device)
                for f in dataclasses.fields(table)
                if isinstance(getattr(table, f.name), torch.Tensor)})

        return Scene(move(self.geom), move(self.materials),
                     move(self.emitters), move(self.camera),
                     move(self.textures), self.width, self.height)


class SceneBuilder:
    """Host-side scene assembly: shapes bind materials and area emitters."""

    def __init__(self):
        self.materials = MaterialBuilder()
        self.emitters = EmitterBuilder()
        self.textures = TextureBuilder()
        self._shapes = []     # (mesh, material_id, emitter_id, shape_id)
        self.camera = None
        self.width = 256
        self.height = 256

    def add_shape(self, mesh, material_id, emitter_id=-1):
        sid = len(self._shapes)
        self._shapes.append((mesh, material_id, emitter_id, sid))
        return sid

    def add_area_emitter_shape(self, mesh, material_id, radiance):
        eid = self.emitters.area(mesh, radiance)
        return self.add_shape(mesh, material_id, eid)

    def set_camera(self, camera: Camera, width: int, height: int):
        self.camera = camera
        self.width, self.height = width, height

    def build(self, backend: str = "brute", device="cpu") -> Scene:
        if not self._shapes:
            raise ValueError("scene has no shapes")
        geom = build_geometry(self._shapes, backend=backend)
        e1 = geom.e1.numpy()
        e2 = geom.e2.numpy()
        areas = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
        em = self.emitters.build(geom.emitter_id.numpy(), areas)
        cam = self.camera
        if cam is None:
            cam = make_perspective(np.eye(4), 45.0, self.width / self.height)
        scene = Scene(geom=geom, materials=self.materials.build(),
                      emitters=em, camera=cam,
                      width=self.width, height=self.height,
                      textures=self.textures.build())
        return scene.to(device)


def cornell_box(width=256, height=256, backend="brute", device="cpu") \
        -> Scene:
    """The Cornell box of bench config 1 (reference
    mitsuba_tpu/render/scene.py:328): 556 x 548.8 x 559.2 units, 32
    triangles, one area light."""
    b = SceneBuilder()
    white = b.materials.lambertian((0.725, 0.71, 0.68))
    red = b.materials.lambertian((0.63, 0.065, 0.05))
    green = b.materials.lambertian((0.14, 0.45, 0.091))
    light_mat = b.materials.lambertian((0.0, 0.0, 0.0))

    mq = mesh_mod.make_quad
    # floor / ceiling / back wall (normals inward)
    b.add_shape(mq([552.8, 0, 0], [0, 0, 0], [0, 0, 559.2], [549.6, 0, 559.2], "floor"), white)
    b.add_shape(mq([556, 548.8, 0], [556, 548.8, 559.2], [0, 548.8, 559.2], [0, 548.8, 0], "ceiling"), white)
    b.add_shape(mq([549.6, 0, 559.2], [0, 0, 559.2], [0, 548.8, 559.2], [556, 548.8, 559.2], "back"), white)
    b.add_shape(mq([0, 0, 559.2], [0, 0, 0], [0, 548.8, 0], [0, 548.8, 559.2], "right-green"), green)
    b.add_shape(mq([552.8, 0, 0], [549.6, 0, 559.2], [556, 548.8, 559.2], [556, 548.8, 0], "left-red"), red)

    # short block
    for q in [
        mq([130, 165, 65], [82, 165, 225], [240, 165, 272], [290, 165, 114]),
        mq([290, 0, 114], [290, 165, 114], [240, 165, 272], [240, 0, 272]),
        mq([130, 0, 65], [130, 165, 65], [290, 165, 114], [290, 0, 114]),
        mq([82, 0, 225], [82, 165, 225], [130, 165, 65], [130, 0, 65]),
        mq([240, 0, 272], [240, 165, 272], [82, 165, 225], [82, 0, 225]),
    ]:
        b.add_shape(q, white)
    # tall block
    for q in [
        mq([423, 330, 247], [265, 330, 296], [314, 330, 456], [472, 330, 406]),
        mq([423, 0, 247], [423, 330, 247], [472, 330, 406], [472, 0, 406]),
        mq([472, 0, 406], [472, 330, 406], [314, 330, 456], [314, 0, 456]),
        mq([314, 0, 456], [314, 330, 456], [265, 330, 296], [265, 0, 296]),
        mq([265, 0, 296], [265, 330, 296], [423, 330, 247], [423, 0, 247]),
    ]:
        b.add_shape(q, white)

    # light (slightly below the ceiling, facing down)
    light = mq([343, 548.7, 227], [343, 548.7, 332], [213, 548.7, 332], [213, 548.7, 227], "light")
    b.add_area_emitter_shape(light, light_mat, (18.4, 15.6, 8.0))

    cam = make_perspective(
        tf.look_at([278, 273, -800], [278, 273, 0], [0, 1, 0]),
        fov_deg=39.3077,
        aspect=width / height,
    )
    b.set_camera(cam, width, height)
    return b.build(backend=backend, device=device)


def textured_mesh_scene(width=256, height=256, backend="cluster",
                        device="cpu") -> Scene:
    """Bench config 3 (reference mitsuba_tpu/render/scene.py:435): a
    101,762-triangle mesh — the reference's fallback when its bunny mesh
    is absent, a 160 x 320 sphere — with a phong body on a checkerboard-
    textured floor under a Preetham sky."""
    b = SceneBuilder()
    tex = b.textures.checkerboard(bright=(0.7, 0.7, 0.7),
                                  dark=(0.2, 0.2, 0.25), uv_scale=(8.0, 8.0))
    floor_mat = b.materials.lambertian((1.0, 1.0, 1.0), tex_id=tex)
    body_mat = b.materials.phong(diffuse=(0.4, 0.3, 0.2),
                                 specular=(0.3,) * 3, exponent=40.0)
    b.add_shape(mesh_mod.make_sphere_mesh([0, 0.8, 0], 0.8, 160, 320),
                body_mat)
    b.add_shape(mesh_mod.make_quad([-6, 0, -6], [-6, 0, 6], [6, 0, 6],
                                   [6, 0, -6]), floor_mat)
    b.emitters.sky(turbidity=3.0, sun_dir=(0.35, 0.6, -0.5), scale=1.0)
    cam = make_perspective(
        tf.look_at([0, 1.4, -3.2], [0, 0.7, 0], [0, 1, 0]),
        fov_deg=40.0, aspect=width / height,
    )
    b.set_camera(cam, width, height)
    return b.build(backend=backend, device=device)
