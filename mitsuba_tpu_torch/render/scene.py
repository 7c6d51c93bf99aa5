"""Scene container and builder (port of the parts of
mitsuba_tpu/render/scene.py that build bench configs 1, 2 and 3 and
instanced scenes, and shape-interior media).

A `Scene` holds the geometry, material, emitter and texture tables and the
camera, all on one device: the card unless the caller passes
`device="cpu"` (without a CUDA device any other request raises).
`SceneBuilder` assembles them on the host; triangle shapes, analytic
spheres and analytic open cylinders bind any material of
`bsdfs.MaterialBuilder` (the woven cloth's included), triangle shapes
and spheres also area emitters, the
builder's emitters may hold point, spot, directional, collimated,
constant, image-map and Preetham-sky lights, textures may be constant,
checkerboard, grid, vertex colours or bitmaps (with MIP pyramids under
`build_mips`), and groups of shapes may be
placed as true instances (one shared copy of their triangles, cluster
backend). Triangle shapes, spheres and cylinders may bound an interior
medium
(`add_medium`, homogeneous or a density grid): the scene then carries a
`media.medium.MediumStack` and each shape's medium index, which
`integrators/volpath.py` `render_volpath_media` renders. An ambient
medium is not part of the scene: it is passed to `render_volpath`. A
material may carry a subsurface entry (`add_subsurface`: dipole,
multipole or adipole): the scene then carries a
`subsurface.dipole.SceneSubsurface`, its points sampled at build time and
its irradiance filled by the first render. A shape may move along an
animated transform (`add_animated_shape`, core/track.py): `build` bakes
it at a time (the camera's shutter-open by default), `build_time_scenes`
at stratified times across the shutter for `render_motion`. Analytic
hair (`add_hair`) is a set of exact cylinder segments in a BVH of their
own (render/intersect.py).

A scene's tensors may require grad: `integrators/path.py` then
differentiates a render with respect to them (materials and emitter
radiance, texture images; a tensor that moves a ray, such as the
geometry, is refused by the kernels' wrappers).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from mitsuba_tpu_torch.bsdfs import MaterialBuilder, MaterialTable
from mitsuba_tpu_torch.core import microfacet as mf
from mitsuba_tpu_torch.core import transform as tf
from mitsuba_tpu_torch.emitters import EmitterBuilder, EmitterTable
from mitsuba_tpu_torch.render.camera import Camera, make_perspective
from mitsuba_tpu_torch.render import mesh as mesh_mod
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
    # shape-interior media: the stack, and each shape's medium index
    # (S,) int32, -1 = none; both None when no shape has a medium
    media: object = None
    shape_interior: torch.Tensor = None
    # subsurface entries (subsurface/dipole.py SceneSubsurface), None when
    # no material carries one
    subsurface: object = None

    @property
    def device(self) -> torch.device:
        return self.geom.v0.device

    def to(self, device) -> "Scene":
        """The scene with every table moved to `device`."""
        check_device(device)
        def move(table):
            return dataclasses.replace(table, **{
                f.name: getattr(table, f.name).to(device)
                for f in dataclasses.fields(table)
                if isinstance(getattr(table, f.name), torch.Tensor)})

        return Scene(self.geom.to(device), self.materials.to(device),
                     move(self.emitters), move(self.camera),
                     self.textures.to(device), self.width, self.height,
                     None if self.media is None else self.media.to(device),
                     None if self.shape_interior is None
                     else self.shape_interior.to(device),
                     None if self.subsurface is None
                     else self.subsurface.to(device))


def check_device(device):
    """Raise for a CUDA device where there is none: the port never falls
    back to the CPU unless the caller asks for it."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run on the CPU")


class SceneBuilder:
    """Host-side scene assembly: shapes bind materials and area emitters."""

    def __init__(self, build_mips: bool = False):
        self.materials = MaterialBuilder()
        self.emitters = EmitterBuilder()
        self.textures = TextureBuilder(build_mips=build_mips)
        self._shapes = []     # (mesh, material_id, emitter_id, shape_id)
        self._spheres = []    # (centre, radius, material_id, -1, shape_id)
        # (p0, p1, radius, material_id, emitter_id, shape_id)
        self._cylinders = []
        self._hair = []       # (segments dict, material_id, shape_id)
        # shared id space: meshes, spheres, cylinders, hair
        self._n_shapes = 0
        self._inst_groups = []   # [[(mesh, material_id, shape_id), ...]]
        self._instances = []     # [(group id, 4x4 to_world), ...]
        self._shape_interior = []   # per shape id: medium index or -1
        self._media = []            # (sigma_s, sigma_a, g) or grid dicts
        self._subsurface = []       # dicts: material_id, sigma_s, ...
        self._animated = []         # (mesh, material_id, emitter_id, track)
        self.camera = None
        self.width = 256
        self.height = 256

    def add_medium(self, sigma_s, sigma_a, g: float = 0.0, density=None,
                   world_to_grid=None, density_scale: float = 1.0) -> int:
        """Register a medium; returns its index for add_shape's and
        add_sphere's `interior_medium` (scene.py:75). density (D, H, W)
        and world_to_grid make it a grid medium (heterogeneous.cpp:79-96)."""
        if density is None:
            self._media.append((tuple(sigma_s), tuple(sigma_a), float(g)))
        else:
            self._media.append(dict(
                sigma_s=tuple(sigma_s), sigma_a=tuple(sigma_a), g=float(g),
                density=density, world_to_grid=world_to_grid,
                density_scale=float(density_scale)))
        return len(self._media) - 1

    def add_subsurface(self, material_id: int, sigma_s, sigma_a,
                       g: float = 0.0, eta: float = 1.33,
                       ss_factor=(1.0, 1.0, 1.0), n_points: int = 512,
                       profile: str = "dipole", thickness: float = 1.0,
                       n_poles: int = 3, aniso_dir=(1.0, 0.0, 0.0),
                       aniso_ratio: float = 2.0):
        """Attach a subsurface entry to every shape of material_id
        (reference <subsurface type="dipole">, dipole.cpp:362-468;
        scene.py:81). profile: 'dipole', 'multipole' (a thin slab of
        `thickness`, 2·n_poles + 1 pole pairs; multipole.cpp) or 'adipole'
        (a metric stretched by aniso_ratio along aniso_dir; adipole.cpp).
        Its n_points are sampled at build time, their irradiance at the
        first render."""
        self._subsurface.append(dict(
            material_id=int(material_id), sigma_s=tuple(sigma_s),
            sigma_a=tuple(sigma_a), g=float(g), eta=float(eta),
            ss_factor=tuple(ss_factor), n_points=int(n_points),
            profile=str(profile), thickness=float(thickness),
            n_poles=int(n_poles), aniso_dir=tuple(aniso_dir),
            aniso_ratio=float(aniso_ratio)))

    def add_animated_shape(self, mesh, material_id, track,
                           emitter_id: int = -1):
        """A shape in object space moving along `track` (an
        AnimatedTransform; reference animatedinstance.cpp, scene.py:193).
        `build` bakes it at one time, after every static shape."""
        self._animated.append((mesh, int(material_id), int(emitter_id),
                               track))

    def build_time_scenes(self, n_bins: int, backend: str = "auto",
                          device="cuda", ex_walk=None):
        """Scenes baked at n_bins stratified times across the camera's
        shutter, open + (k + 0.5) / n_bins * time (scene.py:203):
        `render_motion` averages their renders."""
        so = float(self.camera.shutter_open) if self.camera else 0.0
        st = float(self.camera.shutter_time) if self.camera else 0.0
        return [self.build(backend=backend, device=device, ex_walk=ex_walk,
                           time=so + (k + 0.5) / n_bins * st)
                for k in range(n_bins)]

    def add_shape(self, mesh, material_id, emitter_id=-1,
                  interior_medium: int = -1):
        sid = self._n_shapes
        self._n_shapes += 1
        self._shapes.append((mesh, material_id, emitter_id, sid))
        self._shape_interior.append(int(interior_medium))
        return sid

    def add_sphere(self, center, radius, material_id, emitter_id=-1,
                   interior_medium: int = -1):
        """An analytic sphere (reference src/shapes/sphere.cpp: exact
        quadratic intersection, not tessellated; scene.py:121);
        emitter_id binds a `sphere_area` emitter row."""
        sid = self._n_shapes
        self._n_shapes += 1
        self._spheres.append((tuple(center), float(radius),
                              int(material_id), int(emitter_id), sid))
        self._shape_interior.append(int(interior_medium))
        return sid

    def add_sphere_emitter(self, center, radius, material_id, radiance):
        """An analytic sphere area light, sampled by solid angle
        (reference sphere.cpp:359 sampleSolidAngle; scene.py:135)."""
        eid = self.emitters.sphere_area(center, radius, radiance)
        return self.add_sphere(center, radius, material_id, emitter_id=eid)

    def add_cylinder(self, p0, p1, radius, material_id, emitter_id=-1,
                     interior_medium: int = -1):
        """An analytic open cylinder from p0 to p1 (reference
        src/shapes/cylinder.cpp: no end caps; scene.py:139)."""
        sid = self._n_shapes
        self._n_shapes += 1
        self._cylinders.append((tuple(p0), tuple(p1), float(radius),
                                int(material_id), int(emitter_id), sid))
        self._shape_interior.append(int(interior_medium))
        return sid

    def add_hair(self, segments, material_id):
        """Analytic hair segments (reference src/shapes/hair.cpp: exact
        per-segment cylinders, not tessellated; scene.py:151): segments
        dict(a, b, r, u0, u1) of io/hairio.py `load_hair_segments`."""
        sid = self._n_shapes
        self._n_shapes += 1
        self._hair.append((segments, int(material_id), sid))
        self._shape_interior.append(-1)
        return sid

    def add_area_emitter_shape(self, mesh, material_id, radiance):
        eid = self.emitters.area(mesh, radiance)
        return self.add_shape(mesh, material_id, eid)

    def add_instanced_group(self, meshes_with_mats) -> int:
        """Register a group of [(TriMesh in object space, material_id),
        ...] for true instancing; returns its id for add_instance. Its
        instances share one copy of its triangles (cluster backend) and
        cannot be emitters (reference scene.py:165)."""
        items = []
        for msh, mid in meshes_with_mats:
            items.append((msh, int(mid), self._n_shapes))
            self._n_shapes += 1
            self._shape_interior.append(-1)
        self._inst_groups.append(items)
        return len(self._inst_groups) - 1

    def add_instance(self, group_id: int, to_world):
        """Place an instance of a registered group by a 4x4 to_world."""
        self._instances.append((int(group_id),
                                np.asarray(to_world, np.float64)))

    def set_camera(self, camera: Camera, width: int, height: int):
        self.camera = camera
        self.width, self.height = width, height

    def build(self, backend: str = "auto", device="cuda",
              ex_walk=None, time: float | None = None) -> Scene:
        """backend: 'brute', 'bvh', 'cluster' or 'auto' (cluster above 64
        triangles); a scene with instances needs 'cluster' or 'auto'.
        device: where the scene's tables live, the card by default.
        ex_walk: the cluster backend's exact item walk, 'v5', 'v6', 'v6b'
        or None for the device's default (ops/exact.py). time: when to
        bake the animated shapes (the camera's shutter-open by default),
        each a shape after the static ones (scene.py:222-238)."""
        check_device(device)
        shapes = list(self._shapes)
        interior = list(self._shape_interior)
        if self._animated:
            if time is None:
                time = float(self.camera.shutter_open) if self.camera \
                    else 0.0
            sid = self._n_shapes
            for mesh, mid, eid, track in self._animated:
                m4 = track.eval(time).numpy()
                shapes.append((mesh.transformed(m4), mid, eid, sid))
                interior.append(-1)
                sid += 1
        if not (shapes or self._spheres or self._cylinders or self._hair):
            raise ValueError("scene has no shapes")
        if not shapes:
            # analytic shapes only: the triangle tables still need a row,
            # a degenerate far-away triangle that is never hit (as the
            # reference's builder adds, scene.py:253-267)
            far = mesh_mod.make_quad(*[(1e8, 1e8, 1e8)] * 4)
            shapes = [(far, 0, -1, len(interior))]
            interior.append(-1)
        instanced = None
        if self._instances:
            if backend not in ("cluster", "auto"):
                raise ValueError(
                    "true instancing requires the cluster backend")
            backend = "cluster"
            instanced = (self._inst_groups, self._instances)
        hair = None
        if self._hair:
            # one row a segment, its material and shape ids beside it
            # (scene.py:274-286)
            parts = [dict(a=seg["a"], b=seg["b"], r=seg["r"], u0=seg["u0"],
                          u1=seg["u1"],
                          mid=np.full(seg["a"].shape[0], mid, np.int32),
                          eid=np.full(seg["a"].shape[0], -1, np.int32),
                          sid=np.full(seg["a"].shape[0], sid, np.int32))
                     for seg, mid, sid in self._hair]
            hair = {k: np.concatenate([p[k] for p in parts])
                    for k in parts[0]}
        geom = build_geometry(shapes, backend=backend,
                              instanced=instanced, ex_walk=ex_walk,
                              spheres=self._spheres,
                              cylinders=self._cylinders, hair=hair)
        e1 = geom.e1.numpy()
        e2 = geom.e2.numpy()
        areas = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
        em = self.emitters.build(geom.emitter_id.numpy(), areas)
        cam = self.camera
        if cam is None:
            cam = make_perspective(np.eye(4), 45.0, self.width / self.height)
        media = shape_interior = None
        if self._media:
            from mitsuba_tpu_torch.media.medium import make_medium_stack

            media = make_medium_stack(self._media)
            shape_interior = torch.as_tensor(np.asarray(interior, np.int32))
        mats = self.materials.build()
        subsurface = None
        if self._subsurface:
            from mitsuba_tpu_torch.subsurface.dipole import (
                build_scene_subsurface,
            )

            subsurface = build_scene_subsurface(
                self._subsurface, mats.n_materials, geom,
                n_points=max(e["n_points"] for e in self._subsurface))
        scene = Scene(geom=geom, materials=mats, emitters=em, camera=cam,
                      width=self.width, height=self.height,
                      textures=self.textures.build(), media=media,
                      shape_interior=shape_interior, subsurface=subsurface)
        return scene.to(device)


def cornell_box(width=256, height=256, backend="brute", device="cuda") \
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


def cornell_box_specular(width=256, height=256, backend="brute",
                         device="cuda") -> Scene:
    """Bench config 2 (reference mitsuba_tpu/render/scene.py:380): the
    Cornell box with a rough-conductor (GGX) short block, a mirror tall
    block and an analytic glass sphere; 32 triangles, so `auto` keeps it
    on the brute backend."""
    b = SceneBuilder()
    white = b.materials.lambertian((0.725, 0.71, 0.68))
    red = b.materials.lambertian((0.63, 0.065, 0.05))
    green = b.materials.lambertian((0.14, 0.45, 0.091))
    mirror = b.materials.mirror((0.95, 0.95, 0.95))
    glass = b.materials.dielectric(int_ior=1.5)
    metal = b.materials.rough_conductor(alpha=0.15, dist=mf.GGX)
    light_mat = b.materials.lambertian((0.0, 0.0, 0.0))

    mq = mesh_mod.make_quad
    b.add_shape(mq([552.8, 0, 0], [0, 0, 0], [0, 0, 559.2], [549.6, 0, 559.2]), white)
    b.add_shape(mq([556, 548.8, 0], [556, 548.8, 559.2], [0, 548.8, 559.2], [0, 548.8, 0]), white)
    b.add_shape(mq([549.6, 0, 559.2], [0, 0, 559.2], [0, 548.8, 559.2], [556, 548.8, 559.2]), white)
    b.add_shape(mq([0, 0, 559.2], [0, 0, 0], [0, 548.8, 0], [0, 548.8, 559.2]), green)
    b.add_shape(mq([552.8, 0, 0], [549.6, 0, 559.2], [556, 548.8, 559.2], [556, 548.8, 0]), red)

    # rough-metal short block
    for q in [
        mq([130, 165, 65], [82, 165, 225], [240, 165, 272], [290, 165, 114]),
        mq([290, 0, 114], [290, 165, 114], [240, 165, 272], [240, 0, 272]),
        mq([130, 0, 65], [130, 165, 65], [290, 165, 114], [290, 0, 114]),
        mq([82, 0, 225], [82, 165, 225], [130, 165, 65], [130, 0, 65]),
        mq([240, 0, 272], [240, 165, 272], [82, 165, 225], [82, 0, 225]),
    ]:
        b.add_shape(q, metal)
    # mirror tall block
    for q in [
        mq([423, 330, 247], [265, 330, 296], [314, 330, 456], [472, 330, 406]),
        mq([423, 0, 247], [423, 330, 247], [472, 330, 406], [472, 0, 406]),
        mq([472, 0, 406], [472, 330, 406], [314, 330, 456], [314, 0, 456]),
        mq([314, 0, 456], [314, 330, 456], [265, 330, 296], [265, 0, 296]),
        mq([265, 0, 296], [265, 330, 296], [423, 330, 247], [423, 0, 247]),
    ]:
        b.add_shape(q, mirror)
    # the glass sphere between the blocks, analytic
    b.add_sphere([160, 280, 170], 70.0, glass)

    light = mq([343, 548.7, 227], [343, 548.7, 332], [213, 548.7, 332], [213, 548.7, 227])
    b.add_area_emitter_shape(light, light_mat, (18.4, 15.6, 8.0))

    cam = make_perspective(
        tf.look_at([278, 273, -800], [278, 273, 0], [0, 1, 0]),
        fov_deg=39.3077, aspect=width / height,
    )
    b.set_camera(cam, width, height)
    return b.build(backend=backend, device=device)


def textured_mesh_scene(width=256, height=256, backend="bvh",
                        device="cuda", ex_walk=None) -> Scene:
    """Bench config 3 (reference mitsuba_tpu/render/scene.py:435): a
    101,762-triangle mesh — the reference's fallback when its bunny mesh
    is absent, a 160 x 320 sphere — with a phong body on a checkerboard-
    textured floor under a Preetham sky. ex_walk: SceneBuilder.build."""
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
    return b.build(backend=backend, device=device, ex_walk=ex_walk)


# (x, y, z, scale) of the three instances of tests/test_instancing.py
INSTANCE_PLACES = ((-2.0, 0.0, 1.0, 1.0), (2.0, 0.5, 1.2, 0.7),
                   (0.0, 2.0, 0.8, 1.3))


def instanced_scene(width=256, height=256, n_theta=160, n_phi=320,
                    flatten=False, device="cuda") -> Scene:
    """The layout of tests/test_instancing.py: a floor and an area light
    under three placements of one n_theta x n_phi sphere, instances of
    one group sharing one copy of its triangles (cluster backend) or,
    with flatten, the same spheres baked into world space. The default
    sphere is config 3's body, 101,760 triangles, so the instances hold
    305,280 triangles."""
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
        tf.look_at([0, -7, 4], [0, 0, 1], [0, 0, 1]), 50, width / height),
        width, height)
    ball = mesh_mod.make_sphere_mesh([0, 0, 0], 1.0, n_theta, n_phi)
    gid = None if flatten else b.add_instanced_group([(ball, red)])
    for x, y, z, s in INSTANCE_PLACES:
        m4 = np.diag([s, s, s, 1.0])
        m4[:3, 3] = (x, y, z)
        if flatten:
            b.add_shape(ball.transformed(m4), red)
        else:
            b.add_instance(gid, m4)
    return b.build(device=device)
