"""XML shape and luminaire nodes -> SceneBuilder (port of
mitsuba_tpu/io/xml_shapes.py for the shapes and emitters the port has).

Shapes (reference src/shapes/): obj, ply and serialized file meshes, the
analytic sphere and open cylinder, `hspan` height-span maps, `hair`
files (io/hairio.py: analytic segments, or tubes under
`tessellate="true"`), and `shapegroup` /
`instance` / `animatedinstance`,
flattened into transformed copies as the reference flattens them (an
animated instance's shapes move along the track of its `filename`,
animatedinstance.cpp:28-37, baked by the builder at a shutter time). An
inverted sphere, or a sphere, cylinder or hair carrying subsurface, is
tessellated. An area `<luminaire>` binds to a triangle shape or an
analytic sphere (a cylinder with one raises the reference's ValueError);
the
scene-level luminaires are point, spot, directional, constant, envmap
(an image read by io/bitmap.py) and the Preetham sky, with the
reference's property names and defaults (xml_shapes.py:372-420). A
shape's <medium name="interior"> (homogeneous, or heterogeneous from a
gridvolume) joins the scene's media, and a shape with an interior but
neither BSDF nor luminaire gets the pass-through `null()` material. A
shape's <subsurface type="dipole|multipole|adipole"> binds to a fresh
copy of its material (xml_shapes.py:285-330); `marschner` is accepted
and adds nothing, as in the reference. A hair with a luminaire raises
the reference's ValueError.
"""
from __future__ import annotations

import numpy as np

import os

from mitsuba_tpu_torch.core import transform as tf
from mitsuba_tpu_torch.io import meshio
from mitsuba_tpu_torch.render import mesh as mesh_mod


def _spec(props, name, default):
    v = props.get(name, default)
    if isinstance(v, (int, float)):
        return (float(v),) * 3
    return tuple(v)


def _find(node, category):
    for c in node["children"]:
        if c["category"] == category:
            return c
    return None


def _make_cylinder_mesh(p1, p2, radius, n_phi=64):
    """The open cylinder from p1 to p2 as n_phi quads (cylinder.cpp has no
    caps either; xml_shapes.py:35), for a cylinder carrying subsurface,
    whose irradiance points sample triangles."""
    p1 = np.asarray(p1, np.float64)
    p2 = np.asarray(p2, np.float64)
    axis = p2 - p1
    z = axis / np.linalg.norm(axis)
    a = np.array([1.0, 0, 0]) if abs(z[0]) < 0.9 else np.array([0, 1.0, 0])
    x = np.cross(a, z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    phi = np.linspace(0, 2 * np.pi, n_phi + 1)
    ring = (np.cos(phi)[:, None] * x + np.sin(phi)[:, None] * y) * radius
    verts = np.concatenate([p1 + ring, p2 + ring]).astype(np.float32)
    normals = np.concatenate([ring, ring]) / radius
    w = n_phi + 1
    faces = []
    for i in range(n_phi):
        faces.append([i, i + 1, w + i + 1])
        faces.append([i, w + i + 1, w + i])
    return mesh_mod.TriMesh(verts, np.asarray(faces, np.int32),
                            normals=np.asarray(normals, np.float32),
                            name="cylinder")


def _resolve(base_dir, name):
    """Scene-relative first, then the process search path (reference
    FileResolver semantics, fresolver.h:40)."""
    from mitsuba_tpu_torch.io.resolver import default_resolver

    r = default_resolver().clone()
    r.prepend(base_dir)
    return r.resolve(name)


def load_shape_mesh(shape_node, base_dir):
    t = shape_node["type"]
    p = shape_node["props"]
    if t == "obj":
        mesh = meshio.load_obj(_resolve(base_dir, p["filename"]))
        if p.get("faceNormals", False):
            mesh.normals = None
    elif t == "ply":
        mesh = meshio.load_ply(_resolve(base_dir, p["filename"]))
    elif t == "serialized":
        mesh = meshio.load_serialized(
            _resolve(base_dir, p["filename"]), int(p.get("shapeIndex", 0))
        )
    elif t == "sphere":
        center = p.get("center", (0.0, 0.0, 0.0))
        radius = float(p.get("radius", 1.0))
        mesh = mesh_mod.make_sphere_mesh(center, radius, 48, 96)
        if p.get("inverted", False):
            mesh.faces = mesh.faces[:, ::-1].copy()
            mesh.normals = -mesh.normals
    elif t == "cylinder":
        mesh = _make_cylinder_mesh(p.get("p1", (0, 0, 0)),
                                   p.get("p2", (0, 0, 1)),
                                   float(p.get("radius", 1.0)))
    elif t == "hair":
        from mitsuba_tpu_torch.io.hairio import load_hair

        mesh = load_hair(_resolve(base_dir, p["filename"]),
                         radius=float(p.get("radius", 0.05)))
    elif t == "hspan":
        from mitsuba_tpu_torch.io.hairio import load_hspan

        mesh = load_hspan(_resolve(base_dir, p["filename"]))
    else:
        raise ValueError(f"unsupported shape type '{t}'")
    to_world = p.get("toWorld")
    if to_world is not None:
        mesh = mesh.transformed(np.asarray(to_world))
    if p.get("flipNormals", False):
        mesh.faces = mesh.faces[:, ::-1].copy()
        if mesh.normals is not None:
            mesh.normals = -mesh.normals
    return mesh


def add_shape(builder, shape_node, base_dir, mat_cache, material_fn,
              track=None):
    t = shape_node["type"]
    if t == "shapegroup":
        # reference src/shapes/group.cpp: a named collection only
        # instantiated via <shape type="instance"> — nothing added here.
        return
    if t in ("instance", "animatedinstance"):
        # reference src/shapes/instance.cpp and animatedinstance.cpp; the
        # reference's loader flattens an instance into a transformed copy
        # of the group's shapes, and so does the port's; an animated
        # instance's shapes follow the track of its binary file
        group = None
        for c in shape_node["children"]:
            if c["category"] == "shape" and c["type"] == "shapegroup":
                group = c
        if group is None:
            raise ValueError("<instance> needs a <ref> to a shapegroup")
        track = None
        if t == "animatedinstance" and "filename" in shape_node["props"]:
            from mitsuba_tpu_torch.core.track import load_animated_transform

            track = load_animated_transform(
                os.path.join(base_dir, shape_node["props"]["filename"]))
        to_world = shape_node["props"].get("toWorld")
        for sub in group["children"]:
            if sub["category"] != "shape":
                continue
            sub_copy = dict(sub)
            if to_world is not None:
                props = dict(sub["props"])
                inner = props.get("toWorld")
                comp = np.asarray(to_world) if inner is None else (
                    np.asarray(to_world) @ np.asarray(inner)
                )
                props["toWorld"] = comp
                sub_copy["props"] = props
            add_shape(builder, sub_copy, base_dir, mat_cache, material_fn,
                      track=track)
        return
    # the analytic sphere and cylinder (reference sphere.cpp and
    # cylinder.cpp intersect exactly) skip tessellation unless inverted
    # (a sphere) or carrying subsurface (whose points sample triangles);
    # a hair is analytic unless tessellated or carrying subsurface
    props0 = shape_node["props"]
    sss = _find(shape_node, "subsurface") is not None
    tw = props0.get("toWorld")
    tw = None if tw is None else np.asarray(tw, np.float32)
    scale = 1.0 if tw is None else float(np.linalg.norm(tw[:3, 0]))
    analytic = None
    mesh = None
    if t == "sphere" and not props0.get("inverted", False) and not sss:
        center = np.asarray(props0.get("center", (0.0, 0.0, 0.0)),
                            np.float32)
        if tw is not None:
            center = tf.apply_point_np(tw, center)
        analytic = ("sphere", center, float(props0.get("radius", 1.0))
                    * scale)
    elif t == "cylinder" and not sss:
        ends = [np.asarray(props0.get(k, d), np.float32) for k, d in (
            ("p1", (0.0, 0.0, 0.0)), ("p2", (0.0, 0.0, 1.0)))]
        if tw is not None:
            ends = [tf.apply_point_np(tw, e) for e in ends]
        analytic = ("cylinder", *ends, float(props0.get("radius", 1.0))
                    * scale)
    elif t == "hair" and not props0.get("tessellate", False) and not sss:
        # exact per-segment cylinders (hair.cpp:132; xml_shapes.py:200)
        from mitsuba_tpu_torch.io.hairio import load_hair_segments

        seg = load_hair_segments(_resolve(base_dir, props0["filename"]),
                                 radius=float(props0.get("radius", 0.05)))
        if tw is not None:
            seg["a"] = tf.apply_point_np(tw, seg["a"])
            seg["b"] = tf.apply_point_np(tw, seg["b"])
            seg["r"] = (seg["r"] * scale).astype(np.float32)
        analytic = ("hair", seg)
    else:
        mesh = load_shape_mesh(shape_node, base_dir)
    bsdf = _find(shape_node, "bsdf")
    lum = _find(shape_node, "luminaire")
    interior = -1
    for c in shape_node["children"]:
        if c["category"] == "medium" and c.get("name") in ("interior", None):
            interior = _interior_medium(builder, c, base_dir)
    if bsdf is not None:
        mid = material_fn(builder, bsdf, mat_cache)
    elif interior >= 0 and lum is None:
        # a shape with an interior medium and no BSDF is an index-matched
        # boundary that occludes nothing (Shape::isOccluder false)
        mid = mat_cache.setdefault("__null__", builder.materials.null())
    else:
        # reference default: lambertian 0.5 when a shape has no BSDF but
        # is not a pure emitter (a row is added either way, as in the
        # reference, whose setdefault evaluates its default)
        mid = mat_cache.setdefault(
            "__default__", builder.materials.lambertian((0.5, 0.5, 0.5))
        ) if lum is None else mat_cache.setdefault(
            "__black__", builder.materials.lambertian((0.0, 0.0, 0.0))
        )
    ssn = _find(shape_node, "subsurface")
    if ssn is not None and ssn["type"] != "marschner":
        mid = _add_subsurface(builder, ssn, bsdf, mid, material_fn,
                              base_dir)
    if analytic is not None and analytic[0] == "sphere":
        _, center, radius = analytic
        eid = -1
        if lum is not None:
            eid = builder.emitters.sphere_area(
                center, radius, _spec(lum["props"], "intensity", 1.0))
        builder.add_sphere(center, radius, mid, emitter_id=eid,
                           interior_medium=interior)
        return
    if analytic is not None and analytic[0] == "hair":
        if lum is not None:
            raise ValueError("hair emitters are not supported")
        builder.add_hair(analytic[1], mid)
        return
    if analytic is not None:
        _, p1, p2, radius = analytic
        if lum is not None:
            raise ValueError("cylinder area emitters are not supported; "
                             "tessellate explicitly")
        builder.add_cylinder(p1, p2, radius, mid, interior_medium=interior)
        return
    eid = -1
    if lum is not None:
        if lum["type"] not in ("area", ""):
            raise ValueError("only area luminaires can be attached to shapes")
        radiance = _spec(lum["props"], "intensity", 1.0)
        eid = builder.emitters.area(mesh, radiance)
    if track is not None:
        builder.add_animated_shape(mesh, mid, track, emitter_id=eid)
    else:
        builder.add_shape(mesh, mid, eid, interior_medium=interior)


def _add_subsurface(builder, node, bsdf, mid, material_fn, base_dir) -> int:
    """A shape's <subsurface type="dipole|multipole|adipole"> (dipole.cpp,
    multipole.cpp, adipole.cpp properties; xml_shapes.py:295-330): sigmaS
    and sigmaA, or sigmaT and albedo; eta, or intIOR / extIOR; g,
    ssFactor, irrSamples, thickness, extraDipoles, anisoDirection,
    anisoRatio. The entry binds to a fresh copy of the shape's BSDF, so
    that shapes sharing it stay without (its textures resolved against the
    scene's directory; the reference's copy loses it, xml_shapes.py:314).
    Returns the material id."""
    if node["type"] not in ("dipole", "multipole", "adipole", ""):
        raise ValueError(f"unsupported subsurface type '{node['type']}'")
    sp = node["props"]
    if "sigmaT" in sp or "albedo" in sp:
        st = _spec(sp, "sigmaT", 1.0)
        al = _spec(sp, "albedo", 0.5)
        ss_c = tuple(t_ * a_ for t_, a_ in zip(st, al))
        sa_c = tuple(t_ - s_ for t_, s_ in zip(st, ss_c))
    else:
        ss_c = _spec(sp, "sigmaS", (2.6, 3.2, 3.9))
        sa_c = _spec(sp, "sigmaA", (0.0021, 0.0041, 0.0071))
    eta = float(sp.get("eta", float(sp.get("intIOR", 1.33))
                / float(sp.get("extIOR", 1.0))))
    if bsdf is not None:
        mid = material_fn(builder, bsdf, {"__base_dir__": base_dir})
    builder.add_subsurface(
        mid, ss_c, sa_c, g=float(sp.get("g", 0.0)), eta=eta,
        ss_factor=_spec(sp, "ssFactor", 1.0),
        n_points=int(sp.get("irrSamples", 512)),
        profile=node["type"] or "dipole",
        thickness=float(sp.get("thickness", 1.0)),
        n_poles=int(sp.get("extraDipoles", 3)),
        aniso_dir=_spec(sp, "anisoDirection", (1.0, 0.0, 0.0)),
        aniso_ratio=float(sp.get("anisoRatio", 2.0)))
    return mid


def medium_sigmas(props):
    """A <medium>'s (sigma_s, sigma_a): sigmaS and sigmaA, or sigmaT and
    albedo (reference homogeneous.cpp)."""
    if "sigmaT" in props or "albedo" in props:
        st = _spec(props, "sigmaT", 1.0)
        al = _spec(props, "albedo", 0.5)
        ss = tuple(t_ * a_ for t_, a_ in zip(st, al))
        return ss, tuple(t_ - s_ for t_, s_ in zip(st, ss))
    return _spec(props, "sigmaS", 1.0), _spec(props, "sigmaA", 0.1)


def _interior_medium(builder, node, base_dir) -> int:
    """A shape's interior <medium> -> its index in the builder's media
    (xml_shapes.py:226-265): its sigmas, an hg phase's g, and for a
    heterogeneous one a gridvolume density."""
    mp = node["props"]
    ss, sa = medium_sigmas(mp)
    g = 0.0
    for pc in node["children"]:
        if pc["category"] == "phase" and pc["type"] == "hg":
            g = float(pc["props"].get("g", 0.8))
    if node["type"] != "heterogeneous":
        return builder.add_medium(ss, sa, g=g)
    from mitsuba_tpu_torch.io.volio import (
        grid_world_to_index_transform, load_vol,
    )

    vol = None
    for pc in node["children"]:
        if pc["category"] == "volume" and pc.get("name") in ("density",
                                                             None):
            vol = pc
    if vol is None or "filename" not in vol["props"]:
        raise ValueError("heterogeneous interior needs a gridvolume density")
    data, bmin_v, bmax_v = load_vol(_resolve(base_dir,
                                             vol["props"]["filename"]))
    density = data[..., 0]
    w2g = grid_world_to_index_transform(bmin_v, bmax_v, density.shape)
    return builder.add_medium(
        ss, sa, g=g, density=density, world_to_grid=w2g,
        density_scale=float(mp.get("densityMultiplier", 1.0)))


def add_scene_luminaire(builder, lum_node, base_dir="."):
    """A scene-level <luminaire> (xml_shapes.py:372)."""
    t = lum_node["type"]
    p = lum_node["props"]
    intensity = _spec(p, "intensity", 1.0)
    to_world = p.get("toWorld")
    if t == "point":
        pos = p.get("position", (0.0, 0.0, 0.0))
        if to_world is not None:
            pos = tuple(tf.apply_point_np(to_world, np.asarray(pos)))
        builder.emitters.point(pos, intensity)
    elif t == "spot":
        # reference spot.cpp: at the origin of toWorld, aimed along its +z
        origin = (0.0, 0.0, 0.0)
        direction = (0.0, 0.0, 1.0)
        if to_world is not None:
            origin = tuple(tf.apply_point_np(to_world, np.zeros(3)))
            direction = tuple(tf.apply_vector_np(to_world, (0.0, 0.0, 1.0)))
        cutoff = float(p.get("cutoffAngle", 20.0))
        builder.emitters.spot(
            origin, direction, intensity, cutoff_deg=cutoff,
            falloff_deg=float(p.get("beamWidth", cutoff * 0.75)))
    elif t == "directional":
        d = p.get("direction", (0.0, 0.0, 1.0))
        if to_world is not None and "direction" not in p:
            d = tuple(tf.apply_vector_np(to_world, (0.0, 0.0, 1.0)))
        builder.emitters.directional(d, intensity)
    elif t == "constant":
        builder.emitters.constant(intensity)
    elif t == "envmap":
        from mitsuba_tpu_torch.io.bitmap import read_image

        img = read_image(os.path.join(base_dir, p["filename"]))
        builder.emitters.envmap(img, to_world=to_world,
                                scale=float(p.get("intensityScale", 1.0)))
    elif t == "sky":
        sun = p.get("sunDirection", (0.0, 1.0, 0.0))
        builder.emitters.sky(
            turbidity=float(p.get("turbidity", 3.0)), sun_dir=sun,
            scale=float(p.get("intensityScale", 1.0)),
            extend_below=bool(p.get("extend", True)),
        )
    else:
        raise ValueError(f"unsupported scene-level luminaire '{t}'")
