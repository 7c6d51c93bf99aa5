"""XML shape and luminaire nodes -> SceneBuilder (port of
mitsuba_tpu/io/xml_shapes.py for the shapes and emitters the port has).

Shapes (reference src/shapes/): obj, ply and serialized file meshes, the
analytic sphere, and `shapegroup` / `instance`, flattened into
transformed copies as the reference flattens them. An inverted sphere is
tessellated. An area `<luminaire>` binds to a triangle shape; a scene-
level `sky` is the Preetham sky. A shape's <medium name="interior">
(homogeneous, or heterogeneous from a gridvolume) joins the scene's
media, and a shape with an interior but neither BSDF nor luminaire gets
the pass-through `null()` material. Everything else raises
NotImplementedError naming its ROADMAP item: cylinder, hair and hspan
shapes, animated instances, subsurface, sphere emitters, and point,
spot, directional, constant and envmap luminaires.
"""
from __future__ import annotations

import numpy as np

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


def _unported(what, item):
    raise NotImplementedError(f"{what} is not ported (ROADMAP {item})")


_UNPORTED_SHAPES = {"cylinder": "A.11", "hair": "A.12", "hspan": "A.12",
                    "animatedinstance": "A.12"}


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
    elif t in _UNPORTED_SHAPES:
        _unported(f"the shape '{t}'", _UNPORTED_SHAPES[t])
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


def add_shape(builder, shape_node, base_dir, mat_cache, material_fn):
    t = shape_node["type"]
    if t == "shapegroup":
        # reference src/shapes/group.cpp: a named collection only
        # instantiated via <shape type="instance"> — nothing added here.
        return
    if t == "instance":
        # reference src/shapes/instance.cpp; the reference's loader
        # flattens an instance into a transformed copy of the group's
        # shapes, and so does the port's
        group = None
        for c in shape_node["children"]:
            if c["category"] == "shape" and c["type"] == "shapegroup":
                group = c
        if group is None:
            raise ValueError("<instance> needs a <ref> to a shapegroup")
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
            add_shape(builder, sub_copy, base_dir, mat_cache, material_fn)
        return
    if _find(shape_node, "subsurface") is not None:
        _unported("subsurface scattering", "A.12")
    # the analytic sphere (reference sphere.cpp intersects exactly) skips
    # tessellation unless inverted
    props0 = shape_node["props"]
    analytic = None
    if t == "sphere" and not props0.get("inverted", False):
        center = np.asarray(props0.get("center", (0.0, 0.0, 0.0)),
                            np.float32)
        radius = float(props0.get("radius", 1.0))
        tw = props0.get("toWorld")
        if tw is not None:
            tw = np.asarray(tw, np.float32)
            center = tf.apply_point_np(tw, center)
            radius *= float(np.linalg.norm(tw[:3, 0]))
        analytic = (center, radius)
        mesh = None
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
    if analytic is not None:
        if lum is not None:
            _unported("a sphere emitter", "A.11")
        builder.add_sphere(analytic[0], analytic[1], mid,
                           interior_medium=interior)
        return
    if lum is not None:
        if lum["type"] not in ("area", ""):
            raise ValueError("only area luminaires can be attached to shapes")
        radiance = _spec(lum["props"], "intensity", 1.0)
        eid = builder.emitters.area(mesh, radiance)
        builder.add_shape(mesh, mid, eid, interior_medium=interior)
    else:
        builder.add_shape(mesh, mid, interior_medium=interior)


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


_UNPORTED_LUMINAIRES = ("point", "spot", "directional", "constant",
                        "envmap")


def add_scene_luminaire(builder, lum_node):
    t = lum_node["type"]
    p = lum_node["props"]
    if t == "sky":
        sun = p.get("sunDirection", (0.0, 1.0, 0.0))
        builder.emitters.sky(
            turbidity=float(p.get("turbidity", 3.0)), sun_dir=sun,
            scale=float(p.get("intensityScale", 1.0)),
            extend_below=bool(p.get("extend", True)),
        )
    elif t in _UNPORTED_LUMINAIRES:
        _unported(f"the '{t}' luminaire", "A.11")
    else:
        raise ValueError(f"unsupported scene-level luminaire '{t}'")
