"""Conversion of a scene of the JAX package into the port's `Scene`.

`from_jax_scene` reads the reference scene's arrays as numpy (geometry,
materials, emitters, camera) and builds the port's tables from them, so
that both packages render the same scene. It needs no jax import of its
own: `np.asarray` reads the reference's arrays. Every feature of the
reference scene that the port does not implement raises
NotImplementedError.
"""
from __future__ import annotations

import numpy as np
import torch

from mitsuba_tpu_torch.bsdfs.table import MaterialTable, check_kinds
from mitsuba_tpu_torch.emitters.table import EmitterTable
from mitsuba_tpu_torch.emitters.table import check_kinds as check_emitters
from mitsuba_tpu_torch.render.camera import Camera
from mitsuba_tpu_torch.render.intersect import GeometryTables
from mitsuba_tpu_torch.render.scene import Scene

_GEOM_FIELDS = ("v0", "e1", "e2", "n0", "n1", "n2", "uv0", "uv1", "uv2",
                "material_id", "emitter_id", "shape_id")


def _unported(what):
    raise NotImplementedError(f"{what} is not ported")


def _t(x):
    return torch.as_tensor(np.array(x))


def _geometry(g) -> GeometryTables:
    if g.backend != "brute":
        _unported(f"intersection backend '{g.backend}'")
    if g.has_analytic or g.n_hair > 0 or g.has_instances:
        _unported("analytic, hair or instanced geometry")
    return GeometryTables(**{k: _t(getattr(g, k)) for k in _GEOM_FIELDS})


def _materials(mt, textures) -> MaterialTable:
    kinds = np.asarray(mt.kind)
    check_kinds(kinds)
    if mt.has_composite or mt.cloth is not None:
        _unported("composite or cloth BSDFs")
    if np.any(np.asarray(mt.opacity) < 1.0):
        _unported("opacity masks")
    if np.any(np.asarray(mt.tex_id) >= 0) or textures.n_textures > 0:
        _unported("textures")
    return MaterialTable(
        kind=_t(kinds),
        reflectance=_t(mt.reflectance),
        two_sided=_t(mt.two_sided),
        kinds_present=tuple(sorted({int(k) for k, _ in mt.kinds_present})),
    )


def _emitters(em) -> EmitterTable:
    check_emitters(np.asarray(em.kind))
    if em.env_id >= 0:
        _unported("environment emitters")
    return EmitterTable(
        **{k: _t(getattr(em, k)) for k in (
            "kind", "radiance", "tri_pdf_area", "rec_cdf", "rec_pmf",
            "rec_emitter", "rec_prim")},
        n_tri_records=int(em.n_tri_records),
        kinds_present=tuple(int(k) for k in em.kinds_present),
    )


def _camera(cam) -> Camera:
    if cam.kind != 0:
        _unported("orthographic cameras")
    if float(cam.aperture_radius) != 0.0 or float(cam.shutter_time) != 0.0:
        _unported("thin-lens aperture or shutter time")
    return Camera(
        to_world=_t(np.asarray(cam.to_world, np.float32)),
        tan_half_fov_x=float(np.asarray(cam.tan_half_fov_x)),
        tan_half_fov_y=float(np.asarray(cam.tan_half_fov_y)),
    )


def from_jax_scene(scene, device="cpu") -> Scene:
    """The port's Scene for a `mitsuba_tpu.render.scene.Scene`."""
    if scene.media is not None or scene.subsurface is not None:
        _unported("participating media or subsurface scattering")
    return Scene(
        geom=_geometry(scene.geom),
        materials=_materials(scene.materials, scene.textures),
        emitters=_emitters(scene.emitters),
        camera=_camera(scene.camera),
        width=scene.width,
        height=scene.height,
    ).to(device)
