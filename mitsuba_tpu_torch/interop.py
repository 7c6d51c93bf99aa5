"""Conversion of a scene of the JAX package into the port's `Scene`.

`from_jax_scene` reads the reference scene's arrays as numpy (geometry on
the brute, bvh or cluster backend, instanced or not, with or without
analytic spheres and cylinders, sphere emitters, materials of every kind
with their opacity column, composite children and the woven cloth's
weave tables, textures of every kind
with their images and MIP pyramids, emitters of every kind with the
environment map's sampling tables, the perspective, thin-lens or
orthographic camera with its shutter interval, shape-interior media,
subsurface entries with their irradiance cache when it is filled) and
builds the port's tables from them, so that both packages render the
same scene from the same arrays; `from_jax_medium` does the
same for an ambient medium (homogeneous or a grid, oriented or a
Gaussian flake), `from_jax_guide` for a path-guiding grid, and
`from_jax_cluster_tables` for the v1 cluster intersector's tables.
It needs no jax import of its own: `np.asarray` reads the reference's
arrays. Every feature of the reference scene that the port does not
implement raises NotImplementedError.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mitsuba_tpu_torch.bsdfs.table import MaterialTable, check_kinds
from mitsuba_tpu_torch.emitters.table import EmitterTable
from mitsuba_tpu_torch.integrators.guiding import GuideGrid
from mitsuba_tpu_torch.media.medium import MediumStack, MediumTable
from mitsuba_tpu_torch.ops import bvh as bp
from mitsuba_tpu_torch.render.camera import Camera
from mitsuba_tpu_torch.render.clusters import ClusterTables
from mitsuba_tpu_torch.render.intersect import GeometryTables
from mitsuba_tpu_torch.render.scene import Scene, check_device
from mitsuba_tpu_torch.render.mipmap import MIPMap
from mitsuba_tpu_torch.render.texture import (
    BITMAP, TextureTable, wraps_present,
)
from mitsuba_tpu_torch.subsurface.dipole import SceneSubsurface

_GEOM_FIELDS = ("v0", "e1", "e2", "n0", "n1", "n2", "uv0", "uv1", "uv2",
                "material_id", "emitter_id", "shape_id")
_SPHERE_FIELDS = ("sph_c", "sph_r", "sph_mid", "sph_eid", "sph_sid")
_CYLINDER_FIELDS = ("cyl_a", "cyl_b", "cyl_r", "cyl_mid", "cyl_eid",
                    "cyl_sid")
_MATERIAL_FIELDS = ("kind", "reflectance", "two_sided", "specular",
                    "exponent", "tex_id", "transmittance", "eta", "cond_eta",
                    "cond_k", "alpha_u", "alpha_v", "dist_type", "child_ids",
                    "child_weights")
_BVH_FIELDS = ("bvh_min", "bvh_max", "bvh_first", "bvh_count", "bvh_skip",
               "bvh_packed", "tri_packed", "shade_pack")
_CLUSTER_FIELDS = ("mt_tri", "mt_start", "mt_bmin", "mt_bmax", "cl_sc_bmin",
                   "cl_sc_bmax")
_EXACT_FIELDS = ("ex_tri", "ex_b0lo", "ex_b0hi", "ex_b1lo", "ex_b1hi",
                 "ex_b2lo", "ex_b2hi", "ex_ct0", "ex_ct1", "ex_ct2")
_INSTANCE_FIELDS = ("mt_block_id", "mt_xform", "mt_xform_fwd", "obj_v0",
                    "obj_e1", "obj_e2", "obj_n0", "obj_n1", "obj_n2",
                    "obj_uv0", "obj_uv1", "obj_uv2", "obj_mid", "obj_sid",
                    "inst_xf_inv")
_ENV_FIELDS = ("env_image", "env_prob", "env_alias", "env_pdf_img",
               "env_to_world", "env_to_env")


def _unported(what):
    raise NotImplementedError(f"{what} is not ported")


def _t(x):
    return torch.as_tensor(np.array(x))


def _geometry(g) -> GeometryTables:
    if g.backend not in ("brute", "bvh", "cluster"):
        _unported(f"intersection backend '{g.backend}'")
    if g.n_hair > 0:
        _unported("hair geometry (ROADMAP A.12)")
    analytic = {}
    if g.n_spheres > 0:
        analytic.update({k: _t(getattr(g, k)) for k in _SPHERE_FIELDS})
    if g.n_cylinders > 0:
        analytic.update({k: _t(getattr(g, k)) for k in _CYLINDER_FIELDS})
    geom = GeometryTables(**{k: _t(getattr(g, k)) for k in _GEOM_FIELDS},
                          bvh_min=_t(g.bvh_min), bvh_max=_t(g.bvh_max),
                          **analytic)
    if g.backend == "brute":
        return geom
    fields = {k: _t(getattr(g, k)) for k in _BVH_FIELDS}
    fields["bvh_aligned"], fields["tri_aligned"] = bp.align_tables(
        fields["bvh_packed"], fields["tri_packed"])
    if g.backend == "cluster":
        fields.update({k: _t(getattr(g, k)) for k in _CLUSTER_FIELDS})
        if g.has_instances:
            fields.update({k: _t(getattr(g, k)) for k in _INSTANCE_FIELDS})
            fields.update(
                inst_groups=tuple(_geometry(s) for s in g.inst_groups),
                inst_tri2virt=tuple(_t(x) for x in g.inst_tri2virt),
                inst_gid=tuple(g.inst_gid),
                inst_vp_base=tuple(g.inst_vp_base),
                n_static_clusters=int(g.n_static_clusters), mt_k=g.mt_k)
        elif g.ex_tri is None:
            _unported("a cluster geometry without exact-cull tables")
        else:
            fields.update({k: _t(getattr(g, k)) for k in _EXACT_FIELDS})
            fields.update(sc_tri=_t(g.st_tables["sc_tri"]),
                          ex_caps=g.ex_caps)
    return dataclasses.replace(geom, **fields, backend=g.backend)


def _materials(mt) -> MaterialTable:
    check_kinds(np.asarray(mt.kind))
    opacity = np.asarray(mt.opacity, np.float32)
    return MaterialTable(
        **{k: _t(getattr(mt, k)) for k in _MATERIAL_FIELDS},
        opacity=_t(opacity), has_mask=bool(opacity.min() < 0.999),
        cloth_slot=_t(mt.cloth_slot),
        cloth=None if mt.cloth is None
        else {k: _t(v) for k, v in mt.cloth.items()},
        kinds_present=tuple((int(k), int(d)) for k, d in mt.kinds_present),
        has_composite=bool(mt.has_composite),
    )


def _textures(tx) -> TextureTable:
    kind = np.asarray(tx.kind)
    clamp = np.asarray(tx.wrap_clamp)
    return TextureTable(
        **{k: _t(getattr(tx, k)) for k in (
            "kind", "color0", "color1", "line_width", "uv_scale",
            "uv_offset", "image_slot", "wrap_clamp")},
        images=tuple(_t(x) for x in tx.images),
        mips=tuple(MIPMap(tuple(_t(lv) for lv in mp.levels), mp.n_levels)
                   for mp in tx.mips),
        kinds_present=tuple(int(k) for k in tx.kinds_present),
        wraps_present=wraps_present(clamp[kind == BITMAP]))


def _emitters(em) -> EmitterTable:
    return EmitterTable(
        **{k: _t(getattr(em, k)) for k in (
            "kind", "radiance", "position", "direction", "cutoff_cos",
            "falloff_cos", "tri_pdf_area", "rec_cdf", "rec_pmf",
            "rec_emitter", "rec_prim", "radius") + _ENV_FIELDS},
        n_tri_records=int(em.n_tri_records),
        kinds_present=tuple(int(k) for k in em.kinds_present),
        env_id=int(em.env_id),
        env_kind=int(em.env_kind),
    )


def _camera(cam) -> Camera:
    def f(x):
        return float(np.asarray(x))

    return Camera(
        to_world=_t(np.asarray(cam.to_world, np.float32)),
        tan_half_fov_x=f(cam.tan_half_fov_x),
        tan_half_fov_y=f(cam.tan_half_fov_y),
        aperture_radius=f(cam.aperture_radius),
        focus_distance=f(cam.focus_distance),
        ortho_scale=f(cam.ortho_scale),
        kind=int(cam.kind),
        shutter_open=f(cam.shutter_open),
        shutter_time=f(cam.shutter_time),
    )


_SUBSURFACE_FIELDS = ("sigma_tr", "zri", "zvi", "alpha_p", "eta", "fdr",
                      "fdt", "ss_factor", "aniso_dir", "aniso_ratio",
                      "points", "normals", "area", "mat_ss")


def _subsurface(ss) -> SceneSubsurface:
    return SceneSubsurface(
        **{k: _t(getattr(ss, k)) for k in _SUBSURFACE_FIELDS},
        irradiance=None if ss.irradiance is None else _t(ss.irradiance))


def _media(st) -> MediumStack:
    fields = {k: _t(getattr(st, k)) for k in (
        "sigma_s", "sigma_a", "phase_g", "grid_id", "grids", "grid_dims",
        "world_to_grid", "density_scale", "max_density")
        if getattr(st, k) is not None}
    return MediumStack(**fields, has_hetero=bool(st.has_hetero))


def from_jax_scene(scene, device="cuda") -> Scene:
    """The port's Scene for a `mitsuba_tpu.render.scene.Scene`, on
    `device` (the card by default)."""
    return Scene(
        geom=_geometry(scene.geom),
        materials=_materials(scene.materials),
        emitters=_emitters(scene.emitters),
        camera=_camera(scene.camera),
        width=scene.width,
        height=scene.height,
        textures=_textures(scene.textures),
        media=None if scene.media is None else _media(scene.media),
        shape_interior=None if scene.shape_interior is None
        else _t(scene.shape_interior),
        subsurface=None if scene.subsurface is None
        else _subsurface(scene.subsurface),
    ).to(device)


def from_jax_medium(med) -> MediumTable:
    """The port's MediumTable for a `mitsuba_tpu.media.MediumTable`
    (homogeneous or a grid, with its orientation field and flake
    coefficients), on the host (the integrator moves it to the scene's
    device)."""
    opt = {k: _t(getattr(med, k)) for k in (
        "density", "world_to_grid", "density_scale", "max_density",
        "orientation", "flake_coeffs") if getattr(med, k) is not None}
    return MediumTable(
        sigma_s=_t(np.asarray(med.sigma_s, np.float32)),
        sigma_a=_t(np.asarray(med.sigma_a, np.float32)),
        phase_g=_t(np.asarray(med.phase_g, np.float32)), **opt,
        kind=int(med.kind), phase_kind=int(med.phase_kind),
        enabled=bool(med.enabled))


def from_jax_guide(guide, device="cuda") -> GuideGrid:
    """The port's GuideGrid for a `mitsuba_tpu.integrators.guiding
    .GuideGrid`, on `device` (the card by default)."""
    check_device(device)
    return GuideGrid(mass=_t(guide.mass), bmin=_t(guide.bmin),
                     bmax=_t(guide.bmax), res=int(guide.res)).to(device)


def from_jax_cluster_tables(ct) -> ClusterTables:
    """The port's ClusterTables for a
    `mitsuba_tpu.render.clusters.ClusterTables` (numpy, copied)."""
    return ClusterTables(
        **{k: np.array(getattr(ct, k)) for k in (
            "G", "aabb", "tri_start", "sc_bmin", "sc_bmax")},
        n_super=int(ct.n_super))
