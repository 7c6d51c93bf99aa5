"""Wavefront BSDF dispatch (port of mitsuba_tpu/bsdfs/dispatch.py without
composites).

Each (kind, microfacet distribution) pair present in the scene is
evaluated on all lanes and the result selected by material mask. The
`twosided` adapter (src/bsdfs/twosided.cpp) mirrors the local frame for
lanes whose material has the flag and wi.z < 0, except for the dielectric,
which is two-sided already.
"""
from __future__ import annotations

import torch

from mitsuba_tpu_torch.bsdfs import models as md
from mitsuba_tpu_torch.bsdfs.table import (
    DIELECTRIC, LAMBERTIAN, MIRROR, PHONG, ROUGH_CONDUCTOR, MaterialTable,
)

_MODELS = {
    LAMBERTIAN: (md.lambertian_eval, md.lambertian_pdf, md.lambertian_sample),
    MIRROR: (md.mirror_eval, md.mirror_pdf, md.mirror_sample),
    DIELECTRIC: (md.dielectric_eval, md.dielectric_pdf,
                 md.dielectric_sample),
    ROUGH_CONDUCTOR: (md.rough_conductor_eval, md.rough_conductor_pdf,
                      md.rough_conductor_sample),
    PHONG: (md.phong_eval, md.phong_pdf, md.phong_sample),
}

_NO_FLIP_KINDS = (DIELECTRIC,)          # two-sided already


def _flip_mask(p, wi):
    return p["two_sided"] & (wi[..., 2] < 0)


def _flip(v, mask):
    sign = torch.tensor([1.0, 1.0, -1.0], dtype=v.dtype, device=v.device)
    return torch.where(mask[..., None], v * sign, v)


def _resolve(p, albedo=None):
    if albedo is not None:
        p = dict(p, reflectance=albedo)
    return p


def _kinds(table, p):
    """(kind, lane mask, per-kind parameters) for each (kind, distribution)
    pair of the table; a rough lobe's lanes are those of its distribution
    (dispatch.py:115)."""
    for kind, dist in table.kinds_present:
        mask = p["kind"] == kind
        if kind == ROUGH_CONDUCTOR:
            mask = mask & (p["dist_type"] == dist)
        yield kind, mask, dict(p, _dist_static=dist)


def bsdf_eval(table: MaterialTable, material_id, wi, wo, albedo=None):
    """fCos for every lane (reference BSDF::fCos)."""
    p = _resolve(table.gather(material_id), albedo)
    fl = _flip_mask(p, wi)
    wi_f, wo_f = _flip(wi, fl), _flip(wo, fl)
    out = torch.zeros(wi.shape[:-1] + (table.reflectance.shape[-1],),
                      device=wi.device)
    for kind, mask, pk in _kinds(table, p):
        flip = kind not in _NO_FLIP_KINDS
        val = _MODELS[kind][0](pk, wi_f if flip else wi, wo_f if flip else wo)
        out = torch.where(mask[..., None], val, out)
    return out


def bsdf_pdf(table: MaterialTable, material_id, wi, wo):
    """Solid-angle pdf of bsdf_sample (reference BSDF::pdf)."""
    p = table.gather(material_id)
    fl = _flip_mask(p, wi)
    wi_f, wo_f = _flip(wi, fl), _flip(wo, fl)
    out = torch.zeros(wi.shape[:-1], device=wi.device)
    for kind, mask, pk in _kinds(table, p):
        flip = kind not in _NO_FLIP_KINDS
        val = _MODELS[kind][1](pk, wi_f if flip else wi, wo_f if flip else wo)
        out = torch.where(mask, val, out)
    return out


def bsdf_sample(table: MaterialTable, material_id, wi, u2, u1, albedo=None):
    """Sample wo ~ BSDF; returns the merged per-lane sample dict
    (reference BSDF::sampleCos). Opacity masks (reference mask.cpp,
    dispatch.py:162-183): with probability 1 - opacity the surface is
    passed straight through (a delta transmission of weight 1), and u1 is
    rescaled for the lobe decision of the lanes that stay."""
    if table.has_mask:
        i = torch.clamp(material_id, 0, table.n_materials - 1).long()
        opacity = table.opacity[i]
        pass_through = u1 >= opacity
        u1 = torch.clamp(u1 / torch.clamp(opacity, min=1e-6), 0.0,
                         1.0 - 1e-7)
    s = _sample(table, material_id, wi, u2, u1, albedo)
    if table.has_mask:
        sel = pass_through[:, None]
        s["wo"] = torch.where(sel, -wi, s["wo"])
        s["weight"] = torch.where(sel, 1.0, s["weight"])
        s["pdf"] = torch.where(pass_through, 1.0, s["pdf"])
        for key in ("delta", "transmission", "valid"):
            s[key] = s[key] | pass_through
    return s


def _sample(table: MaterialTable, material_id, wi, u2, u1, albedo=None):
    p = _resolve(table.gather(material_id), albedo)
    fl = _flip_mask(p, wi)
    wi_f = _flip(wi, fl)
    out = md.zero_sample(wi, p["reflectance"].shape[-1])
    for kind, mask, pk in _kinds(table, p):
        if kind in _NO_FLIP_KINDS:
            s = _MODELS[kind][2](pk, wi, u2, u1)
        else:
            s = _MODELS[kind][2](pk, wi_f, u2, u1)
            s = dict(s, wo=_flip(s["wo"], fl))
        for key in out:
            sel = mask[..., None] if out[key].ndim > mask.ndim else mask
            out[key] = torch.where(sel, s[key], out[key])
    return out
