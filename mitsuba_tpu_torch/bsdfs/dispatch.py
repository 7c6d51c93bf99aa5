"""Wavefront BSDF dispatch (port of mitsuba_tpu/bsdfs/dispatch.py).

Each (kind, microfacet distribution) pair present in the scene is
evaluated on all lanes and the result selected by material mask. The
`twosided` adapter (src/bsdfs/twosided.cpp) mirrors the local frame for
lanes whose material has the flag and wi.z < 0, except for the smooth and
rough dielectrics, which are two-sided already. A composite row
(src/bsdfs/composite.cpp) sums its weighted children's values, mixes
their pdfs by weight and samples one child picked by u1. The woven cloth
(bsdfs/irawan.py) reads each lane's hit uv, which eval and sample take as
`uv` (dispatch.py:72); without it the cloth evaluates to zero, as in the
reference.
"""
from __future__ import annotations

import torch

from mitsuba_tpu_torch.bsdfs import irawan as ir
from mitsuba_tpu_torch.bsdfs import models as md
from mitsuba_tpu_torch.bsdfs.table import (
    CLOTH, COMPOSITE, DIELECTRIC, DIFF_TRANS, HANRAHAN_KRUEGER, LAMBERTIAN,
    MAX_COMPOSITE_LOBES, MIRROR, PHONG, ROUGH_CONDUCTOR, ROUGH_GLASS, WARD,
    WISCOMBE, MaterialTable,
)

_MODELS = {
    LAMBERTIAN: (md.lambertian_eval, md.lambertian_pdf, md.lambertian_sample),
    MIRROR: (md.mirror_eval, md.mirror_pdf, md.mirror_sample),
    DIELECTRIC: (md.dielectric_eval, md.dielectric_pdf,
                 md.dielectric_sample),
    ROUGH_CONDUCTOR: (md.rough_conductor_eval, md.rough_conductor_pdf,
                      md.rough_conductor_sample),
    PHONG: (md.phong_eval, md.phong_pdf, md.phong_sample),
    WARD: (md.ward_eval, md.ward_pdf, md.ward_sample),
    ROUGH_GLASS: (md.roughglass_eval, md.roughglass_pdf,
                  md.roughglass_sample),
    DIFF_TRANS: (md.difftrans_eval, md.difftrans_pdf, md.difftrans_sample),
    WISCOMBE: (md.wiscombe_eval, md.wiscombe_pdf, md.wiscombe_sample),
    HANRAHAN_KRUEGER: (md.hk_eval, md.hk_pdf, md.hk_sample),
    CLOTH: (ir.irawan_eval, ir.irawan_pdf, ir.irawan_sample),
}

_NO_FLIP_KINDS = (DIELECTRIC, ROUGH_GLASS)      # two-sided already
_ROUGH_KINDS = (ROUGH_CONDUCTOR, ROUGH_GLASS)   # a distribution each


def _flip_mask(p, wi):
    return p["two_sided"] & (wi[..., 2] < 0)


def _flip(v, mask):
    sign = torch.tensor([1.0, 1.0, -1.0], dtype=v.dtype, device=v.device)
    return torch.where(mask[..., None], v * sign, v)


def _resolve(p, albedo=None, uv=None):
    """The lanes' texture-resolved albedo and hit uv over their rows."""
    if albedo is not None:
        p = dict(p, reflectance=albedo)
    if uv is not None:
        p = dict(p, _uv=uv)
    return p


def _kinds(table, p):
    """(kind, lane mask, per-kind parameters) for each (kind, distribution)
    pair of the table; a rough lobe's lanes are those of its distribution
    (dispatch.py:115)."""
    for kind, dist in table.kinds_present:
        mask = p["kind"] == kind
        if kind in _ROUGH_KINDS:
            mask = mask & (p["dist_type"] == dist)
        yield kind, mask, dict(p, _dist_static=dist)


def _composite(table, material_id):
    """(is a composite row, its child ids (N, 4), its weights (N, 4))."""
    i = torch.clamp(material_id, 0, table.n_materials - 1).long()
    return (table.kind[i] == COMPOSITE, table.child_ids[i],
            table.child_weights[i])


def bsdf_eval(table: MaterialTable, material_id, wi, wo, albedo=None,
              uv=None):
    """fCos for every lane (reference BSDF::fCos); a composite row sums
    its weighted children (composite.cpp f()), which read their own
    reflectance and the lane's uv."""
    base = _eval(table, material_id, wi, wo, albedo, uv)
    if not table.has_composite:
        return base
    is_comp, cids, cws = _composite(table, material_id)
    total = torch.zeros_like(base)
    for k in range(MAX_COMPOSITE_LOBES):
        val = _eval(table, torch.clamp(cids[:, k], min=0), wi, wo, None,
                    uv)
        total = total + torch.where((is_comp & (cids[:, k] >= 0))[:, None],
                                    cws[:, k][:, None] * val, 0.0)
    return torch.where(is_comp[:, None], total, base)


def _eval(table: MaterialTable, material_id, wi, wo, albedo=None,
          uv=None):
    p = _resolve(table.gather(material_id), albedo, uv)
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
    """Solid-angle pdf of bsdf_sample (reference BSDF::pdf); a composite
    row's is its children's mixed by weight."""
    base = _pdf(table, material_id, wi, wo)
    if not table.has_composite:
        return base
    is_comp, cids, cws = _composite(table, material_id)
    wsum = torch.clamp(torch.where(cids >= 0, cws, 0.0).sum(-1), min=1e-8)
    total = torch.zeros_like(base)
    for k in range(MAX_COMPOSITE_LOBES):
        val = _pdf(table, torch.clamp(cids[:, k], min=0), wi, wo)
        total = total + torch.where(is_comp & (cids[:, k] >= 0),
                                    (cws[:, k] / wsum) * val, 0.0)
    return torch.where(is_comp, total, base)


def _pdf(table: MaterialTable, material_id, wi, wo):
    p = table.gather(material_id)
    fl = _flip_mask(p, wi)
    wi_f, wo_f = _flip(wi, fl), _flip(wo, fl)
    out = torch.zeros(wi.shape[:-1], device=wi.device)
    for kind, mask, pk in _kinds(table, p):
        flip = kind not in _NO_FLIP_KINDS
        val = _MODELS[kind][1](pk, wi_f if flip else wi, wo_f if flip else wo)
        out = torch.where(mask, val, out)
    return out


def bsdf_sample(table: MaterialTable, material_id, wi, u2, u1, albedo=None,
                uv=None):
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
    s = _sample_composite(table, material_id, wi, u2, u1, albedo, uv)
    if table.has_mask:
        sel = pass_through[:, None]
        s["wo"] = torch.where(sel, -wi, s["wo"])
        s["weight"] = torch.where(sel, 1.0, s["weight"])
        s["pdf"] = torch.where(pass_through, 1.0, s["pdf"])
        for key in ("delta", "transmission", "valid"):
            s[key] = s[key] | pass_through
    return s


def _sample_composite(table: MaterialTable, material_id, wi, u2, u1,
                      albedo=None, uv=None):
    """A composite row samples the child that u1 picks by weight, with u1
    rescaled into that child's share; its weight and pdf are the whole
    row's eval over its pdf (composite.cpp sample(), dispatch.py:194-225).
    """
    if not table.has_composite:
        return _sample(table, material_id, wi, u2, u1, albedo, uv)
    is_comp, cids, cws = _composite(table, material_id)
    w_valid = torch.where(cids >= 0, cws, 0.0)
    wsum = torch.clamp(w_valid.sum(-1), min=1e-8)
    share = w_valid / wsum[:, None]
    cdf = torch.cumsum(share, dim=-1)
    chosen = torch.argmax((u1[:, None] <= cdf + 1e-7).to(torch.int32),
                          dim=-1)[:, None]
    lo = torch.where(chosen[:, 0] > 0, torch.gather(
        cdf, 1, torch.clamp(chosen - 1, min=0))[:, 0], 0.0)
    pk = torch.gather(share, 1, chosen)[:, 0]
    u1_re = torch.clamp((u1 - lo) / torch.clamp(pk, min=1e-8), 0.0,
                        1.0 - 1e-7)
    child = torch.clamp(torch.gather(cids, 1, chosen)[:, 0], min=0)
    s = _sample(table, torch.where(is_comp, child, material_id), wi, u2,
                torch.where(is_comp, u1_re, u1), albedo, uv)
    fcos = bsdf_eval(table, material_id, wi, s["wo"], albedo, uv)
    pdf = bsdf_pdf(table, material_id, wi, s["wo"])
    s["weight"] = torch.where(is_comp[:, None],
                              fcos / torch.clamp(pdf, min=1e-9)[:, None],
                              s["weight"])
    s["pdf"] = torch.where(is_comp, pdf, s["pdf"])
    s["valid"] = torch.where(is_comp, (pdf > 1e-10) & ~s["delta"],
                             s["valid"])
    return s


def _sample(table: MaterialTable, material_id, wi, u2, u1, albedo=None,
            uv=None):
    p = _resolve(table.gather(material_id), albedo, uv)
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
