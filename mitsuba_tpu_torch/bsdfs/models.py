"""BSDF models in the local shading frame (port of
mitsuba_tpu/bsdfs/models.py; reference src/bsdfs/lambertian.cpp:204,
mirror.cpp, dielectric.cpp, roughmetal.cpp, phong.cpp, ward.cpp,
roughglass.cpp:776, difftrans.cpp, the fork's wiscombe.cpp:294 and
hanrahan-krueger.cpp:154-193).

    eval(p, wi, wo)       -> fCos (N, C): f(wi, wo) * |cos_theta(wo)|
    pdf(p, wi, wo)        -> (N,) solid-angle density of sample()
    sample(p, wi, u2, u1) -> dict(wo, weight, pdf, delta, transmission, eta,
                                  valid)
with p the per-lane gathered parameter dict (bsdfs/table.py), and for the
rough conductor and rough glass p["_dist_static"] the static microfacet
distribution.

Delta models (mirror, dielectric) return pdf = the discrete probability
of the event folded into the weight, and eval = pdf = 0: the smooth
strategies never hit them (the reference's EDelta convention, bsdf.h:149).
"""
from __future__ import annotations

import math

import torch

from mitsuba_tpu_torch.core import math as m
from mitsuba_tpu_torch.core import microfacet as mf
from mitsuba_tpu_torch.core import warp
from mitsuba_tpu_torch.core.fresnel import (
    fresnel, fresnel_conductor, fresnel_dielectric_ext,
)


def _both_upper(wi, wo):
    return (m.cos_theta(wi) > 0) & (m.cos_theta(wo) > 0)


def _mask3(mask, x):
    return torch.where(mask[..., None], x, 0.0)


def zero_sample(wi, c=3):
    n = wi.shape[0]
    kw = dict(device=wi.device)
    return dict(
        wo=torch.zeros_like(wi),
        weight=torch.zeros((n, c), **kw),
        pdf=torch.zeros(n, **kw),
        delta=torch.zeros(n, dtype=torch.bool, **kw),
        transmission=torch.zeros(n, dtype=torch.bool, **kw),
        eta=torch.ones(n, **kw),
        valid=torch.zeros(n, dtype=torch.bool, **kw),
    )


def lambertian_eval(p, wi, wo):
    f = p["reflectance"] * m.INV_PI \
        * torch.clamp(m.cos_theta(wo), min=0.0)[..., None]
    return _mask3(_both_upper(wi, wo), f)


def lambertian_pdf(p, wi, wo):
    return torch.where(_both_upper(wi, wo),
                       warp.square_to_cosine_hemisphere_pdf(wo), 0.0)


def lambertian_sample(p, wi, u2, u1):
    wo = warp.square_to_cosine_hemisphere(u2)
    pdf = warp.square_to_cosine_hemisphere_pdf(wo)
    valid = (m.cos_theta(wi) > 0) & (pdf > 0)
    s = zero_sample(wi, p["reflectance"].shape[-1])
    s.update(
        wo=wo,
        weight=_mask3(valid, p["reflectance"]),
        pdf=torch.where(valid, pdf, 0.0),
        valid=valid,
    )
    return s


def _zero_eval(p, wi):
    return torch.zeros(wi.shape[:-1] + (p["reflectance"].shape[-1],),
                       device=wi.device)


def _zero_pdf(wi):
    return torch.zeros(wi.shape[:-1], device=wi.device)


# smooth mirror (src/bsdfs/mirror.cpp)

def mirror_eval(p, wi, wo):
    return _zero_eval(p, wi)


def mirror_pdf(p, wi, wo):
    return _zero_pdf(wi)


def mirror_sample(p, wi, u2, u1):
    valid = m.cos_theta(wi) > 0
    s = zero_sample(wi, p["reflectance"].shape[-1])
    s.update(
        wo=m.reflect_local(wi),
        weight=_mask3(valid, p["specular"]),
        pdf=torch.where(valid, 1.0, 0.0),
        delta=valid,
        valid=valid,
    )
    return s


# smooth dielectric (src/bsdfs/dielectric.cpp)

def dielectric_eval(p, wi, wo):
    return _zero_eval(p, wi)


def dielectric_pdf(p, wi, wo):
    return _zero_pdf(wi)


def dielectric_sample(p, wi, u2, u1):
    eta = p["eta"]
    ci = m.cos_theta(wi)
    fr, cos_t = fresnel_dielectric_ext(ci, eta)
    reflect = u1 < fr
    rel_eta = torch.where(ci > 0, eta, 1.0 / eta)
    # the refracted direction in the local frame (z = normal)
    scale = -1.0 / rel_eta
    wo_t = torch.stack([wi[..., 0] * scale, wi[..., 1] * scale, cos_t],
                       dim=-1)
    wo = torch.where(reflect[..., None], m.reflect_local(wi), wo_t)
    # radiance is compressed by (1 / eta)^2 on refraction (reference
    # dielectric.cpp sampleCos); the event's probability is folded in
    t_scale = (1.0 / rel_eta) ** 2
    weight = torch.where(reflect[..., None], p["specular"],
                         p["transmittance"] * t_scale[..., None])
    valid = reflect | (cos_t != 0.0)          # not under total reflection
    s = zero_sample(wi, p["reflectance"].shape[-1])
    s.update(
        wo=wo,
        weight=_mask3(valid, weight),
        pdf=torch.where(valid, torch.where(reflect, fr, 1.0 - fr), 0.0),
        delta=valid,
        transmission=valid & ~reflect,
        eta=torch.where(reflect, 1.0, rel_eta),
        valid=valid,
    )
    return s


# rough conductor: microfacet reflection (src/bsdfs/roughmetal.cpp, the
# microfacet lobe of src/bsdfs/microfacet.cpp)

def rough_conductor_eval(p, wi, wo):
    upper = _both_upper(wi, wo)
    dist, alpha = p["_dist_static"], p["alpha_u"]
    wh = m.normalize(wi + wo)
    d = mf.eval_d(dist, alpha, wh)
    g = mf.smith_g(dist, alpha, wi, wo, wh)
    f = fresnel_conductor(m.dot(wi, wh), p["cond_eta"], p["cond_k"])
    ci = torch.clamp(m.cos_theta(wi), min=1e-6)
    return _mask3(upper, p["specular"] * f * (d * g / (4.0 * ci))[..., None])


def _half_to_solid_angle(pdf_h, wo, wh):
    return pdf_h / torch.clamp(4.0 * torch.abs(m.dot(wo, wh)), min=1e-8)


def rough_conductor_pdf(p, wi, wo):
    wh = m.normalize(wi + wo)
    pdf_h = mf.pdf_wh(p["_dist_static"], p["alpha_u"], wh)
    return torch.where(_both_upper(wi, wo),
                       _half_to_solid_angle(pdf_h, wo, wh), 0.0)


def rough_conductor_sample(p, wi, u2, u1):
    wh, pdf_h = mf.sample_wh(p["_dist_static"], p["alpha_u"], u2)
    wo = m.reflect(wi, wh)
    pdf = _half_to_solid_angle(pdf_h, wo, wh)
    valid = _both_upper(wi, wo) & (pdf > 1e-12)
    fcos = rough_conductor_eval(p, wi, wo)
    s = zero_sample(wi, p["reflectance"].shape[-1])
    s.update(
        wo=wo,
        weight=_mask3(valid, fcos / torch.clamp(pdf, min=1e-12)[..., None]),
        pdf=torch.where(valid, pdf, 0.0),
        valid=valid,
    )
    return s


# modified phong (src/bsdfs/phong.cpp)

def _luminance(c):
    return c[..., 0] * 0.212671 + c[..., 1] * 0.715160 + c[..., 2] * 0.072169


def _phong_spec_prob(p):
    """Probability of sampling the specular lobe: its share of the
    luminance."""
    kd = _luminance(p["reflectance"])
    ks = _luminance(p["specular"])
    return ks / torch.clamp(kd + ks, min=1e-8)


def phong_eval(p, wi, wo):
    upper = _both_upper(wi, wo)
    alpha = m.dot(wo, m.reflect_local(wi))
    n = p["exponent"]
    spec = p["specular"] * ((n + 2.0) * m.INV_TWOPI * torch.pow(
        torch.clamp(alpha, min=0.0), n))[..., None]
    diff = p["reflectance"] * m.INV_PI
    return _mask3(upper, (spec + diff)
                  * torch.clamp(m.cos_theta(wo), min=0.0)[..., None])


def phong_pdf(p, wi, wo):
    upper = _both_upper(wi, wo)
    alpha = torch.clamp(m.dot(wo, m.reflect_local(wi)), min=0.0)
    n = p["exponent"]
    spec_prob = _phong_spec_prob(p)
    pdf_spec = (n + 1.0) * m.INV_TWOPI * torch.pow(alpha, n)
    pdf_diff = warp.square_to_cosine_hemisphere_pdf(wo)
    return torch.where(upper, spec_prob * pdf_spec
                       + (1.0 - spec_prob) * pdf_diff, 0.0)


def phong_sample(p, wi, u2, u1):
    choose_spec = u1 < _phong_spec_prob(p)
    # specular: a cos^n lobe around the mirror direction
    n = p["exponent"]
    cos_a = torch.pow(torch.clamp(u2[..., 0], min=1e-20), 1.0 / (n + 1.0))
    sin_a = m.safe_sqrt(1.0 - cos_a * cos_a)
    phi = 2.0 * math.pi * u2[..., 1]
    lobe = torch.stack([sin_a * torch.cos(phi), sin_a * torch.sin(phi),
                        cos_a], dim=-1)
    wo_spec = m.Frame.from_normal(m.reflect_local(wi)).to_world(lobe)
    wo_diff = warp.square_to_cosine_hemisphere(u2)
    wo = torch.where(choose_spec[..., None], wo_spec, wo_diff)
    pdf = phong_pdf(p, wi, wo)
    valid = _both_upper(wi, wo) & (pdf > 1e-10)
    fcos = phong_eval(p, wi, wo)
    s = zero_sample(wi, p["reflectance"].shape[-1])
    s.update(
        wo=wo,
        weight=_mask3(valid, fcos / torch.clamp(pdf, min=1e-10)[..., None]),
        pdf=torch.where(valid, pdf, 0.0),
        valid=valid,
    )
    return s


def _smooth_sample(wi, wo, pdf, fcos, valid, c, floor):
    """The sample dict of a non-delta reflection: weight fCos / pdf."""
    s = zero_sample(wi, c)
    s.update(
        wo=wo,
        weight=_mask3(valid, fcos / torch.clamp(pdf, min=floor)[..., None]),
        pdf=torch.where(valid, pdf, 0.0),
        valid=valid,
    )
    return s


# anisotropic Ward (src/bsdfs/ward.cpp, Walter's sampling notes)

def ward_eval(p, wi, wo):
    upper = _both_upper(wi, wo)
    au, av = p["alpha_u"], p["alpha_v"]
    ci = torch.clamp(m.cos_theta(wi), min=1e-6)
    co = torch.clamp(m.cos_theta(wo), min=1e-6)
    h = wi + wo
    hz2 = torch.clamp(h[..., 2] * h[..., 2], min=1e-12)
    exp_term = torch.exp(-((h[..., 0] / au) ** 2 + (h[..., 1] / av) ** 2)
                         / hz2)
    spec = p["specular"] * (
        exp_term / (4.0 * math.pi * au * av * torch.sqrt(ci * co)))[..., None]
    diff = p["reflectance"] * m.INV_PI
    return _mask3(upper, (spec + diff) * co[..., None])


def _ward_pdf_h(p, wi, wo):
    """pdf of a wo sampled through the half vector (Walter PCG-05-06
    eq. 9)."""
    au, av = p["alpha_u"], p["alpha_v"]
    wh = m.normalize(wi + wo)
    ct = torch.clamp(wh[..., 2], min=1e-6)
    st2 = torch.clamp(1.0 - ct * ct, min=0.0)
    cp2 = torch.where(st2 > 0, wh[..., 0] ** 2 / torch.clamp(st2, min=1e-12),
                      1.0)
    sp2 = torch.where(st2 > 0, wh[..., 1] ** 2 / torch.clamp(st2, min=1e-12),
                      0.0)
    tan2 = st2 / (ct * ct)
    e = torch.exp(-tan2 * (cp2 / (au * au) + sp2 / (av * av)))
    dot_hw = torch.clamp(torch.abs(m.dot(wh, wi)), min=1e-6)
    return e / (4.0 * math.pi * au * av * dot_hw * ct ** 3)


def ward_pdf(p, wi, wo):
    spec_prob = _phong_spec_prob(p)
    pdf = spec_prob * _ward_pdf_h(p, wi, wo) + (1.0 - spec_prob) \
        * warp.square_to_cosine_hemisphere_pdf(wo)
    return torch.where(_both_upper(wi, wo), pdf, 0.0)


def ward_sample(p, wi, u2, u1):
    au, av = p["alpha_u"], p["alpha_v"]
    choose_spec = u1 < _phong_spec_prob(p)
    # the anisotropic half vector, its azimuth in the right quadrant
    phi_p = torch.atan2(av * torch.sin(2 * math.pi * u2[..., 1]),
                        au * torch.cos(2 * math.pi * u2[..., 1]))
    cp, sp = torch.cos(phi_p), torch.sin(phi_p)
    denom = cp * cp / (au * au) + sp * sp / (av * av)
    tan2t = -torch.log(torch.clamp(u2[..., 0], min=1e-20)) \
        / torch.clamp(denom, min=1e-12)
    ct = 1.0 / torch.sqrt(1.0 + tan2t)
    st = m.safe_sqrt(1.0 - ct * ct)
    wh = torch.stack([st * cp, st * sp, ct], dim=-1)
    wo = torch.where(choose_spec[..., None], m.reflect(wi, wh),
                     warp.square_to_cosine_hemisphere(u2))
    pdf = ward_pdf(p, wi, wo)
    valid = _both_upper(wi, wo) & (pdf > 1e-10)
    return _smooth_sample(wi, wo, pdf, ward_eval(p, wi, wo), valid,
                          p["reflectance"].shape[-1], 1e-10)


# rough dielectric (Walter 2007; src/bsdfs/roughglass.cpp:776)

def _roughglass_terms(p, wi, wo):
    """Half vectors, and the guards that each direction lies on its own
    side of the micronormal (reference roughglass.cpp sidedness). The
    micronormals lie on the +z (exterior) hemisphere; the signed cosine
    given to fresnel_dielectric_ext picks the relative IOR."""
    eta = p["eta"]
    ci, co = m.cos_theta(wi), m.cos_theta(wo)
    wh = m.normalize(wi + wo)
    wh = wh * torch.sign(wh[..., 2:3])
    eta_i = torch.where(ci > 0, 1.0, eta)
    eta_o = torch.where(ci > 0, eta, 1.0)
    ht = m.normalize(-(wi * eta_i[..., None] + wo * eta_o[..., None]))
    ht = ht * torch.sign(ht[..., 2:3])
    ok_r = (m.dot(wi, wh) * ci > 0) & (m.dot(wo, wh) * co > 0)
    ok_t = (m.dot(wi, ht) * ci > 0) & (m.dot(wo, ht) * co > 0)
    return eta, ci, co, wh, ht, eta_i, eta_o, ok_r, ok_t


def roughglass_eval(p, wi, wo):
    dist, alpha = p["_dist_static"], p["alpha_u"]
    eta, ci, co, wh, ht, eta_i, eta_o, ok_r, ok_t = \
        _roughglass_terms(p, wi, wo)
    # reflection: fCos = F D G / (4 |ci|)
    fr_r, _ = fresnel_dielectric_ext(m.dot(wi, wh), eta)
    d_r = mf.eval_d(dist, alpha, wh)
    g_r = mf.smith_g(dist, alpha, wi, wo, wh)
    val_r = p["specular"] * (fr_r * d_r * g_r / torch.clamp(
        4.0 * torch.abs(ci), min=1e-8))[..., None]
    # transmission (Walter 2007 eq. 21), radiance scaled by
    # (eta_i / eta_o)^2
    wi_ht, wo_ht = m.dot(wi, ht), m.dot(wo, ht)
    fr_t, _ = fresnel_dielectric_ext(wi_ht, eta)
    d_t = mf.eval_d(dist, alpha, ht)
    g_t = mf.smith_g(dist, alpha, wi, wo, ht)
    denom = (eta_i * wi_ht + eta_o * wo_ht) ** 2
    f_t = (torch.abs(wi_ht * wo_ht) * eta_o * eta_o * (1.0 - fr_t) * d_t
           * g_t) / (torch.clamp(torch.abs(ci * co), min=1e-8)
                     * torch.clamp(denom, min=1e-10))
    f_t = f_t * (eta_i / eta_o) ** 2
    val_t = p["transmittance"] * (f_t * torch.abs(co))[..., None]
    val = torch.where((ci * co > 0)[..., None],
                      _mask3(ok_r, val_r), _mask3(ok_t, val_t))
    return _mask3(torch.abs(ci) > 1e-6, val)


def roughglass_pdf(p, wi, wo):
    dist, alpha = p["_dist_static"], p["alpha_u"]
    eta, ci, co, wh, ht, eta_i, eta_o, ok_r, ok_t = \
        _roughglass_terms(p, wi, wo)
    fr_r, _ = fresnel_dielectric_ext(m.dot(wi, wh), eta)
    pdf_r = fr_r * mf.pdf_wh(dist, alpha, wh) / torch.clamp(
        4.0 * torch.abs(m.dot(wo, wh)), min=1e-8)
    wi_ht, wo_ht = m.dot(wi, ht), m.dot(wo, ht)
    fr_t, _ = fresnel_dielectric_ext(wi_ht, eta)
    jac = eta_o * eta_o * torch.abs(wo_ht) / torch.clamp(
        (eta_i * wi_ht + eta_o * wo_ht) ** 2, min=1e-10)
    pdf_t = (1.0 - fr_t) * mf.pdf_wh(dist, alpha, ht) * jac
    return torch.where(ci * co > 0, torch.where(ok_r, pdf_r, 0.0),
                       torch.where(ok_t, pdf_t, 0.0))


def roughglass_sample(p, wi, u2, u1):
    dist, alpha, eta = p["_dist_static"], p["alpha_u"], p["eta"]
    ci = m.cos_theta(wi)
    wh, _ = mf.sample_wh(dist, alpha, u2)   # a +z micronormal
    cos_ih = m.dot(wi, wh)
    fr, _ = fresnel_dielectric_ext(cos_ih, eta)
    reflect = u1 < fr
    # the crossing's relative IOR, by the side wi is on
    rel_eta = torch.where(cos_ih > 0, eta, 1.0 / eta)
    wo_t, tir = m.refract(wi, wh, rel_eta)
    wo = torch.where(reflect[..., None], m.reflect(wi, wh), wo_t)
    pdf = roughglass_pdf(p, wi, wo)
    fcos = roughglass_eval(p, wi, wo)
    co = m.cos_theta(wo)
    ok_side = torch.where(reflect, ci * co > 0, ci * co < 0)
    # a micronormal that wi's side cannot see is rejected: the pdf models
    # front-facing events only (reference roughglass.cpp sidedness)
    facing = cos_ih * ci > 0
    valid = ok_side & facing & (pdf > 1e-10) & (reflect | ~tir)
    s = _smooth_sample(wi, wo, pdf, fcos, valid,
                       p["reflectance"].shape[-1], 1e-10)
    s.update(transmission=valid & ~reflect,
             eta=torch.where(reflect, 1.0, rel_eta))
    return s


# diffuse transmitter (src/bsdfs/difftrans.cpp)

def _opposite(wi, wo):
    return (m.cos_theta(wi) > 0) & (m.cos_theta(wo) < 0)


def difftrans_eval(p, wi, wo):
    f = p["transmittance"] * m.INV_PI \
        * torch.abs(m.cos_theta(wo))[..., None]
    return _mask3(_opposite(wi, wo), f)


def difftrans_pdf(p, wi, wo):
    return torch.where(_opposite(wi, wo),
                       torch.abs(m.cos_theta(wo)) * m.INV_PI, 0.0)


def difftrans_sample(p, wi, u2, u1):
    flip = torch.tensor([1.0, 1.0, -1.0], dtype=wi.dtype, device=wi.device)
    wo = warp.square_to_cosine_hemisphere(u2) * flip
    pdf = torch.abs(m.cos_theta(wo)) * m.INV_PI
    valid = (m.cos_theta(wi) > 0) & (pdf > 0)
    s = zero_sample(wi, p["reflectance"].shape[-1])
    s.update(
        wo=wo,
        weight=_mask3(valid, p["transmittance"]),
        pdf=torch.where(valid, pdf, 0.0),
        transmission=valid,
        valid=valid,
    )
    return s


def _cosine_sample(eval_fn, p, wi, u2):
    """Cosine-hemisphere sampling of a smooth reflection, weight fCos /
    pdf."""
    wo = warp.square_to_cosine_hemisphere(u2)
    pdf = warp.square_to_cosine_hemisphere_pdf(wo)
    valid = (m.cos_theta(wi) > 0) & (pdf > 0)
    return _smooth_sample(wi, wo, pdf, eval_fn(p, wi, wo), valid,
                          p["reflectance"].shape[-1], 1e-9)


# the Wiscombe-Warren snow BRDF (the fork's src/bsdfs/wiscombe.cpp:294).
# The table holds its delta-Eddington constants (table.py wiscombe()):
# reflectance <- A = wStar / (1 + P), specular <- xi, transmittance <-
# bStar. f = albedo(cos wo) fBar / pi^2, the reference's double INV_PI
# included (wiscombe.cpp:112-133), sampled over the cosine hemisphere.

def wiscombe_eval(p, wi, wo):
    upper = _both_upper(wi, wo)
    mu0 = torch.clamp(m.cos_theta(wo), min=1e-6)
    mu_p = torch.clamp(m.cos_theta(wi), min=1e-6)
    xi = p["specular"]
    albedo = p["reflectance"] * (1.0 - xi * mu0[..., None]
                                 * p["transmittance"]) \
        / (1.0 + xi * mu0[..., None])
    b = 1.07 * mu0 - 0.84
    fbar = (3.0 / (3.0 - b)) * (1.0 + b * (mu_p - 1.0))
    f = albedo * (fbar * m.INV_PI * m.INV_PI)[..., None]
    return _mask3(upper, f * torch.clamp(m.cos_theta(wo), min=0.0)[..., None])


def wiscombe_pdf(p, wi, wo):
    return lambertian_pdf(p, wi, wo)


def wiscombe_sample(p, wi, u2, u1):
    return _cosine_sample(wiscombe_eval, p, wi, u2)


# Hanrahan-Krueger thin-slab single scattering plus a diffuse term
# (src/bsdfs/hanrahan-krueger.cpp:154-193). The table holds
# reflectance <- the single-scattering albedo times ssFactor,
# transmittance <- the diffuse reflectance, eta <- etaInt / etaExt,
# alpha_u <- g (table.py hanrahan_krueger()).

def hk_eval(p, wi, wo):
    upper = _both_upper(wi, wo)
    ci, co = m.cos_theta(wi), m.cos_theta(wo)
    eta = p["eta"]
    one = torch.ones_like(eta)
    fr_prod = (1.0 - fresnel(co, one, eta)) * (1.0 - fresnel(ci, one, eta))
    g = p["alpha_u"]
    # the reference's hgPhaseFunction: cos = dot(-wi, wo), normalized by
    # 1/2
    cos_t = m.dot(-wi, wo)
    g2 = g * g
    phase = 0.5 * (1.0 - g2) / torch.pow(
        torch.clamp(1.0 + g2 - 2.0 * g * cos_t, min=1e-8), 1.5)
    f1 = p["reflectance"] * (fr_prod * phase / torch.clamp(
        torch.abs(ci) + torch.abs(co), min=1e-6))[..., None]
    lo = f1 + p["transmittance"] * (fr_prod * m.INV_PI)[..., None]
    return _mask3(upper, lo * m.INV_PI
                  * torch.clamp(co, min=0.0)[..., None])


def hk_pdf(p, wi, wo):
    return lambertian_pdf(p, wi, wo)


def hk_sample(p, wi, u2, u1):
    return _cosine_sample(hk_eval, p, wi, u2)
