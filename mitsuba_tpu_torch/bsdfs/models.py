"""BSDF models in the local shading frame (port of the lambertian,
mirror, dielectric, rough-conductor and modified-phong models of
mitsuba_tpu/bsdfs/models.py:1-258; reference src/bsdfs/lambertian.cpp:204,
mirror.cpp, dielectric.cpp, roughmetal.cpp and phong.cpp).

    eval(p, wi, wo)       -> fCos (N, C): f(wi, wo) * |cos_theta(wo)|
    pdf(p, wi, wo)        -> (N,) solid-angle density of sample()
    sample(p, wi, u2, u1) -> dict(wo, weight, pdf, delta, transmission, eta,
                                  valid)
with p the per-lane gathered parameter dict (bsdfs/table.py), and for the
rough conductor p["_dist_static"] the static microfacet distribution.

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
    fresnel_conductor, fresnel_dielectric_ext,
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
