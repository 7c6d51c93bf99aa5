"""BSDF models in the local shading frame (port of the lambertian and
modified-phong models of mitsuba_tpu/bsdfs/models.py:1-60, 200-258;
reference src/bsdfs/lambertian.cpp:204 and phong.cpp).

    eval(p, wi, wo)       -> fCos (N, C): f(wi, wo) * |cos_theta(wo)|
    pdf(p, wi, wo)        -> (N,) solid-angle density of sample()
    sample(p, wi, u2, u1) -> dict(wo, weight, pdf, delta, transmission, eta,
                                  valid)
with p the per-lane gathered parameter dict (bsdfs/table.py).
"""
from __future__ import annotations

import math

import torch

from mitsuba_tpu_torch.core import math as m
from mitsuba_tpu_torch.core import warp


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
