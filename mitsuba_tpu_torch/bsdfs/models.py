"""BSDF models in the local shading frame (port of the lambertian model of
mitsuba_tpu/bsdfs/models.py; reference src/bsdfs/lambertian.cpp:204).

    eval(p, wi, wo)       -> fCos (N, C): f(wi, wo) * |cos_theta(wo)|
    pdf(p, wi, wo)        -> (N,) solid-angle density of sample()
    sample(p, wi, u2, u1) -> dict(wo, weight, pdf, delta, transmission, eta,
                                  valid)
with p the per-lane gathered parameter dict (bsdfs/table.py).
"""
from __future__ import annotations

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
