"""Microfacet normal distributions: Beckmann, GGX and Phong (port of
mitsuba_tpu/core/microfacet.py; reference src/bsdfs/microfacet.cpp,
roughglass.cpp:776).

All functions work in the local shading frame (+z = normal) and broadcast
over wavefront axes. The distribution is a static int, chosen in Python,
with the reference's codes: BECKMANN = 0, GGX = 1, PHONG = 2. For Phong,
`alpha` is the exponent.
"""
from __future__ import annotations

import math

import torch

from mitsuba_tpu_torch.core import math as m

BECKMANN, GGX, PHONG = 0, 1, 2


def _ct2(w):
    return torch.clamp(w[..., 2] * w[..., 2], 1e-12, 1.0)


def eval_d(dist_type: int, alpha, wh):
    """Microfacet distribution D(wh) for half-vector wh (upper
    hemisphere)."""
    ct = wh[..., 2]
    ct2 = _ct2(wh)
    t2 = (1.0 - ct2) / ct2  # tan^2 theta_h
    a2 = alpha * alpha
    if dist_type == BECKMANN:
        d = torch.exp(-t2 / a2) / (math.pi * a2 * ct2 * ct2)
    elif dist_type == GGX:
        denom = math.pi * ct2 * ct2 * (a2 + t2) ** 2
        d = a2 / torch.clamp(denom, min=1e-20)
    elif dist_type == PHONG:
        d = (alpha + 2.0) * m.INV_TWOPI * torch.pow(
            torch.clamp(ct, min=0.0), alpha)
    else:
        raise ValueError(dist_type)
    return torch.where(ct > 0, d, 0.0)


def sample_wh(dist_type: int, alpha, sample):
    """Sample a half-vector ~ D(wh) |cos|; returns (wh, pdf)."""
    u1, u2 = sample[..., 0], sample[..., 1]
    phi = 2.0 * math.pi * u2
    if dist_type == BECKMANN:
        log_u = torch.log(torch.clamp(1.0 - u1, min=1e-20))
        ct = 1.0 / torch.sqrt(1.0 + (-alpha * alpha * log_u))
    elif dist_type == GGX:
        t2 = alpha * alpha * u1 / torch.clamp(1.0 - u1, min=1e-9)
        ct = 1.0 / torch.sqrt(1.0 + t2)
    elif dist_type == PHONG:
        ct = torch.pow(torch.clamp(u1, min=1e-20), 1.0 / (alpha + 2.0))
    else:
        raise ValueError(dist_type)
    st = m.safe_sqrt(1.0 - ct * ct)
    wh = torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], dim=-1)
    return wh, pdf_wh(dist_type, alpha, wh)


def pdf_wh(dist_type: int, alpha, wh):
    """pdf of sample_wh with respect to solid angle: D(wh) cos(theta_h)."""
    return eval_d(dist_type, alpha, wh) * torch.clamp(wh[..., 2], min=0.0)


def smith_g1(dist_type: int, alpha, w, wh):
    """Smith masking-shadowing for one direction (reference
    roughglass.cpp)."""
    ct = w[..., 2]
    tan_t = torch.abs(m.tan_theta(w))
    # back-facing with respect to the half vector: fully shadowed
    backfacing = (m.dot(w, wh) * ct) <= 0
    if dist_type in (BECKMANN, PHONG):
        if dist_type == PHONG:
            # the exponent's Beckmann roughness (Walter's mapping)
            alpha = torch.sqrt(2.0 / (alpha + 2.0))
        a = 1.0 / torch.clamp(alpha * tan_t, min=1e-20)
        g = torch.where(
            a < 1.6,
            (3.535 * a + 2.181 * a * a) / (1.0 + 2.276 * a + 2.577 * a * a),
            1.0)
    elif dist_type == GGX:
        root = alpha * tan_t
        g = 2.0 / (1.0 + torch.sqrt(1.0 + root * root))
    else:
        raise ValueError(dist_type)
    return torch.where(backfacing, 0.0, g)


def smith_g(dist_type: int, alpha, wi, wo, wh):
    return smith_g1(dist_type, alpha, wi, wh) * smith_g1(dist_type, alpha,
                                                          wo, wh)


def roughness_to_alpha(dist_type: int, roughness):
    """A user's roughness as the distribution's parameter: for Phong, the
    Beckmann-matched exponent (reference roughglass.cpp:176)."""
    if dist_type == PHONG:
        return torch.clamp(2.0 / (roughness * roughness) - 2.0, min=0.1)
    return roughness
