"""Square → distribution warps with their pdfs (port of the parts of
mitsuba_tpu/core/warp.py that the path and particle tracers, the lights
and the thin lens use).

Samples are uniform in [0,1)^2 with a trailing axis of 2; pdfs are with
respect to solid angle.
"""
from __future__ import annotations

import math

import torch

from mitsuba_tpu_torch.core.math import INV_FOURPI, INV_PI, INV_TWOPI, safe_sqrt


def square_to_uniform_sphere(sample):
    z = 1.0 - 2.0 * sample[..., 0]
    r = safe_sqrt(1.0 - z * z)
    phi = 2.0 * math.pi * sample[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def square_to_uniform_sphere_pdf(d):
    return torch.full(d.shape[:-1], INV_FOURPI, dtype=d.dtype,
                      device=d.device)


def square_to_uniform_hemisphere(sample):
    z = sample[..., 0]
    r = safe_sqrt(1.0 - z * z)
    phi = 2.0 * math.pi * sample[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def square_to_uniform_hemisphere_pdf(d):
    return torch.where(d[..., 2] >= 0, INV_TWOPI, 0.0)


def square_to_uniform_cone(cos_cutoff, sample):
    """Uniform direction in a cone around +z with cos(angle) >= cos_cutoff
    (cos_cutoff a float or a tensor broadcasting against the sample)."""
    cos_theta = (1.0 - sample[..., 0]) + sample[..., 0] * cos_cutoff
    sin_theta = safe_sqrt(1.0 - cos_theta * cos_theta)
    phi = 2.0 * math.pi * sample[..., 1]
    return torch.stack([torch.cos(phi) * sin_theta,
                        torch.sin(phi) * sin_theta, cos_theta], dim=-1)


def square_to_uniform_cone_pdf(cos_cutoff, d=None):
    pdf = 1.0 / (2.0 * math.pi * (1.0 - cos_cutoff))
    if d is None:
        return pdf
    return torch.where(d[..., 2] >= cos_cutoff, pdf, 0.0)


def square_to_uniform_disk(sample):
    r = torch.sqrt(sample[..., 0])
    phi = 2.0 * math.pi * sample[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], dim=-1)


def square_to_uniform_disk_concentric(sample):
    """Shirley's low-distortion concentric mapping — branchless variant."""
    ox = 2.0 * sample[..., 0] - 1.0
    oy = 2.0 * sample[..., 1] - 1.0
    zero = (ox == 0.0) & (oy == 0.0)
    use_x = torch.abs(ox) > torch.abs(oy)
    r = torch.where(use_x, ox, oy)
    denom = torch.where(use_x, torch.where(ox == 0, 1.0, ox),
                        torch.where(oy == 0, 1.0, oy))
    ratio = torch.where(use_x, oy, ox) / denom
    phi = torch.where(use_x, (math.pi / 4.0) * ratio,
                      (math.pi / 2.0) - (math.pi / 4.0) * ratio)
    r = torch.where(zero, 0.0, r)
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], dim=-1)


def square_to_cosine_hemisphere(sample):
    """PSA-weighted hemisphere (pdf = cos(theta)/pi), via concentric disk."""
    p = square_to_uniform_disk_concentric(sample)
    px, py = p[..., 0], p[..., 1]
    z = safe_sqrt(1.0 - px * px - py * py)
    return torch.stack([px, py, z], dim=-1)


def square_to_cosine_hemisphere_pdf(d):
    return torch.clamp(d[..., 2], min=0.0) * INV_PI


def square_to_uniform_triangle(sample):
    """Uniform barycentric coordinates (reference util.cpp squareToTriangle)."""
    a = safe_sqrt(1.0 - sample[..., 0])
    return torch.stack([1.0 - a, a * sample[..., 1]], dim=-1)
