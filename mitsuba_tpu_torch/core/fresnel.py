"""Fresnel reflectance of dielectrics and conductors (port of the parts of
mitsuba_tpu/core/fresnel.py that the BSDFs use; reference
src/libcore/util.cpp fresnelDielectric, fresnel, fresnelConductor).
"""
from __future__ import annotations

import torch

from mitsuba_tpu_torch.core.math import safe_sqrt


def fresnel_dielectric(cos_i, cos_t, eta_i, eta_t):
    """Unpolarized Fresnel reflectance given both angles (positive
    cosines)."""
    rs = (eta_i * cos_i - eta_t * cos_t) / (eta_i * cos_i + eta_t * cos_t)
    rp = (eta_t * cos_i - eta_i * cos_t) / (eta_t * cos_i + eta_i * cos_t)
    return 0.5 * (rs * rs + rp * rp)


def fresnel(cos_i, eta_ext, eta_int):
    """Reflectance for incidence from either side: cos_i is signed
    (positive outside); 1 under total internal reflection."""
    entering = cos_i > 0.0
    eta_i = torch.where(entering, eta_ext, eta_int)
    eta_t = torch.where(entering, eta_int, eta_ext)
    abs_ci = torch.abs(cos_i)
    sin2_t = (eta_i / eta_t) ** 2 * torch.clamp(1.0 - abs_ci * abs_ci,
                                                min=0.0)
    tir = sin2_t >= 1.0
    cos_t = safe_sqrt(1.0 - sin2_t)
    return torch.where(tir, 1.0, fresnel_dielectric(abs_ci, cos_t, eta_i,
                                                    eta_t))


def fresnel_dielectric_ext(cos_i, eta):
    """Reflectance and transmitted cosine for the relative IOR eta.

    Returns (F, cos_t), cos_t the signed transmitted-side cosine (of the
    sign opposite to cos_i), 0 under total internal reflection.
    """
    entering = cos_i > 0.0
    rel_eta = torch.where(entering, eta, 1.0 / eta)
    abs_ci = torch.abs(cos_i)
    sin2_t = torch.clamp(1.0 - abs_ci * abs_ci, min=0.0) / (rel_eta * rel_eta)
    tir = sin2_t >= 1.0
    abs_ct = safe_sqrt(1.0 - sin2_t)
    fr = torch.where(tir, 1.0, fresnel_dielectric(abs_ci, abs_ct, 1.0,
                                                  rel_eta))
    cos_t = torch.where(tir, 0.0, -torch.sign(cos_i) * abs_ct)
    return fr, cos_t


def fresnel_conductor(cos_i, eta, k):
    """Unpolarized conductor Fresnel per spectral channel: eta and k have
    a trailing spectrum axis, cos_i broadcasts from (...,)."""
    ci = torch.abs(cos_i)[..., None]
    ci2 = ci * ci
    tmp = (eta * eta + k * k) * ci2
    rs2 = (tmp - 2.0 * eta * ci + 1.0) / (tmp + 2.0 * eta * ci + 1.0)
    tmp2 = eta * eta + k * k
    rp2 = (tmp2 - 2.0 * eta * ci + ci2) / (tmp2 + 2.0 * eta * ci + ci2)
    return 0.5 * (rp2 + rs2)
