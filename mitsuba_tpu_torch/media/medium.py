"""Participating media: the homogeneous medium in closed form (port of the
homogeneous parts of mitsuba_tpu/media/medium.py; reference
src/medium/homogeneous.cpp sampleDistance / getTransmittance).

A `MediumTable` is the one ambient medium that the volumetric path tracer
is given: it fills space. Heterogeneous grids raise: their Woodcock
tracking draws `jax.random` keys (medium.py:315-341), whose streams the
port does not reproduce. So do oriented and Gaussian-flake media.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from mitsuba_tpu_torch.media.phase import HG, ISOTROPIC

HOMOGENEOUS, HETEROGENEOUS = 0, 1


@dataclass
class MediumTable:
    sigma_s: torch.Tensor       # (3,) scattering coefficient
    sigma_a: torch.Tensor       # (3,) absorption
    phase_g: torch.Tensor       # () HG anisotropy
    kind: int = HOMOGENEOUS
    phase_kind: int = ISOTROPIC
    enabled: bool = False

    @property
    def sigma_t(self):
        return self.sigma_s + self.sigma_a

    def to(self, device) -> "MediumTable":
        return dataclasses.replace(
            self, sigma_s=self.sigma_s.to(device),
            sigma_a=self.sigma_a.to(device), phase_g=self.phase_g.to(device))


def no_medium() -> MediumTable:
    return MediumTable(sigma_s=torch.zeros(3), sigma_a=torch.zeros(3),
                       phase_g=torch.zeros(()), kind=HOMOGENEOUS,
                       phase_kind=ISOTROPIC, enabled=False)


def make_homogeneous(sigma_s, sigma_a, g: float = 0.0,
                     phase_kind: int = None) -> MediumTable:
    """A homogeneous medium, HG-scattering when g != 0 and no phase kind is
    given (medium.py:62). Host tensors; the integrator moves them to the
    scene's device."""
    pk = HG if (phase_kind is None and g != 0.0) else (
        phase_kind if phase_kind is not None else ISOTROPIC)
    return MediumTable(
        sigma_s=torch.as_tensor(sigma_s, dtype=torch.float32),
        sigma_a=torch.as_tensor(sigma_a, dtype=torch.float32),
        phase_g=torch.as_tensor(g, dtype=torch.float32),
        kind=HOMOGENEOUS, phase_kind=pk, enabled=True)


def check_medium(med: MediumTable):
    if med.enabled and med.kind != HOMOGENEOUS:
        raise NotImplementedError(
            "heterogeneous media are not ported (Woodcock tracking draws "
            "jax.random keys)")


def medium_transmittance(med: MediumTable, o, d, dist):
    """Transmittance along the segments [o, o + d dist] (reference
    Medium::getTransmittance, medium.h:141): exp(-σ_t dist) exactly."""
    check_medium(med)
    if not med.enabled:
        return torch.ones(o.shape[:-1] + (3,), dtype=o.dtype,
                          device=o.device)
    return torch.exp(-med.sigma_t[None, :] * dist[..., None])


def sample_distance(med: MediumTable, o, d, max_dist, u_channel, u_dist):
    """Sample a medium interaction along rays (reference
    Medium::sampleDistance, medium.h:110). Returns dict(valid: interacted
    before max_dist, t, p, weight (N, 3), surface_weight (N, 3)): `weight`
    multiplies the throughput on a medium event, `surface_weight` when the
    surface is reached."""
    check_medium(med)
    n = o.shape[0]
    if not med.enabled:
        ones = torch.ones((n, 3), dtype=o.dtype, device=o.device)
        return dict(valid=torch.zeros(n, dtype=torch.bool, device=o.device),
                    t=max_dist, p=o + d * max_dist[:, None], weight=ones,
                    surface_weight=ones)
    sigma_t = med.sigma_t
    # channel-stratified exponential sampling (reference homogeneous.cpp
    # strategy EBalance): pick a channel uniformly, pdf = mean over them
    ch = torch.clamp((u_channel * 3).to(torch.int32), 0, 2).long()
    st_ch = sigma_t[ch]
    st_div = torch.where(st_ch > 0, st_ch, 1.0)
    t_raw = -torch.log(torch.clamp(1.0 - u_dist, min=1e-20)) / st_div
    t = torch.where(st_ch > 0, t_raw, max_dist)
    valid = (t < max_dist) & (st_ch > 0)
    t_clamped = torch.minimum(t, max_dist)
    tr = torch.exp(-sigma_t[None, :] * t_clamped[:, None])       # (N, 3)
    # pdf of sampling t (medium event): mean_c σ_c exp(-σ_c t)
    pdf_t = torch.mean(sigma_t[None, :] * tr, dim=1)
    # probability of passing max_dist: mean_c exp(-σ_c max)
    tr_max = torch.exp(-sigma_t[None, :] * max_dist[:, None])
    pdf_surf = torch.mean(tr_max, dim=1)
    weight = med.sigma_s[None, :] * tr / torch.clamp(
        pdf_t, min=1e-20)[:, None]
    surface_weight = tr_max / torch.clamp(pdf_surf, min=1e-20)[:, None]
    return dict(valid=valid, t=t_clamped, p=o + d * t_clamped[:, None],
                weight=weight, surface_weight=surface_weight)
