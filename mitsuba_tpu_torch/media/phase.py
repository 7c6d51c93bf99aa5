"""Phase functions: isotropic, Henyey–Greenstein, Kajiya–Kay, microflake
(port of mitsuba_tpu/media/phase.py; reference src/phase/isotropic.cpp,
hg.cpp, kajiyakay.cpp, microflake.cpp).

Conventions as in the reference: `wi_dir` is the propagation direction of
the incoming ray, so forward scattering means dot(wi_dir, wo) ≈ +1; pdfs
are with respect to solid angle and equal the value (phase functions are
normalised densities). Every kind here is closed-form. The Gaussian
microflake (`MICROFLAKE_GAUSS`) raises: its sampling draws per-lane
`jax.random` proposal streams (phase.py:193-197) and its value needs the
fitted σ_t expansion, neither of which is ported.
"""
from __future__ import annotations

import math

import torch

from mitsuba_tpu_torch.core import math as m
from mitsuba_tpu_torch.core import warp

ISOTROPIC, HG, KAJIYA_KAY, MICROFLAKE = 0, 1, 2, 3
MICROFLAKE_GAUSS = 4        # specular flakes, Gaussian fiber distribution


def _unported(kind):
    if kind == MICROFLAKE_GAUSS:
        raise NotImplementedError(
            "the Gaussian microflake phase function is not ported (its "
            "sampling draws per-lane jax.random streams)")
    raise ValueError(kind)


def _axis(fiber_axis, like):
    """The fiber axis, +z where none is given."""
    if fiber_axis is not None:
        return fiber_axis
    return torch.tensor([0.0, 0.0, 1.0], dtype=like.dtype,
                        device=like.device).expand(like.shape)


def _hg(cos_t, g):
    """cos_t = dot(propagation_dir, wo): forward peak at +1 for g > 0."""
    denom = 1.0 + g * g - 2.0 * g * cos_t
    return m.INV_FOURPI * (1.0 - g * g) / torch.pow(
        torch.clamp(denom, min=1e-8), 1.5)


def phase_eval(kind: int, g, wi_dir, wo, fiber_axis=None):
    """Phase value (= pdf, normalised) for propagation dir wi_dir -> wo."""
    if kind == ISOTROPIC:
        return torch.full(wi_dir.shape[:-1], m.INV_FOURPI,
                          dtype=wi_dir.dtype, device=wi_dir.device)
    if kind == HG:
        return _hg(m.dot(wi_dir, wo), g)
    if kind == KAJIYA_KAY:
        # normalised sin-lobe around the axis-orthogonal plane:
        # ∫ sinθ dω = π² ⇒ pdf = sinθ / π²
        cos_o = m.dot(_axis(fiber_axis, wi_dir), wo)
        sin_o = torch.sqrt(torch.clamp(1.0 - cos_o * cos_o, min=0.0))
        return sin_o / (math.pi * math.pi)
    if kind == MICROFLAKE:
        # sin²-distributed flakes: ∫ sin²θ dω = 8π/3 ⇒ pdf = 3 sin²θ / (8π)
        cos_o = m.dot(_axis(fiber_axis, wi_dir), wo)
        sin2 = torch.clamp(1.0 - cos_o * cos_o, min=0.0)
        return 3.0 * sin2 / (8.0 * math.pi)
    return _unported(kind)


def phase_pdf(kind: int, g, wi_dir, wo, fiber_axis=None):
    return phase_eval(kind, g, wi_dir, wo, fiber_axis)


def _bisect(u0, lo, hi, cdf_fn, increasing):
    """24 bisection steps of cdf(c) = u0 on [lo, hi] (phase.py:244-261)."""
    for _ in range(24):
        mid = 0.5 * (lo + hi)
        below = cdf_fn(mid) < u0
        if increasing:
            lo, hi = torch.where(below, mid, lo), torch.where(below, hi, mid)
        else:
            hi, lo = torch.where(below, mid, hi), torch.where(below, lo, mid)
    return 0.5 * (lo + hi)


def phase_sample(kind: int, g, wi_dir, u2, fiber_axis=None):
    """Sample wo ~ phase(wi_dir, ·). Returns (wo, pdf); the weight is 1
    (exact sampling)."""
    if kind == ISOTROPIC:
        return (warp.square_to_uniform_sphere(u2),
                phase_eval(ISOTROPIC, g, wi_dir, wi_dir))
    if kind == HG:
        g = torch.as_tensor(g, dtype=u2.dtype, device=u2.device)
        small = torch.abs(g) < 1e-4
        g_safe = torch.where(small, 1e-4, g)
        sqr = (1.0 - g * g) / (1.0 - g + 2.0 * g * u2[..., 0])
        cos_t = torch.where(small, 1.0 - 2.0 * u2[..., 0],
                            (1.0 + g * g - sqr * sqr) / (2.0 * g_safe))
        frame = m.Frame.from_normal(wi_dir)
    elif kind in (KAJIYA_KAY, MICROFLAKE):
        # inversion of the sin / sin² marginal around the axis
        u0 = u2[..., 0]
        if kind == KAJIYA_KAY:
            # p(θ) = 2 sin²θ / π, cdf(θ) = (θ - sinθ cosθ) / π; bisection
            # (the endpoint derivatives vanish, Newton is unstable)
            theta = _bisect(
                u0, torch.zeros_like(u0), torch.full_like(u0, math.pi),
                lambda x: (x - torch.sin(x) * torch.cos(x)) / math.pi,
                increasing=True)
            cos_t = torch.cos(theta)
        else:
            # over c = cosθ the cdf (c³/3 - c + 2/3) / (4/3) decreases
            cos_t = _bisect(
                u0, torch.full_like(u0, -1.0), torch.ones_like(u0),
                lambda c: (c ** 3 / 3.0 - c + 2.0 / 3.0) / (4.0 / 3.0),
                increasing=False)
        frame = m.Frame.from_normal(_axis(fiber_axis, wi_dir))
    else:
        return _unported(kind)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = 2.0 * math.pi * u2[..., 1]
    wo = frame.to_world(torch.stack(
        [sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t], dim=-1))
    return wo, phase_eval(kind, g, wi_dir, wo, fiber_axis)
