"""Phase functions: isotropic, Henyey–Greenstein, Kajiya–Kay, microflake
and the Gaussian-fiber microflake (port of mitsuba_tpu/media/phase.py;
reference src/phase/isotropic.cpp, hg.cpp, kajiyakay.cpp, microflake.cpp).

Conventions as in the reference: `wi_dir` is the propagation direction of
the incoming ray, so forward scattering means dot(wi_dir, wo) ≈ +1; pdfs
are with respect to solid angle and equal the value (phase functions are
normalised densities). `MICROFLAKE_GAUSS` carries its fiber stddev in `g`
and needs the fitted σ_t expansion (`fit_fiber_sigma_t`, host numpy); its
sampling draws 64 proposals a lane from a per-lane `jax.random` stream
keyed by the bits of the lane's two uniforms (phase.py:193-197), which
the port reproduces bit for bit (`render/sampler.py`).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from mitsuba_tpu_torch.core import math as m
from mitsuba_tpu_torch.core import warp
from mitsuba_tpu_torch.render import sampler as rs

ISOTROPIC, HG, KAJIYA_KAY, MICROFLAKE = 0, 1, 2, 3
MICROFLAKE_GAUSS = 4        # specular flakes, Gaussian fiber distribution

# proposals a lane of the Gaussian flake's rejection sampler draws, and
# those every lane tests before the lanes that rejected them all go on
FLAKE_PROPOSALS = 64
FLAKE_FIRST = 8
# lanes a chunk of that sampler holds at once: the (lanes, 8, 3) draws'
# threefry words take 192 bytes a lane each (the lanes' keys are their
# own, so chunking changes no bit)
FLAKE_CHUNK = 1 << 20


def _axis(fiber_axis, like):
    """The fiber axis, +z where none is given."""
    if fiber_axis is not None:
        return fiber_axis
    return torch.tensor([0.0, 0.0, 1.0], dtype=like.dtype,
                        device=like.device).expand(like.shape)


# ---------------------------------------------------------------------------
# Gaussian fiber distribution (reference src/phase/microflake_fiber.h:201):
# D(ω) = exp(-cos²θ/(2σ²)) / ((2π)^{3/2} σ erf(1/(√2 σ))), flake normals
# concentrated around the plane ⊥ to the fiber axis.
# ---------------------------------------------------------------------------

def _gauss_fiber_norm(stddev):
    return 1.0 / ((2.0 * math.pi) ** 1.5 * stddev
                  * torch.erf(1.0 / (math.sqrt(2.0) * stddev)))


def gauss_fiber_pdf_cos(cos_t, stddev):
    """Flake-normal density as a function of cosθ to the fiber axis."""
    return torch.exp(-cos_t * cos_t / (2.0 * stddev * stddev)) \
        * _gauss_fiber_norm(stddev)


def gauss_fiber_sample_cos(xi, stddev):
    """Closed-form inverse-CDF sample of cosθ (erfinv in place of the
    reference's Brent solve, microflake_fiber.h:262)."""
    c1 = torch.erf(1.0 / (math.sqrt(2.0) * stddev))
    return math.sqrt(2.0) * stddev * torch.erfinv((1.0 - 2.0 * xi) * c1)


def fit_fiber_sigma_t(stddev: float, n_coeffs: int = 10,
                      n_theta: int = 181, n_quad: int = 256):
    """σ_t(θ_i) = ∫ D(ω) |ω·w_i| dω expanded in powers of sin θ_i (the
    reference's `mtsutil uflakefit`, src/utils/uflakefit.cpp). Host numpy:
    the azimuthal integral in closed form,
      ∫₀^{2π} |a + b cosφ| dφ = 2π|a|                      (|a| ≥ |b|)
                              = 4(√(b²-a²) + a·asin(a/|b|)) (|a| < |b|)
    with a = cosθ_h cosθ_i, b = sinθ_h sinθ_i, then one Gauss-Legendre
    quadrature over cosθ_h. Returns (coeffs (n_coeffs,) float32,
    max_abs_err)."""
    xg, wg = np.polynomial.legendre.leggauss(n_quad)
    # the density lives in |cosθ_h| < ~8σ: put the nodes there
    L = min(1.0, 10.0 * stddev)
    xg = xg * L
    wg = wg * L
    norm = 1.0 / ((2.0 * np.pi) ** 1.5 * stddev
                  * math.erf(1.0 / (np.sqrt(2.0) * stddev)))
    d_cos = np.exp(-xg ** 2 / (2.0 * stddev ** 2)) * norm
    sin_h = np.sqrt(np.maximum(1.0 - xg ** 2, 0.0))
    theta_i = np.linspace(0.0, np.pi / 2, n_theta)
    sig = np.empty(n_theta)
    for k, ti in enumerate(theta_i):
        a = xg * np.cos(ti)
        b = sin_h * np.sin(ti)
        aa, ab = np.abs(a), np.abs(b)
        inner = np.where(
            aa >= ab, 2.0 * np.pi * aa,
            4.0 * (np.sqrt(np.maximum(ab * ab - a * a, 0.0))
                   + a * np.arcsin(np.clip(a / np.maximum(ab, 1e-300),
                                           -1, 1))))
        sig[k] = np.sum(wg * d_cos * inner)
    s = np.sin(theta_i)
    basis = np.stack([s ** i for i in range(n_coeffs)], axis=1)
    coeffs, *_ = np.linalg.lstsq(basis, sig, rcond=None)
    err = float(np.abs(basis @ coeffs - sig).max())
    return coeffs.astype(np.float32), err


def gauss_fiber_sigma_t(cos_t, coeffs):
    """σ_t(cosθ) from the fitted sin-power expansion, by Horner
    (microflake_fiber.h:229 sigmaT)."""
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    acc = torch.zeros_like(sin_t)
    for c in coeffs.flip(0):
        acc = acc * sin_t + c
    return acc


def _hg(cos_t, g):
    """cos_t = dot(propagation_dir, wo): forward peak at +1 for g > 0."""
    denom = 1.0 + g * g - 2.0 * g * cos_t
    return m.INV_FOURPI * (1.0 - g * g) / torch.pow(
        torch.clamp(denom, min=1e-8), 1.5)


def phase_eval(kind: int, g, wi_dir, wo, fiber_axis=None,
               flake_coeffs=None):
    """Phase value (= pdf, normalised) for propagation dir wi_dir -> wo.
    For MICROFLAKE_GAUSS, g is the fiber stddev and flake_coeffs the
    fitted σ_t expansion."""
    if kind == ISOTROPIC:
        return torch.full(wi_dir.shape[:-1], m.INV_FOURPI,
                          dtype=wi_dir.dtype, device=wi_dir.device)
    if kind == MICROFLAKE_GAUSS:
        # reference microflake.cpp:74 f(): 0.5 D(h) / σ_t(cosθ_i), h the
        # half-vector of the source-pointing wi (= -wi_dir) and wo
        if flake_coeffs is None:
            raise ValueError("MICROFLAKE_GAUSS needs flake_coeffs "
                             "(fit_fiber_sigma_t)")
        g = torch.as_tensor(g, dtype=wi_dir.dtype, device=wi_dir.device)
        axis = _axis(fiber_axis, wi_dir)
        h = wo - wi_dir
        hl = torch.sqrt(torch.clamp(torch.sum(h * h, dim=-1), min=1e-20))
        cos_h = torch.sum(h * axis, dim=-1) / hl
        cos_i = -torch.sum(wi_dir * axis, dim=-1)
        sig = gauss_fiber_sigma_t(cos_i, flake_coeffs)
        return 0.5 * gauss_fiber_pdf_cos(cos_h, g) \
            / torch.clamp(sig, min=1e-6)
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
    raise ValueError(kind)


def phase_pdf(kind: int, g, wi_dir, wo, fiber_axis=None,
              flake_coeffs=None):
    return phase_eval(kind, g, wi_dir, wo, fiber_axis, flake_coeffs)


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


def _flake_keys(u2):
    """Each lane's proposal key: fold_in(fold_in(key(0x51AB), bits(u0)),
    bits(u1)) (phase.py:193-196)."""
    bits = u2.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    b1, b2 = rs.key(0x51AB)
    k1, k2 = rs.fold_in(torch.full_like(bits[..., 0], b1),
                        torch.full_like(bits[..., 0], b2), bits[..., 0])
    return rs.fold_in(k1, k2, bits[..., 1])


def flake_proposals(u2, j0: int = 0, j1: int = FLAKE_PROPOSALS, keys=None):
    """The uniforms of each lane's flake proposals j0 <= j < j1, (N, j1 -
    j0, 3): those of uniform(key, (64, 3)) (phase.py:197), whose
    counters are the flat indices 3 j + c."""
    k1, k2 = keys if keys is not None else _flake_keys(u2)
    return rs.uniform(k1, k2, (j1 - j0, 3), start=3 * j0)


def _first_accept(g, u, fr, wi_ref):
    """The first accepted of proposals u (N, K, 3) about the frame fr:
    (any accepted, its wi·h, its h)."""
    cos_h = gauss_fiber_sample_cos(u[..., 0], g)                # (N, K)
    sin_h = torch.sqrt(torch.clamp(1.0 - cos_h * cos_h, min=0.0))
    phi = 2.0 * math.pi * u[..., 1]
    hx = sin_h * torch.cos(phi)
    hy = sin_h * torch.sin(phi)
    h = (hx[..., None] * fr.s[..., None, :]
         + hy[..., None] * fr.t[..., None, :]
         + cos_h[..., None] * fr.n[..., None, :])               # (N, K, 3)
    dp = torch.sum(wi_ref[..., None, :] * h, dim=-1)            # (N, K)
    accept = u[..., 2] < torch.abs(dp)
    idx = torch.argmax(accept.to(torch.uint8), dim=-1)          # first True
    hsel = torch.take_along_dim(h, idx[..., None, None].expand(
        idx.shape + (1, 3)), dim=-2)[..., 0, :]
    dpsel = torch.take_along_dim(dp, idx[..., None], dim=-1)[..., 0]
    return accept.any(dim=-1), dpsel, hsel


def _flake_sample(g, wi_dir, u2, axis):
    """reference microflake.cpp:97 sample(): flake normals h ~ D, each
    accepted with probability |wi·h|, mirror-reflected; the per-ray loop
    becomes 64 proposals a lane, the first accepted winning. Every lane
    tests its first FLAKE_FIRST proposals; the few lanes that reject them
    all (one host sync to find them) test the rest: the first accepted
    one is the same as when every lane tests all 64. Returns (wo, valid)."""
    keys = _flake_keys(u2)
    fr = m.Frame.from_normal(axis)
    wi_ref = -wi_dir
    valid, dpsel, hsel = _first_accept(
        g, flake_proposals(u2, 0, FLAKE_FIRST, keys), fr, wi_ref)
    rest = torch.nonzero(~valid).squeeze(-1)
    if rest.numel():
        v2, dp2, h2 = _first_accept(
            g, flake_proposals(None, FLAKE_FIRST, FLAKE_PROPOSALS,
                               (keys[0][rest], keys[1][rest])),
            m.Frame(fr.s[rest], fr.t[rest], fr.n[rest]), wi_ref[rest])
        valid = valid.index_put((rest,), v2)
        dpsel = dpsel.index_put((rest,), dp2)
        hsel = hsel.index_put((rest,), h2)
    wo = 2.0 * dpsel[..., None] * hsel - wi_ref
    return torch.where(valid[..., None], wo, wi_dir), valid


def phase_sample(kind: int, g, wi_dir, u2, fiber_axis=None,
                 flake_coeffs=None):
    """Sample wo ~ phase(wi_dir, ·). Returns (wo, pdf); the weight is 1
    (exact sampling). MICROFLAKE_GAUSS lanes whose 64 proposals are all
    rejected return pdf 0, the reference's failure mode after its 1000
    iterations (microflake.cpp:130)."""
    if kind == ISOTROPIC:
        return (warp.square_to_uniform_sphere(u2),
                phase_eval(ISOTROPIC, g, wi_dir, wi_dir))
    if kind == MICROFLAKE_GAUSS:
        g = torch.as_tensor(g, dtype=wi_dir.dtype, device=wi_dir.device)
        axis = _axis(fiber_axis, wi_dir)
        n = wi_dir.shape[0]
        parts = [_flake_sample(g, wi_dir[i:i + FLAKE_CHUNK],
                               u2[i:i + FLAKE_CHUNK],
                               axis[i:i + FLAKE_CHUNK])
                 for i in range(0, n, FLAKE_CHUNK)]
        wo = torch.cat([p[0] for p in parts]) if len(parts) > 1 \
            else parts[0][0]
        valid = torch.cat([p[1] for p in parts]) if len(parts) > 1 \
            else parts[0][1]
        pdf = phase_eval(kind, g, wi_dir, wo, fiber_axis, flake_coeffs)
        return wo, torch.where(valid, pdf, 0.0)
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
        raise ValueError(kind)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = 2.0 * math.pi * u2[..., 1]
    wo = frame.to_world(torch.stack(
        [sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t], dim=-1))
    return wo, phase_eval(kind, g, wi_dir, wo, fiber_axis)
