"""Vector math and shading frames (port of mitsuba_tpu/core/math.py).

Vectors are float tensors with a trailing axis of size 3; everything
broadcasts over leading (wavefront) axes. Dot products are written out
component by component, in the reference's summation order, so that the
CPU and CUDA paths round identically.
"""
from __future__ import annotations

import math

import torch

EPSILON = 1e-4          # ray epsilon, cf. reference Epsilon (mitsuba.h)
INV_PI = 1.0 / math.pi
INV_TWOPI = 1.0 / (2.0 * math.pi)
INV_FOURPI = 1.0 / (4.0 * math.pi)


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def squared_length(v):
    return dot(v, v)


def normalize(v, eps: float = 1e-20):
    return v / torch.sqrt(torch.clamp(dot(v, v), min=eps))[..., None]


def safe_sqrt(x):
    return torch.sqrt(torch.clamp(x, min=0.0))


def safe_rcp(x, eps: float = 1e-20):
    """Reciprocal clamped away from inf; sign-preserving (0 counts as
    +0)."""
    mag = torch.clamp(torch.abs(x), min=eps)
    return torch.where(x >= 0, 1.0, -1.0) / mag


def coordinate_system(n):
    """Orthonormal (s, t) around unit normal n — Duff et al. branchless
    formulation, as in the reference. [s, t, n] is right-handed."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    sign = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    s = torch.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx], dim=-1)
    t = torch.stack([b, sign + ny * ny * a, -ny], dim=-1)
    return s, t


class Frame:
    """A batched shading frame (s, t, n); local +z is n."""

    __slots__ = ("s", "t", "n")

    def __init__(self, s, t, n):
        self.s, self.t, self.n = s, t, n

    @staticmethod
    def from_normal(n):
        s, t = coordinate_system(n)
        return Frame(s, t, n)

    @staticmethod
    def from_normal_tangent(n, tangent):
        """Frame whose s axis follows the tangent projected off n; falls
        back to from_normal where the tangent degenerates."""
        s = tangent - n * dot(n, tangent)[..., None]
        l2 = dot(s, s)[..., None]
        ok = l2 > 1e-18
        s_fb, _ = coordinate_system(n)
        s = torch.where(ok, s / torch.sqrt(torch.where(ok, l2, 1.0)), s_fb)
        t = cross(n, s)
        return Frame(s, t, n)

    def to_local(self, v):
        return torch.stack(
            [dot(v, self.s), dot(v, self.t), dot(v, self.n)], dim=-1)

    def to_world(self, v):
        return (v[..., 0:1] * self.s + v[..., 1:2] * self.t
                + v[..., 2:3] * self.n)


def cos_theta(w):
    return w[..., 2]


def sin_theta(w):
    return torch.sqrt(torch.clamp(1.0 - w[..., 2] * w[..., 2], min=0.0))


def tan_theta(w):
    return sin_theta(w) / torch.where(w[..., 2] == 0, 1e-20, w[..., 2])


def reflect_local(w):
    """Mirror reflection in the local frame: (x, y, z) -> (-x, -y, z)."""
    return torch.stack([-w[..., 0], -w[..., 1], w[..., 2]], dim=-1)


def reflect(w, n):
    """Reflect w about the normal n; both point away from the surface
    (reference util.cpp reflect up to the wi convention)."""
    return 2.0 * dot(w, n)[..., None] * n - w


def refract(wi, n, rel_eta):
    """Refract wi (pointing away from the interface) through the normal n,
    from either side of n; rel_eta = IOR of the transmitted side over IOR
    of the incident side. Returns (wt, total internal reflection mask),
    wt pointing away from the interface on the transmitted side."""
    cos_i = dot(wi, n)
    inv = 1.0 / torch.as_tensor(rel_eta, dtype=wi.dtype, device=wi.device)
    sin2_t = inv * inv * torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    tir = sin2_t >= 1.0
    cos_t = safe_sqrt(1.0 - sin2_t)
    coef = inv * cos_i - torch.sign(cos_i) * cos_t
    wt = -wi * torch.broadcast_to(inv, cos_i.shape)[..., None] \
        + coef[..., None] * n
    return normalize(wt), tir


def spherical_direction(theta, phi):
    """Spherical coordinates -> direction (reference sphericalDirection)."""
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    return torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi),
                        cos_t], dim=-1)


def to_spherical(v):
    """Direction -> (theta, phi) with phi in [0, 2 pi)."""
    theta = torch.arccos(torch.clamp(v[..., 2], -1.0, 1.0))
    phi = torch.atan2(v[..., 1], v[..., 0])
    phi = torch.where(phi < 0, phi + 2.0 * math.pi, phi)
    return theta, phi
