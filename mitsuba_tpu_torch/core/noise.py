"""Procedural noise: Perlin gradient noise, fbm and turbulence (port of
mitsuba_tpu/core/noise.py; reference src/librender/noise.cpp).

The lattice hash is the reference's arithmetic one (an integer mix in
place of the shuffled permutation table of noise.cpp), in uint32
arithmetic: here int64 tensors masked to their low 32 bits after each
step, each product split in 16-bit halves so that no int64 product
overflows. So the hash and the gradient a corner picks are the
reference's bit for bit.
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF


def mul32(x, c):
    """(x * c) mod 2^32 of x and c in [0, 2^32) (c a constant or a
    tensor), on int64 without overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def u32(x):
    """An integer tensor's value as uint32 (wrapping negatives), int64."""
    return x.to(torch.int64) & MASK32


def _hash3(ix, iy, iz):
    """The lattice corner's uint32 hash (noise.py:17), as int64."""
    h = (mul32(u32(ix), 0x9E3779B1) ^ mul32(u32(iy), 0x85EBCA77)
         ^ mul32(u32(iz), 0xC2B2AE3D))
    h = h ^ (h >> 15)
    h = mul32(h, 0x2C1B3C6D)
    h = h ^ (h >> 12)
    h = mul32(h, 0x297A2D39)
    return h ^ (h >> 15)


def _grad(ix, iy, iz, dx, dy, dz):
    """The gradient's dot product at a lattice corner (the 16 directions
    of Perlin's improved noise, noise.cpp Grad)."""
    h = _hash3(ix, iy, iz) & 15
    u = torch.where(h < 8, dx, dy)
    v = torch.where(h < 4, dy, torch.where((h == 12) | (h == 14), dx, dz))
    return (torch.where((h & 1) == 0, u, -u)
            + torch.where((h & 2) == 0, v, -v))


def _fade(t):
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def _lerp(t, a, b):
    return a + t * (b - a)


def perlin_noise(p):
    """Improved Perlin noise of points p (..., 3) -> (...,), in about
    [-1, 1]."""
    p = torch.as_tensor(p, dtype=torch.float32)
    pi = torch.floor(p)
    pf = p - pi
    ix, iy, iz = (pi[..., k].to(torch.int32) for k in range(3))
    dx, dy, dz = pf[..., 0], pf[..., 1], pf[..., 2]
    u, v, w = _fade(dx), _fade(dy), _fade(dz)
    g = _grad
    x00 = _lerp(u, g(ix, iy, iz, dx, dy, dz),
                g(ix + 1, iy, iz, dx - 1, dy, dz))
    x10 = _lerp(u, g(ix, iy + 1, iz, dx, dy - 1, dz),
                g(ix + 1, iy + 1, iz, dx - 1, dy - 1, dz))
    x01 = _lerp(u, g(ix, iy, iz + 1, dx, dy, dz - 1),
                g(ix + 1, iy, iz + 1, dx - 1, dy, dz - 1))
    x11 = _lerp(u, g(ix, iy + 1, iz + 1, dx, dy - 1, dz - 1),
                g(ix + 1, iy + 1, iz + 1, dx - 1, dy - 1, dz - 1))
    return _lerp(w, _lerp(v, x00, x10), _lerp(v, x01, x11))


def _octaves(p, omega, max_octaves, fn):
    p = torch.as_tensor(p, dtype=torch.float32)
    total = torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device)
    lam, o = 1.0, 1.0
    for _ in range(max_octaves):
        total = total + o * fn(perlin_noise(p * lam))
        lam *= 1.99     # slightly off 2, against lattice alignment
        o *= omega
    return total


def fbm(p, omega: float = 0.5, max_octaves: int = 8):
    """Fractional Brownian motion: octaves of Perlin noise summed
    (noise.cpp fbm)."""
    return _octaves(p, omega, max_octaves, lambda x: x)


def turbulence(p, omega: float = 0.5, max_octaves: int = 8):
    """fbm of |noise| (noise.cpp turbulence)."""
    return _octaves(p, omega, max_octaves, torch.abs)
