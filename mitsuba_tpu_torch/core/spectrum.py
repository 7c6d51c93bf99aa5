"""Spectra as 3-channel linear RGB (port of mitsuba_tpu/core/spectrum.py):
sRGB encoding on host float32 numpy arrays, as the loader (`<srgb>`
values) and the CLI (LDR images) use it; and, on torch tensors whose last
axis holds the 3 channels, luminance, the RGB <-> XYZ matrices, Planck's
blackbody at three wavelengths (the `<blackbody>` value), `is_black` and
`max_component`.
"""
from __future__ import annotations

import numpy as np
import torch

# ITU-R BT.709 linear RGB <-> CIE XYZ (the reference's fromXYZ / toXYZ,
# src/libcore/spectrum.cpp)
_RGB_TO_XYZ = ((0.412453, 0.357580, 0.180423),
               (0.212671, 0.715160, 0.072169),
               (0.019334, 0.119193, 0.950227))
_XYZ_TO_RGB = ((3.240479, -1.537150, -0.498535),
               (-0.969256, 1.875991, 0.041556),
               (0.055648, -0.204043, 1.057311))
# Planck's law is evaluated at these wavelengths (nm), as the reference's
# 3-sample build represents a spectrum
BLACKBODY_NM = (611.0, 549.0, 465.0)


def to_srgb(s):
    """Linear -> sRGB gamma encoding, clamped to [0, 1]."""
    s = np.clip(np.asarray(s, np.float32), 0.0, 1.0)
    return np.where(
        s <= np.float32(0.0031308), np.float32(12.92) * s,
        np.float32(1.055) * np.power(np.maximum(s, np.float32(1e-12)),
                                     np.float32(1.0 / 2.4))
        - np.float32(0.055)).astype(np.float32)


def from_srgb(s):
    """sRGB -> linear."""
    s = np.asarray(s, np.float32)
    # the power's branch is taken only above 0.04045, where its base is
    # positive: the clamp keeps the other lanes' unused power finite
    base = np.maximum((s + np.float32(0.055)) / np.float32(1.055),
                      np.float32(0.0))
    return np.where(s <= np.float32(0.04045), s / np.float32(12.92),
                    np.power(base, np.float32(2.4))).astype(np.float32)


def luminance(s):
    """CIE Y of a linear-RGB spectrum (spectrum.cpp getLuminance)."""
    return s[..., 0] * 0.212671 + s[..., 1] * 0.715160 + s[..., 2] * 0.072169


def _matrix(rows, like):
    return torch.tensor(rows, dtype=like.dtype, device=like.device)


def to_xyz(s):
    return s @ _matrix(_RGB_TO_XYZ, s).T


def from_xyz(xyz):
    return xyz @ _matrix(_XYZ_TO_RGB, xyz).T


def blackbody(temperature_k, wavelengths_nm=None):
    """Planck's spectral radiance in W / (m^2 sr nm) at BLACKBODY_NM (or
    `wavelengths_nm`), float32 as the reference computes it: at low
    temperatures exp(hc / lambda k T) overflows and a channel reads 0.
    temperature_k: a float or a tensor; the channels are a last axis."""
    t = torch.as_tensor(temperature_k, dtype=torch.float32)
    lam = torch.as_tensor(BLACKBODY_NM if wavelengths_nm is None
                          else wavelengths_nm, dtype=torch.float32,
                          device=t.device) * 1e-9
    h, c, kb = 6.62607015e-34, 2.99792458e8, 1.380649e-23

    def const(x):
        # a scalar numerator divides as a float32 tensor: `x / tensor`
        # would multiply by the reciprocal, another rounding
        return torch.tensor(x, dtype=torch.float32, device=t.device)

    lam2 = lam * lam
    lam5 = lam2 * lam2 * lam      # lam ** 5 as the reference's integer power
    i = const(2.0 * h * c * c) / lam5 \
        / (torch.exp(const(h * c) / (lam * kb * t[..., None])) - 1.0)
    return i * 1e-9


def is_black(s, eps: float = 0.0):
    return torch.all(s <= eps, dim=-1)


def max_component(s):
    return torch.amax(s, dim=-1)
