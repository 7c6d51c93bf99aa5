"""n-channel spectral power distributions (port of
mitsuba_tpu/core/spectral.py; the reference's compile-time
SPECTRUM_SAMPLES, include/mitsuba/core/spectrum.h:27, with bins over
360..830 nm; fromContinuousSpectrum and toXYZ in src/libcore/spectrum.cpp).

The channel count is a value: `SpectralBins(n)` sizes the tables, and the
render path runs at the tables' width (the material and emitter builders
widen their colour fields to the widest row).

Colour conversion uses the Wyman/Sloan/Shirley multi-lobe Gaussian fit of
the CIE 1931 2-degree matching functions (JCGT 2013), analytic, as the
JAX package does. The (3, n) XYZ weights and the (n, 3) RGB basis are
built in float64 numpy exactly as the JAX package builds them, so both
packages' matrices are equal bit for bit; the conversions are float32
`torch.einsum` on the input's device. RGB -> spectrum upsampling solves
the 3x3 system that makes rgb -> bins -> XYZ -> rgb exact by construction.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

LAMBDA_MIN = 360.0      # nm (reference spectrum.h SPECTRUM_MIN_WAVELENGTH)
LAMBDA_MAX = 830.0


def _gauss_piece(lam, mu, s1, s2):
    s = np.where(lam < mu, s1, s2)
    t = (lam - mu) / s
    return np.exp(-0.5 * t * t)


def cie_xyz_bar(lam):
    """CIE 1931 2-degree x̄/ȳ/z̄ at wavelengths lam (nm), the Wyman et al.
    fit, in float64. Returns (..., 3)."""
    lam = np.asarray(lam, np.float64)
    x = (1.056 * _gauss_piece(lam, 599.8, 37.9, 31.0)
         + 0.362 * _gauss_piece(lam, 442.0, 16.0, 26.7)
         - 0.065 * _gauss_piece(lam, 501.1, 20.4, 26.2))
    y = (0.821 * _gauss_piece(lam, 568.8, 46.9, 40.5)
         + 0.286 * _gauss_piece(lam, 530.9, 16.3, 31.1))
    z = (1.217 * _gauss_piece(lam, 437.0, 11.8, 36.0)
         + 0.681 * _gauss_piece(lam, 459.0, 26.0, 13.8))
    return np.stack([x, y, z], axis=-1)


# linear sRGB primaries, the matrices of core/spectrum.py
_XYZ_TO_RGB = np.array(
    [
        [3.240479, -1.537150, -0.498535],
        [-0.969256, 1.875991, 0.041556],
        [0.055648, -0.204043, 1.057311],
    ]
)
_RGB_TO_XYZ = np.array(
    [
        [0.412453, 0.357580, 0.180423],
        [0.212671, 0.715160, 0.072169],
        [0.019334, 0.119193, 0.950227],
    ]
)


@dataclass(frozen=True)
class SpectralBins:
    """Uniform wavelength bins over [lambda_min, lambda_max): the
    reference's Spectrum discretisation with n a value. Gives the
    bin -> XYZ integration matrix and the exact rgb -> bins basis."""
    n: int
    lambda_min: float = LAMBDA_MIN
    lambda_max: float = LAMBDA_MAX

    @property
    def edges(self):
        return np.linspace(self.lambda_min, self.lambda_max, self.n + 1)

    @property
    def centers(self):
        e = self.edges
        return 0.5 * (e[:-1] + e[1:])

    def _xyz_weights(self, oversample: int = 32):
        """(3, n) float64: column j averages x̄/ȳ/z̄ over bin j, normalised
        so that a flat unit spectrum has Y = 1 (spectrum.cpp toXYZ)."""
        lam = np.linspace(self.lambda_min, self.lambda_max,
                          self.n * oversample, endpoint=False)
        lam = lam + 0.5 * (lam[1] - lam[0])
        bar = cie_xyz_bar(lam)                                # (n*os, 3)
        w = bar.reshape(self.n, oversample, 3).mean(axis=1)   # bin means
        y_total = w[:, 1].sum()
        return (w / max(y_total, 1e-12)).T                    # (3, n)

    def _rgb_basis(self):
        """(n, 3) float64 basis B with from_rgb(rgb) = B @ rgb and
        to_rgb(B @ rgb) == rgb: Smits-style smooth red, green and blue
        bands, right-multiplied by the inverse of the 3x3 round trip."""
        c = self.centers

        def band(lo, hi):
            k = 0.08
            return 1.0 / (1.0 + np.exp(-k * (c - lo))) \
                * 1.0 / (1.0 + np.exp(k * (c - hi)))

        b = np.stack([band(575.0, 700.0),            # red
                      band(490.0, 575.0),            # green
                      band(380.0, 490.0)], axis=-1)  # blue  (n, 3)
        m = _XYZ_TO_RGB @ self._xyz_weights() @ b    # rgb -> rgb round trip
        return b @ np.linalg.inv(m)

    def to_xyz_matrix(self, device="cpu"):
        """The (3, n) float32 XYZ weights on `device`."""
        return torch.as_tensor(self._xyz_weights().astype(np.float32),
                               device=device)

    def rgb_basis(self, device="cpu"):
        """The (n, 3) float32 RGB basis on `device`."""
        return torch.as_tensor(self._rgb_basis().astype(np.float32),
                               device=device)


def _as_tensor(x):
    return torch.as_tensor(x, dtype=torch.float32) \
        if not torch.is_tensor(x) else x.to(torch.float32)


def to_xyz(bins, spec: SpectralBins):
    """(..., n) spectral bins -> (..., 3) CIE XYZ, on bins' device."""
    bins = _as_tensor(bins)
    return torch.einsum("cn,...n->...c", spec.to_xyz_matrix(bins.device),
                        bins)


def to_rgb(bins, spec: SpectralBins):
    """(..., n) spectral bins -> (..., 3) linear sRGB."""
    xyz = to_xyz(bins, spec)
    m = torch.as_tensor(_XYZ_TO_RGB.astype(np.float32), device=xyz.device)
    return torch.einsum("ij,...j->...i", m, xyz)


def from_rgb(rgb, spec: SpectralBins):
    """(..., 3) linear RGB -> (..., n) smooth spectrum whose round trip
    through to_rgb is exact (the reference's fromLinearRGB analogue)."""
    rgb = _as_tensor(rgb)
    return torch.einsum("nc,...c->...n", spec.rgb_basis(rgb.device), rgb)


def luminance(bins, spec: SpectralBins):
    """CIE Y of an n-bin spectrum."""
    return to_xyz(bins, spec)[..., 1]


def from_continuous(fn, spec: SpectralBins, oversample: int = 16,
                    device="cuda"):
    """Discretise a continuous SPD fn(lambda_nm) -> power into the n bins
    by the mean over each bin, in float64 on the host (the reference's
    Spectrum::fromContinuousSpectrum); an (n,) float32 tensor on `device`
    (the card by default, as SceneBuilder.build)."""
    from mitsuba_tpu_torch.render.scene import check_device

    check_device(device)
    lam = np.linspace(spec.lambda_min, spec.lambda_max,
                      spec.n * oversample, endpoint=False)
    lam = lam + 0.5 * (lam[1] - lam[0])
    v = np.asarray(fn(lam), np.float64)
    return torch.as_tensor(
        v.reshape(spec.n, oversample).mean(axis=1).astype(np.float32),
        device=device)


def blackbody(temperature_k, spec: SpectralBins, device="cuda"):
    """Planck's spectral radiance in the bins, W/(m^2 sr nm) (the
    reference's spectrum.cpp fromBlackBody), on `device`."""
    h = 6.62607015e-34
    c = 2.99792458e8
    kb = 1.380649e-23

    def planck(lam_nm):
        lam = lam_nm * 1e-9
        return (2.0 * h * c * c) / (lam ** 5) \
            / (np.exp(h * c / (lam * kb * float(temperature_k))) - 1.0) \
            * 1e-9
    return from_continuous(planck, spec, device=device)
