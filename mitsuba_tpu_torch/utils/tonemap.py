"""Image utilities (port of mitsuba_tpu/utils/tonemap.py): tonemap,
addimages, joinrgb, the reference's src/utils/{tonemap,addimages,
joinrgb}.cpp as library functions, on host numpy arrays (a tensor is
copied to the host first)."""
from __future__ import annotations

import numpy as np


def _host(img):
    if hasattr(img, "detach"):
        img = img.detach().cpu().numpy()
    return np.asarray(img, np.float32)


def _srgb_np(x):
    """The sRGB curve in numpy (core/spectrum.py `to_srgb` is the same on
    the host)."""
    x = np.clip(x, 0.0, 1.0)
    return np.where(x <= 0.0031308, 12.92 * x,
                    1.055 * np.power(np.maximum(x, 1e-12), 1 / 2.4) - 0.055)


def tonemap(img, exposure_ev: float = 0.0, gamma: float = -1.0):
    """HDR -> 8-bit LDR; gamma = -1 is the sRGB curve (reference
    tonemap.cpp)."""
    img = _host(img) * (2.0 ** exposure_ev)
    if gamma == -1.0:
        out = _srgb_np(img)
    else:
        out = np.clip(img, 0, 1) ** (1.0 / gamma)
    return (out * 255 + 0.5).astype(np.uint8)


def add_images(a, b, weight_a: float = 1.0, weight_b: float = 1.0):
    """Weighted sum of two HDR images (reference addimages.cpp)."""
    return _host(a) * weight_a + _host(b) * weight_b


def join_rgb(r, g, b):
    """Three single-channel images merged into RGB (reference
    joinrgb.cpp)."""
    def chan(x):
        x = _host(x)
        return x[..., 0] if x.ndim == 3 else x
    return np.stack([chan(r), chan(g), chan(b)], axis=-1)
