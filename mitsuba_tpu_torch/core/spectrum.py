"""sRGB encoding (port of `to_srgb` and `from_srgb` of
mitsuba_tpu/core/spectrum.py), on host float32 numpy arrays as the loader
(`<srgb>` values) and the CLI (LDR images) use them.
"""
from __future__ import annotations

import numpy as np


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
