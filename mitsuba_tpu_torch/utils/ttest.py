"""Statistical comparison of renders — the reference's test machinery (the
port's copy of mitsuba_tpu/utils/ttest.py; host numpy).

Capability parity with:
  * `TestSupervisor::analyze` (src/librender/testcase.cpp:168): per-pixel
    Student's t-test of a render (mean/variance/n per pixel) against a
    reference, or relative-error thresholding (scene.h:55-60
    ETTest/ERelativeError).
  * the `ttest` utility (src/utils/ttest.cpp:88-118): Welch's t-test
    between two independent renders — used to check that two *different
    estimators* agree (e.g. path vs volpath with sigma=0).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _t_sf(t_abs, dof):
    """Two-sided survival p-value for |t| with the given dof (vectorized).
    Uses the incomplete-beta identity; no scipy dependency."""
    t_abs = np.asarray(t_abs, np.float64)
    dof = np.maximum(np.asarray(dof, np.float64), 1e-6)
    x = dof / (dof + t_abs * t_abs)
    return _betainc(dof / 2.0, 0.5, x)


def _betainc(a, b, x):
    """Regularized incomplete beta I_x(a,b) via continued fraction
    (Numerical-Recipes-style; vectorized)."""
    a = np.broadcast_to(np.asarray(a, np.float64), np.shape(x)).copy()
    b = np.broadcast_to(np.asarray(b, np.float64), np.shape(x)).copy()
    x = np.asarray(x, np.float64)
    x = np.clip(x, 0.0, 1.0)

    swap = x > (a + 1.0) / (a + b + 2.0)
    aa = np.where(swap, b, a)
    bb = np.where(swap, a, b)
    xx = np.where(swap, 1.0 - x, x)

    # ln prefactor
    from math import lgamma

    lg = np.vectorize(lgamma)
    ln_beta = lg(aa + bb) - lg(aa) - lg(bb)
    with np.errstate(divide="ignore", invalid="ignore"):
        front = np.exp(
            ln_beta + aa * np.log(np.maximum(xx, 1e-300))
            + bb * np.log(np.maximum(1.0 - xx, 1e-300))
        ) / aa

    # Lentz continued fraction
    tiny = 1e-30
    f = np.ones_like(xx)
    c = np.ones_like(xx)
    d = 1.0 - (aa + bb) * xx / (aa + 1.0)
    d = np.where(np.abs(d) < tiny, tiny, d)
    d = 1.0 / d
    f = d.copy()
    for i in range(1, 200):
        m = i // 2
        if i % 2 == 0:
            num = m * (bb - m) * xx / ((aa + 2 * m - 1) * (aa + 2 * m))
        else:
            num = -(aa + m) * (aa + bb + m) * xx / ((aa + 2 * m) * (aa + 2 * m + 1))
        d = 1.0 + num * d
        d = np.where(np.abs(d) < tiny, tiny, d)
        d = 1.0 / d
        c = 1.0 + num / c
        c = np.where(np.abs(c) < tiny, tiny, c)
        f = f * c * d
    result = front * (f - 1.0)
    result = np.clip(result, 0.0, 1.0)
    return np.where(swap, 1.0 - result, result)


@dataclass
class TTestResult:
    passed: bool
    failed_pixels: int
    total_pixels: int
    min_p_value: float
    mean_abs_t: float


def welch_ttest_images(mean1, var1, n1, mean2, var2, n2,
                       significance: float = 0.01,
                       max_fail_frac: float = 0.01) -> TTestResult:
    """Welch's t-test per pixel between two renders with per-pixel sample
    variance (reference ttest.cpp:88 Welch-Satterthwaite)."""
    mean1, var1 = np.asarray(mean1, np.float64), np.asarray(var1, np.float64)
    mean2, var2 = np.asarray(mean2, np.float64), np.asarray(var2, np.float64)
    s1 = var1 / n1
    s2 = var2 / n2
    denom = np.sqrt(np.maximum(s1 + s2, 1e-30))
    t = (mean1 - mean2) / denom
    dof = (s1 + s2) ** 2 / np.maximum(
        s1 ** 2 / max(n1 - 1, 1) + s2 ** 2 / max(n2 - 1, 1), 1e-30
    )
    # pixels where both estimates are exactly equal (e.g. both 0) pass
    p = np.where(np.abs(t) < 1e-12, 1.0, _t_sf(np.abs(t), dof))
    failed = p < significance
    total = p.size
    nfail = int(failed.sum())
    return TTestResult(
        passed=nfail <= max_fail_frac * total,
        failed_pixels=nfail,
        total_pixels=total,
        min_p_value=float(p.min()),
        mean_abs_t=float(np.abs(t).mean()),
    )


def relative_error_test(img, ref, threshold: float = 0.05,
                        pixel_fail_frac: float = 0.01,
                        min_ref: float = 1e-3) -> bool:
    """Relative-error gate (reference scene.h ERelativeError mode)."""
    img = np.asarray(img, np.float64)
    ref = np.asarray(ref, np.float64)
    rel = np.abs(img - ref) / np.maximum(np.abs(ref), min_ref)
    return float((rel > threshold).mean()) <= pixel_fail_frac
