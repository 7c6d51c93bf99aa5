"""MIP pyramid with trilinear and anisotropic (EWA-style) filtering (port
of mitsuba_tpu/render/mipmap.py; reference include/mitsuba/render/mipmap.h).

The pyramid is built on the host in numpy, exactly as the reference
builds it: an image whose sides are not powers of two is first resampled
bilinearly to the next ones, then each level box-averages 2 x 2 texels of
the one above, down to 1 x 1. So its levels are the reference's bit for
bit. A lookup evaluates every level for all lanes and selects, as the
reference does. The anisotropic filter takes `taps` trilinear samples
along the footprint's major axis at the lod of its minor axis, as the
reference approximates the elliptical EWA footprint.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class MIPMap:
    levels: tuple               # (H_l, W_l, C) tensors, level 0 the finest
    n_levels: int = 1

    @property
    def shape(self):
        return self.levels[0].shape

    def to(self, device) -> "MIPMap":
        return MIPMap(tuple(lv.to(device) for lv in self.levels),
                      self.n_levels)


def build_mipmap(image) -> MIPMap:
    """Box-filtered power-of-two pyramid (mipmap.py:39, reference
    mipmap.cpp's constructor)."""
    img = np.asarray(image, np.float32)
    if img.ndim == 2:
        img = img[:, :, None]
    h = 1 << max(int(np.ceil(np.log2(img.shape[0]))), 0)
    w = 1 << max(int(np.ceil(np.log2(img.shape[1]))), 0)
    if (h, w) != img.shape[:2]:
        ys = (np.arange(h) + 0.5) * img.shape[0] / h - 0.5
        xs = (np.arange(w) + 0.5) * img.shape[1] / w - 0.5
        y0 = np.clip(np.floor(ys).astype(int), 0, img.shape[0] - 1)
        x0 = np.clip(np.floor(xs).astype(int), 0, img.shape[1] - 1)
        y1 = np.clip(y0 + 1, 0, img.shape[0] - 1)
        x1 = np.clip(x0 + 1, 0, img.shape[1] - 1)
        fy = (ys - y0)[:, None, None]
        fx = (xs - x0)[None, :, None]
        img = ((img[y0][:, x0] * (1 - fx) + img[y0][:, x1] * fx) * (1 - fy)
               + (img[y1][:, x0] * (1 - fx) + img[y1][:, x1] * fx) * fy)
    levels = [img]
    while levels[-1].shape[0] > 1 or levels[-1].shape[1] > 1:
        cur = levels[-1]
        nh, nw = max(cur.shape[0] // 2, 1), max(cur.shape[1] // 2, 1)
        if cur.shape[0] > 1 and cur.shape[1] > 1:
            ds = cur.reshape(nh, 2, nw, 2, -1).mean(axis=(1, 3))
        elif cur.shape[0] > 1:
            ds = cur.reshape(nh, 2, 1, -1).mean(axis=1)
        else:
            ds = cur.reshape(1, nw, 2, -1).mean(axis=2)
        levels.append(ds.reshape(nh, nw, cur.shape[2]))
    return MIPMap(levels=tuple(torch.as_tensor(np.asarray(lv, np.float32))
                               for lv in levels),
                  n_levels=len(levels))


def bilinear(img, uv, clamp_wrap: bool):
    """Bilinear fetch of an (H, W, C) image at uv (N, 2): v flipped (image
    row 0 is v = 1), texel centres at half integers, texel indices wrapped
    (repeat) or clamped in int32 (texture.py:50, mipmap.py:75); a lane
    whose coordinates are not finite reads a clamped texel, as XLA's
    gather clamps."""
    h, w = img.shape[0], img.shape[1]
    x = uv[..., 0] * w - 0.5
    y = (1.0 - uv[..., 1]) * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]

    def wrap(i, n):
        if clamp_wrap:
            i = torch.clamp(i, 0, n - 1).to(torch.int32)
        else:
            i = torch.remainder(i, n).to(torch.int32)
        # a NaN coordinate (a lane whose footprint is infinite) reads what
        # XLA's gather reads: negative indices wrap once, then clamp
        return torch.clamp(torch.where(i < 0, i + n, i), 0, n - 1).long()

    x0i, x1i = wrap(x0, w), wrap(x0 + 1, w)
    y0i, y1i = wrap(y0, h), wrap(y0 + 1, h)
    return (img[y0i, x0i] * (1 - fx) * (1 - fy)
            + img[y0i, x1i] * fx * (1 - fy)
            + img[y1i, x0i] * (1 - fx) * fy
            + img[y1i, x1i] * fx * fy)


def eval_trilinear(mip: MIPMap, uv, lod, clamp_wrap: bool = False):
    """Bilinear on floor(lod) and the level below it, lerped; lod (N,) the
    continuous level (0 the finest)."""
    l_max = mip.n_levels - 1
    lod = torch.clamp(lod, 0.0, float(l_max))
    l0 = torch.floor(lod)
    l1 = torch.clamp(l0 + 1, max=l_max)
    frac = (lod - l0)[..., None]
    c = mip.levels[0].shape[-1]
    out0 = torch.zeros(uv.shape[:-1] + (c,), device=uv.device)
    out1 = torch.zeros(uv.shape[:-1] + (c,), device=uv.device)
    for li, img in enumerate(mip.levels):
        v = bilinear(img, uv, clamp_wrap)
        out0 = torch.where((l0 == li)[..., None], v, out0)
        out1 = torch.where((l1 == li)[..., None], v, out1)
        del v
    return out0 * (1 - frac) + out1 * frac


def _len2(v, scale_x, scale_y):
    return torch.sqrt((v[..., 0] * scale_x) ** 2 + (v[..., 1] * scale_y) ** 2)


def lod_from_duv(mip: MIPMap, duv_dx, duv_dy):
    """Isotropic lod: log2 of the larger footprint axis in texels."""
    h, w = mip.levels[0].shape[:2]
    sx = _len2(duv_dx, w, h)
    sy = _len2(duv_dy, w, h)
    return torch.log2(torch.clamp(torch.maximum(sx, sy), min=1e-8))


def eval_aniso(mip: MIPMap, uv, duv_dx, duv_dy, taps: int = 8,
               max_aniso: float = 16.0, clamp_wrap: bool = False):
    """`taps` trilinear samples along the major footprint axis, at the
    lod of the minor axis widened to at most `max_aniso` eccentricity
    (mipmap.py:123). The taps are summed one at a time, so no more than
    one tap's (N, C) levels are alive at once."""
    h, w = mip.levels[0].shape[:2]
    scale = torch.tensor([w, h], dtype=torch.float32, device=uv.device)
    vx = duv_dx * scale
    vy = duv_dy * scale
    lx = torch.sqrt(torch.sum(vx * vx, dim=-1))
    ly = torch.sqrt(torch.sum(vy * vy, dim=-1))
    major_is_x = lx >= ly
    major = torch.where(major_is_x[..., None], duv_dx, duv_dy)
    l_major = torch.clamp(torch.where(major_is_x, lx, ly), min=1e-8)
    l_minor = torch.clamp(torch.where(major_is_x, ly, lx), min=1e-8)
    l_minor = torch.maximum(l_minor, l_major / max_aniso)
    lod = torch.log2(l_minor)
    acc = torch.zeros(uv.shape[:-1] + (mip.levels[0].shape[-1],),
                      device=uv.device)
    for i in range(taps):
        t = (i + 0.5) / taps - 0.5          # [-0.5, 0.5) along the major
        acc = acc + eval_trilinear(mip, uv + major * t, lod, clamp_wrap)
    return acc / taps
