"""Environment emitters: lat-long maps and the Preetham sky (port of
mitsuba_tpu/emitters/envmap.py:27-306; reference src/luminaires/envmap.cpp
and sky.cpp).

A lat-long image is importance-sampled through a Walker/Vose alias table
over its texels, weighted by luminance x sin(theta); a sampled direction
is the texel's centre, so its radiance is the texel value. Directions use
the reference's convention: v = 0 at the +z pole, u wraps phi in
[0, 2 pi). The sky is baked on the host into such an image
(emitters/table.py `EmitterBuilder.sky`). Every function here works for
any number of colour channels.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from mitsuba_tpu_torch.core import math as m
from mitsuba_tpu_torch.core import transform as tf

# CIE XYZ -> linear sRGB (reference spectrum.cpp)
_XYZ_TO_RGB = ((3.240479, -1.537150, -0.498535),
               (-0.969256, 1.875991, 0.041556),
               (0.055648, -0.204043, 1.057311))


def latlong_dir_to_uv(d):
    """Unit direction -> lat-long uv."""
    theta, phi = m.to_spherical(d)
    return torch.stack([phi * m.INV_TWOPI, theta / math.pi], dim=-1)


def latlong_uv_to_dir(uv):
    theta = uv[..., 1] * math.pi
    phi = uv[..., 0] * 2.0 * math.pi
    return m.spherical_direction(theta, phi)


def _vose_alias(w):
    """Walker/Vose alias table for weights w (K,): (prob (K,) f64, alias
    (K,) i64); picking k = floor(u K) and branching to alias[k] when the
    in-bin remainder exceeds prob[k] samples proportionally to w."""
    k = w.size
    p = w / w.sum() * k
    prob = np.ones(k)
    alias = np.arange(k, dtype=np.int64)
    small = [i for i in range(k) if p[i] < 1.0]
    large = [i for i in range(k) if p[i] >= 1.0]
    p = p.copy()
    while small and large:
        s_i = small.pop()
        l_i = large.pop()
        prob[s_i] = p[s_i]
        alias[s_i] = l_i
        p[l_i] = (p[l_i] + p[s_i]) - 1.0
        (small if p[l_i] < 1.0 else large).append(l_i)
    for i in large + small:
        prob[i] = 1.0
    return prob, alias


def build_env_cdfs(image):
    """Sampling tables of an (H, W, C) map, host numpy: (prob (H*W,) f32,
    alias (H*W,) i32, pdf_img (H, W) f32 solid-angle pdf per texel).
    The weight is the luminance of the first three channels, or their
    mean when the map is not RGB."""
    img = np.asarray(image, np.float64)
    h, w = img.shape[:2]
    if img.shape[-1] == 3:
        lum = (0.212671 * img[..., 0] + 0.71516 * img[..., 1]
               + 0.072169 * img[..., 2])
    else:
        lum = img.mean(axis=-1)
    theta = (np.arange(h) + 0.5) / h * np.pi
    weight = np.maximum(lum, 0.0) * np.sin(theta)[:, None]
    total = weight.sum()
    if total <= 0:
        weight = np.ones_like(weight)
        total = weight.sum()
    prob, alias = _vose_alias(weight.reshape(-1))
    pix_sa = (2 * np.pi / w) * (np.pi / h) * np.sin(theta)[:, None]
    pdf_img = (weight / total) / np.maximum(pix_sa, 1e-12)
    return (prob.astype(np.float32), alias.astype(np.int32),
            pdf_img.astype(np.float32))


def env_sample(prob, alias, pdf_img, image, u2, from_env=None):
    """Directions sampled proportionally to luminance x sin(theta) through
    the alias table (envmap.py:119). Returns (d_world (N, 3), pdf (N,),
    radiance (N, C)), or (d_world, pdf) when `image` is None."""
    h, w = pdf_img.shape
    hw = h * w
    x = torch.clamp(u2[..., 0], 0.0, 1.0 - 1e-7) * hw
    k = torch.clamp(x.to(torch.int32), 0, hw - 1)
    frac = x - k.to(torch.float32)
    kl = k.long()
    idx = torch.where(frac < prob[kl], k, alias[kl]).long()
    row = torch.div(idx, w, rounding_mode="floor")
    col = idx % w
    uv = torch.stack([(col.to(torch.float32) + 0.5) / w,
                      (row.to(torch.float32) + 0.5) / h], dim=-1)
    d = latlong_uv_to_dir(uv)
    if from_env is not None:
        d = tf.apply_vector(from_env, d)
    if image is None:
        return d, pdf_img.reshape(-1)[idx]
    return (d, pdf_img.reshape(-1)[idx],
            image.reshape(hw, image.shape[-1])[idx])


def _bilinear_setup(uv, h, w):
    """Corner indices and fractions of a bilinear lat-long lookup: u
    wraps, v clamps at the poles."""
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    xi = x0.to(torch.int32)
    yi = y0.to(torch.int32)
    xi0, xi1 = xi % w, (xi + 1) % w
    yi0 = torch.clamp(yi, 0, h - 1)
    yi1 = torch.clamp(yi + 1, 0, h - 1)
    return ((yi0 * w + xi0).long(), (yi0 * w + xi1).long(),
            (yi1 * w + xi0).long(), (yi1 * w + xi1).long(), fx, fy)


def _blend(c00, c10, c01, c11, fx, fy):
    return (c00 * (1 - fx) * (1 - fy) + c10 * fx * (1 - fy)
            + c01 * (1 - fx) * fy + c11 * fx * fy)


def env_eval(image, d, to_env=None, scale=1.0):
    """Bilinear radiance of world directions d (envmap.py:88)."""
    if to_env is not None:
        d = tf.apply_vector(to_env, d)
    uv = latlong_dir_to_uv(d)
    h, w, c = image.shape
    flat = image.reshape(h * w, c)
    i00, i10, i01, i11, fx, fy = _bilinear_setup(uv, h, w)
    return _blend(flat[i00], flat[i10], flat[i01], flat[i11], fx, fy) \
        * scale


def env_pdf(pdf_img, d, to_env=None):
    """Solid-angle pdf of env_sample at world directions d: the nearest
    texel's (envmap.py:220)."""
    if to_env is not None:
        d = tf.apply_vector(to_env, d)
    uv = latlong_dir_to_uv(d)
    h, w = pdf_img.shape
    col = torch.clamp((uv[..., 0] * w).to(torch.int32), 0, w - 1)
    row = torch.clamp((uv[..., 1] * h).to(torch.int32), 0, h - 1)
    return pdf_img.reshape(-1)[(row * w + col).long()]


def env_eval_pdf(image, pdf_img, d, to_env):
    """Bilinear radiance and nearest-texel sampling pdf for world
    directions d (envmap.py:163): where the pdf image has the map's
    shape, the nearest texel is one of the four bilinear corners,
    selected by the fractions."""
    d = tf.apply_vector(to_env, d)
    uv = latlong_dir_to_uv(d)
    h, w, c = image.shape
    i00, i10, i01, i11, fx, fy = _bilinear_setup(uv, h, w)
    if tuple(pdf_img.shape) != (h, w):
        flat = image.reshape(h * w, c)
        val = _blend(flat[i00], flat[i10], flat[i01], flat[i11], fx, fy)
        hp, wp = pdf_img.shape
        colp = torch.clamp((uv[..., 0] * wp).to(torch.int32), 0, wp - 1)
        rowp = torch.clamp((uv[..., 1] * hp).to(torch.int32), 0, hp - 1)
        return val, pdf_img.reshape(-1)[(rowp * wp + colp).long()]
    flat = torch.cat([image.reshape(h * w, c), pdf_img.reshape(h * w, 1)],
                     dim=1)
    c00, c10, c01, c11 = flat[i00], flat[i10], flat[i01], flat[i11]
    val = _blend(c00[..., :c], c10[..., :c], c01[..., :c], c11[..., :c],
                 fx, fy)
    right = fx[..., 0] >= 0.5
    down = fy[..., 0] >= 0.5
    pdf = torch.where(down, torch.where(right, c11[..., c], c01[..., c]),
                      torch.where(right, c10[..., c], c00[..., c]))
    return val, pdf


def _perez(theta, gamma, a, b, c, d, e):
    cos_t = torch.clamp(torch.cos(theta), min=1e-3)
    cg = torch.cos(gamma)
    return (1.0 + a * torch.exp(b / cos_t)) * (
        1.0 + c * torch.exp(d * gamma) + e * cg * cg)


def preetham_sky(d_world, sun_dir, turbidity: float = 3.0,
                 scale: float = 1.0, extend_below: bool = True):
    """Preetham sky radiance (linear RGB) for world directions d_world
    (N, 3), zenith +y; sun_dir points toward the sun. float32 torch, the
    reference's formulas and operation order."""
    t = turbidity
    f32 = dict(dtype=torch.float32, device=d_world.device)
    sun = m.normalize(torch.as_tensor(sun_dir, **f32))
    up = torch.tensor([0.0, 1.0, 0.0], **f32)
    cos_theta = torch.clamp(m.dot(d_world, up), -1.0, 1.0)
    theta = torch.arccos(torch.clamp(torch.abs(cos_theta), 1e-4, 1.0))
    gamma = torch.arccos(torch.clamp(m.dot(d_world, sun), -1.0, 1.0))
    theta_s = torch.arccos(torch.clamp(m.dot(sun, up), 0.0, 1.0))

    chi = (4.0 / 9.0 - t / 120.0) * (math.pi - 2.0 * theta_s)
    yz = (4.0453 * t - 4.9710) * torch.tan(chi) - 0.2155 * t + 2.4192
    t2 = t * t
    ts = theta_s
    ts2, ts3 = ts * ts, ts * ts * ts
    xz = ((0.00166 * ts3 - 0.00375 * ts2 + 0.00209 * ts) * t2
          + (-0.02903 * ts3 + 0.06377 * ts2 - 0.03202 * ts + 0.00394) * t
          + (0.11693 * ts3 - 0.21196 * ts2 + 0.06052 * ts + 0.25886))
    yz_c = ((0.00275 * ts3 - 0.00610 * ts2 + 0.00317 * ts) * t2
            + (-0.04214 * ts3 + 0.08970 * ts2 - 0.04153 * ts + 0.00516) * t
            + (0.15346 * ts3 - 0.26756 * ts2 + 0.06670 * ts + 0.26688))
    coef_y = (0.1787 * t - 1.4630, -0.3554 * t + 0.4275,
              -0.0227 * t + 5.3251, 0.1206 * t - 2.5771,
              -0.0670 * t + 0.3703)
    coef_x = (-0.0193 * t - 0.2592, -0.0665 * t + 0.0008,
              -0.0004 * t + 0.2125, -0.0641 * t - 0.8989,
              -0.0033 * t + 0.0452)
    coef_yc = (-0.0167 * t - 0.2608, -0.0950 * t + 0.0092,
               -0.0079 * t + 0.2102, -0.0441 * t - 1.6537,
               -0.0109 * t + 0.0529)

    def ratio(coef):
        return _perez(theta, gamma, *coef) / torch.clamp(
            _perez(torch.zeros_like(theta), theta_s, *coef), min=1e-6)

    yy = yz * ratio(coef_y) * 1000.0
    x = xz * ratio(coef_x)
    y = yz_c * ratio(coef_yc)
    big_y = yy / 20000.0 * scale
    big_x = big_y / torch.clamp(y, min=1e-5) * x
    big_z = big_y / torch.clamp(y, min=1e-5) * (1.0 - x - y)
    rgb = torch.stack([r[0] * big_x + r[1] * big_y + r[2] * big_z
                       for r in _XYZ_TO_RGB], dim=-1)
    rgb = torch.clamp(rgb, min=0.0)
    if not extend_below:
        rgb = torch.where((cos_theta > 0)[..., None], rgb, 0.0)
    return rgb
