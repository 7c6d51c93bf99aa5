"""Film development (port of mitsuba_tpu/render/film.py).

The reference splats each sample into an ImageBlock with its filter
(include/mitsuba/render/imageblock.h:80 putSample); as in the JAX package
the film instead gathers: each pixel collects the samples of its
(2R+1)^2 neighbourhood, shifted in by `torch.roll`, weighted by the filter
at their offsets, and divides by the sum of the weights, as putImageBlock's
weight channel does. Neighbours beyond the image border are masked.
"""
from __future__ import annotations

import math

import torch

from mitsuba_tpu_torch.render.rfilter import RFilter


def develop(L, offsets, spp: int, height: int, width: int,
            rfilter: RFilter | None = None):
    """Reconstruct an (H, W, C) image from per-lane radiance.

    L: (N, C) with N = H*W*spp, lane-major (pixel*spp + sample);
    offsets: (N, 2) sub-pixel sample positions in [0, 1)^2 (x, y). The
    box filter (or none) gives each pixel the mean of its own samples.
    """
    c = L.shape[-1]
    lv = L.reshape(height, width, spp, c)
    if rfilter is None or rfilter.name == "box":
        return lv.mean(dim=2)
    r = int(math.ceil(rfilter.radius - 0.5))
    off = offsets.reshape(height, width, spp, 2)
    dev = L.device
    iy = torch.arange(height, device=dev)[:, None, None]
    ix = torch.arange(width, device=dev)[None, :, None]
    acc = torch.zeros((height, width, c), device=dev)
    wacc = torch.zeros((height, width, 1), device=dev)
    # pixel (i, j) collects the samples of pixel (i+dy, j+dx): a sample
    # at (j+dx + ox, i+dy + oy) lies (dx + ox - 0.5, dy + oy - 0.5) from
    # the centre of pixel (i, j)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            ls = torch.roll(lv, shifts=(-dy, -dx), dims=(0, 1))
            os_ = torch.roll(off, shifts=(-dy, -dx), dims=(0, 1))
            w = rfilter(dx + os_[..., 0] - 0.5) \
                * rfilter(dy + os_[..., 1] - 0.5)
            inside = (iy + dy >= 0) & (iy + dy < height) & (ix + dx >= 0) \
                & (ix + dx < width)
            w = torch.where(inside, w, 0.0)
            acc = acc + (ls * w[..., None]).sum(dim=2)
            wacc = wacc + w.sum(dim=2)[..., None]
    return acc / torch.clamp(wacc, min=1e-8)


def develop_with_variance(L, spp: int, height: int, width: int):
    """The box-filtered image, each pixel's sample variance and its count
    (the MFilm's channels, src/films/mfilm.cpp), as the statistical tests
    read them."""
    lv = L.reshape(height, width, spp, L.shape[-1])
    mean = lv.mean(dim=2)
    var = lv.var(dim=2, unbiased=True) if spp > 1 \
        else torch.zeros_like(mean)
    n = torch.full((height, width), spp, dtype=torch.int32, device=L.device)
    return mean, var, n
