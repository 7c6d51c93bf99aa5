"""Reconstruction filters (port of mitsuba_tpu/render/rfilter.py;
reference src/rfilters/: box, gaussian, mitchell, catmullrom, wsinc, and
a tent).

Each filter is a separable 1-D profile, f(x) f(y), evaluated on tensors;
the film (render/film.py) gathers it over a (2R+1)^2 pixel neighbourhood.
"""
from __future__ import annotations

import numpy as np
import torch

from mitsuba_tpu_torch.core.registry import register_plugin


class RFilter:
    """A name, a radius and a 1-D profile of |x|."""

    def __init__(self, name, radius, fn):
        self.name = name
        self.radius = float(radius)
        self.fn = fn

    def __call__(self, x):
        ax = torch.abs(x)
        return torch.where(ax <= self.radius, self.fn(ax), 0.0)


def make_box():
    return RFilter("box", 0.5, torch.ones_like)


def make_gaussian(stddev: float = 0.5):
    """A Gaussian cut at radius 4 stddev (2 at the default), shifted
    down by its value there."""
    r = 2.0 * stddev * 2.0
    alpha = 1.0 / (2.0 * stddev * stddev)
    offset = np.exp(-alpha * r * r)
    return RFilter("gaussian", r, lambda x: torch.clamp(
        torch.exp(-alpha * x * x) - offset, min=0.0))


def _mitchell_1d(x, b, c):
    x = torch.abs(x)
    x2, x3 = x * x, x * x * x
    p1 = ((12 - 9 * b - 6 * c) * x3 + (-18 + 12 * b + 6 * c) * x2
          + (6 - 2 * b)) / 6.0
    p2 = ((-b - 6 * c) * x3 + (6 * b + 30 * c) * x2 + (-12 * b - 48 * c) * x
          + (8 * b + 24 * c)) / 6.0
    return torch.where(x < 1, p1, torch.where(x < 2, p2, 0.0))


def make_mitchell(b: float = 1.0 / 3.0, c: float = 1.0 / 3.0):
    return RFilter("mitchell", 2.0, lambda x: _mitchell_1d(x, b, c))


def make_catmullrom():
    return RFilter("catmullrom", 2.0, lambda x: _mitchell_1d(x, 0.0, 0.5))


def make_wsinc(radius: float = 3.0, tau: float = 3.0):
    """A sinc windowed by a wider sinc (a Lanczos filter)."""
    return RFilter("wsinc", radius,
                   lambda x: torch.sinc(x) * torch.sinc(x / tau))


def make_tent():
    return RFilter("tent", 1.0,
                   lambda x: torch.clamp(1.0 - torch.abs(x), min=0.0))


_FACTORIES = {
    "box": make_box,
    "gaussian": make_gaussian,
    "mitchell": make_mitchell,
    "catmullrom": make_catmullrom,
    "wsinc": make_wsinc,
    "tent": make_tent,
}


def make_rfilter(name: str, **kw) -> RFilter:
    if name not in _FACTORIES:
        raise KeyError(
            f"unknown rfilter '{name}'; known: {sorted(_FACTORIES)}")
    return _FACTORIES[name](**kw)


for _n in _FACTORIES:
    register_plugin("rfilter", _n)(lambda props, _n=_n: make_rfilter(_n))
