"""4x4 homogeneous transforms (port of mitsuba_tpu/core/transform.py).

Matrices are built on the host in float64 numpy, as in the reference;
the application helpers take a (4, 4) tensor and broadcast over leading
axes, with each row's products summed left to right.
"""
from __future__ import annotations

import numpy as np
import torch


def look_at(origin, target, up):
    """Camera-to-world: +z looks at target, y ~ up (reference
    transform.cpp:174 lookAt: x = cross(dir, up), y = cross(x, dir),
    z = dir, as columns). Returns a (4, 4) float64 numpy array."""
    origin = np.asarray(origin, np.float64)
    d = np.asarray(target, np.float64) - origin
    d = d / np.linalg.norm(d)
    right = np.cross(d, np.asarray(up, np.float64))
    right = right / np.linalg.norm(right)
    new_up = np.cross(right, d)
    m = np.eye(4)
    m[:3, 0] = right
    m[:3, 1] = new_up
    m[:3, 2] = d
    m[:3, 3] = origin
    return m


def _rows(m, v):
    return [m[i, 0] * v[..., 0] + m[i, 1] * v[..., 1] + m[i, 2] * v[..., 2]
            for i in range(3)]


def apply_point(m, p):
    x, y, z = _rows(m, p)
    return torch.stack([x + m[0, 3], y + m[1, 3], z + m[2, 3]], dim=-1)


def apply_vector(m, v):
    return torch.stack(_rows(m, v), dim=-1)
