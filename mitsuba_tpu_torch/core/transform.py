"""4x4 homogeneous transforms (port of mitsuba_tpu/core/transform.py).

Matrices are built on the host as float32 numpy arrays: the reference
builds each in float64 and rounds it to float32 (jnp's default dtype),
and composes them with float32 products, which numpy's float32 matmul
reproduces. The application helpers take a (4, 4) tensor and broadcast
over leading axes, with each row's products summed left to right.
"""
from __future__ import annotations

import numpy as np
import torch


def _f32(m):
    return np.asarray(m, np.float32)


def identity():
    return np.eye(4, dtype=np.float32)


def translate(v):
    m = np.eye(4)
    m[:3, 3] = np.asarray(v)
    return _f32(m)


def scale(v):
    v = np.broadcast_to(np.asarray(v, np.float64), (3,))
    return _f32(np.diag([v[0], v[1], v[2], 1.0]))


def rotate(axis, angle_deg):
    """Rotation about an arbitrary axis, angle in degrees."""
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    s, c = np.sin(np.deg2rad(angle_deg)), np.cos(np.deg2rad(angle_deg))
    x, y, z = axis
    k = np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]])
    r = np.eye(3) * c + s * k + (1 - c) * np.outer(axis, axis)
    m = np.eye(4)
    m[:3, :3] = r
    return _f32(m)


def matrix(values):
    """A 4x4 matrix from 16 row-major entries."""
    return _f32(np.asarray(values, np.float64).reshape(4, 4))


def look_at(origin, target, up):
    """Camera-to-world: +z looks at target, y ~ up (reference
    transform.cpp:174 lookAt: x = cross(dir, up), y = cross(x, dir),
    z = dir, as columns)."""
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
    return _f32(m)


def compose(*mats):
    """compose(A, B, C) == A @ B @ C (applied right to left)."""
    out = identity()
    for m in mats:
        out = out @ _f32(m)
    return out


def apply_point_np(m, p):
    """A point under m on the host, in float32 as the reference's
    `apply_point` computes it on the CPU: each row a chain of fused
    multiply-adds, m[i,0] p0, then + m[i,1] p1, then + m[i,2] p2, each
    rounded once (a float64 product of two float32 values is exact),
    then the translation."""
    return apply_vector_np(m, p) + np.asarray(m, np.float32)[:3, 3]


def apply_vector_np(m, v):
    """A direction under m on the host: `apply_point_np` without the
    translation, as the reference's `apply_vector` computes it; v (3,) or
    (..., 3)."""
    m64 = np.asarray(m, np.float32).astype(np.float64)
    v = np.asarray(v, np.float32).astype(np.float64)
    acc = (m64[:3, 0] * v[..., 0, None]).astype(np.float32)
    for k in (1, 2):
        acc = (m64[:3, k] * v[..., k, None] + acc).astype(np.float32)
    return acc


def _rows(m, v):
    return [m[i, 0] * v[..., 0] + m[i, 1] * v[..., 1] + m[i, 2] * v[..., 2]
            for i in range(3)]


def apply_point(m, p):
    x, y, z = _rows(m, p)
    return torch.stack([x + m[0, 3], y + m[1, 3], z + m[2, 3]], dim=-1)


def apply_vector(m, v):
    return torch.stack(_rows(m, v), dim=-1)
