"""Keyframed animated transforms (port of mitsuba_tpu/core/track.py;
reference include/mitsuba/core/track.h:29,159 `AnimatedTransform`).

A transform decomposes into translation, rotation (a quaternion) and
scale keyframes, interpolated by lerp and slerp and recomposed. The keys
are decomposed on the host in float64 numpy, as in the JAX package; `eval`
interpolates in float32 torch on the CPU with the JAX package's operations
in its order, so a baked shape's vertices match it to float32 rounding.
`load_animated_transform` and `save_animated_transform` read and write the
reference's binary track files (animatedinstance.cpp:28-37) with numpy.
"""
from __future__ import annotations

import numpy as np
import torch


def _mat_to_quat(m3):
    """Rotation matrix → quaternion (w, x, y, z)."""
    m = np.asarray(m3, np.float64)
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (m[2, 1] - m[1, 2]) / s
        y = (m[0, 2] - m[2, 0]) / s
        z = (m[1, 0] - m[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(m)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(m[i, i] - m[j, j] - m[k, k] + 1.0, 1e-12)) * 2
        q = np.zeros(4)
        q[1 + i] = 0.25 * s
        q[0] = (m[k, j] - m[j, k]) / s
        q[1 + j] = (m[j, i] + m[i, j]) / s
        q[1 + k] = (m[k, i] + m[i, k]) / s
        w, x, y, z = q
    q = np.asarray([w, x, y, z])
    return q / np.linalg.norm(q)


def _quat_to_mat(q):
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ], -2)


def _slerp(q0, q1, t):
    d = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(d < 0, -q1, q1)
    d = torch.abs(d)
    theta = torch.arccos(torch.clamp(d, -1.0, 1.0))
    sin_t = torch.sin(theta)
    use_lerp = sin_t < 1e-5
    den = torch.where(use_lerp, 1.0, sin_t)
    w0 = torch.where(use_lerp, 1.0 - t, torch.sin((1 - t) * theta) / den)
    w1 = torch.where(use_lerp, t, torch.sin(t * theta) / den)
    q = w0 * q0 + w1 * q1
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def _compose(rot, trans):
    """(..., 3, 3) rotation-scale and (..., 3) translation -> (..., 4, 4)."""
    m = torch.zeros(rot.shape[:-2] + (4, 4), dtype=torch.float32)
    m[..., :3, :3] = rot
    m[..., :3, 3] = trans
    m[..., 3, 3] = 1.0
    return m


class AnimatedTransform:
    """Keyframed rigid + scale transform, slerp/lerp interpolated."""

    def __init__(self):
        self._times = []
        self._trans = []
        self._quats = []
        self._scales = []

    def append_transform(self, time: float, mat4):
        m = np.asarray(mat4, np.float64)
        t = m[:3, 3]
        a = m[:3, :3]
        # scale = column norms (no shear, as in the reference's
        # track decomposition)
        s = np.linalg.norm(a, axis=0)
        r = a / np.maximum(s, 1e-12)
        self._times.append(float(time))
        self._trans.append(t)
        self._quats.append(_mat_to_quat(r))
        self._scales.append(s)
        return self

    @property
    def n_keys(self):
        return len(self._times)

    def eval(self, times):
        """times: (...,) -> (..., 4, 4) float32 interpolated transforms, on
        the CPU."""
        times = torch.as_tensor(np.asarray(times, np.float32))
        kt = torch.as_tensor(np.asarray(self._times, np.float32))
        tr = torch.as_tensor(np.asarray(self._trans, np.float32))
        qu = torch.as_tensor(np.asarray(self._quats, np.float32))
        sc = torch.as_tensor(np.asarray(self._scales, np.float32))
        if self.n_keys == 1:
            rot = _quat_to_mat(qu[0]) * sc[0][None, :]
            return _compose(rot.expand(times.shape + (3, 3)),
                            tr[0].expand(times.shape + (3,)))
        i1 = torch.clamp(torch.searchsorted(kt, times, right=True), 1,
                         self.n_keys - 1)
        i0 = i1 - 1
        t0 = kt[i0]
        t1 = kt[i1]
        f = torch.clamp((times - t0) / torch.clamp(t1 - t0, min=1e-9),
                        0.0, 1.0)
        trans = tr[i0] + (tr[i1] - tr[i0]) * f[..., None]
        scale = sc[i0] + (sc[i1] - sc[i0]) * f[..., None]
        quat = _slerp(qu[i0], qu[i1], f[..., None])
        rot = _quat_to_mat(quat) * scale[..., None, :]
        return _compose(rot, trans)


# ---------------------------------------------------------------------------
# Reference binary track files (animatedinstance's 'filename' prop)
# ---------------------------------------------------------------------------

# track-type enum, reference include/mitsuba/render/track.h:32
_T_TX, _T_TY, _T_TZ, _T_TXYZ = 1, 2, 3, 4
_T_SX, _T_SY, _T_SZ, _T_SXYZ = 5, 6, 7, 8
_T_RX, _T_RY, _T_RZ, _T_RQUAT = 9, 10, 11, 12
_WIDTH = {_T_TX: 1, _T_TY: 1, _T_TZ: 1, _T_TXYZ: 3,
          _T_SX: 1, _T_SY: 1, _T_SZ: 1, _T_SXYZ: 3,
          _T_RX: 1, _T_RY: 1, _T_RZ: 1, _T_RQUAT: 4}


def load_animated_transform(path) -> "AnimatedTransform":
    """Read the reference's serialized AnimatedTransform (little-endian
    single precision; format: uint32 nTracks, then per track uint32 type,
    uint32 nKeyframes, float32 times[n], values — float / vec3 /
    quat(x,y,z,w) by type; track.cpp:5-36 + track.h:77).  Used by
    `<shape type="animatedinstance">`'s 'filename' property
    (animatedinstance.cpp:28-37).  Per-channel tracks are composed as
    T·R·S at the union of keyframe times (track.cpp:56-99 eval) and
    re-keyed into this module's matrix-keyframe AnimatedTransform.
    Euler rotation tracks are rejected exactly like the reference's
    eval() (track.cpp:91-93 default case)."""
    raw = np.fromfile(path, np.uint8)
    off = 0

    def u32():
        nonlocal off
        v = int(np.frombuffer(raw[off:off + 4], "<u4")[0])
        off += 4
        return v

    def f32(n):
        nonlocal off
        v = np.frombuffer(raw[off:off + 4 * n], "<f4").astype(np.float64)
        off += 4 * n
        return v

    n_tracks = u32()
    tracks = []
    for _ in range(n_tracks):
        ty = u32()
        if ty in (_T_RX, _T_RY, _T_RZ):
            raise ValueError(
                "Euler rotation tracks are unsupported (matches the "
                "reference AnimatedTransform::eval)")
        if ty not in _WIDTH:
            raise ValueError(f"unknown animation track type {ty}")
        nk = u32()
        times = f32(nk)
        vals = f32(nk * _WIDTH[ty]).reshape(nk, _WIDTH[ty])
        tracks.append((ty, times, vals))

    key_times = sorted({float(t) for _, ts, _ in tracks for t in ts}) or [0.0]

    def _eval_track(times, vals, t):
        if len(times) == 1:
            return vals[0]
        i1 = int(np.clip(np.searchsorted(times, t, side="right"), 1,
                         len(times) - 1))
        i0 = i1 - 1
        f = np.clip((t - times[i0]) / max(times[i1] - times[i0], 1e-12),
                    0.0, 1.0)
        return vals[i0] * (1 - f) + vals[i1] * f

    at = AnimatedTransform()
    for t in key_times:
        trans = np.zeros(3)
        scale = np.ones(3)
        quat = np.array([0.0, 0.0, 0.0, 1.0])   # (x, y, z, w)
        for ty, ts, vs in tracks:
            v = _eval_track(ts, vs, t)
            if ty == _T_TX:
                trans[0] = v[0]
            elif ty == _T_TY:
                trans[1] = v[0]
            elif ty == _T_TZ:
                trans[2] = v[0]
            elif ty == _T_TXYZ:
                trans = v
            elif ty == _T_SX:
                scale[0] = v[0]
            elif ty == _T_SY:
                scale[1] = v[0]
            elif ty == _T_SZ:
                scale[2] = v[0]
            elif ty == _T_SXYZ:
                scale = v
            elif ty == _T_RQUAT:
                quat = v / max(np.linalg.norm(v), 1e-12)
        x, y, z, w = quat
        rot = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ])
        m = np.eye(4)
        m[:3, :3] = rot * scale[None, :]
        m[:3, 3] = trans
        at.append_transform(t, m)
    return at


def save_animated_transform(path, at: "AnimatedTransform"):
    """Write an AnimatedTransform in the reference binary format (one
    TXYZ + one RQuat + one SXYZ track over the matrix keyframes)."""
    n = at.n_keys
    times = np.asarray(at._times, np.float32)
    out = [np.asarray([3], np.uint32).tobytes()]
    # quats stored here as (w, x, y, z); file format wants (x, y, z, w)
    q = np.asarray(at._quats, np.float32)
    q_file = np.concatenate([q[:, 1:4], q[:, 0:1]], axis=1)
    for ty, vals in ((_T_TXYZ, np.asarray(at._trans, np.float32)),
                     (_T_RQUAT, q_file),
                     (_T_SXYZ, np.asarray(at._scales, np.float32))):
        out.append(np.asarray([ty, n], np.uint32).tobytes())
        out.append(times.tobytes())
        out.append(vals.astype("<f4").tobytes())
    with open(path, "wb") as f:
        f.write(b"".join(out))
