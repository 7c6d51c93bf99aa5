"""Brute-force fused intersector: the CUDA kernel and its plain version
(port of mitsuba_tpu/ops/intersect_pallas.py:312-467).

`closest_hit_shaded_and_any` answers, in one pass over the triangles, the
closest hit with its interpolated shading record for the bounce rays and
the any-hit occlusion of the shadow rays. On CUDA tensors it launches the
hand-written kernel of `csrc/intersect_brute.cu`, built with nvcc at first
use into `_build/` and bound with ctypes; on CPU tensors it runs the plain
PyTorch version `closest_hit_shaded_and_any_ref`. Any other device raises.

Triangle table layout (T, 29), as in the reference:
  [0:9]   v0 | e1 | e2
  [9:18]  n0 | n1 | n2          (shading normals per corner)
  [18:24] uv0 | uv1 | uv2
  [24]    material_id  [25] emitter_id  [26] shape_id  (exact in f32)
  [27:29] padding
"""
from __future__ import annotations

import ctypes

import torch

from mitsuba_tpu_torch.ops import build as nv

SHD_COLS = 29
_DET_EPS = 1e-9
# largest (N, Tc) intermediate of the plain version, in elements (128 MB
# of float32): 1M lanes x 32 triangles in one chunk
_MAX_ELEMS = 1 << 25

SOURCE = nv.source("intersect_brute.cu")

# kernel launches since import (or since a caller reset it): a run shows
# that it went through the kernel by reading this before and after
LAUNCHES = 0
_LIB = None


def make_shading_table(geom):
    """Pack the triangle tables of `geom` into the (T, 29) layout."""
    t = geom.v0.shape[0]
    return torch.cat(
        [
            geom.v0, geom.e1, geom.e2,
            geom.n0, geom.n1, geom.n2,
            geom.uv0, geom.uv1, geom.uv2,
            geom.material_id[:, None].to(torch.float32),
            geom.emitter_id[:, None].to(torch.float32),
            geom.shape_id[:, None].to(torch.float32),
            torch.zeros((t, 2), dtype=torch.float32, device=geom.v0.device),
        ],
        dim=1,
    ).contiguous()


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def _mt(tri, o, d, mint, maxt):
    """Möller–Trumbore of N rays against Tc table rows, as an (N, Tc)
    broadcast with the kernel's operation order. Returns (t, u, v, hit)."""
    v0x, v0y, v0z = tri[:, 0], tri[:, 1], tri[:, 2]
    e1x, e1y, e1z = tri[:, 3], tri[:, 4], tri[:, 5]
    e2x, e2y, e2z = tri[:, 6], tri[:, 7], tri[:, 8]
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    det_ok = torch.abs(det) > _DET_EPS
    inv_det = torch.where(det_ok, 1.0 / torch.where(det == 0, 1.0, det), 0.0)
    tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    hit = (det_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > mint[:, None]) & (t < maxt[:, None]))
    return t, u, v, hit


def closest_hit_shaded_and_any_ref(table, o, d, mint, maxt, so, sd, smint,
                                   smaxt):
    """Plain version of the fused kernel: the same results, lane for lane.

    The triangle loop becomes an (N, Tc) broadcast, chunked over T so that
    no intermediate holds more than _MAX_ELEMS elements. The closest hit
    is the first minimum (argmin keeps the lowest index, as the kernel's
    strict t < t_best does); a later chunk wins only when strictly closer.
    """
    n, n_tris = o.shape[0], table.shape[0]
    dev = o.device
    inf = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
    t_b, u_b, v_b = inf, torch.zeros_like(inf), torch.zeros_like(inf)
    p_b = torch.full((n,), -1, dtype=torch.int64, device=dev)
    occ = torch.zeros(n, dtype=torch.bool, device=dev)
    step = max(1, min(n_tris, _MAX_ELEMS // max(n, 1)))
    rows = torch.arange(n, device=dev)
    for c0 in range(0, n_tris, step):
        tri = table[c0:c0 + step]
        t, u, v, hit = _mt(tri, o, d, mint, maxt)
        t_masked = torch.where(hit, t, float("inf"))
        j = torch.argmin(t_masked, dim=1)
        t_j = t_masked[rows, j]
        better = t_j < t_b
        t_b = torch.where(better, t_j, t_b)
        u_b = torch.where(better, u[rows, j], u_b)
        v_b = torch.where(better, v[rows, j], v_b)
        p_b = torch.where(better, j + c0, p_b)
        occ = occ | _mt(tri, so, sd, smint, smaxt)[3].any(dim=1)

    valid = p_b >= 0
    r = table[torch.clamp(p_b, min=0)]
    e1x, e1y, e1z = r[:, 3], r[:, 4], r[:, 5]
    e2x, e2y, e2z = r[:, 6], r[:, 7], r[:, 8]
    w = 1.0 - u_b - v_b

    def lerp3(c):
        return w * r[:, c] + u_b * r[:, c + 3] + v_b * r[:, c + 6]

    def lerp_uv(c):
        return w * r[:, c] + u_b * r[:, c + 2] + v_b * r[:, c + 4]

    zero, one = torch.zeros_like(w), torch.ones_like(w)
    g = [torch.where(valid, x, z) for x, z in (
        (e1y * e2z - e1z * e2y, zero), (e1z * e2x - e1x * e2z, zero),
        (e1x * e2y - e1y * e2x, one))]
    s = [torch.where(valid, lerp3(9 + k), z)
         for k, z in enumerate((zero, zero, one))]
    uv = [torch.where(valid, lerp_uv(18 + k), zero) for k in range(2)]

    def unit(c):
        inv = 1.0 / torch.sqrt(torch.clamp(
            c[0] * c[0] + c[1] * c[1] + c[2] * c[2], min=1e-20))
        return torch.stack([x * inv for x in c], dim=-1)

    def ids(c):
        return torch.where(valid, r[:, c].to(torch.int32), -1)

    rec = dict(
        t=t_b, u=u_b, v=v_b, prim=p_b.to(torch.int32), valid=valid,
        geo_n=unit(g), sh_n=unit(s), uv=torch.stack(uv, dim=-1),
        material_id=ids(24), emitter_id=ids(25), shape_id=ids(26),
    )
    return rec, occ


# ---------------------------------------------------------------------------
# CUDA kernel: build, bind, launch
# ---------------------------------------------------------------------------

def build() -> str:
    """Compile the kernel (at most once per source hash) and load it.
    Returns the compiler's output, empty when the library was cached."""
    global _LIB
    log = nv.build_all([SOURCE])[SOURCE]
    p, i = ctypes.c_void_p, ctypes.c_int
    _LIB = nv.bind(SOURCE, "mts_shaded_any",
                   [p, i] + [p] * 8 + [i] + [p] * 17 + [p])
    return log


def _check_inputs(table, o, d, mint, maxt, so, sd, smint, smaxt):
    n = o.shape[0] if o.dim() == 2 else -1
    shapes = ((table, (table.shape[0], SHD_COLS)),
              (o, (n, 3)), (d, (n, 3)), (so, (n, 3)), (sd, (n, 3)),
              (mint, (n,)), (maxt, (n,)), (smint, (n,)), (smaxt, (n,)))
    for x, shape in shapes:
        if x.dtype != torch.float32:
            raise TypeError(f"expected float32, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"expected shape {shape}, got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError("inputs must be contiguous")
        if x.device != o.device:
            raise ValueError(f"inputs on {x.device} and {o.device}")
    if table.shape[0] == 0:
        raise ValueError("empty triangle table")


def closest_hit_shaded_and_any(table, o, d, mint, maxt, so, sd, smint,
                               smaxt):
    """Fused closest hit + shading record for (o, d) and any-hit occlusion
    for the shadow rays (so, sd). Returns (record dict, occluded bool)
    with the reference's keys: t, u, v, prim, valid, geo_n, sh_n, uv,
    material_id, emitter_id, shape_id."""
    _check_inputs(table, o, d, mint, maxt, so, sd, smint, smaxt)
    if o.device.type == "cpu":
        return closest_hit_shaded_and_any_ref(table, o, d, mint, maxt,
                                              so, sd, smint, smaxt)
    if o.device.type != "cuda":
        raise NotImplementedError(f"no intersector for {o.device}")
    return _launch(table, o, d, mint, maxt, so, sd, smint, smaxt)


def _launch(table, o, d, mint, maxt, so, sd, smint, smaxt):
    global LAUNCHES
    if _LIB is None:
        build()
    n = o.shape[0]
    with torch.cuda.device(o.device):
        f32 = [torch.empty(n, dtype=torch.float32, device=o.device)
               for _ in range(11)]
        i32 = [torch.empty(n, dtype=torch.int32, device=o.device)
               for _ in range(6)]
        t, u, v, gx, gy, gz, sx, sy, sz, tu, tv = f32
        prim, hit, mid, eid, sid, occ = i32
        stream = torch.cuda.current_stream(o.device).cuda_stream
        err = _LIB(
            table.data_ptr(), table.shape[0], o.data_ptr(), d.data_ptr(),
            mint.data_ptr(), maxt.data_ptr(), so.data_ptr(), sd.data_ptr(),
            smint.data_ptr(), smaxt.data_ptr(), n,
            t.data_ptr(), u.data_ptr(), v.data_ptr(), prim.data_ptr(),
            hit.data_ptr(), gx.data_ptr(), gy.data_ptr(), gz.data_ptr(),
            sx.data_ptr(), sy.data_ptr(), sz.data_ptr(), tu.data_ptr(),
            tv.data_ptr(), mid.data_ptr(), eid.data_ptr(), sid.data_ptr(),
            occ.data_ptr(), stream)
    nv.check(err, "intersect_brute")
    if n > 0:
        LAUNCHES += 1
    rec = dict(
        t=t, u=u, v=v, prim=prim, valid=hit.bool(),
        geo_n=torch.stack([gx, gy, gz], dim=-1),
        sh_n=torch.stack([sx, sy, sz], dim=-1),
        uv=torch.stack([tu, tv], dim=-1),
        material_id=mid, emitter_id=eid, shape_id=sid,
    )
    return rec, occ.bool()
