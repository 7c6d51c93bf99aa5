"""Brute-force intersectors: the CUDA kernels and their plain versions
(port of mitsuba_tpu/ops/intersect_pallas.py).

Four queries of N rays against every triangle of a brute scene:

* `closest_hit_shaded_and_any` (#1, :432): closest hit with its
  interpolated shading record for the bounce rays and any-hit occlusion
  of the shadow rays, in one pass over the (T, 29) table;
* `closest_hit_shaded` (#2, :281): the closest hit and its shading
  record alone;
* `any_hit` (#3, :165): occlusion over the (T, 9) `v0|e1|e2` table;
* `closest_hit` (#4, :139): t, u, v and prim over the (T, 9) table.

On CUDA tensors each launches its hand-written kernel of
`csrc/intersect_brute.cu`, built with nvcc at first use into `_build/`
and bound with ctypes; on CPU tensors it runs the plain PyTorch version
(`*_ref`). Any other device raises. The four kernels are instances of
one, `brute_kernel`. Each has its own launch count: `LAUNCHES` for #1,
`SPLIT_LAUNCHES` for the others. Each writes its outputs in their final
layout, bool masks included, into views of one allocation a dtype
(`_record_outputs`, `_hit_outputs`), so a call launches nothing but its
kernel.

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
TRI_COLS = 9
_DET_EPS = 1e-9
# largest (N, Tc) intermediate of the plain versions, in elements (128 MB
# of float32): 1M lanes x 32 triangles in one chunk
_MAX_ELEMS = 1 << 25

SOURCE = nv.source("intersect_brute.cu")

# kernel launches since import (or since a caller reset them): a run shows
# that it went through a kernel by reading its count before and after.
# LAUNCHES counts #1; SPLIT_LAUNCHES #2 (shaded), #3 (any), #4 (closest)
LAUNCHES = 0
SPLIT_LAUNCHES = {"shaded": 0, "any": 0, "closest": 0}
_LIB = {}
# the kernels' schedule (csrc/intersect_brute.cu kRows, kGroup,
# kThreads): test rows staged per pass, rows between the any-hit half's
# votes, threads a block
STAGE_ROWS = 256
SHADOW_GROUP = 8
THREADS = 256
# the brute kernels by the index `mts_brute_info` takes: #2, #1, #3, #4
BRUTE_KERNELS = ("shaded", "shaded_any", "any", "closest")


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


def make_tri_table(v0, e1, e2):
    """Pack triangle SoA into the (T, 9) `v0|e1|e2` layout (:182)."""
    return torch.cat([v0, e1, e2], dim=1).to(torch.float32).contiguous()


# ---------------------------------------------------------------------------
# Plain PyTorch versions
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


def _chunks(n, n_tris):
    """Triangle chunks [c0, c0 + step) keeping (N, step) <= _MAX_ELEMS."""
    step = max(1, min(n_tris, _MAX_ELEMS // max(n, 1)))
    return range(0, n_tris, step), step


def closest_hit_ref(table, o, d, mint, maxt):
    """Plain version of #4 (and the closest half of #1 and #2): the
    triangle loop becomes an (N, Tc) broadcast, chunked over T. The
    closest hit is the first minimum (argmin keeps the lowest index, as
    the kernel's strict t < t_best does); a later chunk wins only when
    strictly closer. Returns (t, u, v, prim, valid): t = inf, u = v = 0
    and prim = -1 on a miss."""
    n = o.shape[0]
    dev = o.device
    t_b = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
    u_b, v_b = torch.zeros_like(t_b), torch.zeros_like(t_b)
    p_b = torch.full((n,), -1, dtype=torch.int64, device=dev)
    rows = torch.arange(n, device=dev)
    starts, step = _chunks(n, table.shape[0])
    for c0 in starts:
        t, u, v, hit = _mt(table[c0:c0 + step], o, d, mint, maxt)
        t_masked = torch.where(hit, t, float("inf"))
        j = torch.argmin(t_masked, dim=1)
        t_j = t_masked[rows, j]
        better = t_j < t_b
        t_b = torch.where(better, t_j, t_b)
        u_b = torch.where(better, u[rows, j], u_b)
        v_b = torch.where(better, v[rows, j], v_b)
        p_b = torch.where(better, j + c0, p_b)
    return t_b, u_b, v_b, p_b.to(torch.int32), p_b >= 0


def any_hit_ref(table, o, d, mint, maxt):
    """Plain version of #3 (and the shadow half of #1): the OR over all
    triangles of the hit test."""
    occ = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    starts, step = _chunks(o.shape[0], table.shape[0])
    for c0 in starts:
        occ = occ | _mt(table[c0:c0 + step], o, d, mint, maxt)[3].any(dim=1)
    return occ


def _shading_record(table, t_b, u_b, v_b, p_b, valid):
    """The shading record of the winning rows, interpolated once (the
    kernels' epilogue): on a miss prim and ids -1, normals (0, 0, 1)."""
    r = table[torch.clamp(p_b, min=0).long()]
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

    return dict(
        t=t_b, u=u_b, v=v_b, prim=p_b, valid=valid,
        geo_n=unit(g), sh_n=unit(s), uv=torch.stack(uv, dim=-1),
        material_id=ids(24), emitter_id=ids(25), shape_id=ids(26),
    )


def closest_hit_shaded_ref(table, o, d, mint, maxt):
    """Plain version of #2: #1's without the shadow half."""
    return _shading_record(table, *closest_hit_ref(table, o, d, mint, maxt))


def closest_hit_shaded_and_any_ref(table, o, d, mint, maxt, so, sd, smint,
                                   smaxt):
    """Plain version of the fused kernel #1: the same results, lane for
    lane."""
    return (closest_hit_shaded_ref(table, o, d, mint, maxt),
            any_hit_ref(table, so, sd, smint, smaxt))


# ---------------------------------------------------------------------------
# CUDA kernels: build, bind, launch
# ---------------------------------------------------------------------------

def build() -> str:
    """Compile the kernels (at most once per source hash) and load them.
    Returns the compiler's output, empty when the library was cached."""
    log = nv.build_all([SOURCE])[SOURCE]
    p, i = ctypes.c_void_p, ctypes.c_int
    rays = [i, p, p, p, p, i]                  # n_tris, o, d, mint, maxt, n
    _LIB.update(
        shaded_any=nv.bind(SOURCE, "mts_shaded_any",
                           [p, i] + [p] * 8 + [i] + [p] * 12 + [p]),
        shaded=nv.bind(SOURCE, "mts_shaded", [p] + rays + [p] * 11 + [p]),
        any=nv.bind(SOURCE, "mts_any", [p] + rays + [p] + [p]),
        closest=nv.bind(SOURCE, "mts_closest", [p] + rays + [p] * 5 + [p]),
        info=nv.bind(SOURCE, "mts_brute_info", [i, p]),
    )
    return log


def brute_info(kernel) -> dict:
    """The resources of a brute kernel on the current card, by its name
    in BRUTE_KERNELS or its index there (so True is #1, False #2):
    resident blocks of THREADS per SM, registers per thread, static shared
    memory per block, local (spill) bytes per thread."""
    if "info" not in _LIB:
        build()
    kind = BRUTE_KERNELS.index(kernel) if isinstance(kernel, str) \
        else int(kernel)
    out = (ctypes.c_int * 4)()
    nv.check(_LIB["info"](kind, out), "brute_info")
    return dict(zip(("blocks_per_sm", "registers", "smem_bytes",
                     "local_bytes"), out))


def _check_inputs(table, cols, *rays):
    """rays: (o, d, mint, maxt) groups of N rays, all float32, contiguous
    and on one device, the CPU or a CUDA device, with the (T, cols)
    table."""
    o = rays[0]
    n = o.shape[0] if o.dim() == 2 else -1
    shapes = [(table, (table.shape[0], cols))]
    for k, x in enumerate(rays):
        shapes.append((x, (n, 3) if k % 4 < 2 else (n,)))
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
    if o.device.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"no intersector for {o.device}")
    nv.refuse_grad(table, *rays)


def closest_hit_shaded_and_any(table, o, d, mint, maxt, so, sd, smint,
                               smaxt):
    """#1: fused closest hit + shading record for (o, d) and any-hit
    occlusion for the shadow rays (so, sd). Returns (record dict, occluded
    bool) with the reference's keys: t, u, v, prim, valid, geo_n, sh_n,
    uv, material_id, emitter_id, shape_id."""
    _check_inputs(table, SHD_COLS, o, d, mint, maxt, so, sd, smint, smaxt)
    if o.device.type == "cpu":
        return closest_hit_shaded_and_any_ref(table, o, d, mint, maxt,
                                              so, sd, smint, smaxt)
    global LAUNCHES
    n = o.shape[0]
    rec, occ = _record_outputs(n, o.device, shadow=True)
    _launch("shaded_any", o, table, table.shape[0], o, d, mint, maxt,
            so, sd, smint, smaxt, n, *rec.values(), occ)
    if n > 0:
        LAUNCHES += 1
    return rec, occ


def closest_hit_shaded(table, o, d, mint, maxt):
    """#2: closest hit + shading record over the (T, 29) table, the record
    of `closest_hit_shaded_and_any`."""
    _check_inputs(table, SHD_COLS, o, d, mint, maxt)
    if o.device.type == "cpu":
        return closest_hit_shaded_ref(table, o, d, mint, maxt)
    n = o.shape[0]
    rec, _ = _record_outputs(n, o.device, shadow=False)
    _launch("shaded", o, table, table.shape[0], o, d, mint, maxt, n,
            *rec.values())
    _count("shaded", n)
    return rec


def any_hit(table, o, d, mint, maxt):
    """#3: occlusion of N rays over the (T, 9) table -> bool (N,)."""
    _check_inputs(table, TRI_COLS, o, d, mint, maxt)
    if o.device.type == "cpu":
        return any_hit_ref(table, o, d, mint, maxt)
    n = o.shape[0]
    occ = torch.empty(n, dtype=torch.bool, device=o.device)
    _launch("any", o, table, table.shape[0], o, d, mint, maxt, n, occ)
    _count("any", n)
    return occ


def closest_hit(table, o, d, mint, maxt):
    """#4: closest hit over the (T, 9) table -> (t, u, v, prim, valid),
    prim = -1 on a miss."""
    _check_inputs(table, TRI_COLS, o, d, mint, maxt)
    if o.device.type == "cpu":
        return closest_hit_ref(table, o, d, mint, maxt)
    n = o.shape[0]
    out = _hit_outputs(n, o.device)
    _launch("closest", o, table, table.shape[0], o, d, mint, maxt, n, *out)
    _count("closest", n)
    return out


def _record_outputs(n, device, shadow):
    """The record of #1 and #2 in its final layout, in the kernels'
    argument order (the reference's key order), and #1's occlusion mask:
    views of one float32, one int32 and one bool allocation."""
    f = torch.empty(11 * n, dtype=torch.float32, device=device)
    i = torch.empty(4 * n, dtype=torch.int32, device=device)
    b = torch.empty((2 if shadow else 1) * n, dtype=torch.bool,
                    device=device)
    rec = dict(
        t=f[:n], u=f[n:2 * n], v=f[2 * n:3 * n], prim=i[:n], valid=b[:n],
        geo_n=f[3 * n:6 * n].view(n, 3), sh_n=f[6 * n:9 * n].view(n, 3),
        uv=f[9 * n:].view(n, 2), material_id=i[n:2 * n],
        emitter_id=i[2 * n:3 * n], shape_id=i[3 * n:],
    )
    return rec, (b[n:] if shadow else None)


def _hit_outputs(n, device):
    """#4's (t, u, v, prim, valid): views of one float32, one int32 and
    one bool allocation."""
    f = torch.empty(3 * n, dtype=torch.float32, device=device)
    return (f[:n], f[n:2 * n], f[2 * n:],
            torch.empty(n, dtype=torch.int32, device=device),
            torch.empty(n, dtype=torch.bool, device=device))


def _launch(name, o, *args):
    """Launch kernel `name` on o's device and current stream: tensors pass
    as pointers, ints as ints; raise on a refused launch."""
    if not _LIB:
        build()
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream(o.device).cuda_stream
        err = _LIB[name](*[a.data_ptr() if isinstance(a, torch.Tensor)
                           else a for a in args], stream)
    nv.check(err, f"intersect_brute {name}")


def _count(name, n):
    if n > 0:
        SPLIT_LAUNCHES[name] += 1
