"""Ray–scene intersection on the brute and cluster backends (port of
mitsuba_tpu/render/intersect.py, non-instanced triangle scenes).

Geometry lives in `GeometryTables`, SoA tensors of the triangle soup.

* brute (scenes of up to 64 triangles): the triangles in input order; the
  path tracer's `ray_intersect_and_test` runs the fused kernel of
  `ops/intersect.py` once per bounce and assembles the `Intersection` as
  the reference's TPU kernel path does (intersect.py:1489-1518): the
  shading frame is `Frame.from_normal(sh_n)`, `dp_du` its s axis.
* cluster: the triangles in BVH order, cut into 8-triangle clusters with
  an 8x box hierarchy for the exact cull (`ops/exact.py`) and into
  32-triangle superclusters for the complete stream walk
  (`ops/stream.py`). A query (`ray_intersect`, `ray_test`) clamps maxt to
  the root box, runs the exact cull at diffuse or coherent caps,
  re-runs rows that overflowed at the XL caps on a row-compacted subset,
  and resolves whatever still overflows through the stream kernel
  (intersect.py:1295-1319, 1523-1540). The hit record then comes from the
  reference's generic tail (intersect.py:1359-1481): one packed
  `shade_pack` row per hit, `dp_du` from the uv chart, and the frame
  `Frame.from_normal_tangent(sh_n, dp_du)` — not the brute path's frame.

Each `lax.cond` of the reference is a Python branch on a device-side
`any()`. Instancing and the `bvh` backend are not ported.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from mitsuba_tpu.render.bvh import build_bvh          # numpy only, jax-free
from mitsuba_tpu.render.clusters import (              # numpy only, jax-free
    build_mt_tables, cut_clusters,
)
from mitsuba_tpu_torch.core import math as m
from mitsuba_tpu_torch.ops import exact as ep
from mitsuba_tpu_torch.ops import intersect as ip
from mitsuba_tpu_torch.ops import stream as sp
from mitsuba_tpu_torch.render.records import Intersection, Ray

LANE_ROW = 128


@dataclass
class GeometryTables:
    v0: torch.Tensor        # (T, 3)
    e1: torch.Tensor        # (T, 3) v1 - v0
    e2: torch.Tensor        # (T, 3) v2 - v0
    n0: torch.Tensor        # (T, 3) per-corner shading normals
    n1: torch.Tensor
    n2: torch.Tensor
    uv0: torch.Tensor       # (T, 2)
    uv1: torch.Tensor
    uv2: torch.Tensor
    material_id: torch.Tensor  # (T,) int32
    emitter_id: torch.Tensor   # (T,) int32, -1 = not emissive
    shape_id: torch.Tensor     # (T,) int32
    # cluster backend only (None on brute)
    bvh_min: torch.Tensor = None     # (M, 3) BVH node boxes, row 0 = root
    bvh_max: torch.Tensor = None
    # the shading record in one row: e1|e2|n0|n1|n2|uv0|uv1|uv2|
    # mid|eid|sid (ints bitcast to float32)
    shade_pack: torch.Tensor = None  # (T, 24)
    # stream tables: K = 32 clusters in superclusters of 8
    sc_tri: torch.Tensor = None      # (C_s, 32, 128) lane = cluster*16+field
    mt_start: torch.Tensor = None    # (C,) int32 first triangle per cluster
    cl_sc_bmin: torch.Tensor = None  # (C_s, 3)
    cl_sc_bmax: torch.Tensor = None
    # exact-cull tables: K8 clusters, 8x box hierarchy
    ex_tri: torch.Tensor = None      # (C8, 8, 128) lane 15 = prim (bitcast)
    ex_b0lo: torch.Tensor = None     # (C8, 3)
    ex_b0hi: torch.Tensor = None
    ex_b1lo: torch.Tensor = None     # (C8/8, 3)
    ex_b1hi: torch.Tensor = None
    ex_b2lo: torch.Tensor = None     # (C8/64, 3)
    ex_b2hi: torch.Tensor = None
    ex_ct0: torch.Tensor = None      # (C8/8, 8, 128) K8-child box table
    ex_ct1: torch.Tensor = None      # (C8/64, 8, 128) L1-child box table
    ex_ct2: torch.Tensor = None      # (pad(C8/64)/8, 8, 128) root table
    ex_caps: tuple = None            # (diffuse, coherent, xl) caps
    backend: str = "brute"

    @property
    def n_tris(self):
        return self.v0.shape[0]

    @property
    def ex_tables(self):
        return dict(tri=self.ex_tri, b0_lo=self.ex_b0lo, b0_hi=self.ex_b0hi,
                    b1_lo=self.ex_b1lo, b1_hi=self.ex_b1hi,
                    b2_lo=self.ex_b2lo, b2_hi=self.ex_b2hi,
                    ct0=self.ex_ct0, ct1=self.ex_ct1, ct2=self.ex_ct2)

    @property
    def st_tables(self):
        return dict(sc_tri=self.sc_tri, sc_bmin=self.cl_sc_bmin,
                    sc_bmax=self.cl_sc_bmax, tri_start=self.mt_start)


def _pad_boxes(lo, hi, mult=128):
    """Pad a box list to a multiple of `mult` with far-away degenerate
    boxes (intersect.py:194: 2e30 corners land beyond every clamped maxt;
    not +-inf, whose slab arithmetic gives NaN)."""
    pad = (-lo.shape[0]) % mult
    if pad:
        lo = np.concatenate([lo, np.full((pad, 3), 2e30, np.float32)])
        hi = np.concatenate([hi, np.full((pad, 3), 2e30, np.float32)])
    return lo, hi


def build_geometry(meshes_with_ids, backend: str = "brute") \
        -> GeometryTables:
    """Assemble GeometryTables from [(TriMesh, material_id, emitter_id
    [, shape_id]), ...]. backend 'brute' keeps the input order and builds
    no tree; 'cluster' (the reference's choice above 64 triangles) orders
    the triangles by a BVH and builds the cluster tables. Host numpy, as
    in the reference."""
    vs, fs, ns, uvs, mids, eids, sids = [], [], [], [], [], [], []
    voff = 0
    for k, item in enumerate(meshes_with_ids):
        mesh, mat, emit = item[:3]
        sid = item[3] if len(item) > 3 else k
        vs.append(np.asarray(mesh.vertices, np.float32))
        fs.append(np.asarray(mesh.faces, np.int64) + voff)
        n = mesh.normals
        if n is None:
            # flat face normals averaged onto the vertices
            fn = mesh.face_normals()
            n = np.zeros_like(mesh.vertices)
            for c in range(3):
                np.add.at(n, mesh.faces[:, c], fn)
            n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True),
                               1e-20)
        ns.append(np.asarray(n, np.float32))
        uv = mesh.uvs if mesh.uvs is not None else \
            np.zeros((mesh.vertices.shape[0], 2), np.float32)
        uvs.append(np.asarray(uv, np.float32))
        t = mesh.faces.shape[0]
        mids.append(np.full(t, mat, np.int32))
        eids.append(np.full(t, emit, np.int32))
        sids.append(np.full(t, sid, np.int32))
        voff += mesh.vertices.shape[0]
    v = np.concatenate(vs)
    f = np.concatenate(fs)
    n = np.concatenate(ns)
    uv = np.concatenate(uvs)
    mid = np.concatenate(mids)
    eid = np.concatenate(eids)
    sid = np.concatenate(sids)
    if backend not in ("brute", "cluster"):
        raise NotImplementedError(
            f"intersection backend '{backend}' is not ported "
            "(only 'brute' and 'cluster')")

    def dev(x):
        return torch.as_tensor(np.ascontiguousarray(x))

    cl = {}
    if backend == "cluster":
        bvh = build_bvh(v, f)
        p = bvh.perm
        f = f[p]
        mid, eid, sid = mid[p], eid[p], sid[p]
        cl = _build_cluster(v[f], bvh, n[f], uv[f], mid, eid, sid)
    tri = v[f]  # (T, 3, 3)
    return GeometryTables(
        **{k: dev(x) for k, x in cl.items() if k != "ex_caps"},
        ex_caps=cl.get("ex_caps"),
        backend=backend,
        v0=dev(tri[:, 0]),
        e1=dev(tri[:, 1] - tri[:, 0]),
        e2=dev(tri[:, 2] - tri[:, 0]),
        n0=dev(n[f[:, 0]]), n1=dev(n[f[:, 1]]), n2=dev(n[f[:, 2]]),
        uv0=dev(uv[f[:, 0]]), uv1=dev(uv[f[:, 1]]), uv2=dev(uv[f[:, 2]]),
        material_id=dev(mid), emitter_id=dev(eid), shape_id=dev(sid),
    )


def _build_cluster(tri, bvh, nrm, uvc, mid, eid, sid):
    """numpy tables of the cluster backend (intersect.py:278-328, 476-504)
    for the BVH-ordered soup tri (T, 3, 3) with its per-corner normals
    nrm (T, 3, 3) and uvs uvc (T, 3, 2)."""
    n_t = tri.shape[0]
    v0, e1, e2 = tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
    mt = build_mt_tables(v0, e1, e2, cut_clusters(
        bvh.first, bvh.count, bvh.skip, n_t, max_k=32), k=32)
    c, k, f = mt.tri.shape
    sc_tri = mt.tri.reshape(c // 8, 8, k, f).transpose(0, 2, 1, 3) \
        .reshape(c // 8, k, 8 * f)
    mt8 = build_mt_tables(v0, e1, e2, cut_clusters(
        bvh.first, bvh.count, bvh.skip, n_t, max_k=8), k=8, sc_group=64)
    c8 = mt8.bmin.shape[0]
    b1lo = mt8.bmin.reshape(c8 // 8, 8, 3).min(1)
    b1hi = mt8.bmax.reshape(c8 // 8, 8, 3).max(1)
    b2lo = b1lo.reshape(c8 // 64, 8, 3).min(1)
    b2hi = b1hi.reshape(c8 // 64, 8, 3).max(1)
    tri128 = np.zeros((c8, 8, 128), np.float32)
    tri128[:, :, :9] = mt8.tri[:, :, :9]
    prim8 = (mt8.tri_start[:, None]
             + np.arange(8, dtype=np.int32)[None]).astype(np.int32)
    tri128[:, :, 15] = prim8.view(np.float32)
    shade = np.concatenate(
        [e1.astype(np.float32), e2.astype(np.float32),
         nrm[:, 0].astype(np.float32), nrm[:, 1].astype(np.float32),
         nrm[:, 2].astype(np.float32),
         uvc[:, 0].astype(np.float32), uvc[:, 1].astype(np.float32),
         uvc[:, 2].astype(np.float32),
         mid.astype(np.int32).view(np.float32)[:, None],
         eid.astype(np.int32).view(np.float32)[:, None],
         sid.astype(np.int32).view(np.float32)[:, None]], axis=1)
    return dict(
        bvh_min=bvh.bounds_min, bvh_max=bvh.bounds_max, shade_pack=shade,
        sc_tri=sc_tri, mt_start=mt.tri_start,
        cl_sc_bmin=mt.sc_bmin, cl_sc_bmax=mt.sc_bmax,
        ex_tri=tri128, ex_b0lo=mt8.bmin, ex_b0hi=mt8.bmax,
        ex_b1lo=b1lo, ex_b1hi=b1hi, ex_b2lo=b2lo, ex_b2hi=b2hi,
        ex_ct0=ep.pack_child_table(mt8.bmin, mt8.bmax),
        ex_ct1=ep.pack_child_table(b1lo, b1hi),
        ex_ct2=ep.pack_child_table(*_pad_boxes(b2lo, b2hi)),
        ex_caps=ep.auto_caps(c8),
    )


# ---------------------------------------------------------------------------
# brute backend: the fused kernel
# ---------------------------------------------------------------------------

def ray_intersect_and_test(geom: GeometryTables, ray: Ray, sray: Ray):
    """Closest hit (ray) and shadow any-hit (sray) on the brute backend:
    one fused kernel launch with a shared triangle loop. Returns
    (Intersection, occluded)."""
    table = ip.make_shading_table(geom)
    r, occ = ip.closest_hit_shaded_and_any(
        table, ray.o.contiguous(), ray.d.contiguous(),
        ray.mint.contiguous(), ray.maxt.contiguous(),
        sray.o.contiguous(), sray.d.contiguous(),
        sray.mint.contiguous(), sray.maxt.contiguous(),
    )
    valid = r["valid"]
    # finite position on a miss: inf positions would NaN the masked lanes
    p = ray.at(torch.where(valid, r["t"], 1.0))
    frame = m.Frame.from_normal(r["sh_n"])
    wi = frame.to_local(-ray.d)
    its = Intersection(
        valid=valid,
        t=torch.where(valid, r["t"], float("inf")),
        p=p,
        geo_n=r["geo_n"],
        sh_n=r["sh_n"],
        uv=r["uv"],
        dp_du=frame.s,
        wi=wi,
        prim_id=torch.where(valid, r["prim"], -1),
        shape_id=torch.where(valid, r["shape_id"], -1),
        material_id=torch.where(valid, r["material_id"], -1),
        emitter_id=torch.where(valid, r["emitter_id"], -1),
    )
    return its, occ


# ---------------------------------------------------------------------------
# cluster backend: exact cull, XL re-run, stream fallback
# ---------------------------------------------------------------------------

def _cap_root_exit(geom: GeometryTables, ray: Ray) -> Ray:
    """Clamp maxt to the root box's exit distance, dead where the root box
    is missed (intersect.py:905): nothing lies outside the root, and the
    clamp keeps escaping rays from collecting candidates."""
    lo = geom.bvh_min[0][None]
    hi = geom.bvh_max[0][None]
    inv = torch.where(torch.abs(ray.d) > 1e-12, 1.0 / ray.d, 3e38)
    t0 = (lo - ray.o) * inv
    t1 = (hi - ray.o) * inv
    tn = torch.minimum(t0, t1).amax(dim=-1)
    tf = torch.maximum(t0, t1).amin(dim=-1)
    # slack: the cull and kernels recompute slabs in other orders; a hit
    # exactly at the boundary must stay inside
    cap = tf * 1.0002 + 1e-5
    hit = (tf >= torch.maximum(tn, ray.mint)) & (tf > 0)
    return Ray(ray.o, ray.d, ray.mint,
               torch.where(hit, torch.minimum(ray.maxt, cap), -1.0))


def _retier_capacity(n):
    """Rows of the XL re-run and of the compacted stream fallback: 1/16 of
    the wavefront's rows (intersect.py:1034)."""
    return max(8, -(-n // LANE_ROW) // 16)


def _retier_perm(lane_ovf, n):
    """Lane permutation putting the overflowing rows first (stable), and
    its inverse (intersect.py:1003)."""
    r = -(-n // LANE_ROW)
    ovf_p = torch.zeros(r * LANE_ROW, dtype=torch.bool,
                        device=lane_ovf.device)
    ovf_p[:n] = lane_ovf
    row_ovf = ovf_p.reshape(r, LANE_ROW).any(dim=1)
    row_order = torch.argsort((~row_ovf).to(torch.int8), stable=True)
    lane_perm = (row_order[:, None] * LANE_ROW + torch.arange(
        LANE_ROW, device=lane_ovf.device)[None]).reshape(-1)
    inv = torch.empty_like(lane_perm)
    inv[lane_perm] = torch.arange(r * LANE_ROW, device=lane_ovf.device)
    return lane_perm, inv, int(row_ovf.sum())


def _gather_rows(x, perm, sel, n, fill=0.0):
    """x padded to the permutation's length with `fill`, gathered at sel."""
    pad = perm.shape[0] - n
    if pad:
        x = torch.cat([x, x.new_full((pad,) + x.shape[1:], fill)])
    return x[sel]


def _retier_closest(geom, ray, t, u, v, prim, valid, lane_ovf):
    """Re-run the overflowing rows at the XL caps on a row-compacted
    subset of bounded size (intersect.py:1044). Returns the merged result
    and the residual overflow mask."""
    n = ray.o.shape[0]
    m_xl = _retier_capacity(n) * LANE_ROW
    perm, inv, _ = _retier_perm(lane_ovf, n)
    sel = perm[:m_xl]
    fb_maxt = torch.where(valid & torch.isfinite(t), t, ray.maxt)
    mx = torch.where(lane_ovf, fb_maxt, -1.0)

    def g(x, fill=0.0):
        return _gather_rows(x, perm, sel, n, fill)

    t2, u2, v2, p2, ok2, ovf2 = ep.exact_closest(
        geom.ex_tables, g(ray.o), g(ray.d), g(ray.mint, 1.0), g(mx, -1.0),
        caps=geom.ex_caps[2])
    # lane i sits at rank inv[i]; ranks >= m_xl were not re-run
    rk = inv[:n]
    in_xl = rk < m_xl
    rkc = torch.clamp(rk, max=m_xl - 1)
    t2, u2, v2, p2 = t2[rkc], u2[rkc], v2[rkc], p2[rkc]
    ok2 = ok2[rkc] & in_xl
    ovf2 = ovf2[rkc]
    take = lane_ovf & ok2 & (~valid | (t2 < t))
    t = torch.where(take, t2, t)
    u = torch.where(take, u2, u)
    v = torch.where(take, v2, v)
    prim = torch.where(take, p2, prim)
    resolved = lane_ovf & in_xl & ~ovf2
    valid = torch.where(resolved, ok2 | valid, valid)
    return t, u, v, prim, valid, lane_ovf & (~in_xl | ovf2)


def _retier_any(geom, ray, occ, lane_ovf):
    """Any-hit analog of _retier_closest (intersect.py:1109)."""
    n = ray.o.shape[0]
    m_xl = _retier_capacity(n) * LANE_ROW
    todo = lane_ovf & ~occ
    perm, inv, _ = _retier_perm(todo, n)
    sel = perm[:m_xl]
    mx = torch.where(todo, ray.maxt, -1.0)

    def g(x, fill=0.0):
        return _gather_rows(x, perm, sel, n, fill)

    occ2, ovf2 = ep.exact_any(geom.ex_tables, g(ray.o), g(ray.d),
                              g(ray.mint, 1.0), g(mx, -1.0),
                              caps=geom.ex_caps[2])
    rk = inv[:n]
    in_xl = rk < m_xl
    rkc = torch.clamp(rk, max=m_xl - 1)
    occ2 = occ2[rkc] & in_xl
    ovf2 = ovf2[rkc]
    return occ | (occ2 & todo), todo & (~in_xl | ovf2) & ~occ2


def _fallback_closest_stream(geom, ray, t, u, v, prim, valid, lane_ovf):
    """Resolve the residual overflow lanes completely through the stream
    kernel, on a row-compacted subset when it fits (intersect.py:1149)."""
    n = ray.o.shape[0]
    r_xl = _retier_capacity(n)
    m_xl = r_xl * LANE_ROW
    fb_maxt = torch.where(valid & torch.isfinite(t), t, ray.maxt)
    mx_all = torch.where(lane_ovf, fb_maxt, -1.0)
    perm, inv, n_rows_ovf = _retier_perm(lane_ovf, n)
    if n_rows_ovf <= r_xl:
        sel = perm[:m_xl]

        def g(x, fill=0.0):
            return _gather_rows(x, perm, sel, n, fill)

        tf_, uf, vf, pf, okf = sp.stream_closest(
            geom.st_tables, g(ray.o), g(ray.d), g(ray.mint, 1.0),
            g(mx_all, -1.0))
        rk = inv[:n]
        rkc = torch.clamp(rk, max=m_xl - 1)
        tf_, uf, vf, pf = tf_[rkc], uf[rkc], vf[rkc], pf[rkc]
        okf = okf[rkc] & (rk < m_xl)
    else:
        tf_, uf, vf, pf, okf = sp.stream_closest(
            geom.st_tables, ray.o, ray.d, ray.mint, mx_all)
    take = lane_ovf & okf & (~valid | (tf_ < t))
    return (torch.where(take, tf_, t), torch.where(take, uf, u),
            torch.where(take, vf, v), torch.where(take, pf, prim),
            torch.where(lane_ovf, okf | valid, valid))


def _fallback_any_stream(geom, ray, occ, lane_ovf):
    """Any-hit analog of _fallback_closest_stream (intersect.py:1218)."""
    n = ray.o.shape[0]
    r_xl = _retier_capacity(n)
    m_xl = r_xl * LANE_ROW
    lane_ovf = lane_ovf & ~occ
    mx_all = torch.where(lane_ovf, ray.maxt, -1.0)
    perm, inv, n_rows_ovf = _retier_perm(lane_ovf, n)
    if n_rows_ovf <= r_xl:
        sel = perm[:m_xl]

        def g(x, fill=0.0):
            return _gather_rows(x, perm, sel, n, fill)

        fb = sp.stream_any(geom.st_tables, g(ray.o), g(ray.d),
                           g(ray.mint, 1.0), g(mx_all, -1.0))
        rk = inv[:n]
        fb = fb[torch.clamp(rk, max=m_xl - 1)] & (rk < m_xl)
    else:
        fb = sp.stream_any(geom.st_tables, ray.o, ray.d, ray.mint, mx_all)
    return occ | (fb & lane_ovf)


def _cluster_closest(geom, ray, coherent):
    ray = _cap_root_exit(geom, ray)
    dif, coh, _xl = geom.ex_caps
    t, u, v, prim, valid, lane_ovf = ep.exact_closest(
        geom.ex_tables, ray.o, ray.d, ray.mint, ray.maxt,
        caps=coh if coherent else dif)
    lane_ovf = lane_ovf & (ray.mint <= ray.maxt)
    if bool(lane_ovf.any()):
        t, u, v, prim, valid, lane_ovf = _retier_closest(
            geom, ray, t, u, v, prim, valid, lane_ovf)
    if bool(lane_ovf.any()):
        t, u, v, prim, valid = _fallback_closest_stream(
            geom, ray, t, u, v, prim, valid, lane_ovf)
    return t, u, v, prim, valid


def _shade(geom, ray, t, u, v, prim, valid) -> Intersection:
    """The reference's generic hit record (intersect.py:1359-1481)."""
    prim_raw = torch.where(valid, prim, 0)
    p = ray.at(torch.where(valid, t, 1.0))   # finite on a miss
    w = 1.0 - u - v
    row = geom.shade_pack[prim_raw.long()]
    e1g, e2g = row[:, 0:3], row[:, 3:6]
    n0g, n1g, n2g = row[:, 6:9], row[:, 9:12], row[:, 12:15]
    uv0g, uv1g, uv2g = row[:, 15:17], row[:, 17:19], row[:, 19:21]
    ids = row[:, 21:24].contiguous().view(torch.int32)
    geo_n = m.normalize(m.cross(e1g, e2g))
    sh_n = m.normalize(w[:, None] * n0g + u[:, None] * n1g
                       + v[:, None] * n2g)
    uv = w[:, None] * uv0g + u[:, None] * uv1g + v[:, None] * uv2g
    # parametric dp_du from the uv chart, e1 where the chart degenerates
    duv1 = uv1g - uv0g
    duv2 = uv2g - uv0g
    det_uv = duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0]
    ok_uv = torch.abs(det_uv) > 1e-12
    inv_det = 1.0 / torch.where(ok_uv, det_uv, 1.0)
    dp_du = torch.where(
        ok_uv[:, None],
        (duv2[:, 1:2] * e1g - duv1[:, 1:2] * e2g) * inv_det[:, None], e1g)
    frame = m.Frame.from_normal_tangent(sh_n, dp_du)
    return Intersection(
        valid=valid,
        t=torch.where(valid, t, float("inf")),
        p=p,
        geo_n=geo_n,
        sh_n=sh_n,
        uv=uv,
        dp_du=dp_du,
        wi=frame.to_local(-ray.d),
        prim_id=torch.where(valid, prim_raw, -1),
        shape_id=torch.where(valid, ids[:, 2], -1),
        material_id=torch.where(valid, ids[:, 0], -1),
        emitter_id=torch.where(valid, ids[:, 1], -1),
    )


def ray_intersect(geom: GeometryTables, ray: Ray,
                  coherent: bool = False) -> Intersection:
    """Closest-hit query of the cluster backend -> Intersection.
    coherent: camera-like wavefront; the exact cull then runs at the small
    coherent caps."""
    if geom.backend != "cluster":
        raise NotImplementedError(
            "separate closest-hit queries are ported for the cluster "
            "backend only (brute: ray_intersect_and_test)")
    return _shade(geom, ray, *_cluster_closest(geom, ray, coherent))


def ray_test(geom: GeometryTables, ray: Ray):
    """Any-hit (shadow ray) query of the cluster backend -> occluded."""
    if geom.backend != "cluster":
        raise NotImplementedError(
            "separate any-hit queries are ported for the cluster backend "
            "only (brute: ray_intersect_and_test)")
    ray = _cap_root_exit(geom, ray)
    occ, lane_ovf = ep.exact_any(geom.ex_tables, ray.o, ray.d, ray.mint,
                                 ray.maxt, caps=geom.ex_caps[0])
    lane_ovf = lane_ovf & (ray.mint <= ray.maxt)
    if bool(lane_ovf.any()):
        occ, lane_ovf = _retier_any(geom, ray, occ, lane_ovf)
    if bool(lane_ovf.any()):
        occ = _fallback_any_stream(geom, ray, occ, lane_ovf)
    return occ
