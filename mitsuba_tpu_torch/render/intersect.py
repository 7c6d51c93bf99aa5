"""Ray–scene intersection on the brute, bvh and cluster backends, with
true instancing on the cluster backend and analytic spheres, cylinders
and hair (port of mitsuba_tpu/render/intersect.py).

Geometry lives in `GeometryTables`, SoA tensors of the triangle soup.

* brute (the "auto" choice up to 64 triangles): the triangles in input
  order and, as in the reference, a one-leaf BVH whose root box is the
  scene's bounds (intersect.py:261-271). The path tracer's
  `ray_intersect_and_test` runs the fused kernel #1 of `ops/intersect.py`
  once per bounce; `ray_intersect` runs #2 (closest hit with its shading
  record) and `ray_test` #3 (any hit), as the reference's TPU branches do
  (intersect.py:1266-1294, 1570-1575). Their tables, the (T, 29)
  shading table of #1 and #2 and the (T, 9) table of #3, are built once
  per `GeometryTables` (`brute_tables`). The record is the kernel path's
  (:1489-1518): the shading frame is `Frame.from_normal(sh_n)`, `dp_du`
  its s axis.
* bvh: the triangles in the order of a skip-link BVH (render/bvh.py); a
  closest query is one launch of the packet-BVH kernel's port
  (`ops/bvh.py`, bvh_closest), an any-hit query one of bvh_any
  (intersect.py:1343-1351, 1557-1565).
* cluster (the "auto" choice above 64 triangles): the BVH order cut into
  8-triangle clusters with an 8x box hierarchy for the exact cull
  (`ops/exact.py`) and into 32-triangle clusters, in superclusters of 8,
  for the complete stream walk (`ops/stream.py`) and the work list
  (`ops/worklist.py`). A query (`ray_intersect`, `ray_test`) clamps maxt
  to the root box, runs the exact cull at diffuse or coherent caps with
  the item walk `ex_walk` (by default v6b on the card, v5 on the CPU),
  re-runs rows that overflowed at the XL caps on a row-compacted subset,
  and resolves whatever still overflows through the stream kernel
  (intersect.py:1295-1319, 1523-1540).
* cluster with instances (`build_geometry(..., instanced=...)`): N
  instances of a group share one object-space copy of its 32-triangle
  blocks, and each instance cluster has a world box and a world->object
  map. There are no exact-cull tables; a query runs the work-list kernel
  and re-resolves the lanes of overflowing rows through the BVH kernel on
  the static triangles plus an exact walk of every instance, which is
  the same kernel on the group's own tables with the reference walk's
  reciprocal clamp (intersect.py:1329-1342, 1547-1556, 928-1000).
  Instanced hits carry virtual prim ids >= n_tris, which decode to the
  shared blocks.

Analytic spheres (`sph_*`, prim ids [T, T+S) after the T triangles) and
open cylinders (`cyl_*`, prim ids [T+S, T+S+C)) are intersected in plain
PyTorch against every ray after the triangles' query, on any backend,
and merged into its record where nearer; a shadow ray is also occluded
by a sphere or a cylinder (intersect.py:1579-1651, 1827-1941). Their
prim ids lie at or above n_tris, where an instanced hit's virtual prims
also start, and every per-triangle lookup (textures, hit prediction, the
area lights' pdf) takes only prims below n_tris.

Analytic hair (`hair_*`, prim ids [T+S+C, T+S+C+H)) is a list of open
cylinder segments in a skip-link BVH of their own (`build_bvh_boxes`),
walked in plain PyTorch after the analytic merge, on any backend, as the
reference walks it in XLA (intersect.py:1717): a lane tests one segment
or visits one node a step; the host reads the lanes' liveness every
_HAIR_CHECK_EVERY steps, and compacts the live lanes when fewer than
half still walk.

Off the brute backend the hit record comes from the reference's generic
tail (intersect.py:1359-1481): one packed `shade_pack` row per hit (the
shared block's attributes, rotated to world space, for an instanced
hit), `dp_du` from the uv chart, and the frame
`Frame.from_normal_tangent(sh_n, dp_du)` — not the brute path's frame.

Each `lax.cond` of the reference is a Python branch on a device-side
`any()`.
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass

import numpy as np
import torch

from mitsuba_tpu_torch.core import math as m
from mitsuba_tpu_torch.ops import bvh as bp
from mitsuba_tpu_torch.ops import exact as ep
from mitsuba_tpu_torch.ops import intersect as ip
from mitsuba_tpu_torch.ops import stream as sp
from mitsuba_tpu_torch.ops import worklist as wl
from mitsuba_tpu_torch.render.bvh import MAX_LEAF, build_bvh, build_bvh_boxes
from mitsuba_tpu_torch.render.clusters import (
    MTTables, build_instanced_tables, build_mt_tables, cut_clusters,
)
from mitsuba_tpu_torch.render.records import Intersection, Ray

LANE_ROW = 128
BRUTE_MAX_TRIS = 64     # "auto" picks brute up to here, cluster above
MT_K = 32               # triangles per work-list / stream cluster
# the reference's exact XLA walk clamps |d| in its slab reciprocals at
# this (m.safe_rcp), where the BVH kernel clamps at 1e-12
_WALK_RCP_EPS = 1e-20


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
    # the flattened BVH; brute: the root box alone (M = 1)
    bvh_min: torch.Tensor = None     # (M, 3) node boxes, row 0 = root
    bvh_max: torch.Tensor = None
    # bvh and cluster backends (None on brute): the rest of the BVH
    bvh_first: torch.Tensor = None   # (M,) int32 leaf: first triangle
    bvh_count: torch.Tensor = None   # (M,) int32 leaf size, 0 = inner
    bvh_skip: torch.Tensor = None    # (M,) int32 next node after a miss
    bvh_packed: torch.Tensor = None  # (M, 9) bmin|bmax|first|count|skip
    tri_packed: torch.Tensor = None  # (T, 9) v0|e1|e2
    # the same as the BVH kernel's 16-byte records (ops/bvh.py
    # align_tables): (M, 8) bmin|skip|bmax|first*8+count, (T, 12)
    bvh_aligned: torch.Tensor = None
    tri_aligned: torch.Tensor = None
    # the shading record in one row: e1|e2|n0|n1|n2|uv0|uv1|uv2|
    # mid|eid|sid (ints bitcast to float32)
    shade_pack: torch.Tensor = None  # (T, 24)
    # cluster backend: K = 32 clusters in superclusters of 8
    mt_tri: torch.Tensor = None      # (B, K, 16) blocks (shared, instanced)
    mt_start: torch.Tensor = None    # (C,) int32 prim base per cluster
    mt_bmin: torch.Tensor = None     # (C, 3) world cluster boxes
    mt_bmax: torch.Tensor = None
    cl_sc_bmin: torch.Tensor = None  # (C_s, 3)
    cl_sc_bmax: torch.Tensor = None
    sc_tri: torch.Tensor = None      # (C_s, 32, 128) lane = cluster*16+field
    # exact-cull tables (cluster, no instances): K8 clusters, 8x boxes
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
    # the item walk of the exact cull: "v5", "v6", "v6b", or None for the
    # device's default (v6b on the card, v5 on the CPU; ops/exact.py)
    ex_walk: str = None
    # true instancing (cluster): virtual prims >= n_tris decode to
    # (cluster, local) and shade through the block-aligned obj_* tables
    mt_block_id: torch.Tensor = None   # (C,) int32 cluster -> shared block
    mt_xform: torch.Tensor = None      # (C, 16) world->object 3x4 rows
    mt_xform_fwd: torch.Tensor = None  # (C, 12) object->world 3x4 rows
    obj_v0: torch.Tensor = None        # (B*K, 3) block-aligned object tris
    obj_e1: torch.Tensor = None
    obj_e2: torch.Tensor = None
    obj_n0: torch.Tensor = None
    obj_n1: torch.Tensor = None
    obj_n2: torch.Tensor = None
    obj_uv0: torch.Tensor = None       # (B*K, 2)
    obj_uv1: torch.Tensor = None
    obj_uv2: torch.Tensor = None
    obj_mid: torch.Tensor = None       # (B*K,) int32 material ids
    obj_sid: torch.Tensor = None       # (B*K,) int32 shape ids
    # the exact per-instance walks: each group's object-space geometry,
    # its triangle -> cluster*K + local map, and per instance the
    # world->object rows, group index and virtual prim base
    inst_groups: tuple = ()            # GeometryTables per group
    inst_tri2virt: tuple = ()          # (T_g,) int32 per group
    inst_xf_inv: torch.Tensor = None   # (I, 12)
    inst_gid: tuple = ()
    inst_vp_base: tuple = ()
    n_static_clusters: int = 0
    # analytic spheres (reference src/shapes/sphere.cpp: exact quadratic
    # intersection, not tessellated); prim ids [T, T+S) are spheres
    sph_c: torch.Tensor = None         # (S, 3) centres
    sph_r: torch.Tensor = None         # (S,) radii
    sph_mid: torch.Tensor = None       # (S,) int32 material ids
    sph_eid: torch.Tensor = None       # (S,) int32 emitter ids, -1 = none
    sph_sid: torch.Tensor = None       # (S,) int32 shape ids
    # analytic open cylinders (reference src/shapes/cylinder.cpp: no end
    # caps); prim ids [T+S, T+S+C) are cylinders
    cyl_a: torch.Tensor = None         # (C, 3) axis start
    cyl_b: torch.Tensor = None         # (C, 3) axis end
    cyl_r: torch.Tensor = None         # (C,) radii
    cyl_mid: torch.Tensor = None       # (C,) int32 material ids
    cyl_eid: torch.Tensor = None       # (C,) int32 emitter ids, -1 = none
    cyl_sid: torch.Tensor = None       # (C,) int32 shape ids
    # analytic hair (reference src/shapes/hair.cpp: exact per-segment
    # cylinders): the segments in the order of their own skip-link BVH;
    # prim ids [T+S+C, T+S+C+H) are segments
    hair_nodes: torch.Tensor = None    # (Mh, 9) bmin|bmax|first|count|skip
    hair_segs: torch.Tensor = None     # (H, 16) a|b|r|u0|u1|mid|eid|sid|0
    mt_k: int = MT_K
    backend: str = "brute"

    @property
    def n_tris(self):
        return self.v0.shape[0]

    @property
    def has_instances(self):
        return self.mt_block_id is not None

    @property
    def n_spheres(self):
        return 0 if self.sph_r is None else self.sph_r.shape[0]

    @property
    def n_cylinders(self):
        return 0 if self.cyl_r is None else self.cyl_r.shape[0]

    @property
    def n_hair(self):
        return 0 if self.hair_segs is None else self.hair_segs.shape[0]

    @property
    def has_analytic(self):
        return self.n_spheres + self.n_cylinders > 0

    @property
    def bvh_tables(self):
        """The BVH queries' tables: (nodes, tris) and, as keywords, the
        kernel's aligned copies."""
        return ((self.bvh_packed, self.tri_packed),
                dict(aligned=(self.bvh_aligned, self.tri_aligned)))

    @functools.cached_property
    def brute_tables(self):
        """The brute kernels' tables, built at the first query and kept
        with these tables: the (T, 29) shading table of #1 and #2 and the
        (T, 9) `v0|e1|e2` table of #3."""
        return (ip.make_shading_table(self),
                ip.make_tri_table(self.v0, self.e1, self.e2))

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

    @property
    def wl_tables(self):
        d = dict(tri=self.mt_tri, tri_start=self.mt_start,
                 bmin=self.mt_bmin, bmax=self.mt_bmax,
                 sc_bmin=self.cl_sc_bmin, sc_bmax=self.cl_sc_bmax)
        if self.has_instances:
            d.update(block_id=self.mt_block_id, xform=self.mt_xform)
        return d

    def to(self, device) -> "GeometryTables":
        """The tables, the instance groups' included, on `device`."""
        def move(x):
            if isinstance(x, torch.Tensor):
                return x.to(device)
            if isinstance(x, GeometryTables):
                return x.to(device)
            if isinstance(x, tuple):
                return tuple(move(y) for y in x)
            return x

        return dataclasses.replace(self, **{
            f.name: move(getattr(self, f.name))
            for f in dataclasses.fields(self)})


def _pad_boxes(lo, hi, mult=128):
    """Pad a box list to a multiple of `mult` with far-away degenerate
    boxes (intersect.py:194: 2e30 corners land beyond every clamped maxt;
    not +-inf, whose slab arithmetic gives NaN)."""
    pad = (-lo.shape[0]) % mult
    if pad:
        lo = np.concatenate([lo, np.full((pad, 3), 2e30, np.float32)])
        hi = np.concatenate([hi, np.full((pad, 3), 2e30, np.float32)])
    return lo, hi


def _dev(x):
    return torch.as_tensor(np.ascontiguousarray(x))


def build_geometry(meshes_with_ids, backend: str = "auto",
                   instanced=None, ex_walk=None,
                   spheres=(), cylinders=(), hair=None) -> GeometryTables:
    """Assemble GeometryTables from [(TriMesh, material_id, emitter_id
    [, shape_id]), ...]. backend: 'brute' keeps the input order and
    builds no tree, only the root box; 'bvh' orders the triangles by a
    BVH; 'cluster' also builds the cluster tables; 'auto' is cluster
    above 64 triangles, brute below (intersect.py:257); the analytic
    spheres [(centre, radius, material_id, emitter_id, shape_id), ...]
    and cylinders [(p0, p1, radius, material_id, emitter_id, shape_id),
    ...] count for neither choice nor box, nor do the hair segments
    dict(a, b, r, u0, u1, mid, eid, sid) (`_pack_hair`). instanced:
    (groups, instances) for
    true instancing on the cluster backend, groups = [[(TriMesh in object
    space, material_id, shape_id), ...], ...] and instances = [(group
    index, 4x4 to_world), ...]. ex_walk: the exact cull's item walk
    (GeometryTables.ex_walk). Host numpy, as in the reference."""
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
    if backend == "auto":
        backend = "cluster" if f.shape[0] > BRUTE_MAX_TRIS else "brute"
    if backend not in ("brute", "bvh", "cluster"):
        raise ValueError(f"unknown intersection backend '{backend}'")
    if instanced and instanced[1] and backend != "cluster":
        raise ValueError("true instancing requires the cluster backend")

    # brute force needs no tree: a single leaf covering everything
    tables = dict(bvh_min=v.min(axis=0, keepdims=True).astype(np.float32),
                  bvh_max=v.max(axis=0, keepdims=True).astype(np.float32))
    if backend != "brute":
        bvh = build_bvh(v, f)
        p = bvh.perm
        f = f[p]
        mid, eid, sid = mid[p], eid[p], sid[p]
        tables = _bvh_tables(bvh, v[f], n[f], uv[f], mid, eid, sid)
    tri = v[f]  # (T, 3, 3)
    if backend == "cluster":
        inst = instanced if instanced and instanced[1] else None
        tables.update(_build_cluster(tri, bvh, exact=inst is None))
        if inst is not None:
            tables.update(_build_instanced(tables, tri.shape[0], *inst))
    caps = tables.pop("ex_caps", None)
    if spheres:
        tables.update(
            sph_c=np.asarray([x[0] for x in spheres], np.float32),
            sph_r=np.asarray([x[1] for x in spheres], np.float32),
            sph_mid=np.asarray([x[2] for x in spheres], np.int32),
            sph_eid=np.asarray([x[3] for x in spheres], np.int32),
            sph_sid=np.asarray([x[4] for x in spheres], np.int32))
    if cylinders:
        tables.update(
            cyl_a=np.asarray([x[0] for x in cylinders], np.float32),
            cyl_b=np.asarray([x[1] for x in cylinders], np.float32),
            cyl_r=np.asarray([x[2] for x in cylinders], np.float32),
            cyl_mid=np.asarray([x[3] for x in cylinders], np.int32),
            cyl_eid=np.asarray([x[4] for x in cylinders], np.int32),
            cyl_sid=np.asarray([x[5] for x in cylinders], np.int32))
    if hair is not None and hair["a"].shape[0] > 0:
        tables.update(_pack_hair(hair))
    return GeometryTables(
        **{k: (_dev(x) if isinstance(x, np.ndarray) else x)
           for k, x in tables.items()},
        ex_caps=caps,
        ex_walk=ex_walk,
        backend=backend,
        v0=_dev(tri[:, 0]),
        e1=_dev(tri[:, 1] - tri[:, 0]),
        e2=_dev(tri[:, 2] - tri[:, 0]),
        n0=_dev(n[f[:, 0]]), n1=_dev(n[f[:, 1]]), n2=_dev(n[f[:, 2]]),
        uv0=_dev(uv[f[:, 0]]), uv1=_dev(uv[f[:, 1]]), uv2=_dev(uv[f[:, 2]]),
        material_id=_dev(mid), emitter_id=_dev(eid), shape_id=_dev(sid),
    )


def _bvh_tables(bvh, tri, nrm, uvc, mid, eid, sid):
    """numpy BVH and shading tables (intersect.py:476-504) of the
    BVH-ordered soup tri (T, 3, 3) with per-corner normals nrm (T, 3, 3)
    and uvs uvc (T, 3, 2)."""
    e1, e2 = tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
    nodes = np.concatenate(
        [bvh.bounds_min, bvh.bounds_max,
         bvh.first[:, None].astype(np.float32),
         bvh.count[:, None].astype(np.float32),
         bvh.skip[:, None].astype(np.float32)], axis=1)
    shade = np.concatenate(
        [e1.astype(np.float32), e2.astype(np.float32),
         nrm[:, 0].astype(np.float32), nrm[:, 1].astype(np.float32),
         nrm[:, 2].astype(np.float32),
         uvc[:, 0].astype(np.float32), uvc[:, 1].astype(np.float32),
         uvc[:, 2].astype(np.float32),
         mid.astype(np.int32).view(np.float32)[:, None],
         eid.astype(np.int32).view(np.float32)[:, None],
         sid.astype(np.int32).view(np.float32)[:, None]], axis=1)
    nodes = nodes.astype(np.float32)
    tris = np.concatenate([tri[:, 0], e1, e2], axis=1).astype(np.float32)
    aligned = bp.align_tables(torch.from_numpy(nodes),
                              torch.from_numpy(tris))
    return dict(
        bvh_min=bvh.bounds_min, bvh_max=bvh.bounds_max,
        bvh_first=bvh.first, bvh_count=bvh.count, bvh_skip=bvh.skip,
        bvh_packed=nodes, tri_packed=tris,
        bvh_aligned=aligned[0].numpy(), tri_aligned=aligned[1].numpy(),
        shade_pack=shade)


def _build_cluster(tri, bvh, exact: bool):
    """numpy cluster tables (intersect.py:278-328) of the BVH-ordered
    soup tri (T, 3, 3): the 32-triangle work-list and stream tables and,
    if `exact`, the exact-cull tables."""
    n_t = tri.shape[0]
    v0, e1, e2 = tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
    mt = build_mt_tables(v0, e1, e2, cut_clusters(
        bvh.first, bvh.count, bvh.skip, n_t, max_k=MT_K), k=MT_K)
    c, k, f = mt.tri.shape
    out = dict(
        mt_tri=mt.tri, mt_start=mt.tri_start, mt_bmin=mt.bmin,
        mt_bmax=mt.bmax, cl_sc_bmin=mt.sc_bmin, cl_sc_bmax=mt.sc_bmax,
        sc_tri=mt.tri.reshape(c // 8, 8, k, f).transpose(0, 2, 1, 3)
        .reshape(c // 8, k, 8 * f))
    if not exact:
        return out
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
    out.update(
        ex_tri=tri128, ex_b0lo=mt8.bmin, ex_b0hi=mt8.bmax,
        ex_b1lo=b1lo, ex_b1hi=b1hi, ex_b2lo=b2lo, ex_b2hi=b2hi,
        ex_ct0=ep.pack_child_table(mt8.bmin, mt8.bmax),
        ex_ct1=ep.pack_child_table(b1lo, b1hi),
        ex_ct2=ep.pack_child_table(*_pad_boxes(b2lo, b2hi)),
        ex_caps=ep.auto_caps(c8),
    )
    return out


def _build_instanced(static, n_static_tris, groups, instances):
    """numpy instancing tables (intersect.py:329-426): the static tables'
    work-list blocks joined by each group's shared object-space blocks,
    the block-aligned object attributes, and the side tables of the exact
    per-instance walks."""
    sub = [build_geometry([(msh, mi, -1, si) for msh, mi, si in items],
                          backend="cluster") for items in groups]
    static_mt = MTTables(static["mt_tri"], static["mt_start"],
                         static["mt_bmin"], static["mt_bmax"],
                         static["cl_sc_bmin"], static["cl_sc_bmax"])
    group_mts = [MTTables(*(x.numpy() for x in (
        g.mt_tri, g.mt_start, g.mt_bmin, g.mt_bmax, g.cl_sc_bmin,
        g.cl_sc_bmax))) for g in sub]
    it = build_instanced_tables(static_mt, n_static_tris, group_mts,
                                instances, k=MT_K)
    n_blocks = it.tri.shape[0]
    base0 = static_mt.tri.shape[0]

    def blk(field, width):
        # block-aligned rows [block * K + local]; static blocks stay zero
        # (their prims shade through the world tables)
        out = np.zeros((n_blocks * MT_K, width), np.float32) if width > 1 \
            else np.zeros(n_blocks * MT_K, np.int32)
        base = base0
        for g, gmt in zip(sub, group_mts):
            src = getattr(g, field).numpy()
            for ci, s in enumerate(gmt.tri_start.tolist()):
                cnt = min(MT_K, src.shape[0] - s) if s < src.shape[0] else 0
                if cnt > 0:
                    out[(base + ci) * MT_K:(base + ci) * MT_K + cnt] = \
                        src[s:s + cnt]
            base += gmt.tri.shape[0]
        return out

    tri2virt = []
    for g, gmt in zip(sub, group_mts):
        t2v = np.zeros(g.n_tris, np.int64)
        for ci, s in enumerate(gmt.tri_start.tolist()):
            cnt = min(MT_K, g.n_tris - s) if s < g.n_tris else 0
            if cnt > 0:
                t2v[s:s + cnt] = ci * MT_K + np.arange(cnt)
        tri2virt.append(_dev(t2v.astype(np.int32)))
    vp_base, xf_inv = [], []
    ccur = it.n_static_clusters
    for gi, m4 in instances:
        vp_base.append(n_static_tris + (ccur - it.n_static_clusters) * MT_K)
        ccur += group_mts[gi].tri.shape[0]
        inv = np.linalg.inv(np.asarray(m4, np.float64))
        xf_inv.append(inv[:3, :4].reshape(-1))
    return dict(
        mt_tri=it.tri, mt_start=it.tri_start, mt_bmin=it.bmin,
        mt_bmax=it.bmax, cl_sc_bmin=it.sc_bmin, cl_sc_bmax=it.sc_bmax,
        sc_tri=None,
        mt_block_id=it.block_id, mt_xform=it.xform,
        mt_xform_fwd=it.xform_fwd,
        obj_v0=blk("v0", 3), obj_e1=blk("e1", 3), obj_e2=blk("e2", 3),
        obj_n0=blk("n0", 3), obj_n1=blk("n1", 3), obj_n2=blk("n2", 3),
        obj_uv0=blk("uv0", 2), obj_uv1=blk("uv1", 2),
        obj_uv2=blk("uv2", 2),
        obj_mid=blk("material_id", 1), obj_sid=blk("shape_id", 1),
        n_static_clusters=it.n_static_clusters,
        inst_groups=tuple(sub), inst_tri2virt=tuple(tri2virt),
        inst_xf_inv=np.asarray(xf_inv, np.float32),
        inst_gid=tuple(int(g) for g, _ in instances),
        inst_vp_base=tuple(int(x) for x in vp_base),
    )


# ---------------------------------------------------------------------------
# brute backend: the kernels of ops/intersect.py
# ---------------------------------------------------------------------------

def _brute_record(ray: Ray, r) -> Intersection:
    """The Intersection of a brute kernel's record dict, as the
    reference's TPU branches build it (intersect.py:1266-1294,
    1497-1517)."""
    valid = r["valid"]
    # finite position on a miss: inf positions would NaN the masked lanes
    p = ray.at(torch.where(valid, r["t"], 1.0))
    frame = m.Frame.from_normal(r["sh_n"])
    return Intersection(
        valid=valid,
        t=torch.where(valid, r["t"], float("inf")),
        p=p,
        geo_n=r["geo_n"],
        sh_n=r["sh_n"],
        uv=r["uv"],
        dp_du=frame.s,
        wi=frame.to_local(-ray.d),
        prim_id=torch.where(valid, r["prim"], -1),
        shape_id=torch.where(valid, r["shape_id"], -1),
        material_id=torch.where(valid, r["material_id"], -1),
        emitter_id=torch.where(valid, r["emitter_id"], -1),
    )


def _fused_brute(geom: GeometryTables, ray: Ray, sray: Ray):
    """Closest hit (ray) and shadow any-hit (sray) on the brute backend:
    one launch of the fused kernel #1 with a shared triangle loop.
    Returns (Intersection, occluded)."""
    r, occ = ip.closest_hit_shaded_and_any(
        geom.brute_tables[0], *_ray_args(ray), *_ray_args(sray))
    return _brute_record(ray, r), occ


def _ray_args(ray: Ray):
    return (ray.o.contiguous(), ray.d.contiguous(), ray.mint.contiguous(),
            ray.maxt.contiguous())


# ---------------------------------------------------------------------------
# the exact skip-link walk (instance walks) and the instances
# ---------------------------------------------------------------------------

def _walk(geom: GeometryTables, ray: Ray, any_hit: bool):
    """The reference's exact XLA walk (`_walk_phased`, `_closest_bvh`,
    `_any_bvh`, intersect.py:677-801): per lane the same skip-link walk
    as the BVH kernel's, with the walk's own reciprocal clamp, so it runs
    through that kernel (its plain version on the CPU). Returns (t, u, v,
    prim, valid) (prim = -1 on a miss), or the occlusion mask."""
    fn = bp.bvh_any if any_hit else bp.bvh_closest
    tabs, kw = geom.bvh_tables
    return fn(*tabs, *_ray_args(ray), rcp_eps=_WALK_RCP_EPS, **kw)


def _xf_ray(ray: Ray, xf_row) -> Ray:
    """The ray under a (12,) world->object 3x4 row; t is invariant (the
    direction transforms linearly, no renormalisation; intersect.py:757).
    """
    mm = xf_row.reshape(3, 4)
    o = torch.stack([mm[r, 0] * ray.o[:, 0] + mm[r, 1] * ray.o[:, 1]
                     + mm[r, 2] * ray.o[:, 2] + mm[r, 3] for r in range(3)],
                    dim=-1)
    d = torch.stack([mm[r, 0] * ray.d[:, 0] + mm[r, 1] * ray.d[:, 1]
                     + mm[r, 2] * ray.d[:, 2] for r in range(3)], dim=-1)
    return Ray(o, d, ray.mint, ray.maxt)


def _instance_walks(geom, ray, any_hit):
    """Every instance's exact walk of `ray`, the instances of one group in
    one walk over their stacked object-space rays; per instance, in
    instance order, the walk's (t, u, v, prim, valid) or occlusion."""
    n = ray.o.shape[0]
    out = [None] * len(geom.inst_gid)
    for gi, sub in enumerate(geom.inst_groups):
        ids = [ii for ii, g in enumerate(geom.inst_gid) if g == gi]
        if not ids:
            continue
        rs = [_xf_ray(ray, geom.inst_xf_inv[ii]) for ii in ids]
        res = _walk(sub, Ray(*(torch.cat([getattr(r, f) for r in rs])
                              for f in ("o", "d", "mint", "maxt"))),
                    any_hit)
        for j, ii in enumerate(ids):
            out[ii] = (res[j * n:(j + 1) * n] if any_hit else
                       tuple(x[j * n:(j + 1) * n] for x in res))
    return out


def _instances_closest(geom, ray, t_best, u_b, v_b, prim_b, valid_b):
    """Exact closest hit against every instance by its group's walk,
    merged into the incoming best record in instance order; instanced
    prims are virtual ids >= n_tris (intersect.py:766). The reference
    caps each walk by the best t so far; uncapped walks give the same
    record, since a walk's closest hit below the cap is found with or
    without it and the merge keeps only strictly closer hits."""
    for ii, (t, u, v, p, ok) in enumerate(
            _instance_walks(geom, ray, any_hit=False)):
        gi = geom.inst_gid[ii]
        closer = ok & (t < t_best)
        vp = geom.inst_vp_base[ii] + geom.inst_tri2virt[gi][
            torch.clamp(p, 0, geom.inst_groups[gi].n_tris - 1).long()]
        t_best = torch.where(closer, t, t_best)
        u_b = torch.where(closer, u, u_b)
        v_b = torch.where(closer, v, v_b)
        prim_b = torch.where(closer, vp, prim_b)
        valid_b = valid_b | closer
    return t_best, u_b, v_b, prim_b, valid_b


def _instances_any(geom, ray):
    """Any hit against every instance by its group's walk (:788)."""
    occ = torch.zeros(ray.o.shape[0], dtype=torch.bool, device=ray.o.device)
    for hit in _instance_walks(geom, ray, any_hit=True):
        occ = occ | hit
    return occ


def _fallback_closest(geom, ray, t, u, v, prim, valid, lane_ovf):
    """Re-resolve the overflow lanes of a partial work-list result: the
    BVH kernel on the static triangles, then the exact instance walks on
    those lanes alone, capped by any hit found so far (intersect.py:928).
    """
    fb_maxt = torch.where(valid & torch.isfinite(t), t, ray.maxt)
    mx = torch.where(lane_ovf, fb_maxt, -1.0)
    fb = Ray(ray.o, ray.d, ray.mint, mx)
    tabs, kw = geom.bvh_tables
    tf_, uf, vf, pf, okf = bp.bvh_closest(*tabs, *_ray_args(fb), **kw)
    if geom.has_instances:
        idx = torch.nonzero(lane_ovf)[:, 0]
        sub = Ray(fb.o[idx], fb.d[idx], fb.mint[idx], fb.maxt[idx])
        r = _instances_closest(geom, sub, tf_[idx], uf[idx], vf[idx],
                               pf[idx], okf[idx])
        tf_, uf, vf, pf, okf = (x.index_put((idx,), y) for x, y in zip(
            (tf_, uf, vf, pf, okf), r))
    take = lane_ovf & okf & (~valid | (tf_ < t))
    return (torch.where(take, tf_, t), torch.where(take, uf, u),
            torch.where(take, vf, v), torch.where(take, pf, prim),
            torch.where(lane_ovf, okf | valid, valid))


def _fallback_any(geom, ray, occ, lane_ovf):
    """Any-hit analog of _fallback_closest (intersect.py:976)."""
    lane_ovf = lane_ovf & ~occ
    mx = torch.where(lane_ovf, ray.maxt, -1.0)
    fb = Ray(ray.o, ray.d, ray.mint, mx)
    tabs, kw = geom.bvh_tables
    hit = bp.bvh_any(*tabs, *_ray_args(fb), **kw)
    if geom.has_instances:
        idx = torch.nonzero(lane_ovf)[:, 0]
        sub = Ray(fb.o[idx], fb.d[idx], fb.mint[idx], fb.maxt[idx])
        hit = hit.index_put((idx,), hit[idx] | _instances_any(geom, sub))
    return occ | (hit & lane_ovf)


def _lane_overflow(ovf, ray):
    """Per-row overflow flags (R,) -> per-lane, live lanes only."""
    n = ray.o.shape[0]
    return torch.repeat_interleave(ovf, LANE_ROW)[:n] & (ray.mint <= ray.maxt)


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
        caps=geom.ex_caps[2], walk=geom.ex_walk)
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
                              caps=geom.ex_caps[2], walk=geom.ex_walk)
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
        caps=coh if coherent else dif, walk=geom.ex_walk)
    lane_ovf = lane_ovf & (ray.mint <= ray.maxt)
    if bool(lane_ovf.any()):
        t, u, v, prim, valid, lane_ovf = _retier_closest(
            geom, ray, t, u, v, prim, valid, lane_ovf)
    if bool(lane_ovf.any()):
        t, u, v, prim, valid = _fallback_closest_stream(
            geom, ray, t, u, v, prim, valid, lane_ovf)
    return t, u, v, prim, valid


def _cluster_any(geom, ray):
    ray = _cap_root_exit(geom, ray)
    occ, lane_ovf = ep.exact_any(geom.ex_tables, ray.o, ray.d, ray.mint,
                                 ray.maxt, caps=geom.ex_caps[0],
                                 walk=geom.ex_walk)
    lane_ovf = lane_ovf & (ray.mint <= ray.maxt)
    if bool(lane_ovf.any()):
        occ, lane_ovf = _retier_any(geom, ray, occ, lane_ovf)
    if bool(lane_ovf.any()):
        occ = _fallback_any_stream(geom, ray, occ, lane_ovf)
    return occ


def _worklist_closest(geom, ray):
    t, u, v, prim, valid, ovf = wl.wl_closest(geom.wl_tables,
                                              *_ray_args(ray))
    lane_ovf = _lane_overflow(ovf, ray)
    if bool(lane_ovf.any()):
        t, u, v, prim, valid = _fallback_closest(
            geom, ray, t, u, v, prim, valid, lane_ovf)
    return t, u, v, prim, valid


def _worklist_any(geom, ray):
    occ, ovf = wl.wl_any(geom.wl_tables, *_ray_args(ray))
    lane_ovf = _lane_overflow(ovf, ray)
    if bool(lane_ovf.any()):
        occ = _fallback_any(geom, ray, occ, lane_ovf)
    return occ


# ---------------------------------------------------------------------------
# the hit record
# ---------------------------------------------------------------------------

def _shade(geom, ray, t, u, v, prim, valid) -> Intersection:
    """The reference's generic hit record (intersect.py:1359-1481)."""
    prim_raw = torch.where(valid, prim, 0)
    is_inst = torch.zeros_like(valid)
    if geom.has_instances:
        is_inst = valid & (prim_raw >= geom.n_tris)
    prim_s = torch.where(is_inst, 0, prim_raw)
    p = ray.at(torch.where(valid, t, 1.0))   # finite on a miss
    w = 1.0 - u - v
    row = geom.shade_pack[prim_s.long()]
    e1g, e2g = row[:, 0:3], row[:, 3:6]
    n0g, n1g, n2g = row[:, 6:9], row[:, 9:12], row[:, 12:15]
    uv0g, uv1g, uv2g = row[:, 15:17], row[:, 17:19], row[:, 19:21]
    ids = row[:, 21:24].contiguous().view(torch.int32)
    material_id, emitter_id, shape_id = ids[:, 0], ids[:, 1], ids[:, 2]
    geo_n = m.normalize(m.cross(e1g, e2g))
    sh_n = m.normalize(w[:, None] * n0g + u[:, None] * n1g
                       + v[:, None] * n2g)
    uv = w[:, None] * uv0g + u[:, None] * uv1g + v[:, None] * uv2g
    if geom.has_instances:
        # virtual prims decode to (cluster, local) and shade from the
        # shared block tables, directions rotated to world space (by the
        # forward 3x3; normals by the stored world->object rows
        # transposed, the inverse transpose)
        k = geom.mt_k
        vp = torch.clamp(prim_raw - geom.n_tris, min=0)
        vcid = torch.clamp(geom.n_static_clusters + vp // k, 0,
                           geom.mt_block_id.shape[0] - 1).long()
        oid = (geom.mt_block_id[vcid].long() * k + vp % k).long()
        fwd = geom.mt_xform_fwd[vcid]
        inv = geom.mt_xform[vcid]

        def rot_fwd(x):
            return torch.stack(
                [fwd[:, 0] * x[:, 0] + fwd[:, 1] * x[:, 1]
                 + fwd[:, 2] * x[:, 2],
                 fwd[:, 4] * x[:, 0] + fwd[:, 5] * x[:, 1]
                 + fwd[:, 6] * x[:, 2],
                 fwd[:, 8] * x[:, 0] + fwd[:, 9] * x[:, 1]
                 + fwd[:, 10] * x[:, 2]], dim=-1)

        def rot_normal(x):
            return torch.stack(
                [inv[:, 0] * x[:, 0] + inv[:, 4] * x[:, 1]
                 + inv[:, 8] * x[:, 2],
                 inv[:, 1] * x[:, 0] + inv[:, 5] * x[:, 1]
                 + inv[:, 9] * x[:, 2],
                 inv[:, 2] * x[:, 0] + inv[:, 6] * x[:, 1]
                 + inv[:, 10] * x[:, 2]], dim=-1)

        e1w = rot_fwd(geom.obj_e1[oid])
        e2w = rot_fwd(geom.obj_e2[oid])
        n_obj = (w[:, None] * geom.obj_n0[oid] + u[:, None] * geom.obj_n1[oid]
                 + v[:, None] * geom.obj_n2[oid])
        uv_i = (w[:, None] * geom.obj_uv0[oid]
                + u[:, None] * geom.obj_uv1[oid]
                + v[:, None] * geom.obj_uv2[oid])
        mask = is_inst[:, None]
        geo_n = torch.where(mask, m.normalize(m.cross(e1w, e2w)), geo_n)
        sh_n = torch.where(mask, m.normalize(rot_normal(n_obj)), sh_n)
        uv = torch.where(mask, uv_i, uv)
        material_id = torch.where(is_inst, geom.obj_mid[oid], material_id)
        emitter_id = torch.where(is_inst, -1, emitter_id)
        shape_id = torch.where(is_inst, geom.obj_sid[oid], shape_id)
    dp_du = _dp_du(uv0g, uv1g, uv2g, e1g, e2g)
    if geom.has_instances:
        dp_du = torch.where(is_inst[:, None], _dp_du(
            geom.obj_uv0[oid], geom.obj_uv1[oid], geom.obj_uv2[oid], e1w,
            e2w), dp_du)
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
        shape_id=torch.where(valid, shape_id, -1),
        material_id=torch.where(valid, material_id, -1),
        emitter_id=torch.where(valid, emitter_id, -1),
    )


def _dp_du(uv0, uv1, uv2, e1, e2):
    """Parametric dp_du from the uv chart, e1 where it degenerates."""
    duv1 = uv1 - uv0
    duv2 = uv2 - uv0
    det_uv = duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0]
    ok_uv = torch.abs(det_uv) > 1e-12
    inv_det = 1.0 / torch.where(ok_uv, det_uv, 1.0)
    return torch.where(
        ok_uv[:, None],
        (duv2[:, 1:2] * e1 - duv1[:, 1:2] * e2) * inv_det[:, None], e1)


# ---------------------------------------------------------------------------
# analytic spheres and cylinders: intersected in plain PyTorch against
# every ray (S and C are small) and merged with the triangle result,
# outside the kernels (intersect.py:1579-1651, 1827-1905)
# ---------------------------------------------------------------------------

def _sphere_closest(geom: GeometryTables, ray: Ray):
    """(t, sphere index, valid) of the nearest sphere hit: a loop over the
    spheres, each nearer hit taking over (intersect.py:1584)."""
    n = ray.o.shape[0]
    t_best = torch.full((n,), float("inf"), device=ray.o.device)
    idx = torch.zeros(n, dtype=torch.int64, device=ray.o.device)
    for si in range(geom.n_spheres):
        r = geom.sph_r[si]
        oc = ray.o - geom.sph_c[si][None]
        b = m.dot(oc, ray.d)
        cq = m.dot(oc, oc) - r * r
        disc = b * b - cq
        ok = disc >= 0.0
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        t0 = -b - sq
        t1 = -b + sq
        t = torch.where(ok & (t0 > ray.mint), t0,
                        torch.where(ok & (t1 > ray.mint), t1, float("inf")))
        t = torch.where(t < ray.maxt, t, float("inf"))
        better = t < t_best
        t_best = torch.where(better, t, t_best)
        idx = torch.where(better, si, idx)
    return t_best, idx, torch.isfinite(t_best)


def _cylinder_closest(geom: GeometryTables, ray: Ray):
    """(t, cylinder index, valid) of the nearest hit on an open cylinder
    (no end caps, cylinder.cpp): the ray's components across the axis
    solve the quadratic, a root counts between the axis' two ends; a loop
    over the cylinders as for the spheres (intersect.py:1614). A ray
    along the axis has A clamped at 1e-12: its roots, if any, lie far
    past the cylinder's ends."""
    n = ray.o.shape[0]
    t_best = torch.full((n,), float("inf"), device=ray.o.device)
    idx = torch.zeros(n, dtype=torch.int64, device=ray.o.device)
    for ci in range(geom.n_cylinders):
        a = geom.cyl_a[ci]
        ax = geom.cyl_b[ci] - a
        r = geom.cyl_r[ci]
        ln = torch.clamp(torch.sqrt(m.dot(ax, ax)), min=1e-12)
        u = ax / ln
        oc = ray.o - a[None]
        du = m.dot(ray.d, u[None])
        ou = m.dot(oc, u[None])
        dp = ray.d - du[:, None] * u[None]
        op = oc - ou[:, None] * u[None]
        A = torch.clamp(m.dot(dp, dp), min=1e-12)
        B = m.dot(dp, op)
        Cq = m.dot(op, op) - r * r
        disc = B * B - A * Cq
        ok = disc >= 0.0
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        t0 = (-B - sq) / A
        t1 = (-B + sq) / A

        def axial_ok(t):
            s_ax = ou + t * du
            return (s_ax >= 0.0) & (s_ax <= ln)

        ok0 = ok & (t0 > ray.mint) & axial_ok(t0)
        ok1 = ok & (t1 > ray.mint) & axial_ok(t1)
        t = torch.where(ok0, t0, torch.where(ok1, t1, float("inf")))
        t = torch.where(t < ray.maxt, t, float("inf"))
        better = t < t_best
        t_best = torch.where(better, t, t_best)
        idx = torch.where(better, ci, idx)
    return t_best, idx, torch.isfinite(t_best)


def _analytic_any(geom: GeometryTables, ray: Ray):
    """Occlusion by any sphere or cylinder (intersect.py:1827)."""
    occ = torch.zeros(ray.o.shape[0], dtype=torch.bool, device=ray.o.device)
    if geom.n_spheres:
        occ = occ | _sphere_closest(geom, ray)[2]
    if geom.n_cylinders:
        occ = occ | _cylinder_closest(geom, ray)[2]
    return occ


def _take(its: Intersection, closer, t, p, n, uv, dpdu, wi, prim, sid,
          mid, eid) -> Intersection:
    """The record with the lanes of `closer` taking an analytic hit."""
    def pick(a, b):
        return torch.where(closer[:, None] if b.dim() > 1 else closer, a, b)

    return Intersection(
        valid=its.valid | closer,
        t=pick(t, its.t),
        p=pick(p, its.p),
        geo_n=pick(n, its.geo_n),
        sh_n=pick(n, its.sh_n),
        uv=pick(uv, its.uv),
        dp_du=pick(dpdu, its.dp_du),
        wi=pick(wi, its.wi),
        prim_id=pick(prim.to(its.prim_id.dtype), its.prim_id),
        shape_id=pick(sid, its.shape_id),
        material_id=pick(mid, its.material_id),
        emitter_id=pick(eid, its.emitter_id),
    )


def _merge_analytic(geom: GeometryTables, ray: Ray,
                    its: Intersection) -> Intersection:
    """The triangle record with each lane whose nearest sphere, then
    whose nearest cylinder, is nearer taking its record (intersect.py:
    1838): the sphere's spherical uv of sphere.cpp, the cylinder's
    (azimuth about the axis, the axial fraction), each frame from the
    normal and dp/du."""
    T = geom.n_tris
    if geom.n_spheres:
        t, i, v = _sphere_closest(geom, ray)
        closer = v & (t < its.t)
        p = ray.at(torch.where(closer, t, 1.0))
        n = m.normalize(p - geom.sph_c[i])
        phi = torch.atan2(n[:, 1], n[:, 0])
        theta = torch.arccos(torch.clamp(n[:, 2], -1.0, 1.0))
        uv = torch.stack([phi * (0.5 / np.pi) + 0.5, theta / np.pi], -1)
        dpdu = m.normalize(torch.stack(
            [-n[:, 1], n[:, 0], torch.zeros_like(n[:, 0])], -1) + 1e-12)
        wi = m.Frame.from_normal_tangent(n, dpdu).to_local(-ray.d)
        its = _take(its, closer, t, p, n, uv, dpdu, wi, T + i,
                    geom.sph_sid[i], geom.sph_mid[i], geom.sph_eid[i])
    if geom.n_cylinders:
        t, i, v = _cylinder_closest(geom, ray)
        closer = v & (t < its.t)
        a = geom.cyl_a[i]
        ax = geom.cyl_b[i] - a
        ln = torch.clamp(torch.sqrt(m.dot(ax, ax)), min=1e-12)
        u_ax = ax / ln[:, None]
        p = ray.at(torch.where(closer, t, 1.0))
        s_ax = m.dot(p - a, u_ax)
        n = m.normalize(p - a - s_ax[:, None] * u_ax)
        lp = m.Frame.from_normal(u_ax).to_local(n)
        phi = torch.atan2(lp[:, 1], lp[:, 0])
        uv = torch.stack([phi * (0.5 / np.pi) + 0.5, s_ax / ln], -1)
        dpdu = m.normalize(m.cross(u_ax, n))
        wi = m.Frame.from_normal_tangent(n, dpdu).to_local(-ray.d)
        its = _take(its, closer, t, p, n, uv, dpdu, wi,
                    T + geom.n_spheres + i, geom.cyl_sid[i],
                    geom.cyl_mid[i], geom.cyl_eid[i])
    return its


# ---------------------------------------------------------------------------
# analytic hair: open-cylinder segments in a skip-link BVH of their own,
# walked in plain PyTorch after the triangles and the analytic merge
# (intersect.py:1654-1823); the reference runs this walk in XLA, outside
# its kernels
# ---------------------------------------------------------------------------

# the hair walk checks for live lanes, and compacts them, once every this
# many steps (each check is a host sync; the steps between leave a
# finished lane as it is, as the reference's body does)
_HAIR_CHECK_EVERY = 16
# steps of the hair walks since import (reset by callers that count)
HAIR_STEPS = {"closest": 0, "any": 0}


def _pack_hair(hair) -> dict:
    """numpy `hair_nodes` and `hair_segs` of the segments dict(a, b, r,
    u0, u1, mid, eid, sid) (intersect.py:1654): their BVH over the
    segments' boxes swept by r, the segments in its order."""
    a = np.asarray(hair["a"], np.float32)
    b = np.asarray(hair["b"], np.float32)
    r = np.asarray(hair["r"], np.float32)
    bvh = build_bvh_boxes(np.minimum(a, b) - r[:, None],
                          np.maximum(a, b) + r[:, None])
    perm = bvh.perm
    segs = np.zeros((a.shape[0], 16), np.float32)
    segs[:, 0:3] = a[perm]
    segs[:, 3:6] = b[perm]
    segs[:, 6] = r[perm]
    for col, k in ((7, "u0"), (8, "u1"), (9, "mid"), (10, "eid"),
                   (11, "sid")):
        segs[:, col] = np.asarray(hair[k], np.float32)[perm]
    nodes = np.concatenate(
        [bvh.bounds_min, bvh.bounds_max,
         bvh.first[:, None].astype(np.float32),
         bvh.count[:, None].astype(np.float32),
         bvh.skip[:, None].astype(np.float32)], axis=1)
    return dict(hair_nodes=nodes, hair_segs=segs)


def _cyl_seg_hit(o, d, rows, mint, tcap):
    """The open-cylinder test of segment rows (..., 16) against the rays
    o, d (..., 3), mint and tcap broadcasting with them (intersect.py:
    1683): (t, axial fraction, valid). A ray along the axis has A clamped
    at 1e-12."""
    a = rows[..., 0:3]
    ax = rows[..., 3:6] - a
    r = rows[..., 6]
    ln = torch.clamp(torch.sqrt(m.dot(ax, ax)), min=1e-12)
    u = ax / ln[..., None]
    oc = o - a
    du = m.dot(d, u)
    ou = m.dot(oc, u)
    dp = d - du[..., None] * u
    op = oc - ou[..., None] * u
    A = torch.clamp(m.dot(dp, dp), min=1e-12)
    B = m.dot(dp, op)
    Cq = m.dot(op, op) - r * r
    disc = B * B - A * Cq
    ok = disc >= 0.0
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t0 = (-B - sq) / A
    t1 = (-B + sq) / A

    def axial_ok(t):
        s_ax = ou + t * du
        return (s_ax >= 0.0) & (s_ax <= ln)

    ok0 = ok & (t0 > mint) & axial_ok(t0)
    ok1 = ok & (t1 > mint) & axial_ok(t1)
    t = torch.where(ok0, t0, torch.where(ok1, t1, float("inf")))
    valid = (ok0 | ok1) & (t < tcap)
    frac = torch.clamp((ou + t * du) / ln, 0.0, 1.0)
    return t, frac, valid


def _hair_walk(geom: GeometryTables, ray: Ray, any_hit: bool):
    """The stackless walk of the segment BVH (intersect.py:1717): a step
    tests one segment of the lane's current leaf, or else visits one
    node; the state is the reference's. Every _HAIR_CHECK_EVERY steps the
    host reads which lanes still walk, stops when none does, and compacts
    the walking lanes when fewer than half of the current ones still walk
    (a finished lane's state is left as it is, as the reference's body
    leaves it). The step cap is the reference's. Returns (t, frac,
    segment, valid)."""
    nodes, segs = geom.hair_nodes, geom.hair_segs
    m_nodes, n_segs = nodes.shape[0], segs.shape[0]
    cap = (MAX_LEAF + 1) * m_nodes + 8
    n = ray.o.shape[0]
    dev = ray.o.device
    z = torch.zeros(n, dtype=torch.int64, device=dev)
    out = dict(t=torch.where(torch.isfinite(ray.maxt), ray.maxt,
                             float("inf")),
               frac=torch.zeros(n, device=dev), prim=z,
               valid=torch.zeros(n, dtype=torch.bool, device=dev))
    st = dict(out, node=z, lf=z, lc=z, lk=z)
    o, d, mint, maxt = ray.o, ray.d, ray.mint, ray.maxt
    inv_d = m.safe_rcp(d)
    lanes = None          # the current lanes' indices (None: all)
    key = "any" if any_hit else "closest"

    def live_of(st):
        live = (st["node"] < m_nodes) | (st["lk"] < st["lc"])
        return live & ~st["valid"] if any_hit else live

    def put_back(st, lanes):
        for k in out:
            out[k] = st[k] if lanes is None \
                else out[k].index_copy(0, lanes, st[k])

    step = 0
    while step < cap:
        if step % _HAIR_CHECK_EVERY == 0:
            live = live_of(st)
            n_live = int(live.sum())
            if n_live == 0:
                break
            if n_live * 2 < live.shape[0]:
                put_back(st, lanes)
                sel = torch.nonzero(live).squeeze(1)
                lanes = sel if lanes is None else lanes[sel]
                st = {k: v[sel] for k, v in st.items()}
                o, d, mint, maxt, inv_d = (x[sel] for x in
                                           (o, d, mint, maxt, inv_d))
        step += 1
        HAIR_STEPS[key] += 1
        node, lf, lc, lk = st["node"], st["lf"], st["lc"], st["lk"]
        t_best, valid = st["t"], st["valid"]
        in_leaf = lk < lc
        if any_hit:
            in_leaf = in_leaf & ~valid
        si = torch.clamp(lf + torch.clamp(lk, max=MAX_LEAF - 1),
                         max=n_segs - 1)
        t, frac, hit = _cyl_seg_hit(o, d, segs[si], mint,
                                    torch.minimum(maxt, t_best))
        closer = in_leaf & hit & (t < t_best)
        st["t"] = t_best = torch.where(closer, t, t_best)
        st["frac"] = torch.where(closer, frac, st["frac"])
        st["prim"] = torch.where(closer, si, st["prim"])
        st["valid"] = valid = valid | closer
        lk = torch.where(in_leaf, lk + 1, lk)
        do_node = ~in_leaf & (node < m_nodes)
        if any_hit:
            do_node = do_node & ~valid
        nd = torch.clamp(node, max=m_nodes - 1)
        row = nodes[nd]
        t0 = (row[:, 0:3] - o) * inv_d
        t1 = (row[:, 3:6] - o) * inv_d
        t_near = torch.maximum(torch.amax(torch.minimum(t0, t1), dim=-1),
                               mint)
        t_far = torch.minimum(torch.amin(torch.maximum(t0, t1), dim=-1),
                              torch.minimum(maxt, t_best))
        box_hit = do_node & (t_near <= t_far)
        count = row[:, 7].to(torch.int64)
        is_leaf = count > 0
        enter = box_hit & is_leaf
        st["lf"] = torch.where(enter, row[:, 6].to(torch.int64), lf)
        st["lc"] = torch.where(enter, torch.clamp(count, max=MAX_LEAF), lc)
        st["lk"] = torch.where(enter, 0, lk)
        st["node"] = torch.where(
            do_node, torch.where(box_hit & ~is_leaf, nd + 1,
                                 row[:, 8].to(torch.int64)), node)
    put_back(st, lanes)
    return out["t"], out["frac"], out["prim"], out["valid"]


def _hair_any(geom: GeometryTables, ray: Ray):
    """Occlusion by any hair segment (intersect.py:1780)."""
    return _hair_walk(geom, ray, True)[3]


def _merge_hair(geom: GeometryTables, ray: Ray,
                its: Intersection) -> Intersection:
    """The record with each lane whose nearest segment is nearer taking
    the segment's hit (intersect.py:1785): u the azimuth about the axis,
    v the arclength along the fibre, the frame from the normal and
    dp/du = axis x normal."""
    t, frac, si, valid = _hair_walk(geom, ray, False)
    closer = valid & (t < its.t)
    rows = geom.hair_segs[si]
    a = rows[:, 0:3]
    ax = rows[:, 3:6] - a
    ln = torch.clamp(torch.sqrt(m.dot(ax, ax)), min=1e-12)
    u_ax = ax / ln[:, None]
    p = ray.at(torch.where(closer, t, 1.0))
    s_ax = m.dot(p - a, u_ax)
    nrm = m.normalize(p - a - s_ax[:, None] * u_ax)
    lp = m.Frame.from_normal(u_ax).to_local(nrm)
    phi = torch.atan2(lp[:, 1], lp[:, 0])
    v_par = rows[:, 7] + frac * (rows[:, 8] - rows[:, 7])
    uv = torch.stack([phi * (0.5 / np.pi) + 0.5, v_par], -1)
    dpdu = m.normalize(m.cross(u_ax, nrm))
    wi = m.Frame.from_normal_tangent(nrm, dpdu).to_local(-ray.d)
    base = geom.n_tris + geom.n_spheres + geom.n_cylinders
    ids = rows[:, 9:12].to(torch.int32)
    return _take(its, closer, t, p, nrm, uv, dpdu, wi, base + si,
                 ids[:, 2].to(its.shape_id.dtype),
                 ids[:, 0].to(its.material_id.dtype),
                 ids[:, 1].to(its.emitter_id.dtype))

# ---------------------------------------------------------------------------
# queries
# ---------------------------------------------------------------------------

def _closest(geom, ray, coherent):
    """(t, u, v, prim, valid) of the backend's closest-hit query."""
    if geom.backend == "bvh":
        tabs, kw = geom.bvh_tables
        t, u, v, prim, valid = bp.bvh_closest(*tabs, *_ray_args(ray), **kw)
        return t, u, v, torch.where(valid, prim, 0), valid
    if geom.has_instances:
        return _worklist_closest(geom, ray)
    return _cluster_closest(geom, ray, coherent)


def _intersect_tri(geom: GeometryTables, ray: Ray, coherent: bool):
    if geom.backend == "brute":
        return _brute_record(ray, ip.closest_hit_shaded(
            geom.brute_tables[0], *_ray_args(ray)))
    return _shade(geom, ray, *_closest(geom, ray, coherent))


def _test_tri(geom: GeometryTables, ray: Ray):
    if geom.backend == "brute":
        return ip.any_hit(geom.brute_tables[1], *_ray_args(ray))
    if geom.backend == "bvh":
        tabs, kw = geom.bvh_tables
        return bp.bvh_any(*tabs, *_ray_args(ray), **kw)
    if geom.has_instances:
        return _worklist_any(geom, ray)
    return _cluster_any(geom, ray)


def ray_intersect(geom: GeometryTables, ray: Ray,
                  coherent: bool = False) -> Intersection:
    """Closest-hit query -> Intersection, spheres and cylinders merged
    after the triangles, then hair (intersect.py:1911). coherent:
    camera-like wavefront; the exact cull then runs at the small coherent
    caps."""
    its = _intersect_tri(geom, ray, coherent)
    if geom.has_analytic:
        its = _merge_analytic(geom, ray, its)
    if geom.n_hair:
        its = _merge_hair(geom, ray, its)
    return its


def ray_test(geom: GeometryTables, ray: Ray):
    """Any-hit (shadow ray) query -> occluded by a triangle, a sphere, a
    cylinder or a hair segment (intersect.py:1922)."""
    occ = _test_tri(geom, ray)
    if geom.has_analytic:
        occ = occ | _analytic_any(geom, ray)
    if geom.n_hair:
        occ = occ | _hair_any(geom, ray)
    return occ


def ray_intersect_and_test(geom: GeometryTables, ray: Ray, sray: Ray):
    """Closest hit (ray) and shadow any-hit (sray): one fused kernel on the
    brute backend, two separate queries elsewhere, spheres, cylinders and
    hair merged after either (intersect.py:1932). Returns (Intersection,
    occluded)."""
    if geom.backend == "brute":
        its, occ = _fused_brute(geom, ray, sray)
    else:
        its, occ = _intersect_tri(geom, ray, False), _test_tri(geom, sray)
    if geom.has_analytic:
        its = _merge_analytic(geom, ray, its)
        occ = occ | _analytic_any(geom, sray)
    if geom.n_hair:
        its = _merge_hair(geom, ray, its)
        occ = occ | _hair_any(geom, sray)
    return its, occ


_DET_EPS = 1e-9


def predicted_hit_bound(geom: GeometryTables, ray: Ray, pred_prim):
    """One Möller–Trumbore test of each ray against its predicted triangle
    (hash-based ray-path prediction, arXiv:1910.01304; intersect.py:556),
    in the reference's `_mt_hit` form. A hit is an exact upper bound on
    the nearest hit's distance, and answers a shadow ray's any-hit query
    (the shadow cache). Returns (t, hit); only static triangles (ids below
    n_tris) take part."""
    ok = (pred_prim >= 0) & (pred_prim < geom.n_tris)
    prim = torch.clamp(pred_prim, 0, geom.n_tris - 1).long()
    v0, e1, e2 = geom.v0[prim], geom.e1[prim], geom.e2[prim]
    o, d = ray.o, ray.d
    pvec = m.cross(d, e2)
    det = torch.sum(e1 * pvec, dim=-1)
    det_ok = torch.abs(det) > _DET_EPS
    inv_det = torch.where(det_ok, 1.0 / torch.where(det == 0, 1.0, det), 0.0)
    tvec = o - v0
    u = torch.sum(tvec * pvec, dim=-1) * inv_det
    qvec = m.cross(tvec, e1)
    v = torch.sum(d * qvec, dim=-1) * inv_det
    t = torch.sum(e2 * qvec, dim=-1) * inv_det
    hit = det_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) \
        & (t > ray.mint) & (t < ray.maxt)
    return t, hit & ok
