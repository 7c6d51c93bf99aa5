"""Triangle clusters of the work-list, exact-cull, stream and v1 cluster
intersectors (the port's own copy of the parts of
mitsuba_tpu/render/clusters.py that it uses; host numpy).

Geometry in BVH order is cut into clusters of at most K spatially
coherent triangles (contiguous BVH subtrees, `cut_clusters`); each cluster
is a (K, 16) block of v0 | e1 | e2 rows with its AABB in row 0, columns
9:15 (`build_mt_tables`), and groups of `sc_group` clusters form
superclusters, the coarse cull level. `build_instanced_tables` adds true
instancing: N instances of a group share one copy of its object-space
blocks; per instance and cluster there is only a world AABB and a
world->object transform. `build_cluster_tables` makes the v1 cluster
intersector's tables (ops/cluster.py): per cluster of at most 128
triangles, the Pluecker rows of each triangle, 4 x 128 rows of
[o | d | o x d | 1] coefficients:

  row A: [0, v1 x v2, v2 - v1, 0]   -> s12 (sign test)
  row B: [0, v2 x v0, v0 - v2, 0]   -> s20 (-> barycentric u)
  row C: [0, v0 x v1, v1 - v0, 0]   -> s01 (-> barycentric v)
  row D: [-n, 0, 0, n . v0]          -> Q = n . v0 - n . o (t numerator)

with n = e1 x e2: s12 + s20 + s01 = d . n = det, t = Q / det, u = s20 /
det, v = s01 / det, and a ray crosses the triangle iff s12, s20 and s01
share a sign.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

CLUSTER_K = 128        # default largest cluster
SC_GROUP = 8           # clusters per supercluster
ROWS_PER_TRI = 4       # Pluecker rows A, B, C, D
G_COLS = 16            # 10 used ([o | d | o x d | 1]), padded


def cut_clusters(first: np.ndarray, count: np.ndarray, skip: np.ndarray,
                 n_tris: int, max_k: int = CLUSTER_K):
    """Cut the flattened skip-link BVH into contiguous triangle ranges of
    at most max_k triangles, on subtree boundaries where they fit: node
    i's subtree covers the nodes [i, skip[i]) and a contiguous triangle
    range. Greedy: emit a node's range as one cluster when it fits, else
    descend into i + 1. Returns [(start, count), ...] covering
    [0, n_tris)."""
    m = first.shape[0]
    lo = np.zeros(m + 1, np.int64)
    lo[m] = n_tris
    for i in range(m - 1, -1, -1):
        lo[i] = first[i] if count[i] > 0 else lo[i + 1]
    out = []
    i = 0
    while i < m:
        hi = lo[skip[i]] if skip[i] <= m else n_tris
        n = hi - lo[i]
        if n <= max_k or count[i] > 0:
            if n > 0:
                start = lo[i]
                while n > max_k:          # an oversized leaf, split
                    out.append((int(start), int(max_k)))
                    start += max_k
                    n -= max_k
                out.append((int(start), int(n)))
            i = skip[i]
        else:
            i += 1
    return out


@dataclass
class ClusterTables:
    """The v1 cluster intersector's tables (numpy)."""
    G: np.ndarray          # (C_s, SC_GROUP*CLUSTER_K*4, G_COLS) f32
    aabb: np.ndarray       # (C_s, SC_GROUP, 8) f32: bmin | bmax | pad
    tri_start: np.ndarray  # (C_s*SC_GROUP,) i32 first tri of each cluster
    sc_bmin: np.ndarray    # (C_s, 3) f32 supercluster bounds
    sc_bmax: np.ndarray    # (C_s, 3) f32
    n_super: int


def build_cluster_tables(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
                         ranges) -> ClusterTables:
    """The Pluecker rows of each cluster, computed in float64 and stored
    as float32 (byte-equal with mitsuba_tpu/render/clusters.py:92).
    v0/e1/e2 (T, 3) of the soup in BVH order; ranges from cut_clusters().
    Padding clusters keep zero rows (no triangle is eligible) and
    inverted boxes."""
    v0 = np.asarray(v0, np.float64)
    v1 = v0 + np.asarray(e1, np.float64)
    v2 = v0 + np.asarray(e2, np.float64)
    t = v0.shape[0]
    c = len(ranges)
    c_s = max(1, -(-c // SC_GROUP))
    rows_per_cluster = CLUSTER_K * ROWS_PER_TRI
    G = np.zeros((c_s, SC_GROUP * rows_per_cluster, G_COLS), np.float32)
    aabb = np.zeros((c_s, SC_GROUP, 8), np.float32)
    aabb[:, :, 0:3] = 1e30
    aabb[:, :, 3:6] = -1e30
    tri_start = np.zeros(c_s * SC_GROUP, np.int32)
    sc_bmin = np.full((c_s, 3), 1e30, np.float32)
    sc_bmax = np.full((c_s, 3), -1e30, np.float32)
    n_all = np.cross(v1 - v0, v2 - v0)
    zeros3, zeros1 = np.zeros((t, 3)), np.zeros((t, 1))
    rows = (
        np.concatenate([zeros3, np.cross(v1, v2), v2 - v1, zeros1], axis=1),
        np.concatenate([zeros3, np.cross(v2, v0), v0 - v2, zeros1], axis=1),
        np.concatenate([zeros3, np.cross(v0, v1), v1 - v0, zeros1], axis=1),
        np.concatenate([-n_all, np.zeros((t, 6)),
                        np.sum(n_all * v0, axis=1, keepdims=True)], axis=1),
    )
    tmin = np.minimum(np.minimum(v0, v1), v2)
    tmax = np.maximum(np.maximum(v0, v1), v2)
    for ci, (start, cnt) in enumerate(ranges):
        s, g = divmod(ci, SC_GROUP)
        sl = slice(start, start + cnt)
        for j, row in enumerate(rows):
            base = g * rows_per_cluster + j * CLUSTER_K
            G[s, base:base + cnt, :10] = row[sl]
        bmin = tmin[sl].min(0)
        bmax = tmax[sl].max(0)
        aabb[s, g, 0:3] = bmin
        aabb[s, g, 3:6] = bmax
        tri_start[ci] = start
        sc_bmin[s] = np.minimum(sc_bmin[s], bmin.astype(np.float32))
        sc_bmax[s] = np.maximum(sc_bmax[s], bmax.astype(np.float32))
    return ClusterTables(G=G, aabb=aabb, tri_start=tri_start,
                         sc_bmin=sc_bmin, sc_bmax=sc_bmax, n_super=c_s)


@dataclass
class MTTables:
    """Per-cluster Möller–Trumbore blocks."""
    tri: np.ndarray        # (C_pad, K, 16) f32: v0 | e1 | e2 | pad;
                           #   row 0 cols 9:15 carry the cluster AABB
    tri_start: np.ndarray  # (C_pad,) i32 first triangle of each cluster
    bmin: np.ndarray       # (C_pad, 3) f32 cluster AABBs (inverted: pad)
    bmax: np.ndarray       # (C_pad, 3) f32
    sc_bmin: np.ndarray    # (C_s, 3) supercluster AABBs
    sc_bmax: np.ndarray    # (C_s, 3)


def build_mt_tables(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
                    ranges, k: int = CLUSTER_K,
                    sc_group: int = SC_GROUP) -> MTTables:
    """v0/e1/e2 (T, 3) of the soup in BVH order; ranges from
    cut_clusters(..., max_k=k). Clusters are padded to a multiple of
    sc_group; padding clusters carry inverted AABBs, and padding rows
    e1 = e2 = 0, so no test ever passes."""
    v0 = np.asarray(v0, np.float32)
    e1 = np.asarray(e1, np.float32)
    e2 = np.asarray(e2, np.float32)
    c = len(ranges)
    c_s = max(1, -(-c // sc_group))
    c_pad = c_s * sc_group
    tri = np.zeros((c_pad, k, 16), np.float32)
    tri_start = np.zeros(c_pad, np.int32)
    bmin = np.full((c_pad, 3), 1e30, np.float32)
    bmax = np.full((c_pad, 3), -1e30, np.float32)
    va = v0 + e1
    vb = v0 + e2
    tmin = np.minimum(np.minimum(v0, va), vb)
    tmax = np.maximum(np.maximum(v0, va), vb)
    for ci, (start, cnt) in enumerate(ranges):
        sl = slice(start, start + cnt)
        tri[ci, :cnt, 0:3] = v0[sl]
        tri[ci, :cnt, 3:6] = e1[sl]
        tri[ci, :cnt, 6:9] = e2[sl]
        tri_start[ci] = start
        bmin[ci] = tmin[sl].min(0)
        bmax[ci] = tmax[sl].max(0)
    tri[:, 0, 9:12] = bmin
    tri[:, 0, 12:15] = bmax
    sc_bmin = bmin.reshape(c_s, sc_group, 3).min(1)
    sc_bmax = bmax.reshape(c_s, sc_group, 3).max(1)
    return MTTables(tri=tri, tri_start=tri_start, bmin=bmin, bmax=bmax,
                    sc_bmin=sc_bmin, sc_bmax=sc_bmax)


@dataclass
class InstancedTables:
    """Work-list tables with true instancing.

    tri:        (B, K, 16) shared object-space blocks (static blocks
                first, then each group's)
    block_id:   (C,) i32 cluster -> shared block
    xform:      (C, 16) f32 world->object 3x4 row-major (+4 pad),
                identity for static clusters
    xform_fwd:  (C, 12) f32 object->world 3x4 (shading)
    tri_start:  (C,) i32 prim base per cluster: the soup index for static
                clusters, n_static_tris + (c - C_static) * K virtual ids
                for instanced ones
    bmin/bmax:  (C, 3) world cluster AABBs; sc_*: supercluster AABBs
    """
    tri: np.ndarray
    block_id: np.ndarray
    xform: np.ndarray
    xform_fwd: np.ndarray
    tri_start: np.ndarray
    bmin: np.ndarray
    bmax: np.ndarray
    sc_bmin: np.ndarray
    sc_bmax: np.ndarray
    n_static_clusters: int = 0
    n_static_tris: int = 0


def build_instanced_tables(static_mt: MTTables, n_static_tris: int,
                           group_mts, instances,
                           k: int = CLUSTER_K,
                           sc_group: int = SC_GROUP) -> InstancedTables:
    """Combine the static geometry's MT tables with instanced groups.
    group_mts: MTTables of each group's object-space soup; instances:
    [(group index, to_world (4, 4)), ...]."""
    blocks = [static_mt.tri]
    group_base = []
    for g in group_mts:
        group_base.append(sum(b.shape[0] for b in blocks))
        blocks.append(g.tri)
    tri = np.concatenate(blocks, axis=0)

    c_static = static_mt.tri.shape[0]
    ident = np.zeros(16, np.float32)
    ident[[0, 5, 10]] = 1.0
    rows_bid = [np.arange(c_static, dtype=np.int32)]
    rows_xf = [np.tile(ident, (c_static, 1))]
    rows_fwd = [np.tile(ident[:12], (c_static, 1))]
    rows_start = [static_mt.tri_start]
    rows_bmin = [static_mt.bmin]
    rows_bmax = [static_mt.bmax]
    vcursor = 0
    corners = np.stack(np.meshgrid(*[[0, 1]] * 3, indexing="ij"),
                       -1).reshape(8, 3)
    for gi, m4 in instances:
        g = group_mts[gi]
        m4 = np.asarray(m4, np.float64)
        inv = np.linalg.inv(m4)
        cg = g.tri.shape[0]
        rows_bid.append(group_base[gi] + np.arange(cg, dtype=np.int32))
        rows_xf.append(np.tile(np.concatenate(
            [inv[:3, :4].reshape(-1), np.zeros(4)]).astype(np.float32),
            (cg, 1)))
        rows_fwd.append(np.tile(
            m4[:3, :4].reshape(-1).astype(np.float32), (cg, 1)))
        # virtual prim space: cluster c covers [start, start + K)
        rows_start.append(
            (n_static_tris + vcursor + np.arange(cg) * k).astype(np.int32))
        vcursor += cg * k
        # world box from the 8 transformed object-box corners; padding
        # clusters keep their inverted boxes
        lo, hi = g.bmin, g.bmax
        ok_box = (lo <= hi).all(-1)
        pts = lo[:, None, :] + corners[None] * (hi - lo)[:, None, :]
        ptsw = pts @ m4[:3, :3].T + m4[:3, 3]
        rows_bmin.append(np.where(ok_box[:, None], ptsw.min(1),
                                  1e30).astype(np.float32))
        rows_bmax.append(np.where(ok_box[:, None], ptsw.max(1),
                                  -1e30).astype(np.float32))

    bmin = np.concatenate(rows_bmin)
    bmax = np.concatenate(rows_bmax)
    c = bmin.shape[0]
    c_s = max(1, -(-c // sc_group))
    pad = c_s * sc_group - c
    if pad:
        bmin = np.concatenate([bmin, np.full((pad, 3), 1e30, np.float32)])
        bmax = np.concatenate([bmax, np.full((pad, 3), -1e30, np.float32)])
        rows_bid.append(np.zeros(pad, np.int32))
        rows_xf.append(np.tile(ident, (pad, 1)))
        rows_fwd.append(np.tile(ident[:12], (pad, 1)))
        rows_start.append(np.zeros(pad, np.int32))
    sc_bmin = bmin.reshape(c_s, sc_group, 3).min(1)
    sc_bmax = bmax.reshape(c_s, sc_group, 3).max(1)
    return InstancedTables(
        tri=tri,
        block_id=np.concatenate(rows_bid),
        xform=np.concatenate(rows_xf).astype(np.float32),
        xform_fwd=np.concatenate(rows_fwd).astype(np.float32),
        tri_start=np.concatenate(rows_start).astype(np.int32),
        bmin=bmin, bmax=bmax, sc_bmin=sc_bmin, sc_bmax=sc_bmax,
        n_static_clusters=c_static, n_static_tris=int(n_static_tris),
    )
