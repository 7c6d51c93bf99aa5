"""The v1 streaming cluster intersector: the tile-list build, the CUDA
kernel and its plain version (port of mitsuba_tpu/ops/cluster_pallas.py,
TPU kernels `_closest_kernel` :169 and `_any_kernel` :227, entry
`_common_call` :284 via `cluster_closest` :318 and `cluster_any` :333).

Geometry in BVH order is cut into clusters of at most 128 triangles,
grouped 8 to a supercluster (render/clusters.py `build_cluster_tables`:
per cluster 4 x 128 Pluecker rows). A query packs its rays into tiles of
8 rows x 128 lanes (`pack_tiles`); `build_tile_lists` culls each tile's
conservative interval (ops/rows.py) against every supercluster box and
sorts the survivors front to back (stable; unused slots repeat the last
valid id). The kernel then walks, per row, its tile's list: for each of a
supercluster's 8 clusters a per-lane slab test (closest: capped at the
lane's best t; any: at maxt, and a row stops once all its lanes are
occluded) decides whether any lane of the row can hit it; if one can,
every lane computes the 4 x 128 Pluecker products of the cluster, each an
ordered 10-term sum, and takes the nearest eligible hit (the lowest k
among equal t within a cluster, strict < across clusters; prim =
tri_start + k). The lists are complete, so the result is exact.

On CUDA tensors `cluster_rows` launches `csrc/cluster.cu`; on CPU tensors
it runs `cluster_rows_ref`, the same walk in plain PyTorch with the same
summation order, so the two agree bit for bit. The kernel reads the
Pluecker rows as 96-byte triangle records (`plucker_records`) of the
columns that are not the table's fixed zeros, which `table_dict` builds
once beside G (`rec`); G itself is the reference's layout. The TPU kernel takes the
products on its matrix unit at HIGHEST precision, whose summation order
is its own: against it the port agrees within float32 tolerance.

One deliberate difference from the reference: `cluster_closest` clamps
maxt to 1e30. With maxt = inf the reference's closest kernel takes its
3e38 miss sentinel for a hit (`tmin < tb`), so a lane that misses in a row
that tests some cluster reports a hit at t = 3e38.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from mitsuba_tpu_torch.ops import build as nv
from mitsuba_tpu_torch.ops.rows import (
    BIG, LANES, interval_slab, pack_rays, row_intervals,
)
from mitsuba_tpu_torch.ops.stream import slab, tests_to_first_hit
from mitsuba_tpu_torch.render.clusters import (
    CLUSTER_K, ROWS_PER_TRI, SC_GROUP, build_cluster_tables, cut_clusters,
)

SOURCE = nv.source("cluster.cu")
BM = 8                      # rows per tile
TILE = BM * LANES
RPC = CLUSTER_K * ROWS_PER_TRI      # Pluecker rows per cluster (512)
N_COEF = 10                 # [o | d | o x d | 1]
_DET_EPS = 1e-12
_NO_K = 2 ** 30             # the TPU kernel's "no hit" triangle index
# largest (rows, 512, 128) intermediate of the plain version, in elements
_MAX_ELEMS = 1 << 26

# kernel launches since import, per mode (reset by callers that count)
LAUNCHES = {"cluster_closest": 0, "cluster_any": 0}
_FN = None
_INFO = None


def build() -> str:
    """Compile (once per source hash) and bind the kernel; returns the
    compiler's output, empty when cached."""
    global _FN, _INFO
    log = nv.build_all([SOURCE])[SOURCE]
    p, i = ctypes.c_void_p, ctypes.c_int
    _FN = nv.bind(SOURCE, "mts_cluster", [p] * 6 + [i] * 3 + [p] * 6)
    _INFO = nv.bind(SOURCE, "mts_cluster_info", [i, p])
    return log


def cluster_info(any_hit: bool) -> dict:
    """The kernel's resources on the current card: rows (blocks) resident
    per SM, registers per thread, shared memory bytes per row and local
    (spill) bytes per thread."""
    if _INFO is None:
        build()
    out = (ctypes.c_int * 4)()
    nv.check(_INFO(int(any_hit), out), "cluster_info")
    return dict(rows_per_sm=out[0], registers=out[1], smem_bytes=out[2],
                local_bytes=out[3])


def plucker_records(G):
    """The kernel's view of G (C_s, 8 * 512, 16): (C_s * 8, 128, 24), per
    triangle k of a cluster the columns of its Pluecker rows k, 128 + k,
    256 + k (A, B, C: columns 3-8) and 384 + k (D: columns 0-2 and 9),
    then two zeros, so that a triangle is 96 contiguous bytes. The other
    columns are +0.0 in every table build_cluster_tables makes (A, B, C
    have no o term nor constant, D no d or o x d term); the kernel takes
    their products with the ray once per lane, so this raises on a G
    where they are not."""
    c_s = G.shape[0]
    g = G[:, :, :N_COEF].reshape(c_s * SC_GROUP, ROWS_PER_TRI, CLUSTER_K,
                                 N_COEF)
    outer = torch.tensor([0, 1, 2, 9], device=G.device)
    zeros = torch.cat([g[:, :3][..., outer].reshape(-1),
                       g[:, 3, :, 3:9].reshape(-1)])
    if bool((zeros.view(torch.int32) != 0).any()):
        raise ValueError("G's Pluecker rows must hold +0.0 where "
                         "build_cluster_tables puts it")
    return torch.cat([g[:, :3, :, 3:9].transpose(1, 2).reshape(
        c_s * SC_GROUP, CLUSTER_K, 18), g[:, 3][..., outer],
        g.new_zeros((c_s * SC_GROUP, CLUSTER_K, 2))], dim=2).contiguous()


def geometry_tables(geom):
    """The v1 cluster tables of a bvh or cluster GeometryTables: its
    BVH-ordered soup cut into clusters of at most 128 triangles."""
    v0, e1, e2 = (x.cpu().numpy() for x in (geom.v0, geom.e1, geom.e2))
    ranges = cut_clusters(geom.bvh_first.cpu().numpy(),
                          geom.bvh_count.cpu().numpy(),
                          geom.bvh_skip.cpu().numpy(), v0.shape[0])
    return build_cluster_tables(v0, e1, e2, ranges)


def table_dict(ct, device="cuda"):
    """ClusterTables as the dict the queries take (cluster_pallas.py:321),
    on `device`: the card unless the caller passes another, as the scene
    entry points do; with `rec`, the kernel's records of G."""
    tab = {k: torch.as_tensor(np.ascontiguousarray(getattr(ct, k))).to(
        device) for k in ("G", "aabb", "tri_start", "sc_bmin", "sc_bmax")}
    tab["rec"] = plucker_records(tab["G"])
    return tab


def pack_tiles(o, d, mint, maxt):
    """(N,3),(N,3),(N,),(N,) -> (rays (R, 8, 128), n, R) with R a
    multiple of BM (cluster_pallas.py:268): padding lanes o = 0, d = +z,
    mint = 0, maxt = -1."""
    rays, n, n_rows = pack_rays(o, d, mint, maxt)
    pad = (-n_rows) % BM
    if pad:
        dead = rays.new_zeros((pad, 8, LANES))
        dead[:, 5] = 1.0
        dead[:, 7] = -1.0
        rays = torch.cat([rays, dead])
    return rays.contiguous(), n, n_rows + pad


def build_tile_lists(o, d, maxt, sc_bmin, sc_bmax, n_tiles: int):
    """Conservative cull of ray tiles against supercluster boxes
    (cluster_pallas.py:58). o, d (N, 3) padded to n_tiles * TILE, maxt
    (N,). Returns (ids (n_tiles, C_s) int32 front to back by entry
    distance, a stable sort, with the last valid id repeated in unused
    slots; counts (n_tiles,) int32, the boxes hit)."""
    c_s = sc_bmin.shape[0]
    tiles = torch.cat([
        o.reshape(n_tiles, TILE, 3).transpose(1, 2),
        d.reshape(n_tiles, TILE, 3).transpose(1, 2),
        torch.zeros_like(maxt).reshape(n_tiles, 1, TILE),
        maxt.reshape(n_tiles, 1, TILE)], dim=1)
    hit, t_near = interval_slab(sc_bmin[None], sc_bmax[None],
                                *row_intervals(tiles))
    key = torch.where(hit, t_near, BIG)
    ids = torch.sort(key, dim=1, stable=True)[1].to(torch.int32)
    counts = hit.sum(dim=1).to(torch.int32)
    last = torch.gather(ids, 1, torch.clamp(counts[:, None].long() - 1,
                                            min=0))
    slot = torch.arange(c_s, device=ids.device)[None]
    return (torch.where(slot < counts[:, None], ids, last).contiguous(),
            counts)


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def ray_matrix(rays):
    """The (R, 10, 128) Pluecker ray coefficients [o | d | o x d | 1] of
    rows (R, 8, 128) (cluster_pallas.py:114)."""
    ox, oy, oz, dx, dy, dz = (rays[:, j] for j in range(6))
    return torch.stack([ox, oy, oz, dx, dy, dz, oy * dz - oz * dy,
                        oz * dx - ox * dz, ox * dy - oy * dx,
                        torch.ones_like(ox)], dim=1)


def plucker(g, mrow):
    """Pluecker test of clusters g (Ra, 512, 10) against the rows' ray
    coefficients mrow (Ra, 10, 128): each of the 512 products an ordered
    10-term sum, then the TPU kernel's rules (cluster_pallas.py:140-166).
    Returns (t, 1/det signed, P1, P2, eligible), each (Ra, 128, 128)."""
    s = g[:, :, 0:1] * mrow[:, 0:1]
    for j in range(1, N_COEF):
        s = s + g[:, :, j:j + 1] * mrow[:, j:j + 1]
    p0, p1, p2, qn = (s[:, i * CLUSTER_K:(i + 1) * CLUSTER_K]
                      for i in range(ROWS_PER_TRI))
    det = p0 + p1 + p2
    smin = torch.minimum(torch.minimum(p0, p1), p2)
    smax = torch.maximum(torch.maximum(p0, p1), p2)
    pos = smin >= 0.0
    sgn = torch.where(pos, 1.0, -1.0)
    absdet = det * sgn
    elig = (pos | (smax <= 0.0)) & (absdet > _DET_EPS)
    rcp = 1.0 / torch.where(elig, absdet, 1.0)
    return qn * sgn * rcp, sgn * rcp, p1, p2, elig


def cluster_rows_ref(rays, ids, counts, G, aabb, tri_start, any_hit: bool,
                     work=None):
    """Plain version of the v1 kernel, row for row: rays (R, 8, 128) in
    tiles of BM rows, ids (R/BM, C_s) and counts (R/BM,) from
    build_tile_lists, the tables of ClusterTables. Returns (t, u, v, prim)
    (R, 128) each, or the occlusion mask (R, 128) bool. Rows advance
    together through their tiles' lists, cluster by cluster. work: a dict
    that, if given, receives the tests these inputs need, lane by lane: a
    slab test per live (any hit: live, not yet occluded) lane and listed
    cluster; closest, the 128 triangle tests of each live lane whose own
    slab test passed; any hit, those of each such lane not yet occluded
    up to its first hit; `superclusters_read`, the distinct superclusters
    whose boxes some row tests, and `clusters_read`, the distinct clusters
    whose Pluecker rows some row reads; `row_tests`, the tests the
    row-wide rule makes: closest, the 128 of each live lane of a row that
    votes for a cluster, its own slab passing or not; any hit, each such
    lane's not yet occluded, up to its first hit; `tri_eligible` and
    `row_eligible`, those of `tri_tests` and `row_tests` whose triangle
    is eligible (the lane's three edge signs agree, |det| > 1e-12), the
    only ones that need the fourth product, the division and t."""
    n_rows = rays.shape[0]
    dev = rays.device
    tile = torch.arange(n_rows, device=dev) // BM
    cnt = counts.long()[tile]
    o_all = [rays[:, j] for j in range(3)]
    d_all = [rays[:, 3 + j] for j in range(3)]
    mnb, maxt = rays[:, 6], rays[:, 7]
    live = mnb <= maxt
    mrow = ray_matrix(rays)
    occ = torch.zeros((n_rows, LANES), dtype=torch.bool, device=dev)
    tb = maxt.clone()
    ub = torch.zeros_like(tb)
    vb = torch.zeros_like(tb)
    pb = torch.full((n_rows, LANES), -1, dtype=torch.int32, device=dev)
    krow = torch.arange(CLUSTER_K, dtype=torch.int32, device=dev)[
        None, :, None]
    step = max(1, _MAX_ELEMS // (RPC * LANES))
    n_box = n_tri = n_row = n_tri_el = n_row_el = torch.zeros(
        (), dtype=torch.int64, device=dev)
    sc_read = torch.zeros(G.shape[0], dtype=torch.bool, device=dev)
    cl_read = torch.zeros(G.shape[0] * SC_GROUP, dtype=torch.bool,
                          device=dev)
    for li in range(int(cnt.max()) if n_rows else 0):
        rows = torch.nonzero(cnt > li)[:, 0]
        if any_hit:                 # a row whose lanes are all occluded
            rows = rows[(~occ[rows]).any(dim=1)]
        sc = ids[tile[rows], li].long()
        if work is not None:
            sc_read[sc] = True
        o = [x[rows] for x in o_all]
        d = [x[rows] for x in d_all]
        for c in range(SC_GROUP):
            cap = maxt[rows] if any_hit else tb[rows]
            need = live[rows] & ~occ[rows] if any_hit else live[rows]
            adm = slab(aabb[sc, c, :6], o, d, mnb[rows], cap)
            if work is not None:
                n_box = n_box + need.sum()
            vis = torch.nonzero(adm.any(dim=1))[:, 0]
            for v0 in range(0, vis.numel(), step):
                sel = vis[v0:v0 + step]
                r = rows[sel]
                scr = sc[sel]
                if work is not None:
                    cl_read[scr * SC_GROUP + c] = True
                t, rcp_s, p1, p2, elig = plucker(
                    G[scr, c * RPC:(c + 1) * RPC, :N_COEF], mrow[r])
                mn = mnb[r][:, None]
                if any_hit:
                    hit = elig & (t > mn) & (t < maxt[r][:, None])
                    if work is not None:
                        n_tri = n_tri + tests_to_first_hit(
                            hit, need[sel] & adm[sel])
                        n_row = n_row + tests_to_first_hit(hit, need[sel])
                        # the tests up to and with each lane's first hit
                        made = elig & (torch.cumsum(hit, dim=1) <= hit)
                        n_tri_el = n_tri_el + (
                            made & (need[sel] & adm[sel])[:, None]).sum()
                        n_row_el = n_row_el + (made & need[sel][:, None]).sum()
                    occ[r] = occ[r] | hit.any(dim=1)
                    continue
                t_r = tb[r]
                if work is not None:
                    n_tri = n_tri + (need[sel] & adm[sel]).sum() * CLUSTER_K
                    n_row = n_row + need[sel].sum() * CLUSTER_K
                    n_tri_el = n_tri_el + (
                        elig & (need[sel] & adm[sel])[:, None]).sum()
                    n_row_el = n_row_el + (elig & need[sel][:, None]).sum()
                hit = elig & (t > mn) & (t < t_r[:, None])
                tm = torch.where(hit, t, BIG)
                tmin = tm.amin(dim=1)
                k = torch.where(hit & (tm <= tmin[:, None]), krow,
                                _NO_K).amin(dim=1)
                kc = torch.clamp(k, max=CLUSTER_K - 1).long()[:, None]
                found = k < _NO_K
                usel = torch.where(found, torch.gather(p1 * rcp_s, 1, kc)[
                    :, 0], 0.0)
                vsel = torch.where(found, torch.gather(p2 * rcp_s, 1, kc)[
                    :, 0], 0.0)
                improved = tmin < t_r
                start = tri_start[scr * SC_GROUP + c][:, None]
                tb[r] = torch.where(improved, tmin, t_r)
                ub[r] = torch.where(improved, usel, ub[r])
                vb[r] = torch.where(improved, vsel, vb[r])
                pb[r] = torch.where(improved, start + k, pb[r])
    if work is not None:
        work.update(box_tests=int(n_box), tri_tests=int(n_tri),
                    row_tests=int(n_row), tri_eligible=int(n_tri_el),
                    row_eligible=int(n_row_el),
                    superclusters_read=int(sc_read.sum()),
                    clusters_read=int(cl_read.sum()))
    if any_hit:
        return occ
    return tb, ub, vb, pb


# ---------------------------------------------------------------------------
# Kernel wrapper and queries
# ---------------------------------------------------------------------------

def _check(rays, ids, counts, G, aabb, tri_start):
    r = rays.shape[0]
    c_s = G.shape[0]
    for x, dt, shape in ((rays, torch.float32, (r, 8, LANES)),
                         (ids, torch.int32, (r // BM, c_s)),
                         (counts, torch.int32, (r // BM,)),
                         (G, torch.float32, (c_s, SC_GROUP * RPC, 16)),
                         (aabb, torch.float32, (c_s, SC_GROUP, 8)),
                         (tri_start, torch.int32, (c_s * SC_GROUP,))):
        if x.dtype != dt or tuple(x.shape) != shape:
            raise ValueError(f"expected {dt} {shape}, got {x.dtype} "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous() or x.device != rays.device:
            raise ValueError("inputs must be contiguous, on one device")
    if r % BM:
        raise ValueError("rows must fill whole tiles of 8")
    nv.refuse_grad(rays, G, aabb)


def cluster_rows(rays, ids, counts, G, aabb, tri_start, any_hit: bool,
                 rec=None):
    """The v1 kernel on CUDA tensors, its plain version on CPU ones. rec:
    plucker_records(G), as table_dict holds it; made from G when not
    given."""
    _check(rays, ids, counts, G, aabb, tri_start)
    if rays.device.type == "cpu":
        return cluster_rows_ref(rays, ids, counts, G, aabb, tri_start,
                                any_hit)
    if rays.device.type != "cuda":
        raise NotImplementedError(f"no cluster kernel for {rays.device}")
    if rec is None:
        rec = plucker_records(G)
    c_s = G.shape[0]
    if (rec.dtype != torch.float32 or rec.device != rays.device
            or tuple(rec.shape) != (c_s * SC_GROUP, CLUSTER_K, 24)
            or not rec.is_contiguous()):
        raise ValueError("rec must be plucker_records(G)")
    if _FN is None:
        build()
    if aabb.data_ptr() % 16:
        raise ValueError("the kernel stages aabb in 16-byte pieces: it must "
                         "be 16-byte aligned")
    r = rays.shape[0]
    dev = rays.device
    with torch.cuda.device(dev):
        t = torch.empty((r, LANES), dtype=torch.float32, device=dev)
        u = torch.empty_like(t)
        v = torch.empty_like(t)
        p = torch.empty((r, LANES), dtype=torch.int32, device=dev)
        occ = torch.empty((r, LANES), dtype=torch.int32, device=dev)
        err = _FN(rays.data_ptr(), ids.data_ptr(), counts.data_ptr(),
                  rec.data_ptr(), aabb.data_ptr(),
                  tri_start.data_ptr(), r, G.shape[0], int(any_hit),
                  t.data_ptr(), u.data_ptr(),
                  v.data_ptr(), p.data_ptr(), occ.data_ptr(),
                  torch.cuda.current_stream(dev).cuda_stream)
    nv.check(err, "cluster")
    if r > 0:
        LAUNCHES["cluster_any" if any_hit else "cluster_closest"] += 1
    if any_hit:
        return occ.bool()
    return t, u, v, p


def launch_args(cl, o, d, mint, maxt, any_hit: bool):
    """The arguments of the one `cluster_rows` launch of a query, and its
    ray count: the rays packed into tiles, each tile's list built; closest
    clamps maxt to 1e30 (the module docstring says why). cl: table_dict of
    ClusterTables."""
    if not any_hit:
        maxt = torch.clamp(maxt, max=1e30)
    rays, n, n_rows = pack_tiles(o, d, mint, maxt)
    lanes = rays.transpose(1, 2)                  # (R, 128, 8)
    ids, counts = build_tile_lists(
        lanes[:, :, 0:3].reshape(-1, 3), lanes[:, :, 3:6].reshape(-1, 3),
        lanes[:, :, 7].reshape(-1), cl["sc_bmin"], cl["sc_bmax"],
        n_rows // BM)
    return (rays, ids, counts, cl["G"], cl["aabb"], cl["tri_start"],
            any_hit), n


def cluster_closest(cl, o, d, mint, maxt):
    """Closest hit through the v1 kernel. cl: table_dict of
    ClusterTables. Returns (t, u, v, prim, valid); complete lists, no
    overflow."""
    args, n = launch_args(cl, o, d, mint, maxt, any_hit=False)
    t, u, v, p = (x.reshape(-1)[:n]
                  for x in cluster_rows(*args, rec=cl["rec"]))
    valid = p >= 0
    return torch.where(valid, t, float("inf")), u, v, p, valid


def cluster_any(cl, o, d, mint, maxt):
    """Any-hit / shadow query through the v1 kernel; the occlusion mask."""
    args, n = launch_args(cl, o, d, mint, maxt, any_hit=True)
    return cluster_rows(*args, rec=cl["rec"]).reshape(-1)[:n]
