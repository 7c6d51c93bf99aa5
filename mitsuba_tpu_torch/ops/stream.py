"""Per-row ordered streaming intersector: the CUDA kernel and its plain
version (port of mitsuba_tpu/ops/stream_pallas.py, TPU kernel
`_make_stream_kernel`, stream_pallas.py:176).

The build slab-tests every supercluster (8 clusters of K = 32 triangles)
against each 128-lane row's conservative interval and sorts the survivors
front to back by entry distance (`build_sc_lists`, plain PyTorch). The
kernel then walks each row's list in order: per cluster, a per-lane slab
test against the lane's current best t decides whether any lane can
improve; if one can, Möller–Trumbore over the cluster's 32 triangles. It
stops once the next entry's conservative entry distance lies beyond every
lane's best (closest) or once every live lane is occluded (any). The lists
are complete, so the result is exact: this is the fallback that resolves
the rows the exact cull (ops/exact.py) flags as overflowing.

On CUDA tensors `stream_rows` launches `csrc/stream.cu`; on CPU tensors it
runs `stream_rows_ref`, the same function in plain PyTorch, tie order
included (the even/odd chunk split within a sublane, then the lowest
candidate index among equal t, stream_pallas.py:137-148, 254-266).
"""
from __future__ import annotations

import ctypes

import torch

from mitsuba_tpu_torch.ops import build as nv
from mitsuba_tpu_torch.ops.rows import (
    BIG, LANES, interval_slab, pack_rays, row_intervals,
)

SOURCE = nv.source("stream.cu")
SC_GROUP = 8            # clusters per supercluster
_DET_EPS = 1e-12
_PSEL_NONE = 2 ** 30

# kernel launches since import (reset by callers that count a run)
LAUNCHES = 0
_FN = None
_INFO = None


def build() -> str:
    """Compile (once per source hash) and bind the kernel; returns the
    compiler's output, empty when cached."""
    global _FN, _INFO
    log = nv.build_all([SOURCE])[SOURCE]
    p, i = ctypes.c_void_p, ctypes.c_int
    _FN = nv.bind(SOURCE, "mts_stream", [p] * 4 + [i] * 4 + [p] * 6)
    _INFO = nv.bind(SOURCE, "mts_stream_info", [i, i, p])
    return log


def stream_info(k_cl: int, any_hit: bool) -> dict:
    """The kernel's resources on the current card at cluster size k_cl:
    resident rows per SM, registers per thread, shared memory bytes and
    threads per row."""
    if _INFO is None:
        build()
    out = (ctypes.c_int * 4)()
    nv.check(_INFO(k_cl, int(any_hit), out), "stream_info")
    return dict(rows_per_sm=out[0], registers=out[1], smem_bytes=out[2],
                threads=out[3])


def build_sc_lists(rays, sc_bmin, sc_bmax):
    """Slab-test every supercluster against every row's conservative
    interval and sort each row's survivors by entry distance (stable).
    Returns (ids (R, L) int32, t_near (R, L) f32) with misses at the tail
    as (0, BIG); L = c_s padded to a multiple of 128 plus at least one."""
    c_s = sc_bmin.shape[0]
    n_rows = rays.shape[0]
    hit, tn = interval_slab(sc_bmin[None], sc_bmax[None],
                            *row_intervals(rays))
    key = torch.where(hit, tn, BIG)
    key_s, order = torch.sort(key, dim=1, stable=True)
    ids_s = order.to(torch.int32)
    pad = ((-(c_s + 1)) % LANES) + 1
    key_s = torch.cat([key_s, key_s.new_full((n_rows, pad), BIG)], dim=1)
    ids_s = torch.cat([ids_s, ids_s.new_zeros((n_rows, pad))], dim=1)
    return (torch.where(key_s < BIG, ids_s, 0).contiguous(),
            key_s.contiguous())


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def mt(tri, o, d, mnb, cap, eps: float = _DET_EPS):
    """Möller–Trumbore of rays against triangles whose fields v0 | e1 | e2
    lead the last axis of tri: rows' rays (Ra, 1, 128) against tri (Ra,
    Kt, 16) give (t, u, v, ok), each (Ra, Kt, 128). The operation order of
    every kernel of the port (csrc/mt.cuh); a triangle with |det| <= eps
    never hits, and its t, u, v are then meaningless."""
    f = [tri[..., i:i + 1] for i in range(9)]
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = f
    ox, oy, oz = o
    dx, dy, dz = d
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    tvx = ox - v0x
    tvy = oy - v0y
    tvz = oz - v0z
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    ok_det = torch.abs(det) > eps
    inv = 1.0 / torch.where(ok_det, det, 1.0)
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv
    v = (dx * qvx + dy * qvy + dz * qvz) * inv
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv
    ok = (ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t > mnb) & (t < cap))
    return t, u, v, ok


def tests_to_first_hit(ok, need):
    """The triangle tests that lanes need up to their first hit: ok (Ra,
    K, 128) in test order along dim 1, need (Ra, 128) the lanes that test
    at all; a lane without a hit needs all K. A 0-d int64 tensor."""
    first = ok.to(torch.int8).argmax(dim=1) + 1
    per_lane = torch.where(ok.any(dim=1), first, ok.shape[1])
    return torch.where(need, per_lane, 0).sum()


def slab(box, o, d, mnb, tb):
    """Per-lane can-improve test against cluster AABBs box (Ra, 6)."""
    tn, tf = mnb, tb
    for j in range(3):
        inv = torch.where(d[j] >= 0, 1.0, -1.0) / torch.clamp(
            torch.abs(d[j]), min=1e-12)
        t0 = (box[:, j:j + 1] - o[j]) * inv
        t1 = (box[:, 3 + j:4 + j] - o[j]) * inv
        tn = torch.maximum(tn, torch.minimum(t0, t1))
        tf = torch.minimum(tf, torch.maximum(t0, t1))
    return tn <= tf


def visit(tri, o, d, mnb, tb):
    """One cluster (Ra, K, 16) against the rows' lanes with cap tb:
    returns (tmin, u, v, psel) per lane with the kernel's tie order."""
    ra, k, _ = tri.shape
    t, u, v, ok = mt(tri, o, d, mnb, tb)          # (Ra, K, 128)
    n_chunks = k // 8
    sh = (ra, n_chunks, 8, LANES)
    t, u, v, ok = t.reshape(sh), u.reshape(sh), v.reshape(sh), ok.reshape(sh)
    runs = []
    for g in range(2):
        t_r = torch.full((ra, 8, LANES), BIG, device=t.device)
        j_r = torch.zeros((ra, 8, LANES), dtype=torch.int32, device=t.device)
        u_r = torch.zeros_like(t_r)
        v_r = torch.zeros_like(t_r)
        for j in range(g, n_chunks, 2):
            take = ok[:, j] & (t[:, j] < t_r)
            t_r = torch.where(take, t[:, j], t_r)
            j_r = torch.where(take, j, j_r)
            u_r = torch.where(take, u[:, j], u_r)
            v_r = torch.where(take, v[:, j], v_r)
        runs.append((t_r, j_r, u_r, v_r))
    sel = runs[1][0] < runs[0][0]
    t_run, j_run, u_run, v_run = (torch.where(sel, a, b)
                                  for a, b in zip(runs[1], runs[0]))
    tmin = t_run.amin(dim=1)                           # (Ra, 128)
    sub = torch.arange(8, dtype=torch.int32, device=t.device)[None, :, None]
    pc = j_run * 8 + sub
    win = t_run <= tmin[:, None]
    psel = torch.where(win, pc, _PSEL_NONE).amin(dim=1)
    pick = (win & (pc == psel[:, None])).to(torch.int64).argmax(dim=1)
    usel = torch.gather(u_run, 1, pick[:, None])[:, 0]
    vsel = torch.gather(v_run, 1, pick[:, None])[:, 0]
    return tmin, usel, vsel, psel


def stream_rows_ref(rays, ids, tns, sc_tri, any_hit: bool, work=None):
    """Plain version of the stream kernel, row for row: rays (R, 8, 128),
    ids/tns (R, L) from build_sc_lists, sc_tri (c_s, K, 128). Returns
    (t, u, v, vprim) (R, 128) each, or the occlusion mask (R, 128) bool.
    Rows advance together through a loop over list positions; each row
    leaves the loop where the kernel's row would. work: a dict that, if
    given, receives the tests these inputs need, lane by lane: closest,
    a slab test per live lane and visited cluster and the K triangle
    tests of each lane whose slab test passed; any hit, the triangle
    tests of each live, not yet occluded lane up to its first hit; and
    `walk_tests`, the triangle tests of all 128 lanes of each cluster the
    walk tests (closest: those some lane's slab test admits)."""
    n_rows = rays.shape[0]
    dev = rays.device
    k_cl = sc_tri.shape[1]
    o_all = [rays[:, j] for j in range(3)]
    d_all = [rays[:, 3 + j] for j in range(3)]
    mnb_all, maxt = rays[:, 6], rays[:, 7]
    live0 = mnb_all <= maxt
    if any_hit:
        occ = torch.zeros((n_rows, LANES), dtype=torch.bool, device=dev)
    else:
        tb = maxt.clone()
        ub = torch.zeros_like(tb)
        vb = torch.zeros_like(tb)
        pb = torch.full((n_rows, LANES), -1, dtype=torch.int32, device=dev)
    cont = tns[:, 0] < BIG
    n_box = n_tri = torch.zeros((), dtype=torch.int64, device=dev)
    n_walk = 0
    i = 0
    while bool(cont.any()):
        rows = torch.nonzero(cont)[:, 0]
        o = [x[rows][:, None] for x in o_all]
        d = [x[rows][:, None] for x in d_all]
        mnb = mnb_all[rows][:, None]
        live = live0[rows]
        sc = ids[rows, i].long()
        blocks = sc_tri[sc].reshape(rows.shape[0], k_cl, SC_GROUP, 16)
        nxt_t = tns[rows, i + 1]
        has_next = nxt_t < BIG
        if any_hit:
            oc = occ[rows]
            mx = maxt[rows]
            n_walk += rows.numel() * SC_GROUP * k_cl * LANES
            for k in range(SC_GROUP):
                cap = torch.where(oc, mnb[:, 0], mx)[:, None]
                _t, _u, _v, ok = mt(blocks[:, :, k], o, d, mnb, cap)
                if work is not None:
                    n_tri = n_tri + tests_to_first_hit(ok, live & ~oc)
                oc = oc | ok.any(dim=1)
            occ[rows] = oc
            done = (oc | ~live).all(dim=1)
            cont[rows] = has_next & ~done
        else:
            t_b, u_b, v_b, p_b = tb[rows], ub[rows], vb[rows], pb[rows]
            for k in range(SC_GROUP):
                box = blocks[:, 0, k, 9:15]
                can = slab(box, [x[:, 0] for x in o],
                            [x[:, 0] for x in d], mnb[:, 0], t_b)
                if work is not None:
                    n_box = n_box + live.sum()
                    n_tri = n_tri + can.sum() * k_cl
                vis = torch.nonzero(can.any(dim=1))[:, 0]
                n_walk += vis.numel() * k_cl * LANES
                if vis.numel() == 0:
                    continue
                tv = t_b[vis]
                tmin, usel, vsel, psel = visit(
                    blocks[vis, :, k], [x[vis] for x in o],
                    [x[vis] for x in d], mnb[vis], tv[:, None, :])
                improved = tmin < tv
                prim_new = ((sc[vis] * SC_GROUP + k) * k_cl)[:, None] + psel
                t_b[vis] = torch.where(improved, tmin, tv)
                u_b[vis] = torch.where(improved, usel, u_b[vis])
                v_b[vis] = torch.where(improved, vsel, v_b[vis])
                p_b[vis] = torch.where(improved, prim_new.to(torch.int32),
                                       p_b[vis])
            tb[rows], ub[rows], vb[rows], pb[rows] = t_b, u_b, v_b, p_b
            cont[rows] = has_next & (nxt_t <= t_b.amax(dim=1))
        i += 1
    if work is not None:
        work.update(box_tests=int(n_box), tri_tests=int(n_tri),
                    walk_tests=n_walk)
    if any_hit:
        return occ
    return tb, ub, vb, pb


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

def _check(rays, ids, tns, sc_tri):
    r = rays.shape[0]
    for x, dt, shape in ((rays, torch.float32, (r, 8, LANES)),
                         (ids, torch.int32, (r, ids.shape[-1])),
                         (tns, torch.float32, (r, ids.shape[-1])),
                         (sc_tri, torch.float32,
                          (sc_tri.shape[0], sc_tri.shape[1],
                           SC_GROUP * 16))):
        if x.dtype != dt or tuple(x.shape) != shape:
            raise ValueError(f"expected {dt} {shape}, got {x.dtype} "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous() or x.device != rays.device:
            raise ValueError("inputs must be contiguous, on one device")
    if sc_tri.shape[1] % 8:
        raise ValueError("cluster size must be a multiple of 8")
    nv.refuse_grad(rays, tns, sc_tri)


def stream_rows(rays, ids, tns, sc_tri, any_hit: bool):
    """The stream kernel on CUDA tensors, its plain version on CPU ones."""
    _check(rays, ids, tns, sc_tri)
    if rays.device.type == "cpu":
        return stream_rows_ref(rays, ids, tns, sc_tri, any_hit)
    if rays.device.type != "cuda":
        raise NotImplementedError(f"no stream kernel for {rays.device}")
    global LAUNCHES
    if _FN is None:
        build()
    r = rays.shape[0]
    dev = rays.device
    with torch.cuda.device(dev):
        t = torch.empty((r, LANES), dtype=torch.float32, device=dev)
        u = torch.empty_like(t)
        v = torch.empty_like(t)
        p = torch.empty((r, LANES), dtype=torch.int32, device=dev)
        occ = torch.empty((r, LANES), dtype=torch.int32, device=dev)
        err = _FN(rays.data_ptr(), ids.data_ptr(), tns.data_ptr(),
                  sc_tri.data_ptr(), r, ids.shape[1], sc_tri.shape[1],
                  int(any_hit), t.data_ptr(), u.data_ptr(), v.data_ptr(),
                  p.data_ptr(), occ.data_ptr(),
                  torch.cuda.current_stream(dev).cuda_stream)
    nv.check(err, "stream")
    if r > 0:
        LAUNCHES += 1
    if any_hit:
        return occ.bool()
    return t, u, v, p


def _call(st, o, d, mint, maxt, any_hit):
    # maxt = inf would let the BIG miss sentinel pass `tmin < tb`
    maxt = torch.clamp(maxt, max=1e30)
    rays, n, _ = pack_rays(o, d, mint, maxt)
    ids, tns = build_sc_lists(rays, st["sc_bmin"], st["sc_bmax"])
    return stream_rows(rays, ids, tns, st["sc_tri"], any_hit), n


def stream_closest(st, o, d, mint, maxt):
    """Closest hit through the stream kernel. st: dict from st_tables.
    Returns (t, u, v, prim, valid); complete lists, no overflow."""
    (t, u, v, vp), n = _call(st, o, d, mint, maxt, any_hit=False)
    t, u, v, vp = (x.reshape(-1)[:n] for x in (t, u, v, vp))
    valid = vp >= 0
    # virtual (cluster * K + local) -> soup index through tri_start
    k_cl = st["sc_tri"].shape[1]
    starts = st["tri_start"]
    vp0 = torch.where(valid, vp, 0)
    vcid = torch.clamp(torch.div(vp0, k_cl, rounding_mode="floor"), 0,
                       starts.shape[0] - 1).long()
    prim = (starts[vcid] + vp0 % k_cl).to(torch.int32)
    return torch.where(valid, t, float("inf")), u, v, prim, valid


def stream_any(st, o, d, mint, maxt):
    """Any-hit through the stream kernel; returns the occlusion mask."""
    occ, n = _call(st, o, d, mint, maxt, any_hit=True)
    return occ.reshape(-1)[:n]
