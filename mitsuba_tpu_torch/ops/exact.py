"""Exact-cull item-stream intersector, work-list v5: the three CUDA kernels
of its path, their plain versions, the hierarchical cull around them and
the closest / any-hit queries (port of mitsuba_tpu/ops/exact_pallas.py,
v5 only).

A query packs its rays into 128-lane rows (ops/rows.py) and culls each
row's candidates exactly, level by level, down an 8x box hierarchy
(K8 clusters of 8 triangles -> 64-triangle L1 boxes -> 512-triangle L2
boxes):

  S0  conservative row-interval cull of every L2 box (ops/stream.py
      `build_sc_lists`), capped at E0 candidates;
  S1  exact per-lane slab keys of those L2 boxes           (kernel #5);
  S2  exact keys of the 8 L1 children of the E1 nearest    (kernel #6);
  S3  exact keys of the 8 K8 children of the E2 nearest    (kernel #6);

each stage sorting its keys front to back (stable) and keeping a live
prefix. The item kernel (#7) then runs Möller–Trumbore over the row's E3
nearest K8 clusters in blocks of 16, skipping blocks behind every lane's
best hit. A row whose candidate count exceeds a cap at any level is
flagged as overflowing: its result is partial, and the caller re-resolves
it (render/intersect.py). When the root level has at most E0 boxes, S0
and S1 collapse into one child-refine pass over the root table.

The TPU package picks a branchless variant (v6b) on a compiled TPU and v5
everywhere else; both give the same hit records, and the port follows v5.

On CUDA tensors `refine`, `child_refine` and `items` launch
`csrc/exact.cu`; on CPU tensors they run `refine_ref`, `child_refine_ref`
and `items_ref`, the same functions in plain PyTorch.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from mitsuba_tpu_torch.ops import build as nv
from mitsuba_tpu_torch.ops.rows import BIG, LANES, pack_rays
from mitsuba_tpu_torch.ops.stream import (
    build_sc_lists, mt, tests_to_first_hit,
)

SOURCE = nv.source("exact.cu")
BI = 16                 # K8 clusters per item block
# largest (rows, entries, 3, 128) slab intermediate of the plain
# versions, in elements (256 MB of float32)
_MAX_ELEMS = 1 << 26

# kernel launches since import, per kernel (reset by callers that count)
LAUNCHES = {"refine": 0, "child_refine": 0, "items": 0}
_FN = {}


def build() -> str:
    """Compile (once per source hash) and bind the three kernels; returns
    the compiler's output, empty when cached."""
    log = nv.build_all([SOURCE])[SOURCE]
    p, i = ctypes.c_void_p, ctypes.c_int
    _FN["refine"] = nv.bind(SOURCE, "mts_refine", [p] * 5 + [i, i, p, p])
    _FN["child_refine"] = nv.bind(SOURCE, "mts_child_refine",
                                  [p] * 4 + [i, i, p, p])
    _FN["items"] = nv.bind(SOURCE, "mts_items",
                           [p] * 4 + [i, i, i] + [p] * 6)
    return log


def auto_caps(n_k8: int):
    """Scene-statistics caps (exact_pallas.py:65): (diffuse, coherent, xl)
    tuples (E0, E1, E2, E3) — L2 candidates, L2 kept, L1 kept, K8 items —
    for a scene of n_k8 eight-triangle clusters."""
    def rup(x, m):
        return int(-(-int(x) // m) * m)

    e3 = min(512, max(128, rup(0.06 * n_k8, 16)))
    e2 = min(384, max(48, rup(e3 * 0.75, 16)))
    e1 = min(160, max(16, rup(e2 * 0.42, 16)))
    e0 = 128 if n_k8 // 64 <= 128 else 256
    dif = (e0, e1, e2, e3)
    coh = (128, min(e1, 16), min(e2, 32), min(e3, 96))
    xl = (e0, min(240, ((e1 * 3 // 2) + 15) // 16 * 16),
          min(768, e2 * 2), min(1024, e3 * 2))
    return dif, coh, xl


def pack_child_table(lo, hi):
    """(Cp*8, 3) child boxes -> (Cp, 8, 128) table: sublane = child,
    lanes 0:3 lo, 3:6 hi (exact_pallas.py:284)."""
    n = lo.shape[0]
    tab = np.zeros((n // 8, 8, 128), np.float32)
    tab[:, :, 0:3] = np.asarray(lo).reshape(-1, 8, 3)
    tab[:, :, 3:6] = np.asarray(hi).reshape(-1, 8, 3)
    return tab


# ---------------------------------------------------------------------------
# Plain PyTorch versions of the three kernels
# ---------------------------------------------------------------------------

def _box_keys(rays, lo, hi):
    """rays (Rc, 8, 128), boxes lo/hi (Rc, E, 3) -> (Rc, E) min over
    lanes of the slab entry distance (BIG where no lane hits)."""
    o = rays[:, 0:3]
    d = rays[:, 3:6]
    inv = torch.where(torch.abs(d) > 1e-12, 1.0 / d, BIG)
    tn = rays[:, 6][:, None]
    tf = rays[:, 7][:, None]
    for j in range(3):
        t0 = (lo[:, :, j:j + 1] - o[:, None, j]) * inv[:, None, j]
        t1 = (hi[:, :, j:j + 1] - o[:, None, j]) * inv[:, None, j]
        tn = torch.maximum(tn, torch.minimum(t0, t1))
        tf = torch.minimum(tf, torch.maximum(t0, t1))
    return torch.where(tn <= tf, tn, BIG).amin(dim=-1)


def _chunked_keys(rays, lo_fn, e):
    """Row-chunked _box_keys: lo_fn(r0, r1) -> (lo, hi) of rows r0:r1."""
    r = rays.shape[0]
    step = max(1, _MAX_ELEMS // max(1, e * 3 * LANES))
    out = []
    for r0 in range(0, r, step):
        lo, hi = lo_fn(r0, min(r, r0 + step))
        out.append(_box_keys(rays[r0:r0 + step], lo, hi))
    if not out:
        return rays.new_zeros((0, e))
    return torch.cat(out)


def refine_ref(rays, ids, live, blo, bhi):
    """Plain kernel #5: keys (R, E) of boxes blo/bhi[ids] for entries below
    each row's live count, BIG beyond it."""
    e = ids.shape[1]
    # entries beyond the live count may hold any id: clamp for the gather
    idl = torch.clamp(ids.long(), 0, blo.shape[0] - 1)
    key = _chunked_keys(rays, lambda a, b: (blo[idl[a:b]], bhi[idl[a:b]]), e)
    col = torch.arange(e, device=ids.device)[None]
    return torch.where(col < live[:, None], key, BIG)


def child_refine_ref(rays, pids, live_p, tab):
    """Plain kernel #6: keys (R, Ep*8), entry p*8 + child, of the 8
    children of each listed parent pids (R, Ep) in tab (Cp, 8, 128), for
    parents below each row's live count, BIG beyond it."""
    r, ep = pids.shape
    # parents beyond the live count may hold any id: clamp for the gather
    pl = torch.clamp(pids.long(), 0, tab.shape[0] - 1)

    def boxes(a, b):
        blk = tab[pl[a:b]]                       # (rc, Ep, 8, 128)
        return (blk[..., 0:3].reshape(b - a, ep * 8, 3),
                blk[..., 3:6].reshape(b - a, ep * 8, 3))

    key = _chunked_keys(rays, boxes, ep * 8)
    col = torch.arange(ep * 8, device=pids.device)[None] // 8
    return torch.where(col < live_p[:, None], key, BIG)


def _mt_items(tri, rays, cap):
    """Möller–Trumbore of rows (Rb, 8, 128) against their staged triangles
    tri (Rb, M, 16) with per-lane cap (Rb, 128) -> (t, u, v, ok) of shape
    (Rb, M, 128), in the kernel's operation order."""
    return mt(tri, [rays[:, None, j] for j in range(3)],
              [rays[:, None, 3 + j] for j in range(3)], rays[:, None, 6],
              cap[:, None])


def _items_block(blk, ry, tb):
    """One item block of the plain closest-hit walk for the rows of ry:
    (improved, t, u, v, prim) per lane."""
    t, u, v, ok = _mt_items(blk, ry, tb)
    # lexicographic (t, sublane, item) minimum: the per-sublane running
    # winner over the items (strict <), then the lowest sublane
    t = torch.where(ok, t, BIG)
    tmin = t.amin(dim=1)
    m = torch.arange(BI * 8, device=t.device)[None, :, None]
    order = (m % 8) * BI + m // 8
    first = torch.where((t == tmin[:, None]) & ok, order,
                        BI * 8).argmin(dim=1, keepdim=True)
    prim = blk[:, :, 15].contiguous().view(torch.int32)
    return (tmin < tb, tmin, torch.gather(u, 1, first)[:, 0],
            torch.gather(v, 1, first)[:, 0],
            torch.gather(prim[:, :, None].expand(-1, -1, LANES), 1,
                         first)[:, 0])


def items_ref(tri, rays, ids, blk_tn, any_hit: bool, work=None):
    """Plain kernel #7: rows walk their item blocks in order, each block
    tested only where its key is within the row's current bound. Returns
    (t, u, v, prim) (R, 128) each, or the occlusion mask (R, 128) bool.
    work: a dict that, if given, receives the triangle tests these inputs
    need, lane by lane: a block's key bounds every lane's entry into its
    clusters from below, so of a tested block a live lane needs its 128
    triangles where the key is within the lane's best t (closest), or its
    triangles up to the first hit where the key is within maxt and the
    lane is not yet occluded (any hit)."""
    r, e3 = ids.shape
    nb = e3 // BI
    dev = rays.device
    occ = torch.zeros((r, LANES), dtype=torch.bool, device=dev)
    bound = rays[:, 7].clone()                  # any-hit skip bound
    tb = rays[:, 7].clone()
    ub = torch.zeros_like(tb)
    vb = torch.zeros_like(tb)
    pb = torch.full((r, LANES), -1, dtype=torch.int32, device=dev)
    live = rays[:, 6] <= rays[:, 7]
    # rows per step: (rows, 128 triangles, 128 lanes) intermediates
    step = max(1, _MAX_ELEMS // (BI * 8 * LANES * 4))
    n_tri = torch.zeros((), dtype=torch.int64, device=dev)
    for b in range(nb):
        todo = torch.nonzero(
            blk_tn[:, b] <= (bound if any_hit else tb).amax(dim=1))[:, 0]
        for c0 in range(0, todo.numel(), step):
            rows = todo[c0:c0 + step]
            cid = ids[rows, b * BI:(b + 1) * BI].long()
            blk = tri[cid][:, :, :, :16].reshape(rows.shape[0], BI * 8, 16)
            ry = rays[rows]
            key = blk_tn[rows, b][:, None]
            if any_hit:
                oc = occ[rows]
                ok = _mt_items(blk, ry, torch.where(oc, ry[:, 6],
                                                    ry[:, 7]))[3]
                if work is not None:
                    n_tri = n_tri + tests_to_first_hit(
                        ok, live[rows] & ~oc & (key <= ry[:, 7]))
                oc = oc | ok.any(dim=1)
                occ[rows] = oc
                bound[rows] = torch.where(oc, ry[:, 6] - 1.0, ry[:, 7])
                continue
            t_rows = tb[rows]
            if work is not None:
                n_tri = n_tri + (live[rows] & (key <= t_rows)).sum() \
                    * (BI * 8)
            improved, tmin, u, v, p = _items_block(blk, ry, t_rows)
            tb[rows] = torch.where(improved, tmin, t_rows)
            ub[rows] = torch.where(improved, u, ub[rows])
            vb[rows] = torch.where(improved, v, vb[rows])
            pb[rows] = torch.where(improved, p, pb[rows])
    if work is not None:
        work.update(tri_tests=int(n_tri))
    if any_hit:
        return occ
    return tb, ub, vb, pb


# ---------------------------------------------------------------------------
# Kernel wrappers: the kernel on CUDA tensors, the plain version on CPU ones
# ---------------------------------------------------------------------------

def _check(*specs):
    """specs: (tensor, dtype, shape with None for any size). Returns True
    for CUDA tensors, False for CPU ones; raises on anything else."""
    dev = specs[0][0].device
    for x, dt, shape in specs:
        if x.dtype != dt:
            raise TypeError(f"expected {dt}, got {x.dtype}")
        if x.dim() != len(shape) or any(
                s is not None and s != n for s, n in zip(shape, x.shape)):
            raise ValueError(f"expected shape {shape}, got {tuple(x.shape)}")
        if not x.is_contiguous() or x.device != dev:
            raise ValueError("inputs must be contiguous, on one device")
    if dev.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"no exact-cull kernels for {dev}")
    return dev.type == "cuda"


def _launch(name, device, *args):
    if name not in _FN:
        build()
    with torch.cuda.device(device):
        err = _FN[name](*args, torch.cuda.current_stream(device).cuda_stream)
    nv.check(err, name)
    LAUNCHES[name] += 1


def _ptr(x):
    return x.data_ptr()


def refine(rays, ids, live, blo, bhi):
    """Kernel #5: exact slab keys (R, E) of the listed boxes."""
    f32, i32 = torch.float32, torch.int32
    r, e = ids.shape
    if not _check((rays, f32, (r, 8, LANES)), (ids, i32, (r, e)),
                  (live, i32, (r,)), (blo, f32, (None, 3)),
                  (bhi, f32, blo.shape)):
        return refine_ref(rays, ids, live, blo, bhi)
    out = torch.empty((r, e), dtype=f32, device=rays.device)
    if r:
        _launch("refine", rays.device, _ptr(rays), _ptr(ids), _ptr(live),
                _ptr(blo), _ptr(bhi), r, e, _ptr(out))
    return out


def child_refine(rays, pids, live_p, tab):
    """Kernel #6: exact slab keys (R, Ep*8) of the listed parents'
    children, child-major."""
    f32, i32 = torch.float32, torch.int32
    r, ep = pids.shape
    if not _check((rays, f32, (r, 8, LANES)), (pids, i32, (r, ep)),
                  (live_p, i32, (r,)), (tab, f32, (None, 8, LANES))):
        return child_refine_ref(rays, pids, live_p, tab)
    out = torch.empty((r, ep * 8), dtype=f32, device=rays.device)
    if r:
        _launch("child_refine", rays.device, _ptr(rays), _ptr(pids),
                _ptr(live_p), _ptr(tab), r, ep, _ptr(out))
    return out


def items(tri, rays, ids, blk_tn, any_hit: bool):
    """Kernel #7: the ordered item walk; (t, u, v, prim) or occlusion."""
    f32, i32 = torch.float32, torch.int32
    r, e3 = ids.shape
    if e3 % BI:
        raise ValueError("item list width must be a multiple of 16")
    if not _check((rays, f32, (r, 8, LANES)), (ids, i32, (r, e3)),
                  (blk_tn, f32, (r, e3 // BI)), (tri, f32, (None, 8, LANES))):
        return items_ref(tri, rays, ids, blk_tn, any_hit)
    dev = rays.device
    t = torch.empty((r, LANES), dtype=f32, device=dev)
    u, v = torch.empty_like(t), torch.empty_like(t)
    p = torch.empty((r, LANES), dtype=i32, device=dev)
    occ = torch.empty((r, LANES), dtype=i32, device=dev)
    if r:
        _launch("items", dev, _ptr(rays), _ptr(ids), _ptr(blk_tn),
                _ptr(tri), r, e3, int(any_hit), _ptr(t), _ptr(u), _ptr(v),
                _ptr(p), _ptr(occ))
    return occ.bool() if any_hit else (t, u, v, p)


# ---------------------------------------------------------------------------
# The hierarchical cull and the queries
# ---------------------------------------------------------------------------

def _sorted_prefix(key, ids, width):
    """Stable sort of each row's keys: the first `width` ids and sorted
    keys, the live count clamped to `width`, and the full live count."""
    key_s, order = torch.sort(key, dim=1, stable=True)
    ids_s = torch.gather(ids, 1, order)
    n = (key < BIG).sum(dim=1)
    return (ids_s[:, :width].contiguous(), key_s[:, :width],
            torch.clamp(n, max=width).to(torch.int32), n)


def _children(ids):
    r = ids.shape[0]
    return (ids[:, :, None] * 8 + torch.arange(
        8, dtype=torch.int32, device=ids.device)).reshape(r, -1)


def build_exact_items(rays, ex, caps):
    """Hierarchical exact cull (exact_pallas.py:342, kernel path). rays
    (R, 8, 128); ex: the geometry's exact tables (GeometryTables.ex_tables).
    Returns (ids (R, E3) int32 K8 cluster ids front to back [0 at dead
    slots], blk_tn (R, E3/16) f32 entry key of each item block [BIG when
    dead], overflow (R,) bool)."""
    e0, e1, e2, e3 = caps
    r = rays.shape[0]
    dev = rays.device
    c2 = ex["b2_lo"].shape[0]
    ct2 = ex["ct2"]
    keep = None
    if ct2.shape[0] * 8 <= e0:
        # all-L2: every root box straight from the root table, exact
        p2 = ct2.shape[0]
        pids = torch.arange(p2, dtype=torch.int32, device=dev)[None] \
            .expand(r, p2).contiguous()
        live_p2 = torch.full((r,), -(-c2 // 8), dtype=torch.int32,
                             device=dev)
        child = torch.arange(p2 * 8, dtype=torch.int32, device=dev)
        key1 = child_refine(rays, pids, live_p2, ct2)
        key1 = torch.where((child < c2)[None], key1, BIG)
        ids0 = child[None].expand(r, p2 * 8)
        n0 = torch.zeros(r, dtype=torch.int64, device=dev)
    else:
        # S0 conservative L2 cull, then S1 exact refine
        ids0f, tns0f = build_sc_lists(rays, ex["b2_lo"], ex["b2_hi"])
        n0 = (tns0f < BIG).sum(dim=1)
        ids0 = ids0f[:, :e0].contiguous()
        keep = tns0f[:, :e0] < BIG
        live0 = torch.clamp(n0, max=e0).to(torch.int32)
        key1 = refine(rays, ids0, live0, ex["b2_lo"], ex["b2_hi"])
        key1 = torch.where(keep, key1, BIG)
    # S2: exact L1 keys of the E1 nearest L2 boxes' children
    ids1, key1s, live1, n1 = _sorted_prefix(key1, ids0, e1)
    key2 = child_refine(rays, ids1, live1, ex["ct1"])
    keep1 = (key1s < BIG).repeat_interleave(8, dim=1)
    key2 = torch.where(keep1, key2, BIG)
    # S3: exact K8 keys of the E2 nearest L1 boxes' children
    ids2, key2s, live2, n2 = _sorted_prefix(key2, _children(ids1), e2)
    key3 = child_refine(rays, ids2, live2, ex["ct0"])
    keep2 = (key2s < BIG).repeat_interleave(8, dim=1)
    key3 = torch.where(keep2, key3, BIG)
    ids3, key3s, _live3, n3 = _sorted_prefix(key3, _children(ids2), e3)
    ids = torch.where(key3s < BIG, ids3, 0).contiguous()
    blk_tn = key3s.reshape(r, e3 // BI, BI)[:, :, 0].contiguous()
    overflow = (n0 > e0) | (n1 > e1) | (n2 > e2) | (n3 > e3)
    return ids, blk_tn, overflow


def _run(ex, o, d, mint, maxt, caps, any_hit):
    """Pack, cull and walk the live rows; rows with no live lane answer
    as misses without being built (the reference skips them per chunk)."""
    # maxt = inf would let the BIG miss sentinel pass `tmin < t_best`;
    # clamp below it (no scene extends past 1e30)
    maxt = torch.clamp(maxt, max=1e30)
    rays, n, n_rows = pack_rays(o, d, mint, maxt)
    live = (rays[:, 7] >= rays[:, 6]).any(dim=1)
    rows = torch.nonzero(live)[:, 0]
    all_live = rows.numel() == n_rows
    rays_l = rays if all_live else rays[rows].contiguous()
    ids, blk_tn, ovf_l = build_exact_items(rays_l, ex, caps)
    res = items(ex["tri"], rays_l, ids, blk_tn, any_hit)
    ovf = torch.zeros(n_rows, dtype=torch.bool, device=rays.device)
    ovf[rows] = ovf_l
    if any_hit:
        out = torch.zeros((n_rows, LANES), dtype=torch.bool,
                          device=rays.device)
        out[rows] = res
        return out, ovf, n
    t = rays[:, 7].clone()
    u = torch.zeros_like(t)
    v = torch.zeros_like(t)
    p = torch.full((n_rows, LANES), -1, dtype=torch.int32,
                   device=rays.device)
    for full, part in zip((t, u, v, p), res):
        full[rows] = part
    return (t, u, v, p), ovf, n


def exact_closest(ex, o, d, mint, maxt, caps):
    """Closest hit. Returns (t, u, v, prim, valid, lane_overflow); lanes
    of overflowing rows hold a partial result (a true hit, not
    necessarily the nearest) and must be re-resolved."""
    (t, u, v, p), ovf, n = _run(ex, o, d, mint, maxt, caps, any_hit=False)
    t, u, v, p = (x.reshape(-1)[:n] for x in (t, u, v, p))
    valid = p >= 0
    lane_ovf = ovf.repeat_interleave(LANES)[:n]
    return (torch.where(valid, t, float("inf")), u, v,
            torch.where(valid, p, 0), valid, lane_ovf)


def exact_any(ex, o, d, mint, maxt, caps):
    """Any-hit / shadow query. Returns (occluded, lane_overflow)."""
    occ, ovf, n = _run(ex, o, d, mint, maxt, caps, any_hit=True)
    return occ.reshape(-1)[:n], ovf.repeat_interleave(LANES)[:n]
