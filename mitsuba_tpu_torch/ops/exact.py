"""Exact-cull item-stream intersector: the five CUDA kernels of its walks
(v5, v6 and v6b), their plain versions, the hierarchical cull around them
and the closest / any-hit queries (port of mitsuba_tpu/ops/exact_pallas.py).

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
prefix. When the root level has at most E0 boxes, S0 and S1 collapse into
one child-refine pass over the root table. Then one of three walks:

  v5   S3, then the item kernel (#7) runs Möller–Trumbore over the row's
       E3 nearest K8 clusters in blocks of 16, skipping blocks behind
       every lane's best hit;
  v6   no S3: the walk (#8) visits the E2 nearest L1 boxes one by one,
       skips an L1 behind every lane's bound, slab-tests its 8 K8 children
       per lane and runs Möller–Trumbore on each child some lane admits;
  v6b  no S3: the walk (#9) takes the L1 list in steps of `V6B_BLM`, one
       ordered skip per step, then Möller–Trumbore on all of the step's
       clusters, dead slots (L1 id 0) included.

A row whose candidate count exceeds a cap is flagged as overflowing: its
result is partial, and the caller re-resolves it (render/intersect.py).
v5 flags E0, E1, E2 and E3; v6 and v6b only E0, E1 and E2, so fewer rows
overflow. All three give the same final hit records.

`walk=None` picks as the TPU package does (exact_pallas.py:951): on the
card v6b, its default on the TPU; on the CPU v5, its default in interpret
mode. The step width `V6B_BLM` is read at call time and clamped per call
to the largest divisor of E2.

On CUDA tensors `refine`, `child_refine`, `items`, `l1_items` and
`l1_masked` launch `csrc/exact.cu`; on CPU tensors they run `refine_ref`,
`child_refine_ref`, `items_ref`, `l1_items_ref` and `l1_masked_ref`, the
same functions in plain PyTorch.
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
V6B_BLM = 16            # L1 blocks per v6b step (exact_pallas.py:1007)
WALKS = ("v5", "v6", "v6b")
# largest (rows, entries, 3, 128) slab intermediate of the plain
# versions, in elements (256 MB of float32)
_MAX_ELEMS = 1 << 26

# kernel launches since import, per kernel (reset by callers that count)
LAUNCHES = {"refine": 0, "child_refine": 0, "items": 0, "l1_items": 0,
            "l1_masked": 0}
_FN = {}


def build() -> str:
    """Compile (once per source hash) and bind the five kernels; returns
    the compiler's output, empty when cached."""
    log = nv.build_all([SOURCE])[SOURCE]
    p, i = ctypes.c_void_p, ctypes.c_int
    _FN["refine"] = nv.bind(SOURCE, "mts_refine", [p] * 5 + [i, i, p, p])
    _FN["child_refine"] = nv.bind(SOURCE, "mts_child_refine",
                                  [p] * 4 + [i, i, p, p])
    _FN["items"] = nv.bind(SOURCE, "mts_items",
                           [p] * 4 + [i, i, i] + [p] * 6)
    _FN["l1_items"] = nv.bind(SOURCE, "mts_l1_items",
                              [p] * 5 + [i, i, i] + [p] * 6)
    _FN["l1_masked"] = nv.bind(SOURCE, "mts_l1_masked",
                               [p] * 4 + [i, i, i, i] + [p] * 6)
    _FN["l1_masked_info"] = nv.bind(SOURCE, "mts_l1_masked_info",
                                    [i, i, i, p])
    _FN["refine_info"] = nv.bind(SOURCE, "mts_refine_info", [i, p])
    _FN["items_info"] = nv.bind(SOURCE, "mts_items_info", [i, i, p])
    _FN["l1_items_info"] = nv.bind(SOURCE, "mts_l1_items_info", [i, i, p])
    return log


def refine_info(child: bool) -> dict:
    """Kernel #6's (child) or #5's resources on the current card: resident
    rows per SM, registers per thread, shared memory bytes per row."""
    return _info("refine_info", int(child))


def _info(name, *args) -> dict:
    if name not in _FN:
        build()
    out = (ctypes.c_int * 3)()
    nv.check(_FN[name](*args, out), name)
    return dict(rows_per_sm=out[0], registers=out[1], smem_bytes=out[2])


def l1_masked_info(e2: int, blm: int, any_hit: bool) -> dict:
    """Kernel #9's resources on the current card at list width e2 and
    step width step_width(e2, blm): resident rows per SM, registers per
    thread, shared memory bytes per row."""
    return _info("l1_masked_info", e2, step_width(e2, blm), int(any_hit))


def items_info(e3: int, any_hit: bool) -> dict:
    """Kernel #7's resources on the current card at list width e3, as
    l1_masked_info."""
    return _info("items_info", e3, int(any_hit))


def l1_items_info(e2: int, any_hit: bool) -> dict:
    """Kernel #8's resources on the current card at list width e2, as
    l1_masked_info."""
    return _info("l1_items_info", e2, int(any_hit))


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
# Plain PyTorch versions of the kernels
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
    """One block of K8 clusters (8 triangles each, in list order) of the
    plain closest-hit walks for the rows of ry: (improved, t, u, v, prim)
    per lane."""
    t, u, v, ok = _mt_items(blk, ry, tb)
    # lexicographic (t, sublane, cluster) minimum: the per-sublane running
    # winner over the clusters (strict <), then the lowest sublane
    t = torch.where(ok, t, BIG)
    tmin = t.amin(dim=1)
    n = blk.shape[1]
    m = torch.arange(n, device=t.device)[None, :, None]
    order = (m % 8) * (n // 8) + m // 8
    first = torch.where((t == tmin[:, None]) & ok, order,
                        n).argmin(dim=1, keepdim=True)
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
    lane is not yet occluded (any hit); `clusters_read`, the distinct
    K8 clusters of tri that some row tests; and `steps_tested`, the
    (row, block) pairs tested."""
    nb = ids.shape[1] // BI
    dev = rays.device
    live, occ, bound, tb, ub, vb, pb = _walk_state(rays)
    # rows per step: (rows, 128 triangles, 128 lanes) intermediates
    step = max(1, _MAX_ELEMS // (BI * 8 * LANES * 4))
    n_tri = torch.zeros((), dtype=torch.int64, device=dev)
    n_steps = 0
    read = torch.zeros(tri.shape[0], dtype=torch.bool, device=dev)
    for b in range(nb):
        todo = torch.nonzero(
            blk_tn[:, b] <= (bound if any_hit else tb).amax(dim=1))[:, 0]
        n_steps += todo.numel()
        for c0 in range(0, todo.numel(), step):
            rows = todo[c0:c0 + step]
            cid = ids[rows, b * BI:(b + 1) * BI].long()
            if work is not None:
                read[cid.reshape(-1)] = True
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
        work.update(tri_tests=int(n_tri), clusters_read=int(read.sum()),
                    steps_tested=n_steps)
    if any_hit:
        return occ
    return tb, ub, vb, pb


def step_width(e2: int, blm: int) -> int:
    """The v6b step: the largest divisor of E2 not above blm
    (exact_pallas.py:918), so that no L1 slot is left untested."""
    blm = max(1, min(int(blm), e2))
    while e2 % blm:
        blm -= 1
    return blm


def _l1_tris(tri, ids):
    """The 64 triangles of each L1 block of ids (Rb, n): its 8 consecutive
    K8 clusters of tri (C8, 8, 128), as (Rb, n * 64, 16) in (L1, cluster,
    sublane) order."""
    rb, n = ids.shape
    return tri.reshape(-1, 64, LANES)[:, :, :16][ids.long()].reshape(
        rb, n * 64, 16)


def _walk_state(rays):
    """The walks' per-lane state: (live, occluded, any-hit skip bound,
    best t, u, v, prim)."""
    r = rays.shape[0]
    tb = rays[:, 7].clone()
    return (rays[:, 6] <= rays[:, 7],
            torch.zeros((r, LANES), dtype=torch.bool, device=rays.device),
            rays[:, 7].clone(), tb, torch.zeros_like(tb),
            torch.zeros_like(tb),
            torch.full((r, LANES), -1, dtype=torch.int32, device=rays.device))


def l1_masked_ref(tri, rays, l1_ids, l1_keys, any_hit: bool, blm: int,
                  work=None):
    """Plain kernel #9 (v6b): rows walk their L1 lists in steps of
    step_width(E2, blm) blocks; a step whose first key is within the
    row's bound tests all of its blm * 64 triangles, dead slots included,
    with the bound of the step's start as the cap. Closest: a running
    winner per sublane over the step (strict <), then the lowest sublane
    among equal t, then strict < against the row's best. Returns (t, u, v,
    prim) (R, 128) each, or the occlusion mask (R, 128) bool. work: a dict
    that, if given, receives the triangle tests these inputs need, lane by
    lane: of a tested step, a live lane needs an L1's 64 triangles where
    the L1's key is within the lane's best t (closest), or its triangles
    up to the first hit where the key is within maxt and the lane is not
    yet occluded (any hit); `clusters_read`, the K8 clusters of the
    distinct L1 blocks that some row tests; and `walk_tests`, the tests
    of all 128 lanes of each step tested, which the walk's contract
    runs."""
    r, e2 = l1_ids.shape
    blm = step_width(e2, blm)
    live, occ, bound, tb, ub, vb, pb = _walk_state(rays)
    step = max(1, _MAX_ELEMS // (blm * 64 * LANES * 4))
    n_tri = torch.zeros((), dtype=torch.int64, device=rays.device)
    n_walk = 0
    read = torch.zeros(tri.shape[0] // 8, dtype=torch.bool,
                       device=rays.device)
    for s in range(0, e2, blm):
        todo = torch.nonzero(
            l1_keys[:, s] <= (bound if any_hit else tb).amax(dim=1))[:, 0]
        n_walk += todo.numel() * blm * 64 * LANES
        for c0 in range(0, todo.numel(), step):
            rows = todo[c0:c0 + step]
            if work is not None:
                read[l1_ids[rows, s:s + blm].long().reshape(-1)] = True
            blk = _l1_tris(tri, l1_ids[rows, s:s + blm])
            keys = l1_keys[rows, s:s + blm]
            ry = rays[rows]
            if any_hit:
                oc = occ[rows]
                ok = _mt_items(blk, ry, torch.where(oc, ry[:, 6],
                                                    ry[:, 7]))[3]
                if work is not None:
                    run = oc.clone()
                    for i in range(blm):
                        ok_i = ok[:, i * 64:(i + 1) * 64]
                        n_tri = n_tri + tests_to_first_hit(
                            ok_i, live[rows] & ~run
                            & (keys[:, i:i + 1] <= ry[:, 7]))
                        run = run | ok_i.any(dim=1)
                oc = oc | ok.any(dim=1)
                occ[rows] = oc
                bound[rows] = torch.where(oc, ry[:, 6] - 1.0, ry[:, 7])
                continue
            t_rows = tb[rows]
            if work is not None:
                n_tri = n_tri + (live[rows][:, None] & (
                    keys[:, :, None] <= t_rows[:, None])).sum() * 64
            improved, tmin, u, v, p = _items_block(blk, ry, t_rows)
            tb[rows] = torch.where(improved, tmin, t_rows)
            ub[rows] = torch.where(improved, u, ub[rows])
            vb[rows] = torch.where(improved, v, vb[rows])
            pb[rows] = torch.where(improved, p, pb[rows])
    if work is not None:
        work.update(tri_tests=int(n_tri), clusters_read=8 * int(read.sum()),
                    walk_tests=n_walk)
    if any_hit:
        return occ
    return tb, ub, vb, pb


def _child_admit(ry, box):
    """Per-lane slab test of each row's 8 child boxes box (Rb, 8, 6)
    against [mint, maxt], with the reciprocal BIG where |d| <= 1e-12
    (exact_pallas.py:682, 707-719): (Rb, 8, 128) bool."""
    d = ry[:, 3:6]
    inv = torch.where(torch.abs(d) > 1e-12, 1.0 / d, BIG)
    tn = ry[:, None, 6].expand(-1, 8, -1)
    tf = ry[:, None, 7].expand(-1, 8, -1)
    for j in range(3):
        t0 = (box[:, :, j:j + 1] - ry[:, None, j]) * inv[:, None, j]
        t1 = (box[:, :, 3 + j:4 + j] - ry[:, None, j]) * inv[:, None, j]
        tn = torch.maximum(tn, torch.minimum(t0, t1))
        tf = torch.minimum(tf, torch.maximum(t0, t1))
    return tn <= tf


def l1_items_ref(tri, ct0, rays, l1_ids, l1_keys, any_hit: bool,
                 work=None):
    """Plain kernel #8 (v6): rows walk their L1 lists one block at a time;
    a block whose key is within the row's bound has its 8 K8 children
    slab-tested per lane (`_child_admit`), and each child some lane admits
    is Möller–Trumbore-tested on all 128 lanes, then merged: the lowest
    sublane among the child's nearest hits, strict < against the row's
    best (closest), or occlusion with cap mint once occluded (any). The
    children of a block are tested at once with the bound of the block's
    start and merged in order; a cap can only shrink within the block,
    and a hit beyond the shrunk cap never wins the strict <, so this is
    the kernel's result. Returns what l1_masked_ref does. work: box tests
    (8 per tested block and live lane) and triangle tests (closest: the 8
    of each child the lane's own slab admits; any: up to the first hit of
    such children while not yet occluded); `l1_read`, the distinct L1
    blocks whose child boxes some row tests, and `clusters_read`, the
    distinct children some row tests; `l1_tested`, the (row, L1) pairs
    tested, with `children_row`, the children their rows admit (each
    tested on all 128 lanes), and `children_lane`, those each live lane's
    own slab admits, over `lane_l1s`, the live lanes of those pairs."""
    r, e2 = l1_ids.shape
    live, occ, bound, tb, ub, vb, pb = _walk_state(rays)
    step = max(1, _MAX_ELEMS // (64 * LANES * 4))
    n_box = n_tri = torch.zeros((), dtype=torch.int64, device=rays.device)
    n_row = n_lane = n_lanes = torch.zeros((), dtype=torch.int64,
                                           device=rays.device)
    n_l1 = 0
    read = torch.zeros((ct0.shape[0], 8), dtype=torch.bool,
                       device=rays.device)
    l1_read = torch.zeros(ct0.shape[0], dtype=torch.bool, device=rays.device)
    sub = torch.arange(8, device=rays.device)[None, :, None]
    for s in range(e2):
        todo = torch.nonzero(
            l1_keys[:, s] <= (bound if any_hit else tb).amax(dim=1))[:, 0]
        for c0 in range(0, todo.numel(), step):
            rows = todo[c0:c0 + step]
            ids = l1_ids[rows, s:s + 1]
            ry = rays[rows]
            adm = _child_admit(ry, ct0[ids[:, 0].long()][:, :, :6])
            row_adm = adm.any(dim=2)                     # (Rb, 8)
            blk = _l1_tris(tri, ids)
            lv = live[rows]
            if work is not None:
                l1_read[ids[:, 0].long()] = True
                read.view(-1)[(ids.long() * 8 + sub[:, :, 0])[row_adm]] = True
                n_box = n_box + (lv & ~occ[rows] if any_hit
                                 else lv).sum() * 8
                n_l1 += rows.numel()
                n_row = n_row + row_adm.sum()
                n_lane = n_lane + (adm & lv[:, None]).sum()
                n_lanes = n_lanes + lv.sum()
            if any_hit:
                oc = occ[rows]
                ok = _mt_items(blk, ry, torch.where(oc, ry[:, 6],
                                                    ry[:, 7]))[3]
                ok = ok & row_adm.repeat_interleave(8, dim=1)[:, :, None]
                if work is not None:
                    run = oc.clone()
                    for c in range(8):
                        ok_c = ok[:, c * 8:(c + 1) * 8]
                        n_tri = n_tri + tests_to_first_hit(
                            ok_c, lv & ~run & adm[:, c])
                        run = run | ok_c.any(dim=1)
                oc = oc | ok.any(dim=1)
                occ[rows] = oc
                bound[rows] = torch.where(oc, ry[:, 6] - 1.0, ry[:, 7])
                continue
            t_rows, u_rows, v_rows, p_rows = tb[rows], ub[rows], vb[rows], \
                pb[rows]
            if work is not None:
                n_tri = n_tri + (lv[:, None] & adm).sum() * 8
            t, u, v, ok = _mt_items(blk, ry, t_rows)
            t = torch.where(ok, t, BIG)
            prim = blk[:, :, 15].contiguous().view(torch.int32)
            for c in range(8):
                tc = t[:, c * 8:(c + 1) * 8]
                tmin = tc.amin(dim=1)
                first = torch.where(tc == tmin[:, None], sub, 8).argmin(
                    dim=1, keepdim=True) + c * 8
                improved = (tmin < t_rows) & row_adm[:, c:c + 1]
                t_rows = torch.where(improved, tmin, t_rows)
                u_rows = torch.where(improved,
                                     torch.gather(u, 1, first)[:, 0], u_rows)
                v_rows = torch.where(improved,
                                     torch.gather(v, 1, first)[:, 0], v_rows)
                p_rows = torch.where(improved, torch.gather(
                    prim[:, :, None].expand(-1, -1, LANES), 1, first)[:, 0],
                    p_rows)
            tb[rows], ub[rows], vb[rows], pb[rows] = (t_rows, u_rows, v_rows,
                                                      p_rows)
    if work is not None:
        work.update(box_tests=int(n_box), tri_tests=int(n_tri),
                    l1_read=int(l1_read.sum()), clusters_read=int(read.sum()),
                    l1_tested=n_l1, children_row=int(n_row),
                    children_lane=int(n_lane), lane_l1s=int(n_lanes))
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
    nv.refuse_grad(*(x for x, _, _ in specs))
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
    return _walk_launch("items", (_ptr(rays), _ptr(ids), _ptr(blk_tn),
                                  _ptr(tri), r, e3), r, any_hit, rays.device)


def _walk_launch(kernel, args, r, any_hit, dev):
    """Launch an item walk on `args` and its outputs: (t, u, v, prim) or
    the occlusion mask."""
    f32, i32 = torch.float32, torch.int32
    t = torch.empty((r, LANES), dtype=f32, device=dev)
    u, v = torch.empty_like(t), torch.empty_like(t)
    p = torch.empty((r, LANES), dtype=i32, device=dev)
    occ = torch.empty((r, LANES), dtype=i32, device=dev)
    if r:
        _launch(kernel, dev, *args, int(any_hit), _ptr(t), _ptr(u), _ptr(v),
                _ptr(p), _ptr(occ))
    return occ.bool() if any_hit else (t, u, v, p)


def _l1_specs(tri, rays, l1_ids, l1_keys):
    f32, i32 = torch.float32, torch.int32
    r, e2 = l1_ids.shape
    if tri.shape[0] % 8:
        raise ValueError("the K8 table must hold whole L1 blocks")
    return ((rays, f32, (r, 8, LANES)), (l1_ids, i32, (r, e2)),
            (l1_keys, f32, (r, e2)), (tri, f32, (None, 8, LANES)))


def l1_items(tri, ct0, rays, l1_ids, l1_keys, any_hit: bool):
    """Kernel #8: the v6 walk; (t, u, v, prim) or occlusion."""
    r, e2 = l1_ids.shape
    if not _check(*_l1_specs(tri, rays, l1_ids, l1_keys),
                  (ct0, torch.float32, (tri.shape[0] // 8, 8, LANES))):
        return l1_items_ref(tri, ct0, rays, l1_ids, l1_keys, any_hit)
    return _walk_launch("l1_items", (_ptr(rays), _ptr(l1_ids),
                                     _ptr(l1_keys), _ptr(tri), _ptr(ct0), r,
                                     e2), r, any_hit, rays.device)


def l1_masked(tri, rays, l1_ids, l1_keys, any_hit: bool, blm: int):
    """Kernel #9: the v6b walk in steps of step_width(E2, blm) L1 blocks;
    (t, u, v, prim) or occlusion."""
    r, e2 = l1_ids.shape
    if not _check(*_l1_specs(tri, rays, l1_ids, l1_keys)):
        return l1_masked_ref(tri, rays, l1_ids, l1_keys, any_hit, blm)
    return _walk_launch("l1_masked", (_ptr(rays), _ptr(l1_ids),
                                      _ptr(l1_keys), _ptr(tri), r, e2,
                                      step_width(e2, blm)),
                        r, any_hit, rays.device)


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


def _cull_l1(rays, ex, caps):
    """S0-S2 of the cull: (L1 ids (R, E1*8) int32, their exact keys, BIG
    where dead, and the rows' S0/S1 overflow (n0 > E0) | (n1 > E1))."""
    e0, e1 = caps[:2]
    r = rays.shape[0]
    dev = rays.device
    c2 = ex["b2_lo"].shape[0]
    ct2 = ex["ct2"]
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
    return _children(ids1), key2, (n0 > e0) | (n1 > e1)


def build_exact_l1(rays, ex, caps):
    """The v6 build, the S0-S2 prefix of build_exact_items
    (exact_pallas.py:432): (l1_ids (R, E2) int32 L1 ids front to back [0
    at dead slots], l1_keys (R, E2) f32 sorted entry keys [BIG at dead
    slots], overflow (R,) bool = (n0 > E0) | (n1 > E1) | (n2 > E2))."""
    ids64, key2, ovf = _cull_l1(rays, ex, caps)
    ids2, key2s, _live2, n2 = _sorted_prefix(key2, ids64, caps[2])
    return (torch.where(key2s < BIG, ids2, 0).contiguous(),
            key2s.contiguous(), ovf | (n2 > caps[2]))


def build_exact_items(rays, ex, caps):
    """Hierarchical exact cull (exact_pallas.py:342, kernel path). rays
    (R, 8, 128); ex: the geometry's exact tables (GeometryTables.ex_tables).
    Returns (ids (R, E3) int32 K8 cluster ids front to back [0 at dead
    slots], blk_tn (R, E3/16) f32 entry key of each item block [BIG when
    dead], overflow (R,) bool)."""
    e2, e3 = caps[2:]
    r = rays.shape[0]
    ids64, key2, ovf = _cull_l1(rays, ex, caps)
    # S3: exact K8 keys of the E2 nearest L1 boxes' children
    ids2, key2s, live2, n2 = _sorted_prefix(key2, ids64, e2)
    key3 = child_refine(rays, ids2, live2, ex["ct0"])
    keep2 = (key2s < BIG).repeat_interleave(8, dim=1)
    key3 = torch.where(keep2, key3, BIG)
    ids3, key3s, _live3, n3 = _sorted_prefix(key3, _children(ids2), e3)
    ids = torch.where(key3s < BIG, ids3, 0).contiguous()
    blk_tn = key3s.reshape(r, e3 // BI, BI)[:, :, 0].contiguous()
    return ids, blk_tn, ovf | (n2 > e2) | (n3 > e3)


def resolve_walk(walk, device) -> str:
    """The item walk of a query: `walk` if given, else v6b on the card
    and v5 on the CPU (exact_pallas.py:951-971)."""
    if walk is None:
        walk = "v6b" if torch.device(device).type == "cuda" else "v5"
    if walk not in WALKS:
        raise ValueError(f"unknown item walk '{walk}' (one of {WALKS})")
    return walk


def _walk(ex, rays, caps, any_hit, walk):
    """Cull and walk rows: (result, overflow)."""
    if walk == "v5":
        ids, blk_tn, ovf = build_exact_items(rays, ex, caps)
        return items(ex["tri"], rays, ids, blk_tn, any_hit), ovf
    l1_ids, l1_keys, ovf = build_exact_l1(rays, ex, caps)
    if walk == "v6":
        return l1_items(ex["tri"], ex["ct0"], rays, l1_ids, l1_keys,
                        any_hit), ovf
    return l1_masked(ex["tri"], rays, l1_ids, l1_keys, any_hit,
                     V6B_BLM), ovf


def _run(ex, o, d, mint, maxt, caps, any_hit, walk):
    """Pack, cull and walk the live rows; rows with no live lane answer
    as misses without being built (the reference skips them per chunk)."""
    walk = resolve_walk(walk, o.device)
    # maxt = inf would let the BIG miss sentinel pass `tmin < t_best`;
    # clamp below it (no scene extends past 1e30)
    maxt = torch.clamp(maxt, max=1e30)
    rays, n, n_rows = pack_rays(o, d, mint, maxt)
    live = (rays[:, 7] >= rays[:, 6]).any(dim=1)
    rows = torch.nonzero(live)[:, 0]
    ovf = torch.zeros(n_rows, dtype=torch.bool, device=rays.device)
    if any_hit:
        out = torch.zeros((n_rows, LANES), dtype=torch.bool,
                          device=rays.device)
    else:
        t = rays[:, 7].clone()
        u = torch.zeros_like(t)
        v = torch.zeros_like(t)
        p = torch.full((n_rows, LANES), -1, dtype=torch.int32,
                       device=rays.device)
        out = (t, u, v, p)
    if rows.numel() == 0:
        # no live lane (a wavefront's first shadow query): all miss
        return out, ovf, n
    rays_l = rays if rows.numel() == n_rows else rays[rows].contiguous()
    res, ovf_l = _walk(ex, rays_l, caps, any_hit, walk)
    ovf[rows] = ovf_l
    if any_hit:
        out[rows] = res
        return out, ovf, n
    for full, part in zip(out, res):
        full[rows] = part
    return out, ovf, n


def exact_closest(ex, o, d, mint, maxt, caps, walk=None):
    """Closest hit. Returns (t, u, v, prim, valid, lane_overflow); lanes
    of overflowing rows hold a partial result (a true hit, not
    necessarily the nearest) and must be re-resolved. walk: 'v5', 'v6',
    'v6b' or None (resolve_walk)."""
    (t, u, v, p), ovf, n = _run(ex, o, d, mint, maxt, caps, False, walk)
    t, u, v, p = (x.reshape(-1)[:n] for x in (t, u, v, p))
    valid = p >= 0
    lane_ovf = ovf.repeat_interleave(LANES)[:n]
    return (torch.where(valid, t, float("inf")), u, v,
            torch.where(valid, p, 0), valid, lane_ovf)


def exact_any(ex, o, d, mint, maxt, caps, walk=None):
    """Any-hit / shadow query. Returns (occluded, lane_overflow)."""
    occ, ovf, n = _run(ex, o, d, mint, maxt, caps, True, walk)
    return occ.reshape(-1)[:n], ovf.repeat_interleave(LANES)[:n]
