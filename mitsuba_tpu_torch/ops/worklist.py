"""Work-list cluster intersector: the beam-cull build, the CUDA kernels and
their plain versions (port of mitsuba_tpu/ops/worklist_pallas.py, TPU
kernels `_make_closest_kernel` :364, `_make_any_kernel` :458 and
`_make_probe_kernel` :424, entry `_call_chunk` :548 via `wl_closest` :594,
`wl_any` :619 and `wl_probe` :448).

A query packs its rays into 128-lane rows (ops/rows.py) and, per chunk of
rows, builds one flat work list of (row, cluster) items by a three-level
beam cull of each row's conservative interval: groups of 8 superclusters
(keep the `beam_s2` nearest), their superclusters (keep `l_sc`), their
clusters, front to back by entry distance; every sort is stable. Items
are packed in one int32 (cid | first | valid | row) into a list of
`w_cap = rows * w_factor` slots. A row whose candidates exceed a beam or
whose items do not fit the list overflows: its result is partial (a true
hit, not necessarily the nearest), and the caller re-resolves its lanes
(render/intersect.py, through the BVH walk).

The kernel then walks each row's items in order: per item a per-lane slab
test against the lane's best t decides, across the row, whether the
cluster can improve any lane; if so Möller–Trumbore over its 32 triangles,
with the TPU kernel's tie rules (two chunk parities within a sublane, the
lowest k_run * 8 + sublane among equal t, strict `t < best t` across
items). Any-hit mode tests every valid item and stops once the whole row
is occluded. In instanced mode an item's cluster names a shared
object-space block (`block_id`) and a world->object transform (`xform`):
the rays move into object space and t carries over unchanged.

The chunking exists on the TPU to bound its scalar memory; the card has no
such bound, but the chunk size fixes `w_cap` and so which rows overflow,
so the port keeps it, with the reference's default beams, as constants.

The probe (`wl_probe`, a cost probe, on no render path) walks the same
lists without Möller–Trumbore: per valid item it fetches the cluster block
and slab-tests each lane against [mint, maxt], and each lane accumulates
(acc + pass) + tri[cid, 0, 0], so that the fixed cost of an item can be
set against its full cost (mitsuba_tpu_torch/probes/r3_kernel.py). On the
card it is an instance of the intersector's own walk (its compaction,
staging and one barrier per item), with the tests left out.

The list's slots past its `total` (or past w_cap, where the list
overflowed) are padding, neither valid nor first, that the build gives
to the last row. The TPU kernel's grid walks all `w_cap` slots; the port
ends each row's run at the list's last used slot (`row_segments`' end,
`total`), which changes no output: on the card the last row's block
would otherwise walk tens of thousands of unused slots, one by one,
after every other row has finished.

On CUDA tensors `wl_rows` and `wl_probe_rows` launch `csrc/worklist.cu`;
on CPU tensors they run `wl_rows_ref` and `wl_probe_ref`, the same walks
in plain PyTorch.

One deliberate difference from the reference: rays enter with maxt
clamped to 1e30. With maxt = inf the reference's closest kernel takes its
3e38 miss sentinel for a hit (`tmin < tb`), so a lane that escapes in a
row that tests some cluster reports a hit at t = 3e38.
"""
from __future__ import annotations

import ctypes

import torch

from mitsuba_tpu_torch.ops import build as nv
from mitsuba_tpu_torch.ops.rows import (
    BIG, LANES, interval_slab, pack_rays, row_intervals,
)
from mitsuba_tpu_torch.ops.stream import mt, slab, tests_to_first_hit, visit

SOURCE = nv.source("worklist.cu")
# the reference's render-path beams and its per-call item cap
# (worklist_pallas.py:61-69), as plain constants
W_FACTOR = 48
L_SC = 48
BEAM_S2 = 16
MAX_ITEMS_PER_CALL = 131072

# packed work item (int32): [0:14] cid, [14] first, [15] valid, [16:31] row
_CID_BITS = 14
_FIRST_BIT = 1 << _CID_BITS
_VALID_BIT = 1 << (_CID_BITS + 1)
_ROW_SHIFT = _CID_BITS + 2
MAX_CLUSTERS = _FIRST_BIT
MAX_ROWS = 1 << (31 - _ROW_SHIFT)
MAX_K = 128         # the kernel stages at most (128, 16) floats per item

# kernel launches since import, per query (reset by callers that count)
LAUNCHES = {"wl_closest": 0, "wl_any": 0, "wl_probe": 0}
_FN = None
_PROBE_FN = None
_INFO = None
_PROBE_INFO = None
# the reference's defaults for the probe (worklist_pallas.py:448-449, 63)
PROBE_W_FACTOR = 16
PROBE_L_SC = 24


def build() -> str:
    """Compile (once per source hash) and bind the kernel; returns the
    compiler's output, empty when cached."""
    global _FN, _PROBE_FN, _INFO, _PROBE_INFO
    log = nv.build_all([SOURCE])[SOURCE]
    p, i = ctypes.c_void_p, ctypes.c_int
    _FN = nv.bind(SOURCE, "mts_worklist", [p] * 7 + [i] * 3 + [p] * 6)
    _PROBE_FN = nv.bind(SOURCE, "mts_worklist_probe", [p] * 4 + [i, i, p, p])
    _INFO = nv.bind(SOURCE, "mts_worklist_info", [i, i, i, p])
    _PROBE_INFO = nv.bind(SOURCE, "mts_worklist_probe_info", [i, p])
    return log


def _resources(out) -> dict:
    return dict(rows_per_sm=out[0], registers=out[1], smem_bytes=out[2],
                local_bytes=out[3])


def wl_info(k_cl: int, any_hit: bool, instanced: bool) -> dict:
    """The kernel's resources on the current card at cluster size k_cl:
    resident rows per SM, registers per thread, shared memory bytes per
    row and local (spill) bytes per thread."""
    if _INFO is None:
        build()
    out = (ctypes.c_int * 4)()
    nv.check(_INFO(k_cl, int(any_hit), int(instanced), out), "wl_info")
    return _resources(out)


def wl_probe_info(k_cl: int) -> dict:
    """wl_info of the probe's instance of the walk (flat, closest)."""
    if _PROBE_INFO is None:
        build()
    out = (ctypes.c_int * 4)()
    nv.check(_PROBE_INFO(k_cl, out), "wl_probe_info")
    return _resources(out)


# ---------------------------------------------------------------------------
# The beam cull (plain PyTorch on any device)
# ---------------------------------------------------------------------------

def _beam_stage(bmin, bmax, ids, ok_in, beam, row_ctx):
    """Slab-test candidate boxes, sort each row's candidates by entry
    distance (stable), keep the `beam` nearest. Returns (ids, ok, count of
    true hits)."""
    hit, tn = interval_slab(bmin, bmax, *row_ctx)
    hit = hit & ok_in
    key = torch.where(hit, tn, BIG)
    key_s, order = torch.sort(key, dim=1, stable=True)
    ids_s = torch.gather(ids, 1, order)
    count = hit.sum(dim=1)
    return ids_s[:, :beam], key_s[:, :beam] < BIG, count


def _children(ids, ok, n_boxes):
    """The 8 children of each kept box: (ids, ok), ids clamped in range."""
    n_rows = ids.shape[0]
    cand = (ids[:, :, None] * 8 + torch.arange(
        8, dtype=ids.dtype, device=ids.device)).reshape(n_rows, -1)
    ok = torch.repeat_interleave(ok, 8, dim=1) & (cand < n_boxes)
    return torch.clamp(cand, max=n_boxes - 1), ok


def build_worklist(rays, cl_bmin, cl_bmax, sc_bmin, sc_bmax, w_cap: int,
                   l_sc: int, beam_s2: int):
    """The flat (row, cluster) work list of rays (R, 8, 128) by the
    three-level beam cull (worklist_pallas.py:150-250). Returns (items
    (w_cap,) int32 packed, total int, overflow (R,) bool). Items are
    row-major and front to back within a row; every row gets at least one
    slot (a row with no candidate gets one invalid `first` item)."""
    n_cl = cl_bmin.shape[0]
    if n_cl > MAX_CLUSTERS:
        raise ValueError(f"{n_cl} clusters exceed the work list's "
                         f"{MAX_CLUSTERS}-cluster id space")
    n_rows = rays.shape[0]
    if n_rows > MAX_ROWS:
        raise ValueError(f"{n_rows} rows exceed {MAX_ROWS}")
    dev = rays.device
    c_s = sc_bmin.shape[0]
    row_ctx = row_intervals(rays)

    # groups of 8 consecutive superclusters
    c_s2 = -(-c_s // 8)
    beam_s2 = min(beam_s2, c_s2)
    l_sc = min(l_sc, beam_s2 * 8, c_s)
    pad = c_s2 * 8 - c_s
    s2_bmin = torch.cat([sc_bmin, sc_bmin.new_full((pad, 3), BIG)]) \
        .reshape(c_s2, 8, 3).amin(dim=1)
    s2_bmax = torch.cat([sc_bmax, sc_bmax.new_full((pad, 3), -BIG)]) \
        .reshape(c_s2, 8, 3).amax(dim=1)
    s2_ids = torch.arange(c_s2, dtype=torch.int64, device=dev)[None] \
        .expand(n_rows, c_s2)
    ids2, ok2, cnt2 = _beam_stage(
        s2_bmin, s2_bmax, s2_ids,
        torch.ones((n_rows, c_s2), dtype=torch.bool, device=dev), beam_s2,
        row_ctx)
    overflow = cnt2 > beam_s2

    # superclusters of the kept groups
    sc_boxes = torch.cat([sc_bmin, sc_bmax], dim=1)
    sc_cand, sc_in = _children(ids2, ok2, c_s)
    sc_g = sc_boxes[sc_cand]
    sc_ids, sc_ok, cnt_sc = _beam_stage(
        sc_g[..., 0:3], sc_g[..., 3:6], sc_cand, sc_in, l_sc, row_ctx)
    overflow = overflow | (cnt_sc > l_sc)

    # clusters of the kept superclusters, front to back
    cl_boxes = torch.cat([cl_bmin, cl_bmax], dim=1)
    cand, cl_in = _children(sc_ids, sc_ok, n_cl)
    cl_g = cl_boxes[cand]
    hit_b, tn_b = interval_slab(cl_g[..., 0:3], cl_g[..., 3:6], *row_ctx)
    hit_b = hit_b & cl_in
    key_b = torch.where(hit_b, tn_b, BIG)
    _key_s, perm = torch.sort(key_b, dim=1, stable=True)
    order = torch.gather(cand, 1, perm)
    counts = hit_b.sum(dim=1)

    # flat packing: row r owns slots [off[r], off[r] + max(counts[r], 1));
    # a slot's row and segment start come from scatter-max + cummax
    eff = torch.clamp(counts, min=1)
    off = torch.cat([counts.new_zeros(1), torch.cumsum(eff, 0)])
    total = int(off[-1])
    w = torch.arange(w_cap, dtype=torch.int64, device=dev)
    starts = torch.clamp(off[:-1], max=w_cap - 1)
    rows = torch.arange(n_rows, dtype=torch.int64, device=dev)
    rmark = torch.zeros(w_cap, dtype=torch.int64, device=dev) \
        .scatter_reduce(0, starts, rows, reduce="amax")
    r = torch.cummax(rmark, 0).values
    smark = torch.zeros(w_cap, dtype=torch.int64, device=dev) \
        .scatter_reduce(0, starts, starts, reduce="amax")
    seg_start = torch.cummax(smark, 0).values
    k = w - seg_start
    real = w < total
    valid = real & (k < counts[r])
    first = real & (k == 0)
    kc = torch.clamp(k, max=order.shape[1] - 1)
    cid = order[r, kc]
    items = (cid | torch.where(first, _FIRST_BIT, 0)
             | torch.where(valid, _VALID_BIT, 0) | (r << _ROW_SHIFT))
    # padding slots: the last row and cluster, neither first nor valid
    pad_item = ((n_rows - 1) << _ROW_SHIFT) | cid[-1]
    items = torch.where(real, items, pad_item)
    overflow = overflow | (off[:-1] + counts > w_cap)
    return items.to(torch.int32), total, overflow


def row_segments(items, n_rows, end=None):
    """(R + 1,) int32 bounds of each row's run of slots in the row-major
    item list. end: the list's `total` (build_worklist); the runs then end
    at its last used slot, min(total, w_cap), and the padding slots past
    it, neither valid nor first, fall out of the last row's run. Without
    it the last row's run ends at w_cap, as the TPU kernel's grid does."""
    # rows are non-decreasing along the list, so bounds searched among
    # its first `end` slots are the full list's, capped at end
    used = items if end is None else items[:int(end)]
    item_row = (used >> _ROW_SHIFT).to(torch.int64)
    bounds = torch.arange(n_rows + 1, dtype=torch.int64, device=items.device)
    return torch.searchsorted(item_row, bounds).to(torch.int32)


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def _xform_rays(ry, xf):
    """Rays (Ra, 8, 128) into object space by each row's 3x4 row-major
    world->object map xf (Ra, 16), in the kernel's operation order;
    mint and maxt carry over (worklist_pallas.py:344-361)."""
    m = [xf[:, j:j + 1] for j in range(12)]
    o = [ry[:, j] for j in range(3)]
    d = [ry[:, 3 + j] for j in range(3)]
    po = [m[4 * r] * o[0] + m[4 * r + 1] * o[1] + m[4 * r + 2] * o[2]
          + m[4 * r + 3] for r in range(3)]
    pd = [m[4 * r] * d[0] + m[4 * r + 1] * d[1] + m[4 * r + 2] * d[2]
          for r in range(3)]
    return po, pd


def wl_rows_ref(items, seg, tri, tri_start, rays, block_id, xform,
                any_hit: bool, work=None):
    """Plain version of the kernel, row for row: each row walks its slots
    seg[r]:seg[r + 1] of items in order. tri (B, K, 16); block_id (C,)
    and xform (C, 16) in instanced mode, else None. Returns (t, u, v,
    prim) (R, 128) each, or the occlusion mask (R, 128). Rows advance
    together through a loop over slot positions. work: a dict that, if
    given, receives the tests these inputs need, lane by lane, over the
    valid items: `visits`, the lanes that take part in an item (each a
    ray transform in instanced mode, and in closest mode a slab test):
    closest, every live lane; any hit, every live lane not yet occluded;
    and `tri_tests`: closest, K for each lane whose slab test passed; any
    hit, each visiting lane's tests up to its first hit."""
    n_rows = rays.shape[0]
    dev = rays.device
    k_cl = tri.shape[1]
    lo = seg[:-1].to(torch.int64)
    n_items = seg[1:].to(torch.int64) - lo
    mnb_all, maxt = rays[:, 6], rays[:, 7]
    live_all = mnb_all <= maxt
    occ = torch.zeros((n_rows, LANES), dtype=torch.bool, device=dev)
    tb = maxt.clone()
    ub = torch.zeros_like(tb)
    vb = torch.zeros_like(tb)
    pb = torch.full((n_rows, LANES), -1, dtype=torch.int32, device=dev)
    n_visit = n_tri = torch.zeros((), dtype=torch.int64, device=dev)
    for i in range(int(n_items.max()) if n_rows else 0):
        sel = n_items > i
        if any_hit:
            sel = sel & ~occ.all(dim=1)
        item = torch.where(sel, items[torch.clamp(lo + i, max=items.shape[0]
                                                  - 1)], 0)
        sel = sel & ((item & _VALID_BIT) != 0)
        rows = torch.nonzero(sel)[:, 0]
        if rows.numel() == 0:
            continue
        cid = (item[rows] & (_FIRST_BIT - 1)).long()
        blk = tri[block_id[cid].long() if block_id is not None else cid]
        ry = rays[rows]
        if xform is not None:
            o, d = _xform_rays(ry, xform[cid])
        else:
            o = [ry[:, j] for j in range(3)]
            d = [ry[:, 3 + j] for j in range(3)]
        mnb = mnb_all[rows]
        live = live_all[rows]
        if any_hit:
            _t, _u, _v, ok = mt(blk, [x[:, None] for x in o],
                                [x[:, None] for x in d], mnb[:, None],
                                maxt[rows][:, None])
            if work is not None:
                need = live & ~occ[rows]
                n_visit = n_visit + need.sum()
                n_tri = n_tri + tests_to_first_hit(ok, need)
            occ[rows] = occ[rows] | ok.any(dim=1)
            continue
        t_b = tb[rows]
        can = slab(blk[:, 0, 9:15], o, d, mnb, t_b)
        if work is not None:
            n_visit = n_visit + live.sum()
            n_tri = n_tri + can.sum() * k_cl
        vis = torch.nonzero(can.any(dim=1))[:, 0]
        if vis.numel() == 0:
            continue
        rv = rows[vis]
        tv = t_b[vis]
        tmin, usel, vsel, psel = visit(
            blk[vis], [x[vis][:, None] for x in o],
            [x[vis][:, None] for x in d], mnb[vis][:, None], tv[:, None])
        improved = tmin < tv
        prim_new = (tri_start[cid[vis]][:, None] + psel).to(torch.int32)
        tb[rv] = torch.where(improved, tmin, tv)
        ub[rv] = torch.where(improved, usel, ub[rv])
        vb[rv] = torch.where(improved, vsel, vb[rv])
        pb[rv] = torch.where(improved, prim_new, pb[rv])
    if work is not None:
        work.update(visits=int(n_visit), tri_tests=int(n_tri))
    if any_hit:
        return occ
    return tb, ub, vb, pb


def wl_probe_ref(items, seg, tri, rays):
    """Plain version of the probe kernel: each row walks its slots
    seg[r]:seg[r + 1] in order, and for each valid item every lane adds
    its slab pass of the item's block box (row 0, columns 9:15) against
    [mint, maxt], then the block's first float: acc = (acc + pass) +
    tri[cid, 0, 0] (worklist_pallas.py:438-441). (R, 128) float32; a row
    without a valid item reads 0."""
    n_rows = rays.shape[0]
    lo = seg[:-1].to(torch.int64)
    n_items = seg[1:].to(torch.int64) - lo
    acc = torch.zeros((n_rows, LANES), dtype=torch.float32,
                      device=rays.device)
    for i in range(int(n_items.max()) if n_rows else 0):
        sel = n_items > i
        item = torch.where(sel, items[torch.clamp(lo + i, max=items.shape[0]
                                                  - 1)], 0)
        rows = torch.nonzero(sel & ((item & _VALID_BIT) != 0))[:, 0]
        if rows.numel() == 0:
            continue
        blk = tri[(item[rows] & (_FIRST_BIT - 1)).long()]
        ry = rays[rows]
        can = slab(blk[:, 0, 9:15], [ry[:, j] for j in range(3)],
                   [ry[:, 3 + j] for j in range(3)], ry[:, 6], ry[:, 7])
        acc[rows] = (acc[rows] + can.to(torch.float32)) + blk[:, 0, 0:1]
    return acc


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check(items, seg, tri, tri_start, rays, block_id, xform):
    r = rays.shape[0]
    specs = [(items, torch.int32, (items.shape[0],)),
             (seg, torch.int32, (r + 1,)),
             (tri, torch.float32, (tri.shape[0], tri.shape[1], 16)),
             (rays, torch.float32, (r, 8, LANES))]
    if tri_start is not None:                   # the probe takes none
        c = tri_start.shape[0]
        specs.append((tri_start, torch.int32, (c,)))
    if (block_id is None) != (xform is None):
        raise ValueError("block_id and xform come together")
    if block_id is not None:
        specs += [(block_id, torch.int32, (c,)),
                  (xform, torch.float32, (c, 16))]
    for x, dt, shape in specs:
        if x.dtype != dt or tuple(x.shape) != shape:
            raise ValueError(f"expected {dt} {shape}, got {x.dtype} "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous() or x.device != rays.device:
            raise ValueError("inputs must be contiguous, on one device")
    if tri.shape[1] % 8 or not 0 < tri.shape[1] <= MAX_K:
        raise ValueError(f"cluster size must be a multiple of 8 up to "
                         f"{MAX_K}")
    nv.refuse_grad(tri, rays, xform)


def wl_rows(items, seg, tri, tri_start, rays, block_id, xform,
            any_hit: bool):
    """The work-list kernel on CUDA tensors, its plain version on CPU
    ones."""
    _check(items, seg, tri, tri_start, rays, block_id, xform)
    if rays.device.type == "cpu":
        return wl_rows_ref(items, seg, tri, tri_start, rays, block_id, xform,
                           any_hit)
    if rays.device.type != "cuda":
        raise NotImplementedError(f"no work-list kernel for {rays.device}")
    if _FN is None:
        build()
    if tri.data_ptr() % 16 or (xform is not None and xform.data_ptr() % 16):
        raise ValueError("the kernel stages tri and xform in 16-byte "
                         "pieces: both must be 16-byte aligned")
    r = rays.shape[0]
    dev = rays.device
    inst = block_id is not None
    with torch.cuda.device(dev):
        t = torch.empty((r, LANES), dtype=torch.float32, device=dev)
        u = torch.empty_like(t)
        v = torch.empty_like(t)
        p = torch.empty((r, LANES), dtype=torch.int32, device=dev)
        occ = torch.empty((r, LANES), dtype=torch.int32, device=dev)
        err = _FN(items.data_ptr(), seg.data_ptr(), tri.data_ptr(),
                  tri_start.data_ptr(),
                  block_id.data_ptr() if inst else None,
                  xform.data_ptr() if inst else None, rays.data_ptr(),
                  r, tri.shape[1], int(any_hit), t.data_ptr(),
                  u.data_ptr(), v.data_ptr(), p.data_ptr(), occ.data_ptr(),
                  torch.cuda.current_stream(dev).cuda_stream)
    nv.check(err, "worklist")
    if r > 0:
        LAUNCHES["wl_any" if any_hit else "wl_closest"] += 1
    if any_hit:
        return occ.bool()
    return t, u, v, p


def wl_probe_rows(items, seg, tri, rays):
    """The probe kernel on CUDA tensors, its plain version on CPU ones;
    (R, 128) float32."""
    _check(items, seg, tri, None, rays, None, None)
    if rays.device.type == "cpu":
        return wl_probe_ref(items, seg, tri, rays)
    if rays.device.type != "cuda":
        raise NotImplementedError(f"no work-list kernel for {rays.device}")
    if _PROBE_FN is None:
        build()
    if tri.data_ptr() % 16:
        raise ValueError("the kernel stages tri in 16-byte pieces: it must "
                         "be 16-byte aligned")
    r = rays.shape[0]
    with torch.cuda.device(rays.device):
        out = torch.empty((r, LANES), dtype=torch.float32, device=rays.device)
        err = _PROBE_FN(items.data_ptr(), seg.data_ptr(), tri.data_ptr(),
                        rays.data_ptr(), r, tri.shape[1], out.data_ptr(),
                        torch.cuda.current_stream(rays.device).cuda_stream)
    nv.check(err, "worklist probe")
    if r > 0:
        LAUNCHES["wl_probe"] += 1
    return out


def _call(wl, o, d, mint, maxt, walk, beams=None):
    """Pack, then per chunk of rows build the list and walk it with
    walk(items, seg, rows) (worklist_pallas.py:525-588). beams: (w_factor,
    l_sc, beam_s2), by default the module's W_FACTOR, L_SC and BEAM_S2 as
    they stand at the call. Returns (the walks' outputs joined over the
    chunks, n, overflow (R,))."""
    w_factor, l_sc, beam_s2 = beams or (W_FACTOR, L_SC, BEAM_S2)
    rays, n, n_rows = pack_rays(o, d, mint, torch.clamp(maxt, max=1e30))
    chunk_rows = max(1, min(n_rows, MAX_ITEMS_PER_CALL // max(w_factor, 1),
                            MAX_ROWS))
    outs, ovfs = [], []
    for r0 in range(0, n_rows, chunk_rows):
        ry = rays[r0:r0 + chunk_rows]
        items, total, ovf = build_worklist(
            ry, wl["bmin"], wl["bmax"], wl["sc_bmin"], wl["sc_bmax"],
            ry.shape[0] * w_factor, l_sc, beam_s2)
        outs.append(walk(items, row_segments(items, ry.shape[0], total), ry))
        ovfs.append(ovf)
    if isinstance(outs[0], tuple):
        out = tuple(torch.cat(x) for x in zip(*outs))
    else:
        out = torch.cat(outs)
    return out, n, torch.cat(ovfs)


def _rows_walk(wl, any_hit):
    return lambda items, seg, ry: wl_rows(
        items, seg, wl["tri"], wl["tri_start"], ry, wl.get("block_id"),
        wl.get("xform"), any_hit)


def wl_closest(wl, o, d, mint, maxt):
    """Closest hit. wl: tri (B, K, 16), tri_start (C,), bmin/bmax (C, 3),
    sc_bmin/sc_bmax (C_s, 3) [, block_id (C,), xform (C, 16)]. Returns
    (t, u, v, prim, valid, overflow (R,)); lanes of overflowing rows hold
    a partial result."""
    (t, u, v, p), n, ovf = _call(wl, o, d, mint, maxt,
                                 _rows_walk(wl, False))
    t, u, v, p = (x.reshape(-1)[:n] for x in (t, u, v, p))
    valid = p >= 0
    return torch.where(valid, t, float("inf")), u, v, p, valid, ovf


def wl_any(wl, o, d, mint, maxt):
    """Any hit: (occluded, overflow (R,)); an occluded lane is occluded
    in an overflowing row too."""
    occ, n, ovf = _call(wl, o, d, mint, maxt, _rows_walk(wl, True))
    return occ.reshape(-1)[:n], ovf


def wl_probe(wl, o, d, mint, maxt, w_factor: int = PROBE_W_FACTOR,
             l_sc: int = PROBE_L_SC, beam_s2: int = BEAM_S2):
    """The fixed-cost probe (worklist_pallas.py:448), with the reference's
    beams by default. wl: flat work-list tables (no instances, as the
    reference's probe). Returns (acc (n,), overflow (R,)): per lane the
    count of the row's valid items whose box its ray passes within
    [mint, maxt], plus tri[cid, 0, 0] of each, in list order. A row the
    list never reaches (its items did not fit) reads 0 here; the
    reference leaves that row's output unwritten (its `_init` runs only
    on a row's first item)."""
    if wl.get("block_id") is not None:
        raise ValueError("the probe takes flat work-list tables")
    acc, n, ovf = _call(
        wl, o, d, mint, maxt,
        lambda items, seg, ry: wl_probe_rows(items, seg, wl["tri"], ry),
        (w_factor, l_sc, beam_s2))
    return acc.reshape(-1)[:n], ovf
