"""Inputs that drive the item walks (ops/exact.py: #7 `items`, #8
`l1_items`, #9 `l1_masked`) and the stream kernel (#10, ops/stream.py
`stream_rows`) through the corner cases of their schedules, made by numpy
from a seed.

The scene is a 24 x 48 sphere on a floor quad (2,210 triangles, 384 K8
clusters in 48 L1 blocks, 32-triangle stream clusters). Each 32-lane warp
of a row is one kind, cycling with the row:

  sphere  lanes from one point above the floor toward the sphere;
  floor   ... toward the floor beside it;
  escape  ... upward, hitting nothing: a closest row with such a lane
          walks its list to the end (its best t stays 1e30), an any-hit
          row too (the lane is never occluded);
  dead    mint > maxt: the warp has no live lane;

and the last row is dead as a whole. Closest rays reach 1e30; any-hit
rays end beyond their target (sphere and floor warps are occluded within
their first steps), escape rays at 10.

Every case plants exact ties. `v6b_case` appends to the K8 table a copy of
each L1 block whose 64 records are drawn, with replacement, from the
block's own (prims offset by PRIM_COPY), and lists each copy right after
the next block of its original, so one triangle sits in two L1 blocks,
clusters and sublanes of a step, or in two steps; `l1_case` (#8) adds
the copies' child boxes, each bounding its cluster's own triangles.
`items_case` (#7) does the same with K8 clusters: a copy of each, drawn
from its own 8 records, listed right after the next cluster of its
original, so one triangle sits in two sublanes, clusters and 16-cluster
steps. `stream_case` puts
before the table as many superclusters whose 8 clusters are drawn from
the whole table, with replacement, each with its K rows drawn from the
cluster's own (the box kept in row 0), so one triangle sits in two
chunks, parities, sublanes, clusters and superclusters, and a lane meets
a far cluster of a supercluster after a near one.

Used by tests/test_torch_cuda.py, tests/test_torch_walk_schedule.py and
chip_smoke.py's kernel checks.
"""
from __future__ import annotations

import numpy as np
import torch

from mitsuba_tpu_torch.ops import exact as ep
from mitsuba_tpu_torch.ops import stream as sp
from mitsuba_tpu_torch.ops.rows import BIG, LANES, pack_rays

KINDS = ("sphere", "floor", "escape", "dead")
PRIM_COPY = 1 << 20         # prim offset of the copied triangles
ROWS = 9
# the v6b walk's cull caps at each list width (E2 = 32, 384 and 768 are
# the coherent, diffuse and XL caps of config 3)
E0, E1, E3 = 128, 16, 96

_GEOM = {}


def geometry():
    """The case scene's cluster geometry (host tensors), built once."""
    if "geom" not in _GEOM:
        from mitsuba_tpu_torch.render.intersect import build_geometry
        from mitsuba_tpu_torch.render.mesh import make_quad, make_sphere_mesh

        _GEOM["geom"] = build_geometry(
            [(make_sphere_mesh([0, 0.8, 0], 0.8, 24, 48), 0, -1),
             (make_quad([-6, 0, -6], [-6, 0, 6], [6, 0, 6], [6, 0, -6]),
              1, -1)], backend="cluster")
    return _GEOM["geom"]


def warp_kinds(rows: int = ROWS):
    """(rows, 4) kind index of each warp; the last row all dead."""
    k = (np.arange(rows)[:, None] + np.arange(LANES // 32)[None]) \
        % len(KINDS)
    k[-1] = KINDS.index("dead")
    return k


def case_rays(any_hit: bool, seed: int = 0, rows: int = ROWS):
    """Packed rays (rows, 8, 128) on the host, warps by warp_kinds."""
    rng = np.random.default_rng(seed)
    kinds = warp_kinds(rows).reshape(-1)
    n = rows * LANES
    o = np.zeros((n, 3), np.float32)
    tgt = np.zeros((n, 3), np.float32)
    for w, kind in enumerate(kinds):
        lanes = slice(32 * w, 32 * w + 32)
        base = np.array([rng.uniform(-2, 2), rng.uniform(1.5, 3.0),
                         rng.uniform(-2, 2)], np.float32)
        o[lanes] = base + rng.normal(scale=0.02, size=(32, 3))
        if KINDS[kind] == "sphere":
            aim = np.array([0, 0.8, 0]) + rng.normal(scale=0.3, size=3)
        elif KINDS[kind] == "floor":
            aim = np.array([rng.uniform(-3, 3), 0.0, rng.uniform(-3, 3)])
        else:
            aim = base + np.array([0.0, 5.0, 0.0])
        tgt[lanes] = aim + rng.normal(scale=0.05, size=(32, 3))
    d = tgt - o
    dist = np.linalg.norm(d, axis=1)
    d = (d / dist[:, None]).astype(np.float32)
    mint = np.full(n, 1e-4, np.float32)
    kind_l = np.repeat(kinds, 32)
    if any_hit:
        maxt = np.where(KINDS.index("escape") == kind_l, 10.0, dist * 1.5)
    else:
        maxt = np.full(n, 1e30)
    maxt = np.where(kind_l == KINDS.index("dead"), -1.0, maxt)
    rays = pack_rays(*[torch.from_numpy(np.ascontiguousarray(x, np.float32))
                       for x in (o, d, mint, maxt)])[0]
    return rays


def _copy_l1_blocks(tri, rng):
    """tri (C8, 8, 128) with a resampled, prim-offset copy of each L1
    block appended: block n_l1 + b copies block b."""
    blocks = tri.reshape(-1, 64, LANES)
    n_l1 = blocks.shape[0]
    pick = torch.from_numpy(rng.integers(0, 64, (n_l1, 64)))
    copy = torch.gather(blocks, 1, pick[:, :, None].expand(-1, -1, LANES))
    prim = copy[:, :, 15].contiguous().view(torch.int32) + PRIM_COPY
    copy[:, :, 15] = prim.view(torch.float32)
    return torch.cat([blocks, copy]).reshape(-1, 8, LANES).contiguous(), n_l1


def _interleave(ids, keys, n_l1, e2):
    """Each row's list with the copy of entry i keyed as entry i + 1, so
    that it follows the next original; the first e2 entries, dead slots
    (0, BIG) at the tail."""
    live = keys < BIG
    nxt = torch.cat([keys[:, 1:], keys[:, -1:]], dim=1)
    nxt = torch.where(nxt < BIG, nxt, keys)
    pad = max(0, e2 - 2 * keys.shape[1])
    key_c = torch.cat([keys, torch.where(live, nxt, BIG),
                       keys.new_full((keys.shape[0], pad), BIG)], dim=1)
    id_c = torch.cat([ids, torch.where(live, ids + n_l1, 0),
                      ids.new_zeros((ids.shape[0], pad))], dim=1)
    key_s, order = torch.sort(key_c, dim=1, stable=True)
    id_s = torch.gather(id_c, 1, order)[:, :e2]
    key_s = key_s[:, :e2]
    return (torch.where(key_s < BIG, id_s, 0).to(torch.int32).contiguous(),
            key_s.contiguous())


def v6b_case(e2: int, any_hit: bool, seed: int = 0, device="cpu"):
    """(tri, rays, l1_ids, l1_keys) of #9 at list width e2: the case
    rays' L1 lists at caps (E0, E1, e2, E3), each entry followed by the
    copy of the entry before it."""
    ex = geometry().ex_tables
    rays = case_rays(any_hit, seed)
    ids, keys, _ovf = ep.build_exact_l1(rays, ex, (E0, E1, e2, E3))
    tri, n_l1 = _copy_l1_blocks(ex["tri"], np.random.default_rng(seed + 1))
    ids, keys = _interleave(ids, keys, n_l1, e2)
    return tuple(x.to(device) for x in (tri, rays, ids, keys))


def _copy_clusters(tri, rng):
    """tri (C8, 8, 128) with a resampled, prim-offset copy of each K8
    cluster appended: cluster c8 + c copies cluster c."""
    c8 = tri.shape[0]
    pick = torch.from_numpy(rng.integers(0, 8, (c8, 8)))
    copy = torch.gather(tri, 1, pick[:, :, None].expand(-1, -1, LANES))
    prim = copy[:, :, 15].contiguous().view(torch.int32) + PRIM_COPY
    copy[:, :, 15] = prim.view(torch.float32)
    return torch.cat([tri, copy]).contiguous(), c8


def items_case(e3: int, any_hit: bool, seed: int = 0, device="cpu"):
    """(tri, rays, ids, blk_tn) of #7 at list width e3 (96, 512 and 1,024
    are config 3's coherent, diffuse and XL caps): the case rays' K8
    lists, every cluster of the scene a candidate (caps E0, E1, 48, e3),
    each entry followed by the copy of the entry before it."""
    ex = geometry().ex_tables
    rays = case_rays(any_hit, seed)
    ids64, key2, _ovf = ep._cull_l1(rays, ex, (E0, E1, 48, e3))
    ids2, key2s, live2, _n2 = ep._sorted_prefix(key2, ids64, 48)
    key3 = ep.child_refine(rays, ids2, live2, ex["ct0"])
    key3 = torch.where((key2s < BIG).repeat_interleave(8, dim=1), key3, BIG)
    tri, c8 = _copy_clusters(ex["tri"], np.random.default_rng(seed + 1))
    ids, keys = _interleave(ep._children(ids2), key3, c8, e3)
    blk_tn = keys.reshape(keys.shape[0], -1, ep.BI)[:, :, 0].contiguous()
    return tuple(x.to(device) for x in (tri, rays, ids, blk_tn))


def _copy_boxes(tri, n_l1):
    """The child boxes (ct0 rows) of the L1 blocks n_l1 onward of tri,
    each the bounds of its K8 cluster's own 8 triangles."""
    rec = tri.reshape(-1, 8, 8, LANES)[n_l1:, :, :, :9]
    v0 = rec[..., 0:3]
    pts = torch.stack([v0, v0 + rec[..., 3:6], v0 + rec[..., 6:9]], dim=3)
    ct = torch.zeros((rec.shape[0], 8, LANES))
    ct[:, :, 0:3] = pts.amin(dim=(2, 3))
    ct[:, :, 3:6] = pts.amax(dim=(2, 3))
    return ct


def l1_case(e2: int, any_hit: bool, seed: int = 0, device="cpu"):
    """(tri, ct0, rays, l1_ids, l1_keys) of #8 at list width e2:
    v6b_case's lists, with ct0 rows for the copied L1 blocks made from
    their own triangles, so that a lane's slab admits what each child
    holds."""
    tri, rays, ids, keys = v6b_case(e2, any_hit, seed)
    ct0 = geometry().ex_tables["ct0"]
    ct0 = torch.cat([ct0, _copy_boxes(tri, ct0.shape[0])]).contiguous()
    return tuple(x.to(device) for x in (tri, ct0, rays, ids, keys))


def _mixed_superclusters(sc_tri, rng):
    """c_s superclusters, each of 8 clusters drawn from the whole table
    with replacement, each with its K rows drawn from the cluster's own
    (the cluster's box, fields 9-15 of row 0, kept), and their boxes."""
    c_s, k_cl, _ = sc_tri.shape
    cl = sc_tri.reshape(c_s, k_cl, 8, 16).permute(0, 2, 1, 3) \
        .reshape(c_s * 8, k_cl, 16)
    src_cl = torch.from_numpy(rng.integers(0, c_s * 8, (c_s, 8)))
    src_row = torch.from_numpy(rng.integers(0, k_cl, (c_s, 8, k_cl)))
    picked = cl[src_cl]                                    # (c_s,8,K,16)
    mixed = torch.gather(picked, 2, src_row[..., None].expand(-1, -1, -1,
                                                              16))
    mixed[:, :, 0, 9:16] = picked[:, :, 0, 9:16]
    bmin = picked[:, :, 0, 9:12].amin(dim=1)
    bmax = picked[:, :, 0, 12:15].amax(dim=1)
    return (mixed.permute(0, 2, 1, 3).reshape(c_s, k_cl, 8 * 16),
            bmin, bmax)


def stream_case(any_hit: bool, seed: int = 0, device="cpu"):
    """(rays, ids, tns, sc_tri) of #10 (K = 32): the case rays' complete
    supercluster lists over the table with mixed superclusters put
    before it."""
    st = geometry().st_tables
    rays = case_rays(any_hit, seed)
    mixed, mlo, mhi = _mixed_superclusters(st["sc_tri"],
                                           np.random.default_rng(seed + 1))
    sc_tri = torch.cat([mixed, st["sc_tri"]]).contiguous()
    bmin = torch.cat([mlo, st["sc_bmin"]])
    bmax = torch.cat([mhi, st["sc_bmax"]])
    ids, tns = sp.build_sc_lists(rays, bmin, bmax)
    return tuple(x.to(device) for x in (rays, ids, tns, sc_tri))
