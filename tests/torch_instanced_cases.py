"""Inputs that drive the work-list kernel (#12, ops/worklist.py `wl_rows`)
and the BVH walk (#11, ops/bvh.py `bvh_closest` / `bvh_any`) through the
corner cases of their schedules, made by numpy from a seed.

`wl_case`: six clusters of K triangles (K = 32 or 8), stacked along +z, flat
(world-space blocks) or instanced (three shared object-space blocks, each
cluster with its own world->object map, scale 1/2, 1 or 2). Every block's back
is a whole square; cluster 0 covers only x < 0.5; warps 0 and 2 of every row
look at x < 0.5, warps 1 and 3 at x > 0.5, so an any-hit row has half its warps
occluded after its first item. Each block plants exact ties: a triangle copied
into another sublane, and into the other chunk parity of its own sublane; and
cluster 4 is cluster 1 again (the same world triangles, another prim base), so
two items tie. Rows:

  0  all six clusters, front to back; warp 3 has mint = maxt = inf (no
     test can pass, but closest takes the miss sentinel);
  1  clusters 1, 4, 2; warps 1 and 3 dead (mint > maxt);
  2  clusters 0, 2, 5; every lane dead (the row walks nothing);
  3  all six, back to front;
  4  no candidate: one invalid `first` slot;
  5  clusters 3, 5 with maxt short of them: live lanes that hit nothing;
  6  the six clusters back to front 90 times, one invalid slot among
     them (540 slots: the kernel's 512-slot windows);
  7  all six, front to back; the list's last row.

`tail` pads the list with unused slots (neither valid nor first, given
to the last row, as build_worklist does) up to w_cap; `overflow` cuts it
at w_cap with total beyond it, as a list that ran out of slots.

`bvh_cases`: the flattened tables (nodes (M, 9), tris (T, 9)) and rays
(o, d, mint, maxt) of two trees.
  "leaves"  a tree made by hand: two leaves holding the same triangle
            (equal t; the walk keeps the first) and a last leaf with
            first + k >= T (the walk tests min(first + k, T - 1)); rays
            along the axes (zero direction components) and oblique ones,
            some dead;
  "tail"    the port's builder over 2,000 slivers along the x axis, each
            containing the direction +x, and a floor: the lanes that run
            along the axis (one in 500) enter nearly every box and hit
            nothing, walking the whole tree, while the others end within
            a few nodes (a launch's tail of long walks).

Used by tests/test_torch_cuda.py and tests/test_torch_worklist_trim.py.
"""
from __future__ import annotations

import numpy as np
import torch

from mitsuba_tpu_torch.ops.rows import LANES

# packed work item (ops/worklist.py)
FIRST_BIT = 1 << 14
VALID_BIT = 1 << 15
ROW_SHIFT = 16
N_CL = 6
ROW_LISTS = ([0, 1, 2, 3, 4, 5], [1, 4, 2], [0, 2, 5], [5, 4, 3, 2, 1, 0],
             [], [3, 5], [5, 4, 3, 2, 1, 0] * 90, [0, 1, 2, 3, 4, 5])
ROWS = len(ROW_LISTS)
INVALID_AT = (6, 200)          # (row, position) of the invalid slot
TAIL = 1200                    # unused slots of the `tail` list
# cluster c: world = scale * object + (0, 0, 2 c); cluster 4 repeats 1
SCALE = (1.0, 2.0, 1.0, 1.0, 2.0, 0.5)
BLOCK_OF = (0, 1, 2, 0, 1, 2)


def _block(rng, k, half):
    """One (k, 16) block in object space: squares of two triangles at
    depths in [0.05, 0.9), x in [0, 0.5) where `half`, else [0, 1); in
    its first two rows a square at depth 0, whose triangles are copied
    (the ties), and in its last two the whole square at depth 0.999
    (every ray through the block hits it); row 0 holds the block's box in
    columns 9:15."""
    tri = np.zeros((k, 16), np.float32)
    xw = 0.5 if half else 1.0
    for q in range(k // 2):
        a = rng.uniform(0.0, 0.6 * xw)
        b = rng.uniform(0.0, 0.6)
        w = rng.uniform(0.3 * xw, xw - a)
        h = rng.uniform(0.3, 1.0 - b)
        z = np.float32(rng.uniform(0.05, 0.9))
        if q == 0:                          # the front: the tied square
            z = np.float32(0.0)
        if q == k // 2 - 1:                 # the back: the whole square
            a, b, w, h, z = 0.0, 0.0, xw, 1.0, np.float32(0.999)
        p = np.array([[a, b, z], [a + w, b, z], [a, b + h, z],
                      [a + w, b + h, z]], np.float32)
        for n, (i0, i1, i2) in enumerate(((0, 1, 2), (3, 2, 1))):
            tri[2 * q + n, 0:3] = p[i0]
            tri[2 * q + n, 3:6] = p[i1] - p[i0]
            tri[2 * q + n, 6:9] = p[i2] - p[i0]
    # ties: row 1 (chunk 0, sublane 1) again in row 8 (chunk 1, sublane
    # 0) where there is one, and row 0 in row k - 8 (the other parity of
    # sublane 0's last chunk) or, at K = 8, in row 5
    if k >= 16:
        tri[8, 0:9] = tri[1, 0:9]
        tri[k - 8, 0:9] = tri[0, 0:9]
    else:
        tri[5, 0:9] = tri[1, 0:9]
    v = np.concatenate([tri[:, 0:3], tri[:, 0:3] + tri[:, 3:6],
                        tri[:, 0:3] + tri[:, 6:9]])
    tri[0, 9:12] = v.min(axis=0)
    tri[0, 12:15] = v.max(axis=0)
    return tri


def _to_world(blk, s, zc):
    """A block moved to world space: v0 * s + (0, 0, zc), edges * s."""
    out = blk.copy()
    out[:, 0:9] *= s
    out[:, 2] += zc
    out[0, 9:15] *= s
    out[0, 11] += zc
    out[0, 14] += zc
    return out


def _rays(rng, n_rows):
    """(n_rows, 8, 128) packed rays toward +z from z = -2, per the rows'
    kinds (module docstring)."""
    lane = np.arange(LANES)
    warp = lane // 32
    rays = np.zeros((n_rows, 8, LANES), np.float32)
    for r in range(n_rows):
        x = np.where(warp % 2 == 0, rng.uniform(0.05, 0.45, LANES),
                     rng.uniform(0.55, 0.95, LANES))
        y = rng.uniform(0.05, 0.95, LANES)
        d = np.stack([rng.uniform(-0.01, 0.01, LANES),
                      rng.uniform(-0.01, 0.01, LANES),
                      np.ones(LANES)])
        d[0:2, ::7] = 0.0                       # zero direction components
        rays[r, 0] = x
        rays[r, 1] = y
        rays[r, 2] = -2.0
        rays[r, 3:6] = d
        rays[r, 6] = 1e-4
        rays[r, 7] = 1e30
    rays[0, 6:8, 96:128] = np.inf
    rays[1, 6, 32:64] = 2.0
    rays[1, 7, 32:64] = 1.0
    rays[1, 7, 96:128] = -1.0
    rays[2, 7] = -1.0
    rays[5, 7] = 1.5
    return rays


def wl_case(instanced: bool, k: int = 32, list_end: str = "tail",
            seed: int = 0, device="cpu"):
    """(items, seg, tri, tri_start, rays, block_id, xform, total, full)
    of the module docstring's rows: seg ends the last row's run at
    min(total, w_cap) and `full` at w_cap (the untrimmed segments).
    list_end: "tail" or "overflow"."""
    rng = np.random.default_rng(seed + 7 * k + int(instanced))
    blocks = [_block(rng, k, half=b == 0) for b in range(3)]
    if instanced:
        tri = np.stack(blocks)
        block_id = np.array(BLOCK_OF, np.int32)
        xform = np.zeros((N_CL, 16), np.float32)
        for c, s in enumerate(SCALE):
            inv = np.float32(1.0 / s)
            xform[c, 0] = xform[c, 5] = xform[c, 10] = inv
            xform[c, 11] = np.float32(-2.0 * (1 if c == 4 else c)) * inv
    else:
        tri = np.stack([_to_world(blocks[BLOCK_OF[c]], SCALE[c],
                                  2.0 * (1 if c == 4 else c))
                        for c in range(N_CL)])
        block_id = xform = None
    tri_start = (np.arange(N_CL, dtype=np.int32) * 1000).astype(np.int32)
    rays = _rays(rng, ROWS)
    slots = []
    for r, cl in enumerate(ROW_LISTS):
        if not cl:
            slots.append(FIRST_BIT | (r << ROW_SHIFT))
            continue
        for i, c in enumerate(cl):
            item = c | VALID_BIT | (r << ROW_SHIFT)
            if (r, i) == INVALID_AT:
                item &= ~VALID_BIT
            slots.append(item | (FIRST_BIT if i == 0 else 0))
    total = len(slots)
    if list_end == "tail":
        w_cap = total + TAIL
        slots += [((ROWS - 1) << ROW_SHIFT) | ROW_LISTS[-1][-1]] * TAIL
    else:
        w_cap = total - 3                       # the last row cut short
        slots = slots[:w_cap]
    items = np.array(slots, np.int64).astype(np.int32)
    row = items.astype(np.int64) >> ROW_SHIFT
    full = np.searchsorted(row, np.arange(ROWS + 1)).astype(np.int32)
    seg = np.minimum(full, min(total, w_cap)).astype(np.int32)

    def t(x):
        return None if x is None else torch.as_tensor(
            np.ascontiguousarray(x), device=device)

    return (t(items), t(seg), t(tri), t(tri_start), t(rays), t(block_id),
            t(xform), total, t(full))


def _packed(bmin, bmax, first, count, skip, tri):
    nodes = np.concatenate([bmin, bmax, np.stack(
        [first, count, skip], 1).astype(np.float32)], 1).astype(np.float32)
    tris = np.concatenate([tri[:, 0], tri[:, 1] - tri[:, 0],
                           tri[:, 2] - tri[:, 0]], 1).astype(np.float32)
    return nodes, tris


def _leaves_case(rng, n):
    """The hand-made tree: root (inner), inner node over leaves A (tris
    0-3) and B (tris 4-7, tri 5 = tri 1), leaf C (first T - 2, count 4)."""
    tri = rng.uniform(-1.0, 1.0, (10, 3, 3)).astype(np.float32)
    tri[:, :, 2] = rng.uniform(0.1, 1.0, (10, 1))         # flat in z
    tri[1, :, 2] = 0.05                                    # the nearest
    tri[5] = tri[1]
    tri[8] = [[-1, -1, 0.5], [1, -1, 0.5], [-1, 1, 0.5]]
    tri[9] = [[1, 1, 0.5], [-1, 1, 0.5], [1, -1, 0.5]]
    lo = tri.reshape(-1, 3).min(0)
    hi = tri.reshape(-1, 3).max(0)
    ab = tri[0:8].reshape(-1, 3)
    tc = tri[8:10].reshape(-1, 3)
    bmin = np.stack([lo, ab.min(0), tri[0:4].reshape(-1, 3).min(0),
                     tri[4:8].reshape(-1, 3).min(0), tc.min(0)])
    bmax = np.stack([hi, ab.max(0), tri[0:4].reshape(-1, 3).max(0),
                     tri[4:8].reshape(-1, 3).max(0), tc.max(0)])
    nodes, tris = _packed(bmin, bmax, np.array([0, 0, 0, 4, 8]),
                          np.array([0, 0, 4, 4, 4]),
                          np.array([5, 4, 3, 4, 5]), tri)
    o = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    o[:, 2] = -1.0
    d = np.zeros((n, 3), np.float32)
    d[:, 2] = 1.0
    obl = np.arange(n) % 3 == 2
    d[obl] = rng.uniform(-0.3, 0.3, (int(obl.sum()), 3))
    d[obl, 2] = 1.0
    # lanes aimed at tri 1 (and so at its copy, tri 5)
    at = np.arange(n) % 5 == 1
    w = rng.dirichlet((1.0, 1.0, 1.0), int(at.sum())).astype(np.float32)
    o[at, 0:2] = (w[:, :, None] * tri[1][None, :, 0:2]).sum(1)
    d[at] = (0.0, 0.0, 1.0)
    return nodes, tris, o, d


def _tail_case(rng, n, n_slivers=2000):
    """Slivers along +x (each spans x, and y = z = 0 lies in its box,
    but contains the direction +x: a ray along the axis never hits one)
    and a floor at y = -1."""
    from mitsuba_tpu_torch.render.bvh import build_bvh

    x0 = np.sort(rng.uniform(0.0, 20.0, n_slivers)).astype(np.float32)
    dy = rng.uniform(0.01, 0.02, n_slivers).astype(np.float32)
    sl = np.stack([np.stack([x0, -dy, -dy], 1),
                   np.stack([x0 + 0.05, -dy, -dy], 1),
                   np.stack([x0, dy, dy], 1)], 1)
    floor = np.array([[[-5, -1, -5], [25, -1, -5], [-5, -1, 5]],
                      [[25, -1, 5], [-5, -1, 5], [25, -1, -5]]],
                     np.float32)
    tri = np.concatenate([sl, floor]).astype(np.float32)
    bvh = build_bvh(tri.reshape(-1, 3), np.arange(tri.shape[0] * 3)
                    .reshape(-1, 3))
    nodes, tris = _packed(bvh.bounds_min, bvh.bounds_max, bvh.first,
                          bvh.count, bvh.skip, tri[bvh.perm])
    o = np.stack([rng.uniform(-2.0, 22.0, n), rng.uniform(0.5, 3.0, n),
                  rng.uniform(-4.0, 4.0, n)], 1).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 1] = -np.abs(d[:, 1])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    long_ = np.arange(n) % 500 == 7
    o[long_] = (-1.0, 0.0, 0.0)
    d[long_] = (1.0, 0.0, 0.0)
    return nodes, tris, o, d


def bvh_cases(n: int = 4099, seed: int = 0, device="cpu"):
    """{name: (nodes, tris, o, d, mint, maxt)} of the module docstring's
    trees; every 9th lane dead (maxt -1), every 4th maxt 1e30, the rest
    finite (inf on one lane in 7, the exact walks' maxt)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, make in (("leaves", _leaves_case), ("tail", _tail_case)):
        nodes, tris, o, d = make(rng, n)
        lane = np.arange(n)
        mint = np.full(n, 1e-4, np.float32)
        maxt = rng.uniform(0.5, 30.0, n).astype(np.float32)
        maxt[lane % 4 == 0] = 1e30
        maxt[lane % 7 == 3] = np.inf
        maxt[lane % 9 == 0] = -1.0
        if name == "tail":
            maxt[lane % 500 == 7] = 1e30        # the long walks
        out[name] = tuple(torch.as_tensor(np.ascontiguousarray(x),
                                          device=device)
                          for x in (nodes, tris, o, d, mint, maxt))
    return out
