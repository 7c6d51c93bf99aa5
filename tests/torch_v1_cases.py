"""Inputs that drive the v1 cluster intersector (#14, ops/cluster.py
`cluster_rows`) through the corner cases of its schedule, made by numpy
from a seed.

The geometry is made by hand, cluster by cluster, so that the tile lists
hold several superclusters (`N_SC` = 6):

  SC 0-3  layer 1: supercluster s covers x in [4 s, 4 s + 4), its
          cluster c the strip y in [c, c + 1), at depth z = 2 + s / 2 +
          c / 10 facing -z; each a grid of 16 x 4 squares (two triangles
          each) with every third square left out, so that rays pass
          through the layer (86 triangles of 128, the rest the padding's
          zero rows);
  SC 4    layer 2 at z = 10: cluster c the whole strip y in [c, c + 1),
          x in [0, 16), 32 x 2 squares (128 triangles), in each of which
          triangle DUP_K is a copy of triangle DUP_OF (equal t within a
          cluster: the lowest k wins);
  SC 5    copies of layer-1 clusters COPIED (the same triangles, their
          own prim base): equal t across clusters, where the first in the
          tile's list wins by the strict < across clusters.

Rays start at z = 0 and look along +z with a small slope. The tiles (8
rows of 128 lanes each, rows packed in order) are:

  0 `split`    rows 0-3 over x in [0, 4), rows 4-7 over x in [4, 8): the
               rows of one tile vote for different clusters; row 2 dead
               (maxt < mint), row 5 with warps 1 and 3 dead, row 6 with a
               short maxt (no slab passes: the row votes for nothing);
  1 `all`      rays over the whole area: every supercluster listed (the
               list's length is C_s); row 3 dead; lanes 0-15 of row 7 miss
               everything;
  2 `empty`    rays looking along -z: an empty list;
  3 `occluded` row i through the squares of cluster i of SC 3, maxt past
               layer 2: every lane hits layer 1 (closest: layer 2 passes
               the lanes' slabs at maxt, but not at their best t; any
               hit: each row stops once its lanes are all occluded, then
               the block; row 0's warps leave its cluster after the
               first 32 triangles);
  4 `ties`     rays through the copied clusters and through DUP_K.

`inf`: maxt = inf on the live lanes of tiles 1 and 3, as a caller passes
it (launch_args clamps it to 1e30 for closest; any hit takes it as it
is). `sentinel`: after launch_args, closest, row 7 of tile 1 takes maxt =
inf in the packed rays, as `cluster_rows` may be called directly: no lane
can beat the kernel's 3e38 miss sentinel there, so every such lane of a
row that votes takes it (prim = tri_start + 2^30).

Used by tests/test_torch_v1_schedule.py, tests/test_torch_cuda.py and
chip_smoke.py's kernel checks.
"""
from __future__ import annotations

import numpy as np
import torch

from mitsuba_tpu_torch.ops import cluster as cp
from mitsuba_tpu_torch.ops.rows import LANES
from mitsuba_tpu_torch.render.clusters import build_cluster_tables

N_SC = 6
LAYER1_SC = 4
COPIED = (0, 9, 18)             # layer-1 clusters copied into SC 5
DUP_K, DUP_OF = 100, 20         # in every layer-2 cluster
TILES = ("split", "all", "empty", "occluded", "ties")
ROWS = 8 * len(TILES)


def _squares(x0, x1, y0, y1, z, nx, ny, keep=None):
    """Two triangles per square of an nx x ny grid over [x0, x1) x [y0,
    y1) at depth z, as (T, 3, 3) vertices; keep(i, j) drops squares."""
    xs = np.linspace(x0, x1, nx + 1)
    ys = np.linspace(y0, y1, ny + 1)
    tris = []
    for j in range(ny):
        for i in range(nx):
            if keep is not None and not keep(i, j):
                continue
            a = (xs[i], ys[j], z)
            b = (xs[i + 1], ys[j], z)
            c = (xs[i + 1], ys[j + 1], z)
            d = (xs[i], ys[j + 1], z)
            tris += [(a, b, c), (a, c, d)]
    return np.asarray(tris, np.float64)


def geometry():
    """(triangles (T, 3, 3) float32 in cluster order, ranges [(start,
    count)]), 8 ranges a supercluster."""
    clusters = []
    for s in range(LAYER1_SC):
        for c in range(8):
            clusters.append(_squares(
                4 * s, 4 * s + 4, c, c + 1, 2 + s / 2 + c / 10, 16, 4,
                keep=lambda i, j: (i + j) % 3 != 0))
    for c in range(8):
        t = _squares(0, 16, c, c + 1, 10.0, 32, 2)
        t[DUP_K] = t[DUP_OF]
        clusters.append(t)
    for c in COPIED:
        clusters.append(clusters[c].copy())
    ranges, start = [], 0
    for t in clusters:
        ranges.append((start, t.shape[0]))
        start += t.shape[0]
    return np.concatenate(clusters).astype(np.float32), ranges


def tables(device="cpu"):
    """The ClusterTables of geometry() and its table dict on `device`."""
    tri, ranges = geometry()
    ct = build_cluster_tables(tri[:, 0], tri[:, 1] - tri[:, 0],
                              tri[:, 2] - tri[:, 0], ranges)
    assert ct.n_super == N_SC
    return ct, cp.table_dict(ct, device)


def rays(seed: int = 0, any_hit: bool = False, inf: bool = False):
    """(o, d, mint, maxt) numpy float32, ROWS * 128 lanes by TILES."""
    rng = np.random.default_rng(seed)
    o = np.zeros((ROWS, LANES, 3), np.float64)
    slope = rng.uniform(-0.02, 0.02, (ROWS, LANES, 2))
    d = np.concatenate([slope, np.ones((ROWS, LANES, 1))], axis=2)
    mint = np.full((ROWS, LANES), 1e-4)
    far = 30.0 if any_hit else 1e30
    maxt = np.full((ROWS, LANES), far)
    x = rng.uniform(0.0, 16.0, (ROWS, LANES))
    y = rng.uniform(0.0, 8.0, (ROWS, LANES))
    for t, kind in enumerate(TILES):
        r = slice(8 * t, 8 * t + 8)
        if kind == "split":
            x[8 * t:8 * t + 4] = rng.uniform(0.1, 3.9, (4, LANES))
            x[8 * t + 4:8 * t + 8] = rng.uniform(4.1, 7.9, (4, LANES))
            maxt[8 * t + 2] = -1.0
            maxt[8 * t + 5, 32:64] = -1.0
            maxt[8 * t + 5, 96:] = -1.0
            maxt[8 * t + 6] = 1.0
        elif kind == "all":
            maxt[8 * t + 3] = -1.0
            # lanes 0-15 of row 7 pass beside the geometry (x > 16)
            x[8 * t + 7, :16] = rng.uniform(16.5, 17.0, 16)
        elif kind == "empty":
            d[r, :, 2] = -1.0
        elif kind == "occluded":
            # row i through the kept squares of cluster i of SC 3 (x in
            # [12, 16), y in [i, i + 1)), inside their first triangles;
            # row 0 through the squares of the grid's first row only
            # (triangles k < 32)
            for i in range(8):
                kept = [(a, b) for b in range(1 if i == 0 else 4)
                        for a in range(16) if (a + b) % 3 != 0]
                pick = rng.integers(0, len(kept), LANES)
                x[8 * t + i] = [12.0 + (kept[k][0] + 0.7) / 4 for k in pick]
                y[8 * t + i] = [i + (kept[k][1] + 0.3) / 4 for k in pick]
            d[r, :, :2] = 0.0
            maxt[r] = 30.0
        elif kind == "ties":
            # half through the copied clusters' squares, half through
            # triangle DUP_OF of a layer-2 strip (where layer 1 is open)
            for rr in range(8 * t, 8 * t + 8):
                c = COPIED[rr % len(COPIED)]
                s, cy = divmod(c, 8)
                x[rr, :64] = rng.uniform(4 * s + 0.05, 4 * s + 3.95, 64)
                y[rr, :64] = rng.uniform(cy + 0.05, cy + 0.95, 64)
                # DUP_OF = 20: square 10 of row 0 of a 32 x 2 grid, its
                # first triangle (a, b, c): x in [5, 5.5), below the
                # diagonal
                u = rng.uniform(0.05, 0.95, 64)
                v = rng.uniform(0.0, 1.0, 64) * u * 0.9
                x[rr, 64:] = 5.0 + 0.5 * u
                y[rr, 64:] = (rr % 8) + 0.5 * v
                d[rr, :, :2] = 0.0
    o[..., 0] = x
    o[..., 1] = y
    if inf:
        for t in (1, 3):
            r = slice(8 * t, 8 * t + 8)
            maxt[r] = np.where(maxt[r] > 0, np.inf, maxt[r])
    d = d / np.linalg.norm(d, axis=2, keepdims=True)
    return tuple(np.ascontiguousarray(a, np.float32) for a in (
        o.reshape(-1, 3), d.reshape(-1, 3), mint.reshape(-1),
        maxt.reshape(-1)))


def args(seed: int = 0, any_hit: bool = False, inf: bool = False,
         sentinel: bool = False, device="cpu"):
    """The launch arguments of `cluster_rows` for rays(seed, any_hit, inf)
    through launch_args, on `device`; `sentinel` (closest): maxt = inf on
    row 7 of tile 1 after the clamp."""
    _ct, cl = tables(device)
    ray = [torch.from_numpy(x).to(device) for x in rays(seed, any_hit, inf)]
    a, _n = cp.launch_args(cl, *ray, any_hit)
    if sentinel:
        r = a[0].clone()
        live = r[8 + 7, 7] > 0
        r[8 + 7, 7] = torch.where(live, float("inf"), r[8 + 7, 7])
        a = (r.contiguous(),) + a[1:]
    return a
