"""Point kNN structures (port of mitsuba_tpu/core/kdtree.py; reference
include/mitsuba/core/kdtree.h, the kNN tree of the photon map and the
irradiance cache).

  * `KDTree`: a median-split point kd-tree on the host (numpy), with a
    kNN and a range query per point, the reference's direct analog.
  * `HashGrid`: a uniform grid whose cells index a sorted point table.
    `build` runs on the host as the reference's does, so its tables equal
    the reference's bit for bit for the same points; `gather_sum` sums a
    payload over the points within a radius of each query, a loop over the
    27 neighbour cells, each cell's fixed budget of points gathered at
    once, on the grid's device (the photon, volume-photon and
    irradiance-cache gathers).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from mitsuba_tpu_torch.core import math as m


class KDTree:
    """Median-split point kd-tree (host-side; kdtree.py:24)."""

    def __init__(self, points: np.ndarray, leaf_size: int = 16):
        self.points = np.asarray(points, np.float64)
        n = self.points.shape[0]
        self.idx = np.arange(n)
        self.nodes = []  # (axis, split, left, right, start, count)
        self._build(0, n)

    def _build(self, start, end):
        node_id = len(self.nodes)
        self.nodes.append(None)
        count = end - start
        if count <= 16:
            self.nodes[node_id] = (-1, 0.0, -1, -1, start, count)
            return node_id
        pts = self.points[self.idx[start:end]]
        axis = int(np.argmax(pts.max(0) - pts.min(0)))
        order = np.argsort(pts[:, axis], kind="stable")
        self.idx[start:end] = self.idx[start:end][order]
        mid = start + count // 2
        split = self.points[self.idx[mid], axis]
        left = self._build(start, mid)
        right = self._build(mid, end)
        self.nodes[node_id] = (axis, split, left, right, start, end - start)
        return node_id

    def _walk(self, query, leaf, far_ok):
        """Near child first; the far child while far_ok(|delta|)."""
        def visit(node_id):
            axis, split, left, right, start, count = self.nodes[node_id]
            if axis < 0:
                leaf(self.idx[start:start + count])
                return
            delta = query[axis] - split
            near, far = (left, right) if delta <= 0 else (right, left)
            visit(near)
            if far_ok(abs(delta)):
                visit(far)

        visit(0)

    def knn(self, query, k: int):
        """The k nearest points of one query: (indices, distances),
        ascending."""
        query = np.asarray(query, np.float64)
        best = [np.full(k, np.inf), np.full(k, -1)]

        def leaf(ids):
            d = np.linalg.norm(self.points[ids] - query, axis=1)
            alld = np.concatenate([best[0], d])
            alli = np.concatenate([best[1], ids])
            order = np.argsort(alld)[:k]
            best[0], best[1] = alld[order], alli[order]

        self._walk(query, leaf, lambda delta: delta < best[0][-1])
        return best[1], best[0]

    def range_query(self, query, radius: float):
        """Indices of the points within radius of one query, in the
        order the walk meets them."""
        query = np.asarray(query, np.float64)
        out = []

        def leaf(ids):
            d = np.linalg.norm(self.points[ids] - query, axis=1)
            out.extend(ids[d <= radius].tolist())

        self._walk(query, leaf, lambda delta: delta <= radius)
        return np.asarray(out, np.int64)


_OFFSETS = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
            for dz in (-1, 0, 1)]


@dataclass
class HashGrid:
    """Uniform grid over points (kdtree.py:101): cell c holds the sorted
    points [cell_start[c], cell_start[c + 1])."""
    bmin: torch.Tensor          # (3,)
    inv_cell: torch.Tensor      # () 1 / cell size
    cell_start: torch.Tensor    # (res^3 + 1,) int32
    perm: torch.Tensor          # (P,) int32 sorted position -> input point
    points: torch.Tensor        # (P, 3)
    payload: torch.Tensor       # (P, F)
    res: int = 16
    max_per_query: int = 64

    @staticmethod
    def build(points, payload, res: int = 32, max_per_query: int = 64,
              device="cpu") -> "HashGrid":
        """The grid of points (P, 3) with payload (P, F), its tables on
        `device`. The points are first shuffled by a generator seeded
        from their count, so that the first points of a cell, which a
        gather keeps when the cell is over its budget, are a uniform
        subset; then sorted by cell, stably."""
        pts = np.asarray(points, np.float64)
        rng = np.random.default_rng(pts.shape[0] * 2654435761 % (2 ** 32))
        shuf = rng.permutation(pts.shape[0])
        pts = pts[shuf]
        payload = np.asarray(payload)[shuf]
        bmin = pts.min(0) - 1e-6
        bmax = pts.max(0) + 1e-6
        cell = (bmax - bmin).max() / res
        ijk = np.clip(((pts - bmin) / cell).astype(np.int64), 0, res - 1)
        cid = (ijk[:, 0] * res + ijk[:, 1]) * res + ijk[:, 2]
        order = np.argsort(cid, kind="stable")
        counts = np.bincount(cid, minlength=res ** 3)
        starts = np.concatenate([[0], np.cumsum(counts)])

        def dev(x, dtype):
            return torch.as_tensor(np.array(x, dtype), device=device)

        return HashGrid(bmin=dev(bmin, np.float32),
                        inv_cell=dev(1.0 / cell, np.float32),
                        cell_start=dev(starts, np.int32),
                        perm=dev(shuf[order], np.int32),
                        points=dev(pts[order], np.float32),
                        payload=dev(payload[order], np.float32),
                        res=res, max_per_query=max_per_query)

    def gather_sum(self, queries, radius, weight_fn=None, contrib_fn=None,
                   contrib_pos_fn=None):
        """The sum over the points within radius of each query of their
        payload, or of a function of it (kdtree.py:150): queries (N, 3)
        -> (N, C). radius: a float, or a tensor () or (N,).

        Each query scans its 27 neighbour cells (cells outside the grid
        are skipped, not clamped: clamping would visit a border cell
        twice), at most per_cell = max(max_per_query // 27, 4) points a
        cell; a fuller cell's kept points are scaled by its count over
        the budget. A cell's per_cell candidates are gathered and weighed
        at once, as (N, P) tensors, P = per_cell; the hooks see them so:
        weight_fn(dist (N, P)) scales each point's term; contrib_fn(rows
        (N, P, F), d2 (N, P)) -> (N, P, C) replaces the payload rows;
        contrib_pos_fn(rows, d2, dp (N, P, 3)) also receives query minus
        point. A hook broadcasts a per-query tensor with [:, None] (the
        reference's hooks take one candidate, (N, F), at a time). The
        terms add in the reference's order: cell by cell, point by
        point."""
        res = self.res
        per_cell = max(self.max_per_query // 27, 4)
        dev = queries.device
        n_pts = self.points.shape[0]
        # a float to int cast saturates in XLA; clamp first, as it does
        g = torch.clamp((queries - self.bmin) * self.inv_cell, -1.0,
                        float(res))
        q_ijk = torch.clamp(g.to(torch.int64), 0, res - 1)
        r2 = radius * radius      # a float's square in float64, as jax
        if isinstance(r2, torch.Tensor) and r2.dim() == 1:
            r2 = r2[:, None]
        ks = torch.arange(per_cell, device=dev)[None]
        total = None
        for off in _OFFSETS:
            nijk = q_ijk + torch.tensor(off, device=dev)
            ing = torch.all((nijk >= 0) & (nijk < res), dim=-1)
            ijk = torch.clamp(nijk, 0, res - 1)
            cid = (ijk[:, 0] * res + ijk[:, 1]) * res + ijk[:, 2]
            st = self.cell_start[cid].to(torch.int64)[:, None] + ks
            en = self.cell_start[cid + 1].to(torch.int64)[:, None]
            sc = torch.clamp((en - st[:, :1]).to(torch.float32) / per_cell,
                             min=1.0)
            pi = torch.clamp(st, max=n_pts - 1)
            ok = ing[:, None] & (st < en)
            dp = queries[:, None] - self.points[pi]
            d2 = m.dot(dp, dp)
            w = torch.where(ok & (d2 <= r2), sc, 0.0)
            if weight_fn is not None:
                w = w * weight_fn(torch.sqrt(torch.clamp(d2, min=0.0)))
            rows = self.payload[pi]
            if contrib_pos_fn is not None:
                val = contrib_pos_fn(rows, d2, dp)
            elif contrib_fn is not None:
                val = contrib_fn(rows, d2)
            else:
                val = rows
            term = w[..., None] * val
            for k in range(per_cell):
                total = term[:, k] if total is None else total + term[:, k]
        return total
