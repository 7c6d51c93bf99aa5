"""Static point octree (port of mitsuba_tpu/core/octree.py; reference
include/mitsuba/core/octree.h) with the hierarchical irradiance gather of
the subsurface integrators (src/subsurface/irrtree.h IrradianceOctree).

Host-side numpy, as in the JAX package: the render path gathers
subsurface irradiance densely in lane blocks (subsurface/dipole.py
scene_ss_lo); this octree serves the host-side roles the reference uses
it for: hierarchical O(log n) Lo queries for preview and CPU evaluation
(scene_ss_lo_hier), and range and k-nearest queries."""
from __future__ import annotations

import numpy as np


class Octree:
    """Octree over points with per-node aggregates.

    values: optional (N, C) per-point payload (e.g. irradiance * area).
    Each node keeps sum(values) and the value-weighted centroid — the
    clustering data irrtree.h:60 propagates up the tree."""

    def __init__(self, points: np.ndarray, values: np.ndarray = None,
                 leaf_size: int = 8, max_depth: int = 24):
        self.points = np.asarray(points, np.float64)
        n = self.points.shape[0]
        if values is None:
            values = np.ones((n, 1), np.float64)
        self.values = np.asarray(values, np.float64)
        if self.values.ndim == 1:
            self.values = self.values[:, None]
        self.leaf_size = int(leaf_size)
        # nodes as parallel lists (index 0 = root)
        self._children = []      # (8,) int arrays, -1 = none
        self._start = []         # leaf point range [start, end)
        self._end = []
        self._bmin = []
        self._bmax = []
        self._vsum = []          # (C,) aggregate
        self._centroid = []      # value-weighted centroid
        order = np.arange(n)
        bmin = self.points.min(0) if n else np.zeros(3)
        bmax = self.points.max(0) if n else np.ones(3)
        self._order = order
        self._build(order, bmin, bmax, 0, max_depth)
        self._children = np.asarray(self._children, np.int64)
        self._vsum = np.asarray(self._vsum)
        self._centroid = np.asarray(self._centroid)
        self._bmin = np.asarray(self._bmin)
        self._bmax = np.asarray(self._bmax)

    # --- build -------------------------------------------------------------
    def _new_node(self, idx, bmin, bmax):
        self._children.append(np.full(8, -1, np.int64))
        self._start.append(0)
        self._end.append(0)
        self._bmin.append(bmin)
        self._bmax.append(bmax)
        pv = self.values[idx]
        vs = pv.sum(0)
        w = np.abs(pv).sum(1)
        tot = w.sum()
        c = (self.points[idx] * w[:, None]).sum(0) / tot if tot > 0 else \
            self.points[idx].mean(0) if len(idx) else (bmin + bmax) / 2
        self._vsum.append(vs)
        self._centroid.append(c)
        return len(self._children) - 1

    def _build(self, idx, bmin, bmax, depth, max_depth) -> int:
        node = self._new_node(idx, bmin, bmax)
        if len(idx) <= self.leaf_size or depth >= max_depth:
            # leaves own a contiguous slice of the flat leaf-index list
            self._start[node] = len(self._leaf_idx_list)
            self._leaf_idx_list.extend(idx.tolist())
            self._end[node] = len(self._leaf_idx_list)
            return node
        mid = (np.asarray(bmin) + np.asarray(bmax)) / 2
        p = self.points[idx]
        octant = ((p[:, 0] > mid[0]).astype(int)
                  | ((p[:, 1] > mid[1]).astype(int) << 1)
                  | ((p[:, 2] > mid[2]).astype(int) << 2))
        for o in range(8):
            sub = idx[octant == o]
            if len(sub) == 0:
                continue
            cb_min = np.where([o & 1, o & 2, o & 4], mid, bmin)
            cb_max = np.where([o & 1, o & 2, o & 4], bmax, mid)
            child = self._build(sub, cb_min, cb_max, depth + 1, max_depth)
            self._children[node][o] = child
        return node

    def __new__(cls, *a, **k):
        self = super().__new__(cls)
        self._leaf_idx_list = []
        return self

    @property
    def n_nodes(self):
        return len(self._start)

    # --- queries -----------------------------------------------------------
    def range_query(self, center, radius: float) -> np.ndarray:
        """Indices of points within `radius` of `center` (octree.h
        searchSphere)."""
        center = np.asarray(center, np.float64)
        out = []
        stack = [0]
        leaf_idx = np.asarray(self._leaf_idx_list, np.int64)
        while stack:
            node = stack.pop()
            near = np.maximum(self._bmin[node] - center, 0) \
                + np.maximum(center - self._bmax[node], 0)
            if (near ** 2).sum() > radius * radius:
                continue
            ch = self._children[node]
            if (ch < 0).all():
                idx = leaf_idx[self._start[node]:self._end[node]]
                d2 = ((self.points[idx] - center) ** 2).sum(1)
                out.append(idx[d2 <= radius * radius])
            else:
                stack.extend(int(c) for c in ch if c >= 0)
        return np.concatenate(out) if out else np.empty(0, np.int64)

    def knn(self, center, k: int) -> np.ndarray:
        """k nearest point indices (best-first descent)."""
        import heapq

        center = np.asarray(center, np.float64)
        leaf_idx = np.asarray(self._leaf_idx_list, np.int64)
        heap = [(0.0, 0)]                       # (node lower bound, node)
        best: list = []                         # max-heap via negated d2
        while heap:
            nd2, node = heapq.heappop(heap)
            if len(best) == k and nd2 > -best[0][0]:
                break
            ch = self._children[node]
            if (ch < 0).all():
                idx = leaf_idx[self._start[node]:self._end[node]]
                d2 = ((self.points[idx] - center) ** 2).sum(1)
                for dd, ii in zip(d2, idx):
                    if len(best) < k:
                        heapq.heappush(best, (-dd, int(ii)))
                    elif dd < -best[0][0]:
                        heapq.heapreplace(best, (-dd, int(ii)))
            else:
                for c in ch:
                    if c >= 0:
                        near = np.maximum(self._bmin[c] - center, 0) \
                            + np.maximum(center - self._bmax[c], 0)
                        heapq.heappush(heap, (float((near ** 2).sum()),
                                              int(c)))
        return np.asarray(sorted((-d, i) for d, i in best))[:, 1].astype(
            np.int64) if best else np.empty(0, np.int64)

    def gather(self, x, kernel, solid_angle_eps: float = 0.05) -> np.ndarray:
        """Hierarchical weighted gather: sum_i kernel(|x - p_i|) * v_i,
        approximating far clusters by their aggregate at the centroid
        (irrtree.h:105 — cluster used when its apparent solid angle
        (size/dist)^2 falls below eps). kernel maps radii (...,) to
        weights (...,) or per-channel weights (..., C)."""
        x = np.asarray(x, np.float64)
        leaf_idx = np.asarray(self._leaf_idx_list, np.int64)
        acc = np.zeros(self.values.shape[1], np.float64)
        stack = [0]
        while stack:
            node = stack.pop()
            ext = self._bmax[node] - self._bmin[node]
            size2 = float((ext ** 2).sum())
            d2 = float(((x - self._centroid[node]) ** 2).sum())
            ch = self._children[node]
            if d2 > 0 and size2 / d2 < solid_angle_eps:
                acc = acc + np.asarray(kernel(np.sqrt(d2))) \
                    * self._vsum[node]
            elif (ch < 0).all():
                idx = leaf_idx[self._start[node]:self._end[node]]
                if len(idx):
                    r = np.sqrt(((self.points[idx] - x) ** 2).sum(1))
                    k = np.asarray(kernel(r))
                    if k.ndim == 1:
                        k = k[:, None]
                    acc = acc + (k * self.values[idx]).sum(0)
            else:
                stack.extend(int(c) for c in ch if c >= 0)
        return acc
