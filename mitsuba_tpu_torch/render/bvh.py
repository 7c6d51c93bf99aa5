"""Binned-SAH BVH in the flattened skip-link layout (the port's own copy of
mitsuba_tpu/render/bvh.py; host numpy).

Nodes come in DFS preorder with skip links, so a walk is stackless: from
node i a hit on an inner node goes to i + 1, a miss or a finished leaf to
skip[i]. Leaves hold at most MAX_LEAF triangles of a contiguous range of
the permuted order.

The tree is built by the native builder `csrc/bvh_builder.cpp` (a copy of
the JAX package's), compiled by the host `c++` at first use into
`_build/` (ops/build.py). The tree's order fixes every triangle's prim
id, so it must equal the JAX package's tree: the reference's numpy
recursion, which orders triangles differently, is not carried over, and a
failed build raises.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np

from mitsuba_tpu_torch.ops import build as nv

MAX_LEAF = 4          # triangles per leaf (the walk's unroll bound)
SOURCE = nv.source("bvh_builder.cpp")
_FN = None


@dataclass
class BVH:
    bounds_min: np.ndarray   # (M, 3) float32
    bounds_max: np.ndarray   # (M, 3) float32
    first: np.ndarray        # (M,) leaf: first triangle (permuted order)
    count: np.ndarray        # (M,) leaf: triangle count; 0 for inner nodes
    skip: np.ndarray         # (M,) node after a miss / a leaf; M = done
    perm: np.ndarray         # (T,) new position -> input triangle

    @property
    def n_nodes(self):
        return self.bounds_min.shape[0]


def build() -> str:
    """Compile (once per source hash) and bind the native builder; returns
    the compiler's output, empty when cached."""
    global _FN
    log = nv.build_all([SOURCE])[SOURCE]
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    _FN = nv.bind(SOURCE, "mts_build_bvh",
                  [fp, ctypes.c_int64, ip, ctypes.c_int64, ctypes.c_int32,
                   fp, fp, ip, ip, ip, ctypes.POINTER(ctypes.c_int64)],
                  restype=ctypes.c_int64)
    return log


def build_bvh(vertices: np.ndarray, faces: np.ndarray,
              max_leaf: int = MAX_LEAF) -> BVH:
    """Binned-SAH skip-link BVH over the indexed triangle soup."""
    if _FN is None:
        build()
    v = np.ascontiguousarray(vertices, np.float32)
    f = np.ascontiguousarray(faces, np.int32)
    t = f.shape[0]
    if t == 0:
        raise ValueError("a BVH needs at least one triangle")
    cap = max(2 * t, 2)
    bmin = np.empty((cap, 3), np.float32)
    bmax = np.empty((cap, 3), np.float32)
    first = np.empty(cap, np.int32)
    count = np.empty(cap, np.int32)
    skip = np.empty(cap, np.int32)
    perm = np.empty(t, np.int64)

    def ptr(a, ty):
        return a.ctypes.data_as(ctypes.POINTER(ty))

    m = _FN(ptr(v, ctypes.c_float), v.shape[0], ptr(f, ctypes.c_int32), t,
            max_leaf, ptr(bmin, ctypes.c_float), ptr(bmax, ctypes.c_float),
            ptr(first, ctypes.c_int32), ptr(count, ctypes.c_int32),
            ptr(skip, ctypes.c_int32), ptr(perm, ctypes.c_int64))
    if m <= 0:
        raise RuntimeError(f"native BVH build failed ({m})")
    return BVH(bounds_min=bmin[:m].copy(), bounds_max=bmax[:m].copy(),
               first=first[:m].copy(), count=count[:m].copy(),
               skip=skip[:m].copy(), perm=perm)
