"""Skip-link BVH walk, closest and any hit: the CUDA kernel and its plain
version (port of mitsuba_tpu/ops/bvh_pallas.py, TPU kernels
`_closest_kernel` :169 and `_any_kernel` :196, entries `bvh_closest` and
`bvh_any`).

The tables are the flattened skip-link BVH of render/bvh.py as two float
arrays: nodes (M, 9) bmin | bmax | first | count | skip and triangles
(T, 9) v0 | e1 | e2, ints stored as exact float32. A walk starts at node
0; a lane whose slab test against min(best t, maxt) passes an inner node
goes to i + 1, anything else goes to skip[i]; at a leaf it tests its (at
most MAX_LEAF) triangles, `min(first + k, T - 1)` with k < count, by
Möller–Trumbore with the strict `t < min(best t, maxt)`. The any-hit walk
caps by maxt alone and stops at the first occluder.

The TPU kernel walks a packet of 1,024 rays with one node pointer and
descends where any lane hits the box. Per lane that is the lane's own
walk: every box below a missed one lies inside it, so the lane's slab
tests there fail again (float rounding is monotone), and its best t only
shrinks. So the plain version and the CUDA kernel walk one ray each.

On CUDA tensors `bvh_closest` / `bvh_any` launch `csrc/bvh.cu`; on CPU
tensors they run `walk_ref`, the same walk in plain PyTorch. Both take
the clamp of the slab reciprocals as an argument: the TPU kernel's 1e-12
by default, the 1e-20 of the reference's exact XLA walk for the instance
walks (render/intersect.py).

The kernel reads the same tables as 16-byte records (`align_tables`):
nodes (M, 8) bmin | skip, bmax | first * 8 + count, the ints as int32
bits, and triangles (T, 12) v0 | e1 | e2, each padded to four floats.
The geometry builds them once, beside the (M, 9) and (T, 9) tables
(render/intersect.py), and passes them as `aligned`; a caller without
them gets them built for its call.
"""
from __future__ import annotations

import ctypes

import torch

from mitsuba_tpu_torch.ops import build as nv
from mitsuba_tpu_torch.ops.stream import mt

SOURCE = nv.source("bvh.cu")
MAX_LEAF = 4
_DET_EPS = 1e-9
# the clamp of |d| in the slab reciprocals: the TPU kernel's
RCP_EPS = 1e-12
# the plain walk checks for live lanes once every this many steps (each
# check is a host sync; the steps between are no-ops on finished lanes)
_CHECK_EVERY = 16
# the packed leaf word first * 8 + count: counts up to 7, first below 2^28
_COUNT_BITS = 3

# kernel launches since import, per query (reset by callers that count)
LAUNCHES = {"bvh_closest": 0, "bvh_any": 0}
_FN = None
_INFO = None


def build() -> str:
    """Compile (once per source hash) and bind the kernel; returns the
    compiler's output, empty when cached."""
    global _FN, _INFO
    log = nv.build_all([SOURCE])[SOURCE]
    p, i = ctypes.c_void_p, ctypes.c_int
    _FN = nv.bind(SOURCE, "mts_bvh",
                  [p] * 6 + [i] * 4 + [ctypes.c_float] + [p] * 6)
    _INFO = nv.bind(SOURCE, "mts_bvh_info", [i, p])
    return log


def bvh_info(any_hit: bool) -> dict:
    """The kernel's resources on the current card: resident 128-thread
    blocks per SM, registers and local (spill) bytes per thread."""
    if _INFO is None:
        build()
    out = (ctypes.c_int * 3)()
    nv.check(_INFO(int(any_hit), out), "bvh_info")
    return dict(blocks_per_sm=out[0], registers=out[1], local_bytes=out[2])


# ---------------------------------------------------------------------------
# The kernel's 16-byte tables
# ---------------------------------------------------------------------------

def align_tables(nodes, tris):
    """The kernel's records of the (M, 9) node and (T, 9) triangle
    tables: nodes (M, 8) bmin | skip, bmax | first * 8 + count (the ints
    as int32 bits) and triangles (T, 12) v0 | 0 | e1 | 0 | e2 | 0.
    Raises where an int of the node table is not one, or does not fit
    the packing (count 0-7, first below 2^28, as every tree of
    render/bvh.py has: leaves of at most 4)."""
    ints = nodes[:, 6:9]
    if not bool((ints == torch.trunc(ints)).all()):
        raise ValueError("node table: first, count and skip must be ints")
    first, count, skip = ints.to(torch.int64).unbind(1)
    if bool(((count < 0) | (count >= 1 << _COUNT_BITS) | (first < 0)
             | (first >= 1 << (31 - _COUNT_BITS))).any()):
        raise ValueError("node table: counts must lie in 0-7 and first "
                         "in [0, 2^28) for the kernel's packing")
    leaf = ((first << _COUNT_BITS) | count).to(torch.int32)
    na = torch.cat([nodes[:, 0:3], skip.to(torch.int32).view(torch.float32)
                    [:, None], nodes[:, 3:6],
                    leaf.view(torch.float32)[:, None]], dim=1)
    ta = torch.zeros((tris.shape[0], 12), dtype=torch.float32,
                     device=tris.device)
    for j in range(3):
        ta[:, 4 * j:4 * j + 3] = tris[:, 3 * j:3 * j + 3]
    return na, ta


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def _rcp(x, eps):
    return torch.where(x >= 0, 1.0, -1.0) / torch.clamp(torch.abs(x), min=eps)


def walk_ref(nodes, tris, o, d, mint, maxt, any_hit: bool,
             rcp_eps: float = RCP_EPS, work=None):
    """Plain version of the kernel: every lane walks the tree on its own,
    all lanes advancing together one node per step. Returns (t, u, v,
    prim, hit) with prim = -1 and hit = False on a miss (t is the walk's
    best t, inf when nothing was hit), or the occlusion mask. rcp_eps
    clamps |d| in the slab reciprocals, as the kernel's argument does.
    work: a dict that, if given, receives the walk's box and triangle
    tests (the work behind the kernel's bound)."""
    n = o.shape[0]
    m = nodes.shape[0]
    n_tris = tris.shape[0]
    dev = o.device
    inv = _rcp(d, rcp_eps)
    mn, mx = mint, maxt
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    t_b = torch.full((n,), float("inf"), device=dev)
    u_b = torch.zeros(n, device=dev)
    v_b = torch.zeros(n, device=dev)
    p_b = torch.full((n,), -1, dtype=torch.int64, device=dev)
    occ = torch.zeros(n, dtype=torch.bool, device=dev)
    live = node < m
    n_box = n_tri = torch.zeros((), dtype=torch.int64, device=dev)
    ks = torch.arange(MAX_LEAF, device=dev)[None]
    step = 0
    while step % _CHECK_EVERY or bool(live.any()):
        step += 1
        nd = torch.clamp(node, max=m - 1)
        row = nodes[nd]
        first = row[:, 6].to(torch.int64)
        count = row[:, 7].to(torch.int64)
        skip = row[:, 8].to(torch.int64)
        t_cap = mx if any_hit else torch.minimum(t_b, mx)
        t0 = (row[:, 0:3] - o) * inv
        t1 = (row[:, 3:6] - o) * inv
        lo = torch.minimum(t0, t1)
        hi = torch.maximum(t0, t1)
        tnear = torch.maximum(torch.maximum(lo[:, 0], lo[:, 1]),
                              torch.maximum(lo[:, 2], mn))
        tfar = torch.minimum(torch.minimum(hi[:, 0], hi[:, 1]),
                             torch.minimum(hi[:, 2], t_cap))
        box = live & (tnear <= tfar)
        leaf = count > 0
        if work is not None:
            n_box = n_box + live.sum()
            n_tri = n_tri + (box & leaf).long().mul(
                torch.clamp(count, max=MAX_LEAF)).sum()
        # the leaf's triangles at once: the kernel's sequential strict
        # `t < min(best t, maxt)` keeps the least t below the leaf's
        # starting cap, the first k among equal t
        ti = torch.clamp(first[:, None] + ks, max=n_tris - 1)
        t, u, v, hit = (x[..., 0] for x in mt(
            tris[ti], [o[:, None, j:j + 1] for j in range(3)],
            [d[:, None, j:j + 1] for j in range(3)], mn[:, None, None],
            t_cap[:, None, None], eps=_DET_EPS))
        take = hit & (box & leaf)[:, None] & (ks < count[:, None])
        if any_hit:
            occ = occ | take.any(dim=1)
        else:
            t = torch.where(take, t, float("inf"))
            t_min, _ = t.min(dim=1)
            k = ((t == t_min[:, None]) & take).to(torch.int8).argmax(
                dim=1, keepdim=True)
            has = take.any(dim=1)
            t_b = torch.where(has, t_min, t_b)
            u_b = torch.where(has, u.gather(1, k)[:, 0], u_b)
            v_b = torch.where(has, v.gather(1, k)[:, 0], v_b)
            p_b = torch.where(has, first + k[:, 0], p_b)
        node = torch.where(live, torch.where(box & ~leaf, nd + 1, skip), node)
        live = (node < m) & ~occ
    if work is not None:
        work.update(box_tests=int(n_box), tri_tests=int(n_tri))
    if any_hit:
        return occ
    ok = (p_b >= 0) & (t_b < mx)
    return t_b, u_b, v_b, torch.where(ok, p_b, -1).to(torch.int32), ok


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

def _check(nodes, tris, o, d, mint, maxt):
    n = o.shape[0]
    for x, shape in ((nodes, (nodes.shape[0], 9)), (tris, (tris.shape[0], 9)),
                     (o, (n, 3)), (d, (n, 3)), (mint, (n,)), (maxt, (n,))):
        if x.dtype != torch.float32 or tuple(x.shape) != shape:
            raise ValueError(f"expected float32 {shape}, got {x.dtype} "
                             f"{tuple(x.shape)}")
        if x.device != o.device:
            raise ValueError("inputs must be on one device")
    if nodes.shape[0] < 1 or tris.shape[0] < 1:
        raise ValueError("empty BVH tables")
    nv.refuse_grad(nodes, tris, o, d, mint, maxt)


def _query(nodes, tris, o, d, mint, maxt, any_hit, rcp_eps, aligned):
    _check(nodes, tris, o, d, mint, maxt)
    if o.device.type == "cpu":
        return walk_ref(nodes, tris, o, d, mint, maxt, any_hit, rcp_eps)
    if o.device.type != "cuda":
        raise NotImplementedError(f"no BVH kernel for {o.device}")
    if _FN is None:
        build()
    n = o.shape[0]
    dev = o.device
    na, ta = aligned if aligned is not None else align_tables(nodes, tris)
    if tuple(na.shape) != (nodes.shape[0], 8) or tuple(ta.shape) != (
            tris.shape[0], 12) or na.dtype != torch.float32 or \
            ta.dtype != torch.float32 or na.device != dev or \
            ta.device != dev:
        raise ValueError("aligned tables: float32 (M, 8) and (T, 12) on "
                         "the rays' device")
    args = [x.contiguous() for x in (na, ta, o, d, mint, maxt)]
    with torch.cuda.device(dev):
        t = torch.empty(n, dtype=torch.float32, device=dev)
        u = torch.empty_like(t)
        v = torch.empty_like(t)
        p = torch.empty(n, dtype=torch.int32, device=dev)
        hit = torch.empty(n, dtype=torch.int32, device=dev)
        err = _FN(*[x.data_ptr() for x in args], n, nodes.shape[0],
                  tris.shape[0], int(any_hit), rcp_eps, t.data_ptr(),
                  u.data_ptr(), v.data_ptr(), p.data_ptr(), hit.data_ptr(),
                  torch.cuda.current_stream(dev).cuda_stream)
    nv.check(err, "bvh")
    if n > 0:
        LAUNCHES["bvh_any" if any_hit else "bvh_closest"] += 1
    if any_hit:
        return hit.bool()
    return t, u, v, p, hit.bool()


def bvh_closest(nodes, tris, o, d, mint, maxt, rcp_eps: float = RCP_EPS,
                aligned=None):
    """Closest hit: (t, u, v, prim, hit); prim = -1 where hit is False.
    The kernel on CUDA tensors, its plain version on CPU ones. rcp_eps:
    the clamp of |d| in the slab reciprocals (the exact instance walks of
    render/intersect.py pass the reference's 1e-20). aligned: the
    kernel's tables, align_tables(nodes, tris), built here when not
    given (the plain version reads nodes and tris)."""
    return _query(nodes, tris, o, d, mint, maxt, False, rcp_eps, aligned)


def bvh_any(nodes, tris, o, d, mint, maxt, rcp_eps: float = RCP_EPS,
            aligned=None):
    """Any hit within (mint, maxt): the occlusion mask."""
    return _query(nodes, tris, o, d, mint, maxt, True, rcp_eps, aligned)
