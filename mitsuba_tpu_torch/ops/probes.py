"""Cost probes of the card: the CUDA kernels of csrc/probes.cu, their
wrappers and their plain versions (port of the TPU cost probes of
scripts/: exp_kernel_cost.py:71,111,188,228,270, exp_r3_kernel.py:70,112,
exp_r3_mt.py:63 and exp_r5_megakernel.py:72).

Each probe computes what its TPU script's kernel body computes, in the
form the port's kernels take: a 128-thread block, a thread per lane,
looping over items or steps (see the source's note). `blocks` asks for
that many copies of the work, each written to its own slot of the
result, a block each (but the spread products, below): 1 for the
per-block form, 8,192 for the whole card.

* floors: `count` (a kernel that only counts its launches), `gate`
  (run_empty: an item loop gated per item, adding the 8 row sums of a
  block read in place; the list loaded once into shared memory, the
  items 16 a pass, a thread a row, 64 items' row loads in flight while 8
  threads fold the batch before in item order: bound by a batch's round
  trip to L2 and that serial fold), `rotate` (run_dma_rotate: the same
  with each item's block staged in shared memory, on a ring of
  `ring_stages` blocks that TMA bulk copies fill ahead of the items
  summed, three warps issuing and one waiting for up to four items at
  once: bound by the latency of the waits on the ring's mbarriers; the
  staging floor that #12's staging is judged against), `grid`
  (bench_grid_floor: row 0 of a 2 KB block per item, staged or in
  place; staged, an instance of rotate's ring whose stage holds
  `grid_plan`'s GRID_GROUP items under one wait, so that a wait's
  latency is paid once for 64 KB);
* `fma` (run_vpu_fma): dependent fused multiply-adds;
* `mt` (run_vpu_mt): csrc/mt.cuh's test of a resident cluster, the
  running nearest t and chunk per sublane;
* `v0`, `v1`, `v2`, `v4` (exp_r3_mt.py's variants; `v1` without u is
  bench_mt_ceiling): the FMA ceiling, mt.cuh's test in the TPU's
  `_mt_chunks` form, and the approximate-reciprocal forms with a packed
  (t_bits << 2) | chunk minimum (V3's explicit broadcast has no
  counterpart on the card, where registers are per thread: it is V2);
* `mm_cuda`, `mm_tf32`, `mm_bf16` (run_mm): the sum over steps of
  (G @ M)[0:8], on the float32 pipes as #14 forms its Plücker products,
  and on the tensor cores with K padded to 16 (or 128); the products of
  the other rows feed a running maximum, so that all are computed. All
  three spread each copy's product over several blocks by `mm_plan`,
  and fold the maximum across them in the same launch: a call is one
  launch. `mm_tf32` and `mm_bf16` are the two instances of one wgmma
  kernel, which pads K and rounds (TF32 to nearest, ties away; bf16 to
  nearest even) itself; each is bound by a launch's floor at run_mm's
  sizes, and over many copies by its per-step wait and fold at K 10;
* `gather_smem`, `gather_global` (pallas_gather): table[idx], from the
  table staged in shared memory or from device memory.

On CUDA tensors each wrapper launches its kernel (or raises); on CPU
tensors it runs the plain version. The plain versions repeat the kernels'
float32 operations in order, so most results are equal bit for bit; the
exceptions, each with its tolerance in `TOLERANCE`: the tensor-core sums
(the hardware's summation order) and the approximate reciprocals of V2
and V4 (the plain versions divide exactly; V4's accepts do not depend on
the reciprocal and stay exact).
"""
from __future__ import annotations

import ctypes

import torch

from mitsuba_tpu_torch.ops import build as nv
from mitsuba_tpu_torch.ops.rows import BIG, LANES
from mitsuba_tpu_torch.ops.stream import mt as mt_plain

SOURCE = nv.source("probes.cu")
ROWS = 8
ROW_COLS = 16
N_COEF = 10
DET_EPS = 1e-12
MAX_K = 128
MAX_STAGE = 8192          # floats of a staged block (32 KB)
GRID_FLOATS = 4 * LANES   # bench_grid_floor's (4, 128) block, 2 KB
PACKED_NONE = 0x7F800000
FMA_C = 0.999999          # run_vpu_fma's multiplier, as float32
# the largest difference allowed between a kernel and its plain version,
# relative to the largest magnitude of the plain result; 0 means bit for
# bit. Tensor cores: each product exact, the float32 sums in the
# hardware's order (K terms, ~K * 2^-23 of their magnitude); V2 and V4:
# t from rcp.approx (relative error under 2^-22) against an exact
# division, moving the packed minimum by a few units of its ~2^30.
TOLERANCE = {"mm_tf32": 1e-4, "mm_bf16": 1e-4, "v2": 1e-5, "v4": 1e-5}
# V2's accepts also move with the reciprocal (u, v and t near a bound):
# the share of (sublane, lane) accept counts allowed to differ
V2_HITS_DIFFER_MAX = 0.01


def rel_err(got, ref) -> float:
    """The largest |got - ref| over the values finite in both, relative to
    the largest |ref| there (0 where nothing is finite)."""
    fin = torch.isfinite(got) & torch.isfinite(ref)
    if not bool(fin.any()):
        return 0.0
    scale = float(ref[fin].abs().max())
    return float((got - ref)[fin].abs().max()) / max(scale, 1e-30)


# the staging ring of rotate and grid: the shared memory its stages may
# fill (one block a SM; rotate's 6 stages of 32 KB, 12 of 16 KB, 24 of
# 8 KB: from 16 KB down room for a batch of 4 items being summed and 4 or
# more in flight), the most stages and the most items a stage (a producer
# lane each; csrc/probes.cu)
RING_BYTES = 192 * 1024
RING_MAX_STAGES = 32
RING_MAX_GROUP = 32
# grid's items a stage, under one wait: 32 of 2 KB, 64 KB a wait, in 3
# stages (with 16 the fastest of 1-32 on the card, per block and over
# 8,192 copies: csrc/probes.cu's note)
GRID_GROUP = 32
# gate's schedule (csrc/probes.cu): items a pass (a thread a row of one),
# passes a batch (the loads in flight while the batch before is folded),
# items of the list in shared memory at once
GATE_PASS = LANES // ROWS
GATE_PASSES = 4
GATE_CHUNK = 512


# kernel launches since import, per probe (reset by callers that count)
LAUNCHES = {k: 0 for k in (
    "count", "gate", "rotate", "grid", "fma", "mt", "v0", "v1", "v2", "v4",
    "mm_cuda", "mm_tf32", "mm_bf16", "gather_smem", "gather_global")}
_FN = {}
# the tickets of the spread products (csrc/probes.cu), one buffer per
# (device, stream): zeroed once, on that stream, and left at zero by every
# launch, which runs after the one before it on its stream
_TICKETS = {}
# the device counter that the spread products add their blocks to while
# `blocks_ran` measures a call; None: they count nothing
_RAN = None


def build() -> str:
    """Compile (once per source hash) and bind the probes; returns the
    compiler's output, empty when cached."""
    log = nv.build_all([SOURCE])[SOURCE]
    p, i = ctypes.c_void_p, ctypes.c_int
    sigs = {
        "count": [p, i, i], "gate": [p, i, p, p, i, i, p],
        "rotate": [p, i, p, i, i, i, p], "grid": [p, p, i, i, i, i, i, p],
        "fma": [p, p, i, i, i, p], "mt": [p, i, p, i, i, i, p, p],
        "v0": [p, i, i, p], "v1": [p, i, p, i, i, i, p, p],
        "v2": [p, i, p, i, i, p, p], "v4": [p, i, p, i, i, p, p],
        "mm_cuda": [p, i, p, i, i, i, i, i, p, p, p, p, p],
        "mm_tf32": [p, i, i, p, i, i, i, i, i, p, p, p, p, p],
        "mm_bf16": [p, i, i, p, i, i, i, i, i, p, p, p, p, p],
        "gather_smem": [p, i, p, i, p], "gather_global": [p, i, p, i, p],
    }
    for name, args in sigs.items():
        _FN[name] = nv.bind(SOURCE, f"mts_probe_{name}", args + [p])
    _FN["mm_info"] = nv.bind(SOURCE, "mts_probe_mm_info", [i, p])
    _FN["ring_info"] = nv.bind(SOURCE, "mts_probe_ring_info", [i, i, i, i, p])
    return log


def mm_info(kind: str, k: int = N_COEF) -> dict:
    """The resources of a spread product kernel (kind "cuda", "tf32" or
    "bf16", the tensor-core ones at depth k) on the current card: blocks
    resident per SM, registers per thread, shared memory bytes a block and
    local (spill) bytes per thread; and the tile rows and column halves
    the kernel is compiled for (TILE_ROWS, HALVES here must match them)."""
    if "mm_info" not in _FN:
        build()
    out = (ctypes.c_int * 6)()
    which = 0 if kind == "cuda" else {"tf32": 1, "bf16": 3}[kind] + (k > 16)
    nv.check(_FN["mm_info"](which, out), "mm_info")
    return dict(blocks_per_sm=out[0], registers=out[1], smem_bytes=out[2],
                local_bytes=out[3], tile_rows=out[4], halves=out[5])


def ring_stages(block_floats: int) -> int:
    """The stages of rotate's ring for blocks of `block_floats` floats:
    as many as RING_BYTES holds, at most RING_MAX_STAGES."""
    return min(RING_MAX_STAGES, RING_BYTES // (4 * block_floats))


def grid_plan(n: int) -> dict:
    """grid's ring (fetch) for n items: GRID_GROUP 2 KB items a stage
    (one wait), as many stages as RING_BYTES holds (at most
    RING_MAX_STAGES); the items in `groups` groups of consecutive items,
    group q in stage q % stages, the last holding `last` (0 without
    items)."""
    group = GRID_GROUP
    stages = min(RING_MAX_STAGES, RING_BYTES // (4 * GRID_FLOATS * group))
    groups = -(-n // group)
    return dict(group=group, stages=stages, groups=groups,
                last=n - (groups - 1) * group if groups else 0)


def _ring_info(grid: int, item_floats: int, group: int, stages: int):
    if "ring_info" not in _FN:
        build()
    out = (ctypes.c_int * 5)()
    nv.check(_FN["ring_info"](grid, item_floats, group, stages, out),
             "ring_info")
    return dict(stages=stages, batch=out[4], blocks_per_sm=out[0],
                registers=out[1], smem_bytes=out[2], local_bytes=out[3])


def rotate_info(block_floats: int) -> dict:
    """rotate's resources on the current card for blocks of
    `block_floats` floats: its stages, the items its loop waits for at
    once (`batch`), blocks resident per SM, registers per thread, shared
    memory bytes a block (the ring and its barriers) and local (spill)
    bytes per thread."""
    return _ring_info(0, block_floats, 1, ring_stages(block_floats))


def grid_info() -> dict:
    """grid's (fetch) resources on the current card, on grid_plan's ring:
    as rotate_info, `group` (= `batch`) the items a wait covers."""
    plan = grid_plan(0)
    return dict(_ring_info(1, GRID_FLOATS, plan["group"], plan["stages"]),
                group=plan["group"])


def _on_card(*xs) -> bool:
    """True for CUDA tensors, False for CPU ones (all on one device,
    contiguous); raises on anything else."""
    dev = xs[0].device
    for x in xs:
        if x.device != dev or not x.is_contiguous():
            raise ValueError("inputs must be contiguous, on one device")
    if dev.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"no probe kernels for {dev}")
    nv.refuse_grad(*xs)
    return dev.type == "cuda"


def _launch(name, device, *args):
    if name not in _FN:
        build()
    with torch.cuda.device(device):
        err = _FN[name](*args, torch.cuda.current_stream(device).cuda_stream)
    nv.check(err, f"probe {name}")


def _copies(x, blocks):
    """The plain result as the kernel returns it: one copy per block."""
    return x[None].expand(blocks, *x.shape).contiguous()


def _ptr(x):
    return x.data_ptr()


def _need(x, dtype, shape, what):
    if x.dtype != dtype or tuple(x.shape) != tuple(shape):
        raise ValueError(f"{what}: expected {dtype} {tuple(shape)}, got "
                         f"{x.dtype} {tuple(x.shape)}")


def _need_aligned(x, what, why):
    """x contiguous and starting on 16 bytes (its kernel reads it `why`),
    checked on the CPU as on the card."""
    if not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous: {why}")
    if x.data_ptr() % 16:
        raise ValueError(f"{what} must start on 16 bytes ({why}), not "
                         f"{x.data_ptr() % 16} past")


# ---------------------------------------------------------------------------
# float32 arithmetic of the kernels, in plain PyTorch
# ---------------------------------------------------------------------------

def fma32(a, b, c):
    """float32 a * b + c rounded once, as __fmaf_rn. The product is exact
    in float64; the float64 sum s is rounded once more to float32, which
    can differ from one rounding only where s falls halfway between two
    floats: there the exact remainder e of the sum (TwoSum) decides."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    z = s - p
    e = (p - (s - z)) + (cd - z)
    f = s.float()
    fd = f.double()
    side = torch.where(s > fd, float("inf"), float("-inf")).float()
    other = torch.nextafter(f, side)
    tie = (s != fd) & (s - fd == other.double() - s)
    beyond = (e != 0) & ((e > 0) == (other > f))
    return torch.where(tie & beyond, other, f)


def round_tf32(x):
    """float32 -> the nearest TF32 value (10-bit mantissa, ties away from
    zero: cvt.rna.tf32.f32), kept as float32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def round_bf16(x):
    """float32 -> the nearest bfloat16 value (7-bit mantissa, ties to
    even, as torch.Tensor.to(torch.bfloat16) and cvt.rn.bf16x2.f32),
    kept as float32."""
    return x.to(torch.bfloat16).float()


def _row_sums(blk):
    """(..., rows, 16) -> (..., 8): each of the first 8 rows summed in
    order."""
    s = blk[..., 0:ROWS, 0]
    for c in range(1, ROW_COLS):
        s = s + blk[..., 0:ROWS, c]
    return s


def _sequential_sum(terms, start):
    """start + terms[0] + terms[1] + ..., in that order."""
    acc = start
    for k in range(terms.shape[0]):
        acc = acc + terms[k]
    return acc


def _f32(v, like):
    return torch.tensor(v, dtype=torch.float32, device=like.device)


# ---------------------------------------------------------------------------
# Floors
# ---------------------------------------------------------------------------

def count_ref(count, n_launches: int):
    return count + n_launches


def count(counter, n_launches: int, blocks: int = 1):
    """n_launches back-to-back launches of a kernel of `blocks` blocks
    that adds one to counter[0] (int32 (1,)); returns the counter."""
    _need(counter, torch.int32, (1,), "counter")
    if not _on_card(counter):
        counter.copy_(count_ref(counter, n_launches))
        return counter
    _launch("count", counter.device, _ptr(counter), n_launches, blocks)
    LAUNCHES["count"] += n_launches
    return counter


def gate_ref(g, ids, flags):
    """run_empty's sum: over the items whose flag is set, in order, the 8
    row sums of block ids[i] of g (B, rows, 16); (8, 128)."""
    on = (flags > 0).nonzero()[:, 0]
    acc = _sequential_sum(_row_sums(g[ids[on].long()]),
                          torch.zeros(ROWS, dtype=torch.float32,
                                      device=g.device))
    return acc[:, None].expand(ROWS, LANES).contiguous()


def _check_g(g, why, most_rows=None):
    """g float32 (B, rows, 16), 8 <= rows (<= most_rows), contiguous and
    on 16 bytes (its kernel reads it `why`)."""
    rows = g.shape[1] if g.dim() == 3 else 0
    if g.dtype != torch.float32 or g.dim() != 3 or g.shape[2] != ROW_COLS \
            or rows < ROWS or (most_rows and rows > most_rows):
        raise ValueError(f"g must be float32 (B, 8..{most_rows or ''}, 16), "
                         f"got {g.dtype} {tuple(g.shape)}")
    _need_aligned(g, "g", why)


def gate(g, ids, flags, blocks: int = 1):
    """The gated item loop; (blocks, 8, 128). The kernel reads each row of
    16 floats as four 16-byte loads: g must be float32, contiguous and
    start on 16 bytes (a row is then 64 bytes)."""
    _need(ids, torch.int32, (ids.shape[0],), "ids")
    _need(flags, torch.int32, ids.shape, "flags")
    _check_g(g, "its rows are read as float4")
    if not _on_card(g, ids, flags):
        return _copies(gate_ref(g, ids, flags), blocks)
    out = torch.empty((blocks, ROWS, LANES), dtype=torch.float32,
                      device=g.device)
    _launch("gate", g.device, _ptr(g), g.shape[1], _ptr(ids), _ptr(flags),
            ids.shape[0], blocks, _ptr(out))
    LAUNCHES["gate"] += 1
    return out


def rotate_ref(g, ids):
    """run_dma_rotate's sum: every item's 8 row sums; (8, 128)."""
    return gate_ref(g, ids, torch.ones_like(ids))


def rotate(g, ids, blocks: int = 1):
    """The item loop staging each item's whole block (rows * 16 floats,
    at most 32 KB) in shared memory, on a ring of ring_stages(rows * 16)
    blocks that bulk copies fill; (blocks, 8, 128). The bulk copy takes a
    source on 16 bytes and a multiple of 16 bytes: g must be float32,
    contiguous and start on 16 bytes, and a block of (rows, 16) floats is
    always a multiple of 4 floats. No items (n = 0) are taken: the sums
    are 0."""
    _need(ids, torch.int32, (ids.shape[0],), "ids")
    _check_g(g, "each block is one bulk copy", MAX_STAGE // ROW_COLS)
    if not _on_card(g, ids):
        return _copies(rotate_ref(g, ids), blocks)
    out = torch.empty((blocks, ROWS, LANES), dtype=torch.float32,
                      device=g.device)
    bf = g.shape[1] * ROW_COLS
    _launch("rotate", g.device, _ptr(g), bf, _ptr(ids), ids.shape[0],
            ring_stages(bf), blocks, _ptr(out))
    LAUNCHES["rotate"] += 1
    return out


def grid_ref(tri, ids, fetch: bool):
    """bench_grid_floor's sum: row 0 of block ids[i] of tri (B, 4, 128)
    (of block 0 without fetch) over the items, in order; rows 1-7 zero;
    (8, 128)."""
    rows = tri[ids.long(), 0] if fetch else tri[0, 0][None].expand(
        ids.shape[0], LANES)
    out = torch.zeros((ROWS, LANES), dtype=torch.float32, device=tri.device)
    out[0] = _sequential_sum(rows, out[0])
    return out


def grid(tri, ids, fetch: bool, blocks: int = 1):
    """The near-empty item loop, with (fetch) or without a 2 KB block
    staged per item; (blocks, 8, 128). With fetch, the blocks go through
    the bulk-copy ring of grid_plan(n), GRID_GROUP items a stage: tri
    must be contiguous and start on 16 bytes (a block of 512 floats is a
    multiple of 16 bytes). No items (n = 0) are taken: the sums are 0."""
    _need(ids, torch.int32, (ids.shape[0],), "ids")
    _need(tri, torch.float32, (tri.shape[0], 4, LANES), "tri")
    _need_aligned(tri, "tri", "each block is one bulk copy")
    plan = grid_plan(ids.shape[0])
    if not _on_card(tri, ids):
        return _copies(grid_ref(tri, ids, fetch), blocks)
    out = torch.empty((blocks, ROWS, LANES), dtype=torch.float32,
                      device=tri.device)
    _launch("grid", tri.device, _ptr(tri), _ptr(ids), ids.shape[0],
            int(fetch), plan["group"], plan["stages"], blocks, _ptr(out))
    LAUNCHES["grid"] += 1
    return out


# ---------------------------------------------------------------------------
# FMA rate
# ---------------------------------------------------------------------------

def fma_ref(a, b, n_ops: int, steps: int):
    """run_vpu_fma: steps * n_ops dependent x = fma(x, 0.999999, b) from
    x = a; (8, 128)."""
    c = _f32(FMA_C, a)
    x = a
    for _ in range(steps * n_ops):
        x = fma32(x, c, b)
    return x


def fma(a, b, n_ops: int, steps: int, blocks: int = 1):
    """The FMA chain; (blocks, 8, 128)."""
    _need(a, torch.float32, (ROWS, LANES), "a")
    _need(b, torch.float32, (ROWS, LANES), "b")
    if not _on_card(a, b):
        return _copies(fma_ref(a, b, n_ops, steps), blocks)
    out = torch.empty((blocks, ROWS, LANES), dtype=torch.float32,
                      device=a.device)
    _launch("fma", a.device, _ptr(a), _ptr(b), n_ops, steps, blocks,
            _ptr(out))
    LAUNCHES["fma"] += 1
    return out


# ---------------------------------------------------------------------------
# Möller–Trumbore
# ---------------------------------------------------------------------------

def _ray(rays8):
    """Lane rays of an (8, 128) block as mt_plain's (1, 1, 128) planes."""
    return ([rays8[j][None, None] for j in range(3)],
            [rays8[3 + j][None, None] for j in range(3)])


def mt_ref(tri, rays, steps: int):
    """run_vpu_mt: per step, per sublane s the running nearest t (from
    1e9, t > 1e-4) and chunk j over triangles j * 8 + s of tri (K, 16);
    then the minimum t over sublanes and steps, the maximum chunk.
    Returns (t (128,) f32, chunk (128,) int32)."""
    o, d = _ray(rays)
    dev = rays.device
    to = torch.full((LANES,), 1e9, dtype=torch.float32, device=dev)
    po = torch.full((LANES,), -1, dtype=torch.int32, device=dev)
    for _ in range(steps):
        t_run = torch.full((ROWS, LANES), 1e9, dtype=torch.float32,
                           device=dev)
        k_run = torch.full((ROWS, LANES), -1, dtype=torch.int32, device=dev)
        for j in range(tri.shape[0] // ROWS):
            t, _u, _v, ok = mt_plain(tri[None, j * ROWS:(j + 1) * ROWS], o,
                                     d, 1e-4, t_run[None], DET_EPS)
            t_run = torch.where(ok[0], t[0], t_run)
            k_run = torch.where(ok[0], j, k_run)
        to = torch.minimum(to, t_run.amin(dim=0))
        po = torch.maximum(po, k_run.amax(dim=0))
    return to, po


def _check_cluster(tri, rays, pairs=False):
    _need(rays, torch.float32, (ROWS, LANES), "rays")
    k = tri.shape[0]
    bad = k % 16 or k > 32 if pairs else k % ROWS or k > MAX_K
    if tri.dtype != torch.float32 or tri.shape[1:] != (ROW_COLS,) or not k \
            or bad:
        raise ValueError(f"tri must be float32 (K, 16), K a multiple of "
                         f"{16 if pairs else 8} up to {32 if pairs else 128}"
                         f", got {tri.dtype} {tuple(tri.shape)}")


def mt(tri, rays, steps: int, blocks: int = 1):
    """The cluster test; (t (blocks, 128), chunk (blocks, 128))."""
    _check_cluster(tri, rays)
    if not _on_card(tri, rays):
        return tuple(_copies(x, blocks) for x in mt_ref(tri, rays, steps))
    t = torch.empty((blocks, LANES), dtype=torch.float32, device=tri.device)
    p = torch.empty((blocks, LANES), dtype=torch.int32, device=tri.device)
    _launch("mt", tri.device, _ptr(tri), tri.shape[0], _ptr(rays), steps, 0,
            blocks, _ptr(t), _ptr(p))
    LAUNCHES["mt"] += 1
    return t, p


def v0_ref(rays, reps: int):
    """V0: per iteration 8 chains acc + k, each 4 times a = fma(a, b, b)
    with b = rays, summed in order, times 1e-6; (8, 128)."""
    acc = torch.zeros_like(rays)
    for _ in range(reps):
        a = [acc + float(k) for k in range(8)]
        for _q in range(4):
            a = [fma32(x, rays, rays) for x in a]
        s = a[0]
        for x in a[1:]:
            s = s + x
        acc = s * _f32(1e-6, rays)
    return acc


def _moved(rays, acc):
    """The iteration's ray planes: rays + acc * 1e-30."""
    return rays + acc * _f32(1e-30, rays)


def v1_ref(tri, rays, reps: int, add_u: bool = True):
    """V1: mt.cuh's test in `_mt_chunks` form (mnb 0, cap 3e38, even and
    odd chunks apart, the odd run taken where strictly nearer); acc +=
    t_run (+ u_run). Returns (acc (8, 128), accepts (8, 128) int32)."""
    acc = torch.zeros_like(rays)
    hits = torch.zeros(rays.shape, dtype=torch.int32, device=rays.device)
    for _ in range(reps):
        o, d = _ray(_moved(rays, acc))
        runs = [[torch.full_like(rays, BIG), torch.zeros_like(rays)]
                for _g in range(2)]
        for j in range(tri.shape[0] // ROWS):
            t, u, _v, ok = mt_plain(tri[None, j * ROWS:(j + 1) * ROWS], o,
                                    d, 0.0, BIG, DET_EPS)
            t, u, ok = t[0], u[0], ok[0]
            hits = hits + ok.to(torch.int32)
            run = runs[j & 1]
            take = ok & (t < run[0])
            run[0] = torch.where(take, t, run[0])
            run[1] = torch.where(take, u, run[1])
        odd = runs[1][0] < runs[0][0]
        acc = acc + torch.where(odd, runs[1][0], runs[0][0])
        if add_u:
            acc = acc + torch.where(odd, runs[1][1], runs[0][1])
    return acc, hits


def _packed_terms(tri, o, d, j, divfree):
    """The V2 (divfree False) or V4 candidate of chunk j: (packed (8, 128)
    int32, accepted (8, 128) bool), with an exact division standing in
    for the kernels' approximate reciprocal."""
    f = [tri[j * ROWS:(j + 1) * ROWS, c:c + 1] for c in range(9)]
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = f
    ox, oy, oz = (x[0, 0][None] for x in o)
    dx, dy, dz = (x[0, 0][None] for x in d)
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    tvx = ox - v0x
    tvy = oy - v0y
    tvz = oz - v0z
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    if divfree:
        sd = torch.where(det >= 0, 1.0, -1.0)
        ad = det * sd
        us = (tvx * pvx + tvy * pvy + tvz * pvz) * sd
        vs = (dx * qvx + dy * qvy + dz * qvz) * sd
        ts = (e2x * qvx + e2y * qvy + e2z * qvz) * sd
        t = ts * (1.0 / ad)
        ok = (us >= 0.0) & (vs >= 0.0) & (us + vs <= ad) & (t > 0.0) & (
            t < BIG)
    else:
        inv = 1.0 / det
        u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv
        v = (dx * qvx + dy * qvy + dz * qvz) * inv
        t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv
        ok = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0) & (t < BIG)
    cand = (t.view(torch.int32) << 2) | j
    return torch.where(ok, cand, PACKED_NONE), ok


def packed_ref(tri, rays, reps: int, divfree: bool):
    """V2 (divfree False; also V3) and V4: per sublane the packed minimum
    (t_bits << 2) | chunk of the even and of the odd chunks, then of the
    two; acc += float(packed) * 1e-9. Returns (acc, accepts)."""
    acc = torch.zeros_like(rays)
    hits = torch.zeros(rays.shape, dtype=torch.int32, device=rays.device)
    for _ in range(reps):
        o, d = _ray(_moved(rays, acc))
        p = [torch.full(rays.shape, PACKED_NONE, dtype=torch.int32,
                        device=rays.device) for _g in range(2)]
        for j in range(tri.shape[0] // ROWS):
            cand, ok = _packed_terms(tri, o, d, j, divfree)
            hits = hits + ok.to(torch.int32)
            p[j & 1] = torch.minimum(p[j & 1], cand)
        acc = acc + torch.minimum(p[0], p[1]).float() * _f32(1e-9, rays)
    return acc, hits


def v0(rays, reps: int, blocks: int = 1):
    """V0; (blocks, 8, 128)."""
    _need(rays, torch.float32, (ROWS, LANES), "rays")
    if not _on_card(rays):
        return _copies(v0_ref(rays, reps), blocks)
    out = torch.empty((blocks, ROWS, LANES), dtype=torch.float32,
                      device=rays.device)
    _launch("v0", rays.device, _ptr(rays), reps, blocks, _ptr(out))
    LAUNCHES["v0"] += 1
    return out


def _variant(name, tri, rays, reps, blocks, extra=()):
    out = torch.empty((blocks, ROWS, LANES), dtype=torch.float32,
                      device=rays.device)
    hits = torch.empty((blocks, ROWS, LANES), dtype=torch.int32,
                       device=rays.device)
    _launch(name, rays.device, _ptr(tri), tri.shape[0], _ptr(rays), reps,
            *extra, blocks, _ptr(out), _ptr(hits))
    LAUNCHES[name] += 1
    return out, hits


def v1(tri, rays, reps: int, add_u: bool = True, blocks: int = 1):
    """V1 (add_u False: bench_mt_ceiling); (acc, accepts), each (blocks,
    8, 128)."""
    _check_cluster(tri, rays, pairs=True)
    if not _on_card(tri, rays):
        return tuple(_copies(x, blocks)
                     for x in v1_ref(tri, rays, reps, add_u))
    return _variant("v1", tri, rays, reps, blocks, (int(add_u),))


def v2(tri, rays, reps: int, blocks: int = 1):
    """V2 (and V3); (acc, accepts), each (blocks, 8, 128)."""
    _check_cluster(tri, rays, pairs=True)
    if not _on_card(tri, rays):
        return tuple(_copies(x, blocks)
                     for x in packed_ref(tri, rays, reps, False))
    return _variant("v2", tri, rays, reps, blocks)


def v4(tri, rays, reps: int, blocks: int = 1):
    """V4; (acc, accepts), each (blocks, 8, 128)."""
    _check_cluster(tri, rays, pairs=True)
    if not _on_card(tri, rays):
        return tuple(_copies(x, blocks)
                     for x in packed_ref(tri, rays, reps, True))
    return _variant("v4", tri, rays, reps, blocks)


# ---------------------------------------------------------------------------
# Plücker products: the sum over steps of (G @ M)[0:8]
# ---------------------------------------------------------------------------

# rows of G in a tile, per spread kernel (csrc/probes.cu MM_ROWS,
# TC_ROWS), and the column halves a tensor-core copy splits M into
TILE_ROWS = {"cuda": 32, "tf32": 64, "bf16": 64}
HALVES = {"cuda": 1, "tf32": 2, "bf16": 2}
# the most blocks a launch spreads its copies' tiles over before it gives
# a block several tiles: 8 blocks of 128 threads on each of 128 SMs
SPREAD_BLOCKS = 1024


def mm_plan(kind: str, m: int, copies: int = 1) -> dict:
    """The grid of a spread product kernel (kind "cuda", "tf32" or
    "bf16") for `copies` copies of an (m, K) x (K, 128) product: G's rows
    cut into `tiles` tiles of `tile_rows` (the last holding `last_rows`),
    M's columns into `halves`; each block takes a chunk of `per`
    consecutive tiles of one half of one copy, `chunks` chunks a half, so
    that the launch has at most SPREAD_BLOCKS blocks unless the copies
    alone need more (a chunk of every tile a copy: `blocks` = copies x
    halves)."""
    rows, halves = TILE_ROWS[kind], HALVES[kind]
    tiles = -(-m // rows)
    want = max(1, min(tiles, SPREAD_BLOCKS // (copies * halves)))
    per = -(-tiles // want)
    chunks = -(-tiles // per)
    return dict(tile_rows=rows, tiles=tiles, last_rows=m - (tiles - 1) * rows,
                halves=halves, per=per, chunks=chunks,
                blocks=copies * halves * chunks)


def _fold(s, steps):
    """Rows 0-7 of the step's product summed over steps in order, and the
    maximum of the other rows (-inf if none)."""
    acc = torch.zeros((ROWS, LANES), dtype=torch.float32, device=s.device)
    for _ in range(steps):
        acc = acc + s[0:ROWS]
    rest = s[ROWS:]
    mx = rest.amax(dim=0) if rest.shape[0] else torch.full(
        (LANES,), float("-inf"), device=s.device)
    return acc, mx


def mm_cuda_products(G, M):
    """The (m, 128) float32 products as #14 forms them, each an ordered
    10-term sum."""
    s = G[:, 0:1] * M[0:1]
    for k in range(1, N_COEF):
        s = s + G[:, k:k + 1] * M[k:k + 1]
    return s


def mm_cuda_ref(G, M, steps: int):
    """The float32 products as #14 forms them, each an ordered 10-term
    sum; returns (sum (8, 128), max of rows 8.. (128,))."""
    return _fold(mm_cuda_products(G, M), steps)


def _tc_depth(k: int) -> int:
    """The depth a tensor-core kernel pads K to: 16 (K <= 16) or 128."""
    kp = 16 if k <= 16 else k
    if kp not in (16, 128):
        raise ValueError(f"depth {k}: the tensor-core probes take K <= 16 "
                         f"or K = 128")
    return kp


def _padded(G, M):
    """G (m, K), M (K, 128) with K zero-padded to 16 (K <= 16) or kept
    (K = 128): the depths the tensor-core kernels take."""
    k = G.shape[1]
    kp = _tc_depth(k)
    if kp == k:
        return G.contiguous(), M.contiguous()
    gp = torch.zeros((G.shape[0], kp), dtype=G.dtype, device=G.device)
    mp = torch.zeros((kp, M.shape[1]), dtype=M.dtype, device=M.device)
    gp[:, :k] = G
    mp[:k] = M
    return gp, mp


def _tc_inputs(G, M, kind):
    """G and M as the tensor-core kernels take them: padded, rounded
    (the plain version's inputs; the kernels do this themselves)."""
    rnd = round_tf32 if kind == "tf32" else round_bf16
    return tuple(rnd(x) for x in _padded(G, M))


def mm_tc_products(G, M, kind: str):
    """The (m, 128) tensor-core products in plain PyTorch: the inputs
    rounded as the kernel takes them (TF32: to nearest, ties away; bf16:
    to nearest even), the exact products summed in float64 and rounded
    once."""
    gq, mq = _tc_inputs(G, M, kind)
    return (gq.double() @ mq.double()).float()


def mm_tc_ref(G, M, steps: int, kind: str):
    """`mm_tc_products` folded: (sum (8, 128), max of rows 8.. (128,))."""
    return _fold(mm_tc_products(G, M, kind), steps)


def _check_mm(G, M):
    m, k = G.shape
    if G.dtype != torch.float32 or M.dtype != torch.float32 or \
            tuple(M.shape) != (k, LANES):
        raise ValueError("G (m, K) and M (K, 128) float32")
    return m, k


def _tickets(device, n: int):
    """At least n zero tickets for a spread launch on the current stream
    of `device`. Two spread launches must not overlap on one buffer: a
    launch on another stream draws that stream's, and a CUDA graph that
    captures one must not replay beside another launch of the stream."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        with torch.cuda.device(device):
            t = torch.zeros(n, dtype=torch.int32, device=device)
        _TICKETS[key] = t
    return t


def _spread(kind, G, M, m, k, steps, blocks):
    """One launch of a spread product kernel: (sum (blocks, 8, 128), max
    (blocks, 128)); the partial maxima's scratch is empty memory, and
    only a launch of several chunks a copy draws tickets."""
    plan = mm_plan(kind, m, blocks)
    out = torch.empty((blocks, ROWS, LANES), dtype=torch.float32,
                      device=G.device)
    mx = torch.empty((blocks, LANES), dtype=torch.float32, device=G.device)
    several = plan["chunks"] > 1
    part = torch.empty((blocks, plan["chunks"], LANES) if several else (1,),
                       dtype=torch.float32, device=G.device)
    tickets = _tickets(G.device, blocks if several else 1)
    name = f"mm_{kind}"
    head = (_ptr(G), m, _ptr(M)) if kind == "cuda" else (_ptr(G), m, k,
                                                        _ptr(M))
    _launch(name, G.device, *head, steps, 0, blocks, plan["chunks"],
            plan["per"], _ptr(out), _ptr(mx), _ptr(part), _ptr(tickets),
            None if _RAN is None else _ptr(_RAN))
    LAUNCHES[name] += 1
    return out, mx


def blocks_ran(fn, device):
    """fn()'s result and the blocks that the spread products' launches in
    it ran on `device`, as the kernels count them: each block adds one to
    a device counter, which they are handed only inside this call."""
    global _RAN
    _RAN = torch.zeros(1, dtype=torch.int32, device=device)
    try:
        out = fn()
        return out, int(_RAN.item())
    finally:
        _RAN = None


def mm_cuda(G, M, steps: int, blocks: int = 1):
    """The products on the float32 pipes; K = 10. (sum (blocks, 8, 128),
    max (blocks, 128)); each of the `blocks` copies spread by
    mm_plan("cuda", m, blocks)."""
    m, k = _check_mm(G, M)
    if k != N_COEF or m < ROWS:
        raise ValueError(f"mm_cuda takes G (m >= 8, 10), got {(m, k)}")
    if not _on_card(G, M):
        return tuple(_copies(x, blocks) for x in mm_cuda_ref(G, M, steps))
    return _spread("cuda", G, M, m, k, steps, blocks)


def mm_tc(G, M, steps: int, kind: str, blocks: int = 1):
    """The products on the tensor cores, kind "tf32" or "bf16", float32
    accumulators; m a multiple of 16. (sum (blocks, 8, 128), max (blocks,
    128)); each of the `blocks` copies spread by mm_plan(kind, m,
    blocks): one launch of the spread wgmma kernel's instance of the
    kind, which pads and rounds G and M itself."""
    m, k = _check_mm(G, M)
    if m % 16:
        raise ValueError(f"m = {m} is not a multiple of 16")
    if kind not in ("tf32", "bf16"):
        raise ValueError(f"unknown tensor-core kind {kind!r}")
    if not _on_card(G, M):
        return tuple(_copies(x, blocks) for x in mm_tc_ref(G, M, steps, kind))
    _tc_depth(k)
    return _spread(kind, G, M, m, k, steps, blocks)


# ---------------------------------------------------------------------------
# Gathers
# ---------------------------------------------------------------------------

def gather_ref(table, idx):
    """table[idx], NaN where an index lies outside the table."""
    ok = (idx >= 0) & (idx < table.shape[0])
    val = table[torch.where(ok, idx, 0).long()]
    return torch.where(ok, val, float("nan"))


def _gather(name, table, idx):
    _need(table, torch.float32, (table.shape[0],), "table")
    _need(idx, torch.int32, (idx.shape[0],), "idx")
    if not _on_card(table, idx):
        return gather_ref(table, idx)
    out = torch.empty(idx.shape, dtype=torch.float32, device=idx.device)
    _launch(name, idx.device, _ptr(table), table.shape[0], _ptr(idx),
            idx.shape[0], _ptr(out))
    LAUNCHES[name] += 1
    return out


def gather_smem(table, idx):
    """The gather from the table staged in shared memory (up to 56,832
    floats)."""
    if table.shape[0] * 4 > 227 * 1024:
        raise ValueError(f"a {table.shape[0]}-entry table exceeds shared "
                         f"memory")
    return _gather("gather_smem", table, idx)


def gather_global(table, idx):
    """The gather from device memory."""
    return _gather("gather_global", table, idx)
