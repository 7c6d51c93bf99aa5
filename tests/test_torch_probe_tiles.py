"""The tile plan of the spread product probes (csrc/probes.cu `mm_cuda`,
`mm_tf32`, `mm_bf16`; ops/probes.py `mm_plan`) on the CPU, where no
kernel runs; and (at the end) the schedules of the item loops `grid`
(its fetch form on the bulk-copy ring, `grid_plan`) and `gate` (passes
of 16 items, folded in item order).

A copy's product is cut into tiles of G's rows; a block takes a chunk of
consecutive tiles of one column half of one copy; rows 0-7 of tile 0 add
into the step sums, every other real row feeds a per-chunk partial
maximum, and the partials fold into one (a maximum, in any order).
`_emulate` repeats that split in plain PyTorch, from the plan, and must
give the plain versions' results bit for bit: the step sums in the same
order, the maximum with a
ragged last tile's padded rows left out (rows whose products are all
negative, where a padded row's zero would win, show that).
"""
import numpy as np
import pytest
import torch

from mitsuba_tpu_torch.ops import probes as pr

M_CUDA = (8, 24, 512, 4096, 4104)
M_TF32 = (16, 48, 528, 4096)      # the tensor-core kinds' (m % 16 == 0)


def _inputs(m, k=10, seed=0, negative=False):
    rng = np.random.default_rng(seed + m + k)
    G = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    M = torch.from_numpy(rng.standard_normal((k, 128)).astype(np.float32))
    if negative:                # every product below zero
        G, M = -(G.abs() + 0.1), M.abs() + 0.1
    return G, M


def _emulate(kind, G, M, steps, copies, mask=True):
    """The kernels' split on the CPU: (sum (copies, 8, 128), max (copies,
    128)). mask=False lets a ragged tile's padded rows into the maximum,
    as a kernel that forgot them would."""
    plan = pr.mm_plan(kind, G.shape[0], copies)
    m, rows, tiles = G.shape[0], plan["tile_rows"], plan["tiles"]
    per, chunks, cols = plan["per"], plan["chunks"], 128 // plan["halves"]
    padded = G.new_zeros((tiles * rows, G.shape[1]))
    padded[:m] = G
    # each tile's products (its rows zero-padded), as a block computes them
    prods = [(pr.mm_cuda_products(tile, M) if kind == "cuda"
              else pr.mm_tc_products(tile, M, kind))
             for tile in padded.split(rows)]
    sums = torch.empty((copies, 8, 128))
    maxima = torch.empty((copies, 128))
    for copy in range(copies):
        part = torch.empty((chunks, 128))
        for half in range(plan["halves"]):
            cs = slice(half * cols, (half + 1) * cols)
            for chunk in range(chunks):
                mx = torch.full((cols,), float("-inf"))
                for t in range(chunk * per, min(tiles, (chunk + 1) * per)):
                    p = prods[t][:, cs]
                    real = min(rows, m - t * rows) if mask else rows
                    rest = p[8 if t == 0 else 0:real]
                    acc = torch.zeros((8, cols))
                    for _ in range(steps):
                        acc = acc + p[:8]
                        if rest.shape[0]:
                            mx = torch.fmax(mx, rest.amax(dim=0))
                    if t == 0:
                        sums[copy, :, cs] = acc
                part[chunk, cs] = mx
        acc = part[0]
        for chunk in range(1, chunks):
            acc = torch.fmax(acc, part[chunk])
        maxima[copy] = acc
    return sums, maxima


def _same(got, ref):
    for a, r in zip(got, ref):
        assert torch.equal(a, r.expand_as(a))


@pytest.mark.parametrize("kind,m,copies,blocks,tiles,last", [
    ("cuda", 4096, 1, 128, 128, 32),       # a tile a block over the card
    ("cuda", 512, 1, 16, 16, 32),
    ("cuda", 4104, 2, 258, 129, 8),        # a ragged last tile
    ("cuda", 8, 1, 1, 1, 8),
    ("cuda", 4096, 8192, 8192, 128, 32),   # a block a copy
    ("tf32", 4096, 1, 128, 64, 64),        # 64 tiles x 2 column halves
    ("tf32", 528, 2, 36, 9, 16),
    ("tf32", 4096, 8192, 16384, 64, 64),
    ("bf16", 4096, 1, 128, 64, 64),        # the tf32 plan, the same tiles
    ("bf16", 528, 2, 36, 9, 16),
    ("bf16", 512, 1, 16, 8, 64),
    ("bf16", 4096, 8192, 16384, 64, 64),
])
def test_mm_plan_grids(kind, m, copies, blocks, tiles, last):
    plan = pr.mm_plan(kind, m, copies)
    assert (plan["blocks"], plan["tiles"], plan["last_rows"]) == (
        blocks, tiles, last)
    assert plan["tile_rows"] == {"cuda": 32, "tf32": 64, "bf16": 64}[kind]
    assert plan["halves"] == {"cuda": 1, "tf32": 2, "bf16": 2}[kind]


@pytest.mark.parametrize("kind", ["cuda", "tf32", "bf16"])
@pytest.mark.parametrize("copies", [1, 2, 3, 7, 100, 513, 8192])
def test_mm_plan_covers_every_tile_once(kind, copies):
    """Every tile in exactly one chunk, no empty chunk; at most
    SPREAD_BLOCKS blocks unless the copies alone need more, and then a
    block a copy and half."""
    for m in (8, 16, 33, 512, 4096, 4104, 65536):
        plan = pr.mm_plan(kind, m, copies)
        t, per, chunks = plan["tiles"], plan["per"], plan["chunks"]
        assert t == -(-m // plan["tile_rows"])
        assert 1 <= plan["last_rows"] <= plan["tile_rows"]
        assert (chunks - 1) * per < t <= chunks * per
        assert plan["blocks"] == copies * plan["halves"] * chunks
        if copies * plan["halves"] <= pr.SPREAD_BLOCKS:
            assert plan["blocks"] <= pr.SPREAD_BLOCKS
        else:
            assert chunks == 1


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("m", M_CUDA)
def test_cuda_split_matches_plain_version(m, steps):
    G, M = _inputs(m)
    _same(_emulate("cuda", G, M, steps, 2), pr.mm_cuda_ref(G, M, steps))


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("m", M_TF32)
def test_tf32_split_matches_plain_version(m, steps):
    G, M = _inputs(m)
    _same(_emulate("tf32", G, M, steps, 2), pr.mm_tc_ref(G, M, steps,
                                                          "tf32"))


def test_tf32_split_at_depth_128():
    """The (512, 128) x (128, 128) form: 8 tiles of 16 k-steps."""
    G, M = _inputs(512, 128)
    _same(_emulate("tf32", G, M, 2, 1), pr.mm_tc_ref(G, M, 2, "tf32"))


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("m", M_TF32)
def test_bf16_split_matches_plain_version(m, steps):
    """mm_bf16, the bf16 instance of mm_tf32's kernel, on its plan: each
    tile's products from the inputs rounded to bf16 (to nearest even)."""
    G, M = _inputs(m)
    _same(_emulate("bf16", G, M, steps, 2), pr.mm_tc_ref(G, M, steps,
                                                          "bf16"))


def test_bf16_split_at_depth_128():
    """The (512, 128) x (128, 128) form in bf16: 8 tiles of 8 k16 steps."""
    G, M = _inputs(512, 128)
    _same(_emulate("bf16", G, M, 2, 1), pr.mm_tc_ref(G, M, 2, "bf16"))


@pytest.mark.parametrize("kind,m", [("cuda", 24), ("cuda", 4104),
                                    ("tf32", 48), ("tf32", 528),
                                    ("bf16", 48), ("bf16", 528)])
def test_padded_rows_stay_out_of_the_maximum(kind, m):
    """Rows whose products are all negative: the masked split gives the
    plain maximum (below zero), while one that let a ragged tile's padded
    rows in would report 0."""
    G, M = _inputs(m, negative=True)
    ref = (pr.mm_cuda_ref(G, M, 3) if kind == "cuda"
           else pr.mm_tc_ref(G, M, 3, kind))
    assert bool((ref[1] < 0).all())
    _same(_emulate(kind, G, M, 3, 2), ref)
    unmasked = _emulate(kind, G, M, 3, 1, mask=False)[1]
    assert bool((unmasked == 0).all())


# ---------------------------------------------------------------------------
# grid's ring and gate's passes
# ---------------------------------------------------------------------------

def _planted(shape, seed):
    """Standard normal float32 values, one in five scaled by 1e7: a sum
    taken in another order rounds otherwise."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    x[rng.random(shape) < 0.2] *= 1e7
    return torch.from_numpy(x.astype(np.float32))


def _listed(n, blocks, seed):
    """Drawn ids, the first repeated (one block in several slots), the
    last block among them."""
    ids = np.random.default_rng(seed).integers(0, blocks, n)
    if n > 3:
        ids[1:4] = ids[0]
    if n:
        ids[n // 2] = blocks - 1
    return torch.from_numpy(ids.astype(np.int32))


def _ring_plan(n, group):
    """grid_plan's ring at `group` 2 KB items a stage (the kernel's entry
    takes 1 .. RING_MAX_GROUP; grid_plan uses GRID_GROUP)."""
    stages = min(pr.RING_MAX_STAGES, pr.RING_BYTES // (2048 * group))
    groups = -(-n // group)
    return dict(group=group, stages=stages, groups=groups,
                last=n - (groups - 1) * group if groups else 0)


def _emulate_grid(tri, ids, group, order=None):
    """grid's ring on the CPU: group q (items q * group ...) copied into
    stage q % stages, then lane l of the consumer adds floats 4l .. 4l +
    3 of each staged item's row 0 to its four sums, in item order (or in
    the order `order` gives the items of a group)."""
    plan = _ring_plan(ids.shape[0], group)
    stages, n = plan["stages"], ids.shape[0]
    ring = torch.zeros((stages, group, 4, 128))
    acc = torch.zeros((32, 4))
    for q in range(plan["groups"]):
        first, st = q * group, q % stages
        m = min(group, n - first)
        ring[st, :m] = tri[ids[first:first + m].long()]
        for j in (order(m) if order else range(m)):
            acc = acc + ring[st, j, 0].view(32, 4)
    out = torch.zeros((8, 128))
    out[0] = acc.reshape(128)
    return out


def _emulate_gate(g, ids, flags, tree=False):
    """gate's schedule on the CPU: the list a chunk at a time (an id, or
    -1 for a closed gate), batches of GATE_PASSES passes of GATE_PASS
    items, thread t the ordered 16-term sum of row t % 8 of item t / 8,
    then the batch's open items added to acc in item order (tree: each
    pass's open items summed first, then the pass's sum added, as a fold
    across items would)."""
    n, batch = ids.shape[0], pr.GATE_PASS * pr.GATE_PASSES
    t = torch.arange(128)
    j, r = t // 8, t % 8
    acc = torch.zeros(8)
    for c0 in range(0, n, pr.GATE_CHUNK):
        cn = min(pr.GATE_CHUNK, n - c0)
        lst = torch.where(flags[c0:c0 + cn] > 0, ids[c0:c0 + cn], -1)
        for b0 in range(0, cn, batch):
            sums = torch.zeros(batch * 8)
            for p in range(pr.GATE_PASSES):
                k = b0 + p * pr.GATE_PASS + j
                idk = torch.where(k < cn, lst[k.clamp(max=cn - 1)], -1)
                row = torch.where((idk >= 0)[:, None],
                                  g[idk.clamp(min=0).long(), r], 0.0)
                s = row[:, 0]
                for c in range(1, 16):
                    s = s + row[:, c]
                sums[p * 128:(p + 1) * 128] = s
            sums = sums.view(batch, 8)
            m = min(batch, cn - b0)
            open_ = [k for k in range(m) if lst[b0 + k] >= 0]
            if not tree:
                for k in open_:
                    acc = acc + sums[k]
                continue
            for p0 in range(0, m, pr.GATE_PASS):
                part = [k for k in open_ if p0 <= k < p0 + pr.GATE_PASS]
                if part:
                    acc = acc + pr._sequential_sum(sums[part[1:]],
                                                   sums[part[0]])
    return acc[:, None].expand(8, 128)


GRID_N = (0, 1, 7, 8, 9, 31, 32, 33, 95, 96, 97, 512)
GATE_N = (0, 1, 15, 16, 17, 63, 64, 65, 511, 512, 513, 1100)


@pytest.mark.parametrize("group", [1, 2, 4, 8, 16, 32])
def test_grid_plan_fits_the_ring(group):
    """At G items a stage: G x stages x 2 KB within RING_BYTES, the
    stages within RING_MAX_STAGES, as many as fit; grid_plan is that
    ring at GRID_GROUP (32 items a stage, 3 stages)."""
    plan = _ring_plan(512, group)
    s = plan["stages"]
    assert 1 <= s <= pr.RING_MAX_STAGES and plan["group"] == group
    assert group * s * 2048 <= pr.RING_BYTES
    assert s == pr.RING_MAX_STAGES or group * (s + 1) * 2048 > pr.RING_BYTES
    assert 1 <= pr.GRID_GROUP <= pr.RING_MAX_GROUP
    assert pr.grid_plan(512) == _ring_plan(512, pr.GRID_GROUP)
    assert (pr.grid_plan(0)["group"], pr.grid_plan(0)["stages"]) == (32, 3)


@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 512])
def test_grid_plan_takes_every_item_once(n):
    """At n = 0, 1, G - 1, G, G + 1 and 512 (G = 32): the groups of
    consecutive items cover 0 .. n - 1 once each, the last holding
    `last`."""
    plan = pr.grid_plan(n)
    g = plan["group"]
    seen = [i for q in range(plan["groups"])
            for i in range(q * g, min(n, (q + 1) * g))]
    assert seen == list(range(n))
    assert plan["last"] == (n - (plan["groups"] - 1) * g if n else 0)
    assert 0 < plan["last"] <= g or n == 0


@pytest.mark.parametrize("group", [1, 8, 32])
@pytest.mark.parametrize("n", GRID_N)
def test_grid_ring_matches_plain_version(n, group):
    """The ring's groups (G - 1, G, G + 1 at G = 8 and 32), wrapping
    its stages (S G - 1, S G, S G + 1: 96 items at both), bit for bit
    with grid_ref on planted rows, ids repeated and the last block among
    them."""
    tri = _planted((64, 4, 128), n)
    ids = _listed(n, 64, n + 1)
    ref = pr.grid_ref(tri, ids, True)
    assert torch.equal(_emulate_grid(tri, ids, group), ref)
    assert torch.equal(pr.grid(tri, ids, True, blocks=2), ref.expand(2, 8,
                                                                     128))


def test_grid_ring_out_of_order_would_differ():
    """On the planted rows a group summed in reverse differs: the
    emulation's match above is the order's, not the data's."""
    tri, ids = _planted((64, 4, 128), 5), _listed(512, 64, 6)
    ref = pr.grid_ref(tri, ids, True)
    rev = _emulate_grid(tri, ids, pr.GRID_GROUP,
                        order=lambda m: reversed(range(m)))
    assert not torch.equal(rev, ref)


def _flags(form, n, seed):
    if form == "open":
        f = np.ones(n)
    elif form == "closed":
        f = np.zeros(n)
    elif form == "alternating":
        f = np.arange(n) % 2
    else:
        f = np.random.default_rng(seed).integers(-1, 2, n)
    return torch.from_numpy(f.astype(np.int32))


@pytest.mark.parametrize("form", ["open", "closed", "alternating", "drawn"])
@pytest.mark.parametrize("n", GATE_N)
def test_gate_passes_match_plain_version(n, form):
    """gate's passes, batches and chunks (n at each edge, past one chunk
    of 512), every gate open, closed, alternating or drawn (flags -1, 0,
    1), bit for bit with gate_ref on planted rows of a (B, 12, 16) g (a
    block's rows past the 8 summed), ids repeated and the last block
    among them."""
    g = _planted((64, 12, 16), n)
    ids, flags = _listed(n, 64, n + 2), _flags(form, n, n + 3)
    ref = pr.gate_ref(g, ids, flags)
    assert torch.equal(_emulate_gate(g, ids, flags), ref)
    if form == "closed" or n == 0:
        assert not ref.any()


def test_gate_tree_fold_would_differ():
    """A fold that sums each pass's items first differs on the planted
    rows: the fold across items must stay serial."""
    g = _planted((64, 12, 16), 8)
    ids, flags = _listed(512, 64, 9), _flags("drawn", 512, 10)
    ref = pr.gate_ref(g, ids, flags)
    assert torch.equal(_emulate_gate(g, ids, flags), ref)
    assert not torch.equal(_emulate_gate(g, ids, flags, tree=True), ref)
