"""The tile plan of the spread product probes (csrc/probes.cu `mm_cuda`,
`mm_tf32`, `mm_bf16`; ops/probes.py `mm_plan`) on the CPU, where no
kernel runs.

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
