"""Inputs that drive the refine kernels (#5 `refine`, #6 `child_refine`,
ops/exact.py) through the corner cases of their schedule, made by numpy
from a seed.

Each of the ROWS rows is a pattern of four 32-lane warps (ROW_WARPS):

  hit     lanes from around a cloud of random boxes toward it, mint 1e-4,
          maxt 1e30 or a few units (some miss every box);
  dead    maxt < mint (mint 1e-4, or 0 as a padded lane): the warp has no
          live lane;
  zero    origins inside BSTAR, a box around the whole scene; mint +0.0
          or -0.0 on most lanes, 1e-4 on the rest: BSTAR's key is a zero,
          tied between lanes of both signs within and across warps;
  neg     origins inside BSTAR, mint -0.25 on some lanes: negative keys;
  axis    a direction component exactly 0 and another below 1e-12 (the
          reciprocal is BIG on both), mint 1e-4;
  sparse  `hit` lanes, every other one dead at random.

Row 3 has a single live lane, row 10 none. Each row's live prefix is the
whole list (row 0), 0 (row 1), 1 (row 2) or a random count, and every id
past it is garbage: random 32-bit integers, most far outside the table,
which a kernel must not read. Within the prefix BSTAR (and, for #6, the
child that holds it) is listed at random positions. The child tables
hold junk (NaN and huge values) in every float but each child's six box
floats, which a kernel must not use.

Widths: #5 at E = 128 and 256 (S1 at the coherent and the other caps),
#6 at Ep = 16, 160 and 240 (S2: coherent, diffuse, XL), 32, 384 and 768
(S3 of the v5 walk at the same caps) and the all-L2 pass over a root
table of 33 parents (config 3's 263 L2 boxes), every row listing all.

Used by tests/test_torch_refine_schedule.py, tests/test_torch_cuda.py and
chip_smoke.py's kernel checks.
"""
from __future__ import annotations

import numpy as np
import torch

from mitsuba_tpu_torch.ops.rows import LANES, pack_rays

ROWS = 12
ROW_WARPS = (
    ("hit", "hit", "hit", "hit"),
    ("hit", "dead", "dead", "dead"),
    ("dead", "dead", "dead", "hit"),
    ("single", "single", "single", "single"),
    ("zero", "hit", "zero", "dead"),
    ("dead", "zero", "dead", "zero"),
    ("neg", "hit", "axis", "zero"),
    ("axis", "axis", "hit", "hit"),
    ("zero", "zero", "zero", "zero"),
    ("hit", "dead", "zero", "axis"),
    ("dead", "dead", "dead", "dead"),
    ("sparse", "sparse", "sparse", "sparse"),
)
SINGLE_LANE = 77
N_BOXES = 400
BSTAR = N_BOXES                       # the last box of the #5 table
STAR_HALF = 8.0
REFINE_WIDTHS = (128, 256)
CHILD_WIDTHS = (16, 160, 240, 32, 384, 768)
ROOT_PARENTS = 33
N_PARENTS = 120
STAR_CHILD = (7, 3)                   # (parent, child) holding BSTAR


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def case_rays(seed: int = 0):
    """Packed rays (ROWS, 8, 128) on the host, warps by ROW_WARPS."""
    rng = np.random.default_rng(seed)
    n = ROWS * LANES
    o = rng.uniform(-4, 4, (n, 3))
    d = _unit(rng.uniform(-2, 2, (n, 3)) - o)
    mint = np.full(n, 1e-4)
    maxt = np.where(rng.random(n) < 0.8, 1e30, rng.uniform(0.5, 4.0, n))
    for r, kinds in enumerate(ROW_WARPS):
        for w, kind in enumerate(kinds):
            ln = slice(r * LANES + 32 * w, r * LANES + 32 * w + 32)
            if kind == "dead":
                mint[ln] = np.where(rng.random(32) < 0.5, 0.0, 1e-4)
                maxt[ln] = -1.0
            elif kind in ("zero", "neg"):
                o[ln] = rng.uniform(-1.5, 1.5, (32, 3))
                d[ln] = _unit(rng.normal(size=(32, 3)))
                if kind == "zero":
                    pick = rng.random(32)
                    mint[ln] = np.where(pick < 0.35, -0.0,
                                        np.where(pick < 0.7, 0.0, 1e-4))
                else:
                    mint[ln] = np.where(rng.random(32) < 0.4, -0.25, 1e-4)
                maxt[ln] = 1e30
            elif kind == "axis":
                a = rng.integers(0, 3, 32)
                b = (a + 1 + rng.integers(0, 2, 32)) % 3
                dd = d[ln].copy()
                dd[np.arange(32), a] = 0.0
                dd = _unit(dd)
                dd[np.arange(32), b] = rng.choice([5e-13, -5e-13, 0.0], 32)
                d[ln] = dd
            elif kind == "sparse":
                maxt[ln] = np.where(rng.random(32) < 0.5, -1.0, maxt[ln])
        if kinds[0] == "single":
            row = slice(r * LANES, (r + 1) * LANES)
            maxt[row] = -1.0
            maxt[r * LANES + SINGLE_LANE] = 1e30
    return pack_rays(*[torch.from_numpy(np.ascontiguousarray(x, np.float32))
                       for x in (o, d, mint, maxt)])[0]


def _boxes(rng, n):
    """n random boxes (lo, hi), each (n, 3): centres in [-2, 2]^3, half
    sizes 0.05-0.6, every 20th flat in one axis."""
    c = rng.uniform(-2, 2, (n, 3))
    h = rng.uniform(0.05, 0.6, (n, 3))
    h[::20, 0] = 0.0
    return (c - h).astype(np.float32), (c + h).astype(np.float32)


def _lists(rng, width, table, star_ids):
    """(ids (ROWS, width), live (ROWS,)) int32: row 0 full, row 1 empty,
    row 2 one entry, else a random live count; ids in [0, table) within
    the prefix, star_ids at random positions, garbage past it."""
    live = rng.integers(2, width + 1, ROWS)
    live[0], live[1], live[2] = width, 0, 1
    ids = rng.integers(-2 ** 31, 2 ** 31 - 1, (ROWS, width), dtype=np.int64)
    for r in range(ROWS):
        n = live[r]
        ids[r, :n] = rng.integers(0, table, n)
        k = max(1, n // 37) if n else 0
        ids[r, rng.choice(n, size=min(k, n), replace=False)] = \
            rng.choice(star_ids, size=min(k, n))
    return ids.astype(np.int32), live.astype(np.int32)


def _t(x, device):
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def refine_case(width: int, seed: int = 0, device="cpu"):
    """(rays, ids, live, blo, bhi) of #5 at list width `width`."""
    rng = np.random.default_rng(seed + 1)
    lo, hi = _boxes(rng, N_BOXES)
    lo = np.concatenate([lo, np.full((1, 3), -STAR_HALF, np.float32)])
    hi = np.concatenate([hi, np.full((1, 3), STAR_HALF, np.float32)])
    ids, live = _lists(rng, width, N_BOXES + 1, [BSTAR])
    return (case_rays(seed).to(device), _t(ids, device), _t(live, device),
            _t(lo, device), _t(hi, device))


def child_table(rng, n_parents):
    """(n_parents, 8, 128) child table: lanes 0:3 lo, 3:6 hi, junk in the
    rest; STAR_CHILD holds BSTAR."""
    tab = rng.uniform(-1e30, 1e30, (n_parents, 8, LANES)).astype(np.float32)
    tab[:, :, 6::3] = np.nan
    lo, hi = _boxes(rng, n_parents * 8)
    tab[:, :, 0:3] = lo.reshape(n_parents, 8, 3)
    tab[:, :, 3:6] = hi.reshape(n_parents, 8, 3)
    p, c = STAR_CHILD
    if p < n_parents:
        tab[p, c, 0:3], tab[p, c, 3:6] = -STAR_HALF, STAR_HALF
    return tab


def child_case(width: int, seed: int = 0, device="cpu"):
    """(rays, pids, live_p, tab) of #6 at parent list width `width`."""
    rng = np.random.default_rng(seed + 2)
    tab = child_table(rng, N_PARENTS)
    pids, live = _lists(rng, width, N_PARENTS, [STAR_CHILD[0]])
    return (case_rays(seed).to(device), _t(pids, device), _t(live, device),
            _t(tab, device))


def root_case(seed: int = 0, device="cpu"):
    """(rays, pids, live_p, tab) of the all-L2 pass: every row lists the
    ROOT_PARENTS parents of a root table, all live."""
    rng = np.random.default_rng(seed + 3)
    tab = child_table(rng, ROOT_PARENTS)
    pids = np.broadcast_to(np.arange(ROOT_PARENTS, dtype=np.int32),
                           (ROWS, ROOT_PARENTS))
    live = np.full(ROWS, ROOT_PARENTS, np.int32)
    return (case_rays(seed).to(device), _t(pids, device), _t(live, device),
            _t(tab, device))


CASE_NAMES = tuple([f"refine E {w}" for w in REFINE_WIDTHS]
                   + [f"child Ep {w}" for w in CHILD_WIDTHS] + ["child root"])


def case(name: str, seed: int = 0, device="cpu"):
    """(kernel, args) of the case `name` (one of CASE_NAMES): kernel is
    'refine' or 'child_refine'."""
    if name.startswith("refine E "):
        return "refine", refine_case(int(name.split()[-1]), seed, device)
    if name == "child root":
        return "child_refine", root_case(seed, device)
    return "child_refine", child_case(int(name.split()[-1]), seed, device)


def cases(seed: int = 0, device="cpu"):
    """{name: (kernel, args)} of every case."""
    return {name: case(name, seed, device) for name in CASE_NAMES}
