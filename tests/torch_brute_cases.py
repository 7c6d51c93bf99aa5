"""Inputs that drive the shaded brute kernels (#1 `shaded_any_kernel<true>`,
#2 `shaded_any_kernel<false>`, csrc/intersect_brute.cu) through the
corner cases of their schedule, made by numpy from a seed.

A case is a (T, 29) shading table and two sets of N rays, the bounce rays
(o, d, mint, maxt) and the shadow rays (so, sd, smint, smaxt): #1 takes
both, #2 the bounce rays alone. N = 32 * len(warps) - 19, so the last
warp holds 13 lanes (a ragged last block). Each 32-lane warp follows a
pattern:

  hit     from below the cloud of random triangles toward it; bounce
          maxt inf or a few units, shadow maxt a few units;
  dead    maxt < mint, maxt == mint, or mint = maxt = 0 (padded lanes);
  single  one live `hit` lane, the others dead;
  sparse  `hit` lanes, about half of them dead at random;
  first   toward row 0 (the FIRST occluder when T >= 16);
  last    toward row T - 1 (the LAST occluder when T >= 16);
  tie     toward rows 8 and 10, which rows 9 and T - 2 duplicate exactly
          (so equal t; the lower index must win), when T >= 16;
  det     straight up through slivers whose |det| is 1e-9 in float32
          or one or two ulps either side of it, of both signs (rows
          1-6), when T >= 16: a ray hits exactly where |det| > 1e-9;
  zero    axis directions (0, 0, +-1) with +0.0 and -0.0 components,
          from below and from above the cloud;
  still   `hit` lanes, about half of them with a zero direction (+0.0
          and -0.0 components) and mint < maxt, as the fog path's NEE
          rays of ended paths: det is 0 for every row, so they never hit
          (#3's compaction drops them; the other kernels test them).

Below T = 16 the special rows do not exist: `tie` and `det` lanes are
`hit` lanes and `first` and `last` aim at rows 0 and T - 1 of the cloud.
Whole 128-lane tiles are dead in BOUNCE_WARPS, and differently in
SHADOW_WARPS, so a lane's bounce and shadow rays differ in liveness;
warps 32-47 leave a whole block of 256 or 512 lanes with no live bounce
lane, and their shadow lanes all aim at row 0 (`first`), so warps of
compacted live lanes are all occluded by the first row; the ragged last
warp starts a block of its own.

Cases: T = 1, 32, 64, 65 and 300 under those patterns; `shadow_dead`,
every shadow lane dead as in a render's first launch of #1
(`Ray.make(..., maxt=-1.0)`); `warps_dead`, nearly every warp dead and
single live lanes; `still_dirs`, every third warp `still`.

Used by tests/test_torch_brute_schedule.py, tests/test_torch_cuda.py and
chip_smoke.py's kernel checks.
"""
from __future__ import annotations

import numpy as np
import torch

SHD_COLS = 29
BOUNCE_WARPS = (
    "hit", "dead", "single", "sparse",
    "first", "last", "tie", "det",
    "dead", "dead", "dead", "dead",
    "zero", "hit", "sparse", "single",
    "tie", "det", "zero", "first",
    "hit", "last", "dead", "sparse",
) + (
    "hit", "first", "sparse", "single", "tie", "det", "zero", "hit",
) + ("dead",) * 16 + ("hit",)
SHADOW_WARPS = (
    "first", "last", "hit", "sparse",
    "dead", "dead", "dead", "dead",
    "hit", "single", "first", "last",
    "zero", "tie", "det", "dead",
    "sparse", "hit", "single", "zero",
    "last", "first", "hit", "dead",
) + (
    "sparse", "hit", "dead", "last", "single", "zero", "first", "hit",
) + ("first",) * 16 + ("sparse",)
RAGGED = 19                     # lanes missing from the last warp
SPECIAL_MIN_T = 16              # tables this large hold the special rows
DET_ROWS = range(1, 7)
TIE_ROWS = ((8, 9), (10, -2))   # (row, its duplicate); -2 is row T - 2
WIDTHS = (1, 32, 64, 65, 300)


def _f32(x):
    return np.float32(x)


def det_values():
    """|det| of the sliver rows 1-6: 1e-9 in float32 and its neighbours
    (one ulp below, one and two above), then -1e-9 and one ulp beyond."""
    e = _f32(1e-9)
    up = np.nextafter(e, _f32(1))
    return np.array([np.nextafter(e, _f32(0)), e, up,
                     np.nextafter(up, _f32(1)), -e, -up], np.float32)


def _tri_rows(v):
    """(T, 3, 3) corners -> the (T, 9) v0 | e1 | e2 columns."""
    return np.concatenate([v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]],
                          axis=1)


def make_table(n_tris, seed=0):
    """A (T, 29) shading table: a cloud of random triangles at z in
    [0, 2] over [-1, 1]^2; from T >= 16 the special rows (FIRST at row 0,
    the det slivers, the duplicated tie rows, LAST at row T - 1), each
    over its own patch of the plane z = 5, away from the cloud."""
    rng = np.random.default_rng(seed)
    v = rng.uniform(-1, 1, (n_tris, 3, 3)).astype(np.float32)
    v[:, :, 2] += np.linspace(0, 2, n_tris, dtype=np.float32)[:, None]
    tri = _tri_rows(v)
    if n_tris >= SPECIAL_MIN_T:
        def big(y):
            return _tri_rows(np.array(
                [[[-2, y - 2, 5], [2, y - 2, 5], [0, y + 2, 5]]],
                np.float32))[0]
        tri[0] = big(10.0)
        tri[-1] = big(20.0)
        for r, a in zip(DET_ROWS, det_values()):
            # v0 = (0, y, 5), e1 = (-a, 0, 0), e2 = (0, 1, 0): for the
            # ray d = (0, 0, 1) det = a exactly
            tri[r] = [0, 30 + 2 * r, 5, -a, 0, 0, 0, 1, 0]
        for k, (r, dup) in enumerate(TIE_ROWS):
            tri[r] = big(50.0 + 10 * k)
            tri[dup] = tri[r]
    table = np.zeros((n_tris, SHD_COLS), np.float32)
    table[:, 0:9] = tri
    table[:, 9:18] = rng.normal(size=(n_tris, 9))
    table[:, 18:24] = rng.uniform(0, 1, (n_tris, 6))
    table[:, 24] = np.arange(n_tris) % 5
    table[:, 25] = np.where(np.arange(n_tris) % 7 == 0, 0, -1)
    table[:, 26] = np.arange(n_tris)
    for r, dup in TIE_ROWS if n_tris >= SPECIAL_MIN_T else ():
        table[dup, 9:24] = table[r, 9:24]
    return table


def _centroid(table, row):
    t = table[row]
    return t[0:3] + (t[3:6] + t[6:9]) / 3.0


def make_rays(table, kinds, shadow, seed):
    """N rays by 32-lane warp patterns `kinds` against `table`: (o, d,
    mint, maxt) as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    n_tris = table.shape[0]
    special = n_tris >= SPECIAL_MIN_T
    n = 32 * len(kinds) - RAGGED
    o = np.zeros((32 * len(kinds), 3), np.float32)
    d = np.zeros_like(o)
    mint = np.full(o.shape[0], 1e-4, np.float32)
    maxt = np.full(o.shape[0], np.inf, np.float32)
    dets = det_values()

    def aim(lanes, target, jitter):
        src = target + rng.normal(scale=jitter, size=(len(lanes), 3))
        src[:, 2] = -3.0
        dst = target + rng.normal(scale=jitter, size=(len(lanes), 3))
        dst[:, 2] = target[2]
        dd = dst - src
        o[lanes] = src
        d[lanes] = dd / np.linalg.norm(dd, axis=-1, keepdims=True)

    def hit(lanes):
        src = rng.uniform(-1, 1, (len(lanes), 3))
        src[:, 2] -= 3.0
        dst = rng.uniform(-1, 1, (len(lanes), 3))
        dst[:, 2] += 1.0
        dd = dst - src
        o[lanes] = src
        d[lanes] = dd / np.linalg.norm(dd, axis=-1, keepdims=True)
        if shadow:
            maxt[lanes] = rng.uniform(1.0, 8.0, len(lanes))
        else:
            maxt[lanes] = np.where(rng.random(len(lanes)) < 0.7, np.inf,
                                   rng.uniform(1.0, 8.0, len(lanes)))

    def dead(lanes):
        hit(lanes)
        k = rng.integers(0, 3, len(lanes))
        maxt[lanes] = np.where(k == 0, -1.0, mint[lanes])
        zero = lanes[k == 2]
        mint[zero] = 0.0
        maxt[zero] = 0.0

    for w, kind in enumerate(kinds):
        lanes = np.arange(32 * w, 32 * w + 32)
        if not special and kind in ("tie", "det"):
            kind = "hit"
        if kind == "hit":
            hit(lanes)
        elif kind == "dead":
            dead(lanes)
        elif kind == "single":
            dead(lanes)
            keep = lanes[rng.integers(0, 32):][:1]
            hit(keep)
        elif kind == "sparse":
            hit(lanes)
            dead(lanes[rng.random(32) < 0.5])
        elif kind in ("first", "last"):
            aim(lanes, _centroid(table, 0 if kind == "first" else -1),
                0.3 if special else 0.02)
        elif kind == "tie":
            for k, (r, _dup) in enumerate(TIE_ROWS):
                aim(lanes[lanes % 2 == k], _centroid(table, r), 0.3)
        elif kind == "det":
            r = np.array(DET_ROWS)[lanes % len(DET_ROWS)]
            a = dets[lanes % len(DET_ROWS)]
            # x = -a / 4 on the sliver (u = v = 1/4, t = 5)
            o[lanes, 0] = -a / np.float32(4)
            o[lanes, 1] = (30 + 2 * r).astype(np.float32) + np.float32(0.25)
            o[lanes, 2] = 0.0
            d[lanes] = (0.0, 0.0, 1.0)
        elif kind == "still":
            hit(lanes)
            still = lanes[rng.random(32) < 0.5]
            d[still] = np.where(rng.random((len(still), 3)) < 0.5, 0.0,
                                -0.0)
        elif kind == "zero":
            hit(lanes)
            src = rng.uniform(-1, 1, (32, 3)).astype(np.float32)
            down = lanes % 2 == 1
            src[:, 2] = np.where(down, 5.0, -3.0)
            o[lanes] = src
            sx = np.where(lanes % 4 < 2, 0.0, -0.0)
            sy = np.where(lanes % 8 < 4, -0.0, 0.0)
            d[lanes, 0] = sx
            d[lanes, 1] = sy
            d[lanes, 2] = np.where(down, -1.0, 1.0)
        else:
            raise ValueError(kind)
        if shadow and kind in ("first", "last", "tie", "det", "zero"):
            maxt[lanes] = np.float32(30.0)
    return tuple(np.ascontiguousarray(x[:n]).astype(np.float32)
                 for x in (o, d, mint, maxt))


def case_arrays(n_tris, bounce=BOUNCE_WARPS, shadow=SHADOW_WARPS, seed=0):
    """(table, o, d, mint, maxt, so, sd, smint, smaxt), numpy."""
    table = make_table(n_tris, seed)
    return (table, *make_rays(table, bounce, False, seed * 10 + 1),
            *make_rays(table, shadow, True, seed * 10 + 2))


def case_specs():
    """{name: (T, bounce warps, shadow warps)}."""
    specs = {f"T{t}": (t, BOUNCE_WARPS, SHADOW_WARPS) for t in WIDTHS}
    specs["shadow_dead"] = (32, BOUNCE_WARPS, ("dead",) * len(BOUNCE_WARPS))
    sparse = tuple("single" if w % 5 == 2 else "dead"
                   for w in range(len(BOUNCE_WARPS)))
    specs["warps_dead"] = (32, sparse, sparse[::-1])
    specs["still_dirs"] = tuple(
        (32, *(tuple("still" if w % 3 == k else kind
                     for w, kind in enumerate(warps))
               for k, warps in ((0, BOUNCE_WARPS), (1, SHADOW_WARPS)))))
    return specs


def cases(seed=0, device="cpu"):
    """{name: the nine arguments of #1 as float32 tensors on device}."""
    out = {}
    for name, (t, bounce, shadow) in case_specs().items():
        arrays = case_arrays(t, bounce, shadow, seed)
        out[name] = tuple(torch.from_numpy(x).to(device) for x in arrays)
    return out
