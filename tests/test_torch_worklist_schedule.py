"""The schedule of the work-list kernel (#12, csrc/worklist.cu
`worklist_kernel`), emulated here in plain PyTorch, against the unchanged
plain version `wl_rows_ref`, exactly.

The kernel runs a row's items in list order as the plain version does,
but skips work that cannot change a record; on the CPU the wrapper runs
the plain version, so this emulation stands for the kernel's order:

* a row none of whose lanes can change walks nothing (closest: no lane
  with mint < maxt or maxt above the miss sentinel; any hit: no lane with
  mint < maxt);
* the row's slots are compacted to its valid items, in list order;
* closest: the block-wide OR of the slab tests against each lane's best
  t decides whether an item is tested; a warp none of whose lanes has
  mint < best t, or best t above the sentinel, skips the item's tests;
  the tests run two chunks of a sublane at a time, each chunk parity
  keeping its running minimum (strict <), the odd one winning only when
  strictly nearer, the lowest chunk * 8 + sublane among equal t, and a
  strict t < best t across items;
* any hit: before each item the row stops once every lane is occluded or
  has mint >= maxt; a warp none of whose lanes can still hit skips the
  item, and stops, every 8 triangles, once each of its lanes has hit or
  cannot.

The probe (#13, `worklist_kernel<false, false, true>`) is the same walk
with the tests left out, emulated by `probe_schedule`: the row's slots
read 512 a window, the valid ones compacted in list order, and per item,
with no vote and no stop, acc = (acc + pass) + the block's first float,
pass the lane's slab test against [mint, maxt]; a row with no valid item
reads 0. It is held to `wl_probe_ref` bit for bit, and on a few rows to
the reference's probe kernel in interpret mode (equal, as
tests/test_torch_probes.py holds the plain version).

The inputs are tests/torch_instanced_cases.py's (numpy, fixed seed): rows
with dead, occluded and sentinel warps, a dead row, a row of 540 slots,
planted exact ties within a block and across items, flat and instanced,
at K = 32 and K = 8. The emulation counts the events it must have met,
so a case that stops exercising the schedule fails.
torch.set_num_threads(1); each case takes under 5 s.
"""
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_instanced_cases as ic
from mitsuba_tpu.ops import worklist_pallas as jwp
from mitsuba_tpu.render import intersect as jri
from mitsuba_tpu_torch.ops import stream as sp
from mitsuba_tpu_torch.ops import worklist as wl
from mitsuba_tpu_torch.ops.rows import BIG, LANES, pack_rays
from mitsuba_tpu_torch.render import intersect as ri
from test_torch_bvh import _meshes
from test_torch_worklist import _reached_rows

torch.set_num_threads(1)
WARPS = LANES // 32
PSEL_NONE = 1 << 30
WIN = 512                     # slots a window (csrc/worklist.cu)


def _object_rays(ow, dw, xf):
    """The lanes' rays under a (16,) world->object map, in the kernel's
    operation order."""
    m = [xf[j] for j in range(12)]
    o = [m[4 * r] * ow[0] + m[4 * r + 1] * ow[1] + m[4 * r + 2] * ow[2]
         + m[4 * r + 3] for r in range(3)]
    d = [m[4 * r] * dw[0] + m[4 * r + 1] * dw[1] + m[4 * r + 2] * dw[2]
         for r in range(3)]
    return o, d


def _tests(blk, o, d, mnb, cap):
    """(t, u, v, ok) of every triangle of blk (K, 16) for the row's
    lanes, each (K, 128)."""
    t, u, v, ok = sp.mt(blk[None], [x[None, None] for x in o],
                        [x[None, None] for x in d], mnb[None, None],
                        cap[None, None])
    return t[0], u[0], v[0], ok[0]


def _visit_warp(t, u, v, ok, sl, n_chunks, seen):
    """One warp's merge of an item's tests, two chunks at a time: (t, u,
    v, candidate) per lane, t = BIG where nothing passed."""
    bt = torch.full((32,), BIG)
    bu = torch.zeros(32)
    bv = torch.zeros(32)
    bp = torch.full((32,), PSEL_NONE, dtype=torch.int64)
    for s in range(8):
        runs = [[torch.full((32,), BIG), torch.zeros(32), torch.zeros(32),
                 torch.zeros(32, dtype=torch.int64)] for _ in range(2)]
        for j in range(0, n_chunks, 2):
            for jj in (j, j + 1):
                if jj >= n_chunks:
                    continue
                k = jj * 8 + s
                r = runs[jj % 2]
                take = ok[k, sl] & (t[k, sl] < r[0])
                seen["chunk_ties"] += int((ok[k, sl] & (t[k, sl] == r[0])
                                           ).sum())
                r[0] = torch.where(take, t[k, sl], r[0])
                r[1] = torch.where(take, u[k, sl], r[1])
                r[2] = torch.where(take, v[k, sl], r[2])
                r[3] = torch.where(take, jj, r[3])
        sel = runs[1][0] < runs[0][0]
        seen["parity_ties"] += int(((runs[1][0] == runs[0][0])
                                    & (runs[0][0] < BIG)).sum())
        rt, ru, rv, rj = (torch.where(sel, a, b)
                          for a, b in zip(runs[1], runs[0]))
        pc = rj * 8 + s
        seen["sublane_ties"] += int(((rt == bt) & (rt < BIG)).sum())
        upd = (rt < bt) | ((rt == bt) & (pc < bp))
        bt = torch.where(upd, rt, bt)
        bu = torch.where(upd, ru, bu)
        bv = torch.where(upd, rv, bv)
        bp = torch.where(upd, pc, bp)
    return bt, bu, bv, bp


def wl_schedule(items, seg, tri, tri_start, rays, block_id, xform, any_hit,
                seen):
    """#12's order, row by row (module docstring): the kernel's (t, u, v,
    prim) or occlusion, as wl_rows_ref returns them. seen: counts of the
    skipped rows and warps, stopped rows and warps, and ties met."""
    n_rows = rays.shape[0]
    n_chunks = tri.shape[1] // 8
    out_t, out_u, out_v, out_p, out_o = [], [], [], [], []
    for r in range(n_rows):
        ry = rays[r]
        ow = [ry[j] for j in range(3)]
        dw = [ry[3 + j] for j in range(3)]
        mnb, mx = ry[6], ry[7]
        tb, ub, vb = mx.clone(), torch.zeros(LANES), torch.zeros(LANES)
        pb = torch.full((LANES,), -1, dtype=torch.int64)
        occ = torch.zeros(LANES, dtype=torch.bool)
        able = (mnb < mx) if any_hit else (mnb < mx) | (BIG < mx)
        run = items[int(seg[r]):int(seg[r + 1])].long()
        cids = (run[(run & ic.VALID_BIT) != 0] & (ic.FIRST_BIT - 1)).tolist()
        if not bool(able.any()):
            seen["rows_skipped"] += 1
            cids = []
        for cid in cids:
            blk = tri[int(block_id[cid]) if block_id is not None else cid]
            o, d = (_object_rays(ow, dw, xform[cid]) if xform is not None
                    else (ow, dw))
            if any_hit:
                if bool((occ | ~(mnb < mx)).all()):
                    seen["rows_stopped"] += 1
                    break
                can = ~occ & (mnb < mx)
                _t, _u, _v, ok = _tests(blk, o, d, mnb, mx)
                for w in range(WARPS):
                    sl = slice(32 * w, 32 * w + 32)
                    if not bool(can[sl].any()):
                        seen["warps_skipped"] += 1
                        continue
                    hit = torch.zeros(32, dtype=torch.bool)
                    for k in range(0, blk.shape[0], 8):
                        if bool((hit | ~can[sl]).all()):
                            seen["warps_stopped"] += 1
                            break
                        for j in range(0, 8, 2):
                            hit = hit | ok[k + j, sl] | ok[k + j + 1, sl]
                    occ[sl] = occ[sl] | hit
                continue
            if not bool(sp.slab(blk[None, 0, 9:15], [x[None] for x in o],
                                [x[None] for x in d], mnb[None],
                                tb[None]).any()):
                continue
            t, u, v, ok = _tests(blk, o, d, mnb, tb)
            # ties across items: a test at the lane's best t, which the
            # strict cap t < best t turns away
            _t, _u, _v, ok_any = _tests(blk, o, d, mnb,
                                        torch.full_like(tb, float("inf")))
            seen["item_ties"] += int((ok_any & (t == tb) & (tb < BIG)).sum())
            can = (mnb < tb) | (BIG < tb)
            for w in range(WARPS):
                sl = slice(32 * w, 32 * w + 32)
                if not bool(can[sl].any()):
                    seen["warps_skipped"] += 1
                    continue
                bt, bu, bv, bp = _visit_warp(t, u, v, ok, sl, n_chunks, seen)
                imp = bt < tb[sl]
                tb[sl] = torch.where(imp, bt, tb[sl])
                ub[sl] = torch.where(imp, bu, ub[sl])
                vb[sl] = torch.where(imp, bv, vb[sl])
                pb[sl] = torch.where(imp, int(tri_start[cid]) + bp, pb[sl])
        out_t.append(tb)
        out_u.append(ub)
        out_v.append(vb)
        out_p.append(pb.to(torch.int32))
        out_o.append(occ)
    if any_hit:
        return torch.stack(out_o)
    return (torch.stack(out_t), torch.stack(out_u), torch.stack(out_v),
            torch.stack(out_p))


def _seen():
    return dict(rows_skipped=0, rows_stopped=0, warps_skipped=0,
                warps_stopped=0, chunk_ties=0, parity_ties=0,
                sublane_ties=0, item_ties=0)


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("k", [32, 8])
@pytest.mark.parametrize("instanced", [False, True])
def test_worklist_schedule_gives_the_plain_walk(instanced, k, any_hit):
    items, seg, tri, ts, rays, bid, xf, _total, _full = ic.wl_case(
        instanced, k)
    seen = _seen()
    got = wl_schedule(items, seg, tri, ts, rays, bid, xf, any_hit, seen)
    ref = wl.wl_rows_ref(items, seg, tri, ts, rays, bid, xf, any_hit)
    if any_hit:
        assert torch.equal(got, ref) and 0 < int(ref.sum()) < ref.numel()
        assert seen["rows_stopped"] > 0
        if k == 32:                 # a warp stops between 8-test groups
            assert seen["warps_stopped"] > 0
    else:
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
        assert seen["item_ties"] > 0 and seen["sublane_ties"] > 0
        if k == 32:
            assert seen["parity_ties"] > 0 or seen["chunk_ties"] > 0
        # warp 3 of row 0 takes the miss sentinel (mint = maxt = inf)
        assert bool((ref[0][0, 96:] == BIG).all())
    assert seen["rows_skipped"] == 1 and seen["warps_skipped"] > 0


def probe_schedule(items, seg, tri, rays, seen):
    """#13's order, row by row (module docstring): (R, 128) float32 as
    wl_probe_ref returns it. seen: windows read, invalid slots dropped by
    the compaction, items walked, rows with no valid item."""
    out = []
    for r in range(rays.shape[0]):
        ry = rays[r]
        o = [ry[j][None] for j in range(3)]
        d = [ry[3 + j][None] for j in range(3)]
        acc = torch.zeros(LANES)
        lo, hi = int(seg[r]), int(seg[r + 1])
        walked = 0
        for base in range(lo, hi, WIN):
            run = items[base:min(hi, base + WIN)].long()
            valid = (run & ic.VALID_BIT) != 0
            seen["windows"] += 1
            seen["dropped"] += int((~valid).sum())
            for cid in (run[valid] & (ic.FIRST_BIT - 1)).tolist():
                blk = tri[cid]
                ok = sp.slab(blk[None, 0, 9:15], o, d, ry[6][None],
                             ry[7][None])[0]
                acc = (acc + ok.to(torch.float32)) + blk[0, 0]
                walked += 1
        seen["items"] += walked
        seen["rows_empty"] += walked == 0
        out.append(acc)
    return torch.stack(out)


@pytest.mark.parametrize("list_end", ["tail", "overflow"])
@pytest.mark.parametrize("k", [32, 8])
def test_probe_schedule_gives_the_plain_probe(k, list_end):
    """The flat cases: a dead row (it still sums the blocks' first
    floats), a row with no valid item, a 540-slot row (two windows) with
    an invalid slot, the list's unused tail, untrimmed too."""
    items, seg, tri, _ts, rays, _bid, _xf, _total, full = ic.wl_case(
        False, k, list_end)
    seen = Counter()
    got = probe_schedule(items, seg, tri, rays, seen)
    ref = wl.wl_probe_ref(items, seg, tri, rays)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    assert torch.equal(probe_schedule(items, full, tri, rays, Counter()),
                       ref)
    assert seen["rows_empty"] == 1 and bool((ref[4] == 0).all())
    assert seen["windows"] > ic.ROWS and seen["dropped"] >= 1
    assert bool((ref[2] != 0).all())        # the dead row
    assert torch.unique(ref).numel() > 5


def test_probe_schedule_matches_tpu_kernel():
    """Three rows of tests/test_torch_probes.py's flat scene and rays,
    through the port's list build and the emulated walk, and through the
    JAX package's probe in interpret mode: equal on the rows its list
    reaches."""
    jg = jri.build_geometry(_meshes(), backend="cluster")
    tg = ri.build_geometry(_meshes(), backend="cluster")
    lo, hi = np.asarray(jg.bvh_min[0]), np.asarray(jg.bvh_max[0])
    mid = 0.5 * (lo + hi)
    rng = np.random.default_rng(11)
    n = 300
    o = (mid + rng.uniform(-1, 1, (n, 3)) * (hi - lo) * 0.8).astype(
        np.float32)
    o[:, 1] += 3.0
    d = (mid + rng.normal(scale=0.3, size=(n, 3)) * (hi - lo)).astype(
        np.float32) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    mint = np.full(n, 1e-4, np.float32)
    maxt = rng.uniform(5.0, 50.0, n).astype(np.float32)
    maxt[::9] = -1.0
    beams = dict(w_factor=8, l_sc=8, beam_s2=4)
    ref, _ovf = jwp.wl_probe(jg.wl_tables, *[jnp.asarray(x) for x in (
        o, d, mint, maxt)], interpret=True, **beams)
    tt = tg.wl_tables
    rays = pack_rays(*[torch.from_numpy(x) for x in (o, d, mint, maxt)])[0]
    items, total, _ = wl.build_worklist(
        rays, tt["bmin"], tt["bmax"], tt["sc_bmin"], tt["sc_bmax"],
        rays.shape[0] * beams["w_factor"], beams["l_sc"], beams["beam_s2"])
    seen = Counter()
    got = probe_schedule(items, wl.row_segments(items, rays.shape[0], total),
                         tt["tri"], rays, seen).reshape(-1)[:n].numpy()
    lanes = np.repeat(_reached_rows(items.numpy(), rays.shape[0]), LANES)[:n]
    assert lanes.mean() > 0.5 and seen["items"] > 10
    assert np.array_equal(got[lanes], np.asarray(ref)[lanes])
