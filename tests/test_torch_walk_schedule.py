"""The schedules of the v6b walk (#9, csrc/exact.cu `l1_masked_kernel`)
and of the stream kernel (#10, csrc/stream.cu `stream_kernel`), emulated
here in plain PyTorch, against the unchanged plain versions
`l1_masked_ref` and `stream_rows_ref`, exactly.

The kernels run the walks' tests in another order than the plain
versions, and skip some; on the CPU the wrappers run the plain versions,
so these emulations stand for the kernels' order:

* #9: a warp none of whose lanes has mint < the step's cap skips the
  step's tests; an any-hit warp stops, at a K8 cluster's start, once
  each of its lanes has hit or cannot; the closest merge takes the step's
  triangles two at a time, in order.
* #10: two groups of four warps each test four of a supercluster's 8
  clusters at once, under the lanes' best t at the supercluster's start
  (looser than the walk's bound) and only where that looser slab vote
  passes; one warp then replays the cluster order, voting with the true
  bound and keeping a hit only below it. Warps with no lane that can hit
  skip their tests; an any-hit warp stops once each of its lanes has hit
  or cannot.

The inputs are tests/torch_walk_cases.py's (numpy, fixed seed): rows with dead,
escaping and occluded warps and planted exact ties. Each emulation also
counts the events it must have met, so a case that stops exercising its
schedule fails. torch.set_num_threads(1); each case takes under 5 s.
"""
import pytest
import torch

from mitsuba_tpu_torch.ops import exact as ep
from mitsuba_tpu_torch.ops import stream as sp
import torch_walk_cases as wc
from mitsuba_tpu_torch.ops.rows import BIG, LANES

torch.set_num_threads(1)
WARPS = LANES // 32


def _lanes(ry):
    """o, d as lists of (128,) planes, mint, maxt of one packed row."""
    return ([ry[j] for j in range(3)], [ry[3 + j] for j in range(3)],
            ry[6], ry[7])


def _mt(recs, o, d, mn, cap):
    """Moeller-Trumbore of one row's lanes against records (n, 16):
    (t, u, v, ok), each (n, 128)."""
    t, u, v, ok = sp.mt(recs[None], [x[None, None] for x in o],
                        [x[None, None] for x in d], mn[None, None],
                        cap[None, None])
    return t[0], u[0], v[0], ok[0]


def _per_warp(x):
    return x.reshape(WARPS, 32).any(dim=1).repeat_interleave(32)


def v6b_schedule(tri, rays, l1_ids, l1_keys, any_hit, blm, seen):
    """#9's order, row by row. seen: counts of skipped warps, stopped
    warps and tied picks."""
    r, e2 = l1_ids.shape
    blm = ep.step_width(e2, blm)
    n_tri = blm * 64
    recs_all = tri.reshape(-1, 64, LANES)[:, :, :16]
    outs = []
    for row in range(r):
        o, d, mn, mx = _lanes(rays[row])
        best = [mx.clone(), torch.zeros_like(mx), torch.zeros_like(mx),
                torch.full((LANES,), -1, dtype=torch.int32)]
        occ = torch.zeros(LANES, dtype=torch.bool)
        for s in range(0, e2, blm):
            bound = torch.where(occ, mn - 1.0, mx) if any_hit else best[0]
            if not bool((l1_keys[row, s] <= bound).any()):
                continue
            cap = torch.where(occ, mn, mx) if any_hit else best[0]
            live = mn < cap
            warp_live = _per_warp(live)
            seen["warps_skipped"] += int((~warp_live).sum()) // 32
            recs = recs_all[l1_ids[row, s:s + blm].long()].reshape(n_tri, 16)
            t, u, v, ok = _mt(recs, o, d, mn, cap)
            prim = recs[:, 15].contiguous().view(torch.int32)
            if any_hit:
                hit = torch.zeros(LANES, dtype=torch.bool)
                for k0 in range(0, n_tri, 8):
                    # a warp tests the cluster unless each lane has hit or
                    # cannot
                    go = warp_live & ~(hit | ~live).reshape(WARPS, 32).all(
                        dim=1).repeat_interleave(32)
                    seen["warps_stopped"] += int(
                        (warp_live & ~go).sum()) // 32
                    hit = hit | (go & ok[k0:k0 + 8].any(dim=0))
                occ = occ | hit
                continue
            ht = torch.full((LANES,), BIG)
            hu, hv = torch.zeros(LANES), torch.zeros(LANES)
            hp = torch.zeros(LANES, dtype=torch.int32)
            hs = torch.full((LANES,), 8)
            for m in range(n_tri):          # pairs, merged in order
                sub = m % 8
                okm = ok[m] & warp_live
                seen["ties"] += int((okm & (t[m] == ht)).sum())
                take = okm & ((t[m] < ht) | ((t[m] == ht) & (sub < hs)))
                ht = torch.where(take, t[m], ht)
                hu = torch.where(take, u[m], hu)
                hv = torch.where(take, v[m], hv)
                hp = torch.where(take, prim[m], hp)
                hs = torch.where(take, sub, hs)
            imp = ht < best[0]
            best = [torch.where(imp, a, b) for a, b in
                    zip((ht, hu, hv, hp), best)]
        outs.append(occ if any_hit else best)
    if any_hit:
        return torch.stack(outs)
    return tuple(torch.stack([o[k] for o in outs]) for k in range(4))


def _thresholds(blk, o, d, mnb):
    """The kernel's slab threshold of each cluster box (8, 128): the
    entry distance where some t_bound >= it admits the lane, NaN where
    none does."""
    sinv = [torch.where(x >= 0, 1.0, -1.0) / torch.clamp(torch.abs(x),
                                                          min=1e-12)
            for x in d]
    box = blk[0, :, 9:15]                                  # (8, 6)
    tn = mnb[None].expand(8, -1)
    tf = torch.full((8, mnb.numel()), float("inf"))
    for j in range(3):
        t0 = (box[:, j:j + 1] - o[j][None]) * sinv[j][None]
        t1 = (box[:, 3 + j:4 + j] - o[j][None]) * sinv[j][None]
        tn = torch.maximum(tn, torch.minimum(t0, t1))
        tf = torch.minimum(tf, torch.maximum(t0, t1))
    return torch.where(tn <= tf, tn, float("nan"))


def stream_schedule(rays, ids, tns, sc_tri, any_hit, seen):
    """#10's order, row by row: two groups of four warps, group g testing
    clusters 4g to 4g + 3 of each supercluster for all 128 lanes. seen:
    counts of skipped and stopped warps, loose votes the true bound
    refused, looser hits dropped at the merge, and rows that walked their
    list to its end."""
    r = rays.shape[0]
    k_cl = sc_tri.shape[1]
    outs = []
    for row in range(r):
        o, d, mnb, mx = _lanes(rays[row])
        tb, ub, vb = mx.clone(), torch.zeros(LANES), torch.zeros(LANES)
        pb = torch.full((LANES,), -1, dtype=torch.int32)
        occ = torch.zeros(LANES, dtype=torch.bool)
        live0 = mnb <= mx
        i = 0
        cont = bool(tns[row, 0] < BIG)
        while cont:
            sc = int(ids[row, i])
            blk = sc_tri[sc].reshape(k_cl, 8, 16)
            nxt = float(tns[row, i + 1])
            has_next = nxt < BIG
            if any_hit:
                live = ~occ & (mnb < mx)
                warp_live = _per_warp(live)
                hit = torch.zeros(LANES, dtype=torch.bool)
                for g in range(2):
                    gh = torch.zeros(LANES, dtype=torch.bool)
                    seen["warps_skipped"] += int((~warp_live).sum()) // 32
                    for k in range(4 * g, 4 * g + 4):
                        _t, _u, _v, ok = _mt(blk[:, k], o, d, mnb, mx)
                        for row0 in range(0, k_cl, 8):
                            go = warp_live & ~(gh | ~live).reshape(
                                WARPS, 32).all(dim=1).repeat_interleave(32)
                            seen["warps_stopped"] += int(
                                (warp_live & ~go).sum()) // 32
                            gh = gh | (go & live & ok[row0:row0 + 8].any(0))
                    hit = hit | gh
                occ = occ | hit
                cont = has_next and not bool((occ | ~live0).all())
            else:
                tb0 = tb.clone()
                thr = _thresholds(blk, o, d, mnb)
                loose = (thr <= tb0[None]).any(dim=1)
                warp_live = _per_warp(mnb < tb0)
                res = {}
                for k in range(8):
                    if not bool(loose[k]):
                        continue
                    tmin, u, v, psel = sp.visit(
                        blk[None, :, k], [x[None, None] for x in o],
                        [x[None, None] for x in d], mnb[None, None],
                        tb0[None, None])
                    res[k] = (torch.where(warp_live, tmin[0], BIG),
                              u[0], v[0], psel[0])
                    seen["warps_skipped"] += int((~warp_live).sum()) // 32
                for k in range(8):          # the walk's order, true bound
                    if k not in res:
                        continue
                    if not bool((thr[k] <= tb).any()):
                        seen["loose_votes_refused"] += 1
                        continue
                    t, u, v, psel = res[k]
                    imp = t < tb
                    seen["looser_hits_dropped"] += int(
                        ((t < tb0) & ~imp).sum())
                    tb = torch.where(imp, t, tb)
                    ub = torch.where(imp, u, ub)
                    vb = torch.where(imp, v, vb)
                    pb = torch.where(imp, ((sc * 8 + k) * k_cl + psel).to(
                        torch.int32), pb)
                cont = has_next and nxt <= float(tb.max())
            seen["list_ends"] += int(not has_next)
            i += 1
        outs.append(occ if any_hit else (tb, ub, vb, pb))
    if any_hit:
        return torch.stack(outs)
    return tuple(torch.stack([o[k] for o in outs]) for k in range(4))


def _equal(got, ref):
    if isinstance(ref, torch.Tensor):
        return torch.equal(got, ref)
    return all(torch.equal(a, b) for a, b in zip(got, ref))


def _seen():
    return dict(warps_skipped=0, warps_stopped=0, ties=0,
                loose_votes_refused=0, looser_hits_dropped=0, list_ends=0)


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("e2", [32, 384, 768])
def test_v6b_schedule_gives_the_plain_walk(e2, any_hit):
    tri, rays, ids, keys = wc.v6b_case(e2, any_hit)
    seen = _seen()
    got = v6b_schedule(tri, rays, ids, keys, any_hit, ep.V6B_BLM, seen)
    ref = ep.l1_masked_ref(tri, rays, ids, keys, any_hit, ep.V6B_BLM)
    assert _equal(got, ref)
    assert seen["warps_skipped"] > 0
    if any_hit:
        assert seen["warps_stopped"] > 0 and 0 < int(ref.sum())
    else:
        assert seen["ties"] > 0
        assert int((ref[3] >= wc.PRIM_COPY).sum()) > 0


@pytest.mark.parametrize("any_hit", [False, True])
def test_stream_schedule_gives_the_plain_walk(any_hit):
    rays, ids, tns, sc_tri = wc.stream_case(any_hit)
    assert sc_tri.shape[1] == 32
    seen = _seen()
    got = stream_schedule(rays, ids, tns, sc_tri, any_hit, seen)
    ref = sp.stream_rows_ref(rays, ids, tns, sc_tri, any_hit)
    assert _equal(got, ref)
    assert seen["warps_skipped"] > 0 and seen["list_ends"] > 0
    if any_hit:
        assert seen["warps_stopped"] > 0
    else:
        assert seen["looser_hits_dropped"] > 0


def test_cases_hold_dead_warps_and_ties():
    """The case rows: whole warps dead, a dead row, lanes that escape;
    the copies tie their originals exactly."""
    rays = wc.case_rays(False)
    live = rays[:, 6] <= rays[:, 7]
    per_warp = live.reshape(-1, WARPS, 32)
    assert bool((~per_warp.any(dim=2)).any())          # whole warps dead
    assert not bool(live[-1].any())                    # a dead row
    tri, _rays, ids, keys = wc.v6b_case(384, False)
    n_l1 = tri.shape[0] // 16
    assert bool((ids >= n_l1).any()) and bool((keys >= BIG).any())
    _r, _ids, _tns, sc_tri = wc.stream_case(False)
    assert sc_tri.shape[0] % 2 == 0
