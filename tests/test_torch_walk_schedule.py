"""The schedules of the item walks (#7 `items_kernel`, #8
`l1_items_kernel`, #9 `l1_masked_kernel` of csrc/exact.cu) and of the
stream kernel (#10, csrc/stream.cu `stream_kernel`), emulated here in
plain PyTorch, against the unchanged plain versions `items_ref`,
`l1_items_ref`, `l1_masked_ref` and `stream_rows_ref`, exactly.

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

* #7 and #9 (`step_walk`): after a tested step, one barrier gives every
  warp the row's largest bound, and each warp finds the next step to
  test among the keys; the next step's first chunk loads meanwhile.
* #8: an L1 block at a time; its children are those some lane of the row
  admits (the OR of the warps' 8-bit masks, not a warp's own), each
  tested on every lane under the lane's current cap and merged child by
  child; a closest warp with no lane below its cap and an any-hit warp
  whose lanes have each hit or cannot stop at a child's start.

The inputs are tests/torch_walk_cases.py's (numpy, fixed seed): rows with dead,
escaping and occluded warps and planted exact ties. Each emulation also
counts the events it must have met, so a case that stops exercising its
schedule fails. The emulations of #7 and #8 are also held against the JAX
package's interpreted kernels on the first rows of a case (prims and
occlusion equal; t, u and v within 1e-5, as tests/test_torch_l1_walk.py:
XLA may contract the kernel's float32 operations).
torch.set_num_threads(1); each case takes under 5 s.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.ops import exact_pallas as jep

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


def _next_step(keys, frm, bmax):
    """The kernels' next step tested: the first of keys[frm:] within the
    row's largest bound, else len(keys)."""
    ok = torch.nonzero(keys[frm:] <= bmax)
    return frm + int(ok[0, 0]) if ok.numel() else keys.numel()


def step_schedule(steps, rays, any_hit, seen):
    """#7's and #9's order (csrc/exact.cu `step_walk`), row by row.
    steps(row) -> (the row's step keys (n,), recs(s) -> step s's records
    (n_tri, 16) in list order). seen: counts of skipped warps, stopped
    warps, tied picks and steps the bound skips."""
    outs = []
    for row in range(rays.shape[0]):
        o, d, mn, mx = _lanes(rays[row])
        keys, recs_of = steps(row)
        best = [mx.clone(), torch.zeros_like(mx), torch.zeros_like(mx),
                torch.full((LANES,), -1, dtype=torch.int32)]
        occ = torch.zeros(LANES, dtype=torch.bool)
        s = _next_step(keys, 0, float(mx.max()))
        seen["steps_skipped"] += s
        while s < keys.numel():
            cap = torch.where(occ, mn, mx) if any_hit else best[0]
            live = mn < cap
            warp_live = _per_warp(live)
            seen["warps_skipped"] += int((~warp_live).sum()) // 32
            recs = recs_of(s)
            n_tri = recs.shape[0]
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
            else:
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
            # one barrier: every warp's largest bound, then the next step
            bound = torch.where(occ, mn - 1.0, mx) if any_hit else best[0]
            ns = _next_step(keys, s + 1, float(bound.max()))
            seen["steps_skipped"] += ns - s - 1
            s = ns
        outs.append(occ if any_hit else best)
    if any_hit:
        return torch.stack(outs)
    return tuple(torch.stack([o[k] for o in outs]) for k in range(4))


def v6b_schedule(tri, rays, l1_ids, l1_keys, any_hit, blm, seen):
    """#9's order: steps of blm L1 blocks, keyed by their first's key."""
    e2 = l1_ids.shape[1]
    blm = ep.step_width(e2, blm)
    recs_all = tri.reshape(-1, 64, LANES)[:, :, :16]

    def steps(row):
        return (l1_keys[row, ::blm], lambda s: recs_all[
            l1_ids[row, s * blm:(s + 1) * blm].long()].reshape(-1, 16))
    return step_schedule(steps, rays, any_hit, seen)


def items_schedule(tri, rays, ids, blk_tn, any_hit, seen):
    """#7's order: steps of 16 K8 clusters, keyed by blk_tn."""
    recs_all = tri[:, :, :16]

    def steps(row):
        return (blk_tn[row], lambda s: recs_all[
            ids[row, s * ep.BI:(s + 1) * ep.BI].long()].reshape(-1, 16))
    return step_schedule(steps, rays, any_hit, seen)


def l1_schedule(tri, ct0, rays, l1_ids, l1_keys, any_hit, seen):
    """#8's order (csrc/exact.cu `l1_items_kernel`), row by row: an L1
    block at a time, its children those the row's lanes admit (the OR of
    the warps' 8-bit masks), each tested on every lane under the lane's
    current cap and merged child by child. seen: skipped and stopped
    warps, ties at the merge, tests of lanes outside the child's own slab
    (`outside`), children a warp's own vote would drop (`warp_dropped`),
    steps the bound skips."""
    recs_all = tri.reshape(-1, 64, LANES)[:, :, :16]
    outs = []
    for row in range(rays.shape[0]):
        ry = rays[row]
        o, d, mn, mx = _lanes(ry)
        keys = l1_keys[row]
        best = [mx.clone(), torch.zeros_like(mx), torch.zeros_like(mx),
                torch.full((LANES,), -1, dtype=torch.int32)]
        occ = torch.zeros(LANES, dtype=torch.bool)
        can = mn < mx
        s = _next_step(keys, 0, float(mx.max()))
        seen["steps_skipped"] += s
        while s < keys.numel():
            lid = int(l1_ids[row, s])
            adm = ep._child_admit(ry[None], ct0[lid][None, :, :6])[0]
            warp_adm = adm.reshape(8, WARPS, 32).any(dim=2)     # (8, 4)
            mask = warp_adm.any(dim=1)
            seen["warp_dropped"] += int((mask[:, None] & ~warp_adm).sum())
            recs = recs_all[lid]
            for c in torch.nonzero(mask)[:, 0].tolist():
                ct = recs[c * 8:(c + 1) * 8]
                if any_hit:
                    go = ~(occ | ~can).reshape(WARPS, 32).all(
                        dim=1).repeat_interleave(32)
                    seen["warps_stopped"] += int((~go).sum()) // 32
                    ok = _mt(ct, o, d, mn, mx)[3]
                    seen["outside"] += int((go & ~adm[c] & ok.any(0)).sum())
                    occ = occ | (go & ok.any(dim=0))
                    continue
                go = _per_warp(mn < best[0])
                seen["warps_skipped"] += int((~go).sum()) // 32
                t, u, v, ok = _mt(ct, o, d, mn, best[0])
                prim = ct[:, 15].contiguous().view(torch.int32)
                ht = torch.full((LANES,), BIG)
                hu, hv = torch.zeros(LANES), torch.zeros(LANES)
                hp = torch.zeros(LANES, dtype=torch.int32)
                # a copy's triangle at its original's t: the strict cap
                # refuses it
                t_all, _u, _v, ok_all = _mt(ct, o, d, mn,
                                           torch.full_like(mn, BIG))
                seen["ties"] += int((go & (ok_all & (t_all == best[0])).any(
                    dim=0)).sum())
                for j in range(8):          # pairs, merged in order
                    take = go & ok[j] & (t[j] < ht)
                    ht = torch.where(take, t[j], ht)
                    hu = torch.where(take, u[j], hu)
                    hv = torch.where(take, v[j], hv)
                    hp = torch.where(take, prim[j], hp)
                seen["outside"] += int((go & ~adm[c] & ok.any(0)).sum())
                imp = ht < best[0]
                best = [torch.where(imp, a, b) for a, b in
                        zip((ht, hu, hv, hp), best)]
            bound = torch.where(occ, mn - 1.0, mx) if any_hit else best[0]
            ns = _next_step(keys, s + 1, float(bound.max()))
            seen["steps_skipped"] += ns - s - 1
            s = ns
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
                loose_votes_refused=0, looser_hits_dropped=0, list_ends=0,
                steps_skipped=0, outside=0, warp_dropped=0)


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
@pytest.mark.parametrize("e3", [96, 512, 1024])
def test_items_schedule_gives_the_plain_walk(e3, any_hit):
    tri, rays, ids, blk_tn = wc.items_case(e3, any_hit)
    seen = _seen()
    got = items_schedule(tri, rays, ids, blk_tn, any_hit, seen)
    ref = ep.items_ref(tri, rays, ids, blk_tn, any_hit)
    assert _equal(got, ref)
    assert seen["warps_skipped"] > 0 and seen["steps_skipped"] > 0
    if any_hit:
        assert seen["warps_stopped"] > 0 and 0 < int(ref.sum())
    else:
        assert seen["ties"] > 0
        assert int((ref[3] >= wc.PRIM_COPY).sum()) > 0


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("e2", [32, 384, 768])
def test_l1_schedule_gives_the_plain_walk(e2, any_hit):
    case = wc.l1_case(e2, any_hit)
    seen = _seen()
    got = l1_schedule(*case, any_hit, seen)
    ref = ep.l1_items_ref(*case, any_hit)
    assert _equal(got, ref)
    # a child some warp admits and another refuses is tested on all lanes
    assert seen["warp_dropped"] > 0 and seen["steps_skipped"] > 0
    if any_hit:
        assert seen["warps_stopped"] > 0 and 0 < int(ref.sum())
    else:
        # copies meet the best of their originals, tested first, and
        # never win
        assert seen["warps_skipped"] > 0 and seen["ties"] > 0
        assert int((ref[3] >= 0).sum()) > 0
        assert int((ref[3] >= wc.PRIM_COPY).sum()) == 0


# the first rows of a case, and its dead last row
_FEW = [0, 1, wc.ROWS - 1]


def _same_as_tpu(got, out, any_hit):
    """got: an emulation's (t, u, v, prim) or occlusion; out: the
    interpreted TPU kernel's (R, 8, 128) output."""
    out = np.asarray(out)
    if any_hit:
        assert np.array_equal(got.numpy(), out[:, 0] > 0.5)
        assert 0 < int(got.sum())
        return
    prim_r = out[:, 3].view(np.int32)
    assert np.array_equal(got[3].numpy(), prim_r)
    hit = prim_r >= 0
    assert hit.sum() > 50
    for a, k in zip(got[:3], range(3)):
        np.testing.assert_allclose(a.numpy()[hit], out[:, k][hit],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("any_hit", [False, True])
def test_items_schedule_matches_tpu_kernel(any_hit):
    """#7's order against `_call_items`, interpreted, on items_case's
    rows at E3 = 96, cut to their first two steps."""
    tri, rays, ids, blk_tn = wc.items_case(96, any_hit)
    case = (tri, rays[_FEW], ids[_FEW, :2 * ep.BI].contiguous(),
            blk_tn[_FEW, :2].contiguous())
    got = items_schedule(*case, any_hit, _seen())
    out = jep._call_items(*(jnp.asarray(x.numpy()) for x in case), any_hit,
                          True)
    _same_as_tpu(got, out, any_hit)


@pytest.mark.parametrize("any_hit", [False, True])
def test_l1_schedule_matches_tpu_kernel(any_hit, monkeypatch):
    """#8's order against `_call_l1_items`, interpreted one L1 block a
    grid step, on l1_case's rows at E2 = 32."""
    monkeypatch.setattr(jep, "BL", 1)
    case = [x[_FEW] if i > 1 else x
            for i, x in enumerate(wc.l1_case(32, any_hit))]
    got = l1_schedule(*case, any_hit, _seen())
    out = jep._call_l1_items(*(jnp.asarray(x.numpy()) for x in case),
                             any_hit, True)
    _same_as_tpu(got, out, any_hit)


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
