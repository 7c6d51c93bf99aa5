"""The schedule of the v1 cluster intersector (#14, csrc/cluster.cu
`cluster_kernel<ANY>`), emulated here in plain PyTorch, against the
unchanged plain version `cluster_rows_ref`, exactly, and on a few rows
against the reference's TPU kernel run in Pallas interpret mode.

The kernel walks a tile's list as the plain version does, but in its own
order of work; on the CPU the wrapper runs the plain version, so this
emulation stands for the kernel's order:

* a block walks one row's tile list in windows of 8 superclusters: each
  lane slab-tests the window's 64 cluster boxes at its maxt, and a
  cluster no lane of the row passes is skipped (it can take no vote);
* the row's other clusters (candidates) run in list order, each staged
  for the row, with the row's vote: closest, the OR of its lanes' slab
  tests at their best t; any hit, every candidate, while a lane of the
  row can still be occluded;
* a test step takes two triangles and evaluates their fourth Pluecker
  products and divisions only where a lane of its warp is eligible for
  one of them;
* closest: a warp none of whose lanes can change its record (mint < best
  t, or best t above the 3e38 miss sentinel) skips the tests; the lowest
  k among equal t within a cluster, strict < across clusters;
* any hit: a warp whose lanes are all occluded or unable skips a
  cluster, and leaves it between groups of 8 triangles once each lane
  has hit or cannot; the row stops once no lane of it can be occluded.

The inputs are tests/torch_v1_cases.py's (numpy, fixed seed): six
superclusters, rows of one tile voting differently, dead and occluded
rows, lists of length 0 and C_s, ties within and across clusters, maxt =
inf through launch_args and the miss sentinel. The emulation counts the
events it must have met, so a case that stops exercising the schedule
fails. torch.set_num_threads(1); each test takes under 5 s.

Tolerances against the TPU kernel are tests/test_torch_cluster_v1.py's:
valid flags, prims and occlusion equal; t within rtol 2e-4 / atol 2e-5,
u and v within rtol 5e-3 / atol 5e-4 (its products run on the matrix
unit in their own summation order).
"""
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_v1_cases as vc
from mitsuba_tpu.ops import cluster_pallas as jcp
from mitsuba_tpu.render import clusters as jcl
from mitsuba_tpu_torch.ops import cluster as cp
from mitsuba_tpu_torch.ops import stream as sp
from mitsuba_tpu_torch.ops.rows import BIG, LANES

torch.set_num_threads(1)
WARPS = LANES // 32
WIN_SC = 8                    # superclusters of a window (csrc/cluster.cu)
NO_K = 1 << 30


def _by_warp(x):
    """(..., 128) lane values -> (..., 4) any over each warp."""
    return x.reshape(*x.shape[:-1], WARPS, 32).any(dim=-1)


def _tests(rec, mrow):
    """The Pluecker tests of one cluster's records (128, 24) against a
    row's rays (10, 128), through the plain version's `plucker` on the
    records turned back into G's (512, 10) rows (their fixed zeros
    restored)."""
    g = rec.new_zeros((4, cp.CLUSTER_K, cp.N_COEF))
    g[:3, :, 3:9] = rec[:, :18].reshape(cp.CLUSTER_K, 3, 6).transpose(0, 1)
    g[3, :, [0, 1, 2, 9]] = rec[:, 18:22]
    return [x[0] for x in cp.plucker(g.reshape(1, 4 * cp.CLUSTER_K,
                                               cp.N_COEF), mrow[None])]


def v1_schedule(rays, ids, counts, G, aabb, tri_start, any_hit, seen):
    """#14's order (module docstring), one row (block) at a time: the
    kernel's (t, u, v, prim) or occlusion, as cluster_rows_ref returns
    them. seen: counts of the events met."""
    rec = cp.plucker_records(G)
    n_rows, c_s = rays.shape[0], G.shape[0]
    o = [rays[:, j] for j in range(3)]
    d = [rays[:, 3 + j] for j in range(3)]
    mn, mx = rays[:, 6], rays[:, 7]
    mrow = cp.ray_matrix(rays)
    tb, ub, vb = mx.clone(), torch.zeros_like(mx), torch.zeros_like(mx)
    pb = torch.full((n_rows, LANES), -1, dtype=torch.int32)
    occ = torch.zeros((n_rows, LANES), dtype=torch.bool)
    kk = torch.arange(cp.CLUSTER_K)[:, None]
    voted = [set() for _ in range(n_rows)]
    for r in range(n_rows):
        tile = r // cp.BM
        n_sc = int(counts[tile])
        seen["empty_lists"] += n_sc == 0
        seen["full_lists"] += n_sc == c_s
        stopped = False
        for w0 in range(0, n_sc, WIN_SC):
            if stopped:
                break
            scs = ids[tile, w0:min(n_sc, w0 + WIN_SC)].long()
            boxes = aabb[scs, :, :6].reshape(-1, 6)          # (nc, 6)

            def slabs(cap, bx=boxes):
                # the row's lanes against boxes bx: (len(bx), 128)
                n = bx.shape[0]
                return sp.slab(bx, [x[r].repeat(n, 1) for x in o],
                               [x[r].repeat(n, 1) for x in d],
                               mn[r].repeat(n, 1), cap[r].repeat(n, 1))
            # the window's masks: clusters some lane passes at maxt
            mask = _by_warp(slabs(mx)).any(dim=1)           # (nc,)
            seen["skipped"] += int((~mask).sum())
            for j in torch.nonzero(mask)[:, 0].tolist():
                cl = int(scs[j // 8]) * 8 + j % 8
                if any_hit:
                    # every candidate is a vote while a lane can be
                    # occluded
                    if not bool((~occ[r] & (mn[r] < mx[r])).any()):
                        seen["blocks_stopped"] += 1
                        stopped = True
                        break
                    vote = True
                else:
                    vote = bool(slabs(tb, boxes[j:j + 1]).any())
                seen["candidates"] += 1
                seen["unvoted"] += not vote
                if vote:
                    voted[r].add(cl)
                    t, rcps, p1, p2, elig = _tests(rec[cl], mrow[r])
                    if not any_hit:   # the row-wide rule's eligible tests
                        seen["row_eligible"] += int(
                            (elig & (mn[r] <= mx[r])[None]).sum())
                    for w in range(WARPS):
                        sl = slice(32 * w, 32 * w + 32)
                        # test steps of two triangles no lane is eligible for
                        lazy = ~elig[:, sl].reshape(-1, 2, 32).any(dim=2).any(
                            dim=1)                           # (64,)
                        if any_hit:
                            can = ~occ[r, sl] & (mn[r, sl] < mx[r, sl])
                            if not bool(can.any()):
                                seen["warps_skipped"] += 1
                                continue
                            hit = elig[:, sl] & (t[:, sl] > mn[r, sl]) \
                                & (t[:, sl] < mx[r, sl])
                            ran = 0
                            for k0 in range(0, cp.CLUSTER_K, 8):
                                if bool((hit[:k0].any(dim=0) | ~can).all()):
                                    seen["warps_left"] += 1
                                    break
                                ran = k0 + 8
                            seen["lazy"] += int(lazy[:ran // 2].sum())
                            occ[r, sl] = occ[r, sl] | hit[:ran].any(dim=0)
                            continue
                        t_r = tb[r, sl]
                        if not bool(((mn[r, sl] < t_r) | (BIG < t_r)).any()):
                            seen["warps_skipped"] += 1
                            continue
                        seen["lazy"] += int(lazy.sum())
                        hit = elig[:, sl] & (t[:, sl] > mn[r, sl]) \
                            & (t[:, sl] < t_r)
                        # k in order, strict < against the run's best,
                        # which starts at the miss sentinel
                        tm = torch.where(hit & (t[:, sl] < BIG), t[:, sl],
                                         BIG)
                        bt = tm.amin(dim=0)
                        at_min = (tm == bt) & (bt < BIG)
                        seen["cluster_ties"] += int(
                            (at_min.sum(dim=0) > 1).sum())
                        bk = torch.where(at_min, kk, NO_K).amin(dim=0)
                        # a test at the lane's best t, which the strict
                        # cap turns away
                        seen["cross_ties"] += int(
                            ((elig[:, sl] & (t[:, sl] == t_r)).any(dim=0)
                             & (t_r < BIG)).sum())
                        kc = bk.clamp(max=cp.CLUSTER_K - 1)[None]
                        imp = bt < t_r
                        seen["sentinels"] += int((imp & (bk == NO_K)).sum())
                        found = bk < NO_K
                        tb[r, sl] = torch.where(imp, bt, t_r)
                        for out, p in ((ub, p1), (vb, p2)):
                            sel = torch.gather(p[:, sl] * rcps[:, sl], 0,
                                               kc)[0]
                            out[r, sl] = torch.where(
                                imp, torch.where(found, sel, 0.0),
                                out[r, sl])
                        pb[r, sl] = torch.where(
                            imp, (tri_start[cl] + bk).to(torch.int32),
                            pb[r, sl])
    # tiles whose rows vote for different clusters
    seen["tiles_split"] += sum(
        len({frozenset(v) for v in voted[t:t + cp.BM]}) > 1
        for t in range(0, n_rows, cp.BM))
    if any_hit:
        return occ
    return tb, ub, vb, pb


def _same(got, ref):
    if isinstance(ref, torch.Tensor):
        return torch.equal(got, ref)
    return all(torch.equal(a.view(torch.int32) if a.is_floating_point()
                           else a, b.view(torch.int32)
                           if b.is_floating_point() else b)
               for a, b in zip(got, ref))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("any_hit", [False, True])
def test_v1_schedule_gives_the_plain_walk(any_hit, seed):
    args = vc.args(seed=seed, any_hit=any_hit)
    seen = Counter()
    got = v1_schedule(*args[:6], any_hit, seen)
    work = {}
    ref = cp.cluster_rows_ref(*args, work=work)
    assert _same(got, ref)
    # the plain version's counts of the tests that need the fourth
    # product and the division (chip_smoke.py's bound)
    assert 0 < work["tri_eligible"] < work["tri_tests"]
    assert work["tri_eligible"] <= work["row_eligible"] < work["row_tests"]
    if not any_hit:
        assert work["row_eligible"] == seen["row_eligible"]
    assert seen["empty_lists"] == 8 and seen["full_lists"] > 0
    assert seen["skipped"] > 0 and seen["warps_skipped"] > 0
    assert seen["lazy"] > 0 and seen["tiles_split"] > 0
    if any_hit:
        assert seen["blocks_stopped"] > 0 and seen["warps_left"] > 0
        assert 0 < int(ref.sum()) < ref.numel()
    else:
        assert seen["unvoted"] > 0
        assert seen["cluster_ties"] > 0 and seen["cross_ties"] > 0
        assert int((ref[3] >= 0).sum()) > 2000


@pytest.mark.parametrize("any_hit", [False, True])
def test_v1_schedule_takes_infinite_maxt(any_hit):
    """maxt = inf through launch_args: closest answers as with 1e30 (its
    clamp), any hit as with a maxt past every box; both by the emulated
    schedule, bit for bit with the plain version."""
    args = vc.args(any_hit=any_hit, inf=True)
    seen = Counter()
    got = v1_schedule(*args[:6], any_hit, seen)
    assert _same(got, cp.cluster_rows_ref(*args))
    if any_hit:
        assert bool(torch.isinf(args[0][8:16, 7]).any())
        assert seen["blocks_stopped"] > 0
    else:
        assert float(args[0][8:16, 7].max()) == np.float32(1e30)


def test_v1_schedule_takes_the_miss_sentinel():
    """maxt = inf in the packed rays of a closest launch: a lane of a
    voting row whose own tests all fail takes the 3e38 sentinel as the
    plain version does (prim = tri_start + 2^30)."""
    args = vc.args(sentinel=True)
    seen = Counter()
    got = v1_schedule(*args[:6], False, seen)
    ref = cp.cluster_rows_ref(*args)
    assert _same(got, ref)
    assert seen["sentinels"] > 0
    # lanes 0-15 of row 15 hit nothing: the sentinel stays
    assert bool((ref[0][15, :16] == np.float32(BIG)).all())
    assert bool((ref[3][15, :16] >= NO_K).all())


@pytest.mark.parametrize("any_hit", [False, True])
def test_v1_schedule_matches_tpu_kernel(any_hit, monkeypatch):
    """The `occluded` tile's eight rows (no copied cluster nor planted tie
    on their paths, so the reference's one-row tiles list what matters in
    the same order) through the emulated schedule and through the JAX
    package's kernel in interpret mode, one row per tile as in
    tests/test_torch_cluster_v1.py."""
    monkeypatch.setattr(jcp, "BM", 1)
    monkeypatch.setattr(jcp, "TILE", jcp.LANES)
    o, d, mint, maxt = (x[3 * 1024:4 * 1024]
                        for x in vc.rays(any_hit=any_hit))
    tri, ranges = vc.geometry()
    jct = jcl.build_cluster_tables(tri[:, 0], tri[:, 1] - tri[:, 0],
                                   tri[:, 2] - tri[:, 0], ranges)
    jtab = {k: jnp.asarray(getattr(jct, k))
            for k in ("G", "aabb", "tri_start", "sc_bmin", "sc_bmax")}
    jargs = [jnp.asarray(x) for x in (o, d, mint, maxt)]
    _ct, cl = vc.tables()
    args, n = cp.launch_args(cl, *[torch.from_numpy(x)
                                   for x in (o, d, mint, maxt)], any_hit)
    seen = Counter()
    got = v1_schedule(*args[:6], any_hit, seen)
    if any_hit:
        ref = np.asarray(jcp.cluster_any.__wrapped__(jtab, *jargs,
                                                     interpret=True))
        assert np.array_equal(got.reshape(-1)[:n].numpy(), ref)
        assert ref.mean() > 0.9 and seen["blocks_stopped"] == 8
        return
    ref = [np.asarray(x) for x in jcp.cluster_closest.__wrapped__(
        jtab, *jargs, interpret=True)]
    t, u, v, p = (x.reshape(-1)[:n].numpy() for x in got)
    ok = ref[4]
    assert np.array_equal(p >= 0, ok) and ok.mean() > 0.9
    assert np.array_equal(p[ok], ref[3][ok])
    np.testing.assert_allclose(t[ok], ref[0][ok], rtol=2e-4, atol=2e-5)
    for a, k in ((u, 1), (v, 2)):
        np.testing.assert_allclose(a[ok], ref[k][ok], rtol=5e-3, atol=5e-4)
