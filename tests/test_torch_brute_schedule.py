"""The schedule of the brute kernel's four instances (csrc/intersect_brute.cu
`brute_kernel`: #1 fused closest with its shading record and any hit, #2
shaded closest, #3 any hit and #4 unshaded closest over the (T, 9)
table), emulated here in plain PyTorch, against the unchanged plain
versions `closest_hit_shaded_and_any_ref`, `closest_hit_shaded_ref`,
`any_hit_ref` and `closest_hit_ref`, exactly.

On the CPU the wrappers run the plain versions, so this emulation stands
for the kernels' order:

* the lanes come in tiles of THREADS lanes, a block's; in each tile the
  live lanes (mint < maxt; for #3, kStill, also a direction other than
  zero) of each ray set are compacted in lane order into slots, thread t
  taking slot t, so warp w holds slots [32 w, 32 w + 32);
* a dead lane, or for #3 one with a zero direction (det 0 for every
  row), gets the miss record (and is not occluded) without a test;
* a warp runs only where the tile has a live lane at its first slot or
  beyond, so a tile with no live lane runs no test;
* the table's rows are staged in passes of STAGE_ROWS, in row order, and
  each slot keeps the first row of least t (strict <) row by row;
* the any-hit half of a warp stops, before each group of SHADOW_GROUP
  rows of a pass, once each of its live slots is occluded;
* the record is interpolated once, from the winning row (#1, #2), or the
  winning row's t, u, v and index are written as they are (#4).

The emulation counts the events it must have met (dead lanes, lanes
with a zero direction dropped, tiles with no live lane, warps not run, any-hit warps stopped early and the tests
they skipped, exact ties, within a pass and across passes, tables of
several passes), so a case that stops exercising its schedule fails. The
inputs are tests/torch_brute_cases.py's (numpy, fixed seed); #3 and #4
take the first 9 columns of a case's table. On a few small cases the
emulation is also held to the JAX package's Pallas kernels run in
interpret mode, within the tolerances of tests/test_torch_intersect.py
(XLA may reassociate or contract the reference's arithmetic).
torch.set_num_threads(1); each case takes under 5 s.
"""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.ops import intersect_pallas as jip
from mitsuba_tpu_torch.ops import intersect as ip
import torch_brute_cases as bc

torch.set_num_threads(1)
NAMES = tuple(bc.case_specs())


def _slots(d, mint, maxt, tile, still):
    """Per tile the live lanes' indices in lane order (-1 past them) and
    the live count: a lane is live where mint < maxt and, with `still`
    (the kernel's kStill), its direction is not zero."""
    n = mint.shape[0]
    n_tiles = -(-n // tile)
    live = torch.zeros(n_tiles * tile, dtype=torch.bool)
    live[:n] = mint < maxt
    if still:
        live[:n] &= (d != 0).any(dim=1)
    live = live.view(n_tiles, tile)
    rank = live.cumsum(dim=1) - 1
    slot = torch.full((n_tiles, tile), -1, dtype=torch.long)
    ti, li = live.nonzero(as_tuple=True)
    slot[ti, rank[ti, li]] = ti * tile + li
    return slot.reshape(-1), live.sum(dim=1)


def _slot_rays(slot, o, d, mint, maxt):
    """The slots' rays; a slot past the live count holds a dead ray."""
    pad = slot < 0
    i = slot.clamp(min=0)
    return (torch.where(pad[:, None], torch.tensor([0.0, 0.0, 0.0]), o[i]),
            torch.where(pad[:, None], torch.tensor([0.0, 0.0, 1.0]), d[i]),
            torch.where(pad, 0.0, mint[i]), torch.where(pad, -1.0, maxt[i]))


def _runs(count, warps):
    """(S,) bool: the slots whose warp (32 slots) the tile runs."""
    k = torch.arange(warps).repeat_interleave(32)
    return (32 * k[None, :] < count[:, None]).reshape(-1)


def emulate(table, rays=None, shadow=None, shade=True, still=False,
            counts=None):
    """One instance's schedule: the closest half over rays = (o, d, mint,
    maxt) when given, writing the shading record if `shade` (#1, #2) or t,
    u, v, prim and valid (#4); the any-hit half over shadow = (so, sd,
    smint, smaxt) when given (#1, #3); `still`: the compaction also drops
    lanes with a zero direction (#3). Returns #1's (record, occluded),
    #2's record, #3's occlusion mask or #4's (t, u, v, prim, valid)."""
    counts = {} if counts is None else counts
    tile, warp_lanes = ip.THREADS, 32
    n = (rays if rays is not None else shadow)[0].shape[0]
    n_tris = table.shape[0]

    def add(key, x):
        counts[key] = counts.get(key, 0) + int(x)

    def schedule(ray_set, keys):
        """A ray set's slots, the slots whose warp runs, their rays."""
        _o, d, mint, maxt = ray_set
        if still:
            add("zero_direction_lanes_dropped",
                ((mint < maxt) & (d == 0).all(dim=1)).sum())
        slot, count = _slots(d, mint, maxt, tile, still)
        run = _runs(count, tile // 32)
        for key, x in zip(keys, (n - int(count.sum()), (count == 0).sum(),
                                 (~run).sum() // 32)):
            add(key, x)
        return slot, run, _slot_rays(slot, *ray_set)

    if rays is not None:
        b_slot, b_run, (bo, bd, bmn, bmx) = schedule(
            rays, ("dead_lanes", "tiles_without_live_lane", "warps_not_run"))
        n_slots = b_slot.shape[0]
        t_b = torch.full((n_slots,), float("inf"))
        u_b, v_b = torch.zeros(n_slots), torch.zeros(n_slots)
        p_b = torch.full((n_slots,), -1, dtype=torch.long)
    if shadow is not None:
        s_slot, s_run, (so_, sd_, smn, smx) = schedule(
            shadow, ("dead_shadow_lanes", "shadow_tiles_without_live_lane",
                     "shadow_warps_not_run"))
        s_pad = s_slot < 0
        # a warp's slots: 32 K consecutive ones; warps still testing
        s_on = (~s_pad).view(-1, warp_lanes).any(dim=1)
        occ = torch.zeros_like(s_run)
    passes = range(0, n_tris, ip.STAGE_ROWS)
    add("multi_pass_tables", len(passes) > 1)
    for c0 in passes:
        rows = min(ip.STAGE_ROWS, n_tris - c0)
        for j in range(c0, c0 + rows):
            row = table[j:j + 1]
            if rays is not None:
                t, u, v, hit = (x[:, 0]
                                for x in ip._mt(row, bo, bd, bmn, bmx))
                hit = hit & b_run
                tie = hit & (t == t_b)
                add("ties", tie.sum())
                add("ties_across_passes", (tie & (p_b < c0)).sum())
                better = hit & (t < t_b)
                t_b = torch.where(better, t, t_b)
                u_b = torch.where(better, u, u_b)
                v_b = torch.where(better, v, v_b)
                p_b = torch.where(better, j, p_b)
            if shadow is None:
                continue
            if (j - c0) % ip.SHADOW_GROUP == 0:
                # the vote before a group: a warp stops once each of its
                # live lanes is occluded
                done = (occ | s_pad).view(-1, warp_lanes).all(dim=1) & s_on
                add("shadow_warps_stopped_early", done.sum())
                live = (~s_pad).view(-1, warp_lanes).sum(dim=1)
                add("shadow_tests_skipped", (live[done] * (n_tris - j)).sum())
                s_on = s_on & ~done
            test = s_run & s_on.repeat_interleave(warp_lanes)
            occ = occ | (ip._mt(row, so_, sd_, smn, smx)[3][:, 0] & test)
    out = []
    if rays is not None:
        # the winning row's record, interpolated once, or its t, u, v and
        # index; a dead lane's and a pad slot's from no row
        p32 = p_b.to(torch.int32)
        got = (ip._shading_record(table, t_b, u_b, v_b, p32, p_b >= 0)
               if shade else dict(t=t_b, u=u_b, v=v_b, prim=p32,
                                  valid=p_b >= 0))
        miss = dict(t=torch.full((n,), float("inf")), u=torch.zeros(n),
                    v=torch.zeros(n),
                    prim=torch.full((n,), -1, dtype=torch.int32),
                    valid=torch.zeros(n, dtype=torch.bool))
        if shade:
            miss = ip._shading_record(table, *miss.values())
        live = b_slot >= 0
        rec = {}
        for k, x in miss.items():
            x = x.clone()
            x[b_slot[live]] = got[k][live]
            rec[k] = x
        out.append(rec if shade else tuple(rec.values()))
    if shadow is not None:
        mask = torch.zeros(n, dtype=torch.bool)
        mask[s_slot[~s_pad]] = occ[~s_pad]
        out.append(mask)
    return out[0] if len(out) == 1 else tuple(out)


def _same(got, ref):
    assert list(got) == list(ref)
    for k in ref:
        a, b = got[k], ref[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), k


@pytest.mark.parametrize("name", NAMES)
def test_schedule_matches_plain_versions(name):
    """#1's and #2's schedules against the plain versions, every field of
    every lane by its bits."""
    args = bc.cases(0)[name]
    counts = {}
    rec, occ = emulate(args[0], args[1:5], shadow=args[5:], counts=counts)
    ref, ref_occ = ip.closest_hit_shaded_and_any_ref(*args)
    _same(rec, ref)
    assert torch.equal(occ, ref_occ)
    _same(emulate(args[0], args[1:5]), ip.closest_hit_shaded_ref(*args[:5]))
    assert counts["dead_lanes"] > 0 and counts["warps_not_run"] > 0
    assert counts["multi_pass_tables"] == (args[0].shape[0]
                                           > ip.STAGE_ROWS)
    if name == "shadow_dead":
        assert counts["dead_shadow_lanes"] == args[5].shape[0]


def test_schedule_meets_its_corner_cases():
    """Over all cases the emulation met every event its schedule has:
    whole tiles dead, warps not run, shadow warps stopped early (every
    live lane occluded, as by the FIRST occluder), exact ties of
    duplicated rows, and a table of several passes."""
    counts = {}
    for args in bc.cases(0).values():
        emulate(args[0], args[1:5], shadow=args[5:], counts=counts)
    for key in ("dead_lanes", "tiles_without_live_lane",
                "warps_not_run", "dead_shadow_lanes",
                "shadow_warps_stopped_early", "shadow_tests_skipped",
                "ties", "multi_pass_tables"):
        assert counts[key] > 0, key


def test_record_outputs_are_the_reference_layout():
    """The kernels' outputs: the reference's keys in its order, dtypes and
    shapes, as views of three allocations that do not overlap."""
    n = 37
    args = bc.cases(0)["T32"]
    ref = ip.closest_hit_shaded_ref(*(a[:n] if a.dim() and k else a
                                      for k, a in enumerate(args[:5])))
    rec, occ = ip._record_outputs(n, torch.device("cpu"), shadow=True)
    assert list(rec) == list(ref)
    for k in ref:
        assert rec[k].dtype == ref[k].dtype, k
        assert rec[k].shape == ref[k].shape, k
        assert rec[k].is_contiguous(), k
    assert occ.dtype == torch.bool and occ.shape == (n,)
    views = list(rec.items()) + [("occ", occ)]
    fills = [(k, x, True if k == "valid" else False if x.dtype == torch.bool
              else j + 1) for j, (k, x) in enumerate(views)]
    for _k, x, value in fills:
        x.fill_(value)
    for k, x, value in fills:
        assert bool((x == value).all()), k
    rec2, none = ip._record_outputs(n, torch.device("cpu"), shadow=False)
    assert none is None and list(rec2) == list(ref)


def _jax_table(table):
    t = table.numpy()
    g = dict(v0=t[:, 0:3], e1=t[:, 3:6], e2=t[:, 6:9], n0=t[:, 9:12],
             n1=t[:, 12:15], n2=t[:, 15:18], uv0=t[:, 18:20],
             uv1=t[:, 20:22], uv2=t[:, 22:24],
             material_id=t[:, 24].astype(np.int32),
             emitter_id=t[:, 25].astype(np.int32),
             shape_id=t[:, 26].astype(np.int32))
    jt = jip.make_shading_table(
        SimpleNamespace(**{k: jnp.asarray(v) for k, v in g.items()}))
    np.testing.assert_array_equal(np.asarray(jt), t)
    return jt


def _near(rec, ref, keep):
    """tests/test_torch_intersect.py's tolerances, on the lanes `keep`."""
    for k in ("prim", "material_id", "emitter_id", "shape_id", "valid"):
        np.testing.assert_array_equal(rec[k].numpy()[keep],
                                      np.asarray(ref[k])[keep], err_msg=k)
    hit = rec["valid"].numpy() & keep
    for k in ("t", "u", "v"):
        np.testing.assert_allclose(rec[k].numpy()[hit],
                                   np.asarray(ref[k])[hit], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    for k in ("geo_n", "sh_n", "uv"):
        np.testing.assert_allclose(rec[k].numpy()[keep],
                                   np.asarray(ref[k])[keep], rtol=0,
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("shadow", [True, False])
@pytest.mark.parametrize("n_tris", [1, 4])
def test_schedule_matches_interpreted_tpu_kernels(n_tris, shadow):
    """The emulation against the TPU kernels `_shaded_any_kernel` (#1)
    and `_shaded_kernel` (#2) themselves, in Pallas interpret mode, on
    the cases' warp patterns over tables of 1 and 4 rows (below the
    special rows' 16: the interpreter's time grows by ~0.35 s a row; the
    ties and the |det| slivers are held to the plain version above, and
    the plain version to the interpreted kernel in
    tests/test_torch_intersect.py)."""
    args = tuple(torch.from_numpy(x) for x in bc.case_arrays(n_tris))
    jt = _jax_table(args[0])
    rays = [a.numpy() for a in args[1:]]
    keep = np.ones(args[1].shape[0], dtype=bool)
    if shadow:
        rec, occ = emulate(args[0], args[1:5], shadow=args[5:])
        ref, ref_occ = jip.closest_hit_shaded_and_any(jt, *rays,
                                                      interpret=True)
        np.testing.assert_array_equal(occ.numpy(), np.asarray(ref_occ))
        assert 0 < int(occ.sum()) < int((args[7] < args[8]).sum())
    else:
        rec = emulate(args[0], args[1:5])
        ref = jip.closest_hit_shaded(jt, *rays[:4], interpret=True)
    _near(rec, ref, keep)
    assert 0 < int(rec["valid"].sum()) < int((args[3] < args[4]).sum())


def _same_hits(got, ref):
    """#4's (t, u, v, prim, valid), float32 fields by their bits."""
    assert len(got) == len(ref) == 5
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)


def _split_case(name):
    """#3's arguments (the shadow rays) and #4's (the bounce rays) of a
    case, over the (T, 9) table of its first 9 columns."""
    args = bc.cases(0)[name]
    tri = args[0][:, :9].contiguous()
    return (tri,) + args[5:9], (tri,) + args[1:5]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("kernel", ["any", "closest"])
def test_split_schedule_matches_plain_versions(kernel, name):
    """#3's (any hit only) and #4's (closest, unshaded) schedules over the
    (T, 9) table against `any_hit_ref` and `closest_hit_ref`, every field
    of every lane by its bits."""
    any_args, closest_args = _split_case(name)
    counts = {}
    if kernel == "any":
        occ = emulate(any_args[0], shadow=any_args[1:], still=True,
                      counts=counts)
        assert occ.dtype == torch.bool
        assert torch.equal(occ, ip.any_hit_ref(*any_args))
        assert counts["dead_shadow_lanes"] > 0
        assert counts["shadow_warps_not_run"] > 0
        if name == "shadow_dead":
            assert not bool(occ.any())
            assert counts["dead_shadow_lanes"] == occ.shape[0]
    else:
        got = emulate(closest_args[0], closest_args[1:], shade=False,
                      counts=counts)
        _same_hits(got, ip.closest_hit_ref(*closest_args))
        assert counts["dead_lanes"] > 0 and counts["warps_not_run"] > 0
    assert counts["multi_pass_tables"] == (any_args[0].shape[0]
                                           > ip.STAGE_ROWS)


def test_split_schedules_meet_their_corner_cases():
    """Over all cases #3's emulation met every event of its schedule
    (dead lanes, lanes with a zero direction dropped, tiles with no live
    lane, warps not run, warps stopped early once all their live lanes
    are occluded, and the tests that saved), and #4's (dead lanes, tiles
    with no live lane, warps not run, exact ties within a pass and across
    passes); each on a table of several passes."""
    any_counts, closest_counts = {}, {}
    for name in NAMES:
        any_args, closest_args = _split_case(name)
        emulate(any_args[0], shadow=any_args[1:], still=True,
                counts=any_counts)
        emulate(closest_args[0], closest_args[1:], shade=False,
                counts=closest_counts)
    for key in ("dead_shadow_lanes", "zero_direction_lanes_dropped",
                "shadow_tiles_without_live_lane", "shadow_warps_not_run",
                "shadow_warps_stopped_early", "shadow_tests_skipped",
                "multi_pass_tables"):
        assert any_counts[key] > 0, key
    for key in ("dead_lanes", "tiles_without_live_lane", "warps_not_run",
                "ties", "ties_across_passes", "multi_pass_tables"):
        assert closest_counts[key] > 0, key


def test_hit_outputs_are_the_reference_layout():
    """#4's outputs: closest_hit_ref's dtypes and shapes, as views of
    three allocations that do not overlap."""
    n = 37
    _any_args, closest_args = _split_case("T32")
    ref = ip.closest_hit_ref(*(a if k == 0 else a[:n]
                               for k, a in enumerate(closest_args)))
    out = ip._hit_outputs(n, torch.device("cpu"))
    assert len(out) == len(ref)
    for x, r in zip(out, ref):
        assert x.dtype == r.dtype and x.shape == r.shape
        assert x.is_contiguous()
    fills = [(x, True if x.dtype == torch.bool else k + 1)
             for k, x in enumerate(out)]
    for x, value in fills:
        x.fill_(value)
    for x, value in fills:
        assert bool((x == value).all())


def _jax_tri_table(tri):
    t = tri.numpy()
    jt = jip.make_tri_table(jnp.asarray(t[:, 0:3]), jnp.asarray(t[:, 3:6]),
                            jnp.asarray(t[:, 6:9]))
    np.testing.assert_array_equal(np.asarray(jt), t)
    return jt


@pytest.mark.parametrize("n_tris", [1, 4])
@pytest.mark.parametrize("kernel", ["any", "closest"])
def test_split_schedule_matches_interpreted_tpu_kernels(kernel, n_tris):
    """#3's and #4's emulations against the TPU kernels `_any_kernel` and
    `_closest_kernel` themselves, in Pallas interpret mode, on the cases'
    warp patterns over tables of 1 and 4 rows (the ties, the |det|
    slivers and the passes are held to the plain versions above)."""
    args = tuple(torch.from_numpy(x) for x in bc.case_arrays(n_tris))
    tri = args[0][:, :9].contiguous()
    jt = _jax_tri_table(tri)
    if kernel == "any":
        occ = emulate(tri, shadow=args[5:9], still=True)
        ref = jip.any_hit(jt, *(a.numpy() for a in args[5:9]),
                          interpret=True)
        np.testing.assert_array_equal(occ.numpy(), np.asarray(ref))
        assert 0 < int(occ.sum()) < int((args[7] < args[8]).sum())
        return
    t, u, v, prim, valid = emulate(tri, args[1:5], shade=False)
    rt, ru, rv, rprim, rvalid = jip.closest_hit(
        jt, *(a.numpy() for a in args[1:5]), interpret=True)
    np.testing.assert_array_equal(prim.numpy(), np.asarray(rprim))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(rvalid))
    hit = valid.numpy()
    assert 0 < int(hit.sum()) < int((args[3] < args[4]).sum())
    for a, b in ((t, rt), (u, ru), (v, rv)):
        np.testing.assert_allclose(a.numpy()[hit], np.asarray(b)[hit],
                                   rtol=1e-5, atol=1e-6)
    assert np.isinf(t.numpy()[~hit]).all()
    assert (u.numpy()[~hit] == 0).all() and (v.numpy()[~hit] == 0).all()
