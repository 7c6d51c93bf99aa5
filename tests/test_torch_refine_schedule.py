"""The schedule of the refine kernels (#5 `refine_kernel`, #6
`child_refine_kernel`, csrc/exact.cu), emulated here in plain PyTorch,
against the unchanged plain versions `refine_ref` and `child_refine_ref`,
exactly.

On the CPU the wrappers run the plain versions, so this emulation stands
for the kernels' order:

* a row's lanes with maxt < mint are left out and the live ones
  compacted; thread t of every warp holds compacted lanes t, t + 32,
  ... in K = ceil(live / 32) slots, so slots past them are never tested;
* the row's live entries come in tiles of 128, warp w taking entries w,
  w + 4, ...; an entry's code is the least over a thread's K lanes, then
  over the warp's 32 threads (one redux), and lane j of the warp stores
  its j-th entry;
* a row whose live lanes all have mint > 0 takes its keys' bits as
  codes; any other maps each key to a code that orders -0.0 and +0.0 as
  equal and breaks their tie by the lane's rank (`tie_rank`).

The plain version's zero on a tie of -0.0 and +0.0 is that of torch.amin
on the card, whose order `card_amin` emulates (ATen/native/cuda/
Reduce.cuh); on the CPU torch.amin keeps another zero. So the emulation
is held to the plain version bit for bit where a key is not a zero, and
by its value and `card_amin`'s bits where it is. On the card
tests/test_torch_cuda.py holds the kernels to the plain versions bit for
bit everywhere.

The inputs are tests/torch_refine_cases.py's (numpy, fixed seed). The
emulation counts the events it must have met (dead lanes and lane slots
left out, rows with no live lane, rows on either code path, zero ties
within a thread's slots and across threads, ties the rank gives to
+0.0), so a case that stops exercising its schedule fails.
torch.set_num_threads(1); each case takes under 5 s.
"""
import numpy as np
import pytest
import torch

from mitsuba_tpu_torch.ops import exact as ep
from mitsuba_tpu_torch.ops.rows import BIG, LANES
import torch_refine_cases as rc

torch.set_num_threads(1)
WARPS = LANES // 32
TILE = 128
ZERO_BAND = 256


def tie_rank(lane):
    """csrc/exact.cu `tie_rank`: the 5 bits of lane >> 2 reversed, then
    lane & 3."""
    t = lane >> 2
    rev = sum(((t >> k) & 1) << (4 - k) for k in range(5))
    return rev << 2 | (lane & 3)


RANK = torch.tensor([tie_rank(la) for la in range(LANES)])


def key_code(key, zr):
    """csrc/exact.cu `key_code` of float32 keys (int64 codes)."""
    b = key.view(torch.int32).long()
    zero = (b & 0x7FFFFFFF) == 0
    neg = b < 0
    return torch.where(zero, -(zr | neg.long()),
                       torch.where(neg, (b ^ 0x7FFFFFFF) - ZERO_BAND,
                                   b + ZERO_BAND))


def code_key(c):
    """csrc/exact.cu `code_key`: float32 keys of int64 codes."""
    bits = torch.where(c > ZERO_BAND, c - ZERO_BAND,
                       torch.where(c < -ZERO_BAND,
                                   (c + ZERO_BAND) ^ 0x7FFFFFFF,
                                   ((-c) & 1) << 31))
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32)


def _inv(d):
    return torch.where(torch.abs(d) > 1e-12, 1.0 / d, BIG)


def _lane_keys(lo, hi, o, inv, mn, mx):
    """Keys (k, m) of k boxes for m lanes, in the kernels' operation
    order."""
    tn = mn[None].expand(lo.shape[0], -1)
    tf = mx[None].expand(lo.shape[0], -1)
    for j in range(3):
        t0 = (lo[:, j:j + 1] - o[None, :, j]) * inv[None, :, j]
        t1 = (hi[:, j:j + 1] - o[None, :, j]) * inv[None, :, j]
        tn = torch.maximum(tn, torch.minimum(t0, t1))
        tf = torch.minimum(tf, torch.maximum(t0, t1))
    return torch.where(tn <= tf, tn, BIG)


def card_amin(v):
    """torch.amin(v, dim=-1) of v (k, 128) in the order the card reduces
    it: thread t of a warp folds lanes 4t..4t+3 in order, then a
    shuffle-down tree with offsets 16..1; each combine keeps its second
    operand unless the first is less."""
    def comb(a, b):
        return torch.where(a < b, a, b)

    x = v.reshape(-1, 32, 4)
    acc = x[:, :, 0]
    for i in range(1, 4):
        acc = comb(acc, x[:, :, i])
    for off in (16, 8, 4, 2, 1):
        acc = comb(acc[:, :off], acc[:, off:2 * off])
    return acc[:, 0]


def schedule(rays, n_live, n_out, boxes, seen):
    """The kernels' schedule over every row. n_live (R,) the live prefix
    in entries; boxes(r, e0, e1) -> (lo, hi) of entries e0:e1 of row r.
    seen: counts of the events met."""
    out = torch.full((rays.shape[0], n_out), BIG)
    for r in range(rays.shape[0]):
        n = max(0, min(int(n_live[r]), n_out))
        if n == 0:
            continue
        ry = rays[r]
        alive = ~(ry[7] < ry[6])
        lanes = torch.nonzero(alive)[:, 0]
        total = lanes.numel()
        k_slots = -(-total // 32)
        seen["dead_lanes_left_out"] += LANES - total
        seen["slots_skipped"] += WARPS - k_slots
        if total == 0:
            seen["rows_without_live_lane"] += 1
            continue
        # slot k of thread t: compacted lane t + 32 k, or a dead filler
        pad = k_slots * 32 - total
        o = torch.cat([ry[0:3, lanes].T, torch.zeros(pad, 3)])
        inv = torch.cat([_inv(ry[3:6, lanes]).T, torch.zeros(pad, 3)])
        mn = torch.cat([ry[6, lanes], torch.ones(pad)])
        mx = torch.cat([ry[7, lanes], -torch.ones(pad)])
        zr = torch.cat([RANK[lanes], torch.zeros(pad, dtype=torch.long)]) * 2
        fast = bool((mn > 0).all())
        seen["fast_rows" if fast else "slow_rows"] += 1
        for t0 in range(0, n, TILE):
            lo, hi = boxes(r, t0, min(n, t0 + TILE))
            key = _lane_keys(lo, hi, o, inv, mn, mx)     # (nt, 32 K)
            code = key.view(torch.int32).long() + ZERO_BAND if fast \
                else key_code(key, zr[None])
            # each thread's K slots, then the warp's threads (entry e is
            # warp e % 4's, stored by its lane e // 4 < 32)
            c = code.reshape(-1, k_slots, 32).amin(dim=1).amin(dim=1)
            out[r, t0:t0 + c.shape[0]] = code_key(c)
            _count_ties(seen, key, c)
    return out


def _count_ties(seen, key, c):
    """Zero keys of a tile (key (nt, 32 K) by slot) tied between lanes of
    both signs: within a thread's slots, across threads, and those the
    rank gives to +0.0."""
    zero = (key == 0) & (code_key(c) == 0)[:, None]
    tied = (zero & torch.signbit(key)).any(dim=1) & \
        (zero & ~torch.signbit(key)).any(dim=1)
    seen["zero_ties"] += int(tied.sum())
    z = zero.reshape(zero.shape[0], -1, 32)              # (nt, K, 32)
    seen["zero_ties_in_a_thread"] += int(
        (tied & (z.sum(dim=1) > 1).any(dim=1)).sum())
    seen["zero_ties_across_threads"] += int(
        (tied & (z.any(dim=1).sum(dim=1) > 1)).sum())
    seen["ties_won_by_plus_zero"] += int(
        (tied & ~torch.signbit(code_key(c))).sum())


def _check(got, ref, plain_keys):
    """Bit for bit where ref is not a zero; at zeros equal in value and
    to card_amin's bits."""
    gb, rb = got.view(torch.int32), ref.view(torch.int32)
    assert torch.equal(got, ref)
    nz = ref != 0
    assert torch.equal(gb[nz], rb[nz])
    card = card_amin(plain_keys)
    assert torch.equal(card, ref.reshape(-1))
    cb = card.view(torch.int32).reshape(ref.shape)
    assert torch.equal(gb[~nz], cb[~nz])
    return int((~nz).sum())


def _plain_keys(rays, lo, hi):
    """Each lane's key (R*E, 128) before the plain version's amin."""
    r, e = lo.shape[:2]
    d = rays[:, 3:6]
    inv = _inv(d)
    tn = rays[:, 6][:, None]
    tf = rays[:, 7][:, None]
    for j in range(3):
        t0 = (lo[:, :, j:j + 1] - rays[:, None, j]) * inv[:, None, j]
        t1 = (hi[:, :, j:j + 1] - rays[:, None, j]) * inv[:, None, j]
        tn = torch.maximum(tn, torch.minimum(t0, t1))
        tf = torch.minimum(tf, torch.maximum(t0, t1))
    return torch.where(tn <= tf, tn, BIG).reshape(r * e, LANES)


def _seen():
    return dict.fromkeys(
        ("dead_lanes_left_out", "slots_skipped", "rows_without_live_lane",
         "fast_rows", "slow_rows", "zero_ties", "zero_ties_in_a_thread",
         "zero_ties_across_threads", "ties_won_by_plus_zero"), 0)


def run_refine(width, seen):
    rays, ids, live, blo, bhi = rc.refine_case(width)
    ref = ep.refine_ref(rays, ids, live, blo, bhi)
    idl = torch.clamp(ids.long(), 0, blo.shape[0] - 1)
    got = schedule(rays, live, width,
                   lambda r, a, b: (blo[ids[r, a:b].long()],
                                    bhi[ids[r, a:b].long()]), seen)
    plain = _plain_keys(rays, blo[idl], bhi[idl])
    col = torch.arange(width)[None]
    plain = torch.where((col < live[:, None]).reshape(-1)[:, None], plain,
                        BIG)
    return _check(got, ref, plain)


def run_child(case, seen):
    rays, pids, live_p, tab = case
    ep_w = pids.shape[1]
    ref = ep.child_refine_ref(rays, pids, live_p, tab)

    def boxes(r, a, b):
        e = torch.arange(a, b)
        blk = tab[pids[r, e // 8].long(), e % 8]
        return blk[:, 0:3], blk[:, 3:6]

    got = schedule(rays, live_p * 8, ep_w * 8, boxes, seen)
    pl = torch.clamp(pids.long(), 0, tab.shape[0] - 1)
    blk = tab[pl].reshape(rays.shape[0], ep_w * 8, LANES)
    plain = _plain_keys(rays, blk[..., 0:3], blk[..., 3:6])
    col = torch.arange(ep_w * 8)[None] // 8
    plain = torch.where((col < live_p[:, None]).reshape(-1)[:, None], plain,
                        BIG)
    return _check(got, ref, plain)


@pytest.mark.parametrize("width", rc.REFINE_WIDTHS)
def test_refine_schedule_matches_plain_version(width):
    seen = _seen()
    zeros = run_refine(width, seen)
    assert zeros > 0 and seen["zero_ties"] > 0
    assert seen["slots_skipped"] > 0 and seen["slow_rows"] > 0


@pytest.mark.parametrize("width", rc.CHILD_WIDTHS)
def test_child_refine_schedule_matches_plain_version(width):
    seen = _seen()
    zeros = run_child(rc.child_case(width), seen)
    assert zeros > 0 and seen["zero_ties"] > 0
    assert seen["slots_skipped"] > 0 and seen["slow_rows"] > 0


def test_child_refine_schedule_on_the_root_table():
    """The all-L2 pass: every row lists every parent of a root table."""
    seen = _seen()
    assert run_child(rc.root_case(), seen) > 0
    assert seen["zero_ties"] > 0


def test_cases_reach_the_skip_and_the_ties():
    """The cases leave out dead lanes and whole lane slots, meet a row
    with no live lane, run both code paths, tie zeros of both signs within
    a thread's slots and across threads, and some of those ties go to
    +0.0 (where 'any -0.0 wins' would be wrong)."""
    seen = _seen()
    run_refine(256, seen)
    run_child(rc.child_case(160), seen)
    for k, v in seen.items():
        assert v > 0, k
    rays = rc.case_rays()
    d = rays[:, 3:6]
    assert bool((d == 0).any()) and bool(((d != 0) & (d.abs() < 1e-12))
                                         .any())
    _r, ids, live, _lo, _hi = rc.refine_case(256)
    past = torch.arange(256)[None] >= live[:, None]
    assert bool(((ids < 0) | (ids > rc.N_BOXES))[past].any())
    assert {0, 1, 256} <= set(live.tolist())


def test_key_codes_order_the_keys():
    """The codes order float32 keys as floats, -0.0 and +0.0 tied and
    broken by the rank (highest least), and decode to the key's bits."""
    vals = np.array([-np.inf, -3e38, -1.0, -1e-30, -1e-45, -0.0, 0.0,
                     1e-45, 1e-30, 1.0, 3e38, np.inf], np.float32)
    key = torch.from_numpy(vals)
    for zr in (0, 2, 200, 254):
        c = key_code(key, zr)
        assert torch.equal(code_key(c).view(torch.int32),
                           key.view(torch.int32))
        assert bool((c[1:] >= c[:-1]).all())
        assert bool((c[1:] > c[:-1])[key[1:] != key[:-1]].all())
    z = torch.tensor([-0.0, 0.0])
    ranks = torch.arange(LANES)
    for s in range(2):
        c = key_code(z[s].expand(LANES), ranks * 2)
        assert int(torch.argmin(c)) == LANES - 1
        assert bool(torch.signbit(code_key(c.min()))) == (s == 0)
    assert sorted(RANK.tolist()) == list(range(LANES))
