"""The work-list segments that end at the list's last used slot
(ops/worklist.py `row_segments(items, n_rows, total)`), against the
untrimmed ones whose last row runs to w_cap, as the TPU kernel's grid
does, on the CPU.

The slots past the list's `total` are padding, neither valid nor first,
that build_worklist gives to the last row; ending the last row's run at
min(total, w_cap) changes no output of the plain version `wl_rows_ref`
(and so of the kernel #12, which agrees with it lane for lane):

* the reference's cases of tests/test_torch_worklist.py (a flat and an
  instanced scene, 1,100 rays), with its small beams and the render
  path's, closest and any hit, exactly: where the list runs out of slots
  (total >= w_cap: the small beams, and the instanced scene's render
  beams) nothing is trimmed, elsewhere the last row's run loses its
  tail;
* tests/torch_instanced_cases.py's lists, flat and instanced, K = 32 and
  8: a tail of 1,200 unused slots, and a list cut short at w_cap.

torch.set_num_threads(1); each case takes under 5 s.
"""
import pytest
import torch

import torch_instanced_cases as ic
from mitsuba_tpu_torch.ops import worklist as wl
from mitsuba_tpu_torch.ops.rows import pack_rays
from test_torch_worklist import case  # noqa: F401 (a fixture)

torch.set_num_threads(1)


def _equal(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("beams", [(8, 4, 2), (48, 48, 16)])
def test_trimmed_segments_give_the_same_record(  # noqa: F811 (the fixture)
        case, beams, any_hit):
    _jg, tg, rays = case
    w_factor, l_sc, beam_s2 = beams
    tab = tg.wl_tables
    ry = pack_rays(*[torch.from_numpy(x) for x in rays])[0]
    w_cap = ry.shape[0] * w_factor
    items, total, _ovf = wl.build_worklist(
        ry, tab["bmin"], tab["bmax"], tab["sc_bmin"], tab["sc_bmax"], w_cap,
        l_sc, beam_s2)
    full = wl.row_segments(items, ry.shape[0])
    trim = wl.row_segments(items, ry.shape[0], total)
    assert int(full[-1]) == w_cap
    if total >= w_cap:                      # the list overflowed
        assert torch.equal(trim, full)
    else:
        assert int(trim[-1]) == total < w_cap
        assert torch.equal(trim[:-1], full[:-1])
    args = (tab["tri"], tab["tri_start"], ry, tab.get("block_id"),
            tab.get("xform"), any_hit)
    got = wl.wl_rows_ref(items, trim, *args)
    ref = wl.wl_rows_ref(items, full, *args)
    assert _equal(got, ref)
    hits = got if any_hit else got[3] >= 0
    assert 0 < int(hits.sum()) < hits.numel()


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("list_end", ["tail", "overflow"])
@pytest.mark.parametrize("k", [32, 8])
@pytest.mark.parametrize("instanced", [False, True])
def test_trim_on_the_case_lists(instanced, k, list_end, any_hit):
    items, seg, tri, ts, rays, bid, xf, total, full = ic.wl_case(
        instanced, k, list_end)
    n = rays.shape[0]
    assert torch.equal(wl.row_segments(items, n, total), seg)
    assert torch.equal(wl.row_segments(items, n), full)
    if list_end == "tail":
        assert int(full[-1]) - int(seg[-1]) == ic.TAIL
    else:
        assert total > items.shape[0] and torch.equal(seg, full)
    got = wl.wl_rows_ref(items, seg, tri, ts, rays, bid, xf, any_hit)
    ref = wl.wl_rows_ref(items, full, tri, ts, rays, bid, xf, any_hit)
    assert _equal(got, ref)
