"""The work-list item cost of scripts/exp_r3_kernel.py on the card, items
A-E of its docstring:

  A. the item-loop floor: a near-empty loop over W items, no block
     fetched (bench_grid_floor :70, fetch off);
  B. the same staging a 2 KB block per item in shared memory (fetch on;
     rotate's bulk-copy ring, `shape["group"]` items a stage, the staged
     rate beside);
  C. the Möller–Trumbore ceiling: `_mt_chunks`' form (ops/probes.py `v1`
     without u) on a resident 32-triangle block, R reps (bench_mt_ceiling
     :112);
  D. the work-list probe #13 (ops/worklist.py `wl_probe`: item fetch and
     slab test, no Möller–Trumbore) on a real work list;
  E. the work-list closest-hit kernel #12 on the same list.

The script's list is the bunny's; the bunny file is absent, so the list
is config 3's (`textured_mesh_scene(backend="cluster")`, the 101,762-
triangle sphere fallback) as scripts/exp_worklist2.py:54-88 builds it:
the triangles re-cut into K = 32 clusters by the port's own BVH, and
1,024 x 1,024 camera lanes in pixel-Morton order, w_factor 16, l_sc 24.
D and E are timed as kernels on that one list (and D also through its
entry point, list build included); their ratio is the fixed cost of an
item against its full cost.

    python -m mitsuba_tpu_torch.probes.r3_kernel
"""
from __future__ import annotations

import numpy as np
import torch

from mitsuba_tpu_torch.integrators.path import pixel_morton_perm
from mitsuba_tpu_torch.ops import probes as pr
from mitsuba_tpu_torch.ops import worklist as wl
from mitsuba_tpu_torch.ops.rows import pack_rays
from mitsuba_tpu_torch.probes import (
    both_forms, bound_ns, card, device_ms, main_of, timed_ms,
)
from mitsuba_tpu_torch.render.bvh import build_bvh
from mitsuba_tpu_torch.render.clusters import build_mt_tables, cut_clusters

SCRIPT = "scripts/exp_r3_kernel.py"
K_CL = 32
N_TRI_BLOCKS = 2048
BOX_OPS = 25              # float32 operations of one slab test
SIZES = dict(grid=(25_000, 200_000), grid_card=(256, 2048),
             mt=(512, 4096), mt_card=(8, 64), side=1024)


def worklist_case(device, side: int = 1024, scene=None, k_cl: int = K_CL):
    """exp_worklist2.py's list on config 3's sphere: (tables, o, d, mint,
    maxt) of side x side camera lanes in pixel-Morton order."""
    if scene is None:
        from mitsuba_tpu_torch.render.scene import textured_mesh_scene
        scene = textured_mesh_scene(256, 256, backend="cluster",
                                    device=device)
    g = scene.geom
    v0, e1, e2 = (x.cpu().numpy() for x in (g.v0, g.e1, g.e2))
    f = np.arange(v0.shape[0] * 3, dtype=np.int32).reshape(-1, 3)
    verts = np.concatenate([v0, v0 + e1, v0 + e2], axis=1).reshape(-1, 3)
    bvh = build_bvh(verts, f)
    perm = bvh.perm
    ranges = cut_clusters(bvh.first, bvh.count, bvh.skip, f.shape[0],
                          max_k=k_cl)
    mt = build_mt_tables(v0[perm], e1[perm], e2[perm], ranges, k=k_cl)
    tab = {k: torch.as_tensor(getattr(mt, k), device=device) for k in
           ("tri", "tri_start", "bmin", "bmax", "sc_bmin", "sc_bmax")}
    n = side * side
    lane = torch.arange(n, device=device)
    uv = torch.stack([(lane % side).float() / side,
                      (lane // side).float() / side], -1)
    ray = scene.camera.sample_ray(uv)
    mo = torch.as_tensor(pixel_morton_perm(side, side), device=device)
    mint = torch.full((n,), 1e-4, device=device)
    maxt = torch.full((n,), 1e9, device=device)
    return (tab, ray.o[mo].contiguous(), ray.d[mo].contiguous(), mint,
            maxt)


def _list_lines(device, case):
    """D and E on one list: kernel times, items, the fixed cost of an item
    against its full cost; D's entry point with its list build. Both
    kernels run twice: on the list as built, whose unused slots (past its
    total, up to w_cap) all fall to the last row, and with those slots cut
    from the last row's run ("trimmed"): the same hits, as no unused slot
    is valid."""
    tab, o, d, mint, maxt = case
    rays = pack_rays(o, d, mint, torch.clamp(maxt, max=1e30))[0]
    r = rays.shape[0]
    items, total, ovf = wl.build_worklist(
        rays, tab["bmin"], tab["bmax"], tab["sc_bmin"], tab["sc_bmax"],
        r * wl.PROBE_W_FACTOR, wl.PROBE_L_SC, wl.BEAM_S2)
    seg = wl.row_segments(items, r)
    trimmed = seg.clone()
    trimmed[-1] = torch.clamp(trimmed[-1], max=max(total, int(seg[-2])))
    valid = (items & wl._VALID_BIT) != 0
    n_valid = int(valid.sum())
    n_clusters = int(torch.unique(items[valid] & (wl._FIRST_BIT - 1)).numel())
    row_items = torch.zeros(r, dtype=torch.int64, device=rays.device)
    row_items.index_add_(0, (items[valid] >> wl._ROW_SHIFT).long(),
                         torch.ones_like(items[valid], dtype=torch.int64))
    k_cl = tab["tri"].shape[1]
    common = dict(script=f"{SCRIPT}:8-10", rows=r, lanes=o.shape[0],
                  clusters=int(tab["tri"].shape[0]), k=k_cl,
                  list_slots=int(items.shape[0]), list_total=total,
                  valid_items=n_valid, overflow_rows=int(ovf.sum()),
                  max_row_items=int(row_items.max()),
                  last_row_slots=int(seg[-1] - seg[-2]),
                  device=card(device)["name"])

    def probe(sg):
        return wl.wl_probe_rows(items, sg, tab["tri"], rays)

    def closest(sg):
        return wl.wl_rows(items, sg, tab["tri"], tab["tri_start"], rays,
                          None, None, False)

    def entry():
        return wl.wl_probe(tab, o, d, mint, maxt)

    lists = (("as built", seg), ("trimmed", trimmed))
    if torch.device(device).type != "cuda":
        entry()
        same_d = torch.equal(probe(seg), probe(trimmed))
        same_e = all(torch.equal(x, y)
                     for x, y in zip(closest(seg), closest(trimmed)))
        return [dict(common, probe="wl_probe", item="D", ms=None,
                     trimmed_same=same_d),
                dict(common, probe="wl_closest", item="E", ms=None,
                     trimmed_same=same_e)]
    # D's work: per valid item and lane a slab test and two adds; bytes:
    # the distinct cluster blocks, the rays, the list and the output
    nbytes = (n_clusters * k_cl * 16 * 4 + rays.numel() * 4
              + items.numel() * 4 + seg.numel() * 4 + r * 128 * 4)
    b_ns, b_by = bound_ns(n_valid * 128 * (BOX_OPS + 2), nbytes)
    # the kernels by device time; the entry point, list build included, by
    # CUDA events
    ms_entry = timed_ms(entry)
    lines = []
    for label, sg in lists:
        ms_d = device_ms(lambda sg=sg: probe(sg))
        ms_e = device_ms(lambda sg=sg: closest(sg))
        lines += [
            dict(common, probe="wl_probe", item="D", kernel="wl_probe",
                 list=label, ms=ms_d, ns_per_item=ms_d * 1e6 / n_valid,
                 entry_ms=ms_entry, bound_ns=b_ns, bound_by=b_by,
                 distinct_clusters=n_clusters),
            dict(common, probe="wl_closest", item="E", kernel="wl_closest",
                 list=label, ms=ms_e, ns_per_item=ms_e * 1e6 / n_valid,
                 fixed_share=ms_d / ms_e, bound_ns=None,
                 bound_by="not counted here: chip_smoke's kernel_vs_plain "
                          "wl_closest counts its tests")]
    return lines


def run(device="cuda", sizes=None, scene=None, case=None):
    s = dict(SIZES, **(sizes or {}))
    lines = []
    tri = torch.ones((N_TRI_BLOCKS, 4, 128), dtype=torch.float32,
                     device=device)
    made = {}

    def items(n):
        if n not in made:
            made[n] = torch.arange(n, dtype=torch.int32,
                                   device=device) % N_TRI_BLOCKS
        return made[n]

    for fetch in (False, True):
        lines += both_forms(
            device, lambda b, fetch=fetch: lambda n: pr.grid(
                tri, items(n), fetch, blocks=b),
            s["grid"], s["grid_card"], unit="item",
            rate=(lambda n, b: n * 2048 * b) if fetch else None,
            rate_unit="staged B/s" if fetch else None,
            probe="bench_grid_floor", script=f"{SCRIPT}:70", kernel="grid",
            item="B" if fetch else "A",
            shape={"fetch": fetch, "block_bytes": 2048,
                   "blocks": N_TRI_BLOCKS,
                   **({"group": pr.GRID_GROUP,
                       "stages": pr.grid_plan(0)["stages"]}
                      if fetch else {})})

    c_tri = torch.full((K_CL, 16), 0.3, device=device)
    c_rays = torch.full((8, 128), 0.7, device=device)
    lines += both_forms(
        device, lambda b: lambda n: pr.v1(c_tri, c_rays, n, add_u=False,
                                          blocks=b),
        s["mt"], s["mt_card"], unit="rep",
        work=lambda n, b: (53.0 * n * K_CL * 128 * b, 0.0),
        rate=lambda n, b: n * K_CL * 128 * b, rate_unit="pairs/s",
        probe="bench_mt_ceiling", script=f"{SCRIPT}:112", kernel="v1",
        item="C", shape={"triangles": K_CL, "lanes": 128})
    if s["side"]:
        lines += _list_lines(device, case or worklist_case(
            device, s["side"], scene))
    return lines


def main():
    main_of(run)


if __name__ == "__main__":
    main()
