"""The staged cost of the refine stage (#5) of scripts/exp_r3_refinebits.py
(pallas_call :60) on the card, at its sizes: R = 8,192 rows, E = 3,072
listed boxes per row out of C = 11,488, 504 live per row.

The TPU script times four stages: (a) the id permutation, the box gathers
and their packing into the kernel's (E/128, 8, 128) layout; (b) + the
kernel; (c) + unpacking the keys; (d) + the key sort. The port's kernel
(ops/exact.py `refine`, csrc/exact.cu) gathers each box by id itself and
writes the keys row-major in list order, so (a) and (c) have no
counterpart; what stands for (b) is the kernel, and for (d) the stable
sort of each row's keys with its ids (`_sorted_prefix`, as the cull runs
it). ops/exact.py launches the kernel once over all rows (the TPU's
R_CHUNK of 320 rows bounds its scalar memory, which the card does not
have), so the port's stages run unchunked.

    python -m mitsuba_tpu_torch.probes.r3_refinebits
"""
from __future__ import annotations

import torch

from mitsuba_tpu_torch.ops import exact as ep
from mitsuba_tpu_torch.probes import bound_ns, card, device_ms, main_of

SCRIPT = "scripts/exp_r3_refinebits.py:60"
SIZES = dict(rows=8192, entries=3072, boxes=11488, live=504)
BOX_OPS = 25


def inputs(device, s, seed: int = 0):
    """The script's inputs (uniform boxes 0.1 wide, uniform ids, uniform
    rays in [0, 1)), drawn from a seeded generator on the device."""
    gen = torch.Generator(device=device).manual_seed(seed)
    blo = torch.rand((s["boxes"], 3), generator=gen, device=device)
    bhi = blo + 0.1
    ids = torch.randint(0, s["boxes"], (s["rows"], s["entries"]),
                        generator=gen, device=device, dtype=torch.int32)
    live = torch.full((s["rows"],), s["live"], dtype=torch.int32,
                      device=device)
    rays = torch.rand((s["rows"], 8, 128), generator=gen, device=device)
    return rays, ids, live, blo, bhi


def run(device="cuda", sizes=None):
    s = dict(SIZES, **(sizes or {}))
    rays, ids, live, blo, bhi = inputs(device, s)
    e = s["entries"]

    def kernel():
        return ep.refine(rays, ids, live, blo, bhi)

    def kernel_sort():
        return ep._sorted_prefix(kernel(), ids, e)

    common = dict(script=SCRIPT, kernel="refine",
                  shape={k: s[k] for k in SIZES}, device=card(device)["name"])
    if torch.device(device).type != "cuda":
        kernel_sort()
        return [dict(common, stage=st, ms=None) for st in ("b", "d")]
    ms_b, ms_d = device_ms(kernel), device_ms(kernel_sort)
    # the kernel's work: a slab test of every lane against each live box
    ops = s["rows"] * s["live"] * 128 * BOX_OPS
    nbytes = (rays.numel() + ids.numel() + live.numel() + blo.numel()
              + bhi.numel() + s["rows"] * e) * 4
    b_ns, b_by = bound_ns(ops, nbytes)
    return [
        dict(common, stage="a", tpu_stage="gather+pack", ms=None,
             port="none: the kernel gathers the boxes by id"),
        dict(common, stage="b", tpu_stage="+kernel", ms=ms_b,
             port="ops/exact.py refine (#5)", bound_ms=b_ns * 1e-6,
             bound_by=b_by),
        dict(common, stage="c", tpu_stage="+unpack", ms=None,
             port="none: the keys come out row-major in list order"),
        dict(common, stage="d", tpu_stage="+sort", ms=ms_d,
             port="+ ops/exact.py _sorted_prefix (stable sort, ids)",
             sort_ms=ms_d - ms_b),
    ]


def main():
    main_of(run)


if __name__ == "__main__":
    main()
