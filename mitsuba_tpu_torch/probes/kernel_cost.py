"""The cost components of scripts/exp_kernel_cost.py on the card, after
the launch floor (a kernel that only counts its launches, the slope of
back-to-back launches: what every step of the script's sequential grid
becomes once it is a launch), in its order (:291-306): the FMA chain
(run_vpu_fma :111), the Möller–Trumbore cluster test at 128 and 32
triangles (run_vpu_mt :188), the (m, 10) x (10, 128) Plücker products at
m = 512 and 4,096 and the (512, 128) x (128, 128) product (run_mm :71),
the gated item loop off and on (run_empty :228) and the rotating 8 KB and
32 KB staging (run_dma_rotate :270). Each as the slope between two step
(or item) counts, per block and over the card; inputs drawn as the script
draws them, from a seed.

The products `mm_cuda`, `mm_tf32` and `mm_bf16` spread each copy over
several blocks (ops/probes.py `mm_plan`; on the card
`shape["blocks_launched"]` records the blocks that each form's launch
ran, as the kernel counts them, `blocks_ran`): their 1-copy line is one
product over the card, no longer a one-SM rate, and carries no
`one_sm_bound_ns`; their 8,192-copy line does the same total work as
before. The staging lines' `shape["stages"]` is rotate's ring.

    python -m mitsuba_tpu_torch.probes.kernel_cost
"""
from __future__ import annotations

import numpy as np
import torch

from mitsuba_tpu_torch.ops import probes as pr
from mitsuba_tpu_torch.probes import both_forms, main_of

SCRIPT = "scripts/exp_kernel_cost.py"
MT_OPS = 53               # float32 operations of one Möller–Trumbore test
# steps (or items) of each slope: the script's 2,048 and 16,384 per block
# where that runs in well under a second, fewer over the card
SIZES = dict(launches=(2048, 16384), fma=(2048, 16384), fma_card=(16, 128),
             n_ops=512, mt=(256, 2048), mt_card=(4, 32), mm=(256, 2048),
             mm_card=(4, 32), items=(2048, 16384), items_card=(256, 2048))
N_BLOCKS = 64             # the blocks run_empty and run_dma_rotate fetch
RPC = 512                 # rows of run_empty's block


def inputs(device, seed: int = 0) -> dict:
    """Every probe's inputs, drawn as the script draws them."""
    rng = np.random.default_rng(seed)

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.float32),
                               device=device)

    return dict(
        fma_a=t(rng.random((8, 128)) * 0.1 + 0.9),
        fma_b=t(rng.random((8, 128)) * 1e-6),
        mt_tri={k: t(rng.random((k, 16))) for k in (128, 32)},
        mt_rays=t(rng.random((8, 128))),
        mm={(m, k): (t(rng.standard_normal((m, k))),
                     t(rng.standard_normal((k, 128))))
            for m, k in ((512, 10), (4096, 10), (512, 128))},
        empty_g=t(rng.standard_normal((N_BLOCKS, RPC, 16))),
        rotate_g={kb: t(rng.standard_normal((N_BLOCKS, kb * 16, 16)))
                  for kb in (8, 32)})


def _lists(device):
    """ids(n, rotate) and flags(n, on): each item list made once per size,
    outside the timed runs."""
    made = {}

    def get(kind, n, arg):
        key = (kind, n, arg)
        if key not in made:
            if kind == "ids":
                ids = torch.arange(n, dtype=torch.int32, device=device)
                made[key] = ids % N_BLOCKS if arg else torch.zeros_like(ids)
            else:
                made[key] = torch.full((n,), int(arg), dtype=torch.int32,
                                       device=device)
        return made[key]
    return get


def run(device="cuda", sizes=None, seed: int = 0):
    s = dict(SIZES, **(sizes or {}))
    x = inputs(device, seed)
    lines = []
    n_ops = s["n_ops"]
    lists = _lists(device)
    counter = torch.zeros(1, dtype=torch.int32, device=device)

    lines += both_forms(
        device, lambda b: lambda n: pr.count(counter, n, blocks=b),
        s["launches"], s["launches"], unit="launch",
        probe="launch floor", script=f"{SCRIPT}:228", kernel="count",
        shape={"threads": 128})

    lines += both_forms(
        device, lambda b: lambda n: pr.fma(x["fma_a"], x["fma_b"], n_ops, n,
                                           blocks=b),
        s["fma"], s["fma_card"], unit="step",
        work=lambda n, b: (2.0 * n * n_ops * 8 * 128 * b, 0.0),
        rate=lambda n, b: n * n_ops * 8 * 128 * b, rate_unit="FMA/s",
        probe="run_vpu_fma", script=f"{SCRIPT}:111", kernel="fma",
        shape={"n_ops": n_ops, "chains": "(8, 128)"},
        peak_fma_per_s=33.5e12)

    for k in (128, 32):
        tri = x["mt_tri"][k]
        lines += both_forms(
            device, lambda b, tri=tri: lambda n: pr.mt(
                tri, x["mt_rays"], n, blocks=b),
            s["mt"], s["mt_card"], unit="step",
            work=lambda n, b, k=k: (MT_OPS * n * k * 128 * b, 0.0),
            rate=lambda n, b, k=k: n * k * 128 * b, rate_unit="tests/s",
            probe="run_vpu_mt", script=f"{SCRIPT}:188", kernel="mt",
            shape={"triangles": k, "lanes": 128})

    for (m, k), (G, M) in x["mm"].items():
        for way in (("cuda",) if k == 10 else ()) + ("tf32", "bf16"):
            def make(b, G=G, M=M, way=way):
                if way == "cuda":
                    return lambda n: pr.mm_cuda(G, M, n, blocks=b)
                return lambda n: pr.mm_tc(G, M, n, way, blocks=b)
            lines += both_forms(
                device, make, s["mm"], s["mm_card"], unit="step",
                work=lambda n, b, m=m, k=k: (2.0 * m * k * 128 * n * b, 0.0),
                rate_unit="flop/s",
                kind="fp32" if way == "cuda" else way,
                probe="run_mm", script=f"{SCRIPT}:71", kernel=f"mm_{way}",
                blocks_of=(lambda f: pr.blocks_ran(f, device)[1])
                if way in pr.TILE_ROWS else None,
                shape={"m": m, "k": k, "n": 128,
                       "k_padded": k if way == "cuda" else max(16, k)})

    for gate in (False, True):
        lines += both_forms(
            device, lambda b, gate=gate: lambda n: pr.gate(
                x["empty_g"], lists("ids", n, False),
                lists("flags", n, gate), blocks=b),
            s["items"], s["items_card"], unit="item",
            probe="run_empty", script=f"{SCRIPT}:228", kernel="gate",
            shape={"gate": "on" if gate else "off", "block": [RPC, 16]})

    for kb in (8, 32):
        g = x["rotate_g"][kb]
        lines += both_forms(
            device, lambda b, g=g: lambda n: pr.rotate(
                g, lists("ids", n, True), blocks=b),
            s["items"], s["items_card"], unit="item",
            rate=lambda n, b, kb=kb: n * kb * 1024 * b,
            rate_unit="staged B/s",
            probe="run_dma_rotate", script=f"{SCRIPT}:270", kernel="rotate",
            shape={"block_kb": kb, "blocks_rotated": N_BLOCKS,
                   "stages": pr.ring_stages(kb * 256)})
    return lines


def main():
    main_of(run)


if __name__ == "__main__":
    main()
