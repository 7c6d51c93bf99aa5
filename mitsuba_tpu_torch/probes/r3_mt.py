"""The Möller–Trumbore inner-loop variants of scripts/exp_r3_mt.py
(run_variant :63) on the card: one resident 32-triangle block against 128
lanes, R reps chained through the accumulator, the slope between two R:

  V0  the FMA ceiling (8 chains of 4 dependent fused multiply-adds);
  V1  csrc/mt.cuh's test in the TPU's `_mt_chunks` form;
  V2  the approximate reciprocal and the packed (t_bits << 2) | chunk
      minimum;
  V3  the script's V2 with its triangle fields broadcast once to (8, 128)
      vregs: registers are per thread on the card, so there is nothing to
      broadcast, and V3 runs V2;
  V4  the division-free accept, the approximate reciprocal only for t.

The inputs are the script's: numpy RandomState(0) for the triangles and
RandomState(1) for the rays. Rates in pairs (ray-triangle tests) per
second, V0 in the script's flop-equivalent pairs (8 * 4 * 8 * 128 per
rep).

    python -m mitsuba_tpu_torch.probes.r3_mt
"""
from __future__ import annotations

import numpy as np
import torch

from mitsuba_tpu_torch.ops import probes as pr
from mitsuba_tpu_torch.probes import both_forms, main_of

SCRIPT = "scripts/exp_r3_mt.py:63"
K_CL = 32
LANES = 128
MT_OPS = 53
SIZES = dict(reps=(8192, 65536), reps_card=(8, 64))


def inputs(device):
    tri = np.random.RandomState(0).rand(1, K_CL, 16).astype(np.float32)[0]
    rays = np.random.RandomState(1).rand(8, LANES).astype(np.float32)
    return (torch.as_tensor(tri, device=device),
            torch.as_tensor(rays, device=device))


def run(device="cuda", sizes=None):
    s = dict(SIZES, **(sizes or {}))
    tri, rays = inputs(device)
    pairs = K_CL * LANES
    variants = (
        ("V0", "v0", lambda b: lambda n: pr.v0(rays, n, blocks=b),
         8 * 4 * 8 * LANES, 2.0 * 8 * 4 * 8 * LANES),
        ("V1", "v1", lambda b: lambda n: pr.v1(tri, rays, n, blocks=b),
         pairs, MT_OPS * pairs),
        ("V2", "v2", lambda b: lambda n: pr.v2(tri, rays, n, blocks=b),
         pairs, MT_OPS * pairs),
        ("V3", "v2", lambda b: lambda n: pr.v2(tri, rays, n, blocks=b),
         pairs, MT_OPS * pairs),
        ("V4", "v4", lambda b: lambda n: pr.v4(tri, rays, n, blocks=b),
         pairs, MT_OPS * pairs),
    )
    lines = []
    for name, kernel, make, per_rep, ops in variants:
        lines += both_forms(
            device, make, s["reps"], s["reps_card"], unit="rep",
            work=lambda n, b, ops=ops: (ops * n * b, 0.0),
            rate=lambda n, b, p=per_rep: p * n * b, rate_unit="pairs/s",
            probe="run_variant", script=SCRIPT, variant=name,
            kernel=kernel, shape={"triangles": K_CL, "lanes": LANES})
    return lines


def main():
    main_of(run)


if __name__ == "__main__":
    main()
