"""The megakernel gather question of scripts/exp_r5_megakernel.py
(pallas_gather :72) on the card: N = 2^20 float32 elements gathered by
int32 index from a K-entry table, K = 512 to 32,768, (a) from the table
staged in shared memory by each block (a 128 KB table at K = 32,768),
(b) from device memory. The inputs are the script's (numpy default_rng(0):
per K the table, then the indices). The card has a per-lane gather, so
neither form needs the TPU's one-hot selection. The whole wavefront is
one launch; there is no per-block form.

    python -m mitsuba_tpu_torch.probes.r5_megakernel
"""
from __future__ import annotations

import numpy as np
import torch

from mitsuba_tpu_torch.ops import probes as pr
from mitsuba_tpu_torch.probes import main_of, measure

SCRIPT = "scripts/exp_r5_megakernel.py:72"
SIZES = dict(n=1 << 20, tables=(512, 2048, 8192, 32768))


def inputs(device, s):
    """{K: (table, idx)}, drawn as the script draws them."""
    rng = np.random.default_rng(0)
    out = {}
    for k in s["tables"]:
        table = rng.random(k).astype(np.float32)
        idx = rng.integers(0, k, s["n"]).astype(np.int32)
        out[k] = (torch.as_tensor(table, device=device),
                  torch.as_tensor(idx, device=device))
    return out


def run(device="cuda", sizes=None):
    s = dict(SIZES, **(sizes or {}))
    lines = []
    for k, (table, idx) in inputs(device, s).items():
        for name, fn in (("gather_smem", pr.gather_smem),
                         ("gather_global", pr.gather_global)):
            lines.append(measure(
                device, lambda _n, fn=fn, table=table, idx=idx: fn(table, idx),
                (s["n"],), unit="element",
                work=lambda n, _b, k=k: (0.0, 8.0 * n + 4.0 * k),
                rate=lambda n, _b: n, rate_unit="elements/s",
                probe="pallas_gather", script=SCRIPT, kernel=name,
                form="wavefront", blocks=None,
                shape={"table": k, "n": s["n"]}))
    return lines


def main():
    main_of(run)


if __name__ == "__main__":
    main()
