"""Ray rows and conservative row intervals (port of
mitsuba_tpu/ops/worklist_pallas.py `_pack_rays`, `_interval_mul`,
`_row_intervals` and `_interval_slab`).

The cluster intersectors work on rows of 128 lanes: a wavefront of N rays
becomes (ceil(N/128), 8, 128) planes o.xyz | d.xyz | mint | maxt, the tail
padded with dead lanes (o = 0, d = +z, mint = 0, maxt = -1). A row's
conservative interval (origin box, reciprocal-direction box, the largest
positive maxt) bounds every lane of the row; boxes that fail its slab test
cannot be hit by any lane. Plain PyTorch, on any device.
"""
from __future__ import annotations

import torch

LANES = 128
BIG = 3e38


def pack_rays(o, d, mint, maxt):
    """(N,3),(N,3),(N,),(N,) -> (rays (R, 8, 128), n, R)."""
    n = o.shape[0]
    n_rows = -(-n // LANES)
    pad = n_rows * LANES - n

    def plane(x, fill):
        if pad:
            x = torch.cat([x, x.new_full((pad,), fill)])
        return x.reshape(n_rows, LANES)

    rays = torch.stack([
        plane(o[:, 0], 0.0), plane(o[:, 1], 0.0), plane(o[:, 2], 0.0),
        plane(d[:, 0], 0.0), plane(d[:, 1], 0.0), plane(d[:, 2], 1.0),
        plane(mint, 0.0), plane(maxt, -1.0),
    ], dim=1).contiguous()
    return rays, n, n_rows


def _interval_mul(alo, ahi, blo, bhi):
    p1, p2, p3, p4 = alo * blo, alo * bhi, ahi * blo, ahi * bhi
    return (torch.minimum(torch.minimum(p1, p2), torch.minimum(p3, p4)),
            torch.maximum(torch.maximum(p1, p2), torch.maximum(p3, p4)))


def row_intervals(rays):
    """Per-row conservative intervals of the packed rays:
    (olo, ohi, ilo, ihi, spans, mt_hi), each (R, 3) or (R,)."""
    olo = rays[:, 0:3].amin(dim=2)
    ohi = rays[:, 0:3].amax(dim=2)
    dlo = rays[:, 3:6].amin(dim=2)
    dhi = rays[:, 3:6].amax(dim=2)
    mt = rays[:, 7]
    mt_hi = torch.where(mt > 0, mt, 0.0).amax(dim=1)
    spans = (dlo <= 0) & (dhi >= 0)
    safe_lo = torch.where(spans, 1.0, dlo)
    safe_hi = torch.where(spans, 1.0, dhi)
    ilo = torch.clamp(torch.minimum(1.0 / safe_lo, 1.0 / safe_hi), -BIG, BIG)
    ihi = torch.clamp(torch.maximum(1.0 / safe_lo, 1.0 / safe_hi), -BIG, BIG)
    return olo, ohi, ilo, ihi, spans, mt_hi


def interval_slab(bmin, bmax, olo, ohi, ilo, ihi, spans, mt_hi):
    """Conservative slab test of the row intervals against boxes
    bmin/bmax (R, B, 3) or (B, 3). Returns (hit, t_near), each (R, B)."""
    a_lo = bmin - ohi[:, None]
    a_hi = bmin - olo[:, None]
    b_lo = bmax - ohi[:, None]
    b_hi = bmax - olo[:, None]
    ta_lo, ta_hi = _interval_mul(a_lo, a_hi, ilo[:, None], ihi[:, None])
    tb_lo, tb_hi = _interval_mul(b_lo, b_hi, ilo[:, None], ihi[:, None])
    ent = torch.minimum(ta_lo, tb_lo)
    ext = torch.maximum(ta_hi, tb_hi)
    ent = torch.where(spans[:, None], -BIG, ent)
    ext = torch.where(spans[:, None], BIG, ext)
    t_near = torch.clamp(ent.amax(dim=-1), min=0.0)
    t_far = torch.minimum(ext.amin(dim=-1), mt_hi[:, None])
    return t_near <= t_far, t_near
