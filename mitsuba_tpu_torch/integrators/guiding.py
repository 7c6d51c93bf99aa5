"""Wavefront path guiding: a spatial-directional radiance guide (port of
mitsuba_tpu/integrators/guiding.py; a capability beyond the reference,
after "Path Guiding for Wavefront Path Tracing", arXiv:2405.06997, and
Müller et al.'s practical path guiding).

The guide is a dense res³ grid of cells, each a histogram over N_Z x
N_PHI equal-solid-angle (cos θ, φ) bins, so a bin's share of its cell's
mass times B / 4π is the pdf. Learning is one scatter-add a bounce
(`index_add`; on the card it adds in atomic order, so the learned mass
differs from the reference's in the last bits); sampling and the pdf
invert each lane's gathered row. Rendering stays unbiased for any guide
content: `volpath_trace` draws from the α·phase + (1-α)·guide mixture, and
`path_trace` (surface guiding) from the α·BSDF + (1-α)·guide mixture,
each weighting by the mixture's pdf. `make_guide` and `scene_guide` put
the grid on the card unless the caller passes device="cpu".
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch

N_Z = 8
N_PHI = 16
N_BINS = N_Z * N_PHI


@dataclass
class GuideGrid:
    mass: torch.Tensor          # (C, B) accumulated radiance-weighted hits
    bmin: torch.Tensor          # (3,)
    bmax: torch.Tensor          # (3,)
    res: int = 16

    @property
    def n_cells(self):
        return self.res ** 3

    def to(self, device) -> "GuideGrid":
        return GuideGrid(self.mass.to(device), self.bmin.to(device),
                         self.bmax.to(device), self.res)


def make_guide(bmin, bmax, res: int = 16, device="cuda") -> GuideGrid:
    """An empty res³ grid over the box [bmin, bmax] on `device` (the card
    by default; without a CUDA device that raises)."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run on the CPU")
    return GuideGrid(
        mass=torch.zeros((res ** 3, N_BINS), device=device),
        bmin=torch.as_tensor(bmin, dtype=torch.float32, device=device),
        bmax=torch.as_tensor(bmax, dtype=torch.float32, device=device),
        res=res)


def scene_guide(scene, res: int = 16) -> GuideGrid:
    """An empty guide on the scene's device over its triangle-vertex box,
    padded by 1% of its extent (volpath.py:319-322, path.py:1028-1031)."""
    v0 = scene.geom.v0.detach().cpu().numpy()
    ext = v0.max(0) - v0.min(0)
    return make_guide(v0.min(0) - 0.01 * ext, v0.max(0) + 0.01 * ext,
                      res=res, device=scene.device)


def _cell_of(g: GuideGrid, p):
    q = torch.clamp((p - g.bmin) / torch.clamp(g.bmax - g.bmin, min=1e-6)
                    * g.res, 0, g.res - 1).to(torch.int64)
    return (q[..., 0] * g.res + q[..., 1]) * g.res + q[..., 2]


def _bin_of(d):
    z = torch.clamp(d[..., 2], -1.0, 1.0 - 1e-7)
    iz = torch.clamp(((z + 1.0) * 0.5 * N_Z).to(torch.int64), 0, N_Z - 1)
    phi = torch.atan2(d[..., 1], d[..., 0])             # [-π, π]
    ip = torch.clamp(((phi / (2.0 * math.pi) + 0.5) * N_PHI).to(
        torch.int64), 0, N_PHI - 1)
    return iz * N_PHI + ip


def guide_update(g: GuideGrid, p, d, radiance, active) -> GuideGrid:
    """Deposit the radiance arriving at p from direction d (one masked
    scatter-add)."""
    w = torch.where(active, radiance, 0.0)
    idx = _cell_of(g, p) * N_BINS + _bin_of(d)
    flat = g.mass.reshape(-1).index_add(0, idx, w)
    return dataclasses.replace(g, mass=flat.reshape(g.mass.shape))


def _bin_dirs(device):
    """The bins' centre directions (B, 3)."""
    iz = torch.arange(N_Z, device=device).repeat_interleave(N_PHI)
    ip = torch.arange(N_PHI, device=device).repeat(N_Z)
    z = -1.0 + (iz + 0.5) * (2.0 / N_Z)
    phi = -math.pi + (ip + 0.5) * (2.0 * math.pi / N_PHI)
    s = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return torch.stack([s * torch.cos(phi), s * torch.sin(phi), z], -1)


def _product_rows(rows, normal):
    """Per-lane product reweighting: the radiance histogram times the
    clamped cosine to the shading normal (guiding.py:99)."""
    if normal is None:
        return rows
    cosw = torch.clamp(normal @ _bin_dirs(rows.device).T, min=0.0) + 1e-3
    return rows * cosw


def guide_pdf(g: GuideGrid, p, d, normal=None):
    """Solid-angle pdf of d under the cell's histogram (0 where the cell
    has no mass)."""
    rows = _product_rows(g.mass[_cell_of(g, p)], normal)    # (N, B)
    total = rows.sum(dim=-1)
    frac = torch.take_along_dim(rows, _bin_of(d)[..., None], dim=-1)[..., 0]
    return torch.where(total > 0, frac / torch.clamp(total, min=1e-20)
                       * (N_BINS / (4.0 * math.pi)), 0.0)


def guide_sample(g: GuideGrid, p, u2, u_bin, normal=None):
    """d ~ the cell's histogram: the bin by inverting its cdf with u_bin,
    then uniform within the bin's (z, φ) rectangle. Returns (d, pdf, ok),
    ok False where the cell is empty."""
    rows = _product_rows(g.mass[_cell_of(g, p)], normal)    # (N, B)
    total = rows.sum(dim=-1, keepdim=True)
    ok = total[..., 0] > 0
    cdf = torch.cumsum(rows, dim=-1) / torch.clamp(total, min=1e-20)
    k = torch.sum((cdf < u_bin[..., None]).to(torch.int64), dim=-1)
    k = torch.clamp(k, 0, N_BINS - 1)
    iz = k // N_PHI
    ip = k % N_PHI
    z = -1.0 + (iz.to(torch.float32) + u2[..., 0]) * (2.0 / N_Z)
    z = torch.clamp(z, -1.0 + 1e-6, 1.0 - 1e-6)
    phi = (-math.pi) + (ip.to(torch.float32) + u2[..., 1]) \
        * (2.0 * math.pi / N_PHI)
    s = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    d = torch.stack([s * torch.cos(phi), s * torch.sin(phi), z], dim=-1)
    frac = torch.take_along_dim(rows, k[..., None], dim=-1)[..., 0] \
        / torch.clamp(total[..., 0], min=1e-20)
    pdf = frac * (N_BINS / (4.0 * math.pi))
    return d, torch.where(ok, pdf, 0.0), ok
