"""Participating media (port of mitsuba_tpu/media/medium.py; reference
src/medium/homogeneous.cpp closed-form sampleDistance / getTransmittance,
src/medium/heterogeneous.cpp:79-96,317 grid densities and Woodcock
tracking, src/volume/gridvolume.cpp and constvolume.cpp).

A `MediumTable` is the one ambient medium that `volpath_trace` is given:
it fills space, homogeneous or a density grid, optionally oriented (a
fiber-axis field) with the Gaussian microflake's directional extinction.
A `MediumStack` holds the media bound to shapes' interiors
(`SceneBuilder.add_medium`), each lane of `volpath_media_trace` carrying
the index of the one it travels through.

Woodcock tracking draws two `jax.random.uniform(k, (N,))` a step, with
the step's keys split off the bounce's key (medium.py:322,574). The keys
are host ints (`render/sampler.py`), so the 64 steps of a bounce launch
only their lanes' work and never sync: every lane runs all 64, as in the
reference, so each lane's result and draws are the same.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from mitsuba_tpu_torch.media.phase import (
    HG, ISOTROPIC, MICROFLAKE_GAUSS, fit_fiber_sigma_t, gauss_fiber_sigma_t,
)
from mitsuba_tpu_torch.render import sampler as rs

HOMOGENEOUS, HETEROGENEOUS = 0, 1
N_WOODCOCK = 64        # Woodcock steps a bounce (medium.py:272,551)
# Woodcock steps whose draws one threefry pass makes: (2 x 8, N) int64
# words, 128 MiB each at N = 2^20, and 1/8 of the draws' launches
WOODCOCK_BLOCK = 8


def _move(table, device):
    return dataclasses.replace(table, **{
        f.name: getattr(table, f.name).to(device)
        for f in dataclasses.fields(table)
        if isinstance(getattr(table, f.name), torch.Tensor)})


@dataclass
class MediumTable:
    sigma_s: torch.Tensor       # (3,) scattering coefficient
    sigma_a: torch.Tensor       # (3,) absorption
    phase_g: torch.Tensor       # () HG anisotropy / Gaussian-flake stddev
    density: torch.Tensor = None        # (D, H, W) grid, or (1, 1, 1)
    world_to_grid: torch.Tensor = None  # (4, 4) world -> (x, y, z) index
    density_scale: torch.Tensor = None  # ()
    max_density: torch.Tensor = None    # () Woodcock majorant, scaled
    # oriented media (heterogeneous.cpp's orientation volume): the fiber
    # axis per cell, (D, H, W, 3) or a constant (1, 1, 1, 3); and the
    # Gaussian flake's fitted σ_t expansion (fit_fiber_sigma_t)
    orientation: torch.Tensor = None
    flake_coeffs: torch.Tensor = None
    kind: int = HOMOGENEOUS
    phase_kind: int = ISOTROPIC
    enabled: bool = False

    @property
    def sigma_t(self):
        return self.sigma_s + self.sigma_a

    @property
    def oriented(self):
        return self.orientation is not None

    def to(self, device) -> "MediumTable":
        return _move(self, device)


def _table(sigma_s, sigma_a, g, **kw) -> MediumTable:
    defaults = dict(density=torch.ones((1, 1, 1)),
                    world_to_grid=torch.eye(4),
                    density_scale=torch.ones(()))
    defaults.update(kw)
    return MediumTable(
        sigma_s=torch.as_tensor(np.asarray(sigma_s, np.float32)),
        sigma_a=torch.as_tensor(np.asarray(sigma_a, np.float32)),
        phase_g=torch.as_tensor(np.float32(g)), **defaults)


def no_medium() -> MediumTable:
    return _table((0.0,) * 3, (0.0,) * 3, 0.0, max_density=torch.zeros(()),
                  kind=HOMOGENEOUS, phase_kind=ISOTROPIC, enabled=False)


def _flake(flake_stddev, g):
    """(phase kind or None, the phase's g, its σ_t coefficients)."""
    if flake_stddev is None:
        return None, g, None
    coeffs, _err = fit_fiber_sigma_t(float(flake_stddev))
    return MICROFLAKE_GAUSS, float(flake_stddev), torch.as_tensor(coeffs)


def make_homogeneous(sigma_s, sigma_a, g: float = 0.0,
                     phase_kind: int = None, flake_stddev: float = None,
                     orientation=None) -> MediumTable:
    """A homogeneous medium, HG-scattering when g != 0 and no phase kind is
    given (medium.py:62); `flake_stddev` makes it a Gaussian-flake medium
    about the constant fiber axis `orientation` (+z without one). Host
    tensors; the integrator moves them to the scene's device."""
    pk = HG if (phase_kind is None and g != 0.0) else (
        phase_kind if phase_kind is not None else ISOTROPIC)
    fk, geff, coeffs = _flake(flake_stddev, g)
    orient = None
    if orientation is not None:
        o = np.asarray(orientation, np.float32).reshape(1, 1, 1, 3)
        orient = torch.as_tensor(o / max(float(np.linalg.norm(o)), 1e-20))
    return _table(sigma_s, sigma_a, geff, max_density=torch.ones(()),
                  orientation=orient, flake_coeffs=coeffs, kind=HOMOGENEOUS,
                  phase_kind=fk if fk is not None else pk, enabled=True)


def make_heterogeneous(density_grid, world_to_grid, sigma_s, sigma_a,
                       density_scale: float = 1.0, g: float = 0.0,
                       orientation=None, flake_stddev: float = None,
                       phase_kind: int = None) -> MediumTable:
    """density_grid: (D, H, W) densities; world_to_grid maps world points
    into grid index space [0, D) x [0, H) x [0, W) (z, y, x order).
    orientation: a fiber axis, (3,) constant or a (D, H, W, 3) field;
    flake_stddev: the Gaussian microflake phase, whose extinction varies
    with direction, sigmaDir = 2 σ_t(cosθ) (microflake.cpp:155)."""
    grid = np.asarray(density_grid, np.float32)
    fk, geff, coeffs = _flake(flake_stddev, g)
    pk = fk if fk is not None else phase_kind
    if pk is None:
        pk = HG if g != 0.0 else ISOTROPIC
    orient = None
    if orientation is not None:
        o = np.asarray(orientation, np.float32)
        if o.ndim == 1:
            o = o.reshape(1, 1, 1, 3)
        nrm = np.linalg.norm(o, axis=-1, keepdims=True)
        orient = torch.as_tensor(o / np.maximum(nrm, 1e-20))
    # sigmaDir peaks at cosθ = 0 (sinθ = 1), where the expansion sums its
    # coefficients: the majorant's directional factor, summed in float32
    # left to right as the reference's reduction sums them
    dir_max = 1.0
    if coeffs is not None:
        acc = np.float32(0.0)
        for c in coeffs.numpy():
            acc = np.float32(acc + c)
        dir_max = 2.0 * float(acc)
    grid_t = torch.as_tensor(grid)
    scale = torch.as_tensor(np.float32(density_scale))
    return MediumTable(
        sigma_s=torch.as_tensor(np.asarray(sigma_s, np.float32)),
        sigma_a=torch.as_tensor(np.asarray(sigma_a, np.float32)),
        phase_g=torch.as_tensor(np.float32(geff)),
        density=grid_t,
        world_to_grid=torch.as_tensor(np.array(world_to_grid, np.float32)),
        density_scale=scale,
        max_density=grid_t.max() * scale * dir_max,
        orientation=orient, flake_coeffs=coeffs, kind=HETEROGENEOUS,
        phase_kind=pk, enabled=True)


def grid_point(m44, p):
    """World points p (N, 3) into grid index space by the (4, 4) or per-
    lane (N, 4, 4) map: each row a chain of fused multiply-adds, m[i,0]
    p0, then + m[i,1] p1, then + m[i,2] p2, each rounded once, then the
    translation, as the reference's einsum rounds on the CPU
    (transform.py apply_point; core/transform.py apply_point_np). A
    float64 product of two float32 values is exact, so the float64 chain
    rounded to float32 after each step is the fused one."""
    r = m44[..., :3, :3].to(torch.float64)
    p64 = p.to(torch.float64)[..., None, :]             # (N, 1, 3)
    acc = (r[..., 0] * p64[..., 0]).to(torch.float32)
    for k in (1, 2):
        acc = (r[..., k] * p64[..., k] + acc.to(torch.float64)).to(
            torch.float32)
    return acc + m44[..., :3, 3]


def _corners(x, y, z, w, h, d):
    """Trilinear cell corners and weights of clamped grid coordinates
    (gridvolume.cpp lookupFloat); the extents are ints, or per-lane int
    tensors (a stack's padded grids)."""
    def lo(c, n):
        if isinstance(n, torch.Tensor):
            return torch.minimum(torch.clamp(torch.floor(c).long(), min=0),
                                 torch.clamp(n - 2, min=0))
        if n > 1:
            return torch.clamp(torch.floor(c).long(), 0, n - 2)
        return torch.zeros_like(c, dtype=torch.int64)

    def hi(c0, n):
        return torch.minimum(c0 + 1, n - 1) if isinstance(
            n, torch.Tensor) else torch.clamp(c0 + 1, max=n - 1)

    x0, y0, z0 = lo(x, w), lo(y, h), lo(z, d)
    return ((x0, hi(x0, w), y0, hi(y0, h), z0, hi(z0, d)),
            (x - x0, y - y0, z - z0))


def _trilerp(flat, idx, f, hs, ws, base=0):
    """The 8-corner sum in the reference's order and rounding
    (medium.py:232-241): corner (z, y, x) of a grid flattened with row
    strides (hs, ws) (ints, or per-lane tensors) from `base`, gathered one
    corner at a time (one (N, 8) gather holds 8x the index words, which a
    32-step ray march of 2^20 lanes cannot afford). f: the (fx, fy, fz)
    weights, with a trailing axis for a vector field."""
    x0, x1, y0, y1, z0, z1 = idx
    fx, fy, fz = f
    gx, gy, gz = 1 - fx, 1 - fy, 1 - fz

    def at(zz, yy, xx):
        return flat[base + (zz * hs + yy) * ws + xx]

    return (at(z0, y0, x0) * gx * gy * gz
            + at(z0, y0, x1) * fx * gy * gz
            + at(z0, y1, x0) * gx * fy * gz
            + at(z0, y1, x1) * fx * fy * gz
            + at(z1, y0, x0) * gx * gy * fz
            + at(z1, y0, x1) * fx * gy * fz
            + at(z1, y1, x0) * gx * fy * fz
            + at(z1, y1, x1) * fx * fy * fz)


def lookup_orientation(med: MediumTable, p):
    """Fiber axis at world points p (N, 3): trilinear, renormalised
    (reference volume.h lookupVector); +z where the field is degenerate
    or absent."""
    zaxis = torch.tensor([0.0, 0.0, 1.0], device=p.device).expand(p.shape)
    if med.orientation is None:
        return zaxis
    if tuple(med.orientation.shape[:3]) == (1, 1, 1):
        return med.orientation[0, 0, 0].expand(p.shape)
    g = grid_point(med.world_to_grid, p)
    d, h, w, _ = med.orientation.shape
    idx, f = _corners(torch.clamp(g[..., 0], 0.0, w - 1.0),
                      torch.clamp(g[..., 1], 0.0, h - 1.0),
                      torch.clamp(g[..., 2], 0.0, d - 1.0), w, h, d)
    v = _trilerp(med.orientation.reshape(-1, 3), idx,
                 tuple(c[..., None] for c in f), h, w)
    ln = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
    return torch.where(ln > 1e-6, v / torch.clamp(ln, min=1e-20), zaxis)


def sigma_dir_factor(med: MediumTable, d, p):
    """The directional extinction factor sigmaDir(cos(d, axis)) =
    2 σ_t(cosθ) of a Gaussian-flake medium, 1 otherwise (microflake.cpp:152:
    'scaled such that replacing an isotropic phase with an isotropic
    microflake causes no changes')."""
    if med.flake_coeffs is None:
        return torch.ones(p.shape[:-1], device=p.device)
    cos_t = torch.sum(d * lookup_orientation(med, p), dim=-1)
    return 2.0 * gauss_fiber_sigma_t(cos_t, med.flake_coeffs)


def lookup_density(med: MediumTable, p):
    """Trilinear density at world points p (N, 3), scaled; 0 outside the
    grid (gridvolume.cpp lookupFloat)."""
    if med.kind == HOMOGENEOUS:
        return torch.ones(p.shape[:-1], device=p.device) * med.density_scale
    g = grid_point(med.world_to_grid, p)
    d, h, w = med.density.shape
    x, y, z = g[..., 0], g[..., 1], g[..., 2]
    inside = ((x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1) & (z >= 0)
              & (z <= d - 1))
    x = torch.clamp(x, 0.0, w - 1.0)
    y = torch.clamp(y, 0.0, h - 1.0)
    z = torch.clamp(z, 0.0, d - 1.0)
    idx, f = _corners(x, y, z, w, h, d)
    c = _trilerp(med.density.reshape(-1), idx, f, h, w)
    return torch.where(inside, c * med.density_scale, 0.0)


def medium_transmittance(med: MediumTable, o, d, dist, n_steps: int = 32):
    """Transmittance along the segments [o, o + d dist] (reference
    Medium::getTransmittance, medium.h:141): exp(-σ_t dist) when
    homogeneous; a grid medium integrates its optical depth by composite
    midpoint ray marching over n_steps points (heterogeneous.cpp's
    ray-marching branch), a flake medium's density scaled by sigmaDir."""
    if not med.enabled:
        return torch.ones(o.shape[:-1] + (3,), dtype=o.dtype,
                          device=o.device)
    if med.kind == HOMOGENEOUS:
        return torch.exp(-med.sigma_t[None, :] * dist[..., None])
    ts = (torch.arange(n_steps, device=o.device) + 0.5) / n_steps
    pts = o[:, None, :] + d[:, None, :] * (dist[:, None] * ts[None, :])[
        ..., None]
    flat = pts.reshape(-1, 3)
    rho = lookup_density(med, flat)
    if med.flake_coeffs is not None:
        rho = rho * sigma_dir_factor(
            med, d.repeat_interleave(n_steps, dim=0), flat)
    tau = rho.reshape(o.shape[0], n_steps).sum(dim=1) * (dist / n_steps)
    return torch.exp(-med.sigma_t[None, :] * tau[..., None])


def woodcock_keys(k, n_steps: int = N_WOODCOCK):
    """The keys of each Woodcock step: k, k1, k2 = split(k, 3), 64 times
    (medium.py:322); a list of (k1, k2) host keys."""
    out = []
    for _ in range(n_steps):
        k, k1, k2 = rs.split(k, 3)
        out.append((k1, k2))
    return out


def _woodcock(key, n, sig_m, st_max, max_dist, o, d, density_at,
              n_woodcock):
    """Delta tracking against the majorant sig_m ((N,) or ()): each step
    draws a free flight and accepts a real collision with probability
    ρ σ_max / σ̄ (heterogeneous.cpp:317). The draws do not depend on the
    state, so WOODCOCK_BLOCK steps' draws come from one threefry pass;
    each step's arithmetic is the reference's. Returns (t, accept)."""
    dev = o.device
    t = torch.zeros(n, device=dev)
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    accept = torch.zeros(n, dtype=torch.bool, device=dev)
    keys = woodcock_keys(key, n_woodcock)
    for b0 in range(0, n_woodcock, WOODCOCK_BLOCK):
        blk = keys[b0:b0 + WOODCOCK_BLOCK]
        u = rs.uniform_keys([k for pair in blk for k in pair], n, dev)
        flight = -torch.log(torch.clamp(1.0 - u[0::2], min=1e-20))
        for j in range(len(blk)):
            t_new = t + flight[j] / sig_m
            escaped = t_new >= max_dist
            p = o + d * torch.minimum(t_new, max_dist)[:, None]
            rho = density_at(p)
            real = u[2 * j + 1] < (rho * st_max / sig_m)
            newly_escaped = ~done & escaped
            newly_real = ~done & ~escaped & real
            t = torch.where(done, t, t_new)
            accept = accept | newly_real
            done = done | newly_escaped | newly_real
    return t, accept


def sample_distance(med: MediumTable, o, d, max_dist, u_channel, u_dist,
                    key=None, n_woodcock: int = N_WOODCOCK):
    """Sample a medium interaction along rays (reference
    Medium::sampleDistance, medium.h:110). Returns dict(valid: interacted
    before max_dist, t, p, weight (N, 3), surface_weight (N, 3)): `weight`
    multiplies the throughput on a medium event, `surface_weight` when the
    surface is reached. A grid medium runs Woodcock tracking from the
    host key `key` (render/sampler.py)."""
    n = o.shape[0]
    if not med.enabled:
        ones = torch.ones((n, 3), dtype=o.dtype, device=o.device)
        return dict(valid=torch.zeros(n, dtype=torch.bool, device=o.device),
                    t=max_dist, p=o + d * max_dist[:, None], weight=ones,
                    surface_weight=ones)
    sigma_t = med.sigma_t
    if med.kind == HOMOGENEOUS:
        # channel-stratified exponential sampling (reference
        # homogeneous.cpp strategy EBalance): a channel picked uniformly,
        # pdf = the mean over them
        ch = torch.clamp((u_channel * 3).to(torch.int32), 0, 2).long()
        st_ch = sigma_t[ch]
        st_div = torch.where(st_ch > 0, st_ch, 1.0)
        t_raw = -torch.log(torch.clamp(1.0 - u_dist, min=1e-20)) / st_div
        t = torch.where(st_ch > 0, t_raw, max_dist)
        valid = (t < max_dist) & (st_ch > 0)
        t_clamped = torch.minimum(t, max_dist)
        tr = torch.exp(-sigma_t[None, :] * t_clamped[:, None])    # (N, 3)
        pdf_t = torch.mean(sigma_t[None, :] * tr, dim=1)
        tr_max = torch.exp(-sigma_t[None, :] * max_dist[:, None])
        pdf_surf = torch.mean(tr_max, dim=1)
        weight = med.sigma_s[None, :] * tr / torch.clamp(
            pdf_t, min=1e-20)[:, None]
        surface_weight = tr_max / torch.clamp(pdf_surf, min=1e-20)[:, None]
        return dict(valid=valid, t=t_clamped, p=o + d * t_clamped[:, None],
                    weight=weight, surface_weight=surface_weight)
    if key is None:
        raise ValueError("Woodcock tracking needs a key")
    # majorant: the largest channel's extinction times the largest scaled
    # density (for flake media max_density holds sigmaDir's peak)
    st_max = torch.amax(sigma_t)
    sig_m = torch.clamp(st_max * med.max_density, min=1e-6)

    def density_at(p):
        rho = lookup_density(med, p)
        if med.flake_coeffs is not None:
            rho = rho * sigma_dir_factor(med, d, p)
        return rho

    t, accept = _woodcock(key, n, sig_m, st_max, max_dist, o, d,
                          density_at, n_woodcock)
    t = torch.where(accept, t, max_dist)
    # analog tracking: weight = sigma_s / max sigma_t (exact for gray
    # media)
    weight = (med.sigma_s / torch.clamp(st_max, min=1e-8)).expand(n, 3)
    return dict(valid=accept, t=t, p=o + d * t[:, None], weight=weight,
                surface_weight=torch.ones((n, 3), device=o.device))


# ---------------------------------------------------------------------------
# Shape-interior media (reference Shape::setInteriorMedium; media bind to
# shapes in the scene file): a small stack of media, each lane carrying
# the index of its current one (-1: vacuum). Grid media are padded to a
# common shape and stacked, with per-lane majorants.
# ---------------------------------------------------------------------------

@dataclass
class MediumStack:
    sigma_s: torch.Tensor       # (K, 3)
    sigma_a: torch.Tensor       # (K, 3)
    phase_g: torch.Tensor       # (K,)
    grid_id: torch.Tensor = None        # (K,) index into grids, -1: none
    grids: torch.Tensor = None          # (NG, D, H, W) padded densities
    grid_dims: torch.Tensor = None      # (NG, 3) true (D, H, W)
    world_to_grid: torch.Tensor = None  # (NG, 4, 4)
    density_scale: torch.Tensor = None  # (NG,)
    max_density: torch.Tensor = None    # (NG,) scaled Woodcock majorant
    has_hetero: bool = False

    @property
    def n_media(self):
        return self.sigma_s.shape[0]

    def to(self, device) -> "MediumStack":
        return _move(self, device)


def make_medium_stack(media) -> MediumStack:
    """media: a list of (sigma_s, sigma_a, g) triples or of dicts
    {sigma_s, sigma_a, g, density (D, H, W), world_to_grid,
    density_scale}. Host tensors."""
    if not media:
        return MediumStack(sigma_s=torch.zeros((0, 3)),
                           sigma_a=torch.zeros((0, 3)),
                           phase_g=torch.zeros((0,)))
    norm = [m_ if isinstance(m_, dict)
            else dict(sigma_s=m_[0], sigma_a=m_[1], g=m_[2])
            for m_ in media]

    def col(key, default=None):
        return torch.as_tensor(np.asarray(
            [m_.get(key, default) for m_ in norm], np.float32))

    ss, sa, g = col("sigma_s"), col("sigma_a"), col("g", 0.0)
    het = [m_ for m_ in norm if m_.get("density") is not None]
    if not het:
        return MediumStack(sigma_s=ss, sigma_a=sa, phase_g=g)
    gid = np.full(len(norm), -1, np.int32)
    dims = np.asarray([np.asarray(m_["density"]).shape for m_ in het])
    dmax, hmax, wmax = dims.max(axis=0)
    grids = np.zeros((len(het), dmax, hmax, wmax), np.float32)
    w2g = np.zeros((len(het), 4, 4), np.float32)
    scale = np.zeros(len(het), np.float32)
    maxd = np.zeros(len(het), np.float32)
    j = 0
    for i, m_ in enumerate(norm):
        if m_.get("density") is None:
            continue
        dgrid = np.asarray(m_["density"], np.float32)
        dz, dy, dx = dgrid.shape
        grids[j, :dz, :dy, :dx] = dgrid
        w2g[j] = np.asarray(m_["world_to_grid"], np.float32)
        sc = float(m_.get("density_scale", 1.0))
        scale[j] = sc
        maxd[j] = float(dgrid.max()) * sc
        gid[i] = j
        j += 1
    return MediumStack(
        sigma_s=ss, sigma_a=sa, phase_g=g, grid_id=torch.as_tensor(gid),
        grids=torch.as_tensor(grids),
        grid_dims=torch.as_tensor(dims.astype(np.int32)),
        world_to_grid=torch.as_tensor(w2g),
        density_scale=torch.as_tensor(scale),
        max_density=torch.as_tensor(maxd), has_hetero=True)


def _lane_grid(stack: MediumStack, cur):
    """Each lane's grid index (-1: none) and its clamped gather index."""
    kc = torch.clamp(cur, 0, stack.n_media - 1).long()
    gid = torch.where(cur >= 0, stack.grid_id[kc], -1)
    return gid, torch.clamp(gid, 0, stack.grids.shape[0] - 1).long()


def _stack_lanes(stack: MediumStack, cur):
    """Each lane's grid parameters, gathered once for the lookups of a
    bounce (the lane's medium does not change within it)."""
    gid, gc = _lane_grid(stack, cur)
    dims = stack.grid_dims[gc]                           # (N, 3) D, H, W
    _, dmax, hmax, wmax = stack.grids.shape
    return dict(gid=gid, m44=stack.world_to_grid[gc], dims=dims.long(),
                fdims=dims.float(), scale=stack.density_scale[gc],
                base=gc * (dmax * hmax * wmax))


def stack_lookup_density(stack: MediumStack, cur, p, lanes=None):
    """Per-lane density multiplier at world points p (N, 3): 1 for
    homogeneous and vacuum lanes, the trilinear lookup (0 outside) for a
    lane inside a grid medium. lanes: _stack_lanes(stack, cur), where the
    caller has it."""
    n = cur.shape[0]
    if not stack.has_hetero:
        return torch.ones(n, device=p.device)
    ln = lanes if lanes is not None else _stack_lanes(stack, cur)
    gpt = grid_point(ln["m44"], p)
    dpf, htf, wdf = ln["fdims"].unbind(-1)
    x, y, z = gpt[:, 0], gpt[:, 1], gpt[:, 2]
    inside = ((x >= 0) & (x <= wdf - 1) & (y >= 0) & (y <= htf - 1)
              & (z >= 0) & (z <= dpf - 1))
    x = torch.minimum(torch.clamp(x, min=0.0), wdf - 1.0)
    y = torch.minimum(torch.clamp(y, min=0.0), htf - 1.0)
    z = torch.minimum(torch.clamp(z, min=0.0), dpf - 1.0)
    dp, ht, wd = ln["dims"].unbind(-1)
    idx, f = _corners(x, y, z, wd, ht, dp)
    _, _, hmax, wmax = stack.grids.shape
    c = _trilerp(stack.grids.reshape(-1), idx, f, hmax, wmax, ln["base"])
    rho = torch.where(inside, c * ln["scale"], 0.0)
    return torch.where(ln["gid"] >= 0, rho, 1.0)


def stack_is_hetero(stack: MediumStack, cur):
    """Per lane: its current medium is grid-driven."""
    if stack is None or not stack.has_hetero:
        return torch.zeros(cur.shape[0], dtype=torch.bool,
                           device=cur.device)
    kc = torch.clamp(cur, 0, stack.n_media - 1).long()
    return (cur >= 0) & (stack.grid_id[kc] >= 0)


def stack_params(stack: MediumStack, cur):
    """Per-lane (sigma_s, sigma_a, g, inside) for medium index cur (N,)
    (-1: vacuum, zeros). An index gather (the reference's one-hot product
    gives the same values); the where() keeps masked lanes' cotangents
    out of the parameters' gradient (medium.py:503)."""
    n = cur.shape[0]
    if stack is None or stack.n_media == 0:
        z = torch.zeros((n, 3), device=cur.device)
        return z, z, torch.zeros(n, device=cur.device), torch.zeros(
            n, dtype=torch.bool, device=cur.device)
    kc = torch.clamp(cur, 0, stack.n_media - 1).long()
    inside = cur >= 0
    gate = inside[:, None]
    ss = torch.where(gate, stack.sigma_s[kc], 0.0)
    sa = torch.where(gate, stack.sigma_a[kc], 0.0)
    g = torch.where(inside, stack.phase_g[kc], 0.0)
    return ss, sa, g, inside


def stack_sample_distance(ss, sa, max_dist, u_channel, u_dist):
    """Per-lane closed-form homogeneous distance sampling (sample_distance's
    homogeneous branch with (N, 3) sigmas). The sampled distance and the
    sampling pdfs are detached decisions: sigma's gradient flows only
    through the re-evaluated sigma_s · Tr (medium.py:518)."""
    st = ss + sa
    ch = torch.clamp((u_channel * 3).to(torch.int32), 0, 2).long()
    st_ch = torch.take_along_dim(st, ch[:, None], dim=1)[:, 0]
    st_div = torch.where(st_ch > 0, st_ch, 1.0)
    t_raw = -torch.log(torch.clamp(1.0 - u_dist, min=1e-20)) / st_div
    t = torch.where(st_ch > 0, t_raw, max_dist)
    max_d = max_dist.detach()
    t_cl = torch.minimum(t, max_d).detach()
    valid = (t < max_d).detach() & (st_ch > 0)
    tr = torch.exp(-st * t_cl[:, None])
    pdf_t = torch.mean(st * tr, dim=1).detach()
    tr_max = torch.exp(-st * max_d[:, None])
    pdf_surf = torch.mean(tr_max, dim=1).detach()
    weight = ss * tr / torch.clamp(pdf_t, min=1e-20)[:, None]
    surface_weight = tr_max / torch.clamp(pdf_surf, min=1e-20)[:, None]
    return dict(valid=valid, t=t_cl, weight=weight,
                surface_weight=surface_weight)


def stack_transmittance(ss, sa, dist):
    """exp(-sigma_t dist) per lane (homogeneous closed form)."""
    return torch.exp(-(ss + sa) * dist[:, None])


def stack_sample_distance_het(stack: MediumStack, cur, ss, sa, o, d,
                              max_dist, u_channel, u_dist, key,
                              n_woodcock: int = N_WOODCOCK):
    """stack_sample_distance with grid media: homogeneous lanes keep the
    closed form, lanes inside a grid medium run Woodcock tracking with
    their own majorant (heterogeneous.cpp:317), analog weight sigma_s /
    max-channel sigma_t. `key`: a host key."""
    base = stack_sample_distance(ss, sa, max_dist, u_channel, u_dist)
    if stack is None or not stack.has_hetero:
        return base
    n = cur.shape[0]
    is_het = stack_is_hetero(stack, cur)
    _, gc = _lane_grid(stack, cur)
    st_max = torch.amax((ss + sa).detach(), dim=1)
    sig_m = torch.clamp(st_max * stack.max_density[gc], min=1e-6)
    max_d = max_dist.detach()
    lanes = _stack_lanes(stack, cur)
    t, accept = _woodcock(
        key, n, sig_m, st_max, max_d, o, d,
        lambda p: stack_lookup_density(stack, cur, p, lanes).detach(),
        n_woodcock)
    t = torch.where(accept, t, max_d).detach()
    w_het = ss / torch.clamp(st_max, min=1e-8)[:, None]
    return dict(
        valid=torch.where(is_het, accept, base["valid"]),
        t=torch.where(is_het, t, base["t"]),
        weight=torch.where(is_het[:, None], w_het, base["weight"]),
        surface_weight=torch.where(is_het[:, None], 1.0,
                                   base["surface_weight"]))


def stack_transmittance_het(stack: MediumStack, cur, ss, sa, o, d, dist,
                            n_steps: int = 16):
    """stack_transmittance with grid media: a grid lane integrates its
    optical depth by composite-midpoint ray marching (heterogeneous.cpp's
    ray-marching branch)."""
    base = stack_transmittance(ss, sa, dist)
    if stack is None or not stack.has_hetero:
        return base
    is_het = stack_is_hetero(stack, cur)
    ts = (torch.arange(n_steps, device=o.device) + 0.5) / n_steps
    pts = o[:, None, :] + d[:, None, :] * (dist[:, None] * ts[None, :])[
        ..., None]
    rho = stack_lookup_density(stack, cur.repeat_interleave(n_steps),
                               pts.reshape(-1, 3)).reshape(o.shape[0],
                                                           n_steps)
    tau = rho.mean(dim=1) * dist
    het_tr = torch.exp(-(ss + sa) * tau[:, None])
    return torch.where(is_het[:, None], het_tr, base)
