"""Photon mapping and progressive photon mapping (port of
mitsuba_tpu/integrators/photonmap.py; reference src/integrators/
photonmapper/photonmapper.cpp:30, ppm.cpp:32, sppm.cpp:33).

Photons leave the lights as the particle tracer's particles do
(integrators/ptracer.py `_sample_emission`) and walk the scene in
lockstep, one closest-hit query a bounce; every surface vertex is a
deposit. The deposits come back to the host, which keeps the live ones
(as the reference compacts them) and builds a `core/kdtree.py` HashGrid
over them; a density estimate at a camera hit is one 27-cell gather of
the grid on the scene's device.

  * `photonmap_render`: the photon map seen at the first hit.
  * `ppm_render`: passes of it under Hachisuka's shrinking radius
    r_{i+1}^2 = r_i^2 (i + alpha) / (i + 1).
  * `photonmapper_render`: emission, direct light by one light sample, the
    caustic map's estimate and a final gather of the global map.
  * `sppm_render`: per-pixel radii, photon counts and flux (R, N, tau),
    camera hits jittered anew each pass.

Each is a host loop of passes around device work; every random number is
the reference's (render/sampler.py), so a photon takes the reference's
path unless a hit distance differs in its last bits.
"""
from __future__ import annotations

import numpy as np
import torch

from mitsuba_tpu_torch.bsdfs import bsdf_eval, bsdf_sample
from mitsuba_tpu_torch.core import math as m
from mitsuba_tpu_torch.core import warp
from mitsuba_tpu_torch.core.kdtree import HashGrid
from mitsuba_tpu_torch.emitters import eval_emitter_hit, sample_direct
from mitsuba_tpu_torch.integrators.path import PathConfig, camera_samples
from mitsuba_tpu_torch.integrators.ptracer import _sample_emission
from mitsuba_tpu_torch.render.intersect import ray_intersect, ray_test
from mitsuba_tpu_torch.render.records import Ray
from mitsuba_tpu_torch.render.sampler import Sampler


def _eps(p):
    """The reference's self-intersection offset of rays leaving p."""
    return m.EPSILON * torch.clamp(torch.amax(torch.abs(p), dim=-1),
                                   min=1.0)


def _keep(ray: Ray, new: Ray, nxt) -> Ray:
    """The new ray on the lanes that go on, the old one elsewhere (its
    mint and maxt are the new ray's, as the reference's `replace`)."""
    c = nxt[:, None]
    return Ray(torch.where(c, new.o, ray.o), torch.where(c, new.d, ray.d),
               new.mint, new.maxt)


def _host(*xs):
    return [x.cpu().numpy() for x in xs]


def _lane_ids(n, device):
    lane = torch.arange(n, device=device)
    return lane, torch.zeros(n, dtype=torch.int32, device=device)


def shoot_photons(scene, n_photons: int, max_depth: int, seed: int = 0):
    """Trace photons (photonmap.py:36); returns host arrays (pos, power,
    dir_in, normal) of the live surface deposits, depth-major."""
    n = n_photons
    sampler = Sampler(seed ^ 0x9E3779B9, *_lane_ids(n, scene.device))
    u_sel = sampler.next_1d()
    u_pos = sampler.next_2d()
    u_dir = sampler.next_2d()
    u_scatter = sampler.next_stacked_2d(max_depth)
    u_lobe = sampler.next_stacked_1d(max_depth)
    p0, _, d0, beta, active = _sample_emission(scene, u_sel, u_pos, u_dir)
    ray = Ray.make(p0, d0, mint=_eps(p0))
    deps = []
    for k in range(max_depth):
        its = ray_intersect(scene.geom, ray)
        active = active & its.valid
        # power = beta / n_photons at estimate time
        deps.append((its.p, beta, ray.d, its.sh_n, active))
        bs = bsdf_sample(scene.materials, its.material_id, its.wi,
                         u_scatter[k], u_lobe[k])
        wo_world = its.to_world(bs["wo"])
        active = active & bs["valid"]
        beta = beta * torch.where(active[:, None], bs["weight"], 1.0)
        ray = _keep(ray, Ray.make(its.p, wo_world, mint=_eps(its.p)),
                    active)
    pos, power, din, nrm, act = _host(*(torch.cat(x) for x in zip(*deps)))
    return pos[act], power[act], din[act], nrm[act]


def build_photon_grid(pos, power, din, nrm, res: int = 48,
                      max_per_query: int = 27 * 24,
                      device="cpu") -> HashGrid:
    """The HashGrid of deposits, payload power | dir_in | normal."""
    payload = np.concatenate([power, din, nrm], axis=1)   # (P, 9)
    return HashGrid.build(pos, payload, res=res,
                          max_per_query=max_per_query, device=device)


def photon_estimate(scene, grid: HashGrid, its, radius, n_photons):
    """Outgoing radiance at hits from the photon density (diffuse part,
    the reference's estimateRadianceFiltered, photonmap.h:136): photons
    that arrive on the side of the shading normal, over the disc's area.
    radius and n_photons: floats, or float32 tensors, as the reference
    passes them."""
    mclip = torch.clamp(its.material_id, 0,
                        scene.materials.n_materials - 1).long()
    albedo = scene.materials.reflectance[mclip]
    sh_n = its.sh_n

    def contrib(rows, d2):
        side = (m.dot(sh_n[:, None], -rows[..., 3:6]) > 0).to(torch.float32)
        return rows[..., 0:3] * side[..., None]

    flux = grid.gather_sum(its.p, radius, contrib_fn=contrib)
    area = torch.pi * radius * radius
    return albedo * m.INV_PI * flux / (area * n_photons)


def _pm_estimate(scene, grid, ray, radius_d, inv_np):
    its = ray_intersect(scene.geom, ray)
    le = eval_emitter_hit(scene.emitters, its.emitter_id, -ray.d, its.geo_n)
    lr = photon_estimate(scene, grid, its, radius_d, 1.0) * inv_np
    return torch.where(its.valid[:, None], le + lr, 0.0)


def _extent(pos):
    return float(np.linalg.norm(pos.max(0) - pos.min(0))) if len(pos) \
        else 1.0


def _spp_mean(L, scene, spp):
    return L.reshape(scene.height, scene.width, spp, -1).mean(dim=2)


def photonmap_render(scene, cfg: PathConfig, n_photons: int = 200_000,
                     radius: float | None = None, seed: int = 0):
    """The photon map seen at the first hit (photonmap.py:128), radius by
    default 0.015 of the deposits' extent. Returns (image, aux)."""
    pos, power, din, nrm = shoot_photons(scene, n_photons, cfg.max_depth,
                                         seed)
    if radius is None:
        radius = 0.015 * _extent(pos)
    dev = scene.device
    grid = build_photon_grid(pos, power, din, nrm, device=dev)
    ray, _, _, _ = camera_samples(scene, cfg, seed, morton=False)
    L = _pm_estimate(scene, grid, ray,
                     torch.tensor(radius, dtype=torch.float32, device=dev),
                     torch.tensor(1.0 / n_photons, dtype=torch.float32,
                                  device=dev))
    return _spp_mean(L, scene, cfg.spp), {
        "n_photons": n_photons, "radius": radius,
        "n_deposits": int(len(pos))}


def ppm_render(scene, cfg: PathConfig, n_photons_per_pass: int = 100_000,
               n_passes: int = 8, alpha: float = 0.7,
               initial_radius: float | None = None, seed: int = 0):
    """Progressive photon mapping (photonmap.py:161): pass i renders the
    photon map at seed * 131 + i under the shrinking global radius; the
    image is the passes' mean."""
    acc = None
    radius = initial_radius
    for i in range(n_passes):
        pcfg = PathConfig(max_depth=cfg.max_depth, spp=cfg.spp,
                          pattern=cfg.pattern, remat=False)
        img, aux = photonmap_render(scene, pcfg,
                                    n_photons=n_photons_per_pass,
                                    radius=radius, seed=seed * 131 + i)
        if radius is None:
            radius = aux["radius"]
        acc = img if acc is None else acc + img
        radius = float(radius) * float(np.sqrt((i + alpha) / (i + 1)))
    return acc / n_passes, {"final_radius": radius, "passes": n_passes}


def photonmapper_render(scene, cfg: PathConfig, n_photons: int = 150_000,
                        gather_samples: int = 8,
                        radius: float | None = None, seed: int = 0):
    """Photon mapping with a final gather (photonmap.py:183): at each
    camera hit Le + one light sample's direct light + the caustic map's
    estimate + the mean of `gather_samples` cosine rays' global-map
    estimates times the albedo. The caustic map holds the deposits after
    delta bounces alone (bre.py `shoot_photons_media`); it is used when it
    has more than 8."""
    from mitsuba_tpu_torch.integrators.bre import shoot_photons_media
    from mitsuba_tpu_torch.media import no_medium

    pos, power, din, nrm, caustic = shoot_photons_media(
        scene, no_medium(), n_photons, cfg.max_depth, seed)[0]
    if radius is None:
        radius = 0.02 * _extent(pos)
    dev = scene.device
    grid_global = build_photon_grid(pos, power, din, nrm, device=dev)
    grid_caustic = None
    if caustic.sum() > 8:
        grid_caustic = build_photon_grid(pos[caustic], power[caustic],
                                         din[caustic], nrm[caustic],
                                         device=dev)
    ray, sampler, _, _ = camera_samples(scene, cfg, seed, morton=False)
    u_nee1 = sampler.next_1d()
    u_nee2 = sampler.next_2d()
    u_g = sampler.next_stacked_2d(gather_samples)

    geom, mats = scene.geom, scene.materials
    its = ray_intersect(geom, ray)
    le = eval_emitter_hit(scene.emitters, its.emitter_id, -ray.d, its.geo_n)
    ds = sample_direct(scene.emitters, geom, its.p, u_nee1, u_nee2)
    eps = _eps(its.p)
    occ = ray_test(geom, Ray.make(its.p, ds.d, mint=eps,
                                  maxt=ds.dist * (1 - 1e-3)))
    fcos = bsdf_eval(mats, its.material_id, its.wi, its.to_local(ds.d))
    ok = its.valid & ds.valid & ~occ & (ds.pdf > 0)
    direct = torch.where(
        ok[:, None],
        fcos * ds.value / torch.clamp(ds.pdf, min=1e-20)[:, None], 0.0)
    lc = (photon_estimate(scene, grid_caustic, its, radius, n_photons)
          if grid_caustic is not None else torch.zeros_like(direct))
    mclip = torch.clamp(its.material_id, 0, mats.n_materials - 1).long()
    albedo = mats.reflectance[mclip]
    frame = its.frame()
    ind = torch.zeros((its.p.shape[0], 3), device=dev)
    for k in range(gather_samples):
        d_w = frame.to_world(warp.square_to_cosine_hemisphere(u_g[k]))
        gits = ray_intersect(geom, Ray.make(its.p, d_w, mint=eps))
        lg = photon_estimate(scene, grid_global, gits, radius, n_photons)
        ind = ind + torch.where(gits.valid[:, None], lg, 0.0)
    indirect = albedo * ind / gather_samples
    L = torch.where(its.valid[:, None], le + direct + lc + indirect, 0.0)
    return _spp_mean(L, scene, cfg.spp), {
        "n_photons": n_photons, "radius": radius,
        "n_caustic": int(caustic.sum()), "gather": gather_samples}


def _sppm_pass(scene, grid, R, N, tau, direct, pass_seed: int, alpha_d,
               inv_np):
    """One SPPM pass (photonmap.py:279): a jittered camera hit per pixel
    gathers the pass's photons within its own radius R; returns (R', N,
    tau', direct', N')."""
    w, h = scene.width, scene.height
    n = w * h
    dev = scene.device
    pixel_id = torch.arange(n, device=dev)
    px = (pixel_id % w).to(torch.float32)
    py = (pixel_id // w).to(torch.float32)
    sampler = Sampler(pass_seed, pixel_id,
                      torch.zeros(n, dtype=torch.int32, device=dev))
    jitter = sampler.next_2d()
    uv = torch.stack([(px + jitter[:, 0]) / w, (py + jitter[:, 1]) / h],
                     -1)
    ray = scene.camera.sample_ray(uv)
    its = ray_intersect(scene.geom, ray)
    mclip = torch.clamp(its.material_id, 0,
                        scene.materials.n_materials - 1).long()
    albedo = scene.materials.reflectance[mclip]
    sh_n = its.sh_n

    def contrib(rows, d2):
        # arriving on the shading side and deposited on a surface facing
        # the same way (photonmap.h's normal check)
        n = sh_n[:, None]
        side = ((m.dot(n, -rows[..., 3:6]) > 0)
                & (m.dot(n, rows[..., 6:9]) > 0.5)).to(torch.float32)
        return torch.cat([rows[..., 0:3] * side[..., None],
                          side[..., None]], -1)

    g4 = grid.gather_sum(its.p, R, contrib_fn=contrib)
    flux, M = g4[:, 0:3], g4[:, 3]
    M = torch.where(its.valid, M, 0.0)
    N_new = N + alpha_d * M
    ratio = torch.where(M > 0, N_new / torch.clamp(N + M, min=1e-9), 1.0)
    R_new = R * torch.sqrt(ratio)
    phi = albedo * m.INV_PI * flux * inv_np
    tau_new = (tau + torch.where(its.valid[:, None], phi, 0.0)) \
        * ratio[:, None]
    le = eval_emitter_hit(scene.emitters, its.emitter_id, -ray.d, its.geo_n)
    d_new = direct + torch.where(its.valid[:, None], le, 0.0)
    return R_new, N, tau_new, d_new, N_new


def sppm_render(scene, cfg: PathConfig, n_photons_per_pass: int = 100_000,
                n_passes: int = 8, alpha: float = 0.7,
                initial_radius: float | None = None, seed: int = 0):
    """Stochastic progressive photon mapping with per-pixel statistics
    (photonmap.py:330; Hachisuka & Jensen 2009). Pass i shoots photons at
    seed * 131 + 7 i + 1 and jitters the camera hits at seed * 977 + i;
    with M photons gathered, N' = N + alpha M, R' = R sqrt(N' / (N + M)),
    tau' = (tau + albedo / pi Phi / n_photons) (R' / R)^2. The image is
    tau / (pi R^2 passes) plus the mean emitted Le (photons carry direct
    and indirect light). The first radius is 0.01 of the first pass's
    deposit extent, the grid's resolution extent / radius clamped to [4,
    48]."""
    w, h = scene.width, scene.height
    n = w * h
    dev = scene.device
    pos0 = shoot_photons(scene, n_photons_per_pass, cfg.max_depth, seed)[0]
    extent = _extent(pos0)
    r0 = initial_radius if initial_radius is not None else 0.01 * extent
    grid_res = max(4, min(48, int(extent / max(r0, 1e-6))))
    R = torch.full((n,), r0, dtype=torch.float32, device=dev)
    N = torch.zeros(n, device=dev)
    tau = torch.zeros((n, 3), device=dev)
    direct = torch.zeros((n, 3), device=dev)
    alpha_d = torch.tensor(alpha, dtype=torch.float32, device=dev)
    inv_np = torch.tensor(1.0 / n_photons_per_pass, dtype=torch.float32,
                          device=dev)
    for i in range(n_passes):
        pos, power, din, nrm = shoot_photons(
            scene, n_photons_per_pass, cfg.max_depth, seed * 131 + 7 * i + 1)
        grid = build_photon_grid(pos, power, din, nrm, res=grid_res,
                                 device=dev)
        R, _, tau, direct, N = _sppm_pass(scene, grid, R, N, tau, direct,
                                          seed * 977 + i, alpha_d, inv_np)
    L = tau / (torch.pi * torch.clamp(R, min=1e-9)[:, None] ** 2
               * n_passes) + direct / n_passes
    return L.reshape(h, w, 3), {
        "passes": n_passes,
        "mean_radius": float(R.mean()),
        "min_radius": float(R.min()),
        "mean_N": float(N.mean()),
        "radius_map": R.cpu().numpy().reshape(h, w),
    }
