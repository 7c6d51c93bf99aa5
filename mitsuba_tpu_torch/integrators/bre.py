"""Volume photon mapping and the beam radiance estimate (port of
mitsuba_tpu/integrators/bre.py; reference gatherproc.h:34 volume photons,
photonmapper/bre.cpp BeamRadianceEstimator).

Photons walk through a homogeneous or grid medium: at each step a medium
event is sampled before the surface hit (media/medium.py
`sample_distance`); a medium event deposits a volume photon and scatters
by the phase function, a surface hit deposits a surface photon and
scatters by the BSDF. A camera ray's in-scattered radiance is marched at
n_march stratified points, each a 27-cell gather of the volume photons'
HashGrid with a 3-D Epanechnikov kernel, as the reference marches it in
place of its kd-tree of photon discs.
"""
from __future__ import annotations

import numpy as np
import torch

from mitsuba_tpu_torch.bsdfs import bsdf_sample
from mitsuba_tpu_torch.core.kdtree import HashGrid
from mitsuba_tpu_torch.emitters import eval_emitter_hit
from mitsuba_tpu_torch.integrators.path import PathConfig, camera_samples
from mitsuba_tpu_torch.integrators.photonmap import (
    _eps, _extent, _host, _keep, _lane_ids, _spp_mean, build_photon_grid,
    photon_estimate,
)
from mitsuba_tpu_torch.integrators.ptracer import _sample_emission
from mitsuba_tpu_torch.media.medium import (
    medium_transmittance, sample_distance,
)
from mitsuba_tpu_torch.media.phase import phase_eval, phase_sample
from mitsuba_tpu_torch.render.intersect import ray_intersect
from mitsuba_tpu_torch.render.records import Ray
from mitsuba_tpu_torch.render.sampler import Sampler


def shoot_photons_media(scene, medium, n_photons: int, max_depth: int,
                        seed: int = 0):
    """The photon walk through a medium (bre.py:36). Returns host arrays
    (surface, volume): surface = (pos, power, dir_in, normal, caustic),
    caustic where every earlier surface bounce was a delta one and there
    was at least one (gatherproc.h:34 ECausticPhotons); volume = (pos,
    power, dir_in) of the scattering medium events inside the scene's
    box grown by 5%."""
    n = n_photons
    dev = scene.device
    medium = medium.to(dev)
    sampler = Sampler(seed ^ 0xBEEF1234, *_lane_ids(n, dev))
    u_sel = sampler.next_1d()
    u_pos = sampler.next_2d()
    u_dir = sampler.next_2d()
    u_scatter = sampler.next_stacked_2d(max_depth)
    u_lobe = sampler.next_stacked_1d(max_depth)
    u_mch = sampler.next_stacked_1d(max_depth)
    u_mdist = sampler.next_stacked_1d(max_depth)
    u_ph = sampler.next_stacked_2d(max_depth)
    p0, _, d0, beta, active = _sample_emission(scene, u_sel, u_pos, u_dir)
    ray = Ray.make(p0, d0, mint=_eps(p0))

    # deposits outside the scene's box could never be gathered
    v0 = scene.geom.v0.cpu().numpy()
    vmax = v0 + scene.geom.e1.cpu().numpy() + scene.geom.e2.cpu().numpy()
    margin = 0.05 * float(np.linalg.norm(vmax.max(0) - v0.min(0)) + 1e-6)
    bmin = torch.as_tensor(np.asarray(v0.min(0) - margin, np.float32),
                           device=dev)
    bmax = torch.as_tensor(np.asarray(vmax.max(0) + margin, np.float32),
                           device=dev)
    scatters = bool((medium.sigma_s > 0).any())

    spec_only = torch.zeros(n, dtype=torch.bool, device=dev)
    n_surf = torch.zeros(n, dtype=torch.int32, device=dev)
    surf, vol = [], []
    for k in range(max_depth):
        its = ray_intersect(scene.geom, ray)
        max_t = torch.where(its.valid, its.t, 1e8)
        med = sample_distance(medium, ray.o, ray.d, max_t, u_mch[k],
                              u_mdist[k])
        in_medium = active & med["valid"]
        at_surface = active & its.valid & ~med["valid"]
        in_box = torch.all((med["p"] >= bmin) & (med["p"] <= bmax), dim=-1)
        vol.append((med["p"], beta, ray.d, in_medium & in_box & scatters))
        beta_m = beta * med["weight"]
        d_new_m, _ = phase_sample(medium.phase_kind, medium.phase_g, ray.d,
                                  u_ph[k])
        caustic = spec_only & (n_surf >= 1)
        beta_s = beta * med["surface_weight"]
        surf.append((its.p, beta_s, ray.d, its.sh_n, at_surface,
                     caustic & at_surface))
        bs = bsdf_sample(scene.materials, its.material_id, its.wi,
                         u_scatter[k], u_lobe[k])
        wo_world = its.to_world(bs["wo"])
        nxt_s = at_surface & bs["valid"]
        nxt = in_medium | nxt_s
        beta = torch.where(in_medium[:, None], beta_m,
                           torch.where(nxt_s[:, None], beta_s * bs["weight"],
                                       beta))
        new_o = torch.where(in_medium[:, None], med["p"], its.p)
        new_d = torch.where(in_medium[:, None], d_new_m, wo_world)
        ray = _keep(ray, Ray.make(new_o, new_d, mint=_eps(new_o)), nxt)
        spec_only = torch.where(
            at_surface, spec_only & bs["delta"] | ((n_surf == 0)
                                                   & bs["delta"]),
            spec_only)
        n_surf = n_surf + at_surface.to(torch.int32)
        active = nxt
    sp, spw, sd, sn, sm, scau = _host(*(torch.cat(x) for x in zip(*surf)))
    vp, vpw, vd, vm = _host(*(torch.cat(x) for x in zip(*vol)))
    # absorption-only collisions carry no power
    vm = vm & (vpw.sum(axis=1) > 0)
    return ((sp[sm], spw[sm], sd[sm], sn[sm], scau[sm]),
            (vp[vm], vpw[vm], vd[vm]))


def build_volume_grid(pos, power, din, res: int = 32, device="cpu"):
    """The HashGrid of volume photons and its gather radius, one cell
    (bre.py:155); the budget a cell is the 99th percentile of the filled
    cells' counts, clamped to [4, 48]. (None, 0.0) without photons."""
    if len(pos) == 0:
        return None, 0.0
    pos = np.asarray(pos)
    radius = float((pos.max(0) - pos.min(0)).max() + 1e-6) / res
    bmin = pos.min(0) - 1e-6
    cell = (pos.max(0) + 1e-6 - bmin).max() / res
    ijk = np.clip(((pos - bmin) / cell).astype(np.int64), 0, res - 1)
    cid = (ijk[:, 0] * res + ijk[:, 1]) * res + ijk[:, 2]
    occ = np.bincount(cid)
    occ = occ[occ > 0]
    per_cell = int(min(max(np.percentile(occ, 99), 4), 48))
    grid = HashGrid.build(
        pos, np.concatenate([np.asarray(power), np.asarray(din)], axis=1),
        res=res, max_per_query=27 * per_cell, device=device)
    return grid, radius


def beam_radiance_estimate(medium, grid: HashGrid, radius: float,
                           ray_o, ray_d, max_t, n_emitted: int,
                           n_march: int = 32, u_offset=None):
    """In-scattered radiance along rays from the volume photons (bre.py:
    183): L = sum_s dt Tr(t_s) sigma_s / sigma_t sum_i K3(d_i) phase P_i
    / N over n_march stratified points t_s = (s + u) dt, dt = max_t /
    n_march."""
    n = ray_o.shape[0]
    dev = ray_o.device
    medium = medium.to(dev)
    sigma_t = medium.sigma_t
    albedo_m = medium.sigma_s / torch.clamp(sigma_t, min=1e-20)
    dt = max_t / n_march
    if u_offset is None:
        u_offset = torch.full((n,), 0.5, device=dev)
    inv_kernel = 15.0 / (8.0 * np.pi * radius ** 3)   # 3-D Epanechnikov

    def contrib(rows, d2):
        w = torch.clamp(1.0 - d2 / radius ** 2, min=0.0)[..., None]
        din = rows[..., 3:6]
        f = phase_eval(medium.phase_kind, medium.phase_g,
                       din.reshape(-1, 3),
                       (-ray_d)[:, None].expand_as(din).reshape(-1, 3))
        return rows[..., 0:3] * w * f.reshape(din.shape[:-1])[..., None]

    L = torch.zeros((n, 3), device=dev)
    for s in range(n_march):
        t_s = (s + u_offset) * dt
        p_s = ray_o + ray_d * t_s[:, None]
        tr = torch.exp(-sigma_t[None, :] * t_s[:, None])
        dens = grid.gather_sum(p_s, radius, contrib_fn=contrib)
        L = L + tr * albedo_m[None, :] * dens * inv_kernel * dt[:, None]
    return L / n_emitted


def bre_render(scene, medium, cfg: PathConfig, n_photons: int = 100_000,
               n_march: int = 32, seed: int = 0):
    """The beam estimate along camera rays through the medium plus the
    surface photon map at their hits, attenuated (bre.py:222). Returns
    (image, aux)."""
    dev = scene.device
    medium = medium.to(dev)
    surface, volume = shoot_photons_media(scene, medium, n_photons,
                                          cfg.max_depth, seed)
    sp, spw, sd, sn, _ = surface
    vgrid, vradius = build_volume_grid(*volume, device=dev)
    sgrid = build_photon_grid(sp, spw, sd, sn, device=dev)
    sradius = 0.02 * _extent(sp)
    ray, sampler, _, _ = camera_samples(scene, cfg, seed, morton=False)
    u_march = sampler.next_1d()
    its = ray_intersect(scene.geom, ray)
    max_t = torch.where(its.valid, its.t, 1e4)
    le = eval_emitter_hit(scene.emitters, its.emitter_id, -ray.d, its.geo_n)
    lr = photon_estimate(scene, sgrid, its, sradius, n_photons)
    tr_surf = medium_transmittance(medium, ray.o, ray.d, max_t)
    L = torch.where(its.valid[:, None], (le + lr) * tr_surf, 0.0)
    if vgrid is not None:
        L = L + beam_radiance_estimate(medium, vgrid, vradius, ray.o, ray.d,
                                       max_t, n_photons, n_march=n_march,
                                       u_offset=u_march)
    return _spp_mean(L, scene, cfg.spp), {
        "n_volume_photons": int(len(volume[0])),
        "n_surface_photons": int(len(sp)),
        "volume_radius": vradius,
    }
