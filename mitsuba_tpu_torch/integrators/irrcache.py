"""Irradiance caching (port of mitsuba_tpu/integrators/irrcache.py;
reference src/integrators/misc/irrcache.cpp:45, irrcache_proc.cpp and
include/mitsuba/render/irrcache.h:42,144).

Hemispherical irradiance is estimated at the first hits of a low-res
camera pre-pass, each a batch of short path traces over a cosine
hemisphere, and interpolated at shading time from a `core/kdtree.py`
HashGrid of the records, weighted by distance and normal agreement. With
`gradients`, each record also carries Ward and Heckbert's translational
and rotational gradients from a stratified hemisphere (the reference's
HemisphereSampler), and interpolation extrapolates by them.
"""
from __future__ import annotations

import numpy as np
import torch

from mitsuba_tpu_torch.core import math as m
from mitsuba_tpu_torch.core import warp
from mitsuba_tpu_torch.core.kdtree import HashGrid
from mitsuba_tpu_torch.emitters import eval_emitter_hit
from mitsuba_tpu_torch.integrators.path import (
    PathConfig, camera_samples, path_trace,
)
from mitsuba_tpu_torch.integrators.photonmap import (
    _eps, _lane_ids, _spp_mean,
)
from mitsuba_tpu_torch.render.intersect import ray_intersect
from mitsuba_tpu_torch.render.records import Ray
from mitsuba_tpu_torch.render.sampler import Sampler


def _camera_first_hits(scene, res: int, seed: int):
    """The first hits of a res x res jittered camera pass (irrcache.py:
    41)."""
    n = res * res
    lane, zeros = _lane_ids(n, scene.device)
    sampler = Sampler(seed ^ 0x5151, lane, zeros)
    jitter = sampler.next_2d()
    px = (lane % res).to(torch.float32)
    py = (lane // res).to(torch.float32)
    uv = torch.stack([(px + jitter[:, 0]) / res, (py + jitter[:, 1]) / res],
                     -1)
    return ray_intersect(scene.geom, scene.camera.sample_ray(uv))


def _frame_to_world(frame, v):
    """Local (..., 3) vectors of per-record frames (M, 3) -> world; v's
    leading axis is the record's."""
    shape = (-1,) + (1,) * (v.dim() - 2) + (3,)
    return (v[..., 0:1] * frame.s.reshape(shape)
            + v[..., 1:2] * frame.t.reshape(shape)
            + v[..., 2:3] * frame.n.reshape(shape))


def build_irradiance_cache(scene, cfg: PathConfig, cache_res: int = 32,
                           hemi_samples: int = 32, seed: int = 0,
                           gradients: bool = False) -> HashGrid:
    """The HashGrid of cache records at the pre-pass's hits (irrcache.py:
    54), payload E (3) | normal (3) and, with gradients, the world-space
    translational and rotational gradients (3 channels x 3 axes each)
    from an (M x 2M) stratified hemisphere a record, M = max(4,
    sqrt(hemi_samples / 2)). The paths are cfg.max_depth - 1 deep."""
    dev = scene.device
    its = _camera_first_hits(scene, cache_res, seed)
    valid = its.valid.cpu().numpy()
    pts = its.p.cpu().numpy()[valid]
    nrm = its.sh_n.cpu().numpy()[valid]
    m_pts = pts.shape[0]
    sub_cfg = PathConfig(max_depth=max(cfg.max_depth - 1, 1),
                         rr_depth=cfg.rr_depth, spp=1, remat=False)
    pts_t = torch.as_tensor(pts, device=dev)
    nrm_t = torch.as_tensor(nrm, device=dev)
    if gradients:
        m_t = max(4, int(np.sqrt(hemi_samples / 2.0)))
        n_p = 2 * m_t
        hemi = m_t * n_p
        n = m_pts * hemi
        sampler = Sampler(seed ^ 0xCACE, *_lane_ids(n, dev))
        u = sampler.next_2d().reshape(m_pts, m_t, n_p, 2)
        d_local = stratified_hemisphere(m_t, n_p, u[..., 0], u[..., 1])
        frame = m.Frame.from_normal(nrm_t)
        d = _frame_to_world(frame, d_local)
        rep_p = torch.repeat_interleave(pts_t, hemi, dim=0)
        ray = Ray.make(rep_p, d.reshape(n, 3), mint=_eps(rep_p))
        L, _ = path_trace(scene, ray, sampler, sub_cfg)
        hits = ray_intersect(scene.geom, ray)
        r = torch.where(hits.valid, hits.t, 1e6).reshape(m_pts, m_t, n_p)
        L_cells = L.reshape(m_pts, m_t, n_p, 3)
        e_pts = torch.pi * L_cells.mean(dim=(1, 2))
        gt_l, gr_l = ward_gradients(L_cells, r, m_t, n_p)
        gt_w = _frame_to_world(frame, gt_l).reshape(m_pts, 9)
        gr_w = _frame_to_world(frame, gr_l).reshape(m_pts, 9)
        payload = np.concatenate(
            [e_pts.cpu().numpy(), nrm, gt_w.cpu().numpy(),
             gr_w.cpu().numpy()], axis=1)
    else:
        n = m_pts * hemi_samples
        rep_n = torch.repeat_interleave(nrm_t, hemi_samples, dim=0)
        sampler = Sampler(seed ^ 0xCACE, *_lane_ids(n, dev))
        d_local = warp.square_to_cosine_hemisphere(sampler.next_2d())
        d = m.Frame.from_normal(rep_n).to_world(d_local)
        rep_p = torch.repeat_interleave(pts_t, hemi_samples, dim=0)
        L, _ = path_trace(scene, Ray.make(rep_p, d, mint=_eps(rep_p)),
                          sampler, sub_cfg)
        e_pts = torch.pi * L.reshape(m_pts, hemi_samples, 3).mean(dim=1)
        payload = np.concatenate([e_pts.cpu().numpy(), nrm], axis=1)
    # a cell must cover the interpolation radius, 0.08 of the extent
    return HashGrid.build(pts, payload, res=12, max_per_query=27 * 16,
                          device=dev)


def interpolate_irradiance(grid: HashGrid, x, n, radius):
    """The records' E at points x with normals n (irrcache.py:133), each
    weighted by max(n_i . n, 0)^2 / (1 + 16 d^2 / radius^2); with
    gradients (payload width 24) a record first extrapolates by
    (x - x_i) . grad_t + (n_i x n) . grad_r, clamped to 0.75 |E_i|. A
    point no record's normal agrees with takes the distance weights
    alone. Returns (E, weight sum)."""
    has_grad = grid.payload.shape[1] >= 24

    def contrib(rows, d2, dp):
        e = rows[..., 0:3]
        cn = rows[..., 3:6]
        nq = n[:, None]
        if has_grad:
            # (N, P, channel, axis)
            gt = rows[..., 6:15].reshape(rows.shape[:-1] + (3, 3))
            gr = rows[..., 15:24].reshape(rows.shape[:-1] + (3, 3))
            axis_rot = m.cross(cn, nq.expand_as(cn))
            delta = (torch.einsum("...ca,...a->...c", gt, dp)
                     + torch.einsum("...ca,...a->...c", gr, axis_rot))
            lim = 0.75 * torch.abs(e) + 1e-4
            e = e + torch.clamp(delta, -lim, lim)
        w_n = torch.clamp(m.dot(cn, nq), min=0.0) ** 2
        w_d = 1.0 / (1.0 + d2 / (radius * radius) * 16.0)
        w = (w_n * w_d)[..., None]
        w_rel = w_d[..., None]
        return torch.cat([e * w, w, e * w_rel, w_rel], dim=-1)

    acc = grid.gather_sum(x, radius, contrib_pos_fn=contrib)
    e_sum, w_sum = acc[:, 0:3], acc[:, 3:4]
    e_rel, w_rel = acc[:, 4:7], acc[:, 7:8]
    miss = w_sum[:, 0] < 1e-6
    e_out = torch.where(miss[:, None],
                        e_rel / torch.clamp(w_rel, min=1e-9),
                        e_sum / torch.clamp(w_sum, min=1e-6))
    w_out = torch.where(miss, w_rel[:, 0], w_sum[:, 0])
    return e_out, w_out


def irrcache_render(scene, cfg: PathConfig, cache_res: int = 32,
                    hemi_samples: int = 32, seed: int = 0,
                    gradients: bool = False):
    """Le + albedo / pi E_interp at the camera hits (irrcache.py:163), the
    radius 0.08 of the records' extent. Returns (image, aux)."""
    grid = build_irradiance_cache(scene, cfg, cache_res, hemi_samples, seed,
                                  gradients=gradients)
    extent = float(torch.linalg.norm(torch.amax(grid.points, dim=0)
                                     - torch.amin(grid.points, dim=0)))
    radius = 0.08 * extent
    ray, _, _, _ = camera_samples(scene, cfg, seed, morton=False)
    its = ray_intersect(scene.geom, ray)
    le = eval_emitter_hit(scene.emitters, its.emitter_id, -ray.d, its.geo_n)
    e, wsum = interpolate_irradiance(grid, its.p, its.sh_n, radius)
    mats = scene.materials
    mclip = torch.clamp(its.material_id, 0, mats.n_materials - 1).long()
    lo = mats.reflectance[mclip] * m.INV_PI * e
    L = torch.where(its.valid[:, None], le + lo, 0.0)
    covered = torch.where(its.valid, wsum > 0, True)
    return _spp_mean(L, scene, cfg.spp), {
        "cache_points": int(grid.points.shape[0]), "radius": radius,
        "coverage": float(covered.float().mean())}


# ---------------------------------------------------------------------------
# Ward-Heckbert stratified-hemisphere gradients (reference
# HemisphereSampler, irrcache.h:42, irrcache.cpp; irrcache.py:205)
# ---------------------------------------------------------------------------

def stratified_hemisphere(m_theta: int, n_phi: int, u1, u2):
    """Cosine-stratified cell directions (irrcache.py:213): u1, u2 (...,
    M, N) jitters -> local directions (..., M, N, 3), theta_j =
    asin(sqrt((j + u) / M))."""
    dev = u1.device
    j = torch.arange(m_theta, device=dev)[:, None]
    k = torch.arange(n_phi, device=dev)[None, :]
    sin2 = (j + u1) / m_theta
    sin_t = torch.sqrt(torch.clamp(sin2, 0.0, 1.0))
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2, 0.0, 1.0))
    phi = 2.0 * np.pi * (k + u2) / n_phi
    return torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi),
                        cos_t], dim=-1)


def ward_gradients(L, r, m_theta: int, n_phi: int):
    """Translational and rotational irradiance gradients from the cells'
    radiances L (..., M, N, C) and hit distances r (..., M, N) (Ward &
    Heckbert 1992 eqs. 6 and 7; irrcache.py:226). Returns (grad_t (..., C,
    3), grad_r (..., C, 3)) in the local frame, z the normal."""
    M, N = m_theta, n_phi
    dev = L.device
    j = torch.arange(M, device=dev)
    k = torch.arange(N, device=dev)
    sin_m = torch.sqrt(j / M)                  # sin(theta_j^-)
    cos_m = torch.sqrt(1.0 - j / M)
    sin_p = torch.sqrt((j + 1) / M)            # sin(theta_j^+)
    phi_c = 2.0 * np.pi * (k + 0.5) / N        # cell-centre azimuth
    phi_b = 2.0 * np.pi * k / N                # lower cell boundary
    uk = torch.stack([torch.cos(phi_c), torch.sin(phi_c)], -1)    # (N, 2)
    vk_b = torch.stack([-torch.sin(phi_b), torch.cos(phi_b)], -1)

    r_safe = torch.clamp(r, min=1e-6)
    # translational, theta differences along u_k
    dl_t = L[..., 1:, :, :] - L[..., :-1, :, :]
    rmin_t = torch.minimum(r_safe[..., 1:, :], r_safe[..., :-1, :])
    coef_t = sin_m[1:] * cos_m[1:] * cos_m[1:]
    t_term = (2.0 * np.pi / N) * torch.sum(
        coef_t[:, None, None] * dl_t / rmin_t[..., None], dim=-3)
    # translational, phi differences along v_k (wrapping over N)
    dl_p = L - torch.roll(L, 1, dims=-2)
    rmin_p = torch.minimum(r_safe, torch.roll(r_safe, 1, dims=-1))
    coef_p = sin_p - sin_m
    p_term = torch.sum(coef_p[:, None, None] * dl_p / rmin_p[..., None],
                       dim=-3)
    grad_t = (torch.einsum("...nc,nd->...cd", t_term, uk)
              + torch.einsum("...nc,nd->...cd", p_term, vk_b))
    zeros = torch.zeros(grad_t.shape[:-1] + (1,), device=dev)
    grad_t = torch.cat([grad_t, zeros], dim=-1)
    # rotational (eq. 6): pi / (M N) sum tan(theta_j) L_jk along -v_k
    sin_c = torch.sqrt((j + 0.5) / M)
    cos_c = torch.sqrt(1.0 - (j + 0.5) / M)
    tan_j = sin_c / torch.clamp(cos_c, min=1e-6)
    rot_mag = (np.pi / (M * N)) * torch.sum(tan_j[:, None, None] * L,
                                            dim=-3)
    grad_r = torch.einsum("...nc,nd->...cd", rot_mag,
                          torch.stack([torch.sin(phi_c), -torch.cos(phi_c)],
                                      -1))
    return grad_t, torch.cat([grad_r, zeros], dim=-1)
