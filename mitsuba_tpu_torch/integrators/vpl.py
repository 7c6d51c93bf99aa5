"""Virtual point lights: generation and the instant-radiosity renderer
(port of mitsuba_tpu/integrators/vpl.py; reference render/vpl.h:59,
vpl.cpp:61 generateVPLs, vpl/vpl.cpp:35 VPLIntegrator).

Random walks from the lights leave a luminaire VPL at each start and a
surface VPL at each vertex; a camera hit is lit by every VPL in turn,
one shadow-ray batch of the whole wavefront a VPL, with the inverse
square clamped at clamp_dist.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from mitsuba_tpu_torch.bsdfs import bsdf_eval, bsdf_sample
from mitsuba_tpu_torch.core import math as m
from mitsuba_tpu_torch.emitters import eval_emitter_hit
from mitsuba_tpu_torch.integrators.path import PathConfig, camera_samples
from mitsuba_tpu_torch.integrators.photonmap import _eps, _keep, _lane_ids
from mitsuba_tpu_torch.integrators.ptracer import _sample_emission
from mitsuba_tpu_torch.render.film import develop
from mitsuba_tpu_torch.render.intersect import ray_intersect, ray_test
from mitsuba_tpu_torch.render.records import Ray
from mitsuba_tpu_torch.render.rfilter import make_rfilter
from mitsuba_tpu_torch.render.sampler import Sampler


@dataclass
class VPLSet:
    """The VPLs, SoA (vpl.py:32): the n_paths luminaire VPLs first, then
    the walks' vertices depth-major."""
    p: torch.Tensor            # (V, 3) position
    n: torch.Tensor            # (V, 3) surface normal
    d_in: torch.Tensor         # (V, 3) direction the particle arrived along
    material_id: torch.Tensor  # (V,) int32, -1 for luminaire VPLs
    flux: torch.Tensor         # (V, 3) path throughput
    is_lum: torch.Tensor       # (V,) bool
    valid: torch.Tensor        # (V,) bool
    n_paths: torch.Tensor      # () normalisation


def generate_vpls(scene, n_paths: int, max_depth: int = 3,
                  seed: int = 0) -> VPLSet:
    """Random-walk VPLs (vpl.py:43): a luminaire VPL carries Le / pdf_pos;
    each vertex a surface VPL with the throughput arriving there, its
    BSDF evaluated again at shading time."""
    sampler = Sampler(seed ^ 0x51AB7E, *_lane_ids(n_paths, scene.device))
    u_sel = sampler.next_1d()
    u_pos = sampler.next_2d()
    u_dir = sampler.next_2d()
    u_scatter = sampler.next_stacked_2d(max_depth)
    u_lobe = sampler.next_stacked_1d(max_depth)
    p0, n0, d0, beta, active = _sample_emission(scene, u_sel, u_pos, u_dir)
    # undo the cosine-direction pdf folded into beta: Le / pdf_pos
    cos0 = torch.clamp(m.dot(n0, d0), min=1e-6)
    lum_flux = beta * ((cos0 * m.INV_PI) / cos0)[:, None]
    valid0 = active
    ray = Ray.make(p0, d0, mint=_eps(p0))
    deps = []
    for k in range(max_depth):
        its = ray_intersect(scene.geom, ray)
        active = active & its.valid
        deps.append((its.p, its.sh_n, ray.d, its.material_id, beta, active))
        bs = bsdf_sample(scene.materials, its.material_id, its.wi,
                         u_scatter[k], u_lobe[k])
        wo_world = its.to_world(bs["wo"])
        nxt = active & bs["valid"]
        beta = beta * torch.where(nxt[:, None], bs["weight"], 1.0)
        ray = _keep(ray, Ray.make(its.p, wo_world, mint=_eps(its.p)), nxt)
        active = nxt
    sp, sn, sdin, smat, sbeta, sact = (torch.cat(x) for x in zip(*deps))
    dev = p0.device
    return VPLSet(
        p=torch.cat([p0, sp]), n=torch.cat([n0, sn]),
        d_in=torch.cat([-d0, sdin]),
        material_id=torch.cat([
            torch.full((n_paths,), -1, dtype=torch.int32, device=dev),
            smat.to(torch.int32)]),
        flux=torch.cat([lum_flux, sbeta]),
        is_lum=torch.cat([torch.ones(n_paths, dtype=torch.bool, device=dev),
                          torch.zeros(sact.shape[0], dtype=torch.bool,
                                      device=dev)]),
        valid=torch.cat([valid0, sact]),
        n_paths=torch.tensor(float(n_paths), device=dev))


def _shade_from_vpls(scene, its, vpls: VPLSet, clamp_dist: float):
    """The sum over VPLs of f_x G f_vpl flux V (vpl.py:117): a loop over
    the VPLs, each one shadow-ray batch of every hit; G = 1 / max(d^2,
    clamp_dist^2), both cosines inside the two fCos evaluations (a
    luminaire VPL's side is its emitter cosine)."""
    mats = scene.materials
    n = its.p.shape[0]
    eps = _eps(its.p)
    total = torch.zeros((n, 3), device=its.p.device)
    for v in range(vpls.p.shape[0]):
        vp, vn, vdin = vpls.p[v], vpls.n[v], vpls.d_in[v]
        to_v = vp[None, :] - its.p
        d2 = m.dot(to_v, to_v)
        dist = torch.sqrt(torch.clamp(d2, min=1e-20))
        wd = to_v / dist[:, None]
        cos_x = m.dot(its.sh_n, wd)
        cos_v = m.dot(vn[None, :], -wd)
        g = 1.0 / torch.clamp(d2, min=clamp_dist * clamp_dist)
        f_x = bsdf_eval(mats, its.material_id, its.wi, its.to_local(wd))
        vframe = m.Frame.from_normal(vn[None, :])
        wi_v = vframe.to_local(vdin[None, :].expand(n, 3))
        wo_v = vframe.to_local(-wd)
        f_v = bsdf_eval(mats, torch.clamp(vpls.material_id[v], min=0)
                        .expand(n), wi_v, wo_v)
        resp = torch.where(vpls.is_lum[v],
                           torch.clamp(cos_v, min=0.0)[:, None], f_v)
        shadow = Ray.make(its.p, wd, mint=eps, maxt=dist * (1.0 - 1e-3))
        lit = ~ray_test(scene.geom, shadow)
        ok = its.valid & lit & vpls.valid[v] & (cos_x > 0) & (cos_v > 0)
        contrib = f_x * resp * (g[:, None] * vpls.flux[v][None, :])
        total = total + torch.where(ok[:, None], contrib, 0.0)
    return total / vpls.n_paths


def render_vpl(scene, cfg: PathConfig, n_paths: int = 64,
               vpl_depth: int = 3, clamp_dist: float = 0.05,
               seed: int = 0):
    """Instant radiosity (vpl.py:160): Le plus the VPLs' light at the
    camera hits, the VPLs walked at seed + 7, developed with cfg.rfilter.
    Returns (image, VPLSet)."""
    vpls = generate_vpls(scene, n_paths, max_depth=vpl_depth, seed=seed + 7)
    ray, _, offset, _ = camera_samples(scene, cfg, seed, morton=False)
    its = ray_intersect(scene.geom, ray)
    le = eval_emitter_hit(scene.emitters, its.emitter_id, -ray.d, its.geo_n)
    ind = _shade_from_vpls(scene, its, vpls, clamp_dist)
    L = le + torch.where(its.valid[:, None], ind, 0.0)
    return develop(L, offset, cfg.spp, scene.height, scene.width,
                   make_rfilter(cfg.rfilter)), vpls
