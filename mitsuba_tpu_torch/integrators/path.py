"""Wavefront MIS path tracer (port of the unsorted branch of
mitsuba_tpu/integrators/path.py; reference
src/integrators/path/path.cpp:47 MIPathTracer::Li).

Next-event estimation and BSDF sampling combined with the power heuristic,
Russian roulette after `rr_depth`, one-sided area emitters. All lanes
advance in lockstep through a Python loop over depth; terminated lanes are
masked, never compacted. As in the reference, the NEE shadow ray of a
bounce is deferred and answered by the next bounce's fused intersector
launch, so a render of depth D makes D kernel launches.

Forward rendering only: no gradient flows through the intersector, and
the options of the reference that the port does not implement raise
NotImplementedError.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from mitsuba_tpu_torch.bsdfs import bsdf_eval, bsdf_pdf, bsdf_sample
from mitsuba_tpu_torch.core import math as m
from mitsuba_tpu_torch.emitters import (
    eval_and_pdf_environment, eval_emitter_hit, pdf_direct_area,
    sample_direct,
)
from mitsuba_tpu_torch.render.film import develop
from mitsuba_tpu_torch.render.intersect import ray_intersect_and_test
from mitsuba_tpu_torch.render.records import Ray
from mitsuba_tpu_torch.render.sampler import Sampler, sample_position


@dataclass(frozen=True)
class PathConfig:
    max_depth: int = 5          # reference maxDepth (bounces incl. first hit)
    rr_depth: int = 10          # start Russian roulette after this depth
    spp: int = 16
    pattern: str = "independent"
    rfilter: str = "box"
    # options of the reference that are not ported: each must keep its
    # default, or path_trace raises
    remat: bool = False
    strict_normals: bool = False
    sort_rays: bool = False
    hit_prediction: bool = False
    mip_filter: bool = False
    aniso_filter: bool = False
    skip_direct_emission: bool = False


_UNPORTED = ("remat", "strict_normals", "sort_rays", "hit_prediction",
             "mip_filter", "aniso_filter", "skip_direct_emission")


def _check_config(cfg: PathConfig):
    on = [name for name in _UNPORTED if getattr(cfg, name)]
    if on:
        raise NotImplementedError(f"PathConfig options not ported: {on}")


def mi_weight(pdf_a, pdf_b):
    """Power heuristic, beta=2 (reference path.cpp:218)."""
    a2 = pdf_a * pdf_a
    b2 = pdf_b * pdf_b
    return torch.where(pdf_a > 0, a2 / torch.clamp(a2 + b2, min=1e-20), 0.0)


def path_trace(scene, ray: Ray, sampler: Sampler, cfg: PathConfig):
    """Trace radiance along the given camera rays. Returns (L, aux) with
    L (N, C) and aux = dict(avg_path_length, rays_traced)."""
    _check_config(cfg)
    n = ray.o.shape[0]
    dev = ray.o.device
    d_max = cfg.max_depth
    geom, mats, em = scene.geom, scene.materials, scene.emitters

    # per-depth random fields, drawn up front in the reference's order
    u_nee_sel = sampler.next_stacked_1d(d_max)       # (D, N)
    u_nee_pos = sampler.next_stacked_2d(d_max)       # (D, N, 2)
    u_bsdf_2d = sampler.next_stacked_2d(d_max)
    u_lobe = sampler.next_stacked_1d(d_max)
    u_rr = sampler.next_stacked_1d(d_max)

    n_ch = mats.reflectance.shape[-1]
    L = torch.zeros((n, n_ch), device=dev)
    throughput = torch.ones((n, n_ch), device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    prev_pdf = torch.zeros(n, device=dev)   # BSDF pdf that made this ray
    prev_delta = torch.ones(n, dtype=torch.bool, device=dev)  # camera ray
    depth_count = torch.zeros(n, dtype=torch.int32, device=dev)
    rays_traced = torch.zeros((), dtype=torch.int64, device=dev)
    # deferred NEE: the shadow ray fires with the NEXT bounce's closest
    # hit; its contribution lands one bounce later
    pend_ray = Ray.make(ray.o, ray.d, maxt=-1.0)
    pend_contrib = torch.zeros((n, n_ch), device=dev)
    pend_ok = torch.zeros(n, dtype=torch.bool, device=dev)

    for depth in range(d_max):
        is_last = depth + 1 >= d_max
        do_rr = depth >= cfg.rr_depth
        rays_traced = rays_traced + active.sum() + pend_ok.sum()
        its, s_occ = ray_intersect_and_test(geom, ray, pend_ray)

        # resolve the previous bounce's NEE shadow ray
        L = L + torch.where((pend_ok & ~s_occ)[:, None], pend_contrib, 0.0)

        # escaped rays: background luminaire with MIS
        esc = active & ~its.valid
        env, env_pdf = eval_and_pdf_environment(em, ray.d)
        w_env = torch.where(prev_delta, 1.0, mi_weight(prev_pdf, env_pdf))
        L = L + torch.where(esc[:, None], throughput * env * w_env[:, None],
                            0.0)

        active = active & its.valid
        depth_count = depth_count + active.to(torch.int32)

        # emitter hit (the BSDF-sampling side of MIS)
        if em.has_surface_emitters:
            le = eval_emitter_hit(em, its.emitter_id, -ray.d, its.geo_n)
            lum_pdf = pdf_direct_area(em, its.prim_id, ray.o, its.p,
                                      its.geo_n)
            w_bsdf = torch.where(prev_delta, 1.0,
                                 mi_weight(prev_pdf, lum_pdf))
            L = L + torch.where(active[:, None],
                                throughput * le * w_bsdf[:, None], 0.0)

        # beyond here only matters when this is not the final depth
        cont = active & (not is_last)
        mclip = torch.clamp(its.material_id, 0, mats.n_materials - 1).long()
        albedo = mats.reflectance[mclip]

        # next-event estimation (luminaire sampling)
        ds = sample_direct(em, geom, its.p, u_nee_sel[depth],
                           u_nee_pos[depth])
        wo_local = its.to_local(ds.d)
        fcos = bsdf_eval(mats, its.material_id, its.wi, wo_local,
                         albedo=albedo)
        b_pdf = bsdf_pdf(mats, its.material_id, its.wi, wo_local)
        nee_ok = cont & ds.valid & (ds.pdf > 0)
        # shadow-ray epsilon scales with the coordinate magnitude
        eps = m.EPSILON * torch.clamp(torch.abs(its.p).amax(dim=-1), min=1.0)
        pend_ray = Ray.make(its.p, ds.d, mint=eps,
                            maxt=torch.where(nee_ok, ds.dist * (1.0 - 1e-3),
                                             -1.0))
        w_nee = torch.where(ds.delta, 1.0, mi_weight(ds.pdf, b_pdf))
        pend_contrib = throughput * fcos * ds.value * \
            (w_nee / torch.clamp(ds.pdf, min=1e-20))[:, None]
        pend_ok = nee_ok

        # BSDF sampling
        bs = bsdf_sample(mats, its.material_id, its.wi, u_bsdf_2d[depth],
                         u_lobe[depth], albedo=albedo)
        wo_world = its.to_world(bs["wo"])
        active = cont & bs["valid"]

        # Russian roulette (reference path.cpp:196)
        alb_rr = torch.clamp(bs["weight"].amax(dim=-1), max=0.9)
        kill = do_rr & (u_rr[depth] > alb_rr) & ~bs["transmission"]
        rr_scale = torch.where(do_rr & ~bs["transmission"],
                               1.0 / torch.clamp(alb_rr, min=1e-3), 1.0)
        active = active & ~kill
        throughput = throughput * torch.where(active, rr_scale, 1.0)[:, None]
        throughput = throughput * torch.where(active[:, None], bs["weight"],
                                              1.0)
        # dead lanes keep o/d but get maxt = -1 so they trace nothing
        ray = Ray(
            o=torch.where(active[:, None], its.p, ray.o),
            d=torch.where(active[:, None], wo_world, ray.d),
            mint=eps,
            maxt=torch.where(active, float("inf"), -1.0),
        )
        prev_pdf, prev_delta = bs["pdf"], bs["delta"]

    aux = {
        "avg_path_length": depth_count.to(torch.float32).mean(),
        "rays_traced": rays_traced,
    }
    return L, aux


def render(scene, cfg: PathConfig, seed: int = 0):
    """Render the scene to an (H, W, C) image on the scene's device.
    Wavefront layout: lane = pixel * spp + sample."""
    w, h, spp = scene.width, scene.height, cfg.spp
    n = w * h * spp
    lane = torch.arange(n, dtype=torch.int32, device=scene.device)
    pixel_id = lane // spp
    sample_id = lane % spp
    px = (pixel_id % w).to(torch.float32)
    py = (pixel_id // w).to(torch.float32)

    sampler = Sampler(seed, pixel_id, sample_id)
    jitter = sampler.next_2d()
    offset = sample_position(cfg.pattern, sample_id, spp, jitter)
    uv = torch.stack([(px + offset[:, 0]) / w, (py + offset[:, 1]) / h],
                     dim=-1)
    ray = scene.camera.sample_ray(uv)
    L, aux = path_trace(scene, ray, sampler, cfg)
    return develop(L, spp, h, w, cfg.rfilter), aux
