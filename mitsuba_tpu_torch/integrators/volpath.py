"""Volumetric path tracer in an ambient medium (port of
mitsuba_tpu/integrators/volpath.py:47-302; reference
src/integrators/path/volpath.cpp:37 VolumetricPathTracer, and
volpath_simple.cpp with `mis=False`).

Each bounce intersects the scene, samples a free path in the medium
against the surface distance (`media.sample_distance`), then runs the
medium lanes (phase-function NEE and sampling) and the surface lanes
(BSDF NEE and sampling) masked side by side. NEE is answered in the same
bounce by a separate any-hit query and attenuated by the medium's
transmittance. All lanes advance in lockstep through a Python loop over
depth; lanes that died keep tracing with their old origin and direction
and maxt = inf, as in the reference. On the brute backend the two
queries of a bounce are kernels #2 (`ray_intersect`) and #3 (`ray_test`).

The estimator follows the reference line for line: the draw order of its
seven stacked fields, its Russian-roulette albedo (the throughput ratio,
not the path tracer's BSDF weight), its image as the plain mean of the
spp samples of a pixel. Gradients flow as in the path tracer
(`integrators/path.py`): the samples, the scatter pdf and the roulette
albedo are detached, and with `cfg.remat` each bounce is a checkpoint
where a scene or medium tensor requires grad (volpath.py:265). Path guiding (`guide`, `learn_guide`,
`guide_sampling`) and shape-interior media are not ported: the former
raise, the latter are not part of a port `Scene`.
"""
from __future__ import annotations

import torch

from mitsuba_tpu_torch.bsdfs import bsdf_eval, bsdf_pdf, bsdf_sample
from mitsuba_tpu_torch.core import math as m
from mitsuba_tpu_torch.emitters import (
    eval_emitter_hit, eval_environment, pdf_direct_area, pdf_environment,
    sample_direct,
)
from mitsuba_tpu_torch.integrators.path import (
    PathConfig, camera_wavefront, mi_weight, requires_grad, run_bounce,
)
from mitsuba_tpu_torch.media import (
    medium_transmittance, phase_eval, phase_pdf, phase_sample,
    sample_distance,
)
from mitsuba_tpu_torch.render.intersect import ray_intersect, ray_test
from mitsuba_tpu_torch.render.records import Ray
from mitsuba_tpu_torch.render.sampler import Sampler

_FAR = 1e6


def _check_guiding(guide, learn_guide, guide_sampling):
    if guide is not None or learn_guide or guide_sampling:
        raise NotImplementedError("volumetric path guiding is not ported")


def volpath_trace(scene, medium, ray: Ray, sampler: Sampler, cfg: PathConfig,
                  mis: bool = True, guide=None, learn_guide: bool = False,
                  guide_sampling: bool = None):
    """Trace radiance with an ambient participating medium (a
    `media.MediumTable`, moved to the rays' device). mis=False is the
    volpath_simple estimator (no phase-side MIS). Returns (L (N, 3),
    aux = dict(avg_path_length))."""
    _check_guiding(guide, learn_guide, guide_sampling)
    n = ray.o.shape[0]
    dev = ray.o.device
    d_max = cfg.max_depth
    geom, mats, em = scene.geom, scene.materials, scene.emitters
    medium = medium.to(dev)

    u_ch = sampler.next_stacked_1d(d_max)
    u_dist = sampler.next_stacked_1d(d_max)
    u_nee_sel = sampler.next_stacked_1d(d_max)
    u_nee_pos = sampler.next_stacked_2d(d_max)
    u_scatter = sampler.next_stacked_2d(d_max)
    u_lobe = sampler.next_stacked_1d(d_max)
    u_rr = sampler.next_stacked_1d(d_max)
    kind, g = medium.phase_kind, medium.phase_g

    def bounce(depth, xs, L, throughput, o, d, mint, maxt, active, prev_pdf,
               prev_delta, depth_count):
        u_ch, u_dist, u_nee_sel, u_nee_pos, u_scatter, u_lobe, u_rr = xs
        ray = Ray(o, d, mint, maxt)
        is_last = depth + 1 >= d_max
        do_rr = depth >= cfg.rr_depth
        its = ray_intersect(geom, ray)
        t_surf = torch.where(its.valid, its.t, _FAR)

        md = sample_distance(medium, ray.o, ray.d, t_surf, u_ch, u_dist)
        in_medium = active & md["valid"]
        at_surface = active & ~md["valid"] & its.valid
        escaped = active & ~md["valid"] & ~its.valid

        # throughput after the free-path decision
        thr_med = throughput * md["weight"]
        thr_surf = throughput * md["surface_weight"]

        # escaped: background radiance
        env = eval_environment(em, ray.d)
        env_pdf = pdf_environment(em, ray.d)
        w_env = torch.where(prev_delta, 1.0, mi_weight(prev_pdf, env_pdf))
        L = L + torch.where(escaped[:, None], thr_surf * env * w_env[:, None],
                            0.0)

        depth_count = depth_count + (in_medium | at_surface).to(torch.int32)

        # surface emitter hit
        le = eval_emitter_hit(em, its.emitter_id, -ray.d, its.geo_n)
        lum_pdf = pdf_direct_area(em, its.prim_id, ray.o, its.p, its.geo_n)
        w_bsdf = torch.where(prev_delta, 1.0, mi_weight(prev_pdf, lum_pdf))
        L = L + torch.where(at_surface[:, None],
                            thr_surf * le * w_bsdf[:, None], 0.0)

        cont_m = in_medium & (not is_last)
        cont_s = at_surface & (not is_last)

        # NEE: one emitter sample, from the scatter point of each lane
        p_scatter = torch.where(in_medium[:, None], md["p"], its.p)
        ds = sample_direct(em, geom, p_scatter, u_nee_sel, u_nee_pos)
        ph_val = phase_eval(kind, g, ray.d, ds.d)
        ph_pdf = phase_pdf(kind, g, ray.d, ds.d) if mis \
            else torch.zeros(n, device=dev)
        wo_local = its.to_local(ds.d)
        fcos = bsdf_eval(mats, its.material_id, its.wi, wo_local)
        b_pdf = bsdf_pdf(mats, its.material_id, its.wi, wo_local)

        eps = m.EPSILON * torch.clamp(torch.abs(p_scatter).amax(dim=-1),
                                      min=1.0)
        shadow = Ray.make(p_scatter, ds.d, mint=eps,
                          maxt=ds.dist * (1.0 - 1e-3))
        occluded = ray_test(geom, shadow)
        tr = medium_transmittance(medium, p_scatter, ds.d, ds.dist)

        nee_ok = (cont_m | cont_s) & ds.valid & (ds.pdf > 0) & ~occluded
        scatter_pdf = torch.where(in_medium, ph_pdf, b_pdf)
        w_nee = torch.where(ds.delta, 1.0, mi_weight(ds.pdf, scatter_pdf))
        f_scatter = torch.where(in_medium[:, None], ph_val[:, None], fcos)
        thr_here = torch.where(in_medium[:, None], thr_med, thr_surf)
        contrib = thr_here * f_scatter * ds.value * tr * \
            (w_nee / torch.clamp(ds.pdf, min=1e-20))[:, None]
        L = L + torch.where(nee_ok[:, None], contrib, 0.0)

        # scatter: phase sample (medium) or BSDF sample (surface)
        wo_phase, phase_p = phase_sample(kind, g, ray.d, u_scatter)
        bs = bsdf_sample(mats, its.material_id, its.wi, u_scatter, u_lobe)
        wo_world = torch.where(in_medium[:, None], wo_phase,
                               its.to_world(bs["wo"]))
        next_pdf = torch.where(in_medium, phase_p if mis else 0.0, bs["pdf"])
        next_delta = torch.where(in_medium, not mis, bs["delta"])
        scatter_ok = torch.where(in_medium, True, bs["valid"])
        active = (cont_m | cont_s) & scatter_ok
        new_thr = torch.where(in_medium[:, None], thr_med,
                              thr_surf * bs["weight"])

        # Russian roulette on the detached throughput's growth
        # (volpath.py:246)
        albedo = torch.clamp(
            new_thr.detach().amax(dim=-1)
            / torch.clamp(throughput.detach().amax(dim=-1), min=1e-8),
            min=0.05, max=0.9)
        kill = do_rr & (u_rr > albedo) & ~bs["transmission"]
        rr_scale = torch.where(do_rr & ~bs["transmission"],
                               1.0 / torch.clamp(albedo, min=1e-3), 1.0)
        active = active & ~kill
        new_thr = new_thr * torch.where(active, rr_scale, 1.0)[:, None]

        throughput = torch.where(active[:, None], new_thr, throughput)
        origin = torch.where(in_medium[:, None], md["p"], its.p)
        # dead lanes keep o/d and, like every lane, trace up to maxt = inf
        ray = Ray.make(torch.where(active[:, None], origin, ray.o),
                       torch.where(active[:, None], wo_world, ray.d),
                       mint=eps)
        return (L, throughput, ray.o, ray.d, ray.mint, ray.maxt, active,
                next_pdf.detach(), next_delta, depth_count)

    state = (
        torch.zeros((n, 3), device=dev),                # L
        torch.ones((n, 3), device=dev),                 # throughput
        ray.o, ray.d, ray.mint, ray.maxt,
        torch.ones(n, dtype=torch.bool, device=dev),    # active
        torch.zeros(n, device=dev),                     # prev_pdf
        torch.ones(n, dtype=torch.bool, device=dev),    # prev_delta
        torch.zeros(n, dtype=torch.int32, device=dev),  # depth_count
    )
    xs = (u_ch, u_dist, u_nee_sel, u_nee_pos, u_scatter, u_lobe, u_rr)
    remat = cfg.remat and requires_grad(
        geom, mats, em, scene.textures, scene.camera, medium, ray)
    for depth in range(d_max):
        state = run_bounce(bounce, depth, state, xs, remat)
    L, depth_count = state[0], state[9]

    return L, {"avg_path_length": depth_count.to(torch.float32).mean()}


def render_volpath(scene, medium, cfg: PathConfig, seed: int = 0,
                   mis: bool = True, guide=None, learn_guide: bool = False,
                   guide_sampling: bool = None):
    """Render the scene in an ambient medium to an (H, W, 3) image on the
    scene's device: the mean of each pixel's spp samples, lanes in
    scanline order (volpath.py:280). mis=False renders volpath_simple."""
    _check_guiding(guide, learn_guide, guide_sampling)
    ray, sampler, _ = camera_wavefront(scene, cfg, seed, morton=False)
    L, aux = volpath_trace(scene, medium, ray, sampler, cfg, mis=mis)
    return L.reshape(scene.height, scene.width, cfg.spp, 3).mean(dim=2), aux
