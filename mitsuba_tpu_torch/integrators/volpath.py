"""Volumetric path tracer (port of mitsuba_tpu/integrators/volpath.py;
reference src/integrators/path/volpath.cpp:37 VolumetricPathTracer, and
volpath_simple.cpp with `mis=False`).

`volpath_trace` renders a scene in one ambient medium: each bounce
intersects the scene, samples a free path in the medium against the
surface distance (`media.sample_distance`: closed form when homogeneous,
Woodcock tracking from the bounce's key on a density grid), then runs
the medium lanes (phase-function NEE and sampling, the phase oriented
by the medium's fiber field where it has one) and the surface lanes
(BSDF NEE and sampling) masked side by side. NEE is answered in the same
bounce by a separate any-hit query and attenuated by the medium's
transmittance. With a guide (`integrators/guiding.py`) the medium
lanes scatter by the α·phase + (1-α)·guide mixture, or the bounces learn
the guide; `render_volpath_guided` runs a learning pass and a guided one.

`volpath_media_trace` renders the media bound to shapes' interiors
(`Scene.media`): each lane carries the index of the medium it travels
through, switched where a transmitted ray crosses a shape, and its NEE
is attenuated across every boundary up to the light by
`boundary_transmittance`, up to 4 closest-hit queries a shadow ray.

All lanes advance in lockstep through a Python loop over depth; lanes
that died keep tracing with their old origin and direction and maxt =
inf, as in the reference. On the brute backend a bounce's queries are
kernels #2 (`ray_intersect`) and #3 (`ray_test`); the interior-media
path runs #2 once for the bounce and once per crossing of the shadow
walk, and no #3. The estimators follow the reference line for line: the
draw order of their stacked fields, the Russian-roulette albedo (the
throughput ratio), the image as the plain mean of a pixel's samples.
Gradients flow as in the path tracer (`integrators/path.py`): samples,
scatter pdfs, the roulette albedo and the free-path decisions are
detached, and with `cfg.remat` each bounce is a checkpoint where a scene
or medium tensor requires grad.
"""
from __future__ import annotations

import dataclasses

import torch

from mitsuba_tpu_torch.bsdfs import bsdf_eval, bsdf_pdf, bsdf_sample
from mitsuba_tpu_torch.core import math as m
from mitsuba_tpu_torch.emitters import (
    eval_emitter_hit, eval_environment, pdf_direct_area, pdf_environment,
    sample_direct,
)
from mitsuba_tpu_torch.integrators import guiding as gd
from mitsuba_tpu_torch.integrators.path import (
    PathConfig, camera_wavefront, mi_weight, requires_grad, run_bounce,
)
from mitsuba_tpu_torch.media import (
    HG, MICROFLAKE_GAUSS, medium_transmittance, phase_eval,
    phase_pdf, phase_sample, sample_distance,
)
from mitsuba_tpu_torch.media import medium as md_mod
from mitsuba_tpu_torch.render import sampler as rs
from mitsuba_tpu_torch.render.intersect import ray_intersect, ray_test
from mitsuba_tpu_torch.render.records import Ray
from mitsuba_tpu_torch.render.sampler import Sampler

_FAR = 1e6


def volpath_trace(scene, medium, ray: Ray, sampler: Sampler, cfg: PathConfig,
                  seed: int = 0, mis: bool = True, guide=None,
                  learn_guide: bool = False, guide_alpha: float = 0.5,
                  guide_sampling: bool = None):
    """Trace radiance in an ambient participating medium (a
    `media.MediumTable`, moved to the rays' device). mis=False is the
    volpath_simple estimator (no phase-side MIS). seed keys the Woodcock
    steps (volpath.py:76). guide / learn_guide: with learn_guide the
    bounces deposit into the guide, returned as aux["guide"]; otherwise a
    guide turns guided phase sampling on (guide_sampling). Returns (L
    (N, 3), aux = dict(avg_path_length[, guide]))."""
    n = ray.o.shape[0]
    dev = ray.o.device
    d_max = cfg.max_depth
    geom, mats, em = scene.geom, scene.materials, scene.emitters
    medium = medium.to(dev)
    kind, g = medium.phase_kind, medium.phase_g
    coeffs = medium.flake_coeffs
    oriented = medium.oriented or coeffs is not None
    if guide is not None:
        guide = guide.to(dev)

    u_ch = sampler.next_stacked_1d(d_max)
    u_dist = sampler.next_stacked_1d(d_max)
    u_nee_sel = sampler.next_stacked_1d(d_max)
    u_nee_pos = sampler.next_stacked_2d(d_max)
    u_scatter = sampler.next_stacked_2d(d_max)
    u_lobe = sampler.next_stacked_1d(d_max)
    u_rr = sampler.next_stacked_1d(d_max)
    if guide_sampling is None:
        guide_sampling = guide is not None and not learn_guide
    guide_sampling = guide_sampling and guide is not None
    learn = learn_guide and guide is not None
    if guide_sampling:
        u_gpick = sampler.next_stacked_1d(d_max)
        u_gbin = sampler.next_stacked_1d(d_max)
    else:
        u_gpick = u_gbin = torch.zeros((d_max, 1), device=dev)
    # one Woodcock key a bounce (host ints)
    wd_keys = rs.split(rs.fold_in_key(rs.key(seed), 0x77), d_max)

    def bounce(depth, xs, L, throughput, o, d, mint, maxt, active, prev_pdf,
               prev_delta, depth_count, guide_mass):
        (u_ch, u_dist, u_nee_sel, u_nee_pos, u_scatter, u_lobe, u_rr,
         u_gpick, u_gbin) = xs
        ray = Ray(o, d, mint, maxt)
        is_last = depth + 1 >= d_max
        do_rr = depth >= cfg.rr_depth
        act_in = active
        its = ray_intersect(geom, ray)
        t_surf = torch.where(its.valid, its.t, _FAR)

        md = sample_distance(medium, ray.o, ray.d, t_surf, u_ch, u_dist,
                             key=wd_keys[depth])
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
        if learn:
            # the guide learns the luminance arriving along each ray
            inc = torch.where(at_surface[:, None], le, 0.0) \
                + torch.where(escaped[:, None], env, 0.0)
            lum = 0.2126 * inc[:, 0] + 0.7152 * inc[:, 1] \
                + 0.0722 * inc[:, 2]
            guide_mass = gd.guide_update(
                dataclasses.replace(guide, mass=guide_mass), ray.o.detach(),
                ray.d.detach(), lum.detach(), act_in & (lum > 0)).mass
        lum_pdf = pdf_direct_area(em, its.prim_id, ray.o, its.p, its.geo_n)
        w_bsdf = torch.where(prev_delta, 1.0, mi_weight(prev_pdf, lum_pdf))
        L = L + torch.where(at_surface[:, None],
                            thr_surf * le * w_bsdf[:, None], 0.0)

        cont_m = in_medium & (not is_last)
        cont_s = at_surface & (not is_last)

        # NEE: one emitter sample, from the scatter point of each lane
        p_scatter = torch.where(in_medium[:, None], md["p"], its.p)
        ds = sample_direct(em, geom, p_scatter, u_nee_sel, u_nee_pos)
        ph_axis = md_mod.lookup_orientation(medium, p_scatter) \
            if oriented else None
        ph_val = phase_eval(kind, g, ray.d, ds.d, ph_axis, coeffs)
        ph_pdf = phase_pdf(kind, g, ray.d, ds.d, ph_axis, coeffs) if mis \
            else torch.zeros(n, device=dev)
        if guide_sampling:
            # the medium scatters by the α·phase + (1-α)·guide mixture, so
            # MIS weighs NEE against the mixture's pdf
            p_det = p_scatter.detach()
            g_dir, g_pdf_s, g_ok = gd.guide_sample(guide, p_det, u_scatter,
                                                   u_gbin)
            alpha_l = torch.where(g_ok, guide_alpha, 1.0)
            if mis:
                ph_pdf = alpha_l * ph_pdf + (1.0 - alpha_l) * gd.guide_pdf(
                    guide, p_det, ds.d.detach())
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
        wo_phase, phase_p = phase_sample(kind, g, ray.d, u_scatter, ph_axis,
                                         coeffs)
        w_med = None
        if guide_sampling:
            pick_g = g_ok & (u_gpick >= alpha_l)
            # a lane whose phase sampling failed (pdf 0: the flake's
            # proposals all rejected) stays dead unless the guide drew it
            ph_dead = ~pick_g & (phase_p <= 0)
            wo_mix = torch.where(pick_g[:, None], g_dir, wo_phase)
            ph_mix = phase_eval(kind, g, ray.d, wo_mix, ph_axis, coeffs)
            pg_mix = torch.where(pick_g, g_pdf_s, gd.guide_pdf(
                guide, p_det, wo_mix.detach()))
            q_mix = alpha_l * ph_mix + (1.0 - alpha_l) * pg_mix
            wo_phase = wo_mix
            # the medium's weight: phase / q (1 for exact phase sampling)
            w_med = torch.where((q_mix > 1e-12) & ~ph_dead,
                                ph_mix / torch.clamp(q_mix, min=1e-12), 0.0)
            phase_p = torch.where(ph_dead, 0.0, q_mix)
        bs = bsdf_sample(mats, its.material_id, its.wi, u_scatter, u_lobe)
        wo_world = torch.where(in_medium[:, None], wo_phase,
                               its.to_world(bs["wo"]))
        next_pdf = torch.where(in_medium, phase_p if mis else 0.0, bs["pdf"])
        next_delta = torch.where(in_medium, not mis, bs["delta"])
        med_ok = phase_p > 0 if kind == MICROFLAKE_GAUSS else True
        scatter_ok = torch.where(in_medium, med_ok, bs["valid"])
        active = (cont_m | cont_s) & scatter_ok
        if w_med is not None:
            thr_med = thr_med * w_med[:, None]
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
                next_pdf.detach(), next_delta, depth_count, guide_mass)

    state = (
        torch.zeros((n, 3), device=dev),                # L
        torch.ones((n, 3), device=dev),                 # throughput
        ray.o, ray.d, ray.mint, ray.maxt,
        torch.ones(n, dtype=torch.bool, device=dev),    # active
        torch.zeros(n, device=dev),                     # prev_pdf
        torch.ones(n, dtype=torch.bool, device=dev),    # prev_delta
        torch.zeros(n, dtype=torch.int32, device=dev),  # depth_count
        guide.mass if learn else torch.zeros((), device=dev),
    )
    xs = (u_ch, u_dist, u_nee_sel, u_nee_pos, u_scatter, u_lobe, u_rr,
          u_gpick, u_gbin)
    remat = cfg.remat and requires_grad(
        geom, mats, em, scene.textures, scene.camera, medium, ray)
    for depth in range(d_max):
        state = run_bounce(bounce, depth, state, xs, remat)
    aux = {"avg_path_length": state[9].to(torch.float32).mean()}
    if learn:
        aux["guide"] = dataclasses.replace(guide, mass=state[10])
    return state[0], aux


def render_volpath(scene, medium, cfg: PathConfig, seed: int = 0,
                   mis: bool = True, guide=None, learn_guide: bool = False,
                   guide_alpha: float = 0.5, guide_sampling: bool = None):
    """Render the scene in an ambient medium to an (H, W, 3) image on the
    scene's device: the mean of each pixel's spp samples, lanes in
    scanline order (volpath.py:280). mis=False renders volpath_simple."""
    ray, sampler, _ = camera_wavefront(scene, cfg, seed, morton=False)
    L, aux = volpath_trace(scene, medium, ray, sampler, cfg, seed=seed,
                           mis=mis, guide=guide, learn_guide=learn_guide,
                           guide_alpha=guide_alpha,
                           guide_sampling=guide_sampling)
    return L.reshape(scene.height, scene.width, cfg.spp, 3).mean(dim=2), aux


def scene_guide(scene, res: int = 16):
    """An empty guide over the scene's triangle-vertex box, padded by 1%
    of its extent (volpath.py:319-322)."""
    v0 = scene.geom.v0.detach().cpu().numpy()
    ext = v0.max(0) - v0.min(0)
    return gd.make_guide(v0.min(0) - 0.01 * ext, v0.max(0) + 0.01 * ext,
                         res=res, device=scene.device)


def render_volpath_guided(scene, medium, cfg: PathConfig, seed: int = 0,
                          mis: bool = True, learn_frac: float = 0.5,
                          guide_alpha: float = 0.5, res: int = 16):
    """Volumetric path guiding (volpath.py:305): a learning pass of
    learn_frac of the samples, then a guided pass of the rest from seed +
    7507, the image their spp-weighted mean. Returns (image, aux of the
    last pass, with the learned guide as aux["guide"] when there is no
    guided pass)."""
    spp1 = max(1, int(round(cfg.spp * learn_frac)))
    spp2 = max(0, cfg.spp - spp1)
    img1, aux1 = render_volpath(scene, medium,
                                dataclasses.replace(cfg, spp=spp1),
                                seed=seed, mis=mis, guide=scene_guide(
                                    scene, res), learn_guide=True)
    if spp2 == 0:
        return img1, aux1
    img2, aux2 = render_volpath(scene, medium,
                                dataclasses.replace(cfg, spp=spp2),
                                seed=seed + 7507, mis=mis,
                                guide=aux1.pop("guide"),
                                guide_alpha=guide_alpha)
    return (img1 * spp1 + img2 * spp2) / (spp1 + spp2), aux2


# ---------------------------------------------------------------------------
# Shape-interior media (reference: Shape interior/exterior media, crossed
# by volpath.cpp at refractive boundaries): a per-lane current-medium
# index through the bounce loop (media/medium.py MediumStack).
# ---------------------------------------------------------------------------

def boundary_transmittance(scene, o, d, dist, cur, max_crossings: int = 4):
    """Transmittance from o along d over [0, dist] across every medium on
    the segment (reference scene.cpp:417 getTransmittance): walk the
    boundary crossings, attenuate each segment by its medium, switch media
    at surfaces that do not occlude (opacity < 1: `null()`), and block at
    opaque ones. cur: (N,) current medium index (-1: vacuum). Up to
    max_crossings closest-hit queries (the reference walks up to 100);
    lanes still unresolved then attenuate the rest by their current
    medium. Lanes that are done query with maxt = -1."""
    stack = scene.media
    interior = scene.shape_interior
    n = o.shape[0]
    dev = o.device
    tr = torch.ones((n, 3), device=dev)
    t0 = torch.zeros(n, device=dev)
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    eps = m.EPSILON * torch.clamp(torch.abs(o).amax(dim=-1), min=1.0)

    def seg_transmittance(cur, t0, seg_len):
        ss, sa, _g, inside = md_mod.stack_params(stack, cur)
        if stack is not None and stack.has_hetero:
            seg_tr = md_mod.stack_transmittance_het(
                stack, cur, ss, sa, o + d * t0[:, None], d, seg_len)
        else:
            seg_tr = md_mod.stack_transmittance(ss, sa, seg_len)
        return torch.where(inside[:, None], seg_tr, 1.0)

    for _ in range(max_crossings):
        seg_ray = Ray.make(o, d, mint=t0 + eps,
                           maxt=torch.where(done, -1.0, dist))
        its = ray_intersect(scene.geom, seg_ray)
        hit = its.valid & (its.t < dist) & ~done
        seg_end = torch.where(hit, its.t, dist)
        seg_tr = seg_transmittance(cur, t0,
                                   torch.clamp(seg_end - t0, min=0.0))
        tr = tr * torch.where(done[:, None], 1.0, seg_tr)
        mclip = torch.clamp(its.material_id, 0,
                            scene.materials.n_materials - 1).long()
        opac = scene.materials.opacity[mclip]
        tr = torch.where(hit[:, None], tr * (1.0 - opac[:, None]), tr)
        sid = torch.clamp(its.shape_id, 0, interior.shape[0] - 1).long()
        entering = torch.sum(d * its.geo_n, dim=-1) < 0
        cur = torch.where(hit, torch.where(entering, interior[sid], -1), cur)
        done = done | ~hit
        t0 = torch.where(hit, its.t, t0)
    rest = seg_transmittance(cur, t0, torch.clamp(dist - t0, min=0.0))
    return tr * torch.where(done[:, None], 1.0, rest)


def volpath_media_trace(scene, ray: Ray, sampler: Sampler, cfg: PathConfig,
                        mis: bool = True, seed_het: int = 17):
    """Volumetric path tracing with per-shape interior media
    (volpath.py:397). Each lane carries the index of the medium it
    travels through (-1: vacuum); a transmitted ray entering a shape
    switches to scene.shape_interior[shape], leaving one returns to
    vacuum (one level of nesting). Grid media run Woodcock tracking from
    split(key(seed_het), depth)'s keys. Returns (L (N, 3),
    aux = dict(avg_path_length))."""
    n = ray.o.shape[0]
    dev = ray.o.device
    d_max = cfg.max_depth
    geom, mats, em = scene.geom, scene.materials, scene.emitters
    stack = scene.media
    interior = scene.shape_interior
    has_het = stack is not None and stack.has_hetero
    woodcock_keys = rs.split(rs.key(seed_het), d_max) if has_het else None

    u_ch = sampler.next_stacked_1d(d_max)
    u_dist = sampler.next_stacked_1d(d_max)
    u_nee_sel = sampler.next_stacked_1d(d_max)
    u_nee_pos = sampler.next_stacked_2d(d_max)
    u_scatter = sampler.next_stacked_2d(d_max)
    u_lobe = sampler.next_stacked_1d(d_max)
    u_rr = sampler.next_stacked_1d(d_max)

    def bounce(depth, xs, L, throughput, o, d, mint, maxt, active, prev_pdf,
               prev_delta, depth_count, cur):
        u_ch, u_dist, u_nee_sel, u_nee_pos, u_scatter, u_lobe, u_rr = xs
        ray = Ray(o, d, mint, maxt)
        is_last = depth + 1 >= d_max
        do_rr = depth >= cfg.rr_depth
        its = ray_intersect(geom, ray)
        t_surf = torch.where(its.valid, its.t, _FAR)

        ss, sa, g_lane, inside = md_mod.stack_params(stack, cur)
        if has_het:
            md = md_mod.stack_sample_distance_het(
                stack, cur, ss, sa, ray.o, ray.d, t_surf, u_ch, u_dist,
                woodcock_keys[depth])
        else:
            md = md_mod.stack_sample_distance(ss, sa, t_surf, u_ch, u_dist)
        md_valid = md["valid"] & inside
        in_medium = active & md_valid
        at_surface = active & ~md_valid & its.valid
        escaped = active & ~md_valid & ~its.valid
        p_med = ray.o + ray.d * md["t"][:, None]

        thr_med = throughput * md["weight"]
        thr_surf = throughput * torch.where(inside[:, None],
                                            md["surface_weight"], 1.0)

        env = eval_environment(em, ray.d)
        env_pdf = pdf_environment(em, ray.d)
        w_env = torch.where(prev_delta, 1.0, mi_weight(prev_pdf, env_pdf))
        L = L + torch.where(escaped[:, None], thr_surf * env * w_env[:, None],
                            0.0)

        depth_count = depth_count + (in_medium | at_surface).to(torch.int32)

        le = eval_emitter_hit(em, its.emitter_id, -ray.d, its.geo_n)
        lum_pdf = pdf_direct_area(em, its.prim_id, ray.o, its.p, its.geo_n)
        w_bsdf = torch.where(prev_delta, 1.0, mi_weight(prev_pdf, lum_pdf))
        L = L + torch.where(at_surface[:, None],
                            thr_surf * le * w_bsdf[:, None], 0.0)

        cont_m = in_medium & (not is_last)
        cont_s = at_surface & (not is_last)

        p_scatter = torch.where(in_medium[:, None], p_med, its.p)
        ds = sample_direct(em, geom, p_scatter, u_nee_sel, u_nee_pos)
        ph_val = phase_eval(HG, g_lane, ray.d, ds.d)
        ph_pdf = phase_pdf(HG, g_lane, ray.d, ds.d) if mis \
            else torch.zeros(n, device=dev)
        wo_local = its.to_local(ds.d)
        fcos = bsdf_eval(mats, its.material_id, its.wi, wo_local)
        b_pdf = bsdf_pdf(mats, its.material_id, its.wi, wo_local)

        eps = m.EPSILON * torch.clamp(torch.abs(p_scatter).amax(dim=-1),
                                      min=1.0)
        # a degenerate emitter sample can carry a NaN distance: sanitise it
        # before the exp (volpath.py:494)
        base_ok = (cont_m | cont_s) & ds.valid & (ds.pdf > 0)
        dist_safe = torch.where(base_ok, ds.dist, 0.0)
        if interior is not None:
            # shadow transmittance across the boundaries up to the light
            tr = boundary_transmittance(scene, p_scatter, ds.d,
                                        dist_safe * (1.0 - 1e-3), cur)
            occluded = tr.amax(dim=-1) <= 1e-7
        else:
            shadow = Ray.make(p_scatter, ds.d, mint=eps,
                              maxt=dist_safe * (1.0 - 1e-3))
            occluded = ray_test(geom, shadow)
            tr = torch.where(inside[:, None],
                             md_mod.stack_transmittance(ss, sa, dist_safe),
                             1.0)

        nee_ok = (cont_m | cont_s) & ds.valid & (ds.pdf > 0) & ~occluded
        scatter_pdf = torch.where(in_medium, ph_pdf, b_pdf)
        # sanitise before the arithmetic: masked lanes' garbage pdfs would
        # overflow mi_weight into NaN, which the gradient would carry
        pdf_safe = torch.where(nee_ok, ds.pdf, 1.0)
        spdf_safe = torch.where(nee_ok, scatter_pdf, 1.0)
        w_nee = torch.where(ds.delta, 1.0, mi_weight(pdf_safe, spdf_safe))
        f_scatter = torch.where(in_medium[:, None], ph_val[:, None], fcos)
        thr_here = torch.where(in_medium[:, None], thr_med, thr_surf)
        gate = nee_ok[:, None]
        L = L + (torch.where(gate, thr_here, 0.0)
                 * torch.where(gate, f_scatter, 0.0)
                 * torch.where(gate, ds.value, 0.0)
                 * torch.where(gate, tr, 0.0)
                 * torch.where(nee_ok,
                               w_nee / torch.clamp(pdf_safe, min=1e-20),
                               0.0)[:, None])

        wo_phase, phase_p = phase_sample(HG, g_lane, ray.d, u_scatter)
        bs = bsdf_sample(mats, its.material_id, its.wi, u_scatter, u_lobe)
        wo_world = torch.where(in_medium[:, None], wo_phase,
                               its.to_world(bs["wo"]))
        next_pdf = torch.where(in_medium, phase_p if mis else 0.0, bs["pdf"])
        next_delta = torch.where(in_medium, not mis, bs["delta"])
        scatter_ok = torch.where(in_medium, True, bs["valid"])
        active = (cont_m | cont_s) & scatter_ok
        new_thr = torch.where(in_medium[:, None], thr_med,
                              thr_surf * bs["weight"])

        # the medium changes where a transmitted ray crosses a surface
        if interior is not None:
            sid = torch.clamp(its.shape_id, 0, interior.shape[0] - 1).long()
            entering = torch.sum(wo_world * its.geo_n, dim=-1) < 0
            crossed = at_surface & bs["transmission"] & active
            cur = torch.where(crossed,
                              torch.where(entering, interior[sid], -1), cur)

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
        origin = torch.where(in_medium[:, None], p_med, its.p)
        ray = Ray.make(torch.where(active[:, None], origin, ray.o),
                       torch.where(active[:, None], wo_world, ray.d),
                       mint=eps)
        return (L, throughput, ray.o, ray.d, ray.mint, ray.maxt, active,
                next_pdf.detach(), next_delta, depth_count, cur)

    state = (
        torch.zeros((n, 3), device=dev), torch.ones((n, 3), device=dev),
        ray.o, ray.d, ray.mint, ray.maxt,
        torch.ones(n, dtype=torch.bool, device=dev),
        torch.zeros(n, device=dev),
        torch.ones(n, dtype=torch.bool, device=dev),
        torch.zeros(n, dtype=torch.int32, device=dev),
        torch.full((n,), -1, dtype=torch.int32, device=dev),   # medium
    )
    xs = (u_ch, u_dist, u_nee_sel, u_nee_pos, u_scatter, u_lobe, u_rr)
    tables = [geom, mats, em, scene.textures, scene.camera, ray]
    if stack is not None:
        tables.append(stack)
    remat = cfg.remat and requires_grad(*tables)
    for depth in range(d_max):
        state = run_bounce(bounce, depth, state, xs, remat)
    return state[0], {"avg_path_length": state[9].to(torch.float32).mean()}


def render_volpath_media(scene, cfg: PathConfig, seed: int = 0,
                         mis: bool = True):
    """Render a scene whose shapes carry interior media
    (SceneBuilder.add_medium + add_shape(interior_medium=...)) to an
    (H, W, 3) image on the scene's device (volpath.py:595)."""
    ray, sampler, _ = camera_wavefront(scene, cfg, seed, morton=False)
    L, aux = volpath_media_trace(scene, ray, sampler, cfg, mis=mis)
    return L.reshape(scene.height, scene.width, cfg.spp, 3).mean(dim=2), aux
