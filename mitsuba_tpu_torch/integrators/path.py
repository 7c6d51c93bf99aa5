"""Wavefront MIS path tracer (port of mitsuba_tpu/integrators/path.py;
reference src/integrators/path/path.cpp:47 MIPathTracer::Li).

Next-event estimation and BSDF sampling combined with the power heuristic,
Russian roulette after `rr_depth`, one-sided area emitters, an environment
emitter on escape, textured albedo. All lanes advance in lockstep through
a Python loop over depth; terminated lanes are masked, never compacted.
As in the reference, the NEE shadow ray of a bounce is deferred and
answered by the next bounce's queries.

On the brute backend a bounce is one fused kernel launch for the closest
hit and the pending shadow ray; on the bvh backend it is a closest-hit
query and an any-hit query, each one launch of the BVH kernel, on lanes
in scanline order (as in the reference, path.py:982). With sorted
bounces (`sort_rays`, forced on the cluster backend, instanced or not, as
in the reference) the first bounce runs on the camera lanes as they come,
at the coherent cull caps and with no shadow query (there is no pending
NEE yet), and every later bounce sorts its live rays by octant-major
Morton keys before the closest-hit query and sorts the pending shadow
rays the same way before the any-hit query, un-permuting both results
(path.py:522-547). `render` orders the camera lanes by pixel Morton code
on the cluster backend only; sorted brute bounces run the split kernels
#2 and #3 on scanline lanes.

Reverse-mode gradients flow through the glue, as in the reference:
every sampling decision is detached (the sample fields, the BSDF pdf that
made a ray, the Russian-roulette albedo), radiance values, BSDF values
and pdf ratios are not, and the hit records are constants (no kernel has
a backward; a wrapper given a float input that requires grad raises).
With `remat` (the default) each bounce, the sorted path's first included,
is a `torch.utils.checkpoint` where grad is enabled and a scene tensor
requires grad: the backward recomputes it, launching its kernels again.
A forward render takes the plain loop. The options of the reference that
the port does not implement raise NotImplementedError.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, replace
from typing import NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from mitsuba_tpu_torch.bsdfs import bsdf_eval, bsdf_pdf, bsdf_sample
from mitsuba_tpu_torch.core import math as m
from mitsuba_tpu_torch.emitters import (
    eval_and_pdf_environment, eval_emitter_hit, pdf_direct_area,
    sample_direct,
)
from mitsuba_tpu_torch.render.film import develop
from mitsuba_tpu_torch.render.rfilter import make_rfilter
from mitsuba_tpu_torch.render.intersect import (
    ray_intersect, ray_intersect_and_test, ray_test,
)
from mitsuba_tpu_torch.render.records import Intersection, Ray
from mitsuba_tpu_torch.render.sampler import Sampler, sample_position
from mitsuba_tpu_torch.render.texture import eval_texture


@dataclass(frozen=True)
class PathConfig:
    max_depth: int = 5          # reference maxDepth (bounces incl. first hit)
    rr_depth: int = 10          # start Russian roulette after this depth
    spp: int = 16
    pattern: str = "independent"   # render/sampler.py PATTERNS
    rfilter: str = "box"           # reconstruction filter (render/rfilter.py)
    # Morton-sort rays per bounce; forced on for cluster scenes
    sort_rays: bool = False
    sort_mode: str = "full"     # octant-major Morton argsort ('octant',
                                # the reference's counting sort, is not
                                # ported)
    # checkpoint each bounce for reverse-mode autodiff: its activations are
    # recomputed in the backward, so memory stays O(1) in depth
    remat: bool = True
    # options of the reference that are not ported: each must keep its
    # default, or path_trace raises
    strict_normals: bool = False
    hit_prediction: bool = False
    mip_filter: bool = False
    aniso_filter: bool = False
    skip_direct_emission: bool = False


_UNPORTED = ("strict_normals", "hit_prediction", "mip_filter",
             "aniso_filter", "skip_direct_emission")


def _check_config(cfg: PathConfig):
    on = [name for name in _UNPORTED if getattr(cfg, name)]
    if on:
        raise NotImplementedError(f"PathConfig options not ported: {on}")
    if cfg.sort_mode != "full":
        raise NotImplementedError(
            f"sort_mode '{cfg.sort_mode}' is not ported (only 'full')")


def _morton_keys(o, d, bmin, bmax):
    """Direction octant in the top bits, then a 3 x 10-bit Morton code of
    the origin in the scene box, without its 3 lowest bits (path.py:91)."""
    q = torch.clamp((o - bmin) / torch.clamp(bmax - bmin, min=1e-6)
                    * 1023.0, 0, 1023).to(torch.int32)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    morton = spread(q[:, 0]) | (spread(q[:, 1]) << 1) \
        | (spread(q[:, 2]) << 2)
    octant = ((d[:, 0] > 0).to(torch.int32)
              + 2 * (d[:, 1] > 0).to(torch.int32)
              + 4 * (d[:, 2] > 0).to(torch.int32))
    return (octant << 27) | (morton >> 3)


def pixel_morton_perm(w: int, h: int) -> np.ndarray:
    """Wavefront slot i -> pixel index in Morton (Z-curve) order, so that
    a 128-lane row covers a compact pixel tile (path.py:123). Host numpy."""
    ix = np.arange(w * h, dtype=np.uint64) % np.uint64(w)
    iy = np.arange(w * h, dtype=np.uint64) // np.uint64(w)

    def spread(x):
        x = (x | (x << np.uint64(16))) & np.uint64(0x0000FFFF0000FFFF)
        x = (x | (x << np.uint64(8))) & np.uint64(0x00FF00FF00FF00FF)
        x = (x | (x << np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
        x = (x | (x << np.uint64(2))) & np.uint64(0x3333333333333333)
        x = (x | (x << np.uint64(1))) & np.uint64(0x5555555555555555)
        return x

    code = spread(ix) | (spread(iy) << np.uint64(1))
    return np.argsort(code, kind="stable")


def _bounce_order(geom, ray: Ray):
    """Stable argsort of octant-major Morton keys, dead lanes last."""
    keys = _morton_keys(ray.o, ray.d, geom.bvh_min[0], geom.bvh_max[0])
    keys = torch.where(ray.maxt < ray.mint, 0x7FFFFFFF, keys)
    return torch.argsort(keys, stable=True)


def _perm_ray(ray: Ray, order) -> Ray:
    return Ray(ray.o[order], ray.d[order], ray.mint[order], ray.maxt[order])


def _sorted_intersect(scene, ray: Ray) -> Intersection:
    """Sort, intersect, un-permute the record (path.py:289)."""
    order = _bounce_order(scene.geom, ray)
    its_s = ray_intersect(scene.geom, _perm_ray(ray, order))
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], device=order.device)
    return Intersection(**{f: getattr(its_s, f)[inv]
                           for f in Intersection.__dataclass_fields__})


def _sorted_test(scene, ray: Ray):
    """Sorted shadow query; the occlusion bit returns to lane order by a
    scatter through the forward order (path.py:324)."""
    order = _bounce_order(scene.geom, ray)
    occ_s = ray_test(scene.geom, _perm_ray(ray, order))
    occ = torch.zeros_like(occ_s)
    occ[order] = occ_s
    return occ


def mi_weight(pdf_a, pdf_b):
    """Power heuristic, beta=2 (reference path.cpp:218)."""
    a2 = pdf_a * pdf_a
    b2 = pdf_b * pdf_b
    return torch.where(pdf_a > 0, a2 / torch.clamp(a2 + b2, min=1e-20), 0.0)


class _State(NamedTuple):
    """What one bounce hands the next: tensors only, so that a bounce can
    be a checkpoint."""
    L: torch.Tensor
    throughput: torch.Tensor
    o: torch.Tensor             # the ray
    d: torch.Tensor
    mint: torch.Tensor
    maxt: torch.Tensor
    active: torch.Tensor
    prev_pdf: torch.Tensor      # BSDF pdf that made the ray (detached)
    prev_delta: torch.Tensor    # True for the camera ray
    depth_count: torch.Tensor
    pend_o: torch.Tensor        # the deferred NEE shadow ray
    pend_d: torch.Tensor
    pend_mint: torch.Tensor
    pend_maxt: torch.Tensor
    pend_contrib: torch.Tensor
    pend_ok: torch.Tensor


def requires_grad(*tables) -> bool:
    """True where grad is enabled and a tensor of the given dataclasses (a
    scene's tables, a wavefront's rays) requires grad."""
    return torch.is_grad_enabled() and any(
        isinstance(x, torch.Tensor) and x.requires_grad
        for t in tables for x in vars(t).values())


def run_bounce(bounce, depth: int, state, xs, remat: bool):
    """`bounce(depth, xs at depth, *state) -> state`, as a checkpoint under
    `remat` (path.py:903,912): its activations are dropped after the
    forward and recomputed, kernels included, by the backward. xs: the
    (D, ...) per-depth sample fields, detached as the reference's are."""
    x = tuple(u[depth].detach() for u in xs)
    if remat:
        return checkpoint(functools.partial(bounce, depth), x, *state,
                          use_reentrant=False, preserve_rng_state=False)
    return bounce(depth, x, *state)


def path_trace(scene, ray: Ray, sampler: Sampler, cfg: PathConfig):
    """Trace radiance along the given camera rays. Returns (L, aux) with
    L (N, C) and aux = dict(avg_path_length, rays_traced). Differentiable
    with respect to the scene's material, emitter and texture tensors; with
    `cfg.remat` each bounce is a checkpoint where grad is enabled and a
    scene tensor requires grad, and otherwise the loop runs as is."""
    if scene.geom.backend == "cluster" and not cfg.sort_rays:
        # the cluster cull needs direction- and position-coherent rows
        cfg = replace(cfg, sort_rays=True)
    _check_config(cfg)
    n = ray.o.shape[0]
    dev = ray.o.device
    d_max = cfg.max_depth
    geom, mats, em = scene.geom, scene.materials, scene.emitters
    tex = scene.textures

    # per-depth random fields, drawn up front in the reference's order
    u_nee_sel = sampler.next_stacked_1d(d_max)       # (D, N)
    u_nee_pos = sampler.next_stacked_2d(d_max)       # (D, N, 2)
    u_bsdf_2d = sampler.next_stacked_2d(d_max)
    u_lobe = sampler.next_stacked_1d(d_max)
    u_rr = sampler.next_stacked_1d(d_max)

    def bounce(depth, xs, L, throughput, o, d, mint, maxt, active, prev_pdf,
               prev_delta, depth_count, pend_o, pend_d, pend_mint,
               pend_maxt, pend_contrib, pend_ok):
        u_nee_sel, u_nee_pos, u_bsdf_2d, u_lobe, u_rr = xs
        ray = Ray(o, d, mint, maxt)
        pend_ray = Ray(pend_o, pend_d, pend_mint, pend_maxt)
        is_last = depth + 1 >= d_max
        do_rr = depth >= cfg.rr_depth
        if not cfg.sort_rays:
            its, s_occ = ray_intersect_and_test(geom, ray, pend_ray)
        elif depth == 0 and d_max > 1:
            # camera lanes arrive pixel-Morton ordered and coherent, and
            # no NEE is pending yet
            its = ray_intersect(geom, ray, coherent=True)
            s_occ = torch.zeros(n, dtype=torch.bool, device=dev)
        else:
            its = _sorted_intersect(scene, ray)
            s_occ = _sorted_test(scene, pend_ray)

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
        if tex.n_textures > 0:
            tex_id = mats.tex_id[mclip]
            albedo = torch.where((tex_id >= 0)[:, None],
                                 eval_texture(tex, tex_id, its.uv), albedo)

        # next-event estimation (luminaire sampling)
        ds = sample_direct(em, geom, its.p, u_nee_sel, u_nee_pos)
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
        bs = bsdf_sample(mats, its.material_id, its.wi, u_bsdf_2d, u_lobe,
                         albedo=albedo)
        wo_world = its.to_world(bs["wo"])
        active = cont & bs["valid"]

        # Russian roulette (reference path.cpp:196) on the detached weight
        alb_rr = torch.clamp(bs["weight"].detach().amax(dim=-1), max=0.9)
        kill = do_rr & (u_rr > alb_rr) & ~bs["transmission"]
        rr_scale = torch.where(do_rr & ~bs["transmission"],
                               1.0 / torch.clamp(alb_rr, min=1e-3), 1.0)
        active = active & ~kill
        throughput = throughput * torch.where(active, rr_scale, 1.0)[:, None]
        throughput = throughput * torch.where(active[:, None], bs["weight"],
                                              1.0)
        # dead lanes keep o/d but get maxt = -1 so they trace nothing
        return _State(
            L, throughput, torch.where(active[:, None], its.p, ray.o),
            torch.where(active[:, None], wo_world, ray.d), eps,
            torch.where(active, float("inf"), -1.0), active,
            bs["pdf"].detach(), bs["delta"], depth_count, pend_ray.o,
            pend_ray.d, pend_ray.mint, pend_ray.maxt, pend_contrib, pend_ok)

    n_ch = mats.reflectance.shape[-1]
    # deferred NEE: the shadow ray fires with the NEXT bounce's closest
    # hit; its contribution lands one bounce later
    pend_ray = Ray.make(ray.o, ray.d, maxt=-1.0)
    state = _State(
        torch.zeros((n, n_ch), device=dev), torch.ones((n, n_ch), device=dev),
        ray.o, ray.d, ray.mint, ray.maxt,
        torch.ones(n, dtype=torch.bool, device=dev),
        torch.zeros(n, device=dev),
        torch.ones(n, dtype=torch.bool, device=dev),
        torch.zeros(n, dtype=torch.int32, device=dev),
        pend_ray.o, pend_ray.d, pend_ray.mint, pend_ray.maxt,
        torch.zeros((n, n_ch), device=dev),
        torch.zeros(n, dtype=torch.bool, device=dev))
    xs = (u_nee_sel, u_nee_pos, u_bsdf_2d, u_lobe, u_rr)
    remat = cfg.remat and requires_grad(geom, mats, em, tex, scene.camera,
                                        ray)
    rays_traced = torch.zeros((), dtype=torch.int64, device=dev)
    for depth in range(d_max):
        rays_traced = rays_traced + state.active.sum() + state.pend_ok.sum()
        state = run_bounce(bounce, depth, state, xs, remat)

    aux = {
        "avg_path_length": state.depth_count.to(torch.float32).mean(),
        "rays_traced": rays_traced,
    }
    return state.L, aux


def camera_samples(scene, cfg: PathConfig, seed: int = 0, morton=None):
    """The camera rays and sampler of `render`: lane = pixel * spp +
    sample, with pixels in Morton order if `morton` (default: on the
    cluster backend). Returns (ray, sampler, offset, inv_lane): offset the
    (N, 2) sub-pixel positions of cfg.pattern, inv_lane restoring
    scanline lane order (None without Morton order)."""
    w, h, spp = scene.width, scene.height, cfg.spp
    n = w * h * spp
    dev = scene.device
    lane = torch.arange(n, dtype=torch.int32, device=dev)
    inv_lane = None
    if morton is None:
        morton = scene.geom.backend == "cluster"
    if morton:
        perm_px = pixel_morton_perm(w, h)
        pixel_id = torch.as_tensor(perm_px.astype(np.int32),
                                   device=dev)[lane.long() // spp]
        lane_np = np.arange(n)
        lane_tgt = perm_px[lane_np // spp] * spp + lane_np % spp
        inv_lane = torch.as_tensor(np.argsort(lane_tgt), device=dev)
    else:
        pixel_id = lane // spp
    sample_id = lane % spp
    px = (pixel_id % w).to(torch.float32)
    py = (pixel_id // w).to(torch.float32)
    sampler = Sampler(seed, pixel_id, sample_id)
    jitter = sampler.next_2d()
    offset = sample_position(cfg.pattern, sample_id, spp, jitter)
    uv = torch.stack([(px + offset[:, 0]) / w, (py + offset[:, 1]) / h],
                     dim=-1)
    return scene.camera.sample_ray(uv), sampler, offset, inv_lane


def camera_wavefront(scene, cfg: PathConfig, seed: int = 0, morton=None):
    """`camera_samples` without the offsets: (ray, sampler, inv_lane)."""
    ray, sampler, _, inv_lane = camera_samples(scene, cfg, seed, morton)
    return ray, sampler, inv_lane


def render(scene, cfg: PathConfig, seed: int = 0):
    """Render the scene to an (H, W, C) image on the scene's device,
    developed with cfg.rfilter; on Morton lanes the radiance and the
    offsets return to scanline order together (path.py:1003-1007)."""
    ray, sampler, offset, inv_lane = camera_samples(scene, cfg, seed)
    L, aux = path_trace(scene, ray, sampler, cfg)
    if inv_lane is not None:
        L, offset = L[inv_lane], offset[inv_lane]
    return develop(L, offset, cfg.spp, scene.height, scene.width,
                   make_rfilter(cfg.rfilter)), aux
