"""Wavefront MIS path tracer (port of mitsuba_tpu/integrators/path.py;
reference src/integrators/path/path.cpp:47 MIPathTracer::Li).

Next-event estimation and BSDF sampling combined with the power heuristic,
Russian roulette after `rr_depth`, one-sided area emitters (triangles and
analytic spheres), point, spot, directional and collimated lights, an
environment emitter on escape, textured albedo: bilinear, or from the
ray cone's footprint trilinear (`mip_filter`) or anisotropic
(`aniso_filter`). All lanes advance in lockstep through
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
requires grad: the backward recomputes it, launching its kernels again
(the Morton sort, the exact cull's syncs and the instance walks give
the same hits again). A forward render takes the plain loop. The
gradient reaches every backend's renders and a subsurface scene's
dipole gather and irradiance cache (subsurface/dipole.py).

Every option of the reference's `PathConfig` is ported: `strict_normals`
(a lane dies where the geometric and shading normals disagree about
either side of the bounce), `skip_direct_emission` (the depth-0 emitter
and environment terms gated off, for the subsurface cache's indirect
estimate), `sort_mode="octant"` (a stable sort on the direction octant
alone, the reference's counting sort) and `hit_prediction` (a (cell,
octant) table of recently hit triangles: an exact Möller–Trumbore test
against the cached triangle bounds the closest-hit query's maxt and
answers the shadow query outright where it blocks the segment, so the
image is the same). A scene with subsurface entries adds each hit's
dipole gather (subsurface/dipole.py) and `render` fills their irradiance
cache first; a guide (integrators/guiding.py) makes the bounces learn it
or sample the α·BSDF + (1-α)·guide mixture (`render_guided`).
`render_motion` averages renders of scenes baked at stratified shutter
times (render/scene.py `build_time_scenes`).
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
    predicted_hit_bound, ray_intersect, ray_intersect_and_test, ray_test,
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
    # 'full': octant-major Morton argsort; 'octant': stable sort on the
    # direction octant alone (lanes keep their order within an octant)
    sort_mode: str = "full"
    # checkpoint each bounce for reverse-mode autodiff: its activations are
    # recomputed in the backward, so memory stays O(1) in depth
    remat: bool = True
    # ray-cone texture lod: trilinear MIP lookups of bitmaps from the
    # cone's footprint (needs a scene built with mips, else bilinear)
    mip_filter: bool = False
    # EWA-style anisotropic filtering of bitmaps (implies mip_filter)
    aniso_filter: bool = False
    # kill paths whose shading and geometric normals disagree about the
    # side of wi or wo (reference path.cpp:100-104)
    strict_normals: bool = False
    # hash-based ray-path prediction (arXiv:1910.01304): exact maxt bounds
    # for closest hits and a shadow cache for NEE rays, same image
    hit_prediction: bool = False
    # zero the depth-0 emitter-hit and environment terms (the subsurface
    # cache's indirect estimate adds its own NEE)
    skip_direct_emission: bool = False


SORT_MODES = ("full", "octant")


def _check_config(cfg: PathConfig):
    if cfg.sort_mode not in SORT_MODES:
        raise ValueError(f"unknown sort_mode '{cfg.sort_mode}' "
                         f"(one of {SORT_MODES})")


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
    return (_octants(d) << 27) | (morton >> 3)


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


def _octants(d):
    return ((d[:, 0] > 0).to(torch.int32) + 2 * (d[:, 1] > 0).to(torch.int32)
            + 4 * (d[:, 2] > 0).to(torch.int32))


def _bounce_order(geom, ray: Ray, mode: str = "full"):
    """The bounce's lane order, dead lanes last (path.py:193): a stable
    argsort of octant-major Morton keys ('full'), or of the direction
    octant alone ('octant': the reference's stable counting sort gives the
    same permutation)."""
    dead = ray.maxt < ray.mint
    if mode == "octant":
        keys = torch.where(dead, 8, _octants(ray.d))
    else:
        keys = torch.where(dead, 0x7FFFFFFF, _morton_keys(
            ray.o, ray.d, geom.bvh_min[0], geom.bvh_max[0]))
    return torch.argsort(keys, stable=True)


def _perm_ray(ray: Ray, order) -> Ray:
    return Ray(ray.o[order], ray.d[order], ray.mint[order], ray.maxt[order])


def _sorted_intersect(scene, ray: Ray, mode: str) -> Intersection:
    """Sort, intersect, un-permute the record (path.py:289)."""
    order = _bounce_order(scene.geom, ray, mode)
    its_s = ray_intersect(scene.geom, _perm_ray(ray, order))
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], device=order.device)
    return Intersection(**{f: getattr(its_s, f)[inv]
                           for f in Intersection.__dataclass_fields__})


def _sorted_test(scene, ray: Ray, mode: str):
    """Sorted shadow query; the occlusion bit returns to lane order by a
    scatter through the forward order (path.py:324). The reference's
    MTS_SHADOWSORT knob is the config's sort_mode here."""
    order = _bounce_order(scene.geom, ray, mode)
    occ_s = ray_test(scene.geom, _perm_ray(ray, order))
    occ = torch.zeros_like(occ_s)
    occ[order] = occ_s
    return occ


PRED_BITS = 21          # a 2^21-entry prediction table (8 MiB of int32)


def _pred_keys(o, d, bmin, bmax):
    """Prediction-table key (path.py:180): a 64³ origin cell in the scene
    box and the direction octant."""
    q = torch.clamp((o - bmin) / torch.clamp(bmax - bmin, min=1e-6) * 63.0,
                    0, 63).to(torch.int32)
    cell = (q[:, 0] << 12) | (q[:, 1] << 6) | q[:, 2]
    return ((_octants(d) << 18) | cell).long()


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
    path_len: torch.Tensor      # distance travelled (the ray cone's)
    pend_o: torch.Tensor        # the deferred NEE shadow ray
    pend_d: torch.Tensor
    pend_mint: torch.Tensor
    pend_maxt: torch.Tensor
    pend_contrib: torch.Tensor
    pend_ok: torch.Tensor
    pred_table: torch.Tensor    # (2^PRED_BITS,) prims, or () when off
    pred_hits: torch.Tensor     # queries with a usable prediction
    guide_mass: torch.Tensor    # the guide's mass while learning, or ()


def requires_grad(*tables) -> bool:
    """True where grad is enabled and a tensor of the given dataclasses (a
    scene's tables, a wavefront's rays) requires grad, one in a tuple
    field (a texture's images) included."""
    def tensors(t):
        for x in vars(t).values():
            yield from x if isinstance(x, tuple) else (x,)

    return torch.is_grad_enabled() and any(
        isinstance(x, torch.Tensor) and x.requires_grad
        for t in tables for x in tensors(t))


def _cone_duv_aniso(geom, its, d, width):
    """Anisotropic uv footprint of the ray cone at the hit (path.py:339):
    the cone's disc of diameter `width` lands on the surface as an
    ellipse, its major axis along d's projection stretched by 1/cos, its
    minor axis across; both map to uv through the triangle's chart by a
    2 x 2 Gram solve on (e1, e2). A sphere, or a degenerate chart, takes
    an isotropic footprint from |dp_du|."""
    n = its.sh_n
    ndotd = torch.sum(n * d, dim=-1)
    cos_v = torch.abs(ndotd)
    d_proj = d - ndotd[:, None] * n
    lp2 = torch.sum(d_proj * d_proj, dim=-1, keepdim=True)
    fr = its.frame()
    t_major = torch.where(lp2 > 1e-12,
                          d_proj / torch.sqrt(torch.clamp(lp2, min=1e-24)),
                          fr.s)
    t_minor = m.cross(n, t_major)
    stretch = (width / torch.clamp(cos_v, min=0.05))[:, None]
    a_major = t_major * stretch
    a_minor = t_minor * width[:, None]

    prim_ok = (its.prim_id >= 0) & (its.prim_id < geom.n_tris)
    prim = torch.clamp(its.prim_id, 0, geom.n_tris - 1).long()
    e1, e2 = geom.e1[prim], geom.e2[prim]
    duv1 = geom.uv1[prim] - geom.uv0[prim]
    duv2 = geom.uv2[prim] - geom.uv0[prim]
    c11 = torch.sum(e1 * e1, dim=-1)
    c12 = torch.sum(e1 * e2, dim=-1)
    c22 = torch.sum(e2 * e2, dim=-1)
    det = c11 * c22 - c12 * c12
    ok = prim_ok & (torch.abs(det) > 1e-20)
    inv_det = 1.0 / torch.where(ok, det, 1.0)

    def to_uv(a):
        a1 = torch.sum(a * e1, dim=-1)
        a2 = torch.sum(a * e2, dim=-1)
        b1 = (c22 * a1 - c12 * a2) * inv_det
        b2 = (c11 * a2 - c12 * a1) * inv_det
        return b1[:, None] * duv1 + b2[:, None] * duv2

    dens = torch.clamp(m.length(its.dp_du), min=1e-6)
    f = (width / (dens * torch.clamp(cos_v, min=0.1)))[:, None]
    iso_x = torch.cat([f, torch.zeros_like(f)], dim=-1)
    duv_dx = torch.where(ok[:, None], to_uv(a_major), iso_x)
    duv_dy = torch.where(ok[:, None], to_uv(a_minor), iso_x.flip(-1))
    return duv_dx, duv_dy


def _albedo(scene, cfg, its, d, path_len, cone_alpha):
    """The reflectance of each hit's material, from its texture where it
    has one (path.py:783-806): a bitmap's EWA lookup from the ray cone's
    anisotropic footprint under `aniso_filter`, its trilinear lookup from
    the isotropic |dp_du| footprint under `mip_filter`, its bilinear texel
    otherwise; the mip filters need a scene built with mips. No vertex
    colours reach the lookup, as in the reference (ROADMAP C)."""
    mats, tex = scene.materials, scene.textures
    mclip = torch.clamp(its.material_id, 0, mats.n_materials - 1).long()
    albedo = mats.reflectance[mclip]
    if tex.n_textures == 0:
        return albedo
    tex_id = mats.tex_id[mclip]
    if cfg.aniso_filter and len(tex.mips) > 0:
        width = cone_alpha * path_len
        duv_dx, duv_dy = _cone_duv_aniso(scene.geom, its, d, width)
        val = eval_texture(tex, tex_id, its.uv, duv_dx=duv_dx,
                           duv_dy=duv_dy, aniso=True)
    elif cfg.mip_filter and len(tex.mips) > 0:
        width = cone_alpha * path_len
        dens = torch.clamp(m.length(its.dp_du), min=1e-6)
        cos_v = torch.clamp(torch.abs(its.wi[..., 2]), min=0.1)
        f = (width / (dens * cos_v))[:, None]
        duv = torch.cat([f, torch.zeros_like(f)], dim=-1)
        val = eval_texture(tex, tex_id, its.uv, duv_dx=duv,
                           duv_dy=duv.flip(-1))
    else:
        val = eval_texture(tex, tex_id, its.uv)
    return torch.where((tex_id >= 0)[:, None], val, albedo)


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


def path_trace(scene, ray: Ray, sampler: Sampler, cfg: PathConfig,
               guide=None, learn_guide: bool = False,
               guide_alpha: float = 0.5, guide_sampling: bool = None):
    """Trace radiance along the given camera rays. Returns (L, aux) with
    L (N, C) and aux = dict(avg_path_length, rays_traced, pred_hit_frac[,
    guide]). Differentiable with respect to the scene's material, emitter,
    texture and subsurface tensors (the subsurface's irradiance cache
    too, where `render` fills it under grad); with `cfg.remat` each
    bounce is a checkpoint where grad is enabled and a scene tensor
    requires grad, and otherwise the loop runs as is.

    guide (integrators/guiding.py GuideGrid): with learn_guide the
    bounces deposit the radiance arriving along each ray into it and
    return it as aux["guide"]; with guide_sampling (by default: a guide
    and no learning) each non-delta scatter draws from the α·BSDF +
    (1-α)·guide mixture, α = guide_alpha, weighted by the mixture's pdf,
    two more sample fields drawn for it (path.py:439-446)."""
    if scene.geom.backend == "cluster" and not cfg.sort_rays:
        # the cluster cull needs direction- and position-coherent rows
        cfg = replace(cfg, sort_rays=True)
    if cfg.aniso_filter and not cfg.mip_filter:
        cfg = replace(cfg, mip_filter=True)
    _check_config(cfg)
    n = ray.o.shape[0]
    dev = ray.o.device
    d_max = cfg.max_depth
    geom, mats, em = scene.geom, scene.materials, scene.emitters
    tex, ss = scene.textures, scene.subsurface
    if ss is not None:
        from mitsuba_tpu_torch.subsurface.dipole import scene_ss_lo
    if guide is not None:
        guide = guide.to(dev)
        from mitsuba_tpu_torch.integrators import guiding as gd
    # the ray cone's spread: one pixel's angle (path.py:485), in float32
    cone_alpha = float(np.float32(2.0) * np.float32(
        scene.camera.tan_half_fov_y) / np.float32(scene.height))

    # per-depth random fields, drawn up front in the reference's order
    u_nee_sel = sampler.next_stacked_1d(d_max)       # (D, N)
    u_nee_pos = sampler.next_stacked_2d(d_max)       # (D, N, 2)
    u_bsdf_2d = sampler.next_stacked_2d(d_max)
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
    pbmin, pbmax = geom.bvh_min[0], geom.bvh_max[0]

    def bounce(depth, xs, L, throughput, o, d, mint, maxt, active, prev_pdf,
               prev_delta, depth_count, path_len, pend_o, pend_d, pend_mint,
               pend_maxt, pend_contrib, pend_ok, pred_table, pred_hits,
               guide_mass):
        u_nee_sel, u_nee_pos, u_bsdf_2d, u_lobe, u_rr, u_gpick, u_gbin = xs
        ray = Ray(o, d, mint, maxt)
        pend_ray = Ray(pend_o, pend_d, pend_mint, pend_maxt)
        is_last = depth + 1 >= d_max
        do_rr = depth >= cfg.rr_depth
        # the depth-0 emission gate (skip_direct_emission)
        em_w = 0.0 if cfg.skip_direct_emission and depth == 0 else 1.0
        act_in = active
        ray_q, pend_q = ray, pend_ray
        if cfg.hit_prediction:
            # an exact hit of the cell's cached prim caps the closest-hit
            # query (the margin absorbs the kernels' other MT order), and
            # a cached prim blocking a shadow segment answers it
            kc = _pred_keys(ray.o.detach(), ray.d.detach(), pbmin, pbmax)
            pred = pred_table[kc]
            t_pred, hitp = predicted_hit_bound(geom, ray, pred)
            ray_q = Ray(ray.o, ray.d, ray.mint, torch.where(
                hitp, t_pred.detach() * (1.0 + 1e-4), ray.maxt))
            ks = _pred_keys(pend_ray.o.detach(), pend_ray.d.detach(), pbmin,
                            pbmax)
            _ts, occ_pred = predicted_hit_bound(geom, pend_ray,
                                                pred_table[ks])
            pend_q = Ray(pend_ray.o, pend_ray.d, pend_ray.mint,
                         torch.where(occ_pred, -1.0, pend_ray.maxt))
            pred_hits = pred_hits + (hitp & active).sum() \
                + (occ_pred & pend_ok).sum()
        if not cfg.sort_rays:
            its, s_occ = ray_intersect_and_test(geom, ray_q, pend_q)
        elif depth == 0 and d_max > 1 and not cfg.hit_prediction:
            # camera lanes arrive pixel-Morton ordered and coherent, and
            # no NEE is pending yet
            its = ray_intersect(geom, ray_q, coherent=True)
            s_occ = torch.zeros(n, dtype=torch.bool, device=dev)
        else:
            its = _sorted_intersect(scene, ray_q, cfg.sort_mode)
            s_occ = _sorted_test(scene, pend_q, cfg.sort_mode)
        if cfg.hit_prediction:
            s_occ = s_occ | occ_pred
            # learn this bounce's hits (static prims only: an instanced
            # virtual id cannot be re-tested without its transform)
            ok_upd = its.valid & (its.prim_id >= 0) \
                & (its.prim_id < geom.n_tris)
            pred_table = pred_table.clone()
            pred_table[kc] = torch.where(ok_upd, its.prim_id.to(torch.int32),
                                         pred)

        # resolve the previous bounce's NEE shadow ray
        L = L + torch.where((pend_ok & ~s_occ)[:, None], pend_contrib, 0.0)
        if cfg.mip_filter:
            path_len = path_len + torch.where(active & its.valid, its.t, 0.0)

        # escaped rays: background luminaire with MIS
        esc = active & ~its.valid
        env, env_pdf = eval_and_pdf_environment(em, ray.d)
        w_env = torch.where(prev_delta, 1.0, mi_weight(prev_pdf, env_pdf))
        L = _add_emission(L, em_w, esc, throughput * env * w_env[:, None])

        active = active & its.valid
        if cfg.strict_normals:
            # reference path.cpp:100-104: the shading and geometric
            # normals must agree about the side of wi
            wi_geo = -torch.sum(its.geo_n * ray.d, dim=-1)
            active = active & (wi_geo * its.wi[..., 2] > 0)
        depth_count = depth_count + active.to(torch.int32)

        # emitter hit (the BSDF-sampling side of MIS)
        if em.has_surface_emitters:
            le = eval_emitter_hit(em, its.emitter_id, -ray.d, its.geo_n)
            lum_pdf = pdf_direct_area(em, its.prim_id, ray.o, its.p,
                                      its.geo_n, emitter_id=its.emitter_id)
            w_bsdf = torch.where(prev_delta, 1.0,
                                 mi_weight(prev_pdf, lum_pdf))
            L = _add_emission(L, em_w, active,
                              throughput * le * w_bsdf[:, None])
        else:
            le = torch.zeros_like(throughput)
        if learn:
            # the guide learns the luminance arriving along each ray
            # (emitter hits and the environment), unweighted
            inc = torch.where(active[:, None], le, 0.0) \
                + torch.where(esc[:, None], env, 0.0)
            lum = 0.2126 * inc[:, 0] + 0.7152 * inc[:, 1] \
                + 0.0722 * inc[:, 2]
            guide_mass = gd.guide_update(
                replace(guide, mass=guide_mass), ray.o.detach(),
                ray.d.detach(), lum.detach(), act_in & (lum > 0)).mass
        if guide_sampling:
            # sample the guide up front, so that its pdf enters the NEE's
            # MIS weight and the scatter's mixture alike
            p_det, n_det = its.p.detach(), its.sh_n.detach()
            g_dir, g_pdf_s, g_ok = gd.guide_sample(guide, p_det, u_bsdf_2d,
                                                   u_gbin, normal=n_det)
            alpha_l = torch.where(g_ok, guide_alpha, 1.0)

        # subsurface scattering: each entry's dipole gather on the lanes
        # whose material carries it (reference Subsurface::Lo at every
        # surface interaction); the scatter into `lo` carries the
        # gradient back to those lanes
        if ss is not None:
            ssid = ss.mat_ss[torch.clamp(its.material_id, 0,
                                         ss.mat_ss.shape[0] - 1).long()]
            wo_cos = torch.abs(its.wi[..., 2])
            for s_i in range(ss.n_entries):
                sel = active & (ssid == s_i)
                lanes = torch.nonzero(sel)[:, 0]
                lo = torch.zeros_like(throughput)
                lo[lanes] = scene_ss_lo(ss, s_i, its.p[lanes],
                                        wo_cos[lanes])
                L = L + torch.where(sel[:, None], throughput * lo, 0.0)

        # beyond here only matters when this is not the final depth
        cont = active & (not is_last)
        albedo = _albedo(scene, cfg, its, ray.d, path_len, cone_alpha)

        # next-event estimation (luminaire sampling)
        ds = sample_direct(em, geom, its.p, u_nee_sel, u_nee_pos)
        wo_local = its.to_local(ds.d)
        fcos = bsdf_eval(mats, its.material_id, its.wi, wo_local,
                         albedo=albedo, uv=its.uv)
        b_pdf = bsdf_pdf(mats, its.material_id, its.wi, wo_local)
        if guide_sampling:
            # the MIS counterweight is the pdf of the mixture that scatters
            b_pdf = alpha_l * b_pdf + (1.0 - alpha_l) * gd.guide_pdf(
                guide, p_det, ds.d.detach(), normal=n_det)
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
                         albedo=albedo, uv=its.uv)
        wo_world = its.to_world(bs["wo"])
        wo_z = bs["wo"][..., 2]
        if guide_sampling:
            # one-sample mixture: with probability 1-α the guide's
            # direction (never on a delta lobe or an empty cell), weighted
            # by the mixture's pdf: unbiased for any guide content
            pick_g = ~bs["delta"] & g_ok & (u_gpick >= alpha_l) & cont
            wo_mix = torch.where(pick_g[:, None], g_dir, wo_world)
            wo_mix_l = its.to_local(wo_mix)
            fcos_mix = bsdf_eval(mats, its.material_id, its.wi, wo_mix_l,
                                 albedo=albedo, uv=its.uv)
            pb_mix = bsdf_pdf(mats, its.material_id, its.wi, wo_mix_l)
            pg_mix = torch.where(pick_g, g_pdf_s, gd.guide_pdf(
                guide, p_det, wo_mix.detach(), normal=n_det))
            q_mix = alpha_l * pb_mix + (1.0 - alpha_l) * pg_mix
            w_mix = fcos_mix / torch.clamp(q_mix, min=1e-12)[:, None]
            use_mix = ~bs["delta"]          # delta lanes keep their path
            bs = dict(
                bs,
                weight=torch.where(use_mix[:, None], w_mix, bs["weight"]),
                pdf=torch.where(use_mix, q_mix, bs["pdf"]),
                valid=torch.where(use_mix, q_mix > 1e-12, bs["valid"]))
            wo_world = torch.where(use_mix[:, None], wo_mix, wo_world)
            wo_z = torch.where(use_mix, wo_mix_l[..., 2], wo_z)
        active = cont & bs["valid"]
        if cfg.strict_normals:
            wo_geo = torch.sum(its.geo_n * wo_world, dim=-1)
            active = active & (wo_geo * wo_z > 0)

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
            bs["pdf"].detach(), bs["delta"], depth_count, path_len,
            pend_ray.o, pend_ray.d, pend_ray.mint, pend_ray.maxt,
            pend_contrib, pend_ok, pred_table, pred_hits, guide_mass)

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
        torch.zeros(n, device=dev),
        pend_ray.o, pend_ray.d, pend_ray.mint, pend_ray.maxt,
        torch.zeros((n, n_ch), device=dev),
        torch.zeros(n, dtype=torch.bool, device=dev),
        torch.full((1 << PRED_BITS,), -1, dtype=torch.int32, device=dev)
        if cfg.hit_prediction else torch.zeros((), dtype=torch.int32,
                                               device=dev),
        torch.zeros((), dtype=torch.int64, device=dev),
        guide.mass if learn else torch.zeros((), device=dev))
    xs = (u_nee_sel, u_nee_pos, u_bsdf_2d, u_lobe, u_rr, u_gpick, u_gbin)
    remat = cfg.remat and requires_grad(
        geom, mats, em, tex, scene.camera, ray,
        *(() if ss is None else (ss,)))
    rays_traced = torch.zeros((), dtype=torch.int64, device=dev)
    for depth in range(d_max):
        rays_traced = rays_traced + state.active.sum() + state.pend_ok.sum()
        state = run_bounce(bounce, depth, state, xs, remat)

    aux = {
        "avg_path_length": state.depth_count.to(torch.float32).mean(),
        "rays_traced": rays_traced,
        # the share of traced queries with a usable prediction (a bound
        # or a shadow shortcut); 0 without hit_prediction
        "pred_hit_frac": state.pred_hits.to(torch.float32)
        / torch.clamp(rays_traced.to(torch.float32), min=1.0),
    }
    if learn:
        aux["guide"] = replace(guide, mass=state.guide_mass)
    return state.L, aux


def _add_emission(L, em_w, mask, term):
    """L plus the masked emission term times the depth's gate em_w (the
    reference multiplies by its gate at every depth; a gate of 1 is left
    out, which changes no bit)."""
    term = torch.where(mask[:, None], term, 0.0)
    return L + (term if em_w == 1.0 else em_w * term)


def lane_ids(scene, spp: int, morton=None):
    """The lanes of `render`: lane = pixel * spp + sample, with pixels in
    Morton order if `morton` (default: on the cluster backend). Returns
    (pixel_id, sample_id, inv_lane), int32 ids on the scene's device,
    inv_lane restoring scanline lane order (None without Morton order)."""
    w, h = scene.width, scene.height
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
    return pixel_id, lane % spp, inv_lane


def camera_rays(scene, cfg: PathConfig, seed, pixel_id, sample_id):
    """The camera rays and sampler of the lanes (pixel_id, sample_id), any
    subset of `lane_ids`' (each lane's draws depend on its ids alone).
    Returns (ray, sampler, offset): offset the (N, 2) sub-pixel
    positions of cfg.pattern."""
    w, h = scene.width, scene.height
    px = (pixel_id % w).to(torch.float32)
    py = (pixel_id // w).to(torch.float32)
    sampler = Sampler(seed, pixel_id, sample_id)
    jitter = sampler.next_2d()
    offset = sample_position(cfg.pattern, sample_id, cfg.spp, jitter)
    uv = torch.stack([(px + offset[:, 0]) / w, (py + offset[:, 1]) / h],
                     dim=-1)
    return scene.camera.sample_ray(uv), sampler, offset


def camera_samples(scene, cfg: PathConfig, seed: int = 0, morton=None):
    """The camera rays and sampler of `render` (`lane_ids`, then
    `camera_rays`). Returns (ray, sampler, offset, inv_lane)."""
    pixel_id, sample_id, inv_lane = lane_ids(scene, cfg.spp, morton)
    ray, sampler, offset = camera_rays(scene, cfg, seed, pixel_id,
                                       sample_id)
    return ray, sampler, offset, inv_lane


def camera_wavefront(scene, cfg: PathConfig, seed: int = 0, morton=None):
    """`camera_samples` without the offsets: (ray, sampler, inv_lane)."""
    ray, sampler, _, inv_lane = camera_samples(scene, cfg, seed, morton)
    return ray, sampler, inv_lane


def render(scene, cfg: PathConfig, seed: int = 0, guide=None,
           learn_guide: bool = False, guide_alpha: float = 0.5,
           guide_sampling: bool = None):
    """Render the scene to an (H, W, C) image on the scene's device,
    developed with cfg.rfilter; on Morton lanes the radiance and the
    offsets return to scanline order together (path.py:1003-1007). A
    subsurface scene whose irradiance cache is empty gets it filled at
    `seed` first (path.py:968-973), inside the gradient where a scene
    tensor requires grad. guide, learn_guide, guide_alpha,
    guide_sampling: path_trace's (render_guided)."""
    if scene.subsurface is not None and scene.subsurface.irradiance is None:
        from mitsuba_tpu_torch.subsurface.dipole import (
            prepare_scene_irradiance,
        )

        scene = replace(scene, subsurface=prepare_scene_irradiance(
            scene, seed=seed))
    ray, sampler, offset, inv_lane = camera_samples(scene, cfg, seed)
    L, aux = path_trace(scene, ray, sampler, cfg, guide=guide,
                        learn_guide=learn_guide, guide_alpha=guide_alpha,
                        guide_sampling=guide_sampling)
    if inv_lane is not None:
        L, offset = L[inv_lane], offset[inv_lane]
    return develop(L, offset, cfg.spp, scene.height, scene.width,
                   make_rfilter(cfg.rfilter)), aux


def render_guided(scene, cfg: PathConfig, seed: int = 0,
                  learn_frac: float = 0.5, guide_alpha: float = 0.5,
                  res: int = 16):
    """Surface path guiding (path.py:1011): a learning pass of learn_frac
    of the samples at `seed` that deposits the incident radiance into a
    res³ grid over the scene's box, then a guided pass of the rest from
    seed + 7507 on the learned guide; the image is their spp-weighted
    mean, aux the guided pass's with both passes' rays_traced (with no
    guided pass, the learning pass's with the guide in aux["guide"]).
    The learning pass adds by `index_add`, in atomic order on the card,
    so the learned mass, and the guided image with it, may differ from
    run to run there in the last bits."""
    from mitsuba_tpu_torch.integrators.guiding import scene_guide

    spp1 = max(1, int(round(cfg.spp * learn_frac)))
    spp2 = max(0, cfg.spp - spp1)
    img1, aux1 = render(scene, replace(cfg, spp=spp1), seed=seed,
                        guide=scene_guide(scene, res), learn_guide=True)
    if spp2 == 0:
        return img1, aux1
    img2, aux2 = render(scene, replace(cfg, spp=spp2), seed=seed + 7507,
                        guide=aux1.pop("guide"), guide_alpha=guide_alpha)
    aux2["rays_traced"] = aux1["rays_traced"] + aux2["rays_traced"]
    return (img1 * spp1 + img2 * spp2) / (spp1 + spp2), aux2


def render_motion(scenes, cfg: PathConfig, seed: int = 0):
    """Motion blur (path.py:937): the mean of renders of scenes baked at
    stratified shutter times (SceneBuilder.build_time_scenes), bin k at
    seed `seed * 1031 + k`; aux the last bin's with aux["time_bins"]."""
    acc = aux = None
    for k, scene in enumerate(scenes):
        img, aux = render(scene, cfg, seed=seed * 1031 + k)
        acc = img if acc is None else acc + img
    aux = dict(aux or {})
    aux["time_bins"] = len(scenes)
    return acc / len(scenes), aux
