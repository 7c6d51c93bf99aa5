"""Adjoint particle tracer: light tracing with camera connections (port of
mitsuba_tpu/integrators/ptracer.py; reference
src/integrators/path/ptracer.cpp:45 AdjointParticleTracer).

Particles start on the luminaires (area triangles, analytic spheres,
point and spot lights), walk through the scene in lockstep, and every
vertex is connected to the pinhole camera: the contribution lands in the
pixel that the vertex projects to. Each bounce is one closest-hit query
and one any-hit query of the scene's backend (on brute, the kernels #2
and #3).

The splat is exact and so does not depend on the order of its adds. The
reference adds each bounce's contributions with a float32 scatter-add;
CUDA's `index_add_` adds them in atomic order, whose float sums change
from run to run. Here each bounce's contributions are turned into 64-bit
fixed point at a scale taken from their largest magnitude (a power of
two, so that the sum of all of them fits), added with an integer
`index_add_`, whose sums are the same in any order, and converted back.
Two runs give the same image, and the card the same bits as the CPU for
the same contributions; the quantum is 2^-62 of the bounce's largest
possible pixel sum. The render is forward only: with grad enabled, a
scene tensor that requires grad raises NotImplementedError.
"""
from __future__ import annotations

import torch

from mitsuba_tpu_torch.bsdfs import bsdf_eval, bsdf_sample
from mitsuba_tpu_torch.core import math as m
from mitsuba_tpu_torch.core import transform as tf
from mitsuba_tpu_torch.core import warp
from mitsuba_tpu_torch.emitters.table import POINT, SPHERE, SPOT
from mitsuba_tpu_torch.integrators.path import PathConfig, requires_grad
from mitsuba_tpu_torch.render.intersect import ray_intersect, ray_test
from mitsuba_tpu_torch.render.records import Ray
from mitsuba_tpu_torch.render.sampler import Sampler

FIXED_BITS = 62           # a bounce's pixel sums stay below 2^62 quanta


def _record(em, u_sel):
    rec = torch.searchsorted(em.rec_cdf, u_sel.contiguous(), right=True)
    return torch.clamp(rec, 0, em.rec_pmf.shape[0] - 1)


def _sample_emission(scene, u_sel, u_pos, u_dir):
    """Particle origins and directions, chosen by record power over the
    finite emitters (ptracer.py:31): triangle and sphere lights a uniform
    point and a cosine direction about its normal, point lights a uniform
    direction, spot lights a uniform one in the cone.

    Returns (p, n, d, beta, valid): beta the emitted radiance over the
    pdfs of position and direction, the record pmf included. Other
    records (directional, environment) are not valid, as in the
    reference."""
    em = scene.emitters
    geom = scene.geom
    rec = _record(em, u_sel)
    pmf = em.rec_pmf[rec]
    eid = em.rec_emitter[rec].long()
    le = em.radiance[eid]
    is_tri = rec < em.n_tri_records

    ti = em.rec_prim[rec].long()
    bary = warp.square_to_uniform_triangle(u_pos)
    e1, e2 = geom.e1[ti], geom.e2[ti]
    p_tri = geom.v0[ti] + e1 * bary[:, :1] + e2 * bary[:, 1:2]
    cr = m.cross(e1, e2)
    n_tri = m.normalize(cr)
    area_tri = 0.5 * m.length(cr)

    kind = em.kind[eid]
    is_sph = ~is_tri & (kind == SPHERE)
    n_sph = warp.square_to_uniform_sphere(u_pos)
    sph_r = em.radius[eid]
    p_sph = em.position[eid] + sph_r[:, None] * n_sph
    area_sph = 4.0 * torch.pi * sph_r * sph_r

    p = torch.where(is_tri[:, None], p_tri, p_sph)
    n = torch.where(is_tri[:, None], n_tri, n_sph)
    area = torch.where(is_tri, area_tri, area_sph)
    d_local = warp.square_to_cosine_hemisphere(u_dir)
    d = m.Frame.from_normal(n).to_world(d_local)
    pdf_pos = pmf / torch.clamp(area, min=1e-12)
    pdf_dir = warp.square_to_cosine_hemisphere_pdf(d_local)
    cos_t = torch.clamp(m.cos_theta(d_local), min=0.0)
    beta = le * (cos_t / torch.clamp(pdf_pos * pdf_dir, min=1e-20))[:, None]
    valid = (is_tri | is_sph) & (pmf > 0)

    if POINT in em.kinds_present:
        is_pt = ~is_tri & (kind == POINT)
        d_pt = warp.square_to_uniform_sphere(u_dir)
        beta_pt = le * (4.0 * torch.pi) / torch.clamp(pmf, min=1e-20)[:, None]
        p = torch.where(is_pt[:, None], em.position[eid], p)
        n = torch.where(is_pt[:, None], d_pt, n)
        d = torch.where(is_pt[:, None], d_pt, d)
        beta = torch.where(is_pt[:, None], beta_pt, beta)
        valid = valid | (is_pt & (pmf > 0))

    if SPOT in em.kinds_present:
        # the linear falloff of sample_direct's spot branch
        is_spot = ~is_tri & (kind == SPOT)
        cc = em.cutoff_cos[eid]
        fc = em.falloff_cos[eid]
        d_cone = warp.square_to_uniform_cone(cc, u_dir)
        d_sp = m.Frame.from_normal(em.direction[eid]).to_world(d_cone)
        pdf_cone = warp.square_to_uniform_cone_pdf(cc)
        fall = torch.clamp((m.cos_theta(d_cone) - cc)
                           / torch.clamp(fc - cc, min=1e-6), 0.0, 1.0)
        beta_sp = le * (fall / torch.clamp(pmf * pdf_cone, min=1e-20))[:, None]
        p = torch.where(is_spot[:, None], em.position[eid], p)
        n = torch.where(is_spot[:, None], d_sp, n)
        d = torch.where(is_spot[:, None], d_sp, d)
        beta = torch.where(is_spot[:, None], beta_sp, beta)
        valid = valid | (is_spot & (pmf > 0))

    return p, n, d, torch.where(valid[:, None], beta, 0.0), valid


def _connect_camera(scene, w2c, p):
    """Project world points through the pinhole camera (ptracer.py:117).
    Returns (pixel index, importance, direction to the camera, distance,
    on film): the importance holds the film Jacobian
    W H / (4 tan_x tan_y cos^3); the caller divides by distance^2."""
    cam = scene.camera
    pc = tf.apply_point(w2c, p)                 # camera space, +z forward
    z = pc[:, 2]
    behind = z <= 1e-5
    zs = torch.where(behind, 1.0, z)
    ndc_x = pc[:, 0] / zs
    ndc_y = pc[:, 1] / zs
    u = (ndc_x / cam.tan_half_fov_x + 1.0) * 0.5
    v = (1.0 - ndc_y / cam.tan_half_fov_y) * 0.5
    on_film = ~behind & (u >= 0) & (u < 1) & (v >= 0) & (v < 1)
    px = torch.clamp((u * scene.width).to(torch.int32), 0, scene.width - 1)
    py = torch.clamp((v * scene.height).to(torch.int32), 0,
                     scene.height - 1)
    pix = py * scene.width + px
    to_cam = cam.to_world[:3, 3][None, :] - p
    dist = m.length(to_cam)
    d_cam = to_cam / torch.clamp(dist, min=1e-12)[:, None]
    view_axis = cam.to_world[:3, 2]          # to_world applied to +z
    cos_cam = torch.clamp(m.dot(-d_cam, view_axis[None, :]), min=1e-6)
    importance = (scene.width * scene.height) / (
        4.0 * cam.tan_half_fov_x * cam.tan_half_fov_y
        * (cos_cam * cos_cam * cos_cam))
    return pix, importance, d_cam, dist, on_film


def splat(film, pix, contrib, ok):
    """Add contrib (N, C) of the lanes `ok` to pixels pix of film
    (H*W, C) float64, in 64-bit fixed point (see the module's note): the
    result does not depend on the order of the adds."""
    vals = torch.where(ok[:, None], contrib, 0.0).to(torch.float64)
    top = vals.abs().amax()
    # a power of two at or above the largest possible pixel sum
    _, e = torch.frexp(top * vals.shape[0])   # 0 gives e = 0
    scale = torch.ldexp(torch.ones((), dtype=torch.float64, device=e.device),
                        FIXED_BITS - e)
    q = torch.round(vals * scale).to(torch.int64)
    c = film.shape[-1]
    idx = (pix.long()[:, None] * c
           + torch.arange(c, device=pix.device)[None, :]).reshape(-1)
    acc = torch.zeros(film.numel(), dtype=torch.int64, device=film.device)
    acc.index_add_(0, idx, q.reshape(-1))
    return film + (acc.to(torch.float64) / scale).reshape(film.shape)


def ptracer_render(scene, cfg: PathConfig, n_particles: int, seed: int = 0):
    """Render by light tracing (ptracer.py:152): n_particles particles,
    cfg.max_depth bounces. Returns ((H, W, 3) image, aux) on the scene's
    device."""
    if requires_grad(scene.geom, scene.materials, scene.emitters,
                     scene.textures, scene.camera):
        raise NotImplementedError(
            "gradients of the particle tracer are not ported (ROADMAP A.14)")
    n = n_particles
    dev = scene.device
    d_max = cfg.max_depth
    sampler = Sampler(seed, torch.arange(n, dtype=torch.int32, device=dev),
                      torch.zeros(n, dtype=torch.int32, device=dev))
    u_sel = sampler.next_1d()
    u_pos = sampler.next_2d()
    u_dir = sampler.next_2d()
    u_scatter = sampler.next_stacked_2d(d_max)
    u_lobe = sampler.next_stacked_1d(d_max)

    p0, n0, d0, beta, valid = _sample_emission(scene, u_sel, u_pos, u_dir)
    w2c = torch.linalg.inv(scene.camera.to_world.cpu()).to(dev)
    film = torch.zeros((scene.height * scene.width, 3), dtype=torch.float64,
                       device=dev)
    eps0 = m.EPSILON * torch.clamp(torch.abs(p0).amax(dim=-1), min=1.0)
    ray = Ray.make(p0, d0, mint=eps0)
    active = valid
    for depth in range(d_max):
        its = ray_intersect(scene.geom, ray)
        active = active & its.valid
        # connect the surface vertex to the camera
        pix, importance, d_cam, dist, on_film = _connect_camera(
            scene, w2c, its.p)
        wo_local = its.to_local(d_cam)
        # the reciprocal models' fCos with the arguments swapped is the
        # adjoint BSDF
        fcos = bsdf_eval(scene.materials, its.material_id, its.wi, wo_local)
        eps = m.EPSILON * torch.clamp(torch.abs(its.p).amax(dim=-1), min=1.0)
        shadow = Ray.make(its.p, d_cam, mint=eps, maxt=dist * (1.0 - 1e-4))
        occluded = ray_test(scene.geom, shadow)
        ok = active & on_film & ~occluded
        dc = torch.clamp(dist, min=1e-6)
        contrib = beta * fcos * (importance / (dc * dc))[:, None]
        film = splat(film, pix, contrib, ok)
        del contrib, fcos, shadow, occluded
        # continue the walk
        bs = bsdf_sample(scene.materials, its.material_id, its.wi,
                         u_scatter[depth], u_lobe[depth])
        wo_world = its.to_world(bs["wo"])
        active = active & bs["valid"]
        beta = beta * torch.where(active[:, None], bs["weight"], 1.0)
        ray = Ray.make(torch.where(active[:, None], its.p, ray.o),
                       torch.where(active[:, None], wo_world, ray.d),
                       mint=eps)
        del its, bs, wo_world

    # directly visible emitters: the camera connection of the particle
    # origins, weighted as the reference weights them (ptracer.py:213:
    # the area of the record's triangle, triangle 0's past them)
    pix, importance, d_cam, dist, on_film = _connect_camera(scene, w2c, p0)
    cos_e = torch.clamp(m.dot(n0, d_cam), min=0.0)
    eps = m.EPSILON * torch.clamp(torch.abs(p0).amax(dim=-1), min=1.0)
    shadow = Ray.make(p0, d_cam, mint=eps, maxt=dist * (1.0 - 1e-4))
    occluded = ray_test(scene.geom, shadow)
    em = scene.emitters
    rec = _record(em, u_sel)
    ti = em.rec_prim[rec].long()
    area = 0.5 * m.length(m.cross(scene.geom.e1[ti], scene.geom.e2[ti]))
    pmf = em.rec_pmf[rec]
    le = em.radiance[em.rec_emitter[rec].long()]
    w_emit = le * (area / torch.clamp(pmf, min=1e-20))[:, None]
    dc = torch.clamp(dist, min=1e-6)
    contrib0 = w_emit * (cos_e * importance / (dc * dc))[:, None]
    film = splat(film, pix, contrib0, valid & on_film & ~occluded)
    img = (film / n).to(torch.float32).reshape(scene.height, scene.width, 3)
    return img, {"n_particles": n}
