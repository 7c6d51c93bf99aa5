"""Dipole BSSRDF subsurface scattering (port of
mitsuba_tpu/subsurface/dipole.py; Jensen et al. 2001, reference
src/subsurface/dipole.cpp:362-468, multipole.cpp, adipole.cpp, the
irradiance sampling process irrproc.cpp and the octree gather irrtree.cpp).

As in the JAX package:

  * irradiance sample points are area-weighted surface samples (host
    numpy, `default_rng(123 + entry)`, so the points equal the JAX
    package's bit for bit), and every point's irradiance is one batched
    NEE estimate through `sample_direct` and `ray_test`, plus an indirect
    estimate: cosine-hemisphere rays traced by `path_trace` with the
    depth-0 emission gated off (`PathConfig.skip_direct_emission`) on the
    scene stripped of its subsurface table. Every draw is the JAX
    package's (`jax.random.key(seed)`, `fold_in`, `uniform`; the indirect
    rays' `Sampler`), through render/sampler.py;
  * the octree hierarchy is replaced by a dense gather,
    Lo(x) = Ft/pi * sum_i Rd(|x - p_i|) E_i A_i, over chunks of 256 points
    in the reference's per-lane order. The lanes are cut into blocks so
    that a (lanes, chunk, 3) temporary stays near 200 MB at any
    wavefront size; `path_trace` evaluates only the lanes whose hit
    carries an entry.

Dipole, multipole (2·n_poles + 1 mirrored pole pairs) and adipole (a
stretched distance metric) all evaluate through `scene_ss_lo`'s pole sum.
`scene_ss_lo_hier` is the host-side hierarchical gather on the octree
(core/octree.py), for isotropic profiles. Nothing here is a kernel of the
JAX package (it computes all of it in XLA), so the port's is plain
PyTorch; the renders' queries run the brute, bvh and cluster kernels.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch

from mitsuba_tpu_torch.core import math as m
from mitsuba_tpu_torch.core.fresnel import fresnel
from mitsuba_tpu_torch.core.warp import square_to_cosine_hemisphere
from mitsuba_tpu_torch.emitters import sample_direct
from mitsuba_tpu_torch.render import sampler as rs
from mitsuba_tpu_torch.render.intersect import ray_test
from mitsuba_tpu_torch.render.records import Ray

# lanes of one block of the dense gather: (BLOCK, CHUNK, 3) float32
# temporaries of 192 MiB
GATHER_BLOCK = 1 << 16
GATHER_CHUNK = 256


def _f32(x):
    return torch.as_tensor(np.asarray(x, np.float32))


@dataclass
class DipoleParams:
    sigma_s: torch.Tensor     # (3,) scattering
    sigma_a: torch.Tensor     # (3,) absorption
    g: torch.Tensor           # () HG anisotropy (reduces sigma_s)
    eta: torch.Tensor         # () relative IOR
    sigma_tr: torch.Tensor    # (3,) effective transport coefficient
    zr: torch.Tensor          # (3,) real source depth
    zv: torch.Tensor          # (3,) virtual source depth
    alpha_p: torch.Tensor     # (3,) reduced albedo
    fdr: torch.Tensor = None  # () diffuse Fresnel reflectance
    fdt: torch.Tensor = None  # () 1 - fdr


def make_dipole(sigma_s, sigma_a, g: float = 0.0,
                eta: float = 1.33) -> DipoleParams:
    """The dipole's derived coefficients (dipole.cpp configure), in
    float32 with the JAX package's operations in its order."""
    ss = _f32(sigma_s)
    sa = _f32(sigma_a)
    ss_p = ss * (1.0 - g)                       # reduced scattering
    st_p = ss_p + sa
    alpha_p = ss_p / torch.clamp(st_p, min=1e-9)
    sigma_tr = torch.sqrt(3.0 * sa * st_p)
    fdr = -1.440 / eta ** 2 + 0.710 / eta + 0.668 + 0.0636 * eta
    a_bc = (1.0 + fdr) / (1.0 - fdr)
    zr = 1.0 / torch.clamp(st_p, min=1e-9)
    zv = zr * (1.0 + 4.0 / 3.0 * a_bc)
    return DipoleParams(
        sigma_s=ss, sigma_a=sa, g=_f32(g), eta=_f32(eta),
        sigma_tr=sigma_tr, zr=zr, zv=zv, alpha_p=alpha_p,
        fdr=_f32(fdr), fdt=_f32(1.0 - fdr))


def _to(p, device):
    return dataclasses.replace(p, **{
        f.name: getattr(p, f.name).to(device) for f in dataclasses.fields(p)
        if isinstance(getattr(p, f.name), torch.Tensor)})


def dipole_rd(p: DipoleParams, r):
    """Diffuse reflectance profile Rd(r): distances (...,) -> (..., 3)."""
    r = torch.clamp(r, min=1e-4)[..., None]
    dr = torch.sqrt(r * r + p.zr ** 2)
    dv = torch.sqrt(r * r + p.zv ** 2)
    c1 = p.zr * (p.sigma_tr + 1.0 / dr)
    c2 = p.zv * (p.sigma_tr + 1.0 / dv)
    rd = (p.alpha_p / (4.0 * math.pi)) * (
        c1 * torch.exp(-p.sigma_tr * dr) / (dr * dr)
        + c2 * torch.exp(-p.sigma_tr * dv) / (dv * dv))
    return torch.clamp(rd, min=0.0)


def multipole_rd(p: DipoleParams, r, thickness: float, n_poles: int = 3):
    """Thin-slab multipole Rd: image sources mirrored across both slab
    boundaries (Donner & Jensen 2005; multipole.cpp)."""
    r = torch.clamp(r, min=1e-4)[..., None]
    d_slab = thickness + p.zv - p.zr
    total = torch.zeros(r.shape[:-1] + (3,), device=r.device)
    for i in range(-n_poles, n_poles + 1):
        zri = 2.0 * i * d_slab + p.zr
        zvi = 2.0 * i * d_slab - p.zv
        dr = torch.sqrt(r * r + zri ** 2)
        dv = torch.sqrt(r * r + zvi ** 2)
        c1 = zri * (p.sigma_tr + 1.0 / dr)
        c2 = zvi * (p.sigma_tr + 1.0 / dv)
        total = total + (p.alpha_p / (4.0 * math.pi)) * (
            c1 * torch.exp(-p.sigma_tr * dr) / (dr * dr)
            - c2 * torch.exp(-p.sigma_tr * dv) / (dv * dv))
    return torch.clamp(total, min=0.0)


def adipole_rd(p: DipoleParams, r_vec, aniso_dir, aniso_ratio: float = 2.0):
    """Anisotropic dipole (adipole.cpp): distances in a metric stretched
    along aniso_dir (unit). r_vec: (..., 3) surface offsets."""
    along = torch.sum(r_vec * aniso_dir, dim=-1)
    perp = r_vec - along[..., None] * aniso_dir
    r_eff = torch.sqrt((along / aniso_ratio) ** 2
                       + torch.sum(perp * perp, dim=-1))
    return dipole_rd(p, r_eff)


def sample_irradiance_points(geom, n_points: int, seed: int = 0,
                             shape_id: int | None = None):
    """Area-weighted surface points on the host: (points (M, 3), normals
    (M, 3), area per point ()), float32 on the CPU; optionally on one
    shape id only."""
    v0 = geom.v0.cpu().numpy()
    e1 = geom.e1.cpu().numpy()
    e2 = geom.e2.cpu().numpy()
    sid = geom.shape_id.cpu().numpy()
    if shape_id is not None:
        mask = sid == shape_id
        v0, e1, e2 = v0[mask], e1[mask], e2[mask]
    areas = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
    total = areas.sum()
    rng = np.random.default_rng(seed)
    ti = rng.choice(len(areas), size=n_points, p=areas / total)
    u = rng.uniform(size=(n_points, 2))
    a = np.sqrt(np.maximum(1.0 - u[:, 0], 0.0))
    b0 = 1.0 - a
    b1 = a * u[:, 1]
    pts = v0[ti] + e1[ti] * b0[:, None] + e2[ti] * b1[:, None]
    nrm = np.cross(e1[ti], e2[ti])
    nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-20)
    return _f32(pts), _f32(nrm), _f32(total / n_points)


def _uniform(k, shape, device):
    """jax.random.uniform(k, shape) of a host key."""
    return rs.uniform(torch.tensor(k[0], device=device),
                      torch.tensor(k[1], device=device), shape)


def compute_irradiance(scene, points, normals, n_samples: int = 8,
                       seed: int = 0, indirect_depth: int = 3,
                       n_indirect: int = 4):
    """Irradiance at every point (M, 3) of the scene's device: n_samples
    NEE estimates toward the emitters (irrproc.cpp:44-120), each sample s
    drawing `uniform(fold_in(fold_in(key(seed), s), 1 | 2))`, plus
    `_indirect_irradiance` unless indirect_depth or n_indirect is 0."""
    dev = scene.device
    points, normals = points.to(dev), normals.to(dev)
    m_pts = points.shape[0]
    e_total = torch.zeros((m_pts, 3), device=dev)
    eps = m.EPSILON * torch.clamp(torch.abs(points).amax(dim=-1), min=1.0)
    for s in range(n_samples):
        k = rs.fold_in_key(rs.key(seed), s)
        u1 = _uniform(rs.fold_in_key(k, 1), m_pts, dev)
        u2 = _uniform(rs.fold_in_key(k, 2), (m_pts, 2), dev)
        ds = sample_direct(scene.emitters, scene.geom, points, u1, u2)
        cos_i = torch.clamp(torch.sum(normals * ds.d, dim=-1), min=0.0)
        shadow = Ray.make(points, ds.d, mint=eps,
                          maxt=ds.dist * (1 - 1e-3))
        occ = ray_test(scene.geom, shadow)
        ok = ds.valid & ~occ & (ds.pdf > 0)
        contrib = ds.value * (cos_i / torch.clamp(ds.pdf, min=1e-20))[:, None]
        e_total = e_total + torch.where(ok[:, None], contrib, 0.0)
    e_total = e_total / n_samples
    if indirect_depth > 0 and n_indirect > 0:
        e_total = e_total + _indirect_irradiance(
            scene, points, normals, n_indirect, indirect_depth, seed)
    return e_total


def _indirect_irradiance(scene, points, normals, n_ind: int, depth: int,
                         seed: int):
    """pi * E_cos[L_indirect]: cosine-hemisphere rays from each point,
    traced by path_trace (NEE inside) with the first vertex's emission
    gated off, on the scene without its subsurface table (a point must
    not gather through the cache being built)."""
    from mitsuba_tpu_torch.integrators.path import PathConfig, path_trace
    from mitsuba_tpu_torch.render.sampler import Sampler

    dev = points.device
    m_pts = points.shape[0]
    scene_ni = dataclasses.replace(scene, subsurface=None)
    cfg = PathConfig(max_depth=depth, spp=1, remat=False,
                     skip_direct_emission=True)
    fr = m.Frame.from_normal(normals)
    acc = torch.zeros((m_pts, 3), device=dev)
    eps = m.EPSILON * torch.clamp(torch.abs(points).amax(dim=-1), min=1.0)
    lanes = torch.arange(m_pts, dtype=torch.int32, device=dev)
    for s in range(n_ind):
        k = rs.fold_in_key(rs.key(seed ^ 0x5A5A), s)
        d_loc = square_to_cosine_hemisphere(
            _uniform(rs.fold_in_key(k, 3), (m_pts, 2), dev))
        d = (fr.s * d_loc[:, 0:1] + fr.t * d_loc[:, 1:2]
             + normals * d_loc[:, 2:3])
        sampler = Sampler(seed * 131 + 7 + s, lanes, torch.zeros_like(lanes))
        L, _aux = path_trace(scene_ni, Ray.make(points, d, mint=eps),
                             sampler, cfg)
        acc = acc + L
    return math.pi * acc / n_ind


@dataclass
class DipoleCache:
    params: DipoleParams
    points: torch.Tensor       # (M, 3)
    irradiance: torch.Tensor   # (M, 3)
    area: torch.Tensor         # () per-point area


def prepare_dipole(scene, params: DipoleParams, n_points: int = 1024,
                   n_irr_samples: int = 8, seed: int = 0,
                   shape_id: int | None = None) -> DipoleCache:
    """A single-profile cache on the scene's device: points sampled at
    `seed`, their irradiance estimated from the same seed."""
    dev = scene.device
    pts, nrm, area = sample_irradiance_points(scene.geom, n_points,
                                              seed=seed, shape_id=shape_id)
    irr = compute_irradiance(scene, pts, nrm, n_samples=n_irr_samples,
                             seed=seed)
    return DipoleCache(params=_to(params, dev), points=pts.to(dev),
                       irradiance=irr, area=area.to(dev))


def dipole_lo(cache: DipoleCache, x, wo_cos, chunk: int = 512):
    """Outgoing subsurface radiance at points x (N, 3) with |cos| of the
    outgoing direction wo_cos (N,): Ft(wo)/pi * sum_i Rd(|x - p_i|) E_i
    A_i, summed over chunks of `chunk` points in order."""
    p = cache.params
    n_pts = cache.points.shape[0]
    pad = (-n_pts) % chunk
    pts = torch.nn.functional.pad(cache.points, (0, 0, 0, pad))
    irr = torch.nn.functional.pad(cache.irradiance, (0, 0, 0, pad))
    mo = torch.zeros((x.shape[0], 3), device=x.device)
    for cp, ce in zip(pts.reshape(-1, chunk, 3), irr.reshape(-1, chunk, 3)):
        d = torch.linalg.vector_norm(x[:, None, :] - cp[None], dim=-1)
        mo = mo + torch.sum(dipole_rd(p, d) * ce[None], dim=1)
    ft = 1.0 - fresnel(wo_cos, torch.ones_like(p.eta), p.eta)
    return mo * cache.area * (ft * m.INV_PI)[..., None]


# ---------------------------------------------------------------------------
# Scene integration: every entry of a scene stacked, consumed by the path
# tracer (reference include/mitsuba/render/subsurface.h: subsurface plugins
# attach to shapes, preprocess() builds the irradiance samples, Lo() is
# called by the integrator at each surface hit)
# ---------------------------------------------------------------------------


@dataclass
class SceneSubsurface:
    """A scene's subsurface entries stacked: S entries x K points. Every
    profile is a sum over pole pairs (dipole 1, multipole 2·n_poles + 1,
    mirrored) in a distance metric stretched along aniso_dir (ratio 1:
    isotropic); unused pole slots sit at _PAD_DEPTH, where they add 0."""
    sigma_tr: torch.Tensor     # (S, 3)
    zri: torch.Tensor          # (S, P, 3) real-source depths per pole
    zvi: torch.Tensor          # (S, P, 3) virtual-source depths (signed)
    alpha_p: torch.Tensor      # (S, 3)
    eta: torch.Tensor          # (S,)
    fdr: torch.Tensor          # (S,)
    fdt: torch.Tensor          # (S,)
    ss_factor: torch.Tensor    # (S, 3)
    aniso_dir: torch.Tensor    # (S, 3) slow-diffusion direction (adipole)
    aniso_ratio: torch.Tensor  # (S,) metric stretch along aniso_dir
    points: torch.Tensor       # (S, K, 3)
    normals: torch.Tensor      # (S, K, 3)
    area: torch.Tensor         # (S,) area per point
    mat_ss: torch.Tensor       # (n_materials,) material -> entry, -1 none
    irradiance: torch.Tensor = None   # (S, K, 3), filled at render start

    @property
    def n_entries(self):
        return self.points.shape[0]

    def to(self, device) -> "SceneSubsurface":
        return _to(self, device)


_PAD_DEPTH = 1e6   # pole padding depth; exp(-sigma_tr * 1e6) == 0


def _entry_poles(p: DipoleParams, profile: str, thickness: float,
                 n_poles: int):
    """An entry's (zri, zvi) pole pairs, numpy (P, 3)."""
    zr = p.zr.numpy()
    zv = p.zv.numpy()
    if profile == "multipole":
        d_slab = thickness + zv - zr
        pairs = [(2.0 * i * d_slab + zr, 2.0 * i * d_slab - zv)
                 for i in range(-n_poles, n_poles + 1)]
    else:   # dipole / adipole: one pair, zvi = -zv (see multipole_rd)
        pairs = [(zr, -zv)]
    return (np.stack([a for a, _ in pairs]), np.stack([b for _, b in pairs]))


def build_scene_subsurface(entries, n_materials: int, geom,
                           n_points: int = 512) -> SceneSubsurface:
    """Host build (CPU tensors). entries: dicts of material_id, sigma_s,
    sigma_a, g, eta, ss_factor, profile, thickness, n_poles, aniso_dir,
    aniso_ratio. Each entry's points are sampled area-weighted on the
    triangles of its material, with `default_rng(123 + entry)`."""
    mat_ss = np.full(n_materials, -1, np.int32)
    rows = dict(sigma_tr=[], alpha_p=[], eta=[], fdr=[], fdt=[],
                ss_factor=[], aniso_dir=[], aniso_ratio=[])
    zri_all, zvi_all = [], []
    pts_all, nrm_all, area_all = [], [], []
    v0 = geom.v0.cpu().numpy()
    e1 = geom.e1.cpu().numpy()
    e2 = geom.e2.cpu().numpy()
    mid_tri = geom.material_id.cpu().numpy()
    for si, e in enumerate(entries):
        mat_ss[e["material_id"]] = si
        p = make_dipole(e["sigma_s"], e["sigma_a"], g=e.get("g", 0.0),
                        eta=e.get("eta", 1.33))
        profile = e.get("profile", "dipole")
        zri, zvi = _entry_poles(p, profile, float(e.get("thickness", 1.0)),
                                int(e.get("n_poles", 3)))
        zri_all.append(zri)
        zvi_all.append(zvi)
        if profile == "adipole":
            ad = np.asarray(e.get("aniso_dir", (1.0, 0.0, 0.0)), np.float32)
            ad = ad / max(float(np.linalg.norm(ad)), 1e-12)
            rows["aniso_dir"].append(_f32(ad))
            rows["aniso_ratio"].append(
                _f32(float(e.get("aniso_ratio", 2.0))))
        else:
            rows["aniso_dir"].append(_f32([1.0, 0.0, 0.0]))
            rows["aniso_ratio"].append(_f32(1.0))
        rows["sigma_tr"].append(p.sigma_tr)
        rows["alpha_p"].append(p.alpha_p)
        rows["eta"].append(p.eta)
        rows["fdr"].append(p.fdr)
        rows["fdt"].append(p.fdt)
        rows["ss_factor"].append(_f32(e.get("ss_factor", (1.0, 1.0, 1.0))))
        mask = mid_tri == e["material_id"]
        if not mask.any():
            raise ValueError(
                f"subsurface entry {si}: no triangles with material "
                f"{e['material_id']}")
        mv0, me1, me2 = v0[mask], e1[mask], e2[mask]
        areas = 0.5 * np.linalg.norm(np.cross(me1, me2), axis=-1)
        total = float(areas.sum())
        rng = np.random.default_rng(123 + si)
        ti = rng.choice(len(areas), size=n_points, p=areas / areas.sum())
        u = rng.uniform(size=(n_points, 2))
        a = np.sqrt(np.maximum(1.0 - u[:, 0], 0.0))
        b0, b1 = 1.0 - a, a * u[:, 1]
        pts = mv0[ti] + me1[ti] * b0[:, None] + me2[ti] * b1[:, None]
        nrm = np.cross(me1[ti], me2[ti])
        nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-20)
        pts_all.append(pts)
        nrm_all.append(nrm)
        area_all.append(total / n_points)
    # pad the pole lists to a common P (padded poles add 0)
    p_max = max(z.shape[0] for z in zri_all)
    zri_all = [np.concatenate(
        [z, np.full((p_max - z.shape[0], 3), _PAD_DEPTH)]) for z in zri_all]
    zvi_all = [np.concatenate(
        [z, np.full((p_max - z.shape[0], 3), _PAD_DEPTH)]) for z in zvi_all]
    return SceneSubsurface(
        **{k: torch.stack(v) for k, v in rows.items()},
        zri=_f32(np.stack(zri_all)), zvi=_f32(np.stack(zvi_all)),
        points=_f32(np.stack(pts_all)), normals=_f32(np.stack(nrm_all)),
        area=_f32(area_all), mat_ss=torch.as_tensor(mat_ss))


def refuse_grad(scene):
    """A subsurface scene whose tensors require grad: the gradient
    through the cache and the gather is not ported (ROADMAP A.14)."""
    from mitsuba_tpu_torch.integrators.path import requires_grad

    if scene.subsurface is not None and requires_grad(
            scene.geom, scene.materials, scene.emitters, scene.textures,
            scene.camera, scene.subsurface):
        raise NotImplementedError(
            "gradients of a subsurface scene are not ported (ROADMAP A.14)")


def prepare_scene_irradiance(scene, n_samples: int = 8,
                             seed: int = 7) -> SceneSubsurface:
    """The scene's SceneSubsurface with its irradiance filled by
    compute_irradiance (direct NEE and the indirect estimate)."""
    refuse_grad(scene)
    ss = scene.subsurface
    S, K, _ = ss.points.shape
    irr = compute_irradiance(scene, ss.points.reshape(S * K, 3),
                             ss.normals.reshape(S * K, 3),
                             n_samples=n_samples, seed=seed)
    return dataclasses.replace(ss, irradiance=irr.reshape(S, K, 3))


def _rd_poles(r, zri, zvi, sigma_tr, alpha_p):
    """Pole-sum Rd of stretched distances r (...,) -> (..., 3)."""
    r = torch.clamp(r, min=1e-4)[..., None]
    total = torch.zeros(r.shape[:-1] + (3,), device=r.device)
    for pi in range(zri.shape[0]):
        dr = torch.sqrt(r * r + zri[pi] ** 2)
        dv = torch.sqrt(r * r + zvi[pi] ** 2)
        c1 = zri[pi] * (sigma_tr + 1.0 / dr)
        c2 = zvi[pi] * (sigma_tr + 1.0 / dv)
        total = total + (alpha_p / (4.0 * math.pi)) * (
            c1 * torch.exp(-sigma_tr * dr) / (dr * dr)
            - c2 * torch.exp(-sigma_tr * dv) / (dv * dv))
    return torch.clamp(total, min=0.0)


def scene_ss_lo(ss: SceneSubsurface, s: int, x, wo_cos,
                chunk: int = GATHER_CHUNK, block: int = GATHER_BLOCK):
    """Outgoing subsurface radiance of entry `s` at points x (N, 3), wo_cos
    (N,) the outgoing |cos| (dipole.cpp Lo):
    Mo = sum_i Rd(|x - p_i|) E_i A_i Fdt,
    Lo = Mo * ssFactor / pi * (eta == 1 ? 1 : Ft(cos_o) / Fdr),
    Rd the entry's pole sum in its stretched metric. Each lane sums the
    points chunk by chunk in order, as the JAX package's scan does; the
    lanes run in blocks of `block`."""
    sigma_tr, alpha_p = ss.sigma_tr[s], ss.alpha_p[s]
    zri, zvi = ss.zri[s], ss.zvi[s]
    eta, fdr = ss.eta[s], ss.fdr[s]
    adir, aratio = ss.aniso_dir[s], ss.aniso_ratio[s]
    stretch = 1.0 / (aratio * aratio) - 1.0
    pad = (-ss.points.shape[1]) % chunk
    pts_c = torch.nn.functional.pad(ss.points[s], (0, 0, 0, pad)).reshape(
        -1, chunk, 3)
    irr_c = torch.nn.functional.pad(ss.irradiance[s], (0, 0, 0, pad)) \
        .reshape(-1, chunk, 3)
    mo = torch.empty((x.shape[0], 3), device=x.device)
    for b0 in range(0, x.shape[0], block):
        xb = x[b0:b0 + block]
        acc = torch.zeros((xb.shape[0], 3), device=x.device)
        for cp, ce in zip(pts_c, irr_c):
            rv = xb[:, None, :] - cp[None]
            along = torch.sum(rv * adir, dim=-1)
            r_eff = torch.sqrt(torch.clamp(
                torch.sum(rv * rv, dim=-1) + stretch * along * along,
                min=0.0))
            rd = _rd_poles(r_eff, zri, zvi, sigma_tr, alpha_p)
            acc = acc + torch.sum(rd * ce[None], dim=1)
        mo[b0:b0 + block] = acc
    mo = mo * ss.area[s] * ss.fdt[s]
    ft = 1.0 - fresnel(wo_cos, torch.ones_like(eta), eta)
    bdy = torch.where(torch.abs(eta - 1.0) < 1e-4, 1.0,
                      ft / torch.clamp(fdr, min=1e-4))
    return mo * ss.ss_factor[s] * m.INV_PI * bdy[..., None]


def scene_ss_lo_hier(ss: SceneSubsurface, s: int, x, wo_cos,
                     solid_angle_eps: float = 0.05):
    """Host-side hierarchical Lo on the irradiance octree (irrtree.h
    IrradianceOctree::execute): a far cluster adds Rd(|x - centroid|) times
    its summed irradiance instead of a term per point. Numpy float64, x
    (N, 3) -> (N, 3). Isotropic profiles only (the reference's irrtree
    gathers an isotropic Rd too)."""
    from mitsuba_tpu_torch.core.octree import Octree

    if abs(float(ss.aniso_ratio[s]) - 1.0) > 1e-6:
        raise ValueError("hierarchical gather supports isotropic profiles"
                         " (aniso_ratio == 1)")
    sigma_tr = ss.sigma_tr[s].cpu().numpy().astype(np.float64)
    alpha_p = ss.alpha_p[s].cpu().numpy().astype(np.float64)
    zri = ss.zri[s].cpu().numpy().astype(np.float64)
    zvi = ss.zvi[s].cpu().numpy().astype(np.float64)
    eta = float(ss.eta[s])
    fdr = float(ss.fdr[s])
    tree = Octree(ss.points[s].cpu().numpy(),
                  ss.irradiance[s].cpu().numpy(), leaf_size=8)

    def rd(r):
        r = np.maximum(np.asarray(r, np.float64), 1e-4)[..., None]
        total = np.zeros(r.shape[:-1] + (3,))
        for pi in range(zri.shape[0]):
            dr = np.sqrt(r * r + zri[pi] ** 2)
            dv = np.sqrt(r * r + zvi[pi] ** 2)
            c1 = zri[pi] * (sigma_tr + 1.0 / dr)
            c2 = zvi[pi] * (sigma_tr + 1.0 / dv)
            total = total + (alpha_p / (4.0 * np.pi)) * (
                c1 * np.exp(-sigma_tr * dr) / (dr * dr)
                - c2 * np.exp(-sigma_tr * dv) / (dv * dv))
        return np.maximum(total, 0.0)

    x = np.atleast_2d(np.asarray(x, np.float64))
    mo = np.stack([tree.gather(xi, rd, solid_angle_eps) for xi in x])
    mo = mo * float(ss.area[s]) * float(ss.fdt[s])
    cos_o = torch.as_tensor(np.atleast_1d(np.asarray(wo_cos, np.float32)))
    ft = 1.0 - fresnel(cos_o, torch.ones_like(cos_o),
                       torch.full_like(cos_o, eta)).numpy()
    bdy = np.ones_like(ft) if abs(eta - 1.0) < 1e-4 else \
        ft / max(fdr, 1e-4)
    return mo * ss.ss_factor[s].cpu().numpy().astype(np.float64) / np.pi \
        * bdy[..., None]
