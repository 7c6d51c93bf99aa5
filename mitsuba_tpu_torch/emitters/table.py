"""Emitters: SoA table and direct-illumination sampling (port of
mitsuba_tpu/emitters/table.py; reference src/luminaires/ area, point,
spot, directional, collimated, constant, envmap and sky, the analytic
sphere light of src/shapes/sphere.cpp, and src/librender/scene.cpp:319-396).

One sampling record per emissive triangle, weighted by area × luminance,
then one per other emitter (luminance × 4πr² for a sphere, × 4π for the
rest), all chosen through one flat CDF. The reference picks the record
and gathers its triangle with one-hot matmuls for the TPU's matrix unit;
here both are plain index gathers, which are exact. An image environment
map and the sky (baked on the host into such a map) share the alias-table
sampler of emitters/envmap.py. The reference's quirks are kept: the
collimated beam keeps its radius in the `cutoff_cos` column, and a
scene without emitters gets one dead point-light row.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from mitsuba_tpu_torch.core import math as m
from mitsuba_tpu_torch.core import warp
from mitsuba_tpu_torch.emitters import envmap
from mitsuba_tpu_torch.render.records import DirectSample

AREA, POINT, SPOT, DIRECTIONAL, COLLIMATED, CONSTANT, ENVMAP, SKY, \
    SPHERE = range(9)                  # the reference's kind numbers

DELTA_KINDS = (POINT, SPOT, DIRECTIONAL, COLLIMATED)
ENV_KINDS = (CONSTANT, ENVMAP, SKY)


@dataclass
class EmitterTable:
    kind: torch.Tensor          # (E,) int32
    radiance: torch.Tensor      # (E, C) radiance, or intensity (point, spot)
    position: torch.Tensor      # (E, 3) point / spot / collimated / sphere
    direction: torch.Tensor     # (E, 3) spot / directional / collimated axis
    cutoff_cos: torch.Tensor    # (E,) spot cos(cutoff); collimated radius
    falloff_cos: torch.Tensor   # (E,) spot cos(falloff start)
    tri_pdf_area: torch.Tensor  # (T,) selection prob / area; 0 if not emissive
    rec_cdf: torch.Tensor       # (R,) CDF over records
    rec_pmf: torch.Tensor       # (R,)
    rec_emitter: torch.Tensor   # (R,) emitter id per record
    rec_prim: torch.Tensor      # (R,) triangle id per record (0 past them)
    radius: torch.Tensor        # (E,) analytic sphere emitter radius
    # environment map (lat-long; the sky is baked to one); a scene without
    # one carries the reference's 1 x 1 placeholder
    env_image: torch.Tensor     # (He, We, C)
    env_prob: torch.Tensor      # (He*We,) alias-table keep prob
    env_alias: torch.Tensor     # (He*We,) alias-table partner
    env_pdf_img: torch.Tensor   # (He, We) solid-angle pdf
    env_to_world: torch.Tensor  # (4, 4) env frame -> world
    env_to_env: torch.Tensor    # (4, 4) its inverse
    n_tri_records: int = 0
    kinds_present: tuple = ()
    env_id: int = -1            # the environment emitter's id, -1 = none
    env_kind: int = -1          # CONSTANT, ENVMAP or SKY, -1 = none

    @property
    def n_emitters(self):
        return self.kind.shape[0]

    @property
    def has_surface_emitters(self) -> bool:
        """Any emitter a BSDF ray can hit: area triangles or spheres."""
        return AREA in self.kinds_present or SPHERE in self.kinds_present


class EmitterBuilder:
    """Host-side accumulation of emitters; area emitters bind to shapes."""

    def __init__(self):
        self.rows = []           # per-emitter dicts
        self.area_shapes = []    # (emitter_idx, mesh)
        self.env = None          # (image, to_world) of the environment

    def _add(self, **kw):
        d = dict(kind=AREA, radiance=(1.0, 1.0, 1.0), position=(0, 0, 0),
                 direction=(0, 0, 1), cutoff_cos=np.cos(np.deg2rad(20.0)),
                 falloff_cos=np.cos(np.deg2rad(15.0)))
        d.update(kw)
        self.rows.append(d)
        return len(self.rows) - 1

    def area(self, mesh, radiance):
        """Area luminaire attached to a mesh (src/luminaires/area.cpp)."""
        e = self._add(kind=AREA, radiance=radiance)
        self.area_shapes.append((e, mesh))
        return e

    def point(self, position, intensity):
        return self._add(kind=POINT, position=position, radiance=intensity)

    def sphere_area(self, center, radius, radiance):
        """Analytic sphere area light, sampled by solid angle (reference
        sphere.cpp:359 sampleSolidAngle)."""
        return self._add(kind=SPHERE, position=center, radiance=radiance,
                         radius=float(radius))

    def spot(self, position, direction, intensity, cutoff_deg=20.0,
             falloff_deg=15.0):
        d = np.asarray(direction, np.float64)
        return self._add(kind=SPOT, position=position,
                         direction=d / np.linalg.norm(d), radiance=intensity,
                         cutoff_cos=np.cos(np.deg2rad(cutoff_deg)),
                         falloff_cos=np.cos(np.deg2rad(falloff_deg)))

    def directional(self, direction, irradiance):
        d = np.asarray(direction, np.float64)
        return self._add(kind=DIRECTIONAL, direction=d / np.linalg.norm(d),
                         radiance=irradiance)

    def constant(self, radiance):
        """Constant environment luminaire (src/luminaires/constant.cpp)."""
        return self._add(kind=CONSTANT, radiance=radiance)

    def collimated(self, position, direction, radiance,
                   radius: float = 0.01):
        """Collimated disk beam (src/luminaires/collimated.cpp:29-32) of
        the given radiance within `radius` of the axis position + t
        direction; the row's `cutoff_cos` slot holds the radius."""
        d = np.asarray(direction, np.float64)
        return self._add(kind=COLLIMATED, position=position,
                         direction=d / np.linalg.norm(d), radiance=radiance,
                         cutoff_cos=float(radius))

    def envmap(self, image, to_world=None, scale: float = 1.0):
        """Lat-long environment map (src/luminaires/envmap.cpp): its
        first three channels times `scale`."""
        img = np.asarray(image, np.float32)[:, :, :3] * scale
        self.env = (img, np.eye(4, dtype=np.float32) if to_world is None
                    else np.asarray(to_world, np.float32))
        return self._add(kind=ENVMAP, radiance=tuple(
            img.reshape(-1, 3).mean(0)))

    def sky(self, turbidity: float = 3.0, sun_dir=(0.0, 1.0, 0.0),
            scale: float = 1.0, resolution: int = 128, extend_below=True):
        """Preetham sky (src/luminaires/sky.cpp) baked on the host into a
        (resolution, 2 resolution) lat-long map (emitters/table.py:154):
        the map's +z pole is the world's zenith +y."""
        h, w = resolution, resolution * 2
        uu, vv = np.meshgrid((np.arange(w) + 0.5) / w,
                             (np.arange(h) + 0.5) / h)
        d = envmap.latlong_uv_to_dir(torch.as_tensor(
            np.stack([uu, vv], -1), dtype=torch.float32))
        d_world = torch.stack([d[..., 0], d[..., 2], d[..., 1]], -1)
        img = envmap.preetham_sky(d_world.reshape(-1, 3), sun_dir,
                                  turbidity, scale, extend_below)
        img = img.reshape(h, w, 3).numpy().astype(np.float32)
        rot = np.eye(4, dtype=np.float32)
        rot[:3, :3] = np.array([[1, 0, 0], [0, 0, 1], [0, 1, 0]],
                               np.float32).T
        self.env = (img, rot)
        return self._add(kind=SKY,
                         radiance=tuple(img.reshape(-1, 3).mean(0)))

    def build(self, tri_emitter_id, tri_areas) -> EmitterTable:
        """tri_emitter_id: (T,) per-triangle emitter binding (-1 none);
        tri_areas: (T,) triangle areas. Host numpy, the reference's
        EmitterBuilder.build (emitters/table.py:178)."""
        if not self.rows:
            # no emitters: one dead row and a zero CDF
            self.rows.append(dict(kind=POINT, radiance=(0, 0, 0),
                                  position=(0, 0, 0), direction=(0, 0, 1),
                                  cutoff_cos=0.0, falloff_cos=0.0))
        e = len(self.rows)
        kind = np.array([r["kind"] for r in self.rows], np.int32)
        # spectral rows widen to the widest channel count (uniform greys)
        c = max(len(np.atleast_1d(r["radiance"])) for r in self.rows)
        if c != 3:
            for r in self.rows:
                v = np.asarray(r["radiance"], np.float32).reshape(-1)
                if v.shape[0] != c:
                    if not np.all(v == v[0]):
                        raise ValueError(
                            f"emitter radiance width {v.shape[0]} cannot "
                            f"widen to {c} spectral channels (non-uniform)")
                    v = np.full(c, v[0], np.float32)
                r["radiance"] = v
        radiance = np.array([r["radiance"] for r in self.rows], np.float32)
        t = int(tri_emitter_id.shape[0])
        tri_emitter_id = np.asarray(tri_emitter_id)
        tri_areas = np.asarray(tri_areas, np.float64)
        if radiance.shape[-1] == 3:
            lum = np.maximum(
                0.212671 * radiance[:, 0] + 0.71516 * radiance[:, 1]
                + 0.072169 * radiance[:, 2], 0.0)
        else:
            lum = np.maximum(radiance.mean(axis=-1), 0.0)
        tri_w = np.where(
            tri_emitter_id >= 0,
            tri_areas * lum[np.clip(tri_emitter_id, 0, e - 1)],
            0.0,
        )
        radius = np.array([float(r.get("radius", 0.0)) for r in self.rows],
                          np.float32)
        other_ids = [i for i in range(e) if kind[i] != AREA and lum[i] > 0]
        other_w = [lum[i] * (4.0 * np.pi * radius[i] ** 2
                             if kind[i] == SPHERE else 4.0 * np.pi)
                   for i in other_ids]
        emissive = np.nonzero((tri_w > 0) & (tri_areas > 0))[0]
        t_rec = int(emissive.shape[0])
        rec_w = np.concatenate([tri_w[emissive],
                                np.asarray(other_w, np.float64)])
        total = rec_w.sum()
        pmf = rec_w / total if total > 0 else np.zeros_like(rec_w)
        if pmf.size == 0:       # no emitter at all: one dead record
            pmf = np.zeros(1)
        cdf = np.cumsum(pmf)
        rec_emitter = np.concatenate(
            [np.clip(tri_emitter_id, 0, e - 1)[emissive],
             np.asarray(other_ids, np.int64)]).astype(np.int32)
        if rec_emitter.size == 0:
            rec_emitter = np.zeros(1, np.int32)
        rec_prim = np.zeros(rec_emitter.size, np.int32)
        rec_prim[:t_rec] = emissive
        tri_pdf_area = np.zeros(t)
        if t_rec:
            tri_pdf_area[emissive] = pmf[:t_rec] / np.maximum(
                tri_areas[emissive], 1e-20)
        env_id = env_kind = -1
        for i in range(e):
            if kind[i] in ENV_KINDS:
                env_id, env_kind = i, int(kind[i])

        def dev(x, dtype):
            return torch.as_tensor(np.asarray(x, dtype))

        if self.env is not None:
            img, to_world = self.env
            prob, alias, pdf_img = envmap.build_env_cdfs(img)
            inv = np.linalg.inv(to_world)
        else:
            img = np.zeros((1, 1, 3))
            prob, alias = np.ones(1), np.zeros(1)
            pdf_img = np.full((1, 1), np.float32(0.25 / np.pi))
            to_world = inv = np.eye(4)

        def col(key):
            return dev([r[key] for r in self.rows], np.float32)

        return EmitterTable(
            kind=dev(kind, np.int32),
            radiance=dev(radiance, np.float32),
            position=col("position"),
            direction=col("direction"),
            cutoff_cos=col("cutoff_cos"),
            falloff_cos=col("falloff_cos"),
            tri_pdf_area=dev(tri_pdf_area, np.float32),
            rec_cdf=dev(cdf, np.float32),
            rec_pmf=dev(pmf, np.float32),
            rec_emitter=dev(rec_emitter, np.int32),
            rec_prim=dev(rec_prim, np.int32),
            radius=dev(radius, np.float32),
            env_image=dev(img, np.float32),
            env_prob=dev(prob, np.float32),
            env_alias=dev(alias, np.int32),
            env_pdf_img=dev(pdf_img, np.float32),
            env_to_world=dev(to_world, np.float32),
            env_to_env=dev(inv, np.float32),
            n_tri_records=t_rec,
            kinds_present=tuple(sorted(set(int(k) for k in kind))),
            env_id=env_id,
            env_kind=env_kind,
        )


def sample_direct(em: EmitterTable, geom, p_ref, u_select, u_pos) \
        -> DirectSample:
    """Sample a direction toward the scene's emitters from p_ref
    (emitters/table.py:329).

    u_select: (N,) uniform for record selection; u_pos: (N, 2) position
    sample. pdf is in solid-angle measure (a delta light's is its record
    pmf); value is the emitted radiance, NOT divided by the pdf.
    """
    n = p_ref.shape[0]
    dev = p_ref.device
    n_rec = em.rec_pmf.shape[0]
    # the reference counts cdf entries < u up to 128 records and <= u above
    # that; the two differ only when u lands exactly on a cdf step
    rec = torch.searchsorted(em.rec_cdf, u_select.contiguous(),
                             right=n_rec > 128)
    rec = torch.clamp(rec, 0, n_rec - 1)
    pmf = em.rec_pmf[rec]
    eid = em.rec_emitter[rec].long()
    kind = em.kind[eid]
    is_tri = rec < em.n_tri_records

    n_ch = em.radiance.shape[-1]
    out_d = torch.zeros((n, 3), device=dev)
    out_dist = torch.full((n,), float("inf"), device=dev)
    out_n = torch.zeros((n, 3), device=dev)
    out_value = torch.zeros((n, n_ch), device=dev)
    out_pdf = torch.zeros((n,), device=dev)
    out_delta = torch.zeros(n, dtype=torch.bool, device=dev)
    valid = pmf > 0
    kinds = em.kinds_present

    def put(mask, d, dist, value, pdf, nrm=None):
        nonlocal out_d, out_dist, out_n, out_value, out_pdf
        out_d = torch.where(mask[:, None], d, out_d)
        out_dist = torch.where(mask, dist, out_dist)
        if nrm is not None:
            out_n = torch.where(mask[:, None], nrm, out_n)
        out_value = torch.where(mask[:, None], value, out_value)
        out_pdf = torch.where(mask, pdf, out_pdf)

    if AREA in kinds:
        ti = em.rec_prim[rec].long()
        v0_s, e1_s, e2_s = geom.v0[ti], geom.e1[ti], geom.e2[ti]
        pdf_area = em.tri_pdf_area[ti]
        bary = warp.square_to_uniform_triangle(u_pos)
        pos = v0_s + e1_s * bary[:, :1] + e2_s * bary[:, 1:2]
        nrm = m.normalize(m.cross(e1_s, e2_s))
        to_l = pos - p_ref
        dist2 = torch.clamp(m.squared_length(to_l), min=1e-12)
        dist = torch.sqrt(dist2)
        d = to_l / dist[:, None]
        cos_l = m.dot(nrm, -d)              # one-sided: emits on normal side
        pdf_sa = pdf_area * dist2 / torch.clamp(cos_l, min=1e-8)
        ok = is_tri & (cos_l > 1e-6) & (pdf_area > 0)
        put(ok, d, dist, em.radiance[eid], pdf_sa, nrm)
        valid = valid & torch.where(is_tri, ok, True)

    sel_other = ~is_tri
    if SPHERE in kinds:
        # cone sampling toward the sphere (sphere.cpp:359): pdf is
        # pmf / (2 pi (1 - cos_max)), the record pmf folded in
        mask = sel_other & (kind == SPHERE)
        c = em.position[eid]
        r = em.radius[eid]
        dc_v = c - p_ref
        dc2 = torch.clamp(m.squared_length(dc_v), min=1e-12)
        dc = torch.sqrt(dc2)
        outside = dc > r * (1.0 + 1e-5)
        sin2_max = torch.clamp(r * r / dc2, 0.0, 1.0 - 1e-7)
        cos_max = torch.sqrt(1.0 - sin2_max)
        cos_t = 1.0 - u_pos[:, 0] * (1.0 - cos_max)
        sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
        phi = 2.0 * np.pi * u_pos[:, 1]
        axis = dc_v / dc[:, None]
        d = m.Frame.from_normal(axis).to_world(torch.stack(
            [sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t], dim=-1))
        disc = torch.clamp(r * r - dc2 * (1.0 - cos_t * cos_t), min=0.0)
        dist = dc * cos_t - torch.sqrt(disc)
        nrm = m.normalize(p_ref + d * dist[:, None] - c)
        pdf_sa = pmf / torch.clamp(2.0 * np.pi * (1.0 - cos_max), min=1e-9)
        ok = mask & outside
        put(ok, d, dist, em.radiance[eid], pdf_sa, nrm)
        valid = valid & torch.where(mask, ok, True)
        sel_other = sel_other & (kind != SPHERE)

    if POINT in kinds:
        mask = sel_other & (kind == POINT)
        to_l = em.position[eid] - p_ref
        dist2 = torch.clamp(m.squared_length(to_l), min=1e-12)
        dist = torch.sqrt(dist2)
        put(mask, to_l / dist[:, None], dist,
            em.radiance[eid] / dist2[:, None], pmf)
        out_delta = out_delta | mask
    if SPOT in kinds:
        mask = sel_other & (kind == SPOT)
        to_l = em.position[eid] - p_ref
        dist2 = torch.clamp(m.squared_length(to_l), min=1e-12)
        dist = torch.sqrt(dist2)
        d = to_l / dist[:, None]
        cos_a = m.dot(em.direction[eid], -d)
        cc, fc = em.cutoff_cos[eid], em.falloff_cos[eid]
        fall = torch.clamp((cos_a - cc) / torch.clamp(fc - cc, min=1e-6),
                           0.0, 1.0)
        inside = cos_a > cc
        out_d = torch.where(mask[:, None], d, out_d)
        out_dist = torch.where(mask, dist, out_dist)
        out_value = torch.where(
            (mask & inside)[:, None],
            em.radiance[eid] * fall[:, None] / dist2[:, None], out_value)
        out_pdf = torch.where(mask, pmf, out_pdf)
        out_delta = out_delta | mask
        valid = valid & torch.where(mask, inside, True)
    if DIRECTIONAL in kinds:
        mask = sel_other & (kind == DIRECTIONAL)
        put(mask, -em.direction[eid], 1e7, em.radiance[eid], pmf)
        out_delta = out_delta | mask
    if COLLIMATED in kinds:
        mask = sel_other & (kind == COLLIMATED)
        axis = em.direction[eid]
        rel = p_ref - em.position[eid]
        t_ax = m.dot(rel, axis)
        radial = rel - t_ax[:, None] * axis
        inside = (m.length(radial) <= em.cutoff_cos[eid]) & (t_ax > 0)
        out_d = torch.where(mask[:, None], -axis, out_d)
        out_dist = torch.where(mask, t_ax, out_dist)
        out_value = torch.where((mask & inside)[:, None], em.radiance[eid],
                                out_value)
        out_pdf = torch.where(mask, pmf, out_pdf)
        out_delta = out_delta | mask
        valid = valid & torch.where(mask, inside, True)
    if CONSTANT in kinds:
        mask = sel_other & (kind == CONSTANT)
        put(mask, warp.square_to_uniform_sphere(u_pos), 1e7,
            em.radiance[eid], pmf * m.INV_FOURPI)
    if ENVMAP in kinds or SKY in kinds:
        # the sampled direction is a texel centre, whose bilinear value is
        # the texel itself: the radiance is one row gather
        mask = sel_other & ((kind == ENVMAP) | (kind == SKY))
        d, pdf_dir, val = envmap.env_sample(
            em.env_prob, em.env_alias, em.env_pdf_img, em.env_image, u_pos,
            em.env_to_world)
        put(mask, d, 1e7, val, pmf * pdf_dir)

    return DirectSample(
        d=out_d,
        dist=out_dist,
        n=out_n,
        value=out_value,
        pdf=out_pdf,
        emitter_id=eid.to(torch.int32),
        delta=out_delta,
        valid=valid & (out_pdf > 0),
    )


def pdf_direct_area(em: EmitterTable, prim_id, p_ref, p_hit, n_hit,
                    emitter_id=None):
    """Solid-angle NEE pdf of having sampled the area-emitter point p_hit
    on triangle prim_id from p_ref — the MIS counterweight when a BSDF ray
    hits a luminaire (reference Scene::pdfLuminaire, scene.cpp:381). Pass
    emitter_id to cover analytic sphere emitters (their cone-sampling pdf,
    sphere.cpp pdfSolidAngle), known by kind since their prim ids lie past
    the triangles (emitters/table.py:523)."""
    ti = torch.clamp(prim_id, 0, em.tri_pdf_area.shape[0] - 1).long()
    pdf_area = em.tri_pdf_area[ti]
    to_l = p_hit - p_ref
    dist2 = torch.clamp(m.squared_length(to_l), min=1e-12)
    d = to_l / torch.sqrt(dist2)[:, None]
    cos_l = m.dot(n_hit, -d)
    pdf = torch.where(cos_l > 1e-6,
                      pdf_area * dist2 / torch.clamp(cos_l, min=1e-8), 0.0)
    if emitter_id is not None and SPHERE in em.kinds_present:
        eid = torch.clamp(emitter_id, 0, em.n_emitters - 1).long()
        is_sph = (emitter_id >= 0) & (em.kind[eid] == SPHERE)
        c = em.position[eid]
        r = em.radius[eid]
        dc2 = torch.clamp(m.squared_length(c - p_ref), min=1e-12)
        sin2_max = torch.clamp(r * r / dc2, 0.0, 1.0 - 1e-7)
        cos_max = torch.sqrt(1.0 - sin2_max)
        pdf_sph = _sphere_rec_pmf(em, eid) / torch.clamp(
            2.0 * np.pi * (1.0 - cos_max), min=1e-9)
        pdf_sph = torch.where(dc2 > r * r, pdf_sph, 0.0)
        pdf = torch.where(is_sph, pdf_sph, pdf)
    return pdf


def _sphere_rec_pmf(em: EmitterTable, eid):
    """Selection pmf of the record of emitter eid (records past the
    triangles map one to one to the other emitters)."""
    other = em.rec_emitter[em.n_tri_records:].long()
    if other.shape[0] == 0:
        return torch.zeros(eid.shape, device=eid.device)
    hit = eid[:, None] == other[None, :]
    return torch.where(hit, em.rec_pmf[em.n_tri_records:][None, :],
                       0.0).sum(-1)


def eval_emitter_hit(em: EmitterTable, emitter_id, wi_world, n_hit):
    """Radiance emitted toward wi_world when a ray hits an area emitter
    (reference AreaLuminaire::Le — one-sided on the normal side)."""
    eid = torch.clamp(emitter_id, 0, em.n_emitters - 1).long()
    vis = (emitter_id >= 0) & (m.dot(n_hit, wi_world) > 0)
    return torch.where(vis[:, None], em.radiance[eid], 0.0)


def _env_pmf(em: EmitterTable):
    rec = slice(em.n_tri_records, None)
    return torch.where(em.rec_emitter[rec] == em.env_id,
                       em.rec_pmf[rec], 0.0).sum()


def eval_environment(em: EmitterTable, d_world):
    """Background radiance for escaped rays (emitters/table.py:575,
    reference Scene::LeBackground): zero without an environment."""
    shape = d_world.shape[:-1]
    if em.env_id < 0:
        return torch.zeros(shape + (em.radiance.shape[-1],),
                           device=d_world.device)
    if em.env_kind in (ENVMAP, SKY):
        return envmap.env_eval(em.env_image, d_world, to_env=em.env_to_env)
    return em.radiance[em.env_id].expand(shape + (em.radiance.shape[-1],))


def eval_and_pdf_environment(em: EmitterTable, d_world):
    """Background radiance for escaped rays and the NEE pdf of having
    sampled their direction (emitters/table.py:587): the fused pair, the
    same bits as `eval_environment` and `pdf_environment`."""
    shape = d_world.shape[:-1]
    if em.env_id < 0:
        return (torch.zeros(shape + (em.radiance.shape[-1],),
                            device=d_world.device),
                torch.zeros(shape, device=d_world.device))
    pmf_env = _env_pmf(em)
    if em.env_kind in (ENVMAP, SKY):
        val, pdf = envmap.env_eval_pdf(em.env_image, em.env_pdf_img,
                                       d_world, em.env_to_env)
        return val, pmf_env * pdf
    val = em.radiance[em.env_id].expand(shape + (em.radiance.shape[-1],))
    return val, (pmf_env * m.INV_FOURPI).expand(shape)


def pdf_environment(em: EmitterTable, d_world):
    """NEE solid-angle pdf of sampling direction d toward the environment
    (emitters/table.py:608)."""
    shape = d_world.shape[:-1]
    if em.env_id < 0:
        return torch.zeros(shape, device=d_world.device)
    pmf_env = _env_pmf(em)
    if em.env_kind in (ENVMAP, SKY):
        return pmf_env * envmap.env_pdf(em.env_pdf_img, d_world,
                                        to_env=em.env_to_env)
    return (pmf_env * m.INV_FOURPI).expand(shape)
