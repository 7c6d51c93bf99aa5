"""Emitters: SoA table and direct-illumination sampling (port of the area-
light and sky parts of mitsuba_tpu/emitters/table.py; reference
src/luminaires/area.cpp, sky.cpp and src/librender/scene.cpp:319-396).

One sampling record per emissive triangle, weighted by area × luminance,
then one per other emitter (the sky: luminance × 4π), all chosen through
one flat CDF. The reference picks the record and gathers its triangle
with one-hot matmuls for the TPU's matrix unit; here both are plain index
gathers, which are exact. The sky is baked on the host into a lat-long
map that shares the environment-map sampler (emitters/envmap.py).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from mitsuba_tpu_torch.core import math as m
from mitsuba_tpu_torch.core import warp
from mitsuba_tpu_torch.emitters import envmap
from mitsuba_tpu_torch.render.records import DirectSample

AREA, SKY = 0, 7                    # the reference's kind numbers
KIND_NAMES = {AREA: "area", SKY: "sky"}


@dataclass
class EmitterTable:
    kind: torch.Tensor          # (E,) int32
    radiance: torch.Tensor      # (E, C)
    tri_pdf_area: torch.Tensor  # (T,) selection prob / area; 0 if not emissive
    rec_cdf: torch.Tensor       # (R,) CDF over records
    rec_pmf: torch.Tensor       # (R,)
    rec_emitter: torch.Tensor   # (R,) emitter id per record
    rec_prim: torch.Tensor      # (R,) triangle id per record
    # environment map (lat-long; the sky is baked to one), None without
    env_image: torch.Tensor = None     # (He, We, C)
    env_prob: torch.Tensor = None      # (He*We,) alias-table keep prob
    env_alias: torch.Tensor = None     # (He*We,) alias-table partner
    env_pdf_img: torch.Tensor = None   # (He, We) solid-angle pdf
    env_to_world: torch.Tensor = None  # (4, 4) env frame -> world
    env_to_env: torch.Tensor = None    # (4, 4) its inverse
    n_tri_records: int = 0
    kinds_present: tuple = ()
    env_id: int = -1            # the environment emitter's id, -1 = none

    @property
    def n_emitters(self):
        return self.kind.shape[0]

    @property
    def has_surface_emitters(self) -> bool:
        return AREA in self.kinds_present


def check_kinds(kinds):
    """Raise for any emitter kind the port does not implement yet."""
    missing = sorted(set(int(k) for k in kinds) - set(KIND_NAMES))
    if missing:
        raise NotImplementedError(
            f"emitter kinds {missing} are not ported (only area lights)")


class EmitterBuilder:
    """Host-side accumulation of area emitters bound to shapes."""

    def __init__(self):
        self.rows = []           # per-emitter dicts
        self.area_shapes = []    # (emitter_idx, mesh)
        self.env = None          # (image, to_world) of the environment

    def area(self, mesh, radiance):
        """Area luminaire attached to a mesh (src/luminaires/area.cpp)."""
        self.rows.append(dict(kind=AREA, radiance=radiance))
        e = len(self.rows) - 1
        self.area_shapes.append((e, mesh))
        return e

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
        self.rows.append(dict(kind=SKY,
                              radiance=tuple(img.reshape(-1, 3).mean(0))))
        return len(self.rows) - 1

    def build(self, tri_emitter_id, tri_areas) -> EmitterTable:
        """tri_emitter_id: (T,) per-triangle emitter binding (-1 none);
        tri_areas: (T,) triangle areas. Host numpy, copied from the
        reference's EmitterBuilder.build (emitters/table.py:178) for area
        lights and the sky."""
        if not self.rows:
            raise NotImplementedError(
                "a scene without emitters is not ported")
        e = len(self.rows)
        kind = np.array([r["kind"] for r in self.rows], np.int32)
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
        other_ids = [i for i in range(e) if kind[i] != AREA and lum[i] > 0]
        emissive = np.nonzero((tri_w > 0) & (tri_areas > 0))[0]
        t_rec = int(emissive.shape[0])
        rec_w = np.concatenate([tri_w[emissive],
                                np.asarray([lum[i] * 4.0 * np.pi
                                            for i in other_ids])])
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

        def dev(x, dtype):
            return torch.as_tensor(np.asarray(x, dtype))

        env = {}
        env_id = max((i for i in range(e) if kind[i] == SKY), default=-1)
        if self.env is not None:
            img, to_world = self.env
            prob, alias, pdf_img = envmap.build_env_cdfs(img)
            env = dict(env_image=dev(img, np.float32),
                       env_prob=dev(prob, np.float32),
                       env_alias=dev(alias, np.int32),
                       env_pdf_img=dev(pdf_img, np.float32),
                       env_to_world=dev(to_world, np.float32),
                       env_to_env=dev(np.linalg.inv(to_world), np.float32))
        return EmitterTable(
            **env,
            env_id=env_id,
            kind=dev(kind, np.int32),
            radiance=dev(radiance, np.float32),
            tri_pdf_area=dev(tri_pdf_area, np.float32),
            rec_cdf=dev(cdf, np.float32),
            rec_pmf=dev(pmf, np.float32),
            rec_emitter=dev(rec_emitter, np.int32),
            rec_prim=dev(rec_prim, np.int32),
            n_tri_records=t_rec,
            kinds_present=tuple(sorted(set(int(k) for k in kind))),
        )


def sample_direct(em: EmitterTable, geom, p_ref, u_select, u_pos) \
        -> DirectSample:
    """Sample a direction toward the scene's emitters (area lights and
    the environment) from p_ref.

    u_select: (N,) uniform for record selection; u_pos: (N, 2) position
    sample. pdf is in solid-angle measure; value is the emitted radiance,
    NOT divided by the pdf.
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
    is_tri = rec < em.n_tri_records

    n_ch = em.radiance.shape[-1]
    out_d = torch.zeros((n, 3), device=dev)
    out_dist = torch.full((n,), float("inf"), device=dev)
    out_n = torch.zeros((n, 3), device=dev)
    out_value = torch.zeros((n, n_ch), device=dev)
    out_pdf = torch.zeros((n,), device=dev)
    valid = pmf > 0

    if AREA in em.kinds_present:
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
        out_d = torch.where(ok[:, None], d, out_d)
        out_dist = torch.where(ok, dist, out_dist)
        out_n = torch.where(ok[:, None], nrm, out_n)
        out_value = torch.where(ok[:, None], em.radiance[eid], out_value)
        out_pdf = torch.where(ok, pdf_sa, out_pdf)
        valid = valid & torch.where(is_tri, ok, True)

    if em.env_image is not None:
        # the sampled direction is a texel centre, whose bilinear value is
        # the texel itself: the radiance is one row gather
        mask = ~is_tri & (em.kind[eid] == SKY)
        d, pdf_dir, val = envmap.env_sample(
            em.env_prob, em.env_alias, em.env_pdf_img, em.env_image, u_pos,
            em.env_to_world)
        out_d = torch.where(mask[:, None], d, out_d)
        out_dist = torch.where(mask, 1e7, out_dist)
        out_value = torch.where(mask[:, None], val, out_value)
        out_pdf = torch.where(mask, pmf * pdf_dir, out_pdf)

    return DirectSample(
        d=out_d,
        dist=out_dist,
        n=out_n,
        value=out_value,
        pdf=out_pdf,
        emitter_id=eid.to(torch.int32),
        delta=torch.zeros(n, dtype=torch.bool, device=dev),
        valid=valid & (out_pdf > 0),
    )


def pdf_direct_area(em: EmitterTable, prim_id, p_ref, p_hit, n_hit):
    """Solid-angle NEE pdf of having sampled the area-emitter point p_hit
    on triangle prim_id from p_ref — the MIS counterweight when a BSDF ray
    hits a luminaire (reference Scene::pdfLuminaire, scene.cpp:381)."""
    ti = torch.clamp(prim_id, 0, em.tri_pdf_area.shape[0] - 1).long()
    pdf_area = em.tri_pdf_area[ti]
    to_l = p_hit - p_ref
    dist2 = torch.clamp(m.squared_length(to_l), min=1e-12)
    d = to_l / torch.sqrt(dist2)[:, None]
    cos_l = m.dot(n_hit, -d)
    return torch.where(cos_l > 1e-6,
                       pdf_area * dist2 / torch.clamp(cos_l, min=1e-8), 0.0)


def eval_emitter_hit(em: EmitterTable, emitter_id, wi_world, n_hit):
    """Radiance emitted toward wi_world when a ray hits an area emitter
    (reference AreaLuminaire::Le — one-sided on the normal side)."""
    eid = torch.clamp(emitter_id, 0, em.n_emitters - 1).long()
    vis = (emitter_id >= 0) & (m.dot(n_hit, wi_world) > 0)
    return torch.where(vis[:, None], em.radiance[eid], 0.0)


def eval_and_pdf_environment(em: EmitterTable, d_world):
    """Background radiance for escaped rays and the NEE pdf of having
    sampled their direction (emitters/table.py:587): zero without an
    environment emitter. The reference's fused and separate functions
    give the same bits; `eval_environment` and `pdf_environment` below
    are its two halves."""
    shape = d_world.shape[:-1]
    if em.env_id < 0:
        return (torch.zeros(shape + (em.radiance.shape[-1],),
                            device=d_world.device),
                torch.zeros(shape, device=d_world.device))
    rec = slice(em.n_tri_records, None)
    pmf_env = torch.where(em.rec_emitter[rec] == em.env_id,
                          em.rec_pmf[rec], 0.0).sum()
    val, pdf = envmap.env_eval_pdf(em.env_image, em.env_pdf_img, d_world,
                                   em.env_to_env)
    return val, pmf_env * pdf


def eval_environment(em: EmitterTable, d_world):
    """Background radiance for escaped rays (emitters/table.py:575,
    reference Scene::LeBackground)."""
    return eval_and_pdf_environment(em, d_world)[0]


def pdf_environment(em: EmitterTable, d_world):
    """NEE solid-angle pdf of sampling direction d toward the environment
    (emitters/table.py:608)."""
    return eval_and_pdf_environment(em, d_world)[1]
