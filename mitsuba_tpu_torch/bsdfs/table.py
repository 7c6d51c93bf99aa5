"""SoA material table (port of mitsuba_tpu/bsdfs/table.py: every kind, the
opacity column of the mask adapter that `null()` sets to 0, the
composite's child rows and weights, and the woven cloth's shared weave
tables with each row's slot in them, bsdfs/irawan.py).

The reference gathers small tables with a one-hot matmul for the TPU's
matrix unit; here `gather` is a plain index gather, which is exact.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from mitsuba_tpu_torch.core import microfacet as mf

# the reference's kind numbers
LAMBERTIAN = 0      # src/bsdfs/lambertian.cpp
MIRROR = 1          # src/bsdfs/mirror.cpp
DIELECTRIC = 2      # src/bsdfs/dielectric.cpp (smooth glass)
ROUGH_CONDUCTOR = 3  # src/bsdfs/roughmetal.cpp, microfacet lobe
PHONG = 4           # src/bsdfs/phong.cpp
WARD = 5            # src/bsdfs/ward.cpp (anisotropic)
ROUGH_GLASS = 6     # src/bsdfs/roughglass.cpp
DIFF_TRANS = 7      # src/bsdfs/difftrans.cpp (diffuse transmitter)
WISCOMBE = 8        # src/bsdfs/wiscombe.cpp (the fork's snow BRDF)
HANRAHAN_KRUEGER = 9  # src/bsdfs/hanrahan-krueger.cpp
COMPOSITE = 10      # src/bsdfs/composite.cpp (N weighted lobes)
CLOTH = 11          # src/bsdfs/irawan.cpp (woven cloth, weave patterns)
MAX_COMPOSITE_LOBES = 4
KIND_NAMES = {LAMBERTIAN: "lambertian", MIRROR: "mirror",
              DIELECTRIC: "dielectric", ROUGH_CONDUCTOR: "roughconductor",
              PHONG: "phong", WARD: "ward", ROUGH_GLASS: "roughglass",
              DIFF_TRANS: "difftrans", WISCOMBE: "wiscombe",
              HANRAHAN_KRUEGER: "hk", COMPOSITE: "composite",
              CLOTH: "irawan"}
# the columns a kind reads beyond those every lane gathers, so that a
# scene gathers only what its kinds need
_KIND_FIELDS = {DIELECTRIC: ("transmittance", "eta"),
                ROUGH_CONDUCTOR: ("alpha_u", "cond_eta", "cond_k",
                                  "dist_type"),
                WARD: ("alpha_u", "alpha_v"),
                ROUGH_GLASS: ("transmittance", "eta", "alpha_u",
                              "dist_type"),
                DIFF_TRANS: ("transmittance",),
                WISCOMBE: ("transmittance",),
                HANRAHAN_KRUEGER: ("transmittance", "eta", "alpha_u")}
# the colour fields, which take the scene's channel count
_COLOR_FIELDS = ("reflectance", "specular", "transmittance")


@dataclass
class MaterialTable:
    kind: torch.Tensor         # (M,) int32
    reflectance: torch.Tensor  # (M, C) diffuse albedo
    two_sided: torch.Tensor    # (M,) bool — twosided adapter applied
    specular: torch.Tensor     # (M, C) specular reflectance (phong, mirror)
    exponent: torch.Tensor     # (M,) phong exponent
    tex_id: torch.Tensor       # (M,) reflectance texture, -1 = none
    transmittance: torch.Tensor  # (M, C) dielectric transmittance
    eta: torch.Tensor          # (M,) interior / exterior IOR
    cond_eta: torch.Tensor     # (M, 3) conductor eta
    cond_k: torch.Tensor       # (M, 3) conductor absorption
    alpha_u: torch.Tensor      # (M,) microfacet roughness
    alpha_v: torch.Tensor      # (M,)
    dist_type: torch.Tensor    # (M,) int32 microfacet distribution
    opacity: torch.Tensor = None  # (M,) mask adapter, 1 = opaque
    child_ids: torch.Tensor = None      # (M, 4) composite child rows, -1 pad
    child_weights: torch.Tensor = None  # (M, 4) composite lobe weights
    cloth_slot: torch.Tensor = None     # (M,) int32 cloth table row, -1
    # the cloth materials' shared weave tables (irawan.py pack_patterns:
    # grid, yarn, kd, ks, gl), None without a cloth row
    cloth: dict = None
    # the (kind, distribution) pairs present: the distribution is a static
    # choice, so each pair is dispatched on its own (as in the reference)
    kinds_present: tuple = ((LAMBERTIAN, mf.BECKMANN),)
    # a row with opacity < 0.999, decided on the host when the table is
    # built (dispatch.py:168 _np_min_opacity), never by a device sync
    has_mask: bool = False
    # a composite row is present (its children are listed in
    # kinds_present, the composite itself is not)
    has_composite: bool = False

    @property
    def n_materials(self):
        return self.kind.shape[0]

    def gather(self, material_id):
        """Per-lane parameter rows of the columns the table's kinds read
        (clamped; id < 0 reads row 0 and callers mask)."""
        i = torch.clamp(material_id, 0, self.n_materials - 1).long()
        names = ["kind", "reflectance", "two_sided", "specular", "exponent"]
        for kind, _ in self.kinds_present:
            names += _KIND_FIELDS.get(kind, ())
        out = {name: getattr(self, name)[i] for name in dict.fromkeys(names)}
        if self.cloth is not None:
            out.update(_cloth=self.cloth, _cloth_slot=self.cloth_slot[i])
        return out

    def to(self, device) -> "MaterialTable":
        """The table, the cloth's tables included, on `device`."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)},
            cloth=None if self.cloth is None else {
                k: v.to(device) for k, v in self.cloth.items()})


def check_kinds(kinds):
    """Raise for a BSDF kind that neither package has."""
    missing = sorted(set(int(k) for k in kinds) - set(KIND_NAMES))
    if missing:
        raise NotImplementedError(
            f"BSDF kinds {missing} are unknown (the kinds are "
            f"{', '.join(KIND_NAMES.values())})")


class MaterialBuilder:
    """Accumulates material rows host-side, emits a MaterialTable."""

    def __init__(self):
        self.rows = []
        self.cloth_specs = []

    def _add(self, **kw):
        row = dict(kind=LAMBERTIAN, reflectance=(0.5, 0.5, 0.5),
                   specular=(1.0, 1.0, 1.0), transmittance=(1.0, 1.0, 1.0),
                   eta=1.5, cond_eta=(0.2, 0.9, 1.4), cond_k=(3.9, 2.5, 2.1),
                   alpha_u=0.1, alpha_v=0.1, exponent=30.0,
                   dist_type=mf.BECKMANN, tex_id=-1, two_sided=False,
                   opacity=1.0, child_ids=(-1,) * MAX_COMPOSITE_LOBES,
                   child_weights=(0.0,) * MAX_COMPOSITE_LOBES,
                   cloth_slot=-1)
        row.update(kw)
        self.rows.append(row)
        return len(self.rows) - 1

    def lambertian(self, reflectance=(0.5, 0.5, 0.5), two_sided=False,
                   tex_id=-1):
        return self._add(kind=LAMBERTIAN, reflectance=reflectance,
                         two_sided=two_sided, tex_id=tex_id)

    def null(self):
        """An index-matched pass-through boundary (reference: a shape
        without a BSDF is no occluder, Shape::isOccluder), for shapes that
        only bound a medium: an opacity-0 mask over a black lambertian
        (table.py:176). Sampling passes straight through with weight 1,
        and shadow walks cross it."""
        return self._add(kind=LAMBERTIAN, reflectance=(0.0, 0.0, 0.0),
                         opacity=0.0)

    def mirror(self, specular=(1.0, 1.0, 1.0)):
        return self._add(kind=MIRROR, specular=specular)

    def dielectric(self, int_ior=1.5, ext_ior=1.0, specular=(1, 1, 1),
                   transmittance=(1, 1, 1)):
        return self._add(kind=DIELECTRIC, eta=int_ior / ext_ior,
                         specular=specular, transmittance=transmittance)

    def rough_conductor(self, alpha=0.1, cond_eta=(0.2, 0.9, 1.4),
                        cond_k=(3.9, 2.5, 2.1), specular=(1, 1, 1),
                        dist=mf.BECKMANN):
        return self._add(kind=ROUGH_CONDUCTOR, alpha_u=alpha, alpha_v=alpha,
                         cond_eta=cond_eta, cond_k=cond_k, specular=specular,
                         dist_type=dist)

    def phong(self, diffuse=(0.5, 0.5, 0.5), specular=(0.2, 0.2, 0.2),
              exponent=30.0, tex_id=-1):
        return self._add(kind=PHONG, reflectance=diffuse, specular=specular,
                         exponent=exponent, tex_id=tex_id)

    def ward(self, diffuse=(0.5, 0.5, 0.5), specular=(0.2, 0.2, 0.2),
             alpha_u=0.1, alpha_v=0.1):
        return self._add(kind=WARD, reflectance=diffuse, specular=specular,
                         alpha_u=alpha_u, alpha_v=alpha_v)

    def rough_glass(self, alpha=0.1, int_ior=1.5, ext_ior=1.0,
                    specular=(1, 1, 1), transmittance=(1, 1, 1),
                    dist=mf.GGX):
        return self._add(kind=ROUGH_GLASS, alpha_u=alpha, alpha_v=alpha,
                         eta=int_ior / ext_ior, specular=specular,
                         transmittance=transmittance, dist_type=dist)

    def diff_trans(self, transmittance=(0.5, 0.5, 0.5)):
        return self._add(kind=DIFF_TRANS, transmittance=transmittance)

    def wiscombe(self, g=0.874, w0=(0.99, 0.99, 0.99),
                 sigma_t=(16.4967, 6.0957, 4.6547), depth=1.0):
        """The Wiscombe-Warren snow BRDF; its delta-Eddington constants
        in float64 on the host (reference wiscombe.cpp configure()):
        reflectance <- wStar / (1 + P), specular <- xi, transmittance <-
        bStar, alpha_u <- g. sigma_t and depth are accepted, as the
        reference's configure() reads them, and unused."""
        g = float(g)
        w0 = np.asarray(w0, np.float64)
        g_sq = g * g
        w_star = ((1 - g_sq) * w0) / (1 - g_sq * w0)
        g_star = g / (1 + g)
        b_star = g_star / (1 - w_star * g_star)
        xi = np.sqrt(3.0 * (1 - w_star * g_star) * (1 - w_star))
        p_const = (2 * xi) / ((1 - w_star * g_star) * 3)
        a_const = w_star / (1 + p_const)
        return self._add(kind=WISCOMBE, reflectance=tuple(a_const),
                         specular=tuple(xi), transmittance=tuple(b_star),
                         alpha_u=g)

    def _add_cloth(self, pattern, repeat_u, repeat_v, kd_mult, ks_mult):
        """A weave pattern and a row pointing at it (table.py:243); the
        row's reflectance is its warp yarns' mean kd and its specular all
        yarns' mean ks, as the reference's, for what reads one colour a
        row; the model reads the segment tables (bsdfs/irawan.py)."""
        from mitsuba_tpu_torch.io.weave import EWARP

        warp_yarns = [y for y in pattern.yarns if y.type == EWARP] \
            or pattern.yarns

        def mean(ys, f):
            return tuple(np.mean([getattr(y, f) for y in ys], axis=0))

        self.cloth_specs.append(dict(
            pattern=pattern, repeat_u=float(repeat_u),
            repeat_v=float(repeat_v), kd_mult=float(kd_mult),
            ks_mult=float(ks_mult)))
        return self._add(kind=CLOTH, reflectance=mean(warp_yarns, "kd"),
                         specular=mean(pattern.yarns, "ks"),
                         cloth_slot=len(self.cloth_specs) - 1)

    def irawan(self, warp_kd=(0.3, 0.27, 0.25), weft_kd=(0.6, 0.1, 0.1),
               ks=(0.2, 0.2, 0.2), repeat_u=10.0, repeat_v=10.0,
               pattern: str = "plain", kd_mult=1.0, ks_mult=1.0):
        """Woven cloth of a procedural plain or twill weave (the
        reference needs a pattern file; table.py:270), through the whole
        yarn model on the pattern it synthesizes."""
        from mitsuba_tpu_torch.bsdfs.irawan import procedural_pattern

        return self._add_cloth(
            procedural_pattern(pattern, warp_kd, weft_kd, ks), repeat_u,
            repeat_v, kd_mult, ks_mult)

    def irawan_file(self, path: str, props: dict | None = None,
                    repeat_u: float = 10.0, repeat_v: float = 10.0,
                    kd_mult: float = 1.0, ks_mult: float = 1.0):
        """Woven cloth from a weave-pattern file (irawan.cpp:64, the
        grammar of io/weave.py); `props` resolve its $names, and its
        kdMultiplier and ksMultiplier win over kd_mult and ks_mult."""
        from mitsuba_tpu_torch.io.weave import load_weave

        props = props or {}
        return self._add_cloth(
            load_weave(path, props), repeat_u, repeat_v,
            float(props.get("kdMultiplier", kd_mult)),
            float(props.get("ksMultiplier", ks_mult)))

    def composite(self, children, weights):
        """N weighted lobes (reference composite.cpp, up to 4): children
        are material rows, none of them a composite; the weights sum to
        at most 1."""
        assert len(children) == len(weights) <= MAX_COMPOSITE_LOBES
        for c in children:
            assert self.rows[c]["kind"] != COMPOSITE, "no nested composites"
        pad = MAX_COMPOSITE_LOBES - len(children)
        return self._add(kind=COMPOSITE,
                         child_ids=list(children) + [-1] * pad,
                         child_weights=list(weights) + [0.0] * pad)

    def hanrahan_krueger(self, sigma_a=(0.032, 0.17, 0.48),
                         sigma_s=(0.74, 0.88, 1.01), g=0.0,
                         eta_int=1.32, eta_ext=1.0, ss_factor=(1.0,) * 3,
                         dr_factor=(1.0,) * 3, use_diffuse=True):
        """The Hanrahan-Krueger thin slab: single scattering plus the
        delta-Eddington diffuse term, its constants in float64 on the
        host (reference hanrahan-krueger.cpp configure()): reflectance <-
        the single-scattering albedo times ssFactor, transmittance <- the
        diffuse reflectance, eta <- etaInt / etaExt, alpha_u <- g."""
        sa = np.asarray(sigma_a, np.float64)
        ss = np.asarray(sigma_s, np.float64)
        st = np.maximum(sa + ss, 1e-9)
        ss_albedo = ss / st
        ss_red = ss * (1 - g)
        red_albedo = ss_red / np.maximum(sa + ss_red, 1e-9)
        eta = eta_int / eta_ext
        if eta == 1.0:
            fdr, fdt = 0.0, 1.0
        else:
            fdr = -1.440 / eta ** 2 + 0.710 / eta + 0.668 + 0.0636 * eta
            fdt = 1.0 - fdr
        a_bc = (1 + fdr) / fdt
        var1 = -np.sqrt(3.0 * (1 - red_albedo))
        dr = (red_albedo / 2.0) * (1 + np.exp((4.0 / 3.0) * a_bc * var1)) \
            * np.exp(var1)
        dr = dr * np.asarray(dr_factor, np.float64)
        if not use_diffuse:
            dr = dr * 0.0
        return self._add(
            kind=HANRAHAN_KRUEGER,
            reflectance=tuple(ss_albedo * np.asarray(ss_factor, np.float64)),
            transmittance=tuple(dr), eta=eta, alpha_u=g)

    def build(self) -> MaterialTable:
        from mitsuba_tpu_torch.bsdfs.irawan import pack_patterns

        if not self.rows:
            self.lambertian()
        # spectral rendering: the colour fields widen to the widest row's
        # channel count C; 3-wide uniform greys broadcast, anything else
        # must be given at full width (mitsuba_tpu/bsdfs/table.py:336-358)
        c = max(len(np.atleast_1d(r[k])) for r in self.rows
                for k in _COLOR_FIELDS)

        def widen(v):
            v = np.asarray(v, np.float32).reshape(-1)
            if v.shape[0] == c:
                return v
            if np.all(v == v[0]):
                return np.full(c, v[0], np.float32)
            raise ValueError(
                f"color field of width {v.shape[0]} cannot widen to the "
                f"scene's {c} spectral channels unless it is uniform")

        if c != 3:
            if any(r["kind"] == ROUGH_CONDUCTOR for r in self.rows):
                # the reference keeps cond_eta / cond_k 3-wide and fails
                # at render on such a scene; the port refuses it here
                raise ValueError(
                    f"a rough conductor's cond_eta and cond_k stay 3-wide: "
                    f"a scene of {c} spectral channels cannot hold one "
                    "(ROADMAP C)")
            for r in self.rows:
                for k in _COLOR_FIELDS:
                    r[k] = widen(r[k])

        def col(key, dtype):
            return torch.as_tensor(
                np.array([r[key] for r in self.rows], dtype))

        return MaterialTable(
            kind=col("kind", np.int32),
            reflectance=col("reflectance", np.float32),
            two_sided=col("two_sided", bool),
            specular=col("specular", np.float32),
            exponent=col("exponent", np.float32),
            tex_id=col("tex_id", np.int32),
            transmittance=col("transmittance", np.float32),
            eta=col("eta", np.float32),
            cond_eta=col("cond_eta", np.float32),
            cond_k=col("cond_k", np.float32),
            alpha_u=col("alpha_u", np.float32),
            alpha_v=col("alpha_v", np.float32),
            dist_type=col("dist_type", np.int32),
            opacity=col("opacity", np.float32),
            child_ids=col("child_ids", np.int32),
            child_weights=col("child_weights", np.float32),
            cloth_slot=col("cloth_slot", np.int32),
            cloth=pack_patterns(self.cloth_specs),
            has_mask=min(r["opacity"] for r in self.rows) < 0.999,
            # a composite row dispatches through its children's pairs
            kinds_present=tuple(sorted(
                {(int(r["kind"]), int(r["dist_type"])) for r in self.rows
                 if r["kind"] != COMPOSITE})),
            has_composite=any(r["kind"] == COMPOSITE for r in self.rows),
        )
