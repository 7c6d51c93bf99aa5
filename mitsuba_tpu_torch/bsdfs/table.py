"""SoA material table (port of mitsuba_tpu/bsdfs/table.py: lambertian,
mirror, dielectric, rough-conductor and phong rows, and the opacity
column of the mask adapter that `null()` sets to 0).

The reference gathers small tables with a one-hot matmul for the TPU's
matrix unit; here `gather` is a plain index gather, which is exact.
"""
from __future__ import annotations

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
KIND_NAMES = {LAMBERTIAN: "lambertian", MIRROR: "mirror",
              DIELECTRIC: "dielectric", ROUGH_CONDUCTOR: "roughconductor",
              PHONG: "phong"}
# the columns a kind reads beyond those every lane gathers, so that a
# scene gathers only what its kinds need
_KIND_FIELDS = {DIELECTRIC: ("transmittance", "eta"),
                ROUGH_CONDUCTOR: ("alpha_u", "cond_eta", "cond_k",
                                  "dist_type")}


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
    # the (kind, distribution) pairs present: the distribution is a static
    # choice, so each pair is dispatched on its own (as in the reference)
    kinds_present: tuple = ((LAMBERTIAN, mf.BECKMANN),)
    # a row with opacity < 0.999, decided on the host when the table is
    # built (dispatch.py:168 _np_min_opacity), never by a device sync
    has_mask: bool = False

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
        return {name: getattr(self, name)[i] for name in dict.fromkeys(names)}


def check_kinds(kinds):
    """Raise for any BSDF kind the port does not implement yet."""
    missing = sorted(set(int(k) for k in kinds) - set(KIND_NAMES))
    if missing:
        raise NotImplementedError(
            f"BSDF kinds {missing} are not ported (only "
            f"{', '.join(KIND_NAMES.values())})")


class MaterialBuilder:
    """Accumulates material rows host-side, emits a MaterialTable."""

    def __init__(self):
        self.rows = []

    def _add(self, **kw):
        row = dict(kind=LAMBERTIAN, reflectance=(0.5, 0.5, 0.5),
                   specular=(1.0, 1.0, 1.0), transmittance=(1.0, 1.0, 1.0),
                   eta=1.5, cond_eta=(0.2, 0.9, 1.4), cond_k=(3.9, 2.5, 2.1),
                   alpha_u=0.1, alpha_v=0.1, exponent=30.0,
                   dist_type=mf.BECKMANN, tex_id=-1, two_sided=False,
                   opacity=1.0)
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

    def build(self) -> MaterialTable:
        if not self.rows:
            self.lambertian()

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
            has_mask=min(r["opacity"] for r in self.rows) < 0.999,
            kinds_present=tuple(sorted(
                {(int(r["kind"]), int(r["dist_type"])) for r in self.rows})),
        )
