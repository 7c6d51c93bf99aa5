"""SoA material table (port of mitsuba_tpu/bsdfs/table.py, lambertian and
phong rows).

The reference gathers small tables with a one-hot matmul for the TPU's
matrix unit; here `gather` is a plain index gather, which is exact.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

LAMBERTIAN = 0      # src/bsdfs/lambertian.cpp
PHONG = 4           # src/bsdfs/phong.cpp (the reference's kind number)
KIND_NAMES = {LAMBERTIAN: "lambertian", PHONG: "phong"}


@dataclass
class MaterialTable:
    kind: torch.Tensor         # (M,) int32
    reflectance: torch.Tensor  # (M, C) diffuse albedo
    two_sided: torch.Tensor    # (M,) bool — twosided adapter applied
    specular: torch.Tensor     # (M, C) phong specular reflectance
    exponent: torch.Tensor     # (M,) phong exponent
    tex_id: torch.Tensor       # (M,) reflectance texture, -1 = none
    kinds_present: tuple = (LAMBERTIAN,)

    @property
    def n_materials(self):
        return self.kind.shape[0]

    def gather(self, material_id):
        """Per-lane parameter rows (clamped; id < 0 reads row 0 and callers
        mask)."""
        i = torch.clamp(material_id, 0, self.n_materials - 1).long()
        return {
            "kind": self.kind[i],
            "reflectance": self.reflectance[i],
            "two_sided": self.two_sided[i],
            "specular": self.specular[i],
            "exponent": self.exponent[i],
        }


def check_kinds(kinds):
    """Raise for any BSDF kind the port does not implement yet."""
    missing = sorted(set(int(k) for k in kinds) - set(KIND_NAMES))
    if missing:
        raise NotImplementedError(
            f"BSDF kinds {missing} are not ported (only lambertian, phong)")


class MaterialBuilder:
    """Accumulates material rows host-side, emits a MaterialTable."""

    def __init__(self):
        self.rows = []

    def _add(self, **kw):
        row = dict(kind=LAMBERTIAN, reflectance=(0.5, 0.5, 0.5),
                   specular=(1.0, 1.0, 1.0), exponent=30.0, tex_id=-1,
                   two_sided=False)
        row.update(kw)
        self.rows.append(row)
        return len(self.rows) - 1

    def lambertian(self, reflectance=(0.5, 0.5, 0.5), two_sided=False,
                   tex_id=-1):
        return self._add(kind=LAMBERTIAN, reflectance=reflectance,
                         two_sided=two_sided, tex_id=tex_id)

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
            kinds_present=tuple(sorted({r["kind"] for r in self.rows})),
        )
