"""SoA material table (port of mitsuba_tpu/bsdfs/table.py, lambertian
rows only).

The reference gathers small tables with a one-hot matmul for the TPU's
matrix unit; here `gather` is a plain index gather, which is exact.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

LAMBERTIAN = 0      # src/bsdfs/lambertian.cpp
KIND_NAMES = {LAMBERTIAN: "lambertian"}


@dataclass
class MaterialTable:
    kind: torch.Tensor         # (M,) int32
    reflectance: torch.Tensor  # (M, C) diffuse albedo
    two_sided: torch.Tensor    # (M,) bool — twosided adapter applied
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
        }


def check_kinds(kinds):
    """Raise for any BSDF kind the port does not implement yet."""
    missing = sorted(set(int(k) for k in kinds) - set(KIND_NAMES))
    if missing:
        raise NotImplementedError(
            f"BSDF kinds {missing} are not ported (only lambertian)")


class MaterialBuilder:
    """Accumulates material rows host-side, emits a MaterialTable."""

    def __init__(self):
        self.rows = []

    def lambertian(self, reflectance=(0.5, 0.5, 0.5), two_sided=False):
        self.rows.append(dict(kind=LAMBERTIAN, reflectance=reflectance,
                              two_sided=two_sided))
        return len(self.rows) - 1

    def build(self) -> MaterialTable:
        if not self.rows:
            self.lambertian()
        return MaterialTable(
            kind=torch.as_tensor(
                np.array([r["kind"] for r in self.rows], np.int32)),
            reflectance=torch.as_tensor(
                np.array([r["reflectance"] for r in self.rows], np.float32)),
            two_sided=torch.as_tensor(
                np.array([r["two_sided"] for r in self.rows], bool)),
            kinds_present=tuple(sorted({r["kind"] for r in self.rows})),
        )
