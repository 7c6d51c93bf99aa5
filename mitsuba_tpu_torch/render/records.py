"""Batched SoA records flowing through the wavefront renderer (port of
mitsuba_tpu/render/records.py).

Every field is a tensor with a leading wavefront axis N.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from mitsuba_tpu_torch.core import math as m


@dataclass
class Ray:
    o: torch.Tensor       # (N, 3)
    d: torch.Tensor       # (N, 3) normalized
    mint: torch.Tensor    # (N,)
    maxt: torch.Tensor    # (N,)

    @staticmethod
    def make(o, d, mint=None, maxt=None):
        n = o.shape[:-1]
        if mint is None:
            mint = m.EPSILON
        if maxt is None:
            maxt = float("inf")
        mint = torch.as_tensor(mint, dtype=o.dtype, device=o.device)
        maxt = torch.as_tensor(maxt, dtype=o.dtype, device=o.device)
        return Ray(o=o, d=d, mint=mint.expand(n), maxt=maxt.expand(n))

    def at(self, t):
        return self.o + self.d * t[..., None]


@dataclass
class Intersection:
    valid: torch.Tensor      # (N,) bool — hit anything?
    t: torch.Tensor          # (N,) ray distance
    p: torch.Tensor          # (N, 3) hit position
    geo_n: torch.Tensor      # (N, 3) geometric normal
    sh_n: torch.Tensor       # (N, 3) shading normal
    uv: torch.Tensor         # (N, 2)
    dp_du: torch.Tensor      # (N, 3) tangent (the frame's s axis)
    wi: torch.Tensor         # (N, 3) incident dir in the local shading frame
    prim_id: torch.Tensor    # (N,) triangle index, -1 = none
    shape_id: torch.Tensor   # (N,)
    material_id: torch.Tensor  # (N,)
    emitter_id: torch.Tensor   # (N,) -1 if not emissive

    def frame(self) -> m.Frame:
        """Shading frame with s following dp_du — the frame the intersector
        used for wi (from_normal_tangent reproduces from_normal when dp_du
        is already that frame's s axis, as on the fused-kernel path)."""
        return m.Frame.from_normal_tangent(self.sh_n, self.dp_du)

    def to_world(self, v_local):
        return self.frame().to_world(v_local)

    def to_local(self, v_world):
        return self.frame().to_local(v_world)


@dataclass
class DirectSample:
    """A sample toward an emitter (NEE)."""
    d: torch.Tensor          # (N, 3) unit direction toward the emitter
    dist: torch.Tensor       # (N,) distance to the emitter sample
    n: torch.Tensor          # (N, 3) emitter-side normal
    value: torch.Tensor      # (N, C) emitted radiance (not divided by pdf)
    pdf: torch.Tensor        # (N,) solid-angle pdf at the reference point
    emitter_id: torch.Tensor  # (N,)
    delta: torch.Tensor      # (N,) bool — delta emitter
    valid: torch.Tensor      # (N,) bool
