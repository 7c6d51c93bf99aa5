"""Textures (port of the checkerboard of mitsuba_tpu/render/texture.py;
reference src/textures/checkerboard.cpp).

A `TextureTable` holds one row per texture; materials point at a row
through `tex_id`. Only the checkerboard kind is ported: a table holding
any other kind is refused where it is built (`check_kinds`).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

CHECKERBOARD = 1                    # the reference's kind number
KIND_NAMES = {CHECKERBOARD: "checkerboard"}


def check_kinds(kinds):
    """Raise for any texture kind the port does not implement yet."""
    missing = sorted(set(int(k) for k in kinds) - set(KIND_NAMES))
    if missing:
        raise NotImplementedError(
            f"texture kinds {missing} are not ported (only checkerboard)")


@dataclass
class TextureTable:
    kind: torch.Tensor         # (K,) int32
    color0: torch.Tensor       # (K, 3) bright color
    color1: torch.Tensor       # (K, 3) dark color
    uv_scale: torch.Tensor     # (K, 2)
    uv_offset: torch.Tensor    # (K, 2)

    @property
    def n_textures(self):
        return int(self.kind.shape[0])


def eval_texture(tex: TextureTable, tex_id, uv):
    """Per-lane texture value (N, 3) at uv (N, 2); tex_id < 0 reads row 0
    and the caller masks it."""
    if tex.n_textures == 0:
        return torch.zeros((uv.shape[0], 3), device=uv.device)
    ti = torch.clamp(tex_id, 0, tex.n_textures - 1).long()
    uv_t = uv * tex.uv_scale[ti] + tex.uv_offset[ti]
    ix = torch.floor(uv_t[..., 0] * 2.0).to(torch.int32)
    iy = torch.floor(uv_t[..., 1] * 2.0).to(torch.int32)
    even = (ix + iy) % 2 == 0
    return torch.where(even[..., None], tex.color0[ti], tex.color1[ti])


class TextureBuilder:
    """Host-side accumulation of texture rows."""

    def __init__(self):
        self.rows = []

    def checkerboard(self, bright=(0.4,) * 3, dark=(0.2,) * 3,
                     uv_scale=(1.0, 1.0), uv_offset=(0.0, 0.0)):
        self.rows.append(dict(kind=CHECKERBOARD, color0=bright,
                              color1=dark, uv_scale=uv_scale,
                              uv_offset=uv_offset))
        return len(self.rows) - 1

    def build(self) -> TextureTable:
        def col(key, width, dtype=np.float32):
            a = np.array([r[key] for r in self.rows], dtype)
            return torch.as_tensor(a.reshape((len(self.rows),) + width))

        return TextureTable(
            kind=col("kind", (), np.int32),
            color0=col("color0", (3,)),
            color1=col("color1", (3,)),
            uv_scale=col("uv_scale", (2,)),
            uv_offset=col("uv_offset", (2,)),
        )
