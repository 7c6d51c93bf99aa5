"""Textures: constant, checkerboard, grid, bitmap and vertex colours (port
of mitsuba_tpu/render/texture.py; reference src/textures/ checkerboard.cpp,
gridtexture.cpp, ldrtexture.cpp, exrtexture.cpp).

A `TextureTable` holds one row per texture; materials point at a row
through `tex_id`. A bitmap row points at an image slot: each image is a
tensor of its own size, which may require grad (the texel gradient), and
with `TextureBuilder(build_mips=True)` each has a MIP pyramid
(render/mipmap.py), built on the host. uv is scaled and offset as
uv * scale + offset; a bitmap's v axis is flipped (image row 0 is v = 1).
Lookups evaluate every kind present for all lanes and select by kind, as
the reference does; a bitmap lookup is bilinear, trilinear from a uv
footprint (duv_dx, duv_dy) when the table has mips, or anisotropic (8
trilinear taps along the footprint's major axis) with `aniso`.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from mitsuba_tpu_torch.core.spectrum import from_srgb
from mitsuba_tpu_torch.render import mipmap

CONSTANT, CHECKERBOARD, GRID, BITMAP, VERTEXCOLORS = range(5)


@dataclass
class TextureTable:
    kind: torch.Tensor         # (K,) int32
    color0: torch.Tensor       # (K, 3) bright / constant colour, bitmap tint
    color1: torch.Tensor       # (K, 3) dark colour
    line_width: torch.Tensor   # (K,) grid line width
    uv_scale: torch.Tensor     # (K, 2)
    uv_offset: torch.Tensor    # (K, 2)
    image_slot: torch.Tensor   # (K,) index into images, -1 = none
    wrap_clamp: torch.Tensor   # (K,) bool: clamp instead of repeat
    images: tuple = ()         # (H, W, 3) float32 tensors
    mips: tuple = ()           # MIPMap per image, () without mips
    kinds_present: tuple = ()
    wraps_present: tuple = field(default=())   # bools of wrap_clamp

    @property
    def n_textures(self):
        return int(self.kind.shape[0])

    def to(self, device) -> "TextureTable":
        fields = {k: getattr(self, k).to(device) for k in (
            "kind", "color0", "color1", "line_width", "uv_scale",
            "uv_offset", "image_slot", "wrap_clamp")}
        return TextureTable(
            **fields, images=tuple(x.to(device) for x in self.images),
            mips=tuple(mp.to(device) for mp in self.mips),
            kinds_present=self.kinds_present,
            wraps_present=self.wraps_present)


def eval_texture(tex: TextureTable, tex_id, uv, vertex_color=None,
                 duv_dx=None, duv_dy=None, aniso: bool = False):
    """Per-lane texture value (N, 3) at uv (N, 2) (texture.py:81);
    tex_id < 0 reads row 0 and the caller masks it. vertex_color: the
    lanes' interpolated vertex colours, or None for `color0`. duv_dx,
    duv_dy: the lanes' uv footprint; with mips a bitmap is then trilinear,
    or anisotropic with `aniso`."""
    n = uv.shape[0]
    out = torch.zeros((n, 3), device=uv.device)
    if tex.n_textures == 0:
        return out
    ti = torch.clamp(tex_id, 0, tex.n_textures - 1).long()
    kind = tex.kind[ti]
    uv_t = uv * tex.uv_scale[ti] + tex.uv_offset[ti]
    c0 = tex.color0[ti]
    c1 = tex.color1[ti]
    for k in tex.kinds_present:
        if k == CONSTANT:
            val = c0
        elif k == CHECKERBOARD:
            ix = torch.floor(uv_t[..., 0] * 2.0).to(torch.int32)
            iy = torch.floor(uv_t[..., 1] * 2.0).to(torch.int32)
            even = (ix + iy) % 2 == 0
            val = torch.where(even[..., None], c0, c1)
        elif k == GRID:
            lw = tex.line_width[ti]
            fx = uv_t[..., 0] - torch.floor(uv_t[..., 0]) - 0.5
            fy = uv_t[..., 1] - torch.floor(uv_t[..., 1]) - 0.5
            on_line = (torch.abs(fx) < lw) | (torch.abs(fy) < lw)
            val = torch.where(on_line[..., None], c1, c0)
        elif k == VERTEXCOLORS:
            val = vertex_color if vertex_color is not None else c0
        elif k == BITMAP:
            val = _eval_bitmaps(tex, ti, uv_t, c0, duv_dx, duv_dy, aniso)
        else:
            continue
        out = torch.where((kind == k)[..., None], val, out)
    return out


def _eval_bitmaps(tex, ti, uv_t, c0, duv_dx, duv_dy, aniso):
    """Each image for all lanes, selected by slot; a wrap mode no row uses
    is not evaluated (its lanes would be discarded by the select)."""
    use_mip = (duv_dx is not None and duv_dy is not None
               and len(tex.mips) == len(tex.images) > 0)
    slot = tex.image_slot[ti]
    clamp = tex.wrap_clamp[ti][..., None]
    val = torch.zeros_like(c0)
    for si, img in enumerate(tex.images):
        if use_mip:
            mip = tex.mips[si]
            sc = tex.uv_scale[ti]
            if aniso:
                def look(cw):
                    return mipmap.eval_aniso(mip, uv_t, duv_dx * sc,
                                             duv_dy * sc, clamp_wrap=cw)
            else:
                lod = mipmap.lod_from_duv(mip, duv_dx * sc, duv_dy * sc)

                def look(cw):
                    return mipmap.eval_trilinear(mip, uv_t, lod,
                                                 clamp_wrap=cw)
        else:
            def look(cw):
                return mipmap.bilinear(img, uv_t, cw)
        if tex.wraps_present == (True,):
            bi = look(True)
        elif tex.wraps_present == (False,):
            bi = look(False)
        else:
            bi = torch.where(clamp, look(True), look(False))
        val = torch.where((slot == si)[..., None], bi * c0, val)
    return val


class TextureBuilder:
    """Host-side accumulation of texture rows and bitmap images."""

    def __init__(self, build_mips: bool = False):
        self.rows = []
        self.images = []
        self.mips = []
        self.build_mips = build_mips

    def _add(self, **kw):
        d = dict(kind=CONSTANT, color0=(1.0, 1.0, 1.0),
                 color1=(0.0, 0.0, 0.0), line_width=0.01,
                 uv_scale=(1.0, 1.0), uv_offset=(0.0, 0.0), image_slot=-1,
                 wrap_clamp=False)
        d.update(kw)
        self.rows.append(d)
        return len(self.rows) - 1

    def constant(self, color):
        return self._add(kind=CONSTANT, color0=color)

    def checkerboard(self, bright=(0.4,) * 3, dark=(0.2,) * 3,
                     uv_scale=(1.0, 1.0), uv_offset=(0.0, 0.0)):
        return self._add(kind=CHECKERBOARD, color0=bright, color1=dark,
                         uv_scale=uv_scale, uv_offset=uv_offset)

    def grid(self, bright=(0.4,) * 3, dark=(0.2,) * 3, line_width=0.01,
             uv_scale=(1.0, 1.0), uv_offset=(0.0, 0.0)):
        return self._add(kind=GRID, color0=bright, color1=dark,
                         line_width=line_width, uv_scale=uv_scale,
                         uv_offset=uv_offset)

    def vertex_colors(self):
        return self._add(kind=VERTEXCOLORS)

    def bitmap(self, image, gamma: float = -1.0, tint=(1.0, 1.0, 1.0),
               wrap: str = "repeat", uv_scale=(1.0, 1.0),
               uv_offset=(0.0, 0.0)):
        """image: (H, W, C) uint8, uint16 or float. gamma -1 decodes sRGB
        (reference ldrtexture.cpp:41); 0 and 1 keep the values."""
        img = np.asarray(image)
        if img.ndim == 2:
            img = img[:, :, None]
        if img.shape[2] == 1:
            img = np.repeat(img, 3, 2)
        img = img[:, :, :3]
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        elif img.dtype == np.uint16:
            img = img.astype(np.float32) / 65535.0
        else:
            img = img.astype(np.float32)
        if gamma == -1.0:
            img = from_srgb(img)
        elif gamma not in (0.0, 1.0):
            img = np.power(np.maximum(img, 0.0), gamma)
        slot = len(self.images)
        self.images.append(np.asarray(img, np.float32))
        if self.build_mips:
            self.mips.append(mipmap.build_mipmap(img))
        return self._add(kind=BITMAP, color0=tint, image_slot=slot,
                         wrap_clamp=(wrap == "clamp"), uv_scale=uv_scale,
                         uv_offset=uv_offset)

    def build(self) -> TextureTable:
        k = len(self.rows)

        def col(key, width, dtype=np.float32):
            a = np.array([r[key] for r in self.rows], dtype)
            return torch.as_tensor(a.reshape((k,) + width))

        return TextureTable(
            kind=col("kind", (), np.int32),
            color0=col("color0", (3,)),
            color1=col("color1", (3,)),
            line_width=col("line_width", ()),
            uv_scale=col("uv_scale", (2,)),
            uv_offset=col("uv_offset", (2,)),
            image_slot=col("image_slot", (), np.int32),
            wrap_clamp=col("wrap_clamp", (), bool),
            images=tuple(torch.as_tensor(x) for x in self.images),
            mips=tuple(self.mips) if self.build_mips else (),
            kinds_present=tuple(sorted({int(r["kind"]) for r in self.rows})),
            wraps_present=wraps_present(
                [r["wrap_clamp"] for r in self.rows
                 if r["kind"] == BITMAP]),
        )


def wraps_present(clamps) -> tuple:
    """The sorted distinct wrap modes (True = clamp) of the bitmap rows."""
    return tuple(sorted({bool(c) for c in clamps}))
