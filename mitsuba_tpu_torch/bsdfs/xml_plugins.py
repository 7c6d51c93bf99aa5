"""XML bsdf and texture nodes -> MaterialBuilder and TextureBuilder rows
(port of mitsuba_tpu/bsdfs/xml_plugins.py).

Property names match the reference plugin constructors (e.g.
src/bsdfs/roughglass.cpp:96-118: specularReflectance,
specularTransmittance, alphaB / alpha, intIOR / extIOR, distribution;
src/bsdfs/roughmetal.cpp:38-41: alphaB, ior, k). Ported: lambertian /
diffuse, mirror, dielectric, roughglass / roughdielectric, roughconductor /
roughmetal, phong, ward, microfacet, difftrans, wiscombe / dozier, hk /
hanrahan-krueger, the woven cloth irawan (a weave-pattern `filename`,
else the procedural `pattern`, plain or twill), composite, and the
twosided and mask adapters over any of them; the checkerboard,
gridtexture, ldrtexture, exrtexture, bitmap, diffusiontexture and
vertexcolors textures (an image read by io/bitmap.py).
"""
from __future__ import annotations

import os

from mitsuba_tpu_torch.core import microfacet as mf

_DIST = {"beckmann": mf.BECKMANN, "ggx": mf.GGX, "phong": mf.PHONG}


def _spec(props, name, default):
    v = props.get(name, default)
    if isinstance(v, (int, float)):
        return (float(v),) * 3
    return tuple(v)


def _dist(p):
    return _DIST.get(p.get("distribution", "beckmann"), mf.BECKMANN)


def build_material(mb, bsdf_node, two_sided: bool = False, opacity=None,
                   tb=None, base_dir="."):
    """mb: MaterialBuilder; bsdf_node: parsed dict from io/xml.py;
    tb: TextureBuilder for nested <texture> children. Returns the
    material id."""
    t = bsdf_node["type"]
    p = bsdf_node["props"]
    tex_id = -1
    if tb is not None:
        for c in bsdf_node["children"]:
            if c["category"] == "texture" and (c.get("name") in (
                    "reflectance", "diffuseReflectance", None)):
                tex_id = build_texture(tb, c, base_dir)

    def finish(mid):
        if two_sided:
            mb.rows[mid]["two_sided"] = True
        if opacity is not None:
            mb.rows[mid]["opacity"] = float(opacity[0]) \
                if isinstance(opacity, tuple) else float(opacity)
        if tex_id >= 0:
            mb.rows[mid]["tex_id"] = tex_id
        return mid

    if t in ("lambertian", "diffuse"):
        return finish(mb.lambertian(_spec(p, "reflectance", 0.5)))
    if t == "mirror":
        return finish(mb.mirror(_spec(p, "specularReflectance", 1.0)))
    if t == "dielectric":
        return finish(
            mb.dielectric(
                int_ior=float(p.get("intIOR", 1.5046)),
                ext_ior=float(p.get("extIOR", 1.0)),
                specular=_spec(p, "specularReflectance", 1.0),
                transmittance=_spec(p, "specularTransmittance", 1.0),
            )
        )
    if t in ("roughglass", "roughdielectric"):
        return finish(
            mb.rough_glass(
                alpha=float(p.get("alphaB", p.get("alpha", 0.1))),
                int_ior=float(p.get("intIOR", 1.5046)),
                ext_ior=float(p.get("extIOR", 1.0)),
                specular=_spec(p, "specularReflectance", 1.0),
                transmittance=_spec(p, "specularTransmittance", 1.0),
                dist=_dist(p),
            )
        )
    if t in ("roughmetal", "roughconductor"):
        return finish(
            mb.rough_conductor(
                alpha=float(p.get("alphaB", p.get("alpha", 0.1))),
                cond_eta=_spec(p, "ior", 0.370),
                cond_k=_spec(p, "k", 2.820),
                specular=_spec(p, "specularReflectance", 1.0),
                dist=_dist(p),
            )
        )
    if t == "phong":
        return finish(
            mb.phong(
                diffuse=_spec(p, "diffuseReflectance", 0.5),
                specular=_spec(p, "specularReflectance", 0.2),
                exponent=float(p.get("exponent", 10.0)),
            )
        )
    if t == "ward":
        return finish(
            mb.ward(
                diffuse=_spec(p, "diffuseReflectance", 0.5),
                specular=_spec(p, "specularReflectance", 0.2),
                alpha_u=float(p.get("alphaX", 0.1)),
                alpha_v=float(p.get("alphaY", 0.1)),
            )
        )
    if t == "microfacet":
        # reference microfacet.cpp: a diffuse and a Beckmann specular
        # lobe, here one phong row with the Beckmann-matched exponent
        # (Walter's mapping 2 / a^2 - 2), as the reference package does
        alpha = float(p.get("alphaB", 0.1))
        return finish(
            mb.phong(
                diffuse=_spec(p, "diffuseReflectance", 0.0),
                specular=_spec(p, "specularReflectance", 1.0),
                exponent=max(2.0 / (alpha * alpha) - 2.0, 1.0),
            )
        )
    if t == "difftrans":
        return finish(mb.diff_trans(_spec(p, "transmittance", 0.5)))
    if t in ("wiscombe", "dozier"):
        return finish(
            mb.wiscombe(
                g=float(p.get("g", 0.874)),
                # the reference's own property name is misspelt
                # "singleScatteringAlbodo" (wiscombe.cpp:53): both work
                w0=_spec(p, "singleScatteringAlbedo",
                         p.get("singleScatteringAlbodo", 0.99)),
                sigma_t=_spec(p, "sigmaT", (16.4967, 6.0957, 4.6547)),
                depth=float(p.get("depth", 1.0)),
            )
        )
    if t in ("hk", "hanrahan-krueger"):
        mult = float(p.get("densityMultiplier",
                           p.get("sizeMultiplier", 1.0)))
        sa = tuple(x * mult for x in _spec(p, "sigmaA", (0.032, 0.17, 0.48)))
        ss = tuple(x * mult for x in _spec(p, "sigmaS", (0.74, 0.88, 1.01)))
        return finish(
            mb.hanrahan_krueger(
                sigma_a=sa, sigma_s=ss, g=float(p.get("g", 0.0)),
                eta_int=float(p.get("etaInt", 1.32)),
                eta_ext=float(p.get("etaExt", 1.0)),
                ss_factor=_spec(p, "ssFactor", 1.0),
                dr_factor=_spec(p, "drFactor", 1.0),
                use_diffuse=bool(p.get("diffuseReflectance", True)),
            )
        )
    if t == "irawan":
        # reference irawan.cpp: a weave-pattern file, repeatU / repeatV and
        # kd / ksMultiplier, the file's $names from the plugin's props;
        # without a file the procedural weave (xml_plugins.py:136-160)
        if "filename" in p:
            from mitsuba_tpu_torch.io.xml_shapes import _resolve

            return finish(mb.irawan_file(
                _resolve(base_dir, p["filename"]), props=p,
                repeat_u=float(p.get("repeatU", 10.0)),
                repeat_v=float(p.get("repeatV", 10.0))))
        return finish(mb.irawan(
            warp_kd=_spec(p, "warpKd", (0.3, 0.27, 0.25)),
            weft_kd=_spec(p, "weftKd", (0.6, 0.1, 0.1)),
            ks=_spec(p, "ks", (0.2, 0.2, 0.2)),
            repeat_u=float(p.get("repeatU", 10.0)),
            repeat_v=float(p.get("repeatV", 10.0)),
            pattern=p.get("pattern", "plain"),
            kd_mult=float(p.get("kdMultiplier", 1.0)),
            ks_mult=float(p.get("ksMultiplier", 1.0))))
    if t == "composite":
        # reference composite.cpp: the string "weights", comma-separated,
        # and the nested bsdfs in order
        wstr = str(p.get("weights", "")).replace(";", ",")
        weights = [float(x) for x in wstr.split(",") if x.strip()]
        children = [c for c in bsdf_node["children"]
                    if c["category"] == "bsdf"]
        if len(weights) != len(children):
            raise ValueError(f"composite: {len(children)} children but "
                             f"{len(weights)} weights")
        cids = [build_material(mb, c, tb=tb, base_dir=base_dir)
                for c in children]
        return finish(mb.composite(cids, weights))
    if t == "twosided":
        inner = _first_bsdf_child(bsdf_node)
        return build_material(mb, inner, two_sided=True, opacity=opacity,
                              tb=tb, base_dir=base_dir)
    if t == "mask":
        inner = _first_bsdf_child(bsdf_node)
        return build_material(mb, inner, two_sided=two_sided,
                              opacity=p.get("opacity", (1.0, 1.0, 1.0)),
                              tb=tb, base_dir=base_dir)
    raise ValueError(f"unsupported bsdf type '{t}'")


def _first_bsdf_child(node):
    for c in node["children"]:
        if c["category"] == "bsdf":
            return c
    raise ValueError(f"<bsdf type='{node['type']}'> needs a nested bsdf")


def build_texture(tb, tex_node, base_dir="."):
    """Map a parsed <texture> node to a TextureBuilder row (reference
    src/textures/ property names)."""
    t = tex_node["type"]
    p = tex_node["props"]
    uv_scale = (float(p.get("uscale", 1.0)), float(p.get("vscale", 1.0)))
    uv_offset = (float(p.get("uoffset", 0.0)), float(p.get("voffset", 0.0)))
    if t == "checkerboard":
        return tb.checkerboard(
            bright=_spec(p, "brightColor", 0.4),
            dark=_spec(p, "darkColor", 0.2),
            uv_scale=uv_scale, uv_offset=uv_offset,
        )
    if t == "gridtexture":
        return tb.grid(
            bright=_spec(p, "brightColor", 0.4),
            dark=_spec(p, "darkColor", 0.2),
            line_width=float(p.get("lineWidth", 0.01)),
            uv_scale=uv_scale, uv_offset=uv_offset,
        )
    if t in ("ldrtexture", "exrtexture", "bitmap", "diffusiontexture"):
        # diffusiontexture (src/textures/diffusiontexture.cpp): a linear
        # bitmap whose filtering is the renderer-wide PathConfig switches
        from mitsuba_tpu_torch.io.bitmap import read_image_cached

        img = read_image_cached(os.path.join(base_dir, p["filename"]))
        gamma = float(p.get("gamma", -1.0)) if t == "ldrtexture" else 1.0
        return tb.bitmap(img, gamma=gamma, wrap=p.get("wrapMode", "repeat"),
                         uv_scale=uv_scale, uv_offset=uv_offset)
    if t == "vertexcolors":
        return tb.vertex_colors()
    raise ValueError(f"unsupported texture type '{t}'")
