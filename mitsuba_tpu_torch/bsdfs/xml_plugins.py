"""XML bsdf and texture nodes -> MaterialBuilder and TextureBuilder rows
(port of mitsuba_tpu/bsdfs/xml_plugins.py for the kinds the port has).

Property names match the reference plugin constructors (e.g.
src/bsdfs/roughmetal.cpp:38-41: alphaB, ior, k). Ported: lambertian /
diffuse, mirror, dielectric, roughconductor / roughmetal, phong and the
twosided adapter over any of them; the checkerboard texture. Every other
kind raises NotImplementedError naming the plugin (ROADMAP A.11).
"""
from __future__ import annotations

from mitsuba_tpu_torch.core import microfacet as mf

# the reference's distributions; its phong distribution is not ported
_DIST = {"beckmann": mf.BECKMANN, "ggx": mf.GGX}


def _spec(props, name, default):
    v = props.get(name, default)
    if isinstance(v, (int, float)):
        return (float(v),) * 3
    return tuple(v)


def _unported(what, name):
    raise NotImplementedError(
        f"the {what} '{name}' is not ported (ROADMAP A.11)")


def _dist(p):
    name = p.get("distribution", "beckmann")
    if name == "phong":
        _unported("microfacet distribution", name)
    return _DIST.get(name, mf.BECKMANN)


def build_material(mb, bsdf_node, two_sided: bool = False, tb=None,
                   base_dir="."):
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
    if t == "twosided":
        inner = _first_bsdf_child(bsdf_node)
        return build_material(mb, inner, two_sided=True, tb=tb,
                              base_dir=base_dir)
    _unported("BSDF", t)


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
    _unported("texture", t)
