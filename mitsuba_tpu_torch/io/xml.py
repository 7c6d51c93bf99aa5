"""Mitsuba-compatible XML scene loader (port of mitsuba_tpu/io/xml.py).

Same tag set and semantics as the reference SceneHandler
(src/librender/scenehandler.cpp:100-460): nested property tags
(integer/float/boolean/string/point/vector/rgb/srgb/spectrum/blackbody),
<transform> blocks composed left to right (translate/rotate/scale/lookAt/
matrix, each NEW * CURRENT), $var substitution from parameter maps,
<ref id=...> to named objects, <include>. Builds the port's Scene through
the plugin registry and SceneBuilder, on the card unless the caller
passes device="cpu". Materials, emitters and shapes are added in the
reference's order, so a file gives the same tables in both packages.

A scene-level <medium> (homogeneous, or heterogeneous from a
`gridvolume` density and an optional orientation volume, with an hg,
isotropic, kkay or microflake phase, a `stddev` making it the Gaussian
flake) is carried in the config as a MediumTable; a shape's interior
<medium> joins the scene's MediumStack (io/xml_shapes.py).

Not ported, each raising NotImplementedError: what the shape, BSDF,
texture, luminaire and camera plugins refuse (io/xml_shapes.py,
bsdfs/xml_plugins.py, render/camera.py).
"""
from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np
import torch

import mitsuba_tpu_torch.render.camera  # noqa: F401  (camera plugins)
from mitsuba_tpu_torch.core import transform as tf
from mitsuba_tpu_torch.core.math import coordinate_system
from mitsuba_tpu_torch.core.spectrum import blackbody, from_srgb
from mitsuba_tpu_torch.render.scene import SceneBuilder

_PROP_TAGS = {"integer", "float", "boolean", "string", "point", "vector",
              "rgb", "srgb", "spectrum", "blackbody"}
_OBJECT_TAGS = {"scene", "shape", "sampler", "film", "integrator", "texture",
                "camera", "subsurface", "luminaire", "medium", "volume",
                "phase", "bsdf", "rfilter"}


class SceneParseError(ValueError):
    pass


def _substitute(value: str, params: dict) -> str:
    if "$" not in value:
        return value
    for k, v in params.items():
        value = value.replace("$" + k, str(v))
    if "$" in value:
        raise SceneParseError(f"undefined scene parameter in '{value}'")
    return value


def _parse_floats(s: str):
    return [float(x) for x in s.replace(",", " ").split()]


def _parse_color(node, srgb=False):
    val = node.get("value", "0")
    toks = val.replace(",", " ").split()
    if len(toks) == 1 and toks[0].startswith("#"):
        enc = int(toks[0][1:], 16)
        rgb = [((enc >> 16) & 0xFF) / 255.0, ((enc >> 8) & 0xFF) / 255.0,
               (enc & 0xFF) / 255.0]
    elif len(toks) == 1:
        rgb = [float(toks[0])] * 3
    elif len(toks) == 3:
        rgb = [float(t) for t in toks]
    else:
        raise SceneParseError(f"invalid color value '{val}'")
    if srgb:
        rgb = [float(from_srgb(np.float32(c))) for c in rgb]
    return tuple(rgb)


def _parse_spectrum(node):
    """<spectrum>: single value, 3 values, or wavelength:value pairs
    (flattened to RGB by their mean, as in the reference)."""
    val = node.get("value", "0")
    if ":" in val:
        pairs = [p.split(":") for p in val.replace(",", " ").split()]
        mean = float(np.mean([float(v) for _, v in pairs]))
        return (mean, mean, mean)
    toks = _parse_floats(val)
    if len(toks) == 1:
        return (toks[0],) * 3
    if len(toks) == 3:
        return tuple(toks)
    raise SceneParseError(f"invalid spectrum '{val}'")


def _parse_transform(node, params):
    m = tf.identity()
    for child in node:
        tag = child.tag
        g = lambda k, d=None: _substitute(  # noqa: E731
            child.get(k, d if d is not None else ""), params)
        if tag == "translate":
            m = tf.translate([float(g("x", "0") or 0), float(g("y", "0") or 0),
                              float(g("z", "0") or 0)]) @ m
        elif tag == "rotate":
            axis = [float(g("x", "0") or 0), float(g("y", "0") or 0),
                    float(g("z", "0") or 0)]
            m = tf.rotate(axis, float(g("angle"))) @ m
        elif tag == "scale":
            if child.get("value") is not None:
                s = float(g("value"))
                m = tf.scale([s, s, s]) @ m
            else:
                m = tf.scale([float(g("x", "1") or 1), float(g("y", "1") or 1),
                              float(g("z", "1") or 1)]) @ m
        elif tag in ("lookAt", "lookat"):
            o = [float(g("ox")), float(g("oy")), float(g("oz"))]
            t = [float(g("tx")), float(g("ty")), float(g("tz"))]
            upstr = [child.get("ux"), child.get("uy"), child.get("uz")]
            if any(u is None for u in upstr):
                d = np.asarray(t) - np.asarray(o)
                d = d / np.linalg.norm(d)
                s, _ = coordinate_system(torch.as_tensor(d, dtype=torch.float32))
                up = s.numpy()
            else:
                up = [float(_substitute(u, params)) for u in upstr]
            m = tf.look_at(o, t, up) @ m
        elif tag == "matrix":
            vals = _parse_floats(_substitute(child.get("value"), params))
            if len(vals) != 16:
                raise SceneParseError("matrix needs 16 entries")
            m = tf.matrix(vals) @ m
        else:
            raise SceneParseError(f"unknown transform tag <{tag}>")
    return m


def parse_node(node, params, named, base_dir):
    """Recursively parse an object node into
    {'category', 'type', 'id', 'name', 'props', 'children'}."""
    props = {}
    children = []
    for child in node:
        tag = child.tag
        name = _substitute(child.get("name", ""), params)
        if tag in _PROP_TAGS:
            raw = _substitute(child.get("value", ""), params)
            if tag == "integer":
                props[name] = int(raw)
            elif tag == "float":
                props[name] = float(raw)
            elif tag == "boolean":
                props[name] = raw.strip().lower() == "true"
            elif tag == "string":
                props[name] = raw
            elif tag in ("point", "vector"):
                props[name] = tuple(
                    float(_substitute(child.get(k, "0"), params)) for k in "xyz"
                )
            elif tag == "rgb":
                props[name] = _parse_color(child)
            elif tag == "srgb":
                props[name] = _parse_color(child, srgb=True)
            elif tag == "spectrum":
                props[name] = _parse_spectrum(child)
            elif tag == "blackbody":
                # Planck at three wavelengths times `scale`
                # (xml.py:154-158)
                temp = float(_substitute(child.get("temperature", "6500"),
                                         params))
                scale = float(_substitute(child.get("scale", "1"), params))
                props[name] = tuple(float(x) * scale
                                    for x in blackbody(temp).tolist())
        elif tag == "transform":
            props[name or "toWorld"] = _parse_transform(child, params)
        elif tag == "ref":
            rid = _substitute(child.get("id", ""), params)
            if rid not in named:
                raise SceneParseError(f"referenced object '{rid}' not found")
            children.append(named[rid])
        elif tag in _OBJECT_TAGS:
            children.append(parse_node(child, params, named, base_dir))
        elif tag == "include":
            fname = os.path.join(base_dir,
                                 _substitute(child.get("filename"), params))
            sub = ET.parse(fname).getroot()
            for sub_child in sub:
                if sub_child.tag in _OBJECT_TAGS:
                    children.append(
                        parse_node(sub_child, params, named, base_dir))
        elif tag == "null":
            pass
        elif tag == "alias":
            rid = _substitute(child.get("id", ""), params)
            named[_substitute(child.get("as", ""), params)] = named[rid]
        else:
            raise SceneParseError(f"unknown tag <{tag}>")
    parsed = {
        "category": node.tag,
        "type": node.get("type", "").lower(),
        "id": node.get("id"),
        "name": node.get("name"),
        "props": props,
        "children": children,
    }
    if node.get("id"):
        named[node.get("id")] = parsed
    return parsed


def _find_child(parsed, category):
    for c in parsed["children"]:
        if c["category"] == category:
            return c
    return None


def _find_children(parsed, category):
    return [c for c in parsed["children"] if c["category"] == category]


def load_scene(path: str, params: dict | None = None, backend: str = "auto",
               device="cuda") -> tuple:
    """Load a Mitsuba XML scene file onto `device` (the card by default).

    Returns (Scene, render_config_dict) where render_config_dict carries
    the integrator, sampler and film settings (maxDepth, sampleCount,
    pattern, ...), for a scene-level <medium> the MediumTable, and for
    animated shapes under an open shutter "time_scenes", the scenes of
    4 stratified shutter times (SceneBuilder.build_time_scenes).
    """
    params = dict(params or {})
    base_dir = os.path.dirname(os.path.abspath(path))
    root = ET.parse(path).getroot()
    if root.tag != "scene":
        raise SceneParseError("root element must be <scene>")
    named: dict = {}
    parsed = parse_node(root, params, named, base_dir)
    return build_scene(parsed, base_dir, backend=backend, device=device)


def load_scene_string(text: str, params: dict | None = None,
                      base_dir: str = ".", backend: str = "auto",
                      device="cuda") -> tuple:
    params = dict(params or {})
    root = ET.fromstring(text)
    named: dict = {}
    parsed = parse_node(root, params, named, base_dir)
    return build_scene(parsed, base_dir, backend=backend, device=device)


# ---------------------------------------------------------------------------
# Assembly: parsed tree -> SceneBuilder -> Scene
# ---------------------------------------------------------------------------

def _material_from_bsdf(builder: SceneBuilder, bsdf, cache):
    """Create (or reuse) a material row for a parsed bsdf node."""
    key = id(bsdf)
    if key in cache:
        return cache[key]
    from mitsuba_tpu_torch.bsdfs import xml_plugins

    mid = xml_plugins.build_material(
        builder.materials, bsdf, tb=builder.textures,
        base_dir=cache.get("__base_dir__", "."))
    cache[key] = mid
    return mid


def build_scene(parsed, base_dir: str, backend: str = "auto",
                device="cuda"):
    from mitsuba_tpu_torch.core.registry import create_plugin
    from mitsuba_tpu_torch.io import xml_shapes

    builder = SceneBuilder()
    mat_cache: dict = {"__base_dir__": base_dir}
    config = {
        "integrator": "path", "maxDepth": 5, "rrDepth": 10,
        "sampleCount": 4, "pattern": "independent",
        "width": 768, "height": 576, "rfilter": "box", "film": "exrfilm",
        "gamma": -1.0,
    }

    integ = _find_child(parsed, "integrator")
    if integ is not None:
        config["integrator"] = integ["type"] or "path"
        config["maxDepth"] = int(integ["props"].get("maxDepth", -1))
        config["rrDepth"] = int(integ["props"].get("rrDepth", 10))
        g = integ["props"].get("guiding", False)
        config["guiding"] = g in (True, "true", "1")

    cam_node = _find_child(parsed, "camera")
    film_w, film_h = 768, 576
    if cam_node is not None:
        film = _find_child(cam_node, "film")
        if film is not None:
            film_w = int(film["props"].get("width", 768))
            film_h = int(film["props"].get("height", 576))
            config["film"] = film["type"] or "exrfilm"
            config["gamma"] = float(film["props"].get("gamma", -1.0))
            rf = _find_child(film, "rfilter")
            if rf is not None:
                config["rfilter"] = rf["type"]
        samp = _find_child(cam_node, "sampler")
        if samp is not None:
            config["pattern"] = samp["type"] or "independent"
            config["sampleCount"] = int(samp["props"].get("sampleCount", 4))
        config["width"], config["height"] = film_w, film_h

        cam_props = dict(cam_node["props"])
        cam_props.setdefault("aspect", film_w / film_h)
        camera = create_plugin(
            "camera", cam_node["type"] or "perspective", cam_props,
            aspect=film_w / film_h,
        )
        builder.set_camera(camera, film_w, film_h)

    # scene-level luminaires (not attached to shapes)
    for lum in _find_children(parsed, "luminaire"):
        xml_shapes.add_scene_luminaire(builder, lum, base_dir)

    # the scene-level ambient medium, carried in the config
    med_node = _find_child(parsed, "medium")
    if med_node is not None:
        config["medium"] = _build_medium(med_node, base_dir)

    for shape in _find_children(parsed, "shape"):
        xml_shapes.add_shape(builder, shape, base_dir, mat_cache,
                             _material_from_bsdf)

    scene = builder.build(backend=backend, device=device)
    # motion blur: animated shapes under an open shutter render through
    # render_motion over scenes baked at stratified times (cli.py)
    if builder._animated and builder.camera is not None \
            and float(builder.camera.shutter_time) > 0.0:
        config["time_scenes"] = builder.build_time_scenes(
            int(config.get("time_bins", 4)), backend=backend, device=device)
    return scene, config


def _build_medium(node, base_dir):
    """<medium type="homogeneous|heterogeneous"> -> MediumTable (reference
    src/medium/: sigmaS/sigmaA or sigmaT + albedo, homogeneous.cpp;
    densityMultiplier and a gridvolume child, heterogeneous.cpp; a nested
    <phase type="hg"><float name="g" .../>)."""
    from mitsuba_tpu_torch.io.volio import (
        load_heterogeneous_from_vol, load_vol,
    )
    from mitsuba_tpu_torch.io.xml_shapes import medium_sigmas
    from mitsuba_tpu_torch.media import make_homogeneous
    from mitsuba_tpu_torch.media.phase import (
        HG, ISOTROPIC, KAJIYA_KAY, MICROFLAKE,
    )

    p = node["props"]
    sigma_s, sigma_a = medium_sigmas(p)
    g = 0.0
    phase_kind = None
    flake_stddev = None
    for c in node["children"]:
        if c["category"] == "phase":
            t = c["type"]
            if t == "hg":
                g = float(c["props"].get("g", 0.8))
                phase_kind = HG
            elif t == "isotropic":
                phase_kind = ISOTROPIC
            elif t == "kkay":
                phase_kind = KAJIYA_KAY
            elif t == "microflake":
                # microflake.cpp takes a Gaussian fiber stddev; without one
                # the sin²-lobe stands in for it
                if "stddev" in c["props"]:
                    flake_stddev = float(c["props"]["stddev"])
                else:
                    phase_kind = MICROFLAKE
    if node["type"] == "heterogeneous":
        vol = orient_vol = None
        for c in node["children"]:
            if c["category"] == "volume" and c.get("name") in ("density",
                                                               None):
                vol = c
            elif c["category"] == "volume" and c.get("name") in (
                    "orientation", "orientations"):
                orient_vol = c
        if vol is None or "filename" not in vol["props"]:
            raise SceneParseError(
                "heterogeneous medium needs a gridvolume density")
        orientation = None
        if orient_vol is not None:
            ogrid, _bmin, _bmax = load_vol(
                os.path.join(base_dir, orient_vol["props"]["filename"]))
            if ogrid.shape[-1] != 3:
                raise SceneParseError(
                    "orientation volume must have 3 channels")
            orientation = ogrid
        return load_heterogeneous_from_vol(
            os.path.join(base_dir, vol["props"]["filename"]),
            sigma_s, sigma_a,
            density_scale=float(p.get("densityMultiplier", 1.0)), g=g,
            orientation=orientation, flake_stddev=flake_stddev,
            phase_kind=phase_kind)
    return make_homogeneous(sigma_s, sigma_a, g=g, phase_kind=phase_kind,
                            flake_stddev=flake_stddev)
