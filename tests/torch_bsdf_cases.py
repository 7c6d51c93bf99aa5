"""Scenes of the port's materials slice, shared by its tests,
scripts/gen_torch_goldens.py and chip_smoke.py (numpy only: the caller
passes either package's builder modules, so nothing here imports JAX).

* `zoo_scene`: "bsdf_zoo", every BSDF kind and option the slice ports on
  spheres and quads under two area lights, brute backend: anisotropic
  Ward, rough glass under each microfacet distribution, a rough conductor
  under Phong, a diffuse transmitter (a wall lit from behind), Wiscombe
  snow, Hanrahan-Krueger, a composite, a 0.5 mask and twosided isotropic
  Ward seen from behind. Anisotropy sits on spheres only, whose frame is
  the same in every path of both packages (ROADMAP C).
* `ward_spheres_scene`: tests/golden_scenes.py:51 `scene_ward_spheres`.
* `ZOO_XML`: the new kinds as a scene file, for both XML loaders.
"""
from __future__ import annotations

from types import SimpleNamespace

ZOO_DEPTH = 5
WARD_SPHERES_DEPTH = 5
# the zoo's Phong exponents: the Beckmann-matched exponent of roughness
# 0.3 (2 / 0.3^2 - 2, roughness_to_alpha) for the glass, 30 the metal
PHONG_GLASS_EXP, PHONG_METAL_EXP = 20.2, 30.0


def port_modules():
    """The port's builder modules, as `zoo_scene` takes them."""
    from mitsuba_tpu_torch.core import microfacet as mf
    from mitsuba_tpu_torch.core import transform as tf
    from mitsuba_tpu_torch.render import mesh
    from mitsuba_tpu_torch.render.camera import make_perspective
    from mitsuba_tpu_torch.render.scene import SceneBuilder

    return SimpleNamespace(SceneBuilder=SceneBuilder, mesh=mesh, mf=mf,
                           look_at=tf.look_at,
                           make_perspective=make_perspective)


def zoo_materials(mb, mf):
    """The zoo's rows, in order; returns {name: row id}."""
    ids = {}
    ids["floor"] = mb.lambertian((0.5, 0.5, 0.5))
    ids["black"] = mb.lambertian((0.0, 0.0, 0.0))
    ids["ward"] = mb.ward(diffuse=(0.2, 0.15, 0.1), specular=(0.5, 0.5, 0.5),
                          alpha_u=0.1, alpha_v=0.3)
    ids["glass_beckmann"] = mb.rough_glass(alpha=0.2, dist=mf.BECKMANN)
    ids["glass_ggx"] = mb.rough_glass(alpha=0.3, int_ior=1.33,
                                      transmittance=(0.9, 0.95, 1.0),
                                      dist=mf.GGX)
    ids["glass_phong"] = mb.rough_glass(alpha=PHONG_GLASS_EXP,
                                        dist=mf.PHONG)
    ids["metal_phong"] = mb.rough_conductor(alpha=PHONG_METAL_EXP,
                                            dist=mf.PHONG)
    ids["difftrans"] = mb.diff_trans((0.6, 0.5, 0.4))
    ids["wiscombe"] = mb.wiscombe(w0=(0.9995, 0.9995, 0.999))
    ids["hk"] = mb.hanrahan_krueger()
    lam = mb.lambertian((0.4, 0.4, 0.4))
    metal = mb.rough_conductor(alpha=0.2)
    ids["composite"] = mb.composite([lam, metal], [0.4, 0.5])
    ids["mask"] = mb.lambertian((0.2, 0.5, 0.2))
    mb.rows[ids["mask"]]["opacity"] = 0.5
    ids["ward_twosided"] = mb.ward(diffuse=(0.3, 0.2, 0.3),
                                   specular=(0.4, 0.4, 0.4), alpha_u=0.2,
                                   alpha_v=0.2)
    mb.rows[ids["ward_twosided"]]["two_sided"] = True
    return ids


def zoo_scene(mods, res: int, **build_kw):
    """bsdf_zoo with the given package's modules (`port_modules()`, or
    the same names from mitsuba_tpu), res x res px, brute backend."""
    b = mods.SceneBuilder()
    ids = zoo_materials(b.materials, mods.mf)
    quad = mods.mesh.make_quad
    # the floor, its normal facing +y
    b.add_shape(quad([-4, -1, -4], [-4, -1, 4], [4, -1, 4], [4, -1, -4]),
                ids["floor"])
    # two rows of spheres, the anisotropic and rough kinds in front
    front = ("ward", "glass_beckmann", "glass_ggx", "glass_phong",
             "metal_phong")
    back = ("wiscombe", "hk", "composite", "mask")
    for i, name in enumerate(front):
        b.add_sphere((-1.7 + 0.85 * i, -0.6, 0.7), 0.4, ids[name])
    for i, name in enumerate(back):
        b.add_sphere((-1.35 + 0.9 * i, -0.5, -0.5), 0.5, ids[name])
    # the diffuse transmitter: a back wall facing the camera, lit from
    # behind by its own light
    b.add_shape(quad([-3, -1, -1.6], [3, -1, -1.6], [3, 2, -1.6],
                     [-3, 2, -1.6]), ids["difftrans"])
    b.add_area_emitter_shape(quad([-2, -0.5, -2.6], [2, -0.5, -2.6],
                                  [2, 1.5, -2.6], [-2, 1.5, -2.6]),
                             ids["black"], (1.5, 1.5, 1.5))
    # twosided Ward, its normal facing away from the camera
    b.add_shape(quad([1.9, -1, -0.6], [1.9, 0.0, -0.6], [2.4, 0.0, -0.6],
                     [2.4, -1, -0.6]), ids["ward_twosided"])
    # the key light, its normal facing -y
    b.add_area_emitter_shape(quad([-1, 2.5, -1], [1, 2.5, -1], [1, 2.5, 1],
                                  [-1, 2.5, 1]), ids["black"],
                             (10.0, 10.0, 10.0))
    b.set_camera(mods.make_perspective(
        mods.look_at((0.0, 0.8, 4.2), (0.0, -0.5, 0.0), (0, 1, 0)), 55.0,
        1.0), res, res)
    return b.build(backend="brute", **build_kw)


def ward_spheres_scene(mods, res: int, **build_kw):
    """tests/golden_scenes.py:51 scene_ward_spheres: Ward, Phong and rough
    glass spheres over a floor under an area light, brute backend."""
    b = mods.SceneBuilder()
    floor_m = b.materials.lambertian((0.5, 0.5, 0.5))
    ward = b.materials.ward(diffuse=(0.25, 0.25, 0.25),
                            specular=(0.5, 0.5, 0.5), alpha_u=0.1,
                            alpha_v=0.3)
    phong = b.materials.phong(diffuse=(0.25, 0.1, 0.1),
                              specular=(0.4, 0.4, 0.4), exponent=20.0)
    glass = b.materials.rough_glass(alpha=0.4, int_ior=1.5)
    black = b.materials.lambertian((0.0, 0.0, 0.0))
    quad = mods.mesh.make_quad
    b.add_shape(quad([-4, -1, -4], [4, -1, -4], [4, -1, 4], [-4, -1, 4]),
                floor_m)
    b.add_sphere((-1.2, -0.4, 0), 0.6, ward)
    b.add_sphere((0.0, -0.4, 0), 0.6, phong)
    b.add_sphere((1.2, -0.4, 0), 0.6, glass)
    b.add_area_emitter_shape(quad([-1, 2.5, -1], [1, 2.5, -1], [1, 2.5, 1],
                                  [-1, 2.5, 1]), black, (10.0, 10.0, 10.0))
    b.set_camera(mods.make_perspective(
        mods.look_at((0.0, 0.8, 4.2), (0.0, -0.4, 0.0), (0, 1, 0)), 35.0,
        1.0), res, res)
    return b.build(backend="brute", **build_kw)


def _sphere(x, z, bsdf):
    return (f'<shape type="sphere"><point name="center" x="{x}" y="0" '
            f'z="{z}"/><float name="radius" value="0.4"/>{bsdf}</shape>')


# every new plugin name and property spelling of bsdfs/xml_plugins.py
_ZOO_BSDFS = (
    '<bsdf type="ward"><float name="alphaX" value="0.1"/><float '
    'name="alphaY" value="0.3"/><rgb name="diffuseReflectance" '
    'value="0.2 0.15 0.1"/></bsdf>',
    '<bsdf type="roughglass"><float name="alphaB" value="0.2"/></bsdf>',
    '<bsdf type="roughdielectric"><float name="alpha" value="0.3"/><string '
    'name="distribution" value="ggx"/><float name="intIOR" value="1.33"/>'
    '</bsdf>',
    '<bsdf type="roughglass"><float name="alphaB" value="20"/><string '
    'name="distribution" value="phong"/></bsdf>',
    '<bsdf type="roughconductor"><float name="alpha" value="30"/><string '
    'name="distribution" value="phong"/></bsdf>',
    '<bsdf type="microfacet"><float name="alphaB" value="0.25"/><rgb '
    'name="diffuseReflectance" value="0.3"/></bsdf>',
    '<bsdf type="difftrans"><rgb name="transmittance" value="0.6 0.5 0.4"/>'
    '</bsdf>',
    '<bsdf type="wiscombe"><float name="depth" value="0.6"/><rgb '
    'name="singleScatteringAlbedo" value="0.9995 0.9995 0.999"/></bsdf>',
    '<bsdf type="dozier"><rgb name="singleScatteringAlbodo" value="0.98"/>'
    '<float name="g" value="0.8"/></bsdf>',
    '<bsdf type="hk"><float name="g" value="0.3"/></bsdf>',
    '<bsdf type="hanrahan-krueger"><rgb name="sigmaA" value="0.1 0.2 0.3"/>'
    '<float name="densityMultiplier" value="2"/><boolean '
    'name="diffuseReflectance" value="false"/></bsdf>',
    '<bsdf type="composite"><string name="weights" value="0.4, 0.5"/>'
    '<bsdf type="diffuse"><rgb name="reflectance" value="0.4"/></bsdf>'
    '<bsdf type="roughconductor"><float name="alpha" value="0.2"/></bsdf>'
    '</bsdf>',
    '<bsdf type="mask"><rgb name="opacity" value="0.5"/><bsdf '
    'type="diffuse"/></bsdf>',
    '<bsdf type="twosided"><bsdf type="ward"><float name="alphaX" '
    'value="0.2"/><float name="alphaY" value="0.2"/></bsdf></bsdf>',
)

ZOO_XML = (
    '<scene><integrator type="path"><integer name="maxDepth" value="3"/>'
    '</integrator><camera type="perspective"><float name="fov" value="60"/>'
    '<transform name="toWorld"><lookAt ox="0" oy="2" oz="6" tx="0" ty="0" '
    'tz="0" ux="0" uy="1" uz="0"/></transform><sampler type="halton">'
    '<integer name="sampleCount" value="2"/></sampler><film type="hdrfilm">'
    '<integer name="width" value="16"/><integer name="height" value="16"/>'
    '<rfilter type="mitchell"/></film></camera>'
    '<luminaire type="sky"><float name="turbidity" value="3"/></luminaire>'
    + "".join(_sphere(-3.0 + (i % 5) * 1.5, -1.0 * (i // 5), bsdf)
              for i, bsdf in enumerate(_ZOO_BSDFS))
    + '</scene>')
