"""Inputs of the tests of what scene files could not name before the port
took it (analytic cylinders, the woven cloth, `<blackbody>`, JPEG,
height-span maps and tessellated hair) and of chip_smoke.py's
`cylinders_xml`, `cylinders_cluster`, `cylinder_media`, `cloth_xml` and
`leftovers_xml` phases (numpy and the port's codecs only; every file is
made from a seed).

* `write_cylinders_xml(dir)`: scenes/cornell.xml's box with three
  analytic cylinders, a lambertian one standing, a rough conductor lying
  on the floor and a dielectric one tilted in the air (given in a unit
  frame under `toWorld`); `media=True` gives instead one dielectric
  cylinder holding a homogeneous interior medium. 32 triangles: brute.
* `write_cloth_xml(dir)`: the box with an irawan cloth on the floor from
  the weave file `WEAVE` (tests/test_weave.py:16-40's grammar) and the
  procedural twill on a panel before the back wall. 36 triangles: brute.
* `write_leftovers_xml(dir, cells, fibers)`: a height-span snow field of
  cells x cells (`write_hspan`, version 2), `fibers` tessellated hair
  fibres of 16 points and 6 sides (`write_hair`; `analytic=True` leaves
  them analytic segments), a ground quad under a `tex` x `tex` JPEG
  bitmap, and an area light whose intensity is `<blackbody
  temperature="5800">`. The cluster backend.
* `write_hair_cornell_xml(dir, fibers)`: scenes/cornell.xml's box with
  an analytic `hair` of `fibers` fibres of 16 points (15 segments each)
  standing on its floor; `tessellate=True` makes them tubes. 32
  triangles: brute.
* `write_config3_cylinders(dir)`: tests/torch_xml_cases.py's binary-PLY
  twin of bench config 3 with eight analytic cylinders in a ring about
  its body (the cluster backend under `auto`).
* `cylinders_scene(mods, ...)`: a floor, a sphere and cylinders built with
  either package's SceneBuilder, for the intersection tests;
  `hair_scene(mods, backend, path)` the same floor, a sphere, a cylinder
  and the analytic hair of the file `path` (`load_hair_segments` of
  either package's io.hairio).
"""
from __future__ import annotations

import os

import numpy as np

from mitsuba_tpu_torch.io.jpeg import write_jpeg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORNELL = os.path.join(REPO, "scenes", "cornell.xml")

# a 3 x 2 basket weave, two yarns (tests/test_weave.py:16's grammar)
WEAVE = """
/* a basket weave */
weave {
    name = "Basket",
    tileWidth = 3,
    tileHeight = 2,
    alpha = $alpha,          // from the plugin's props
    beta = 4.0,
    ss = 0.5,
    hWidth = 0.6,
    warpArea = 2.0, weftArea = 1.0,
    fineness = 150.0, period = 100.0,
    dWarpUmaxOverDWarp = 90, dWarpUmaxOverDWeft = 0,
    dWeftUmaxOverDWarp = 0,  dWeftUmaxOverDWeft = 90,
    pattern { 1, 2, 1,
              2, 1, 2 },
    yarn {
        type = warp, psi = 30, umax = 35, kappa = 2.0,
        width = 2, length = 3, centerU = 0.5, centerV = 0.5,
        kd = {0.2, 0.8, 0.3}, ks = {0.4, 0.4, 0.4}
    },
    yarn {
        type = weft, umax = 25,
        width = 2, length = 3, centerU = 0.5, centerV = 0.5,
        kd = {0.7, 0.1, 0.1}, ks = {0.1, 0.1, 0.1}
    }
}
"""


def write_weave(d, name="basket.wv"):
    path = os.path.join(d, name)
    with open(path, "w") as f:
        f.write(WEAVE)
    return path


def _cornell(extra):
    """scenes/cornell.xml with its meshes by absolute path and `extra`
    before its end."""
    with open(CORNELL) as f:
        xml = f.read()
    xml = xml.replace('value="meshes/', 'value="' + os.path.join(
        REPO, "scenes", "meshes") + "/")
    return xml.replace("</scene>", extra + "</scene>")


CYLINDERS = """
	<shape type="cylinder">
		<point name="p1" x="450" y="0" z="120"/>
		<point name="p2" x="450" y="160" z="120"/>
		<float name="radius" value="45"/>
		<bsdf type="diffuse"><rgb name="reflectance" value="0.2 0.3 0.75"/></bsdf>
	</shape>
	<shape type="cylinder">
		<point name="p1" x="60" y="40" z="330"/>
		<point name="p2" x="220" y="40" z="420"/>
		<float name="radius" value="40"/>
		<bsdf type="roughconductor"><float name="alpha" value="0.2"/>
			<string name="distribution" value="ggx"/></bsdf>
	</shape>
	<shape type="cylinder">
		<point name="p1" x="0" y="0" z="0"/>
		<point name="p2" x="0" y="0" z="1"/>
		<float name="radius" value="0.2"/>
		<transform name="toWorld">
			<rotate x="1" angle="-70"/><rotate y="1" angle="35"/>
			<scale value="170"/><translate x="180" y="240" z="150"/>
		</transform>
		<bsdf type="dielectric"><float name="intIOR" value="1.5"/></bsdf>
	</shape>
"""

CYLINDER_MEDIUM = """
	<shape type="cylinder">
		<point name="p1" x="280" y="0" z="180"/>
		<point name="p2" x="280" y="300" z="180"/>
		<float name="radius" value="90"/>
		<bsdf type="dielectric"><float name="intIOR" value="1.33"/></bsdf>
		<medium type="homogeneous" name="interior">
			<rgb name="sigmaS" value="0.012 0.010 0.006"/>
			<rgb name="sigmaA" value="0.0010 0.0020 0.0060"/>
			<phase type="hg"><float name="g" value="0.5"/></phase>
		</medium>
	</shape>
"""


def write_cylinders_xml(d, media=False):
    path = os.path.join(d, "cylinder_media.xml" if media
                        else "cylinders.xml")
    with open(path, "w") as f:
        f.write(_cornell(CYLINDER_MEDIUM if media else CYLINDERS))
    return path


def write_config3_cylinders(d, n_theta=160, n_phi=320):
    """The config-3 twin's files in d and, in config3_cylinders.xml, the
    twin with eight cylinders standing in a ring of radius 1.5 about the
    body: lambertian, rough conductor and dielectric in turn, heights
    0.4 to 1.1, two of them leaning."""
    import torch_xml_cases as xc

    xc.write_config3_twin(d, n_theta, n_phi)
    shapes = []
    bsdfs = ('<bsdf type="diffuse"><rgb name="reflectance" value="{c}"/>'
             '</bsdf>', '<bsdf type="roughconductor"><float name="alpha" '
             'value="0.25"/></bsdf>', '<bsdf type="dielectric"/>')
    for k in range(8):
        a = 2.0 * np.pi * k / 8
        x, z = 1.5 * np.cos(a), 1.5 * np.sin(a)
        top = 0.4 + 0.1 * k
        lean = 0.3 if k in (2, 5) else 0.0
        colour = f"{0.2 + 0.08 * k:.2f} 0.4 {0.8 - 0.08 * k:.2f}"
        shapes.append(
            f'<shape type="cylinder"><point name="p1" x="{x:.4f}" y="0" '
            f'z="{z:.4f}"/><point name="p2" x="{x + lean:.4f}" '
            f'y="{top:.2f}" z="{z:.4f}"/><float name="radius" '
            f'value="{0.06 + 0.01 * k:.2f}"/>'
            + bsdfs[k % 3].format(c=colour) + "</shape>")
    with open(os.path.join(d, "config3.xml")) as f:
        xml = f.read()
    path = os.path.join(d, "config3_cylinders.xml")
    with open(path, "w") as f:
        f.write(xml.replace("</scene>", "\n".join(shapes) + "\n</scene>"))
    return path


def _quad_obj(corners, uv_scale=1.0):
    """A quad (4 corners, counter-clockwise seen from its front) with uvs
    over [0, uv_scale]^2."""
    lines = [f"v {x} {y} {z}" for x, y, z in corners]
    s = uv_scale
    lines += [f"vt {u} {v}" for u, v in ((0, 0), (s, 0), (s, s), (0, s))]
    lines += ["f 1/1 2/2 3/3", "f 1/1 3/3 4/4"]
    return "\n".join(lines) + "\n"


CLOTH = """
	<shape type="obj">
		<string name="filename" value="cloth_floor.obj"/>
		<bsdf type="irawan">
			<string name="filename" value="basket.wv"/>
			<float name="alpha" value="0.33"/>
			<float name="repeatU" value="40"/>
			<float name="repeatV" value="60"/>
			<float name="kdMultiplier" value="0.9"/>
		</bsdf>
	</shape>
	<shape type="obj">
		<string name="filename" value="cloth_panel.obj"/>
		<bsdf type="irawan">
			<string name="pattern" value="twill"/>
			<rgb name="warpKd" value="0.15 0.2 0.5"/>
			<rgb name="weftKd" value="0.6 0.55 0.3"/>
			<float name="repeatU" value="24"/>
			<float name="repeatV" value="24"/>
		</bsdf>
	</shape>
"""


def write_cloth_xml(d):
    write_weave(d)
    with open(os.path.join(d, "cloth_floor.obj"), "w") as f:
        f.write(_quad_obj(((40, 0.5, 20), (40, 0.5, 540), (515, 0.5, 540),
                           (515, 0.5, 20))))
    with open(os.path.join(d, "cloth_panel.obj"), "w") as f:
        f.write(_quad_obj(((120, 60, 557), (120, 460, 557), (440, 460, 557),
                           (440, 60, 557))))
    path = os.path.join(d, "cloth.xml")
    with open(path, "w") as f:
        f.write(_cornell(CLOTH))
    return path


def write_hspan(path, n, seed=0, overhang=7):
    """A version-2 height-span map (`x y` then h1 h2 and 8 adjacency
    numbers a span, hspan.cpp:440-520) of n x n cells: a snow surface of
    a few smooth waves and noise, every `overhang`-th cell (none at 0)
    with a second span below its top, which joins its neighbours' tops
    in quads of its own."""
    rng = np.random.default_rng(seed)
    x, y = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    f = 2.0 * np.pi / n
    # in cell units, so that a field scaled to a given width has the same
    # relief at any n
    top = (n / 64.0) * (3.0 + 1.5 * np.sin(3 * f * x) * np.cos(2 * f * y)
                        + 0.8 * np.sin(7 * f * (x + 2 * y))
                        + 0.15 * rng.standard_normal((n, n)))
    lines = []
    for i in range(n):
        for j in range(n):
            h = top[i, j]
            spans = f"0.0 {h:.5f} 1 0 1 0 1 0 1 0"
            if overhang and (i * n + j) % overhang == 0:
                lo, hi = h - 2.5 * n / 64.0, h - 1.5 * n / 64.0
                spans += f" {lo:.5f} {hi:.5f} 0 0 0 0 0 0 0 0"
            lines.append(f"{i} {j} {spans}")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return path


def write_hair(path, n_fibers, n_pts=16, seed=0, spread=1.6, length=0.45):
    """A mitsuba hair file: n_fibers fibres of n_pts points growing up
    from the square [-spread, spread]^2 of the y = 0.1 plane, bending
    with a random lean and curl."""
    rng = np.random.default_rng(seed)
    s = np.linspace(0.0, 1.0, n_pts)
    lines = []
    for _ in range(n_fibers):
        x0, z0 = rng.uniform(-spread, spread, 2)
        lean = rng.normal(scale=0.15, size=2)
        curl = rng.uniform(0.0, 2.0 * np.pi)
        pts = np.stack([
            x0 + lean[0] * s ** 2 + 0.02 * np.sin(6 * s + curl),
            0.1 + length * s,
            z0 + lean[1] * s ** 2 + 0.02 * np.cos(6 * s + curl)], -1)
        lines.extend(" ".join(f"{c:.6f}" for c in p) for p in pts)
        lines.append("")
    with open(path, "w") as fh:
        fh.write("\n".join(lines))
    return path


def write_ground_jpeg(path, n, seed=0):
    """An n x n JPEG of a tiled pattern with noise (quality 90)."""
    rng = np.random.default_rng(seed)
    u, v = np.meshgrid(np.linspace(0, 1, n), np.linspace(0, 1, n))
    img = np.stack([0.45 + 0.25 * np.sin(24 * np.pi * u),
                    0.40 + 0.20 * np.cos(20 * np.pi * v),
                    0.30 + 0.20 * np.sin(16 * np.pi * (u + v))], -1)
    img = img + 0.02 * rng.standard_normal(img.shape)
    write_jpeg(path, (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8),
               quality=90)
    return path


LEFTOVERS = """<?xml version="1.0" encoding="utf-8"?>
<scene>
	<integrator type="path"><integer name="maxDepth" value="$depth"/></integrator>
	<camera type="perspective">
		<float name="fov" value="45"/>
		<transform name="toWorld">
			<lookAt ox="0" oy="2.4" oz="-4.2" tx="0" ty="0.1" tz="0" ux="0" uy="1" uz="0"/>
		</transform>
		<sampler type="independent"><integer name="sampleCount" value="$spp"/></sampler>
		<film type="exrfilm">
			<integer name="width" value="$width"/>
			<integer name="height" value="$height"/>
		</film>
	</camera>
	<shape type="obj">
		<string name="filename" value="ground.obj"/>
		<bsdf type="diffuse">
			<texture type="bitmap" name="reflectance">
				<string name="filename" value="ground.jpg"/>
				<float name="uscale" value="3"/><float name="vscale" value="3"/>
			</texture>
		</bsdf>
	</shape>
	<shape type="hspan">
		<string name="filename" value="snow.hspans2"/>
		<transform name="toWorld">
			<translate x="{shift}" y="0" z="{shift}"/><scale value="{scale}"/>
		</transform>
		<bsdf type="diffuse"><rgb name="reflectance" value="0.85 0.87 0.9"/></bsdf>
	</shape>
	<shape type="hair">
		<string name="filename" value="fibres.hair"/>
		<boolean name="tessellate" value="true"/>
		<float name="radius" value="0.006"/>
		<bsdf type="roughconductor"><float name="alpha" value="0.3"/>
			<rgb name="specularReflectance" value="0.55 0.35 0.2"/></bsdf>
	</shape>
	<shape type="obj">
		<string name="filename" value="light.obj"/>
		<bsdf type="diffuse"><rgb name="reflectance" value="0"/></bsdf>
		<luminaire type="area">
			<blackbody name="intensity" temperature="5800" scale="0.0008"/>
		</luminaire>
	</shape>
</scene>
"""


def write_leftovers_xml(d, cells, fibers, tex=1024, seed=0,
                        analytic=False):
    """leftovers.xml and its files in d; the field spans [-1.8, 1.8]^2
    whatever its cells (its heights scale with it), no overhangs: 2 (cells
    - 1)^2 triangles. analytic: the fibres stay analytic segments."""
    write_hspan(os.path.join(d, "snow.hspans2"), cells, seed, overhang=0)
    write_hair(os.path.join(d, "fibres.hair"), fibers, seed=seed + 1)
    write_ground_jpeg(os.path.join(d, "ground.jpg"), tex, seed + 2)
    with open(os.path.join(d, "ground.obj"), "w") as f:
        f.write(_quad_obj(((-6, 0, -6), (-6, 0, 6), (6, 0, 6), (6, 0, -6))))
    with open(os.path.join(d, "light.obj"), "w") as f:
        f.write(_quad_obj(((-1, 4, -1), (1, 4, -1), (1, 4, 1), (-1, 4, 1))))
    scale = 3.6 / (cells - 1)
    path = os.path.join(d, "leftovers.xml")
    xml = LEFTOVERS.replace("{shift}", repr(-(cells - 1) / 2.0)) \
        .replace("{scale}", repr(scale))
    if analytic:
        xml = xml.replace(
            '\t\t<boolean name="tessellate" value="true"/>\n', "")
    with open(path, "w") as f:
        f.write(xml)
    return path


HAIR_CORNELL = """
	<shape type="hair">
		<string name="filename" value="fibres.hair"/>
		{tessellate}<float name="radius" value="0.012"/>
		<transform name="toWorld">
			<scale value="100"/><translate x="278" y="0" z="280"/>
		</transform>
		<bsdf type="diffuse"><rgb name="reflectance" value="0.55 0.35 0.2"/></bsdf>
	</shape>
"""


def write_hair_cornell_xml(d, fibers, seed=0, tessellate=False):
    """hair_cornell.xml (hair_cornell_tess.xml with tessellate) and its
    fibres.hair in d: the Cornell box with `fibers` fibres 1.2 units
    tall in a unit frame, scaled 100 onto the middle of the floor."""
    write_hair(os.path.join(d, "fibres.hair"), fibers, seed=seed,
               length=1.2)
    tess = '<boolean name="tessellate" value="true"/>' if tessellate \
        else ""
    path = os.path.join(d, "hair_cornell_tess.xml" if tessellate
                        else "hair_cornell.xml")
    with open(path, "w") as f:
        f.write(_cornell(HAIR_CORNELL.replace("{tessellate}", tess)))
    return path


def cylinders_scene(mods, backend, device=None, width=16, height=16,
                    media=False):
    """A floor, an analytic sphere and three cylinders (one along each of
    two axes, one tilted) under a point light, with either package's
    modules (SceneBuilder, mesh, look_at, make_perspective); `media`
    puts a homogeneous medium in the tilted one."""
    b = mods.SceneBuilder()
    lm = b.materials.lambertian((0.5, 0.5, 0.5))
    green = b.materials.lambertian((0.2, 0.7, 0.2))
    metal = b.materials.rough_conductor(alpha=0.2)
    b.add_shape(mods.mesh.make_quad([-3, -1, -3], [-3, -1, 3], [3, -1, 3],
                                    [3, -1, -3]), lm)
    b.add_sphere((1.5, 0.0, 0.0), 0.5, green)
    b.add_cylinder((0.0, -1.0, 0.0), (0.0, 1.0, 0.2), 0.6, metal)
    b.add_cylinder((-1.5, 0.0, -1.0), (-1.5, 0.0, 1.0), 0.3, green)
    medium = -1
    if media:
        medium = b.add_medium((0.6, 0.5, 0.4), (0.1, 0.1, 0.2), g=0.3)
    b.add_cylinder((0.8, -0.5, -1.5), (1.8, 0.9, -0.6), 0.35,
                   b.materials.dielectric(int_ior=1.33) if media else lm,
                   interior_medium=medium)
    b.add_area_emitter_shape(mods.mesh.make_quad(
        [-1, 3, -1], [1, 3, -1], [1, 3, 1], [-1, 3, 1]), lm, (12.0,) * 3)
    b.set_camera(mods.make_perspective(
        mods.look_at([0.5, 1.5, -5.0], [0.0, 0.0, 0.0], [0, 1, 0]), 45.0,
        width / height), width, height)
    kw = {} if device is None else dict(device=device)
    return b.build(backend=backend, **kw)


def hair_scene(mods, backend, path, radius=0.04, device=None, width=16,
               height=16):
    """cylinders_scene's floor and light, a sphere, a cylinder and the
    analytic hair of the hair file `path`, built with either package's
    modules (SceneBuilder, mesh, look_at, make_perspective, hairio)."""
    b = mods.SceneBuilder()
    lm = b.materials.lambertian((0.5, 0.5, 0.5))
    brown = b.materials.lambertian((0.55, 0.35, 0.2))
    b.add_shape(mods.mesh.make_quad([-3, -1, -3], [-3, -1, 3], [3, -1, 3],
                                    [3, -1, -3]), lm)
    b.add_sphere((1.5, 0.0, 0.0), 0.5, lm)
    b.add_cylinder((-1.5, -1.0, -1.0), (-1.5, 0.5, -0.8), 0.3, lm)
    b.add_hair(mods.hairio.load_hair_segments(path, radius=radius), brown)
    b.add_area_emitter_shape(mods.mesh.make_quad(
        [-1, 3, -1], [1, 3, -1], [1, 3, 1], [-1, 3, 1]), lm, (12.0,) * 3)
    b.set_camera(mods.make_perspective(
        mods.look_at([0.5, 1.5, -5.0], [0.0, 0.0, 0.0], [0, 1, 0]), 45.0,
        width / height), width, height)
    kw = {} if device is None else dict(device=device)
    return b.build(backend=backend, **kw)
