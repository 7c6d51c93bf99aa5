"""Scene files for the port's XML loader: an XML twin of bench config 3
(`textured_mesh_scene`), written as files, and the comparison of two
scenes' tables. Imports no JAX: chip_smoke.py and tests/test_torch_cuda.py
load it on the card, tests/test_torch_xml.py on the CPU.

The twin: the body (`make_sphere_mesh([0, 0.8, 0], 0.8, n_theta,
n_phi)`, config 3's 160 x 320 by default, 101,760 triangles) and the
floor quad as binary PLY files, the phong body, the checkerboard floor
(uscale / vscale 8) and the Preetham sky (turbidity 3, sunDirection,
intensityScale 1) in an XML file. The loader adds a material when the
first shape that uses it is added, as the reference's does, and the body
comes first: so the twin's material rows are config 3's in the other
order (`MATERIAL_ORDER`), and every id that points at them with them.
"""
import dataclasses
import os

import numpy as np
import torch

from mitsuba_tpu_torch.render import mesh as tmesh

# config 3's material row k is the twin's row MATERIAL_ORDER[k]
MATERIAL_ORDER = (1, 0)
# the column of GeometryTables.shade_pack that holds the material id
SHADE_MID = 21

TWIN_XML = """<?xml version="1.0" encoding="utf-8"?>
<scene>
 <integrator type="path"><integer name="maxDepth" value="$depth"/></integrator>
 <camera type="perspective">
  <float name="fov" value="40"/>
  <transform name="toWorld">
   <lookAt ox="0" oy="1.4" oz="-3.2" tx="0" ty="0.7" tz="0" ux="0" uy="1" uz="0"/>
  </transform>
  <sampler type="independent"><integer name="sampleCount" value="$spp"/></sampler>
  <film type="exrfilm">
   <integer name="width" value="$width"/><integer name="height" value="$height"/>
   <rfilter type="box"/>
  </film>
 </camera>
 <luminaire type="sky">
  <float name="turbidity" value="3"/>
  <vector name="sunDirection" x="0.35" y="0.6" z="-0.5"/>
  <float name="intensityScale" value="1"/>
 </luminaire>
 <shape type="ply">
  <string name="filename" value="body.ply"/>
  <bsdf type="phong">
   <rgb name="diffuseReflectance" value="0.4 0.3 0.2"/>
   <rgb name="specularReflectance" value="0.3"/>
   <float name="exponent" value="40"/>
  </bsdf>
 </shape>
 <shape type="ply">
  <string name="filename" value="floor.ply"/>
  <bsdf type="diffuse">
   <rgb name="reflectance" value="1"/>
   <texture type="checkerboard" name="reflectance">
    <rgb name="brightColor" value="0.7"/>
    <rgb name="darkColor" value="0.2 0.2 0.25"/>
    <float name="uscale" value="8"/><float name="vscale" value="8"/>
   </texture>
  </bsdf>
 </shape>
</scene>
"""


def write_binary_ply(path, mesh, endian="<"):
    """A TriMesh as a binary PLY: float32 x y z [nx ny nz] [u v], faces
    as uchar-counted int lists."""
    v = mesh.vertices
    cols = [("x", v[:, 0]), ("y", v[:, 1]), ("z", v[:, 2])]
    if mesh.normals is not None:
        cols += [("nx", mesh.normals[:, 0]), ("ny", mesh.normals[:, 1]),
                 ("nz", mesh.normals[:, 2])]
    if mesh.uvs is not None:
        cols += [("u", mesh.uvs[:, 0]), ("v", mesh.uvs[:, 1])]
    fmt = "binary_little_endian" if endian == "<" else "binary_big_endian"
    head = ["ply", f"format {fmt} 1.0", f"element vertex {len(v)}"]
    head += [f"property float {n}" for n, _ in cols]
    head += [f"element face {mesh.faces.shape[0]}",
             "property list uchar int vertex_indices", "end_header"]
    vert = np.zeros(len(v), [(n, endian + "f4") for n, _ in cols])
    for n, c in cols:
        vert[n] = c
    face = np.zeros(mesh.faces.shape[0],
                    [("n", "u1"), ("i", endian + "i4", 3)])
    face["n"] = 3
    face["i"] = mesh.faces
    with open(path, "wb") as f:
        f.write(("\n".join(head) + "\n").encode())
        f.write(vert.tobytes() + face.tobytes())


def write_config3_twin(directory, n_theta=160, n_phi=320):
    """Write the twin's files into `directory`; returns the XML's path."""
    write_binary_ply(os.path.join(directory, "body.ply"),
                     tmesh.make_sphere_mesh([0, 0.8, 0], 0.8, n_theta,
                                            n_phi))
    write_binary_ply(os.path.join(directory, "floor.ply"),
                     tmesh.make_quad([-6, 0, -6], [-6, 0, 6], [6, 0, 6],
                                     [6, 0, -6]))
    path = os.path.join(directory, "config3.xml")
    with open(path, "w") as f:
        f.write(TWIN_XML)
    return path


def _bytes(t):
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def table_diffs(a, b, where=""):
    """The fields of two scenes (or tables) that differ, each tensor by
    torch.equal of its bytes (dtype and shape included: a table may hold
    ints bitcast to floats, -1 among them, a NaN)."""
    if isinstance(a, torch.Tensor):
        same = isinstance(b, torch.Tensor) and a.dtype == b.dtype \
            and a.shape == b.shape and torch.equal(_bytes(a), _bytes(b))
        return [] if same else [where]
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        if type(a) is not type(b):
            return [where]
        return [d for f in dataclasses.fields(a)
                for d in table_diffs(getattr(a, f.name), getattr(b, f.name),
                                     f"{where}.{f.name}".lstrip("."))]
    if isinstance(a, (tuple, list)):
        if not isinstance(b, (tuple, list)) or len(a) != len(b):
            return [where]
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in table_diffs(x, y, f"{where}[{i}]")]
    return [] if a == b else [where]


def with_material_order(scene, order=MATERIAL_ORDER):
    """`scene` with its material rows permuted: row k moves to order[k],
    and the geometry's material ids (its `material_id`, and the column of
    `shade_pack` that holds it) with it."""
    perm = torch.as_tensor(order, device=scene.device)
    rows = torch.argsort(perm)        # the new row j is the old row rows[j]
    mats = dataclasses.replace(scene.materials, **{
        f.name: getattr(scene.materials, f.name)[rows]
        for f in dataclasses.fields(scene.materials)
        if isinstance(getattr(scene.materials, f.name), torch.Tensor)})
    geom = scene.geom
    mid = perm.to(torch.int32)[geom.material_id.long()]
    fields = dict(material_id=mid)
    if geom.shade_pack is not None:
        pack = geom.shade_pack.clone()
        col = pack[:, SHADE_MID].view(torch.int32)
        pack[:, SHADE_MID] = perm.to(torch.int32)[col.long()].view(
            torch.float32)
        fields["shade_pack"] = pack
    return dataclasses.replace(scene, materials=mats,
                               geom=dataclasses.replace(geom, **fields))
