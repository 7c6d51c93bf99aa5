"""Ray–scene intersection on the brute backend (port of the brute parts of
mitsuba_tpu/render/intersect.py).

Geometry lives in `GeometryTables`, SoA tensors of the triangle soup. The
path tracer's query, `ray_intersect_and_test`, runs the fused kernel of
`ops/intersect.py` once per bounce and assembles the `Intersection` from
its outputs exactly as the reference's TPU kernel path does
(mitsuba_tpu/render/intersect.py:1489-1518): the shading frame is
`Frame.from_normal(sh_n)` and `dp_du` is that frame's s axis.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from mitsuba_tpu_torch.core import math as m
from mitsuba_tpu_torch.ops import intersect as ip
from mitsuba_tpu_torch.render.records import Intersection, Ray


@dataclass
class GeometryTables:
    v0: torch.Tensor        # (T, 3)
    e1: torch.Tensor        # (T, 3) v1 - v0
    e2: torch.Tensor        # (T, 3) v2 - v0
    n0: torch.Tensor        # (T, 3) per-corner shading normals
    n1: torch.Tensor
    n2: torch.Tensor
    uv0: torch.Tensor       # (T, 2)
    uv1: torch.Tensor
    uv2: torch.Tensor
    material_id: torch.Tensor  # (T,) int32
    emitter_id: torch.Tensor   # (T,) int32, -1 = not emissive
    shape_id: torch.Tensor     # (T,) int32

    @property
    def n_tris(self):
        return self.v0.shape[0]


def build_geometry(meshes_with_ids, backend: str = "brute") \
        -> GeometryTables:
    """Assemble GeometryTables from [(TriMesh, material_id, emitter_id
    [, shape_id]), ...] — the reference's brute branch: no tree, triangles
    in input order. Host numpy, as in the reference."""
    vs, fs, ns, uvs, mids, eids, sids = [], [], [], [], [], [], []
    voff = 0
    for k, item in enumerate(meshes_with_ids):
        mesh, mat, emit = item[:3]
        sid = item[3] if len(item) > 3 else k
        vs.append(np.asarray(mesh.vertices, np.float32))
        fs.append(np.asarray(mesh.faces, np.int64) + voff)
        n = mesh.normals
        if n is None:
            # flat face normals averaged onto the vertices
            fn = mesh.face_normals()
            n = np.zeros_like(mesh.vertices)
            for c in range(3):
                np.add.at(n, mesh.faces[:, c], fn)
            n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True),
                               1e-20)
        ns.append(np.asarray(n, np.float32))
        uv = mesh.uvs if mesh.uvs is not None else \
            np.zeros((mesh.vertices.shape[0], 2), np.float32)
        uvs.append(np.asarray(uv, np.float32))
        t = mesh.faces.shape[0]
        mids.append(np.full(t, mat, np.int32))
        eids.append(np.full(t, emit, np.int32))
        sids.append(np.full(t, sid, np.int32))
        voff += mesh.vertices.shape[0]
    v = np.concatenate(vs)
    f = np.concatenate(fs)
    n = np.concatenate(ns)
    uv = np.concatenate(uvs)
    if backend != "brute":
        raise NotImplementedError(
            f"intersection backend '{backend}' is not ported (only 'brute')")
    tri = v[f]  # (T, 3, 3)

    def dev(x):
        return torch.as_tensor(np.ascontiguousarray(x))

    return GeometryTables(
        v0=dev(tri[:, 0]),
        e1=dev(tri[:, 1] - tri[:, 0]),
        e2=dev(tri[:, 2] - tri[:, 0]),
        n0=dev(n[f[:, 0]]), n1=dev(n[f[:, 1]]), n2=dev(n[f[:, 2]]),
        uv0=dev(uv[f[:, 0]]), uv1=dev(uv[f[:, 1]]), uv2=dev(uv[f[:, 2]]),
        material_id=dev(np.concatenate(mids)),
        emitter_id=dev(np.concatenate(eids)),
        shape_id=dev(np.concatenate(sids)),
    )


def ray_intersect_and_test(geom: GeometryTables, ray: Ray, sray: Ray):
    """Fused closest hit (ray) + shadow any-hit (sray): one kernel launch
    with a shared triangle loop. Returns (Intersection, occluded)."""
    table = ip.make_shading_table(geom)
    r, occ = ip.closest_hit_shaded_and_any(
        table, ray.o.contiguous(), ray.d.contiguous(),
        ray.mint.contiguous(), ray.maxt.contiguous(),
        sray.o.contiguous(), sray.d.contiguous(),
        sray.mint.contiguous(), sray.maxt.contiguous(),
    )
    valid = r["valid"]
    # finite position on a miss: inf positions would NaN the masked lanes
    p = ray.at(torch.where(valid, r["t"], 1.0))
    frame = m.Frame.from_normal(r["sh_n"])
    wi = frame.to_local(-ray.d)
    its = Intersection(
        valid=valid,
        t=torch.where(valid, r["t"], float("inf")),
        p=p,
        geo_n=r["geo_n"],
        sh_n=r["sh_n"],
        uv=r["uv"],
        dp_du=frame.s,
        wi=wi,
        prim_id=torch.where(valid, r["prim"], -1),
        shape_id=torch.where(valid, r["shape_id"], -1),
        material_id=torch.where(valid, r["material_id"], -1),
        emitter_id=torch.where(valid, r["emitter_id"], -1),
    )
    return its, occ
