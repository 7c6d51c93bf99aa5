"""Triangle meshes as numpy arrays, and procedural geometry (the port's own
copy of mitsuba_tpu/render/mesh.py; host numpy, no torch).

`TriMesh` is an indexed triangle soup with optional shading normals and
uvs. The procedural shapes the port's scenes and tests use (`make_quad`,
`make_box`, `make_sphere_mesh`, `merge`) give the same arrays as the
reference's, so both packages build the same scenes from the same calls.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class TriMesh:
    vertices: np.ndarray                 # (V, 3) float32
    faces: np.ndarray                    # (F, 3) int32
    normals: Optional[np.ndarray] = None  # (V, 3) shading normals
    uvs: Optional[np.ndarray] = None      # (V, 2)
    name: str = "mesh"

    @property
    def n_faces(self):
        return self.faces.shape[0]

    def face_normals(self):
        v = self.vertices
        f = self.faces
        e1 = v[f[:, 1]] - v[f[:, 0]]
        e2 = v[f[:, 2]] - v[f[:, 0]]
        n = np.cross(e1, e2)
        norm = np.linalg.norm(n, axis=-1, keepdims=True)
        return n / np.maximum(norm, 1e-20)

    def face_areas(self):
        v = self.vertices
        f = self.faces
        e1 = v[f[:, 1]] - v[f[:, 0]]
        e2 = v[f[:, 2]] - v[f[:, 0]]
        return 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)

    def compute_vertex_normals(self):
        """Area-weighted vertex normals (reference trimesh.cpp
        computeNormals)."""
        fn = self.face_normals() * self.face_areas()[:, None]
        n = np.zeros_like(self.vertices)
        for k in range(3):
            np.add.at(n, self.faces[:, k], fn)
        norm = np.linalg.norm(n, axis=-1, keepdims=True)
        self.normals = (n / np.maximum(norm, 1e-20)).astype(np.float32)
        return self

    def transformed(self, mat4: np.ndarray) -> "TriMesh":
        """The mesh under a 4x4 affine map; normals by the inverse
        transpose, uvs kept."""
        mat4 = np.asarray(mat4, np.float64)
        v = self.vertices @ mat4[:3, :3].T + mat4[:3, 3]
        out = TriMesh(v.astype(np.float32), self.faces.copy(), name=self.name)
        if self.normals is not None:
            inv_t = np.linalg.inv(mat4[:3, :3]).T
            n = self.normals @ inv_t.T
            n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
            out.normals = n.astype(np.float32)
        if self.uvs is not None:
            out.uvs = self.uvs.copy()
        return out


def make_quad(p0, p1, p2, p3, name="quad") -> TriMesh:
    """Two-triangle quad; vertices CCW as seen from the normal side."""
    v = np.asarray([p0, p1, p2, p3], np.float32)
    f = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    uv = np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    return TriMesh(v, f, uvs=uv, name=name)


def make_box(pmin, pmax, name="box") -> TriMesh:
    """Axis-aligned box with outward normals."""
    x0, y0, z0 = pmin
    x1, y1, z1 = pmax
    quads = [
        make_quad([x0, y0, z0], [x0, y1, z0], [x1, y1, z0], [x1, y0, z0]),
        make_quad([x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1]),
        make_quad([x0, y0, z0], [x1, y0, z0], [x1, y0, z1], [x0, y0, z1]),
        make_quad([x0, y1, z0], [x0, y1, z1], [x1, y1, z1], [x1, y1, z0]),
        make_quad([x0, y0, z0], [x0, y0, z1], [x0, y1, z1], [x0, y1, z0]),
        make_quad([x1, y0, z0], [x1, y1, z0], [x1, y1, z1], [x1, y0, z1]),
    ]
    return merge(quads, name=name)


def merge(meshes, name="merged") -> TriMesh:
    """One mesh of several; normals and uvs kept where every mesh has
    them."""
    vs, fs, ns, uvs = [], [], [], []
    off = 0
    has_n = all(m.normals is not None for m in meshes)
    has_uv = all(m.uvs is not None for m in meshes)
    for msh in meshes:
        vs.append(msh.vertices)
        fs.append(msh.faces + off)
        if has_n:
            ns.append(msh.normals)
        if has_uv:
            uvs.append(msh.uvs)
        off += msh.vertices.shape[0]
    return TriMesh(
        np.concatenate(vs).astype(np.float32),
        np.concatenate(fs).astype(np.int32),
        normals=np.concatenate(ns).astype(np.float32) if has_n else None,
        uvs=np.concatenate(uvs).astype(np.float32) if has_uv else None,
        name=name,
    )


def make_sphere_mesh(center, radius, n_theta=32, n_phi=64,
                     name="sphere") -> TriMesh:
    """Lat-long tessellated sphere with exact shading normals; the
    zero-area triangles at the poles are left out."""
    th = np.linspace(0, np.pi, n_theta + 1)
    ph = np.linspace(0, 2 * np.pi, n_phi + 1)
    tt, pp = np.meshgrid(th, ph, indexing="ij")
    x = np.sin(tt) * np.cos(pp)
    y = np.sin(tt) * np.sin(pp)
    z = np.cos(tt)
    n = np.stack([x, y, z], -1).reshape(-1, 3)
    v = np.asarray(center) + radius * n
    uv = np.stack([pp / (2 * np.pi), 1.0 - tt / np.pi], -1).reshape(-1, 2)
    faces = []
    w = n_phi + 1
    for i in range(n_theta):
        for j in range(n_phi):
            a, b, c, d = (i * w + j, i * w + j + 1, (i + 1) * w + j + 1,
                          (i + 1) * w + j)
            if i < n_theta - 1:
                faces.append([a, d, c])
            if i > 0:
                faces.append([a, c, b])
    return TriMesh(
        v.astype(np.float32),
        np.asarray(faces, np.int32),
        normals=n.astype(np.float32),
        uvs=uv.astype(np.float32),
        name=name,
    )

