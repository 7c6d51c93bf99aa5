"""Hair fibres tessellated into tubes, and height-span maps (port of
mitsuba_tpu/io/hairio.py `load_hair`, `tessellate_fiber`, `load_hspan`;
host numpy, each a TriMesh).

  * src/shapes/hair.cpp:501: mitsuba hair files, one "x y z" vertex a
    line, a blank line between fibres, swept with a radius. The
    reference intersects the swept volume analytically; under
    `tessellate="true"` a fibre becomes a generalized cylinder (a tube of
    `n_sides` sides on rotation-minimizing frames), whose triangles
    traverse the same kernels as every other mesh. (The analytic fibre,
    the reference's default, is not ported: ROADMAP A.12.)
  * src/shapes/hspan.cpp:1197 (the fork's own shape): .hspans1/.hspans2
    height-span maps, per-cell lists of [h1, h2] vertical spans, used for
    snow surfaces; the top surface is triangulated by joining each span's
    top to the nearest span tops of the +x, +y and +xy cells (the
    reference's triangulation loop, hspan.cpp:814). Cells are visited in
    the file's order, so the vertices and faces come out in the
    reference's order.
"""
from __future__ import annotations

import numpy as np

from mitsuba_tpu_torch.render.mesh import TriMesh, merge


def load_hair(path: str, radius: float = 0.05, n_sides: int = 6,
              name: str | None = None) -> TriMesh:
    """Load a mitsuba hair file and tessellate fibers into tubes."""
    fibers = []
    cur = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                if len(cur) >= 2:
                    fibers.append(np.asarray(cur, np.float64))
                cur = []
                continue
            cur.append([float(x) for x in line.split()[:3]])
    if len(cur) >= 2:
        fibers.append(np.asarray(cur, np.float64))
    meshes = [tessellate_fiber(fb, radius, n_sides) for fb in fibers]
    if not meshes:
        raise ValueError(f"{path}: no fibers found")
    out = merge(meshes, name=name or path)
    return out


def tessellate_fiber(points: np.ndarray, radius: float, n_sides: int = 6) -> TriMesh:
    """Sweep a polyline into a tube with rotation-minimizing frames."""
    p = np.asarray(points, np.float64)
    k = p.shape[0]
    t = np.diff(p, axis=0)
    t = np.concatenate([t, t[-1:]], axis=0)
    t /= np.maximum(np.linalg.norm(t, axis=-1, keepdims=True), 1e-12)
    # rotation minimizing frame (double reflection)
    frames = np.zeros((k, 2, 3))
    a = np.array([1.0, 0, 0]) if abs(t[0, 0]) < 0.9 else np.array([0, 1.0, 0])
    n0 = np.cross(t[0], a)
    n0 /= np.linalg.norm(n0)
    frames[0, 0] = n0
    frames[0, 1] = np.cross(t[0], n0)
    for i in range(1, k):
        v1 = p[i] - p[i - 1]
        c1 = max(v1 @ v1, 1e-20)
        rl = frames[i - 1, 0] - (2.0 / c1) * (v1 @ frames[i - 1, 0]) * v1
        tl = t[i - 1] - (2.0 / c1) * (v1 @ t[i - 1]) * v1
        v2 = t[i] - tl
        c2 = max(v2 @ v2, 1e-20)
        frames[i, 0] = rl - (2.0 / c2) * (v2 @ rl) * v2
        frames[i, 0] /= max(np.linalg.norm(frames[i, 0]), 1e-12)
        frames[i, 1] = np.cross(t[i], frames[i, 0])
    phi = np.linspace(0, 2 * np.pi, n_sides, endpoint=False)
    ring_dirs = (
        np.cos(phi)[None, :, None] * frames[:, 0][:, None, :]
        + np.sin(phi)[None, :, None] * frames[:, 1][:, None, :]
    )                                                    # (K, S, 3)
    verts = (p[:, None, :] + radius * ring_dirs).reshape(-1, 3)
    normals = ring_dirs.reshape(-1, 3)
    faces = []
    for i in range(k - 1):
        for j in range(n_sides):
            a0 = i * n_sides + j
            a1 = i * n_sides + (j + 1) % n_sides
            b0 = (i + 1) * n_sides + j
            b1 = (i + 1) * n_sides + (j + 1) % n_sides
            faces.append([a0, b0, b1])
            faces.append([a0, b1, a1])
    return TriMesh(
        verts.astype(np.float32), np.asarray(faces, np.int32),
        normals=normals.astype(np.float32), name="fiber",
    )


# ---------------------------------------------------------------------------
# Height-span maps (.hspans1 / .hspans2)
# ---------------------------------------------------------------------------

def load_hspan(path: str, cell_size: float = 1.0, name: str | None = None) -> TriMesh:
    """Parse a height-span-map file and triangulate the top surface.

    Format (version 2, hspan.cpp:440-520): lines of
      x y  (h1 h2 d0 i0 d1 i1 d2 i2 d3 i3)*
    i.e. cell coordinates followed by 10 numbers per span element.
    Version 1 files carry just `x y h1 h2` per line.
    """
    cells: dict = {}
    version = 2 if path.endswith("2") else 1
    with open(path) as f:
        content = f.read().replace("\\\n", " ")
    for line in content.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        tok = line.split()
        try:
            x, y = int(tok[0]), int(tok[1])
        except (ValueError, IndexError):
            continue
        rest = tok[2:]
        spans = []
        if version == 2:
            per = 10
            n_el = len(rest) // per
            if len(rest) != per * n_el:
                continue
            for i in range(n_el):
                off = per * i
                h1, h2 = float(rest[off]), float(rest[off + 1])
                spans.append((h1, h2))
        else:
            for i in range(0, len(rest) - 1, 2):
                spans.append((float(rest[i]), float(rest[i + 1])))
        cells.setdefault((x, y), []).extend(spans)
    if not cells:
        raise ValueError(f"{path}: no height spans found")

    verts = []
    faces = []
    vidx = {}

    def top_vertex(x, y, span_i):
        key = (x, y, span_i)
        if key in vidx:
            return vidx[key]
        h = cells[(x, y)][span_i][1]
        vidx[key] = len(verts)
        verts.append([x * cell_size, h, y * cell_size])
        return vidx[key]

    def closest_span(x, y, h):
        """Index of the span in cell (x,y) whose top is nearest to height h."""
        sp = cells.get((x, y))
        if not sp:
            return None
        if len(sp) == 1:
            return 0
        # the first nearest, as np.argmin picks it
        tops = [abs(s[1] - h) for s in sp]
        return min(range(len(tops)), key=tops.__getitem__)

    # connect cell tops with +x/+y neighbours (two triangles per quad)
    for (x, y), spans in cells.items():
        for si, (h1, h2) in enumerate(spans):
            a = closest_span(x + 1, y, h2)
            b = closest_span(x, y + 1, h2)
            c = closest_span(x + 1, y + 1, h2)
            if a is not None and b is not None and c is not None:
                v00 = top_vertex(x, y, si)
                v10 = top_vertex(x + 1, y, a)
                v01 = top_vertex(x, y + 1, b)
                v11 = top_vertex(x + 1, y + 1, c)
                faces.append([v00, v01, v11])
                faces.append([v00, v11, v10])
    if not faces:
        raise ValueError(f"{path}: no triangles produced")
    mesh = TriMesh(
        np.asarray(verts, np.float32), np.asarray(faces, np.int32),
        name=name or path,
    )
    mesh.compute_vertex_normals()
    return mesh
