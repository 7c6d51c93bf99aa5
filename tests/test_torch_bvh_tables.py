"""The BVH kernel's 16-byte tables (ops/bvh.py `align_tables`), on the CPU.

The kernel (#11) reads the (M, 9) node and (T, 9) triangle tables as
nodes (M, 8) bmin | skip, bmax | first * 8 + count (ints as int32 bits)
and triangles (T, 12) v0 | e1 | e2, each padded to four floats; the
geometry builds them once, beside the others. Here they decode to the
(M, 9) and (T, 9) tables bit for bit on the bvh scene, on an instanced
scene's static triangles and its group, and through `from_jax_scene`; a
table the packing cannot hold raises. Also what the kernel cases of
tests/torch_instanced_cases.py plant: equal t in two leaves, a leaf
reaching past the last triangle, and a few lanes walking far longer
than the rest.
"""
import numpy as np
import pytest
import torch

import torch_instanced_cases as ic
from mitsuba_tpu_torch.ops import bvh as bp

torch.set_num_threads(1)


def _bits(x):
    return x.contiguous().view(torch.int32)


def _unalign(nodes_a, tris_a):
    """The (M, 9) and (T, 9) tables that `align_tables` packed."""
    skip = _bits(nodes_a[:, 3])
    leaf = _bits(nodes_a[:, 7])
    ints = torch.stack([leaf >> 3, leaf & 7, skip], dim=1).to(torch.float32)
    nodes = torch.cat([nodes_a[:, 0:3], nodes_a[:, 4:7], ints], dim=1)
    tris = torch.cat([tris_a[:, 4 * j:4 * j + 3] for j in range(3)], dim=1)
    return nodes, tris


def _decodes(geom):
    na, ta = geom.bvh_aligned, geom.tri_aligned
    assert na.dtype == ta.dtype == torch.float32
    assert tuple(na.shape) == (geom.bvh_packed.shape[0], 8)
    assert tuple(ta.shape) == (geom.tri_packed.shape[0], 12)
    nodes, tris = _unalign(na, ta)
    assert torch.equal(_bits(nodes), _bits(geom.bvh_packed))
    assert torch.equal(_bits(tris), _bits(geom.tri_packed))
    assert bool((ta[:, 3::4] == 0).all())


@pytest.mark.parametrize("scene", ["bvh", "instanced"])
def test_aligned_tables_decode_exactly(scene):
    from mitsuba_tpu_torch.render.scene import (
        instanced_scene, textured_mesh_scene,
    )

    if scene == "bvh":
        geom = textured_mesh_scene(8, 8, device="cpu").geom
        assert geom.backend == "bvh" and geom.n_tris > 100_000
        _decodes(geom)
        return
    geom = instanced_scene(8, 8, 10, 20, device="cpu").geom
    assert geom.inst_groups
    for g in (geom,) + tuple(geom.inst_groups):
        _decodes(g)


def test_interop_builds_the_aligned_tables():
    from mitsuba_tpu.render.scene import textured_mesh_scene as jax_tms
    from mitsuba_tpu_torch.interop import from_jax_scene

    _decodes(from_jax_scene(jax_tms(8, 8), device="cpu").geom)


def test_align_tables_rejects_what_it_cannot_pack():
    nodes, tris = ic.bvh_cases()["leaves"][:2]
    bad = nodes.clone()
    bad[2, 7] = 8.0                       # a count past 3 bits
    with pytest.raises(ValueError):
        bp.align_tables(bad, tris)
    bad = nodes.clone()
    bad[1, 6] = 0.5                       # not an int
    with pytest.raises(ValueError):
        bp.align_tables(bad, tris)
    bad = nodes.clone()
    bad[3, 6] = float(1 << 28)            # first past 28 bits
    with pytest.raises(ValueError):
        bp.align_tables(bad, tris)


def test_bvh_cases_plant_what_they_claim():
    cases = ic.bvh_cases()
    nodes, tris, o, d, mint, maxt = cases["leaves"]
    prim = bp.walk_ref(nodes, tris, o, d, mint, maxt, False)[3]
    # tri 5 is tri 1 in the next leaf: equal t, the first kept; the last
    # leaf's k = 2, 3 test min(first + k, T - 1) = 9
    assert int((prim == 1).sum()) > 100 and int((prim == 5).sum()) == 0
    assert int((prim == 9).sum()) > 100
    assert int(nodes[4, 6] + nodes[4, 7]) > tris.shape[0]
    assert float((d == 0).any(dim=1).float().mean()) > 0.5
    nodes, tris, o, d, mint, maxt = cases["tail"]
    lane = torch.arange(o.shape[0])
    long_ = lane % 500 == 7
    steps = {}
    for name, sel in (("long", long_), ("rest", ~long_ & (maxt >= mint))):
        work = {}
        bp.walk_ref(nodes, tris, o[sel], d[sel], mint[sel], maxt[sel],
                    False, work=work)
        steps[name] = work["box_tests"] / int(sel.sum())
    assert steps["long"] > 20 * steps["rest"], steps
    assert steps["long"] > 0.5 * nodes.shape[0]
    assert np.isfinite(steps["rest"])
