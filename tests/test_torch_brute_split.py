"""The port's split brute intersectors (ops/intersect.py #2 closest hit
with shading record, #3 any hit, #4 closest hit) and the brute queries
of render/intersect.py against the reference.

On the CPU each wrapper runs its kernel's plain PyTorch version; these
tests hold that version against the TPU kernel itself, run in Pallas
interpret mode, on config-1 camera rays and on seeded random rays with
dead lanes (maxt = -1) and an exact tie (a duplicated triangle, which the
lower index must win). Prim ids, ids and occlusion must be equal; t
within 1e-6 relative; the barycentrics and the record's normals and uv
within 1e-5 absolute. XLA contracts the kernel's float32 products into
FMAs, which moves the last bits, and where the terms of a dot product
cancel (u and v near an edge, interpolated normals) those bits become
1e-6 to 1e-5 of the result; normals also pass through the reference's
rsqrt.
"""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.ops import intersect_pallas as jip
from mitsuba_tpu.render.intersect import build_geometry as j_build
from mitsuba_tpu.render.scene import cornell_box as jax_cornell_box
from mitsuba_tpu_torch.core import math as m
from mitsuba_tpu_torch.integrators.path import PathConfig, camera_wavefront
from mitsuba_tpu_torch.interop import from_jax_scene
from mitsuba_tpu_torch.ops import intersect as ip
from mitsuba_tpu_torch.render import intersect as ri
from mitsuba_tpu_torch.render.mesh import make_quad
from mitsuba_tpu_torch.render.records import Ray
from mitsuba_tpu_torch.render.scene import cornell_box

torch.set_num_threads(1)
RTOL_T, ATOL = 1e-6, 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _random_tables(seed=0, t=8):
    """t random triangles, an exact duplicate of triangle 1 and a
    degenerate one (det = 0), as the port's and the reference's tables."""
    rng = np.random.default_rng(seed)
    v = rng.uniform(-1.0, 1.0, (t, 3, 3)).astype(np.float32)
    v[:, :, 2] += np.linspace(0.0, 1.4, t, dtype=np.float32)[:, None]
    v[2] = v[1]                                   # duplicate
    v[3, 2] = 0.5 * (v[3, 0] + v[3, 1])           # degenerate
    n = rng.normal(size=(t, 3, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    uv = rng.uniform(0.0, 1.0, (t, 3, 2)).astype(np.float32)
    g = dict(v0=v[:, 0], e1=v[:, 1] - v[:, 0], e2=v[:, 2] - v[:, 0],
             n0=n[:, 0], n1=n[:, 1], n2=n[:, 2],
             uv0=uv[:, 0], uv1=uv[:, 1], uv2=uv[:, 2],
             material_id=np.arange(t, dtype=np.int32) % 3,
             emitter_id=np.where(np.arange(t) % 4 == 1, 0, -1)
             .astype(np.int32),
             shape_id=np.arange(t, dtype=np.int32) + 10)
    return SimpleNamespace(**{k: jnp.asarray(x) for k, x in g.items()})


def _random_rays(geom, seed, n):
    """Rays from below at random points of random triangles, every 7th
    lane dead (maxt = -1), a tenth with a finite maxt."""
    rng = np.random.default_rng(seed)
    v0, e1, e2 = (np.asarray(x) for x in (geom.v0, geom.e1, geom.e2))
    tri = rng.integers(0, v0.shape[0], n)
    b = rng.dirichlet((1.0, 1.0, 1.0), n).astype(np.float32)
    target = v0[tri] + b[:, 1:2] * e1[tri] + b[:, 2:3] * e2[tri]
    target += rng.normal(scale=0.05, size=(n, 3)).astype(np.float32)
    o = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    o[:, 2] -= 3.0
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    mint = np.full(n, 1e-4, np.float32)
    maxt = np.full(n, np.inf, np.float32)
    maxt[3::10] = 3.0
    maxt[::7] = -1.0
    return o, d.astype(np.float32), mint, maxt


def _camera_rays(n_px=8, spp=4):
    """Config-1 camera rays (the camera wavefront of `render`)."""
    js = jax_cornell_box(n_px, n_px)
    ray = camera_wavefront(from_jax_scene(js, device="cpu"),
                           PathConfig(spp=spp))[0]
    return js.geom, tuple(x.contiguous().numpy()
                          for x in (ray.o, ray.d, ray.mint, ray.maxt))


CASES = ["random", "camera"]


def _case(name):
    """(geometry, rays) of a case: 400 seeded random rays at the random
    table, or config-1 camera rays at the Cornell box."""
    if name == "camera":
        return _camera_rays()
    g = _random_tables()
    return g, _random_rays(g, 1, 400)


@pytest.fixture(autouse=True)
def _rolled_tpu_kernels(monkeypatch):
    """The TPU kernels unroll their triangle loop up to 128 triangles,
    which costs seconds of compile time in interpret mode; the rolled
    fori_loop computes the same (monkeypatched for these tests; nothing in
    the package changes)."""
    monkeypatch.setattr(jip, "_UNROLL_LIMIT", 0)


@pytest.mark.parametrize("case", CASES)
def test_closest_ref_matches_interpreted_tpu_kernel(case):
    geom, rays = _case(case)
    jtable = jip.make_tri_table(geom.v0, geom.e1, geom.e2)
    t, u, v, prim, valid = ip.closest_hit(_t(jtable), *map(_t, rays))
    rt, ru, rv, rprim, rvalid = jip.closest_hit(jtable, *rays,
                                                interpret=True)
    np.testing.assert_array_equal(prim.numpy(), np.asarray(rprim))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(rvalid))
    hit = valid.numpy()
    assert 0.2 < hit.mean() < 1.0
    np.testing.assert_allclose(t.numpy()[hit], np.asarray(rt)[hit],
                               rtol=RTOL_T, atol=0)
    for a, b in ((u, ru), (v, rv)):
        np.testing.assert_allclose(a.numpy()[hit], np.asarray(b)[hit],
                                   rtol=0, atol=ATOL)
    # misses: t = inf, u = v = 0, as the kernel leaves them
    assert np.isinf(t.numpy()[~hit]).all()
    assert (u.numpy()[~hit] == 0).all() and (v.numpy()[~hit] == 0).all()
    if case == "random":
        p = prim.numpy()
        assert (p[::7] == -1).all()                       # dead lanes
        assert (p == 1).any() and not (p == 2).any()      # tie: lower index
        assert not (p == 3).any()                         # degenerate


@pytest.mark.parametrize("case", CASES)
def test_any_ref_matches_interpreted_tpu_kernel(case):
    geom, rays = _case(case)
    jtable = jip.make_tri_table(geom.v0, geom.e1, geom.e2)
    occ = ip.any_hit(_t(jtable), *map(_t, rays))
    ref = jip.any_hit(jtable, *rays, interpret=True)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(ref))
    assert 0 < int(occ.sum()) < occ.numel()
    if case == "random":
        assert not occ.numpy()[::7].any()


@pytest.mark.parametrize("case", CASES)
def test_shaded_ref_matches_interpreted_tpu_kernel(case):
    geom, rays = _case(case)
    jtable = jip.make_shading_table(geom)
    rec = ip.closest_hit_shaded(_t(jtable), *map(_t, rays))
    ref = jip.closest_hit_shaded(jtable, *rays, interpret=True)
    for k in ("prim", "valid", "material_id", "emitter_id", "shape_id"):
        np.testing.assert_array_equal(rec[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    hit = rec["valid"].numpy()
    np.testing.assert_allclose(rec["t"].numpy()[hit],
                               np.asarray(ref["t"])[hit], rtol=RTOL_T, atol=0)
    for k in ("u", "v"):
        np.testing.assert_allclose(rec[k].numpy()[hit],
                                   np.asarray(ref[k])[hit], rtol=0,
                                   atol=ATOL, err_msg=k)
    for k in ("geo_n", "sh_n", "uv"):
        np.testing.assert_allclose(rec[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=ATOL, err_msg=k)
    # the same lanes as #1's closest half, bit for bit
    fused, _ = ip.closest_hit_shaded_and_any(
        _t(jtable), *map(_t, rays), *map(_t, rays))
    for k in rec:
        assert torch.equal(rec[k], fused[k]), k


def test_tri_table_equals_reference():
    js = jax_cornell_box(8, 8)
    port = from_jax_scene(js, device="cpu").geom
    table = ip.make_tri_table(port.v0, port.e1, port.e2)
    ref = np.asarray(jip.make_tri_table(js.geom.v0, js.geom.e1, js.geom.e2))
    assert table.shape == (32, ip.TRI_COLS) and table.is_contiguous()
    np.testing.assert_array_equal(table.numpy(), ref)


@pytest.mark.parametrize("meshes", ["cornell", "offset_quads"])
def test_brute_root_box_equals_reference(meshes):
    """The brute backend's one-leaf BVH: its root box is the bounds of
    every vertex (render/intersect.py:261-271), built by each package
    from the same shapes, and carried over by from_jax_scene."""
    if meshes == "cornell":
        jg = jax_cornell_box(4, 4).geom
        tg = cornell_box(4, 4, device="cpu").geom
        conv = from_jax_scene(jax_cornell_box(4, 4), device="cpu").geom
        assert torch.equal(conv.bvh_min, tg.bvh_min)
        assert torch.equal(conv.bvh_max, tg.bvh_max)
    else:
        quads = [make_quad([-1, -2, 0.5], [3, -2, 0.5], [3, 1, 0.5],
                           [-1, 1, 0.5]),
                 make_quad([0, 0, -4], [0, 5, -4], [0, 5, 7], [0, 0, 7])]
        items = [(q, k, -1) for k, q in enumerate(quads)]
        jg = j_build(items, backend="brute")
        tg = ri.build_geometry(items, backend="brute")
    assert tg.backend == jg.backend == "brute"
    assert tg.bvh_min.shape == (1, 3) and tg.bvh_packed is None
    for k in ("bvh_min", "bvh_max"):
        np.testing.assert_array_equal(getattr(tg, k).numpy(),
                                      np.asarray(getattr(jg, k)), err_msg=k)


def test_brute_queries_build_the_kernel_path_record():
    """ray_intersect and ray_test on the brute backend: #2's record with
    the reference kernel path's frame (Frame.from_normal of sh_n, dp_du
    its s axis), prim -1 and a finite position on a miss; #3's occlusion
    equal to #1's shadow half on the same rays."""
    scene = from_jax_scene(jax_cornell_box(8, 8), device="cpu")
    geom, rays = _case("camera")
    ray = Ray(*map(_t, rays))
    ray.maxt[::5] = -1.0
    its = ri.ray_intersect(scene.geom, ray)
    ref, occ_ref = ip.closest_hit_shaded_and_any(
        ip.make_shading_table(scene.geom), *(x.contiguous() for x in (
            ray.o, ray.d, ray.mint, ray.maxt)), *(x.contiguous() for x in (
                ray.o, ray.d, ray.mint, ray.maxt)))
    assert torch.equal(its.valid, ref["valid"])
    assert torch.equal(its.prim_id, ref["prim"])
    assert (its.prim_id[::5] == -1).all() and torch.isinf(its.t[::5]).all()
    assert torch.isfinite(its.p).all()
    frame = m.Frame.from_normal(ref["sh_n"])
    assert torch.equal(its.dp_du, frame.s)
    assert torch.equal(its.wi, frame.to_local(-ray.d))
    occ = ri.ray_test(scene.geom, ray)
    assert torch.equal(occ, occ_ref)
    its2, occ2 = ri.ray_intersect_and_test(scene.geom, ray, ray)
    for f in ("t", "p", "wi", "dp_du", "material_id"):
        assert torch.equal(getattr(its, f), getattr(its2, f)), f
    assert torch.equal(occ, occ2)


def test_split_wrappers_reject_what_the_kernels_do_not_take():
    geom, rays = _case("random")
    tri = _t(jip.make_tri_table(geom.v0, geom.e1, geom.e2))
    shd = _t(jip.make_shading_table(geom))
    args = list(map(_t, rays))
    before = dict(ip.SPLIT_LAUNCHES)
    for fn, table, other in ((ip.closest_hit, tri, shd),
                             (ip.any_hit, tri, shd),
                             (ip.closest_hit_shaded, shd, tri)):
        with pytest.raises(ValueError):
            fn(other, *args)                       # the other layout
        with pytest.raises(TypeError):
            fn(table.double(), *args)
        with pytest.raises(ValueError):
            fn(table, args[0].t().contiguous().t(), *args[1:])
        with pytest.raises(ValueError):
            fn(table, *args[:3], args[3][:8])
        with pytest.raises(ValueError):
            fn(table[:0], *args)                   # empty table
        with pytest.raises(NotImplementedError):
            fn(table.to("meta"), *[a.to("meta") for a in args])
    assert ip.SPLIT_LAUNCHES == before    # the CPU path never counts one


def test_brute_tables_are_built_once_per_geometry(monkeypatch):
    """The brute queries' tables, the (T, 29) shading table and the
    (T, 9) table, equal the reference's and are built once per
    GeometryTables: a render's queries reuse them, and tables moved to
    another device (a new GeometryTables) build their own."""
    js = jax_cornell_box(8, 8)
    geom = from_jax_scene(js, device="cpu").geom
    built = []
    for name in ("make_shading_table", "make_tri_table"):
        orig = getattr(ip, name)
        monkeypatch.setattr(ip, name, lambda *a, _f=orig, _n=name: (
            built.append(_n), _f(*a))[1])
    shd, tri = geom.brute_tables
    np.testing.assert_array_equal(
        shd.numpy(), np.asarray(jip.make_shading_table(js.geom)))
    np.testing.assert_array_equal(tri.numpy(), np.asarray(
        jip.make_tri_table(js.geom.v0, js.geom.e1, js.geom.e2)))
    _geom, rays = _case("camera")
    ray = Ray(*map(_t, rays))
    for _ in range(2):
        ri.ray_intersect(geom, ray)
        ri.ray_test(geom, ray)
        ri.ray_intersect_and_test(geom, ray, ray)
    assert built == ["make_shading_table", "make_tri_table"]
    assert geom.brute_tables[0] is shd and geom.brute_tables[1] is tri
    moved = geom.to("cpu")
    assert moved.brute_tables[0] is not shd
    assert torch.equal(moved.brute_tables[0], shd)
    assert built == ["make_shading_table", "make_tri_table"] * 2
