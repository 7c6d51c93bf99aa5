"""The port's cluster backend (render/intersect.py, ops/exact.py) against
the JAX package on the bench config-3 geometry: the sphere-fallback mesh
of textured_mesh_scene (101,762 triangles, 16,832 K8 clusters), where the
root level holds more boxes than E0, so every query runs the
conservative S0 cull and the S1 refine.

* The cluster tables the port builds are equal to the reference's, array
  for array (bytes), on a 2,210-triangle scene and on config 3.
* The exact build (ids, block keys, overflow flags) equals the
  reference's XLA build (`build_exact_items(use_kernel=False)`; the
  Pallas build in interpret mode would take minutes at this size, and
  tests/test_torch_exact.py holds the kernels against it on a small
  scene).
* The full queries, including the XL re-run and the stream fallback
  (forced with tiny caps), equal the reference's CPU walk of the same
  tables: hits, prims and occlusion on every lane, t within 1e-5.
* The hit record of `ray_intersect` equals the reference's generic tail
  within 1e-5 on the fields (1e-4 on wi, whose frame is derived from the
  normal and the uv tangent).

Rays: 256 lanes (two rows), config-3 camera rays and diffuse-like rays
from the sphere, made with numpy from fixed seeds.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.ops import exact_pallas as jep
from mitsuba_tpu.ops.worklist_pallas import _pack_rays as jax_pack_rays
from mitsuba_tpu.render import intersect as jri
from mitsuba_tpu.render.mesh import make_quad, make_sphere_mesh
from mitsuba_tpu.render.records import Ray as JaxRay
from mitsuba_tpu_torch.ops import exact as ep
from mitsuba_tpu_torch.ops import stream as sp
from mitsuba_tpu_torch.ops.rows import pack_rays
from mitsuba_tpu_torch.render import intersect as ri
from mitsuba_tpu_torch.render.records import Ray
from test_torch_exact import small_scene

torch.set_num_threads(1)
TINY = (128, 16, 16, 16)          # overflow-forcing caps
TINY_XL = (128, 16, 32, 32)


def config3_meshes():
    """textured_mesh_scene's shapes: phong body (material 1, shape 0) and
    the checkerboard floor (material 0, shape 1)."""
    return [(make_sphere_mesh([0, 0.8, 0], 0.8, 160, 320), 1, -1, 0),
            (make_quad([-6, 0, -6], [-6, 0, 6], [6, 0, 6], [6, 0, -6]),
             0, -1, 1)]


@pytest.fixture(scope="module")
def geoms():
    meshes = config3_meshes()
    return (jri.build_geometry(meshes, backend="cluster"),
            ri.build_geometry(meshes, backend="cluster"))


def _rays(kind, n=256, seed=0):
    """'camera': from the config-3 eye through the image; 'bounce': from
    points on the sphere, in random outward directions, maxt infinite."""
    rng = np.random.default_rng(seed)
    if kind == "camera":
        o = np.tile(np.array([[0.0, 1.4, -3.2]], np.float32), (n, 1))
        tgt = np.stack([rng.uniform(-1.2, 1.2, n), rng.uniform(-0.3, 1.8, n),
                        np.zeros(n)], -1).astype(np.float32)
        d = tgt - o
    else:
        nrm = rng.normal(size=(n, 3))
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
        o = (np.array([0, 0.8, 0]) + 0.8 * nrm).astype(np.float32)
        d = nrm + rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    mint = np.full(n, 1e-4, np.float32)
    maxt = np.full(n, np.inf, np.float32)
    maxt[::9] = -1.0
    return o, d, mint, maxt


def _bytes(x):
    x = np.ascontiguousarray(np.asarray(x))
    return x.view(np.uint8)


def _tables(g, jax_side):
    out = {k: getattr(g, k) for k in (
        "v0", "e1", "e2", "n0", "n1", "n2", "uv0", "uv1", "uv2",
        "material_id", "emitter_id", "shape_id", "bvh_min", "bvh_max",
        "shade_pack", "ex_tri", "ex_b0lo", "ex_b0hi", "ex_b1lo", "ex_b1hi",
        "ex_b2lo", "ex_b2hi", "ex_ct0", "ex_ct1", "ex_ct2")}
    out.update({f"st_{k}": v for k, v in g.st_tables.items()})
    if not jax_side:
        out = {k: v.numpy() for k, v in out.items()}
    return out


def test_geometry_matches_reference_small():
    meshes = small_scene()
    jg = jri.build_geometry(meshes, backend="cluster")
    tg = ri.build_geometry(meshes, backend="cluster")
    a, b = _tables(jg, True), _tables(tg, False)
    for k in a:
        assert np.array_equal(_bytes(a[k]), _bytes(b[k])), k
    assert tg.ex_caps == jg.ex_caps


def test_geometry_matches_reference_config3(geoms):
    jg, tg = geoms
    assert tg.n_tris == 101762 and tg.ex_tri.shape[0] == 16832
    # more root boxes than E0: S0 and S1 run on every query
    assert tg.ex_ct2.shape[0] * 8 > tg.ex_caps[0][0]
    a, b = _tables(jg, True), _tables(tg, False)
    for k in a:
        assert np.array_equal(_bytes(a[k]), _bytes(b[k])), k
    assert tg.ex_caps == jg.ex_caps


@pytest.mark.parametrize("kind,tier", [("camera", 1), ("bounce", 0)])
def test_build_matches_reference(geoms, kind, tier):
    """Coherent caps on camera rays, diffuse caps on bounce rays."""
    jg, tg = geoms
    caps = tg.ex_caps[tier]
    o, d, mint, maxt = _rays(kind)
    maxt = np.minimum(maxt, 1e30)
    jr = jax_pack_rays(*[jnp.asarray(x) for x in (o, d, mint, maxt)])[0]
    tr = pack_rays(*[torch.from_numpy(x) for x in (o, d, mint, maxt)])[0]
    ids_r, blk_r, ovf_r = (np.asarray(x) for x in jep.build_exact_items(
        jr, jg.ex_tables, caps, use_kernel=False))
    ids, blk, ovf = ep.build_exact_items(tr, tg.ex_tables, caps)
    assert np.array_equal(ids.numpy(), ids_r)
    assert np.array_equal(blk.numpy(), blk_r)
    assert np.array_equal(ovf.numpy(), ovf_r)
    assert (ids_r > 0).sum() > 20


def _count_calls(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def spy(*args, **kw):
        calls.append(1)
        return fn(*args, **kw)

    monkeypatch.setattr(module, name, spy)
    return calls


def _reference_walk(jg, o, d, mint, maxt, any_hit):
    ray = JaxRay(*[jnp.asarray(x) for x in (o, d, mint, maxt)])
    if any_hit:
        return np.asarray(jri._any_bvh_unrolled(jg, ray))
    return [np.asarray(x) for x in jri._closest_bvh_unrolled(jg, ray)]


@pytest.mark.parametrize("caps", ["auto", "tiny"])
def test_closest_query_matches_reference_walk(geoms, monkeypatch, caps):
    """Tiny caps overflow most rows: the XL re-run and the stream
    fallback must then resolve them completely."""
    jg, tg = geoms
    if caps == "tiny":
        tg = dataclasses.replace(tg, ex_caps=(TINY, TINY, TINY_XL))
    retier = _count_calls(monkeypatch, ri, "_retier_closest")
    stream = _count_calls(monkeypatch, sp, "stream_closest")
    o, d, mint, maxt = _rays("bounce", seed=3)
    its = ri.ray_intersect(tg, Ray(*[torch.from_numpy(x)
                                     for x in (o, d, mint, maxt)]))
    t0, _u0, _v0, p0, ok0 = _reference_walk(jg, o, d, mint, maxt, False)
    assert np.array_equal(its.valid.numpy(), ok0)
    assert ok0.sum() > 50
    assert (its.prim_id.numpy()[ok0] == p0[ok0]).mean() >= 0.99
    np.testing.assert_allclose(its.t.numpy()[ok0], t0[ok0], rtol=1e-5,
                               atol=1e-5)
    if caps == "tiny":
        assert retier and stream


@pytest.mark.parametrize("caps", ["auto", "tiny"])
def test_any_query_matches_reference_walk(geoms, monkeypatch, caps):
    jg, tg = geoms
    if caps == "tiny":
        tg = dataclasses.replace(tg, ex_caps=(TINY, TINY, TINY_XL))
    retier = _count_calls(monkeypatch, ri, "_retier_any")
    stream = _count_calls(monkeypatch, sp, "stream_any")
    o, d, mint, maxt = _rays("bounce", seed=4)
    maxt = np.where(maxt > 0, np.float32(2.5), maxt).astype(np.float32)
    occ = ri.ray_test(tg, Ray(*[torch.from_numpy(x)
                                for x in (o, d, mint, maxt)]))
    occ_ref = _reference_walk(jg, o, d, mint, maxt, True)
    assert np.array_equal(occ.numpy(), occ_ref)
    assert 20 < occ_ref.sum() < 240
    if caps == "tiny":
        assert retier and stream


def test_hit_record_matches_reference_tail(geoms):
    """Generic tail (intersect.py:1359-1481): Frame.from_normal_tangent of
    the shading normal and the uv tangent, not the brute path's frame."""
    jg, tg = geoms
    o, d, mint, maxt = _rays("camera", seed=5)
    its = ri.ray_intersect(tg, Ray(*[torch.from_numpy(x)
                                     for x in (o, d, mint, maxt)]),
                           coherent=True)
    ref = jri._ray_intersect_tri(
        jg, JaxRay(*[jnp.asarray(x) for x in (o, d, mint, maxt)]))
    ok = np.asarray(ref.valid)
    assert np.array_equal(its.valid.numpy(), ok) and ok.sum() > 100
    for k in ("prim_id", "material_id", "shape_id", "emitter_id"):
        assert (getattr(its, k).numpy() == np.asarray(getattr(ref, k))) \
            .mean() >= 0.99, k
    same = ok & (its.prim_id.numpy() == np.asarray(ref.prim_id))
    for k, tol in (("t", 1e-5), ("p", 1e-5), ("geo_n", 1e-5),
                   ("sh_n", 1e-5), ("uv", 1e-5), ("dp_du", 1e-4),
                   ("wi", 1e-4)):
        np.testing.assert_allclose(getattr(its, k).numpy()[same],
                                   np.asarray(getattr(ref, k))[same],
                                   rtol=tol, atol=tol, err_msg=k)
