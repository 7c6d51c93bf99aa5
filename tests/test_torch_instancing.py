"""True instancing in the port against the JAX package, on the CPU: the
layout of tests/test_instancing.py (a floor, an area light, three
instances of one 10 x 20 sphere group), built by the port's SceneBuilder
and by `from_jax_scene`.

* The instanced tables of `build_geometry` (shared blocks, block ids,
  transforms, block-aligned object attributes, the instance walks' side
  tables and each group's own tables) equal the reference's, array for
  array.
* First-bounce records lane by lane against the reference's CPU query
  (which walks the static BVH and every instance exactly; the port runs
  the work-list path, plain version on the CPU), with default beams and
  with beams so small that every live row overflows and re-resolves
  through the BVH kernel and the instance walks: prims, hits, ids
  exact on >= 99% of lanes, t, p, normals, uv within 1e-5, the
  frame-derived wi and dp_du within 1e-4.
* Renders (32 x 32 px, 2 spp, depth 3, seed 0): the image against the
  JAX CPU render per pixel within 1e-4 relative on >= 99% of pixels. The
  JAX render takes ~20 s on the CPU, mostly compiling, so it is
  committed: tests/torch_goldens/instanced_32.npz, made by
  scripts/gen_torch_goldens.py. Instanced against flattened (the same
  spheres baked into world space) as tests/test_instancing.py:63-78
  holds the reference.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.render import intersect as jri
from mitsuba_tpu.render.records import Ray as JaxRay
from mitsuba_tpu_torch.integrators.path import PathConfig, render
from mitsuba_tpu_torch.interop import from_jax_scene
from mitsuba_tpu_torch.ops import worklist as wl
from mitsuba_tpu_torch.render import intersect as ri
from mitsuba_tpu_torch.render.records import Ray
from mitsuba_tpu_torch.render.scene import instanced_scene
from test_instancing import _instanced_scene

torch.set_num_threads(1)
W = H = 32
SPP, DEPTH = 2, 3

_TABLES = ("v0", "e1", "e2", "material_id", "emitter_id", "shape_id",
           "bvh_packed", "tri_packed", "shade_pack", "mt_tri", "mt_start",
           "mt_bmin", "mt_bmax", "cl_sc_bmin", "cl_sc_bmax", "mt_block_id",
           "mt_xform", "mt_xform_fwd", "obj_v0", "obj_e1", "obj_e2",
           "obj_n0", "obj_n1", "obj_n2", "obj_uv0", "obj_uv1", "obj_uv2",
           "obj_mid", "obj_sid", "inst_xf_inv")
_GROUP_TABLES = ("v0", "e1", "e2", "n0", "n1", "n2", "uv0", "uv1", "uv2",
                 "material_id", "shape_id", "bvh_packed", "tri_packed",
                 "mt_tri", "mt_start")


@pytest.fixture(scope="module")
def scenes():
    js = _instanced_scene()
    assert (js.width, js.height) == (W, H)
    return js, {"builder": instanced_scene(W, H, 10, 20, device="cpu"),
                "interop": from_jax_scene(js, device="cpu")}


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("built_by", ["builder", "interop"])
def test_instanced_tables_equal_reference(scenes, built_by):
    js, ts = scenes
    jg, tg = js.geom, ts[built_by].geom
    assert tg.has_instances and tg.backend == "cluster"
    assert tg.ex_tri is None and tg.sc_tri is None
    for k in _TABLES:
        assert _same(getattr(tg, k).numpy(), getattr(jg, k)), k
    assert tg.n_static_clusters == jg.n_static_clusters
    assert tg.inst_gid == tuple(jg.inst_gid)
    assert tg.inst_vp_base == tuple(jg.inst_vp_base)
    for a, b in zip(tg.inst_tri2virt, jg.inst_tri2virt, strict=True):
        assert _same(a.numpy(), b)
    for sa, sb in zip(tg.inst_groups, jg.inst_groups, strict=True):
        for k in _GROUP_TABLES:
            assert _same(getattr(sa, k).numpy(), getattr(sb, k)), k
    # one shared copy of the group's blocks for three instances
    assert tg.mt_tri.shape[0] < tg.mt_block_id.shape[0]


_jax_closest = jax.jit(jri._ray_intersect_tri)
_jax_any = jax.jit(jri._ray_test_tri)


def _rays(scene, n=1024, seed=2):
    """Camera rays through random film points, as numpy."""
    rng = np.random.default_rng(seed)
    uv = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    ray = scene.camera.sample_ray(torch.from_numpy(uv))
    return [x.numpy() for x in (ray.o, ray.d, ray.mint, ray.maxt)]


def _check_records(its, ref):
    ok = np.asarray(ref.valid)
    assert np.array_equal(its.valid.numpy(), ok) and ok.mean() > 0.5
    same = ok & (its.prim_id.numpy() == np.asarray(ref.prim_id))
    assert same.sum() >= 0.99 * ok.sum()
    for k, tol in (("t", 1e-5), ("p", 1e-5), ("geo_n", 1e-5),
                   ("sh_n", 1e-5), ("uv", 1e-5), ("dp_du", 1e-4),
                   ("wi", 1e-4)):
        close = np.isclose(getattr(its, k).numpy(),
                           np.asarray(getattr(ref, k)), rtol=tol,
                           atol=tol).reshape(ok.shape[0], -1).all(-1)
        assert close[same].mean() >= 0.99, k
    for k in ("material_id", "shape_id", "emitter_id"):
        assert np.array_equal(getattr(its, k).numpy()[same],
                              np.asarray(getattr(ref, k))[same]), k


@pytest.mark.parametrize("built_by", ["builder", "interop"])
@pytest.mark.parametrize("beams", ["default", "overflowing"])
def test_first_bounce_records_match(scenes, monkeypatch, built_by, beams):
    js, ts = scenes
    tg = ts[built_by].geom
    if beams == "overflowing":
        for name, value in (("W_FACTOR", 2), ("L_SC", 2), ("BEAM_S2", 1)):
            monkeypatch.setattr(wl, name, value)
    rays = _rays(ts[built_by])
    ref = _jax_closest(js.geom, JaxRay(*[jnp.asarray(x) for x in rays]))
    tray = Ray(*[torch.from_numpy(x) for x in rays])
    _check_records(ri.ray_intersect(tg, tray), ref)
    vp = np.asarray(ref.prim_id)
    assert (vp >= tg.n_tris).sum() > 100        # instanced hits
    # shadow rays from the hits toward the light
    p = np.asarray(ref.p)
    tgt = np.array([0.5, -0.3, 8.0], np.float32)
    d = tgt - p
    dist = np.linalg.norm(d, axis=1)
    srays = [p, d / dist[:, None], np.full_like(dist, 1e-3),
             np.where(np.asarray(ref.valid), dist * 0.999, -1.0)]
    srays = [np.ascontiguousarray(x, np.float32) for x in srays]
    occ_ref = np.asarray(_jax_any(
        js.geom, JaxRay(*[jnp.asarray(x) for x in srays])))
    occ = ri.ray_test(tg, Ray(*[torch.from_numpy(x) for x in srays]))
    assert (occ.numpy() == occ_ref).mean() >= 0.999
    assert 0 < occ_ref.sum() < occ_ref.size


@pytest.mark.parametrize("built_by", ["builder", "interop"])
def test_render_matches_reference_image(scenes, built_by):
    _js, ts = scenes
    reference_image = np.load(os.path.join(
        os.path.dirname(__file__), "torch_goldens", "instanced_32.npz"))["mean"]
    img = render(ts[built_by], PathConfig(max_depth=DEPTH, spp=SPP),
                 seed=0)[0].numpy()
    assert img.shape == (H, W, 3) and np.isfinite(img).all()
    close = np.isclose(img, reference_image, rtol=1e-4, atol=1e-6).all(-1)
    assert close.mean() >= 0.99, close.mean()
    np.testing.assert_allclose(img.mean(), reference_image.mean(),
                               rtol=1e-3)


def test_instanced_matches_flattened_render():
    si = instanced_scene(W, H, 10, 20, device="cpu")
    sf = instanced_scene(W, H, 10, 20, flatten=True, device="cpu")
    assert sf.geom.backend == "cluster" and not sf.geom.has_instances
    assert si.geom.mt_tri.shape[0] < sf.geom.mt_tri.shape[0]
    cfg = PathConfig(max_depth=DEPTH, spp=4)
    img_i = render(si, cfg, seed=3)[0].numpy()
    img_f = render(sf, cfg, seed=3)[0].numpy()
    assert np.isfinite(img_i).all()
    # same scene, same sampler streams: pixels agree up to the
    # object-space vs baked-world float differences
    assert np.abs(img_i - img_f).max() < 5e-2
    assert abs(img_i.mean() - img_f.mean()) / img_f.mean() < 1e-3
