"""The last four options of PathConfig in the port against the JAX package.

- strict_normals, skip_direct_emission and hit_prediction, lane by lane
  against the reference's kernel path (the kernels' plain references,
  tests/torch_kernel_path.py) on the Cornell box with a tessellated
  sphere whose interpolated normals disagree with its facets near the
  silhouette (brute, 16x16x2, depth 4): >= 99% of lanes within rtol 1e-4,
  the mean within 1e-3 of it (tests/test_torch_hetero.py
  assert_lanes_match); strict_normals kills lanes there.
- hit_prediction renders bit for bit the render without it (the bound is
  exact), on brute, bvh and cluster scenes, as tests/test_cluster.py:329
  holds the reference's; pred_hit_frac is reported, not held.
- sort_mode="octant" within 1e-6 of "full" on a 32x32 cluster
  cornell_box_specular, as tests/test_cluster.py:313 holds the
  reference's; its order is the reference's counting sort's.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.integrators.path import PathConfig as JaxPathConfig
from mitsuba_tpu.integrators.path import _octant_partition
from mitsuba_tpu.integrators.path import path_trace as jax_path_trace
from mitsuba_tpu.render import mesh as jmesh
from mitsuba_tpu.render.sampler import Sampler as JaxSampler
from mitsuba_tpu.render.scene import cornell_box as jax_cornell_box
from mitsuba_tpu_torch.integrators.path import (
    PathConfig, _bounce_order, camera_wavefront, path_trace, render,
)
from mitsuba_tpu_torch.interop import from_jax_scene
from mitsuba_tpu_torch.render.records import Ray
from mitsuba_tpu_torch.render.scene import (
    cornell_box, cornell_box_specular, textured_mesh_scene,
)
from tests.test_torch_hetero import assert_lanes_match
from tests.torch_kernel_path import kernel_path, lanes

torch.set_num_threads(1)
W = H = 16
SPP, DEPTH = 2, 4
OPTIONS = ("strict_normals", "skip_direct_emission", "hit_prediction")


def _ball_box():
    """The Cornell box with a coarse tessellated sphere (24 x 12, vertex
    normals) on its floor, brute backend."""
    jscene = jax_cornell_box(W, H)
    from mitsuba_tpu.render.scene import SceneBuilder

    b = SceneBuilder()
    # the box's own tables, rebuilt with the ball: cornell_box's shapes
    # come from its builder, so re-add them from the scene's triangles
    v0 = np.asarray(jscene.geom.v0)
    e1 = np.asarray(jscene.geom.e1)
    e2 = np.asarray(jscene.geom.e2)
    mid = np.asarray(jscene.geom.material_id)
    eid = np.asarray(jscene.geom.emitter_id)
    mt = jscene.materials
    rows = {}
    for i in range(mt.reflectance.shape[0]):
        rows[i] = b.materials.lambertian(tuple(np.asarray(
            mt.reflectance[i]).tolist()))
    for i in range(v0.shape[0]):
        tri = jmesh.TriMesh(np.stack([v0[i], v0[i] + e1[i], v0[i] + e2[i]]),
                            np.asarray([[0, 1, 2]], np.int32))
        if eid[i] >= 0:
            b.add_area_emitter_shape(tri, rows[int(mid[i])],
                                     (18.4, 15.6, 8.0))
        else:
            b.add_shape(tri, rows[int(mid[i])])
    glossy = b.materials.lambertian((0.6, 0.6, 0.7))
    b.add_shape(jmesh.make_sphere_mesh([380, 90, 150], 90.0, 12, 24), glossy)
    b.set_camera(jscene.camera, W, H)
    return b.build(backend="brute")


@pytest.fixture(scope="module")
def reference_lanes():
    """The reference's lanes under each option (seed 0), on its kernel
    path."""
    jscene = _ball_box()
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        kernel_path(mp, jscene.geom)
        for opt in (None,) + OPTIONS:
            kw = {opt: True} if opt else {}
            jcfg = JaxPathConfig(max_depth=DEPTH, spp=SPP, remat=False, **kw)

            @functools.partial(jax.jit, static_argnums=1)
            def run(scene, jcfg):
                pid, sid, px, py = lanes(W, H, SPP, jnp)
                sampler = JaxSampler(0, pid, sid)
                off = sampler.next_2d()
                uv = jnp.stack([(px + off[:, 0]) / W,
                                (py + off[:, 1]) / H], -1)
                return jax_path_trace(scene, scene.camera.sample_ray(uv),
                                      sampler, jcfg)

            L, aux = run(jscene, jcfg)
            out[opt] = (np.asarray(L), float(aux["avg_path_length"]))
    return jscene, out


@pytest.mark.parametrize("opt", OPTIONS)
def test_option_matches_kernel_path_per_lane(reference_lanes, opt):
    jscene, out = reference_lanes
    scene = from_jax_scene(jscene, device="cpu")
    cfg = PathConfig(max_depth=DEPTH, spp=SPP, **{opt: True})
    L, aux = path_trace(scene, *camera_wavefront(scene, cfg, 0,
                                                 morton=False)[:2], cfg)
    L_ref, apl = out[opt]
    assert_lanes_match(L.numpy(), L_ref)
    assert abs(float(aux["avg_path_length"]) - apl) <= 0.02
    plain_ref = out[None][0]
    if opt == "hit_prediction":
        assert np.array_equal(L_ref, plain_ref)
    elif opt == "skip_direct_emission":
        # the light seen directly is gone, the rest is the plain render's
        assert L_ref.sum() < plain_ref.sum()
    else:
        # the ball's silhouette lanes die: fewer bounces on average
        plain = path_trace(scene, *camera_wavefront(
            scene, replace_opt(cfg), 0, morton=False)[:2],
            replace_opt(cfg))[1]
        assert float(aux["avg_path_length"]) \
            < float(plain["avg_path_length"])


def replace_opt(cfg):
    return dataclasses.replace(cfg, strict_normals=False)


@pytest.mark.parametrize("backend", ["brute", "bvh", "cluster"])
def test_hit_prediction_renders_the_same_image(backend):
    if backend == "brute":
        scene = cornell_box(24, 24, device="cpu")
    elif backend == "bvh":
        scene = textured_mesh_scene(12, 12, device="cpu")
    else:
        scene = cornell_box_specular(24, 24, backend="cluster", device="cpu")
    base = PathConfig(max_depth=4 if backend == "brute" else 3, spp=2)
    a, _ = render(scene, base)
    b, aux = render(scene, dataclasses.replace(base, hit_prediction=True))
    assert torch.equal(a, b), backend
    assert 0.0 <= float(aux["pred_hit_frac"]) <= 1.0


def test_octant_sort_matches_full():
    scene = cornell_box_specular(32, 32, backend="cluster", device="cpu")
    a, _ = render(scene, PathConfig(max_depth=3, spp=2, sort_mode="full"))
    b, _ = render(scene, PathConfig(max_depth=3, spp=2, sort_mode="octant"))
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)
    with pytest.raises(ValueError):
        render(scene, PathConfig(max_depth=1, spp=1, sort_mode="morton"))


def test_octant_order_is_the_counting_sort():
    """The port's stable octant argsort gives the reference's counting
    sort's permutation, dead lanes last."""
    rng = np.random.default_rng(0)
    n = 3000
    o = rng.normal(size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    maxt = np.where(rng.uniform(size=n) < 0.2, -1.0, np.inf)
    ray = Ray.make(torch.from_numpy(o), torch.from_numpy(d),
                   maxt=torch.from_numpy(maxt.astype(np.float32)))
    order = _bounce_order(cornell_box(4, 4, device="cpu").geom, ray,
                          "octant")
    oct_ = ((d[:, 0] > 0) + 2 * (d[:, 1] > 0) + 4 * (d[:, 2] > 0))
    keys = np.where(maxt < 1e-4, 8, oct_).astype(np.int32)
    want, _ = _octant_partition(jnp.asarray(keys))
    np.testing.assert_array_equal(order.numpy(), np.asarray(want))
