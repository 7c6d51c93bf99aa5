"""The port's BVH backend against the JAX package, on the CPU.

* The port's own BVH builder (csrc/bvh_builder.cpp through
  render/bvh.py) gives the reference's tree array for array, and the BVH
  tables of `build_geometry` equal the reference's.
* The plain version of the BVH kernel (#11, ops/bvh.py `walk_ref`)
  equals the TPU kernels `bvh_closest` / `bvh_any` run in interpret mode:
  prims, hits and occlusion exact; t, u and v on every hit within
  1e-6 * max(1, |e1| |e2| / |det|) of the hit triangle. Both run the
  same float32 operations, but XLA on the CPU contracts a * b - c * d
  into fused multiply-adds (PyTorch and the CUDA kernel do not), and
  Möller–Trumbore's division by det amplifies that rounding by the
  triangle's conditioning |e1| |e2| / |det| (up to ~90 for these rays:
  1.5e-5 in u on one grazing lane, at most 8.5e-7 once scaled).
* The exact walk of the instance walks (`_walk`) equals the reference's
  `_walk_phased` on the same rays, with the same tolerances.
* A bvh-backend render of `textured_mesh_scene(16, 16)`, built by the
  port's SceneBuilder and by `from_jax_scene`, against the JAX CPU render:
  first-bounce records lane by lane (t, p, normals, uv within 1e-5, the
  frame-derived wi and dp_du within 1e-4, on >= 99% of lanes with the
  same prim) and images per pixel within 1e-4 relative on >= 99% of
  pixels (a ray grazing an edge may take the neighbouring triangle). The
  JAX render takes ~9 s on the CPU, mostly compiling, so it is committed:
  tests/torch_goldens/bvh_16.npz, made by scripts/gen_torch_goldens.py.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.ops import bvh_pallas as jbp
from mitsuba_tpu.render import intersect as jri
from mitsuba_tpu.render.bvh import build_bvh as jax_build_bvh
from mitsuba_tpu.render.mesh import make_quad, make_sphere_mesh
from mitsuba_tpu.render.scene import textured_mesh_scene as jax_tms
from mitsuba_tpu_torch.integrators.path import PathConfig, render
from mitsuba_tpu_torch.interop import from_jax_scene
from mitsuba_tpu_torch.ops import bvh as bp
from mitsuba_tpu_torch.render import intersect as ri
from mitsuba_tpu_torch.render.bvh import build_bvh
from mitsuba_tpu_torch.render.records import Ray
from mitsuba_tpu_torch.render.scene import cornell_box, textured_mesh_scene

torch.set_num_threads(1)
W = H = 16
SPP, DEPTH = 2, 3


def _soup(case):
    """(vertices, faces) of the named triangle set."""
    if case == "cornell":
        g = cornell_box(4, 4, device="cpu").geom
        v0 = g.v0.numpy()
        tri = np.stack([v0, v0 + g.e1.numpy(), v0 + g.e2.numpy()], 1)
        return tri.reshape(-1, 3), np.arange(tri.shape[0] * 3).reshape(-1, 3)
    if case == "sphere":
        s = make_sphere_mesh([0, 0.8, 0], 0.8, 10, 20)
        return s.vertices, s.faces
    rng = np.random.default_rng(7)
    c = rng.uniform(-5, 5, (300, 1, 3))
    tri = (c + rng.normal(scale=0.4, size=(300, 3, 3))).astype(np.float32)
    return tri.reshape(-1, 3), np.arange(900).reshape(-1, 3)


@pytest.mark.parametrize("case", ["cornell", "sphere", "soup"])
def test_build_bvh_equals_reference(case):
    v, f = _soup(case)
    got, ref = build_bvh(v, f), jax_build_bvh(v, f)
    for k in ("bounds_min", "bounds_max", "first", "count", "skip", "perm"):
        a, b = getattr(got, k), getattr(ref, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k


def _meshes():
    return [(make_sphere_mesh([0, 0.8, 0], 0.8, 12, 24), 1, -1, 0),
            (make_quad([-6, 0, -6], [-6, 0, 6], [6, 0, 6], [6, 0, -6]),
             0, -1, 1)]


_BVH_TABLES = ("v0", "e1", "e2", "n0", "n1", "n2", "uv0", "uv1", "uv2",
               "material_id", "emitter_id", "shape_id", "bvh_min",
               "bvh_max", "bvh_first", "bvh_count", "bvh_skip",
               "bvh_packed", "tri_packed", "shade_pack")
_CLUSTER_TABLES = ("mt_tri", "mt_start", "mt_bmin", "mt_bmax",
                   "cl_sc_bmin", "cl_sc_bmax")


@pytest.mark.parametrize("backend", ["bvh", "cluster"])
def test_bvh_tables_equal_reference(backend):
    jg = jri.build_geometry(_meshes(), backend=backend)
    tg = ri.build_geometry(_meshes(), backend=backend)
    assert tg.backend == jg.backend == backend
    names = _BVH_TABLES + (_CLUSTER_TABLES if backend == "cluster" else ())
    for k in names:
        a, b = getattr(tg, k).numpy(), np.asarray(getattr(jg, k))
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), k


@pytest.fixture(scope="module")
def walk_case():
    """A 554-triangle scene and 1,280 rays: camera-like rays, rays from
    inside the sphere's boxes, axis-parallel rays, dead lanes (maxt -1),
    finite and infinite maxt."""
    g = ri.build_geometry(_meshes(), backend="bvh")
    rng = np.random.default_rng(3)
    n = 1280
    o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(0.1, 2.5, n)
    o[n // 4:n // 2] = rng.normal(scale=0.2, size=(n // 4, 3)) + [0, 0.8, 0]
    tgt = rng.normal(scale=0.6, size=(n, 3)).astype(np.float32)
    tgt[:, 1] += 0.8
    d = tgt - o
    d[::7, 0] = 0.0
    d[::11, 2] = 0.0
    d[::13] = [0.0, -1.0, 0.0]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    mint = np.full(n, 1e-4, np.float32)
    maxt = np.where(np.arange(n) % 2 == 0, np.inf,
                    rng.uniform(0.5, 4.0, n)).astype(np.float32)
    maxt[::9] = -1.0
    return g, [np.ascontiguousarray(x, np.float32)
               for x in (o, d, mint, maxt)]


def _close_tuv(g, d, prim, got, ref, hit):
    """The tolerance of the module docstring, on the hit lanes: 1e-6 times
    the conditioning of each lane's hit triangle under its ray d."""
    tri = g.tri_packed.numpy()[prim[hit]]
    e1, e2 = tri[:, 3:6], tri[:, 6:9]
    det = np.abs(np.einsum("ij,ij->i", e1, np.cross(d[hit], e2)))
    cond = np.maximum(1.0, np.linalg.norm(e1, axis=1)
                      * np.linalg.norm(e2, axis=1) / det)
    for k, (a, b) in enumerate(zip(got, ref)):
        err = np.abs(a.numpy()[hit] - b[hit])
        assert (err <= 1e-6 * cond).all(), ("tuv"[k], (err / cond).max())


@pytest.mark.parametrize("any_hit", [False, True])
def test_walk_matches_tpu_kernel(walk_case, any_hit):
    g, rays = walk_case
    nodes, tris = g.bvh_packed, g.tri_packed
    tr = [torch.from_numpy(x) for x in rays]
    fn = jbp.bvh_any if any_hit else jbp.bvh_closest
    ref = fn(jnp.asarray(nodes.numpy()), jnp.asarray(tris.numpy()),
             *[jnp.asarray(x) for x in rays], interpret=True)
    got = (bp.bvh_any if any_hit else bp.bvh_closest)(nodes, tris, *tr)
    if any_hit:
        occ = np.asarray(ref)
        assert np.array_equal(got.numpy(), occ) and 0 < occ.sum() < len(occ)
        return
    t, u, v, prim, hit = got
    rt, ru, rv, rp, rh = (np.asarray(x) for x in ref)
    assert np.array_equal(prim.numpy(), rp) and np.array_equal(
        hit.numpy(), rh)
    assert 0.3 < rh.mean() < 0.95
    _close_tuv(g, rays[1], rp, (t, u, v), (rt, ru, rv), rh)
    assert np.isinf(t.numpy()[~rh]).all() and np.isinf(rt[~rh]).all()


@pytest.fixture(scope="module")
def scenes():
    js = jax_tms(W, H)
    assert js.geom.backend == "bvh"
    return js, {"builder": textured_mesh_scene(W, H, device="cpu"),
                "interop": from_jax_scene(js, device="cpu")}


def test_builder_equals_interop_conversion(scenes):
    _js, ts = scenes
    a, b = ts["builder"].geom, ts["interop"].geom
    assert a.backend == b.backend == "bvh"
    for k in _BVH_TABLES:       # bytes: shade_pack holds bitcast ints
        x, y = getattr(a, k).numpy(), getattr(b, k).numpy()
        assert np.array_equal(x.view(np.uint8), y.view(np.uint8)), k


def _camera_uv():
    """Film points of the scanline lanes (pixel * spp + sample), as
    `render` on bvh draws them; the port's sampler is bit-exact with the
    reference's (tests/test_torch_sampler.py), so both cameras take
    these."""
    from mitsuba_tpu_torch.render.sampler import Sampler

    lane = torch.arange(W * H * SPP)
    pid, sid = lane // SPP, lane % SPP
    off = Sampler(0, pid.to(torch.int32), sid.to(torch.int32)).next_2d()
    px, py = (pid % W).float(), (pid // W).float()
    return torch.stack([(px + off[:, 0]) / W, (py + off[:, 1]) / H],
                       -1).numpy()


@pytest.mark.parametrize("built_by", ["builder", "interop"])
def test_first_bounce_records_match(scenes, built_by):
    js, ts = scenes
    uv = _camera_uv()
    ref = jax.jit(jri._ray_intersect_tri)(
        js.geom, js.camera.sample_ray(jnp.asarray(uv)))
    its = ri.ray_intersect(ts[built_by].geom,
                           ts[built_by].camera.sample_ray(
                               torch.from_numpy(uv)))
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
def test_render_matches_reference_image(scenes, built_by):
    _js, ts = scenes
    reference_image = np.load(os.path.join(
        os.path.dirname(__file__), "torch_goldens", "bvh_16.npz"))["mean"]
    img, aux = render(ts[built_by], PathConfig(max_depth=DEPTH, spp=SPP),
                      seed=0)
    img = img.numpy()
    assert img.shape == (H, W, 3) and np.isfinite(img).all()
    close = np.isclose(img, reference_image, rtol=1e-4, atol=1e-6).all(-1)
    assert close.mean() >= 0.99, close.mean()
    np.testing.assert_allclose(img.mean(), reference_image.mean(),
                               rtol=1e-3)


@pytest.mark.parametrize("any_hit", [False, True])
def test_exact_walk_matches_reference(walk_case, any_hit):
    from mitsuba_tpu.render.records import Ray as JaxRay

    g, rays = walk_case
    jg = jri.build_geometry(_meshes(), backend="bvh")
    ref = jri._walk_phased(jg, JaxRay(*[jnp.asarray(x) for x in rays]),
                           any_hit)
    got = ri._walk(g, Ray(*[torch.from_numpy(x) for x in rays]), any_hit)
    if any_hit:
        assert np.array_equal(got.numpy(), np.asarray(ref[4]))
        return
    t, u, v, prim, ok = got
    rt, ru, rv, rp, rok = (np.asarray(x) for x in ref)
    assert np.array_equal(ok.numpy(), rok) and 0.3 < rok.mean() < 0.95
    assert np.array_equal(prim.numpy()[rok], rp[rok])
    _close_tuv(g, rays[1], rp, (t, u, v), (rt, ru, rv), rok)
