"""The exact cull's L1 walks of the port (ops/exact.py: `build_exact_l1`,
kernel #8's plain version `l1_items_ref` (v6) and kernel #9's
`l1_masked_ref` (v6b), the queries' `walk` argument and the geometry's
`ex_walk`) against the JAX package's mitsuba_tpu/ops/exact_pallas.py,
whose kernels run in Pallas interpret mode.

Inputs are tests/test_torch_exact.py's: two 128-lane rows of a
2,210-triangle cluster scene at caps (128, 16, 32, 96), made by numpy
from a fixed seed (both rows overflow E2 = 32, which makes the lists full
and the kernels' dead slots few).

Interpreting a kernel costs a compile that grows with its unrolled body,
so the live runs take small steps: the v6b kernel at 2 (in the queries,
1) L1 blocks per step, the v6 kernel at one L1 block per grid step (`BL`,
which only groups consecutive blocks into a grid step: each block's skip,
cull and merge read the state the blocks before it left, in order,
whatever the grouping). Stored in tests/torch_goldens/l1_walks.npz
(scripts/gen_torch_l1_golden.py) and held against the port too: v6b at
4 and at 16 blocks per step, 16 being the JAX package's own setting
(their closest modes take about 10 s and over ten minutes to compile on
the CPU), and v6 at `BL` = 8; and the reference's camera hit records on
the config-3 slice scene of tests/test_torch_config3.py, which the port
builds with its own SceneBuilder. The queries also run the reference's
row chunk at its least, 32 rows. The module's tests share one
interpreted reference build (`case`).

Tolerances: ids, keys, overflow flags, prims and occlusion equal; t, u and
v within 1e-5 where the prims agree (as tests/test_torch_exact.py: XLA may
contract or reorder the kernel's float32 operations).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.ops import exact_pallas as jep
from mitsuba_tpu.ops.worklist_pallas import _pack_rays as jax_pack_rays
from mitsuba_tpu.render.intersect import build_geometry as jax_build
from mitsuba_tpu_torch.ops import exact as ep
from mitsuba_tpu_torch.ops.rows import pack_rays
from mitsuba_tpu_torch.render.intersect import build_geometry
from test_torch_exact import CAPS, small_rays, small_scene

torch.set_num_threads(1)
GOLDEN = os.path.join(os.path.dirname(__file__), "torch_goldens",
                      "l1_walks.npz")


@pytest.fixture(scope="module")
def case():
    meshes = small_scene()
    jg = jax_build(meshes, backend="cluster")
    tg = build_geometry(meshes, backend="cluster")
    rays = small_rays()
    jrays = jax_pack_rays(*[jnp.asarray(x) for x in rays])[0]
    trays = pack_rays(*[torch.from_numpy(x) for x in rays])[0]
    # one interpreted reference build, shared by the module's tests
    ref = jep.build_exact_l1(jrays, jg.ex_tables, CAPS, interpret=True)
    return dict(jex=jg.ex_tables, tex=tg.ex_tables, jrays=jrays,
                trays=trays, rays=rays, ref=ref)


def _check_hits(res, out, any_hit):
    """res: the port's (t, u, v, prim) or occlusion; out: the TPU
    kernel's (R, 8, 128) output."""
    out = np.asarray(out)
    if any_hit:
        assert np.array_equal(res.numpy(), out[:, 0] > 0.5)
        assert res.sum() > 100
        return
    t, u, v, prim = (x.numpy() for x in res)
    prim_r = out[:, 3].view(np.int32)
    assert np.array_equal(prim, prim_r)
    hit = prim_r >= 0
    assert hit.sum() > 100
    for a, k in ((t, 0), (u, 1), (v, 2)):
        np.testing.assert_allclose(a[hit], out[:, k][hit], rtol=1e-5,
                                   atol=1e-5)


def test_build_exact_l1_matches_tpu_build(case):
    ids, keys, ovf = ep.build_exact_l1(case["trays"], case["tex"], CAPS)
    for a, b in zip((ids, keys, ovf), case["ref"]):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert ids.shape == (2, CAPS[2]) and int((keys < 3e38).sum()) > 50


@pytest.mark.parametrize("any_hit", [False, True])
def test_l1_items_matches_tpu_kernel(case, any_hit, monkeypatch):
    """#8 (v6) against `_call_l1_items`, one L1 block per grid step."""
    monkeypatch.setattr(jep, "BL", 1)
    l1_ids, l1_keys, _ovf = case["ref"]
    out = jep._call_l1_items(case["jex"]["tri"], case["jex"]["ct0"],
                             case["jrays"], l1_ids, l1_keys, any_hit, True)
    tex = case["tex"]
    res = ep.l1_items(tex["tri"], tex["ct0"], case["trays"],
                      *(torch.from_numpy(np.array(x))
                        for x in (l1_ids, l1_keys)), any_hit)
    _check_hits(res, out, any_hit)


@pytest.mark.parametrize("blm,any_hit", [(2, False), (2, True)])
def test_l1_masked_matches_tpu_kernel(case, blm, any_hit):
    """#9 (v6b) against `_call_l1_masked` at blm L1 blocks per step."""
    l1_ids, l1_keys, _ovf = case["ref"]
    out = jep._call_l1_masked(case["jex"]["tri"], case["jrays"], l1_ids,
                              l1_keys, any_hit, blm=blm, interpret=True)
    res = ep.l1_masked(case["tex"]["tri"], case["trays"],
                       *(torch.from_numpy(np.array(x))
                         for x in (l1_ids, l1_keys)), any_hit, blm)
    _check_hits(res, out, any_hit)


@pytest.mark.parametrize("walk", ["masked4", "masked16", "items"])
@pytest.mark.parametrize("any_hit", [False, True])
def test_l1_walks_match_stored_tpu_outputs(case, walk, any_hit):
    """#9 at 4 and 16 blocks per step and #8 at 8 blocks per grid step
    against the interpreted kernels' stored outputs on these very
    inputs."""
    g = np.load(GOLDEN)
    assert list(g["blms"]) == [4, 16] and int(g["bl"]) == jep.BL == 8
    for k, x in zip(("l1_ids", "l1_keys", "overflow"), case["ref"]):
        assert np.array_equal(g[k], np.asarray(x)), k
    tex = case["tex"]
    l1 = (torch.from_numpy(g["l1_ids"]), torch.from_numpy(g["l1_keys"]))
    if walk == "items":
        res = ep.l1_items(tex["tri"], tex["ct0"], case["trays"], *l1,
                          any_hit)
    else:
        res = ep.l1_masked(tex["tri"], case["trays"], *l1, any_hit,
                           int(walk[len("masked"):]))
    _check_hits(res, g[f"{walk}_{'any' if any_hit else 'closest'}"],
                any_hit)


def test_l1_walks_count_their_work(case):
    """The plain versions count what their inputs need, and counting
    leaves the result as it is."""
    tex, rays = case["tex"], case["trays"]
    ids, keys, _ovf = ep.build_exact_l1(rays, tex, CAPS)
    for any_hit in (False, True):
        w6, w6b = {}, {}
        a = ep.l1_items_ref(tex["tri"], tex["ct0"], rays, ids, keys,
                            any_hit, work=w6)
        b = ep.l1_masked_ref(tex["tri"], rays, ids, keys, any_hit, 16,
                             work=w6b)
        for x, y in ((a, ep.l1_items(tex["tri"], tex["ct0"], rays, ids,
                                     keys, any_hit)),
                     (b, ep.l1_masked(tex["tri"], rays, ids, keys, any_hit,
                                      16))):
            for p, q in zip(x if not any_hit else (x,),
                            y if not any_hit else (y,)):
                assert torch.equal(p, q)
        # v6 culls each L1's children per lane: fewer triangle tests
        assert 0 < w6["tri_tests"] < w6b["tri_tests"]
        assert w6["box_tests"] % 8 == 0 and w6["box_tests"] > 0
        # the distinct blocks read: v6 the children its lanes admit of
        # the L1 blocks it culls, v6b whole L1 blocks
        assert 0 < w6["clusters_read"] <= 8 * w6["l1_read"]
        assert w6b["clusters_read"] % 8 == 0 and w6b["clusters_read"] > 0
        if not any_hit:
            assert w6b["tri_tests"] % 64 == 0


def test_step_width_divides_e2():
    assert ep.step_width(32, 16) == 16
    assert ep.step_width(32, 24) == 16
    assert ep.step_width(384, 16) == 16
    assert ep.step_width(48, 32) == 24
    assert ep.step_width(8, 16) == 8


@pytest.mark.parametrize("walk,v6", [("v6", 1), ("v6b", 2)])
@pytest.mark.parametrize("any_hit", [False, True])
def test_exact_queries_match_reference(case, walk, v6, any_hit,
                                       monkeypatch):
    """exact_closest / exact_any with walk v6 and v6b against the JAX
    package's queries with v6=1 and 2 in interpret mode, one L1 block per
    v6b step on both sides; the v6 overflow mask leaves E3 out."""
    monkeypatch.setenv("MTS_V6BLM", "1")
    monkeypatch.setattr(ep, "V6B_BLM", 1)
    monkeypatch.setattr(jep, "BL", 1)
    monkeypatch.setattr(jep, "R_CHUNK", 32)
    o, d, mint, maxt = case["rays"]
    jargs = [jnp.asarray(x) for x in (o, d, mint, maxt)]
    targs = [torch.from_numpy(x) for x in (o, d, mint, maxt)]
    if any_hit:
        occ_r, ovf_r = jep.exact_any(case["jex"], *jargs, caps=CAPS,
                                     interpret=True, v6=v6)
        occ, ovf = ep.exact_any(case["tex"], *targs, CAPS, walk=walk)
        assert np.array_equal(occ.numpy(), np.asarray(occ_r))
        assert np.array_equal(ovf.numpy(), np.asarray(ovf_r))
        assert int(occ.sum()) > 100
        return
    ref = [np.asarray(x) for x in jep.exact_closest(
        case["jex"], *jargs, caps=CAPS, interpret=True, v6=v6)]
    got = [x.numpy() for x in ep.exact_closest(case["tex"], *targs, CAPS,
                                                walk=walk)]
    for k in (3, 4, 5):                     # prim, valid, overflow
        assert np.array_equal(got[k], ref[k]), k
    hit = ref[4]
    assert hit.sum() > 100
    for k in (0, 1, 2):
        np.testing.assert_allclose(got[k][hit], ref[k][hit], rtol=1e-5,
                                   atol=1e-5)


def test_walks_agree_and_default_to_v5_on_the_cpu(case, monkeypatch):
    """v5, v6 and v6b give the same hit records on the lanes v5 resolves
    (1,024 rays at wider caps); v6's overflow mask is v5's without the E3
    cap; walk=None on CPU tensors runs v5 (items) and neither L1 walk."""
    calls = []
    for name in ("items", "l1_items", "l1_masked"):
        fn = getattr(ep, name)
        monkeypatch.setattr(ep, name, lambda *a, _f=fn, _n=name: (
            calls.append(_n), _f(*a))[1])
    caps = (128, 32, 96, 256)
    targs = [torch.from_numpy(x) for x in small_rays(1024, seed=2)]
    res = {w: ep.exact_closest(case["tex"], *targs, caps, walk=w)
           for w in ("v5", "v6", "v6b")}
    assert calls == ["items", "l1_items", "l1_masked"]
    calls.clear()
    default = ep.exact_closest(case["tex"], *targs, caps)
    assert calls == ["items"]
    for a, b in zip(default, res["v5"]):
        assert torch.equal(a, b)
    done = ~res["v5"][5]
    assert done.float().mean() > 0.5 and int(res["v5"][4][done].sum()) > 300
    for w in ("v6", "v6b"):
        for k in range(5):
            assert torch.equal(res[w][k][done], res["v5"][k][done]), (w, k)
        assert not bool((res[w][5] & ~res["v5"][5]).any())
    assert ep.resolve_walk(None, "cuda") == "v6b"
    assert ep.resolve_walk(None, "cpu") == "v5"
    with pytest.raises(ValueError):
        ep.resolve_walk("v7", "cpu")


def _config3_scene():
    """tests/test_torch_config3.py's `jax_scene`, built by the port."""
    from mitsuba_tpu_torch.core import transform as tf
    from mitsuba_tpu_torch.render.camera import make_perspective
    from mitsuba_tpu_torch.render.mesh import make_quad, make_sphere_mesh
    from mitsuba_tpu_torch.render.scene import SceneBuilder
    from test_torch_config3 import H, W

    b = SceneBuilder()
    tex = b.textures.checkerboard(bright=(0.7,) * 3, dark=(0.2, 0.2, 0.25),
                                  uv_scale=(8.0, 8.0))
    floor = b.materials.lambertian((1.0, 1.0, 1.0), tex_id=tex)
    body = b.materials.phong(diffuse=(0.4, 0.3, 0.2), specular=(0.3,) * 3,
                             exponent=40.0)
    b.add_shape(make_sphere_mesh([0, 0.8, 0], 0.8, 24, 48), body)
    b.add_shape(make_quad([-6, 0, -6], [-6, 0, 6], [6, 0, 6], [6, 0, -6]),
                floor)
    b.emitters.sky(turbidity=3.0, sun_dir=(0.35, 0.6, -0.5), scale=1.0)
    b.set_camera(make_perspective(
        tf.look_at([0, 1.4, -3.2], [0, 0.7, 0], [0, 1, 0]), fov_deg=40.0,
        aspect=W / H), W, H)
    return b.build(backend="cluster", device="cpu", ex_walk="v6b")


def test_config3_first_bounce_v6b_matches_reference():
    """The config-3 slice scene's camera records through the v6b walk
    (geometry ex_walk) equal the reference's (stored) lane for lane."""
    from mitsuba_tpu_torch.render import intersect as ri
    from test_torch_config3 import _camera_rays

    g = np.load(GOLDEN)
    scene = _config3_scene()
    tray, _ = _camera_rays(scene, torch)
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        fn = ep.l1_masked
        mp.setattr(ep, "l1_masked",
                   lambda *a: (calls.append(1), fn(*a))[1])
        its = ri.ray_intersect(scene.geom, tray, coherent=True)
    assert calls
    ok = g["c3_valid"]
    assert np.array_equal(its.valid.numpy(), ok) and ok.mean() > 0.5
    assert np.array_equal(its.prim_id.numpy(), g["c3_prim_id"])
    for k in ("t", "p", "geo_n", "sh_n", "uv"):
        np.testing.assert_allclose(getattr(its, k).numpy()[ok],
                                   g[f"c3_{k}"][ok], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    for k in ("material_id", "shape_id"):
        assert np.array_equal(getattr(its, k).numpy(), g[f"c3_{k}"]), k
