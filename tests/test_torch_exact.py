"""The exact-cull kernels' plain versions (ops/exact.py) against the TPU
kernels themselves, run in Pallas interpret mode.

On the CPU each wrapper runs its kernel's plain version, so these tests
hold the refine (#5), child-refine (#6) and item (#7) functions against
`_refine_keys_pallas`, `_child_refine` and `_call_items` of
mitsuba_tpu/ops/exact_pallas.py on two 128-lane rows of a 2,210-triangle
cluster scene, with inputs made by numpy from a fixed seed. The
reference build is computed once per module.

Tolerances: keys, ids, overflow flags, prims and occlusion must be equal;
t, u and v within 1e-5 where the prims agree (the port evaluates the
kernel's float32 operations in its order; XLA may contract or reorder
them, which moves the last bits).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.ops import exact_pallas as jep
from mitsuba_tpu.ops import stream_pallas as jsp
from mitsuba_tpu.ops.worklist_pallas import _pack_rays as jax_pack_rays
from mitsuba_tpu.render.intersect import build_geometry as jax_build
from mitsuba_tpu.render.mesh import make_quad, make_sphere_mesh
from mitsuba_tpu_torch.ops import exact as ep
from mitsuba_tpu_torch.ops import stream as sp
from mitsuba_tpu_torch.ops.rows import pack_rays
from mitsuba_tpu_torch.render.intersect import build_geometry

torch.set_num_threads(1)
BIG = 3e38
CAPS = (128, 16, 32, 96)


def small_scene():
    """A 24 x 48 sphere on a floor quad: 2,210 triangles, 384 K8
    clusters."""
    return [(make_sphere_mesh([0, 0.8, 0], 0.8, 24, 48), 0, -1),
            (make_quad([-6, 0, -6], [-6, 0, 6], [6, 0, 6], [6, 0, -6]),
             1, -1)]


def small_rays(n=256, seed=0):
    """Rays from above the floor toward the sphere; every 7th lane dead."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(0.2, 2.5, n)
    tgt = (rng.normal(size=(n, 3)) * 0.5).astype(np.float32)
    tgt[:, 1] += 0.8
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    mint = np.full(n, 1e-4, np.float32)
    maxt = np.where(np.arange(n) % 7 == 0, -1.0, 1e30).astype(np.float32)
    return o, d, mint, maxt


@pytest.fixture(scope="module")
def case():
    """Both packages' geometry and packed rows."""
    meshes = small_scene()
    jg = jax_build(meshes, backend="cluster")
    tg = build_geometry(meshes, backend="cluster")
    o, d, mint, maxt = small_rays()
    jrays = jax_pack_rays(*[jnp.asarray(x) for x in (o, d, mint, maxt)])[0]
    trays = pack_rays(*[torch.from_numpy(x) for x in (o, d, mint, maxt)])[0]
    return dict(jg=jg, tg=tg, jrays=jrays, trays=trays, jex=jg.ex_tables,
                tex=tg.ex_tables)


@pytest.fixture(scope="module")
def ref_build(case):
    """The TPU kernel path of the build, in interpret mode."""
    ids, blk, ovf = jep.build_exact_items(case["jrays"], case["jex"], CAPS,
                                          interpret=True)
    return ids, blk, ovf


def _t(x):
    return torch.from_numpy(np.array(x))


def test_rows_and_lists_match(case):
    """Packed rows and the conservative supercluster lists are equal."""
    assert np.array_equal(np.asarray(case["jrays"]), case["trays"].numpy())
    jst, tst = case["jg"].st_tables, case["tg"].st_tables
    ids, tns = jsp.build_sc_lists(case["jrays"], jst["sc_bmin"],
                                  jst["sc_bmax"])
    tids, ttns = sp.build_sc_lists(case["trays"], tst["sc_bmin"],
                                   tst["sc_bmax"])
    assert np.array_equal(np.asarray(ids)[:, 0], tids.numpy())
    assert np.array_equal(np.asarray(tns)[:, 0], ttns.numpy())


def test_refine_matches_tpu_kernel(case):
    """Keys of the K8 boxes the conservative row cull lists."""
    jex, tex = case["jex"], case["tex"]
    ids0, tns0 = jsp.build_sc_lists(case["jrays"], jex["b0_lo"],
                                    jex["b0_hi"])
    ids, keep = ids0[:, 0, :128], tns0[:, 0, :128] < BIG
    live = jnp.minimum(jnp.sum(tns0[:, 0] < BIG, -1), 128).astype(jnp.int32)
    key_ref = np.asarray(jep._refine_keys_pallas(
        case["jrays"], ids, keep, live, jex["b0_lo"], jex["b0_hi"], True))
    ids, keep, live = (np.asarray(x) for x in (ids, keep, live))
    key = ep.refine(case["trays"], _t(ids), _t(live), tex["b0_lo"],
                    tex["b0_hi"])
    key = torch.where(_t(keep), key, BIG).numpy()
    assert np.array_equal(key, key_ref)
    assert (key_ref < BIG).sum() > 100


def test_child_refine_matches_tpu_kernel(case):
    """Keys of random parents' children, two live counts."""
    rng = np.random.default_rng(1)
    pids = rng.integers(0, case["jex"]["ct0"].shape[0],
                        (2, 16)).astype(np.int32)
    lp = np.array([16, 9], np.int32)
    keep8 = np.repeat(np.arange(16)[None] < lp[:, None], 8, axis=1)
    key_ref = np.asarray(jep._child_refine(
        case["jrays"], jnp.asarray(pids), jnp.asarray(lp),
        case["jex"]["ct0"], jnp.asarray(keep8), True))
    key = ep.child_refine(case["trays"], _t(pids), _t(lp),
                          case["tex"]["ct0"])
    key = torch.where(_t(keep8), key, BIG).numpy()
    assert np.array_equal(key, key_ref)
    assert (key_ref < BIG).sum() > 50


def test_build_matches_tpu_kernel_path(case, ref_build):
    """ids, block keys and overflow flags of S0-S3 are equal."""
    ids, blk, ovf = ep.build_exact_items(case["trays"], case["tex"], CAPS)
    ids_r, blk_r, ovf_r = (np.asarray(x) for x in ref_build)
    assert np.array_equal(ids.numpy(), ids_r)
    assert np.array_equal(blk.numpy(), blk_r)
    assert np.array_equal(ovf.numpy(), ovf_r)


@pytest.mark.parametrize("any_hit", [False, True])
def test_items_match_tpu_kernel(case, ref_build, any_hit):
    ids, blk, _ovf = ref_build
    out = np.asarray(jep._call_items(case["jex"]["tri"], case["jrays"], ids,
                                     blk, any_hit, True))
    res = ep.items(case["tex"]["tri"], case["trays"], _t(np.asarray(ids)),
                   _t(np.asarray(blk)), any_hit)
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


def zero_key_rays(n=256, seed=3):
    """Rays from inside the scene's boxes (above the floor, beside the
    sphere), so that a box holding a lane's origin keys that lane at its
    mint: +0.0 on even lanes and -0.0 on odd ones, ties of the two zeros
    within every row (tests/torch_refine_cases.py's `zero` warps, through
    a whole query); every 7th lane dead."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(0.1, 1.4, n)
    tgt = rng.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    tgt[:, 1] = rng.uniform(-0.5, 1.2, n)
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    mint = np.where(np.arange(n) % 2 == 0, 0.0, -0.0).astype(np.float32)
    maxt = np.where(np.arange(n) % 7 == 0, -1.0, 1e30).astype(np.float32)
    return o, d, mint, maxt


def test_zero_key_ties_give_the_reference_hits(case):
    """ROADMAP C's zero-key item: on rays with mint = +0.0 and -0.0 the
    refine keys of the boxes around their origins tie at the two zeros
    (#5 and #6 break that tie by the card's torch.amin, csrc/exact.cu
    `tie_rank`, the reference by its own order). The whole exact-cull
    closest query, through the port's plain versions and through the JAX
    package's kernels in interpret mode, gives the same hit records:
    prim, valid and overflow equal, t, u, v within 1e-5 as above. Only
    the lists' order could carry a zero's sign, and a sort orders -0.0
    and +0.0 as equal. (About 13 s, most of it the reference's
    interpreted compile.)"""
    o, d, mint, maxt = zero_key_rays()
    caps = (128, 32, 96, 256)               # wide enough that no row overflows
    rays = pack_rays(*[torch.from_numpy(x) for x in (o, d, mint, maxt)])[0]
    _ids, blk, _ovf = ep.build_exact_items(rays, case["tex"], caps)
    assert bool((blk == 0).any())           # item blocks keyed at a zero
    ref = [np.asarray(x) for x in jep.exact_closest(
        case["jex"], *[jnp.asarray(x) for x in (o, d, mint, maxt)],
        caps=caps, interpret=True)]
    got = [x.numpy() for x in ep.exact_closest(
        case["tex"], *[torch.from_numpy(x) for x in (o, d, mint, maxt)],
        caps)]
    for k in (3, 4, 5):                     # prim, valid, overflow
        assert np.array_equal(got[k], ref[k]), k
    hit = ref[4]
    assert hit.sum() > 100 and not ref[5].any()
    for k in (0, 1, 2):
        np.testing.assert_allclose(got[k][hit], ref[k][hit], rtol=1e-5,
                                   atol=1e-5)
