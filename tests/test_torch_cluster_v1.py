"""The v1 cluster intersector of the port (ops/cluster.py, kernel #14's
plain version `cluster_rows_ref`; render/clusters.py
`build_cluster_tables`) against the JAX package's
mitsuba_tpu/ops/cluster_pallas.py, whose kernels run in Pallas interpret
mode, and against the port's brute Möller–Trumbore walk as an oracle.

The scene is a 12 x 24 sphere (528 triangles, 8 clusters: one
supercluster), cut by the JAX package's BVH so that both packages build
their tables from the same ranges; the kernel tests use 1,024 rays aimed
at the sphere, made by numpy from a fixed seed. The TPU kernel unrolls
its tile's rows, so it is interpreted at one row per tile (`BM` = 1, and
the query unjitted, so that the setting reaches its trace): with one
supercluster every tile lists the same one, whatever its height, and the
outputs are those of 8-row tiles (an eighth of the compile).

Tolerances: tables, tile lists, valid flags, occlusion and prims equal;
against the TPU kernel t within rtol 2e-4 / atol 2e-5, u and v within
rtol 5e-3 / atol 5e-4 (tests/test_cluster.py:84-93: the TPU kernel takes
its Pluecker products on the matrix unit at HIGHEST precision in its own
summation order, the port as ordered 10-term sums). Against the brute
oracle (a different formulation of the same test, so a ray through an
edge may differ) valid flags on >= 99.5% of lanes and prims on >= 99% of
the lanes both hit, t within the same tolerance.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.ops import cluster_pallas as jcp
from mitsuba_tpu.render import clusters as jcl
from mitsuba_tpu.render.bvh import build_bvh
from mitsuba_tpu.render.mesh import make_sphere_mesh
from mitsuba_tpu_torch.interop import from_jax_cluster_tables
from mitsuba_tpu_torch.ops import cluster as cp
from mitsuba_tpu_torch.ops import intersect as ip
from mitsuba_tpu_torch.render import clusters as tcl

torch.set_num_threads(1)
FIELDS = ("G", "aabb", "tri_start", "sc_bmin", "sc_bmax")


def _rays(n, seed, scale=3.0, maxt=1e9):
    """n rays from a box around the sphere toward points near it."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-scale, scale, (n, 3)).astype(np.float32)
    tgt = (rng.normal(size=(n, 3)) * 0.6).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    mint = np.full(n, 1e-4, np.float32)
    mx = np.where(np.arange(n) % 9 == 0, -1.0, maxt).astype(np.float32)
    return o, d, mint, mx


@pytest.fixture(scope="module")
def case():
    m = make_sphere_mesh([0.0, 0.0, 0.0], 1.0, 12, 24)
    v = np.asarray(m.vertices, np.float32)
    f = np.asarray(m.faces, np.int64)
    bvh = build_bvh(v, f)
    tri = v[f[bvh.perm]]
    v0, e1, e2 = tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
    ranges = jcl.cut_clusters(bvh.first, bvh.count, bvh.skip, v0.shape[0])
    jct = jcl.build_cluster_tables(v0, e1, e2, ranges)
    tct = tcl.build_cluster_tables(v0, e1, e2, ranges)
    return dict(v0=v0, e1=e1, e2=e2, ranges=ranges, jct=jct, tct=tct,
                jcl={k: jnp.asarray(getattr(jct, k)) for k in FIELDS},
                tcl=cp.table_dict(tct, device="cpu"))


def _torch(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def test_cluster_tables_are_byte_equal(case):
    jct, tct = case["jct"], case["tct"]
    assert len(case["ranges"]) == 8 and tct.n_super == jct.n_super == 1
    for k in FIELDS:
        a, b = getattr(jct, k), getattr(tct, k)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k
    conv = from_jax_cluster_tables(jct)
    for k in FIELDS:
        assert getattr(conv, k).tobytes() == getattr(jct, k).tobytes(), k
    assert conv.n_super == jct.n_super


def test_tile_lists_match_reference():
    """Three tiles against the 12 superclusters of a row of spheres."""
    spheres = [make_sphere_mesh([2.5 * i, 0.0, 0.0], 1.0, 12, 24)
               for i in range(12)]
    base = np.cumsum([0] + [s.vertices.shape[0] for s in spheres])
    v = np.concatenate([np.asarray(s.vertices, np.float32)
                        for s in spheres])
    f = np.concatenate([np.asarray(s.faces, np.int64) + b
                        for s, b in zip(spheres, base)])
    bvh = build_bvh(v, f)
    tri = v[f[bvh.perm]]
    ct = jcl.build_cluster_tables(
        tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0],
        jcl.cut_clusters(bvh.first, bvh.count, bvh.skip, tri.shape[0]))
    assert ct.n_super > 8
    o, d, mint, maxt = _rays(3000, 4, scale=14.0)
    # tile 0 looks along +x from x = 10, tile 1 along -x from x = 12
    rng = np.random.default_rng(5)
    for k, (x0, sx) in enumerate(((10.0, 1.0), (12.0, -1.0))):
        lanes = slice(k * 1024, (k + 1) * 1024)
        o[lanes] = [x0, 0.2, 0.2] + rng.uniform(-0.1, 0.1, (1024, 3))
        d[lanes] = np.c_[np.full(1024, sx), rng.uniform(-0.05, 0.05,
                                                        (1024, 2))]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    (ox, oy, oz, dx, dy, dz, _mn, mx, _n, m) = jcp._pack_rays(
        *[jnp.asarray(x) for x in (o, d, mint, maxt)])
    ids, counts = jcp.build_tile_lists(
        jnp.stack([p.reshape(-1) for p in (ox, oy, oz)], -1),
        jnp.stack([p.reshape(-1) for p in (dx, dy, dz)], -1),
        mx.reshape(-1), jnp.asarray(ct.sc_bmin), jnp.asarray(ct.sc_bmax),
        int(m) // cp.BM)
    rays, n, n_rows = cp.pack_tiles(*_torch(o, d, mint, maxt))
    assert (n, n_rows) == (3000, int(m))
    planes = np.stack([np.asarray(x) for x in (ox, oy, oz, dx, dy, dz,
                                                _mn, mx)], axis=1)
    assert np.array_equal(rays.numpy(), planes)
    lanes = rays.transpose(1, 2)
    tids, tcounts = cp.build_tile_lists(
        lanes[:, :, 0:3].reshape(-1, 3), lanes[:, :, 3:6].reshape(-1, 3),
        lanes[:, :, 7].reshape(-1), *_torch(ct.sc_bmin, ct.sc_bmax),
        n_rows // cp.BM)
    assert np.array_equal(tcounts.numpy(), np.asarray(counts))
    assert np.array_equal(tids.numpy(), np.asarray(ids))
    assert 0 < int(tcounts.min()) < int(tcounts.max())


def _oracle(case, o, d, mint, maxt):
    table = ip.make_tri_table(*_torch(case["v0"], case["e1"], case["e2"]))
    return ip.closest_hit_ref(table, *_torch(o, d, mint, maxt)), table


def _one_row_tiles(monkeypatch):
    monkeypatch.setattr(jcp, "BM", 1)
    monkeypatch.setattr(jcp, "TILE", jcp.LANES)


def test_cluster_closest_matches_tpu_kernel(case, monkeypatch):
    _one_row_tiles(monkeypatch)
    o, d, mint, maxt = _rays(1024, 1)
    ref = [np.asarray(x) for x in jcp.cluster_closest.__wrapped__(
        case["jcl"], *[jnp.asarray(x) for x in (o, d, mint, maxt)],
        interpret=True)]
    got = [x.numpy() for x in cp.cluster_closest(
        case["tcl"], *_torch(o, d, mint, maxt))]
    ok = ref[4]
    assert np.array_equal(got[4], ok) and ok.sum() > 300
    assert np.array_equal(got[3][ok], ref[3][ok])
    assert (got[3][~ok] == -1).all() and np.isinf(got[0][~ok]).all()
    np.testing.assert_allclose(got[0][ok], ref[0][ok], rtol=2e-4,
                               atol=2e-5)
    for k in (1, 2):
        np.testing.assert_allclose(got[k][ok], ref[k][ok], rtol=5e-3,
                                   atol=5e-4)
    # the oracle: the port's brute walk over the same soup
    (tb, ub, vb, pb, okb), _ = _oracle(case, o, d, mint, maxt)
    okb = okb.numpy()
    assert (okb == ok).mean() >= 0.995
    both = ok & okb
    assert (pb.numpy()[both] == got[3][both]).mean() >= 0.99
    np.testing.assert_allclose(got[0][both], tb.numpy()[both], rtol=2e-4,
                               atol=2e-5)


def test_cluster_any_matches_tpu_kernel(case, monkeypatch):
    _one_row_tiles(monkeypatch)
    o, d, mint, maxt = _rays(1024, 2, maxt=2.5)
    ref = np.asarray(jcp.cluster_any.__wrapped__(
        case["jcl"], *[jnp.asarray(x) for x in (o, d, mint, maxt)],
        interpret=True))
    got = cp.cluster_any(case["tcl"], *_torch(o, d, mint, maxt)).numpy()
    assert np.array_equal(got, ref) and 100 < got.sum() < 1000
    _, table = _oracle(case, o, d, mint, maxt)
    occ_b = ip.any_hit_ref(table, *_torch(o, d, mint, maxt)).numpy()
    assert (occ_b == got).mean() >= 0.995


def test_cluster_rows_ref_counts_its_work(case):
    """The plain version's counts: a box test per live lane and listed
    cluster, the triangle tests its own slab admits, the superclusters and
    clusters it reads; the same result with or without counting, and as
    the query's own launch."""
    o, d, mint, maxt = _rays(1024, 1)
    args, n = cp.launch_args(case["tcl"], *_torch(o, d, mint, maxt), False)
    rays, counts = args[0], args[2]
    work = {}
    res = cp.cluster_rows_ref(*args, work=work)
    for a, b in zip(res, cp.cluster_rows(*args)):
        assert torch.equal(a, b)
    query = cp.cluster_closest(case["tcl"], *_torch(o, d, mint, maxt))
    assert torch.equal(query[3], res[3].reshape(-1)[:n])
    live = int((rays[:, 6] <= rays[:, 7]).sum())
    assert work["box_tests"] == live * 8 * int(counts[0])
    assert 0 < work["tri_tests"] <= work["box_tests"] * 128
    assert work["tri_tests"] % 128 == 0
    assert work["superclusters_read"] == 1
    assert 0 < work["clusters_read"] <= 8


def test_cluster_closest_clamps_infinite_maxt(case):
    """maxt = inf answers as maxt = 1e30: no lane reports the 3e38 miss
    sentinel as a hit (the reference's kernel does, ROADMAP C)."""
    o, d, mint, maxt = _rays(1024, 3)
    inf = np.where(maxt > 0, np.inf, maxt).astype(np.float32)
    big = np.where(maxt > 0, 1e30, maxt).astype(np.float32)
    a = cp.cluster_closest(case["tcl"], *_torch(o, d, mint, inf))
    b = cp.cluster_closest(case["tcl"], *_torch(o, d, mint, big))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert float(a[0][a[4]].max()) < 10.0
