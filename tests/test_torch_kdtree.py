"""The port's point structures (mitsuba_tpu_torch/core/kdtree.py) against
the JAX package's (mitsuba_tpu/core/kdtree.py).

- `KDTree`: its nodes and permutation, and `knn` and `range_query` of
  seeded queries, equal to the reference's (both are host numpy).
- `HashGrid.build`: every table bit for bit for the same points, with
  the seeded shuffle and the stable sort by cell.
- `HashGrid.gather_sum` with no hook, `weight_fn`, `contrib_fn` and
  `contrib_pos_fn`, a scalar and a per-query radius: within 1e-5
  relative (1e-6 absolute) of the reference's; the grid has a cell far
  over its budget (its kept points scaled by count over budget) and
  queries at the grid's border (its cells outside the grid skipped, not
  clamped). The sums take the reference's order; XLA fuses their
  multiply-adds, so the last bits may differ.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.core.kdtree import HashGrid as JaxHashGrid
from mitsuba_tpu.core.kdtree import KDTree as JaxKDTree
from mitsuba_tpu_torch.core.kdtree import HashGrid, KDTree

torch.set_num_threads(1)


def _points(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-2.0, 2.0, (n, 3))
    # a dense clump: one cell far over its budget
    pts[: n // 5] = rng.normal(scale=0.02, size=(n // 5, 3)) + 0.7
    payload = rng.uniform(0.0, 1.0, (n, 5)).astype(np.float32)
    return pts.astype(np.float32), payload


def _queries(pts, n=400, seed=1):
    """Seeded queries: 40 in the clump, 60 on the grid's border."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(-2.2, 2.2, (n, 3))
    q[:40] = pts[:40] + rng.normal(scale=0.01, size=(40, 3))  # the clump
    q[40:80, 0] = pts[:, 0].min()              # on the grid's border
    q[80:100] = pts.max(0)
    return q.astype(np.float32)


def test_kdtree_matches_reference():
    pts, _ = _points(1500)
    ref, got = JaxKDTree(pts), KDTree(pts)
    assert got.nodes == ref.nodes
    np.testing.assert_array_equal(got.idx, ref.idx)
    for q in _queries(pts)[::13]:
        for k in (1, 8):
            ri, rd = ref.knn(q, k)
            gi, gd = got.knn(q, k)
            np.testing.assert_array_equal(gi, ri)
            np.testing.assert_array_equal(gd, rd)
        for r in (0.05, 0.4):
            np.testing.assert_array_equal(got.range_query(q, r),
                                          ref.range_query(q, r))
    # the nearest of a point of the tree is itself
    i, d = got.knn(pts[7], 1)
    assert i[0] == 7 and d[0] == 0.0


@pytest.mark.parametrize("res,mpq", [(16, 64), (8, 27 * 24)])
def test_hashgrid_build_bit_for_bit(res, mpq):
    pts, payload = _points()
    ref = JaxHashGrid.build(pts, payload, res=res, max_per_query=mpq)
    got = HashGrid.build(pts, payload, res=res, max_per_query=mpq)
    for f in ("bmin", "inv_cell", "cell_start", "perm", "points", "payload"):
        a, b = getattr(got, f).numpy(), np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (got.res, got.max_per_query) == (res, mpq)
    counts = np.diff(got.cell_start.numpy())
    assert counts.max() > max(mpq // 27, 4)      # a cell over its budget


HOOKS = ("none", "weight", "contrib", "contrib_pos")


def _hooks(xp, kind, normals):
    """The same hook for either package: the reference's sees one
    candidate, (N, F), at a time, the port's a cell's candidates,
    (N, P, F), per-query tensors broadcast with [:, None]."""
    nq = normals if xp is jnp else normals[:, None]
    if kind == "weight":
        return dict(weight_fn=lambda dist: 1.0 - 0.5 * dist)
    if kind == "contrib":
        def contrib(rows, d2):
            side = xp.sum(rows[..., 0:3] * nq, -1) > 0.5
            return rows[..., 1:4] * side[..., None] * (1.0 + d2)[..., None]
        return dict(contrib_fn=contrib)
    if kind == "contrib_pos":
        def contrib_pos(rows, d2, dp):
            return rows[..., 0:3] * dp + d2[..., None]
        return dict(contrib_pos_fn=contrib_pos)
    return {}


@pytest.mark.parametrize("hook", HOOKS)
@pytest.mark.parametrize("per_query", [False, True],
                         ids=["scalar", "per_query"])
def test_gather_sum_matches_reference(hook, per_query):
    pts, payload = _points()
    q = _queries(pts)
    nrm = np.random.default_rng(2).normal(size=q.shape).astype(np.float32)
    radius = 0.3
    if per_query:
        radius = np.random.default_rng(3).uniform(
            0.05, 0.3, q.shape[0]).astype(np.float32)
    ref_grid = JaxHashGrid.build(pts, payload, res=16, max_per_query=27 * 6)
    grid = HashGrid.build(pts, payload, res=16, max_per_query=27 * 6)
    r_j = jnp.asarray(radius) if per_query else radius
    r_t = torch.from_numpy(radius) if per_query else radius
    ref = np.asarray(ref_grid.gather_sum(
        jnp.asarray(q), r_j, **_hooks(jnp, hook, jnp.asarray(nrm))))
    got = grid.gather_sum(torch.from_numpy(q), r_t,
                          **_hooks(torch, hook, torch.from_numpy(nrm)))
    got = got.numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    assert np.abs(ref).sum() > 0
    if hook in ("none", "weight"):
        # the clump's queries gather its scaled sums
        assert (np.abs(ref[:40]).sum(-1) > 0).all()
