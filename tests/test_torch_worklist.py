"""The port's work-list intersector (ops/worklist.py) against the JAX
package's (mitsuba_tpu/ops/worklist_pallas.py), on the CPU, on a flat
cluster scene and on an instanced one (three instances of a sphere
group).

* The beam-cull build (`build_worklist`): items, total and overflow
  flags exactly equal, with beams small enough that rows overflow a beam
  and that the list runs out of slots.
* The plain version of the work-list kernel (#12) against the TPU
  kernels `wl_closest` / `wl_any` in interpret mode, with a small
  w_factor: overflow flags, prims, hits and occlusion exact; t within
  1e-6 absolute plus 1e-6 relative, u and v within 2e-5 absolute (XLA on
  the CPU contracts multiply-adds into FMAs, and u, v divide a dot
  product of rounding ~6e-8 by a det of ~0.003 for these 0.2-wide
  triangles seen from ~3 away; tests/test_torch_bvh.py). Compared on
  the rows that the reference's list reached: a row whose items did not fit the
  list at all is left unwritten by the TPU kernel (NaN in interpret
  mode) and initialised by the port's (no hit); both flag it as
  overflowing.

maxt is finite: with maxt = inf the reference's closest kernel takes its
3e38 miss sentinel for a hit, which the port avoids by clamping maxt to
1e30 (ops/worklist.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.ops import worklist_pallas as jwp
from mitsuba_tpu.render import intersect as jri
from mitsuba_tpu_torch.ops import worklist as wl
from mitsuba_tpu_torch.ops.rows import pack_rays
from mitsuba_tpu_torch.render import intersect as ri
from test_instancing import _instanced_scene
from test_torch_bvh import _meshes

torch.set_num_threads(1)
N = 1100                       # 9 rows, the last ragged


@pytest.fixture(scope="module", params=["flat", "instanced"])
def case(request):
    """Both packages' work-list tables and N rays from around the scene
    toward its middle; every 9th lane dead, every 13th axis-parallel."""
    if request.param == "flat":
        jg = jri.build_geometry(_meshes(), backend="cluster")
        tg = ri.build_geometry(_meshes(), backend="cluster")
    else:
        from mitsuba_tpu_torch.interop import from_jax_scene

        jg = _instanced_scene().geom
        tg = from_jax_scene(_instanced_scene(), device="cpu").geom
    lo, hi = np.asarray(jg.bvh_min[0]), np.asarray(jg.bvh_max[0])
    mid = 0.5 * (lo + hi)
    rng = np.random.default_rng(11)
    o = (mid + rng.uniform(-1, 1, (N, 3)) * (hi - lo) * 0.8).astype(
        np.float32)
    o[:, 2 if request.param == "instanced" else 1] += 3.0
    tgt = (mid + rng.normal(scale=0.3, size=(N, 3)) * (hi - lo)).astype(
        np.float32)
    d = tgt - o
    d[::13, :2] = 0.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    mint = np.full(N, 1e-4, np.float32)
    maxt = rng.uniform(5.0, 50.0, N).astype(np.float32)
    maxt[::9] = -1.0
    rays = [np.ascontiguousarray(x) for x in (o, d, mint, maxt)]
    return jg, tg, rays


def _reached_rows(items, n_rows):
    """Rows with a `first` item in the list (the rows the TPU kernel
    writes)."""
    items = np.asarray(items)
    first = (items & (1 << 14)) != 0
    return np.isin(np.arange(n_rows), items[first] >> 16)


@pytest.mark.parametrize("beams", [(8, 4, 2), (48, 48, 16)])
def test_build_worklist_matches_reference(case, beams):
    jg, tg, rays = case
    w_factor, l_sc, beam_s2 = beams
    jt, tt = jg.wl_tables, tg.wl_tables
    jr = jwp._pack_rays(*[jnp.asarray(x) for x in rays])[0]
    tr = pack_rays(*[torch.from_numpy(x) for x in rays])[0]
    assert np.array_equal(tr.numpy(), np.asarray(jr))
    w_cap = tr.shape[0] * w_factor
    ref = jwp.build_worklist(jr, jt["bmin"], jt["bmax"], jt["sc_bmin"],
                             jt["sc_bmax"], w_cap, l_sc, beam_s2)
    items, total, ovf = wl.build_worklist(
        tr, tt["bmin"], tt["bmax"], tt["sc_bmin"], tt["sc_bmax"], w_cap,
        l_sc, beam_s2)
    assert np.array_equal(items.numpy(), np.asarray(ref[0]))
    assert total == int(ref[1])
    assert np.array_equal(ovf.numpy(), np.asarray(ref[2]))
    if beams[0] == 8:
        assert ovf.any() and total > w_cap


def _close_tuv(got, ref, hit):
    np.testing.assert_allclose(got[0][hit], ref[0][hit], rtol=1e-6,
                               atol=1e-6)
    for a, b in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(a[hit], b[hit], rtol=0, atol=2e-5)


@pytest.mark.parametrize("any_hit", [False, True])
def test_worklist_matches_tpu_kernel(case, any_hit, monkeypatch):
    jg, tg, rays = case
    kw = dict(w_factor=8, l_sc=8, beam_s2=4)
    for name, value in zip(("W_FACTOR", "L_SC", "BEAM_S2"), kw.values()):
        monkeypatch.setattr(wl, name, value)
    jt = jg.wl_tables
    jrays = [jnp.asarray(x) for x in rays]
    trays = [torch.from_numpy(x) for x in rays]
    jr = jwp._pack_rays(*jrays)[0]
    reached = _reached_rows(jwp.build_worklist(
        jr, jt["bmin"], jt["bmax"], jt["sc_bmin"], jt["sc_bmax"],
        jr.shape[0] * kw["w_factor"], kw["l_sc"], kw["beam_s2"])[0],
        jr.shape[0])
    lanes = np.repeat(reached, 128)[:N]
    assert lanes.mean() > 0.3
    if any_hit:
        occ_r, ovf_r = jwp.wl_any(jt, *jrays, interpret=True, **kw)
        occ, ovf = wl.wl_any(tg.wl_tables, *trays)
        assert np.array_equal(ovf.numpy(), np.asarray(ovf_r))
        occ_r = np.asarray(occ_r)
        assert np.array_equal(occ.numpy()[lanes], occ_r[lanes])
        assert 0 < occ_r[lanes].sum() < lanes.sum()
        return
    ref = [np.asarray(x) for x in jwp.wl_closest(jt, *jrays, interpret=True,
                                                  **kw)]
    got = [x.numpy() for x in wl.wl_closest(tg.wl_tables, *trays)]
    assert np.array_equal(got[5], ref[5]) and got[5].any()
    assert not got[5].all()
    for k in (3, 4):                       # prim, valid
        assert np.array_equal(got[k][lanes], ref[k][lanes]), k
    hit = lanes & ref[4]
    assert hit.sum() > 50
    _close_tuv(got[:3], ref[:3], hit)
    assert np.isinf(got[0][lanes & ~ref[4]]).all()
