"""The stream kernel's plain version (ops/stream.py) against the TPU
kernel itself, run in Pallas interpret mode.

On the CPU `stream_rows` runs the kernel's plain version; this holds it
against `_call_stream` of mitsuba_tpu/ops/stream_pallas.py on one 128-lane
row of a 2,210-triangle cluster scene (rays made by numpy from a fixed
seed), in closest and any-hit mode, and checks the virtual-to-true prim
map of `stream_closest` against the brute-force oracle.

Tolerances: virtual prims and occlusion must be equal; t, u and v within
1e-5 where the prims agree (XLA may contract or reorder the kernel's
float32 operations).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.ops import stream_pallas as jsp
from mitsuba_tpu.render.intersect import _closest_brute
from mitsuba_tpu.render.intersect import build_geometry as jax_build
from mitsuba_tpu.render.records import Ray as JaxRay
from mitsuba_tpu_torch.ops import stream as sp
from mitsuba_tpu_torch.ops.rows import pack_rays
from mitsuba_tpu_torch.render.intersect import build_geometry
from test_torch_exact import small_rays, small_scene

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def case():
    meshes = small_scene()
    rays = small_rays(n=128, seed=2)
    return dict(jg=jax_build(meshes, backend="cluster"),
                tg=build_geometry(meshes, backend="cluster"), rays=rays)


def test_stream_tables_match(case):
    jst, tst = case["jg"].st_tables, case["tg"].st_tables
    for k in ("sc_tri", "sc_bmin", "sc_bmax", "tri_start"):
        assert np.array_equal(np.asarray(jst[k]), tst[k].numpy()), k


@pytest.mark.parametrize("any_hit", [False, True])
def test_stream_matches_tpu_kernel(case, any_hit):
    o, d, mint, maxt = case["rays"]
    out, _n = jsp._call_stream(case["jg"].st_tables,
                               *[jnp.asarray(x) for x in (o, d, mint, maxt)],
                               any_hit, True)
    out = np.asarray(out)
    st = case["tg"].st_tables
    rays = pack_rays(*[torch.from_numpy(x) for x in (o, d, mint, maxt)])[0]
    ids, tns = sp.build_sc_lists(rays, st["sc_bmin"], st["sc_bmax"])
    res = sp.stream_rows(rays, ids, tns, st["sc_tri"], any_hit)
    if any_hit:
        assert np.array_equal(res.numpy(), out[:, 0] > 0.5)
        assert 30 < int(res.sum()) < 128
        return
    t, u, v, vp = (x.numpy() for x in res)
    vp_ref = out[:, 3].view(np.int32)
    assert np.array_equal(vp, vp_ref)
    hit = vp_ref >= 0
    assert hit.sum() > 30
    for a, k in ((t, 0), (u, 1), (v, 2)):
        np.testing.assert_allclose(a[hit], out[:, k][hit], rtol=1e-5,
                                   atol=1e-5)


def test_stream_closest_maps_true_prims(case):
    """stream_closest's prim ids are soup indices: against the oracle."""
    o, d, mint, maxt = case["rays"]
    t, u, v, prim, valid = sp.stream_closest(
        case["tg"].st_tables,
        *[torch.from_numpy(x) for x in (o, d, mint, maxt)])
    ray = JaxRay(*[jnp.asarray(x) for x in (o, d, mint, maxt)])
    t0, _u0, _v0, p0, ok0 = (np.asarray(x)
                             for x in _closest_brute(case["jg"], ray))
    assert np.array_equal(valid.numpy(), ok0)
    assert (prim.numpy()[ok0] == p0[ok0]).mean() >= 0.99
    np.testing.assert_allclose(t.numpy()[ok0], t0[ok0], rtol=1e-5,
                               atol=1e-5)
