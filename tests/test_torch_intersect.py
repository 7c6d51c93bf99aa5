"""The port's fused intersector (ops/intersect.py) against the reference.

On the CPU the wrapper runs the kernel's plain PyTorch version, so these
tests hold that version against (a) the TPU kernel itself, run in Pallas
interpret mode on a small table, and (b) the reference's XLA oracle on the
full Cornell table. Inputs are made with numpy from fixed seeds.

Tolerances: prim, material, emitter and shape ids and the occlusion mask
must be equal. t, u and v within 1e-5 relative (with 1e-6 absolute for
barycentrics near 0 at an edge): the port evaluates the kernel's float32
operations in the kernel's order, but XLA may reassociate or contract
them, which moves the last bits. Normals and uv within 1e-5 absolute, for
the same reason plus the reference's rsqrt.
"""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.core import math as jm
from mitsuba_tpu.ops import intersect_pallas as jip
from mitsuba_tpu.render import intersect as jri
from mitsuba_tpu.render.records import Ray as JaxRay
from mitsuba_tpu.render.scene import cornell_box as jax_cornell_box
from mitsuba_tpu_torch.interop import from_jax_scene
from mitsuba_tpu_torch.ops import intersect as ip

torch.set_num_threads(1)


def _tables(seed=0):
    """8 triangles: random ones, an exact duplicate of triangle 1 (a tie
    the lower index must win) and a degenerate one (det = 0)."""
    rng = np.random.default_rng(seed)
    t = 8
    v = rng.uniform(-1.0, 1.0, (t, 3, 3)).astype(np.float32)
    v[:, :, 2] += np.linspace(0.0, 1.4, t, dtype=np.float32)[:, None]
    v[2] = v[1]                                   # duplicate
    v[3, 2] = 0.5 * (v[3, 0] + v[3, 1])           # degenerate
    n = rng.normal(size=(t, 3, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    uv = rng.uniform(0.0, 1.0, (t, 3, 2)).astype(np.float32)
    g = dict(v0=v[:, 0], e1=v[:, 1] - v[:, 0], e2=v[:, 2] - v[:, 0],
             n0=n[:, 0], n1=n[:, 1], n2=n[:, 2],
             uv0=uv[:, 0], uv1=uv[:, 1], uv2=uv[:, 2],
             material_id=np.arange(t, dtype=np.int32) % 3,
             emitter_id=np.where(np.arange(t) % 4 == 1, 0, -1)
             .astype(np.int32),
             shape_id=np.arange(t, dtype=np.int32) + 10)
    return g


def _rays(g, seed, n):
    """Rays from below aimed at random points of random triangles."""
    rng = np.random.default_rng(seed)
    tri = rng.integers(0, g["v0"].shape[0], n)
    b = rng.dirichlet((1.0, 1.0, 1.0), n).astype(np.float32)
    target = (g["v0"][tri] + b[:, 1:2] * g["e1"][tri]
              + b[:, 2:3] * g["e2"][tri])
    target += rng.normal(scale=0.05, size=(n, 3)).astype(np.float32)
    o = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    o[:, 2] -= 3.0
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    mint = np.full(n, 1e-4, np.float32)
    maxt = np.full(n, np.inf, np.float32)
    return o, d.astype(np.float32), mint, maxt


def _torch_args(table, rays, srays):
    return [torch.from_numpy(np.array(x))
            for x in (table, *rays, *srays)]


def _assert_records_match(rec, occ, ref, ref_occ):
    for k in ("prim", "material_id", "emitter_id", "shape_id", "valid"):
        np.testing.assert_array_equal(rec[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(ref_occ))
    hit = rec["valid"].numpy()
    for k in ("t", "u", "v"):
        np.testing.assert_allclose(rec[k].numpy()[hit],
                                   np.asarray(ref[k])[hit],
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    for k in ("geo_n", "sh_n", "uv"):
        np.testing.assert_allclose(rec[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=1e-5, err_msg=k)


def test_shading_table_matches_reference():
    jscene = jax_cornell_box(8, 8)
    port = ip.make_shading_table(
        from_jax_scene(jscene, device="cpu").geom)
    ref = np.asarray(jip.make_shading_table(jscene.geom))
    assert port.shape == (32, ip.SHD_COLS)
    np.testing.assert_array_equal(port.numpy(), ref)


def test_ref_matches_interpreted_tpu_kernel():
    g = _tables(0)
    jtable = jip.make_shading_table(
        SimpleNamespace(**{k: jnp.asarray(v) for k, v in g.items()}))
    table = np.asarray(jtable)
    o, d, mint, maxt = _rays(g, 1, 300)
    so, sd, smint, smaxt = _rays(g, 2, 300)
    maxt[:20] = -1.0                                  # dead lanes
    smaxt[:20] = -1.0
    smaxt[100:140] = 2.0
    first, _ = ip.closest_hit_shaded_and_any_ref(
        *_torch_args(table, (o, d, mint, maxt), (so, sd, smint, smaxt)))
    t0 = first["t"].numpy()
    hit = np.nonzero(np.isfinite(t0))[0]
    # lanes whose closest hit sits just inside or just outside the mint or
    # maxt bound (1e-5 relative: far above the ulp by which XLA's t may
    # differ, far below the gap to the next triangle)
    below, above = np.float32(1 - 1e-5), np.float32(1 + 1e-5)
    maxt[hit[20:30]] = t0[hit[20:30]] * below       # skips the hit
    maxt[hit[30:40]] = t0[hit[30:40]] * above       # keeps it
    mint[hit[40:50]] = t0[hit[40:50]] * above       # skips it
    mint[hit[50:60]] = t0[hit[50:60]] * below       # keeps it

    rec, occ = ip.closest_hit_shaded_and_any(
        *_torch_args(table, (o, d, mint, maxt), (so, sd, smint, smaxt)))
    ref, ref_occ = jip.closest_hit_shaded_and_any(
        jtable, o, d, mint, maxt, so, sd, smint, smaxt, interpret=True)
    _assert_records_match(rec, occ, ref, ref_occ)
    prim, t = rec["prim"].numpy(), rec["t"].numpy()
    assert (prim == 1).any() and not (prim == 2).any()   # tie: lower index
    assert not (prim == 3).any()                         # degenerate
    assert (prim[:20] == -1).all()
    assert (t[hit[20:30]] != t0[hit[20:30]]).all()
    assert (t[hit[40:50]] != t0[hit[40:50]]).all()
    assert (t[hit[30:40]] == t0[hit[30:40]]).all()
    assert (t[hit[50:60]] == t0[hit[50:60]]).all()
    assert 0 < occ.sum() < occ.numel()

    # exactly on a bound: t > mint and t < maxt are strict, so the
    # bounding triangle is skipped (the port against itself: XLA's t may
    # differ from the kernel's by an ulp, so the reference cannot say)
    mint[:], maxt[:] = 1e-4, np.inf
    maxt[hit[:30]] = t0[hit[:30]]
    mint[hit[30:60]] = t0[hit[30:60]]
    rec, _ = ip.closest_hit_shaded_and_any(
        *_torch_args(table, (o, d, mint, maxt), (so, sd, smint, smaxt)))
    assert (rec["t"].numpy()[hit[:60]] != t0[hit[:60]]).all()


def test_ref_matches_xla_oracle_on_cornell_table():
    jscene = jax_cornell_box(8, 8)
    geom = jscene.geom
    rng = np.random.default_rng(5)
    n = 2000
    lo, hi = np.array([1.0, 1.0, 1.0]), np.array([550.0, 540.0, 555.0])
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    mint = np.full(n, 1e-4, np.float32)
    maxt = np.where(np.arange(n) % 7 == 0, -1.0, np.inf).astype(np.float32)
    so = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    st = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    sdist = np.linalg.norm(st - so, axis=-1).astype(np.float32)
    sd = ((st - so) / sdist[:, None]).astype(np.float32)
    smint = np.full(n, 1e-2, np.float32)
    smaxt = sdist * np.float32(0.999)

    table = np.asarray(jip.make_shading_table(geom))
    rec, occ = ip.closest_hit_shaded_and_any(
        *_torch_args(table, (o, d, mint, maxt), (so, sd, smint, smaxt)))

    ray = JaxRay.make(jnp.asarray(o), jnp.asarray(d), jnp.asarray(mint),
                      jnp.asarray(maxt))
    sray = JaxRay.make(jnp.asarray(so), jnp.asarray(sd), jnp.asarray(smint),
                       jnp.asarray(smaxt))
    t, u, v, prim, valid = jri._closest_brute(geom, ray)
    ref_occ = jri._any_brute(geom, sray)
    prim = jnp.where(valid, prim, -1)
    p = jnp.maximum(prim, 0)
    w = 1.0 - u - v
    # the reference's shading interpolation (render/intersect.py:1386-1392)
    geo_n = jm.normalize(jnp.cross(geom.e1[p], geom.e2[p]))
    sh_n = jm.normalize(w[:, None] * geom.n0[p] + u[:, None] * geom.n1[p]
                        + v[:, None] * geom.n2[p])
    uv = w[:, None] * geom.uv0[p] + u[:, None] * geom.uv1[p] \
        + v[:, None] * geom.uv2[p]
    miss = ~valid[:, None]
    z = jnp.asarray([0.0, 0.0, 1.0])
    ref = dict(
        t=t, u=u, v=v, prim=prim, valid=valid,
        geo_n=jnp.where(miss, z, geo_n), sh_n=jnp.where(miss, z, sh_n),
        uv=jnp.where(miss, 0.0, uv),
        material_id=jnp.where(valid, geom.material_id[p], -1),
        emitter_id=jnp.where(valid, geom.emitter_id[p], -1),
        shape_id=jnp.where(valid, geom.shape_id[p], -1),
    )
    _assert_records_match(rec, occ, ref, ref_occ)
    assert rec["valid"].numpy().mean() > 0.5
    assert (rec["prim"].numpy()[maxt < 0] == -1).all()


def test_wrapper_rejects_what_the_kernel_does_not_take():
    g = _tables(3)
    table = np.asarray(jip.make_shading_table(
        SimpleNamespace(**{k: jnp.asarray(v) for k, v in g.items()})))
    rays = _rays(g, 4, 16)
    args = _torch_args(table, rays, rays)
    with pytest.raises(TypeError):
        ip.closest_hit_shaded_and_any(args[0].double(), *args[1:])
    with pytest.raises(ValueError):
        ip.closest_hit_shaded_and_any(args[0][:, :9], *args[1:])
    with pytest.raises(ValueError):
        ip.closest_hit_shaded_and_any(args[0], args[1].t().contiguous().t(),
                                      *args[2:])
    with pytest.raises(ValueError):
        ip.closest_hit_shaded_and_any(*args[:4], args[4][:8], *args[5:])
    with pytest.raises(NotImplementedError):
        ip.closest_hit_shaded_and_any(*[a.to("meta") for a in args])
    assert ip.LAUNCHES == 0        # the CPU path never counts a launch
