"""The port's cost probes on the CPU: their plain versions (ops/probes.py,
ops/worklist.py `wl_probe`) against the JAX package's and the TPU probe
scripts' kernels in interpret mode, on the same inputs.

* #13: `wl_probe` against `worklist_pallas.wl_probe(..., interpret=True)`
  on test_torch_worklist.py's flat case, bit for bit on every row the
  list reached (the reference leaves the other rows unwritten), with
  equal overflow flags.
* #15: the scripts' kernel bodies are closures, so each script runs as it
  stands with its `pl` replaced by one whose pallas_call interprets, and
  its `bench` / `timed` by a capture that runs the jitted probe once at a
  small step count, keeps the inputs it was given and the sum it returns.
  The plain version then takes those inputs; the sums agree within
  float32 rounding of sums taken in another order (rtol 1e-5 of the sum
  of magnitudes; XLA on the CPU may also contract a multiply-add into one
  FMA). The scripts draw unseeded numpy inputs: the global numpy state is
  seeded for the call and restored after it.
* exp_r3_mt.py's bodies run inside a three-line kernel at R = 2, giving
  full (8, 128) outputs (the scripts' approximate reciprocals, which the
  interpreter rounds through bfloat16, become exact divisions, as in the
  plain versions); exp_r5_megakernel.pallas_gather equals table[idx]
  and so does the plain gather; exp_r3_refinebits.py runs at a small size
  with the refine kernel's outputs recorded by a debug callback.

Importing the scripts sets two JAX options (the persistent cache); both
are restored right after the import.
"""
import functools
import sys
import types
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from mitsuba_tpu.ops import exact_pallas as jep
from mitsuba_tpu.ops import worklist_pallas as jwp
from mitsuba_tpu.render import intersect as jri
from mitsuba_tpu_torch.ops import probes as pr
from mitsuba_tpu_torch.ops import worklist as wl
from mitsuba_tpu_torch.ops.exact import refine_ref
from mitsuba_tpu_torch.render import intersect as ri
from test_torch_bvh import _meshes
from test_torch_worklist import _reached_rows

_CACHE_OPTIONS = ("jax_compilation_cache_dir",
                  "jax_persistent_cache_min_compile_time_secs")


def _import_scripts():
    saved = {k: getattr(jax.config, k) for k in _CACHE_OPTIONS}
    path = list(sys.path)
    try:
        from scripts import exp_kernel_cost, exp_r3_kernel, exp_r3_mt
        from scripts import exp_r3_refinebits, exp_r5_megakernel
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
        sys.path[:] = path
    return types.SimpleNamespace(
        cost=exp_kernel_cost, r3k=exp_r3_kernel, r3mt=exp_r3_mt,
        bits=exp_r3_refinebits, mega=exp_r5_megakernel)


S = _import_scripts()
torch.set_num_threads(1)
RTOL = 1e-5


def _interpret_pl(pallas_call=None):
    """Pallas with pallas_call interpreting, and an exact reciprocal: the
    interpreter's approximate one rounds through bfloat16, where the plain
    versions divide exactly in place of the card's rcp.approx."""
    ns = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl)
                                  if not k.startswith("__")})
    ns.pallas_call = pallas_call or functools.partial(pl.pallas_call,
                                                      interpret=True)
    ns.reciprocal = lambda x, approx=False: 1.0 / x
    return ns


@pytest.fixture
def seeded():
    state = np.random.get_state()
    np.random.seed(7)
    yield
    np.random.set_state(state)


def _capture(steps, only=None):
    """A stand-in for the scripts' bench / timed: runs the jitted probe
    once at `steps`, keeps its inputs (numpy) and its returned sum; with
    `only`, runs just the call of that index."""
    seen = []
    calls = [0]

    def bench(*args, rounds=3):
        calls[0] += 1
        if only is not None and calls[0] - 1 != only:
            return 1.0
        if callable(args[0]):                 # timed(f, *a)
            fn, a = args[0], args[1:]
        else:                                  # bench(name, mk, *a)
            fn, a = args[1](steps), args[2:]
        seen.append(([np.asarray(x) for x in a], float(fn(*a))))
        return 1.0
    return bench, seen


def _close(got, ref, scale):
    assert abs(got - ref) <= RTOL * scale + 1e-30, (got, ref, scale)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# #13, the work-list probe
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def flat_case():
    """test_torch_worklist.py's flat case: both packages' tables and
    1,100 rays (9 rows) from around the scene toward its middle."""
    jg = jri.build_geometry(_meshes(), backend="cluster")
    tg = ri.build_geometry(_meshes(), backend="cluster")
    lo, hi = np.asarray(jg.bvh_min[0]), np.asarray(jg.bvh_max[0])
    mid = 0.5 * (lo + hi)
    rng = np.random.default_rng(11)
    n = 1100
    o = (mid + rng.uniform(-1, 1, (n, 3)) * (hi - lo) * 0.8).astype(
        np.float32)
    o[:, 1] += 3.0
    d = (mid + rng.normal(scale=0.3, size=(n, 3)) * (hi - lo)).astype(
        np.float32) - o
    d[::13, :2] = 0.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    mint = np.full(n, 1e-4, np.float32)
    maxt = rng.uniform(5.0, 50.0, n).astype(np.float32)
    maxt[::9] = -1.0
    return jg.wl_tables, tg.wl_tables, [np.ascontiguousarray(x)
                                        for x in (o, d, mint, maxt)]


@pytest.mark.parametrize("beams", [(8, 8, 4), (16, 24, 16)])
def test_wl_probe_matches_tpu_kernel(flat_case, beams):
    """Small beams (rows overflow, some are never reached) and the
    reference's defaults."""
    jt, tt, rays = flat_case
    w_factor, l_sc, beam_s2 = beams
    jrays = [jnp.asarray(x) for x in rays]
    acc_r, ovf_r = jwp.wl_probe(jt, *jrays, w_factor=w_factor, l_sc=l_sc,
                                beam_s2=beam_s2, interpret=True)
    acc, ovf = wl.wl_probe(tt, *[_t(x) for x in rays], w_factor=w_factor,
                           l_sc=l_sc, beam_s2=beam_s2)
    jr = jwp._pack_rays(*jrays)[0]
    reached = _reached_rows(jwp.build_worklist(
        jr, jt["bmin"], jt["bmax"], jt["sc_bmin"], jt["sc_bmax"],
        jr.shape[0] * w_factor, l_sc, beam_s2)[0], jr.shape[0])
    lanes = np.repeat(reached, 128)[:len(rays[0])]
    assert np.array_equal(ovf.numpy(), np.asarray(ovf_r))
    assert lanes.mean() > 0.3
    acc_r = np.asarray(acc_r)
    assert np.array_equal(acc.numpy()[lanes], acc_r[lanes])
    # per lane the passes differ (tri[cid, 0, 0] is the same for a row)
    assert len(np.unique(acc_r[lanes])) > 10 and not ovf.all()
    assert (acc.numpy()[~lanes] == 0.0).all()
    if beams[0] == 8:
        assert ovf.any() and not lanes.all()


def test_wl_probe_refuses_instanced_tables(flat_case):
    _jt, tt, rays = flat_case
    with pytest.raises(ValueError):
        wl.wl_probe(dict(tt, block_id=tt["tri_start"]),
                    *[_t(x) for x in rays])


# ---------------------------------------------------------------------------
# exp_kernel_cost.py
# ---------------------------------------------------------------------------

def _cost(monkeypatch, steps):
    bench, seen = _capture(steps)
    monkeypatch.setattr(S.cost, "pl", _interpret_pl())
    monkeypatch.setattr(S.cost, "bench", bench)
    return seen


def test_vpu_fma_matches_script(monkeypatch, seeded):
    seen = _cost(monkeypatch, 2)
    S.cost.run_vpu_fma(n_ops=64)
    (a, b), got = seen[0]
    out = pr.fma_ref(_t(a), _t(b), 64, 2)
    _close(float(out.sum()), got, float(out.abs().sum()))


@pytest.mark.parametrize("kcl", [32])
def test_vpu_mt_matches_script(monkeypatch, seeded, kcl):
    """At 32 triangles (the 128-triangle form is the same code over more
    chunks; the CUDA tests hold both against the plain version)."""
    seen = _cost(monkeypatch, 2)
    S.cost.run_vpu_mt(kcl)
    (tri, rays), got = seen[0]
    t, p = pr.mt_ref(_t(tri[0]), _t(rays[0]), 2)
    assert int((p >= 0).sum()) > 10
    ref = float(t.sum()) + float(p.sum())
    _close(ref, got, float(t.abs().sum()) + float(p.abs().sum()))


@pytest.mark.parametrize("m,k", [(512, 10), (4096, 10), (512, 128)])
def test_mm_matches_script(monkeypatch, seeded, m, k):
    """K = 10 against the ordered float32 sums; K = 128 (tensor cores
    only in the port) against the TF32 and bf16 forms, within their
    rounding unit (2^-11, 2^-8) of the sum of |g m|."""
    seen = _cost(monkeypatch, 2)
    S.cost.run_mm("mm", jax.lax.Precision.HIGHEST, m=m, k=k)
    (G, M), got = seen[0]
    G, M = _t(G), _t(M)
    mag = float((G.double().abs() @ M.double().abs())[0:8].sum()) * 2
    if k == 10:
        out, _mx = pr.mm_cuda_ref(G, M, 2)
        _close(float(out.sum()), got, mag)
    for kind, unit in (("tf32", 2.0 ** -11), ("bf16", 2.0 ** -8)):
        out, _mx = pr.mm_tc_ref(G, M, 2, kind)
        assert abs(float(out.sum()) - got) <= 2 * unit * mag


@pytest.mark.parametrize("gate", [False, True])
def test_empty_matches_script(monkeypatch, seeded, gate):
    seen = _cost(monkeypatch, 3)
    S.cost.run_empty(gate)
    (g,), got = seen[0]
    g = _t(g)
    ids = torch.zeros(3, dtype=torch.int32)
    out = pr.gate_ref(g, ids, torch.full((3,), int(gate), dtype=torch.int32))
    _close(float(out.sum()), got, float(g[0, 0:8].abs().sum()) * 3 * 128)
    assert (out.sum() != 0) == gate


@pytest.mark.parametrize("kb", [8, 32])
def test_dma_rotate_matches_script(monkeypatch, seeded, kb):
    seen = _cost(monkeypatch, 70)
    S.cost.run_dma_rotate(kb)
    (g,), got = seen[0]
    g = _t(g)
    ids = torch.arange(70, dtype=torch.int32) % 64
    out = pr.rotate_ref(g, ids)
    _close(float(out.sum()), got,
           float(g[ids.long(), 0:8].abs().sum()) * 128)


# ---------------------------------------------------------------------------
# exp_r3_kernel.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fetch", [False, True])
def test_grid_floor_matches_script(monkeypatch, fetch):
    timed, seen = _capture(None)
    monkeypatch.setattr(S.r3k, "pl", _interpret_pl())
    monkeypatch.setattr(S.r3k, "timed", timed)
    S.r3k.bench_grid_floor(5, fetch, n_tri_blocks=16)
    (items, tri), got = seen[0]
    out = pr.grid_ref(_t(tri), _t(items), fetch)
    assert float(out[0, 0]) == 5.0
    _close(float(out[0, 0] * torch.tensor(1e-30)), got, abs(got))


def test_mt_ceiling_matches_script(monkeypatch):
    timed, seen = _capture(None)
    monkeypatch.setattr(S.r3k, "pl", _interpret_pl())
    monkeypatch.setattr(S.r3k, "timed", timed)
    S.r3k.bench_mt_ceiling(R=1)
    (tri, rays), got = seen[0]
    acc, hits = pr.v1_ref(_t(tri[0]), _t(rays), 1, add_u=False)
    assert int(hits.sum()) == 0                 # the script's block is flat
    _close(float(acc[0, 0] * torch.tensor(1e-30)), got, abs(got))


# ---------------------------------------------------------------------------
# exp_r3_mt.py: the variants' bodies, full outputs
# ---------------------------------------------------------------------------

def _variant(body, reps=2):
    tri = np.random.RandomState(0).rand(1, 32, 16).astype(np.float32)
    rays = np.random.RandomState(1).rand(8, 128).astype(np.float32)

    def kernel(tri_ref, rays_ref, out_ref):
        out_ref[...] = jax.lax.fori_loop(0, reps, body(tri_ref, rays_ref),
                                         jnp.zeros((8, 128), jnp.float32))
    out = pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct(
        (8, 128), jnp.float32), interpret=True)(jnp.asarray(tri),
                                                jnp.asarray(rays))
    return np.asarray(out), _t(tri[0]), _t(rays)


@pytest.mark.parametrize("name", ["v0", "v1", "v2", "v3", "v4"])
def test_mt_variant_matches_script(name, monkeypatch):
    """Infinite entries (a miss's 3e38 added twice) equal; the finite
    ones within RTOL of each other."""
    monkeypatch.setattr(S.r3mt, "pl", _interpret_pl())
    body = {"v0": S.r3mt.v0_fma, "v1": S.r3mt.v1_current,
            "v2": S.r3mt.v2_recip_packed, "v3": S.r3mt.v3_broadcast,
            "v4": S.r3mt.v4_divfree}[name]
    ref, tri, rays = _variant(body)
    if name == "v0":
        got = pr.v0_ref(rays, 2)
    elif name == "v1":
        got, hits = pr.v1_ref(tri, rays, 2)
        assert int(hits.sum()) > 50
    else:
        got, hits = pr.packed_ref(tri, rays, 2, divfree=name == "v4")
        assert int(hits.sum()) > 50
    got = got.numpy()
    assert np.array_equal(np.isfinite(got), np.isfinite(ref))
    fin = np.isfinite(ref)
    assert fin.mean() > 0.1
    np.testing.assert_allclose(got[fin], ref[fin], rtol=RTOL)


# ---------------------------------------------------------------------------
# exp_r5_megakernel.py and exp_r3_refinebits.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [512, 2048])
def test_gather_matches_script(k):
    rng = np.random.default_rng(k)
    table = rng.random(k).astype(np.float32)
    idx = rng.integers(0, k, 1024).astype(np.int32)
    ref = np.asarray(S.mega.pallas_gather(jnp.asarray(table),
                                          jnp.asarray(idx), k,
                                          interpret=True))
    assert np.array_equal(ref, table[idx])
    assert np.array_equal(pr.gather_ref(_t(table), _t(idx)).numpy(), ref)


def test_refinebits_refine_matches_script(monkeypatch):
    """The script at R = 8, E = 640 (504 live), C = 64 in one chunk of 8
    rows, its stage (b) alone (the kernel): the refine keys, unpacked as
    the script unpacks them, equal the port's on the live entries."""
    for name, v in dict(R=8, E=640, C=64, K_IT=1, RC=8).items():
        monkeypatch.setattr(S.bits, name, v)
    calls = []

    def pallas_call(kernel, **kw):
        f = pl.pallas_call(kernel, interpret=True, **kw)

        def call(*args):
            out = f(*args)
            jax.debug.callback(
                lambda *xs: calls.append([np.asarray(x) for x in xs]),
                *args, out)
            return out
        return call

    timed, seen = _capture(None, only=1)
    monkeypatch.setattr(jep, "pl", _interpret_pl(pallas_call))
    monkeypatch.setattr(S.bits, "timed", timed)
    S.bits.main()
    (ids, rays, live), _sum = seen[0]
    key0 = jax.random.PRNGKey(0)
    blo = np.asarray(jax.random.uniform(key0, (64, 3)))
    inv = np.argsort(np.asarray(jep._pack_perm(640)))
    assert calls
    live_c, rays_c, _boxes, out = calls[0]
    assert np.array_equal(rays_c, rays)
    key = out.reshape(8, 5, 8, 16, 8)[..., 0].reshape(8, 640)[:, inv]
    got = refine_ref(_t(rays_c), _t(ids), _t(live_c), _t(blo),
                     _t(blo + np.float32(0.1)))
    assert np.array_equal(got.numpy()[:, :504], key[:, :504])
    assert (key[:, :504] < 3e38).sum() > 100


# ---------------------------------------------------------------------------
# the float32 arithmetic of the kernels, and the drivers on the CPU
# ---------------------------------------------------------------------------

def _nearest_f32(x: Fraction) -> np.float32:
    """The float32 nearest the rational x, ties to even."""
    f = np.float32(float(x))
    cands = [f, np.nextafter(f, np.float32(np.inf)),
             np.nextafter(f, np.float32(-np.inf))]
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - x),
                                     int(np.array(c).view(np.int32)) & 1))


def test_fma32_rounds_once():
    """Random operands and products that land on a float32 midpoint with
    an addend far below the float64 unit (where rounding the float64 sum
    would round twice)."""
    rng = np.random.default_rng(3)
    n = 3000
    a = rng.standard_normal(n).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    c = (rng.standard_normal(n) * 10.0 ** rng.integers(-12, 3, n)).astype(
        np.float32)
    a[:4] = b[:4] = np.float32(1 + 2 ** -12)     # a * b: a midpoint
    c[:4] = (2 ** -60, -2 ** -60, 0.0, 2 ** -70)
    got = pr.fma32(_t(a), _t(b), _t(c)).numpy()
    want = np.array([_nearest_f32(Fraction(float(x)) * Fraction(float(y))
                                  + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert (got[:4] - 1) * 2 ** 23 == pytest.approx([4097, 4096, 4096, 4097])


def _rna_tf32(x: np.float32) -> np.float32:
    """cvt.rna.tf32.f32 exactly: the nearest value with a 10-bit mantissa
    (ulp 2^(e - 10), or 2^-136 below the normal range), ties away from
    zero, the sign kept (a tiny negative value rounds to -0); beyond the
    largest float32, infinity."""
    if x == 0:
        return x
    f = abs(Fraction(float(x)))
    e = max(int(np.floor(np.log2(float(f)))), -126)
    ulp = Fraction(2) ** (e - 10)
    q = f / ulp
    r = (int(q) + (1 if q - int(q) >= Fraction(1, 2) else 0)) * ulp
    mag = np.float32(np.inf) if r >= 2 ** 128 else np.float32(float(r))
    return np.copysign(mag, x)


def test_round_tf32_is_nearest_ties_away():
    x = np.array([1 + 2 ** -11, 1 + 2 ** -11 + 2 ** -23, -(1 + 2 ** -11),
                  1 + 2 ** -12, 3.0], np.float32)
    got = pr.round_tf32(_t(x)).numpy()
    assert np.array_equal(got, np.array([1 + 2 ** -10, 1 + 2 ** -10,
                                         -(1 + 2 ** -10), 1.0, 3.0],
                                        np.float32))
    assert not (got.view(np.int32) & 0x1FFF).any()
    # planted: the 13 dropped bits a tie (0x1000), one either side, none
    # and all, in both signs, on bases where a tie carries into the
    # exponent, among the subnormals and at the largest finite values,
    # against an exact cvt.rna
    bits = np.array([(base | low) ^ sign
                     for base in (0x3F800000, 0x40490000, 0x3F801000,
                                  0x00000000, 0x00400000, 0x3FFFE000,
                                  0x7F7FE000, 0x0080A000)
                     for low in (0x1000, 0x0FFF, 0x1001, 0x0000, 0x1FFF,
                                 0x0001)
                     for sign in (0, 0x80000000)], np.uint32)
    x = bits.view(np.float32).copy()
    got = pr.round_tf32(_t(x)).numpy()
    want = np.array([_rna_tf32(v) for v in x], np.float32)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    tie = (bits & 0x1FFF) == 0x1000
    assert np.all(np.abs(got[tie]) > np.abs(x[tie]))      # away from zero


def _rne_bf16(x: np.float32) -> np.float32:
    """float32 -> bfloat16 exactly, kept as float32: the nearest value
    with a 7-bit mantissa (ulp 2^(e - 7), or 2^-133 below the normal
    range), ties to the even mantissa, the sign kept; beyond the largest
    bfloat16 (halfway to 2^128 and up), infinity."""
    if x == 0:
        return x
    f = abs(Fraction(float(x)))
    e = max(int(np.floor(np.log2(float(f)))), -126)
    ulp = Fraction(2) ** (e - 7)
    q = f / ulp
    n = int(q)
    if q - n > Fraction(1, 2) or (q - n == Fraction(1, 2) and n % 2):
        n += 1
    r = n * ulp
    mag = np.float32(np.inf) if r >= 2 ** 128 else np.float32(float(r))
    return np.copysign(mag, x)


def test_round_bf16_is_nearest_even():
    """The plain version's bf16 conversion (what mm_bf16's cvt.rn.bf16x2
    must match) on planted values: the 16 dropped bits a tie (0x8000),
    one either side, none and all, in both signs, on bases whose kept
    mantissa is even and odd, where a tie carries into the exponent,
    among the subnormals and at the largest finite values (a tie there
    rounds to infinity), against an exact round-to-nearest-even."""
    x = np.array([1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8),
                  1 + 2 ** -8 + 2 ** -20, 3.0], np.float32)
    got = pr.round_bf16(_t(x)).numpy()
    assert np.array_equal(got, np.array([1.0, 1 + 2 ** -6, -1.0,
                                         1 + 2 ** -7, 3.0], np.float32))
    bits = np.array([(base | low) ^ sign
                     for base in (0x3F800000, 0x3F810000, 0x40490000,
                                  0x3FFF0000, 0x3FFE0000, 0x00000000,
                                  0x00010000, 0x00400000, 0x7F7E0000,
                                  0x7F7F0000, 0x00800000)
                     for low in (0x8000, 0x7FFF, 0x8001, 0x0000, 0xFFFF,
                                 0x0001)
                     for sign in (0, 0x80000000)], np.uint32)
    x = bits.view(np.float32).copy()
    got = pr.round_bf16(_t(x)).numpy()
    want = np.array([_rne_bf16(v) for v in x], np.float32)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert not (got.view(np.uint32) & 0xFFFF).any()
    tie = (bits & 0xFFFF) == 0x8000
    even = (got.view(np.uint32)[tie] >> 16) & 1
    assert not even[np.isfinite(got[tie])].any()           # to even
    assert np.isinf(got[tie & ((bits & 0x7FFFFFFF) >> 16 == 0x7F7F)]).all()
    # the tensor-core inputs of the plain version are these values
    G = _t(x[:64].reshape(64, 1))
    gq, _ = pr._tc_inputs(G, _t(np.ones((1, 128), np.float32)), "bf16")
    assert np.array_equal(gq[:, 0].numpy().view(np.uint32),
                          want[:64].view(np.uint32))


@pytest.mark.parametrize("form", ["misaligned", "strided", "sized"])
def test_rotate_refuses_what_the_bulk_copy_cannot_take(form):
    """rotate's ring copies each block as one bulk copy: a source on 16
    bytes, a multiple of 16 bytes. A g that starts 4 bytes past an
    aligned address, one whose rows are strided, and one whose block is
    not (rows, 16) floats (here 9 x 15, not a multiple of 4) raise before
    any kernel or plain version runs, on the CPU as on the card."""
    ids = torch.zeros(3, dtype=torch.int32)
    if form == "misaligned":
        flat = torch.zeros(4 * 128 * 16 + 1)
        g = flat[1:].view(4, 128, 16)
        assert g.is_contiguous() and g.data_ptr() % 16 == 4
    elif form == "strided":
        g = torch.zeros(4, 128, 32)[:, :, :16]
    else:
        g = torch.zeros(4, 9, 15)
    with pytest.raises(ValueError):
        pr.rotate(g, ids)
    ok = torch.zeros(4, 128, 16)
    assert pr.rotate(ok, ids).shape == (1, 8, 128)


def _misaligned(shape):
    """A contiguous float32 tensor starting 4 bytes past a 16-byte
    boundary."""
    numel = int(np.prod(shape))
    x = torch.zeros(numel + 4)[1:1 + numel].view(*shape)
    assert x.is_contiguous() and x.data_ptr() % 16 == 4
    return x


@pytest.mark.parametrize("form", ["misaligned", "strided", "float64"])
def test_gate_refuses_what_its_loads_cannot_take(form):
    """gate's kernel reads each row as four 16-byte loads: a g off 16
    bytes, one whose rows are strided and one that is not float32 (the
    kernel would read its bytes as float32 while the plain version
    computes in float64) raise before any kernel or plain version runs,
    on the CPU as on the card."""
    ids = torch.zeros(3, dtype=torch.int32)
    flags = torch.ones(3, dtype=torch.int32)
    if form == "misaligned":
        g = _misaligned((4, 512, 16))
    elif form == "strided":
        g = torch.zeros(4, 512, 32)[:, :, :16]
    else:
        g = torch.zeros(4, 512, 16, dtype=torch.float64)
    with pytest.raises(ValueError):
        pr.gate(g, ids, flags)
    assert pr.gate(torch.zeros(4, 512, 16), ids, flags).shape == (1, 8, 128)


def test_rotate_refuses_a_g_not_float32():
    """A float64 g (the kernel would read its bytes as float32) raises, on
    the CPU as on the card; so does float16."""
    ids = torch.zeros(3, dtype=torch.int32)
    for dtype in (torch.float64, torch.float16):
        with pytest.raises(ValueError):
            pr.rotate(torch.zeros(4, 128, 16, dtype=dtype), ids)


@pytest.mark.parametrize("fetch", [False, True])
def test_grid_refuses_a_misaligned_tri(fetch):
    """grid's ring copies each 2 KB block as one bulk copy, from a source
    on 16 bytes: a tri 4 bytes past a boundary raises before any kernel
    or plain version runs, on the CPU as on the card; a strided one too."""
    ids = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError):
        pr.grid(_misaligned((8, 4, 128)), ids, fetch)
    with pytest.raises(ValueError):
        pr.grid(torch.zeros(8, 4, 256)[..., :128], ids, fetch)
    assert pr.grid(torch.zeros(8, 4, 128), ids, fetch).shape == (1, 8, 128)


def test_grid_and_gate_take_no_items():
    """n = 0: zeros, as the plain versions give and the kernels write
    (grid's ring issues no copy; gate loads no list)."""
    none = torch.zeros(0, dtype=torch.int32)
    for fetch in (False, True):
        out = pr.grid(torch.ones(8, 4, 128), none, fetch, blocks=2)
        assert out.shape == (2, 8, 128) and not out.any()
    out = pr.gate(torch.ones(4, 512, 16), none, none, blocks=2)
    assert out.shape == (2, 8, 128) and not out.any()


def test_rotate_takes_no_items():
    """n = 0: the kernel takes it (no copy issued, the ring never waited
    on) and the sums are 0, as the plain version's."""
    g = torch.ones(4, 128, 16)
    out = pr.rotate(g, torch.zeros(0, dtype=torch.int32), blocks=2)
    assert out.shape == (2, 8, 128) and not out.any()


@pytest.mark.parametrize("module,sizes", [
    ("kernel_cost", dict(launches=(1, 2), fma=(1, 2), fma_card=(1, 2),
                         n_ops=2, mt=(1, 2), mt_card=(1, 2), mm=(1, 2),
                         mm_card=(1, 2), items=(2, 3), items_card=(2, 3))),
    ("r3_kernel", dict(grid=(2, 3), grid_card=(2, 3), mt=(1, 2),
                       mt_card=(1, 2), side=0)),
    ("r3_mt", dict(reps=(1, 2), reps_card=(1, 2))),
    ("r3_refinebits", dict(rows=4, entries=256, boxes=50, live=200)),
    ("r5_megakernel", dict(n=256, tables=(512,))),
])
def test_probe_driver_runs_on_the_cpu(module, sizes):
    """Each driver runs its probes' plain versions on the CPU and names
    the TPU script line of every probe; no time is measured there, and
    no launch: the product lines' shapes carry no `blocks_launched`,
    which only a launch's profiled grid gives."""
    import importlib

    mod = importlib.import_module(f"mitsuba_tpu_torch.probes.{module}")
    lines = mod.run("cpu", sizes=sizes)
    assert lines and all(ln["script"].startswith("scripts/exp_")
                         for ln in lines)
    assert all(ln["ms"] is None and ln["device"] == "cpu" for ln in lines)
    for ln in lines:
        if ln.get("probe") == "run_mm":
            assert set(ln["shape"]) == {"m", "k", "n", "k_padded"}


def test_r3_kernel_list_items_on_the_cpu():
    """Items D and E of exp_r3_kernel.py on config 3's list at 32 x 32
    lanes: the probe and the closest walk run on the same list."""
    from mitsuba_tpu_torch.probes import r3_kernel
    from mitsuba_tpu_torch.render.scene import textured_mesh_scene

    scene = textured_mesh_scene(16, 16, backend="cluster", device="cpu")
    case = r3_kernel.worklist_case("cpu", 32, scene)
    assert case[0]["tri"].shape[1:] == (32, 16) and case[1].shape == (1024,
                                                                       3)
    lines = r3_kernel._list_lines("cpu", case)
    assert [ln["item"] for ln in lines] == ["D", "E"]
    assert lines[0]["valid_items"] > 0
    # cutting the unused slots from the last row changes no result
    assert all(ln["trimmed_same"] for ln in lines)
