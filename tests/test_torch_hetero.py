"""The port's heterogeneous media, oriented Gaussian-flake media and the
`jax.random` pieces they draw, against the JAX package on the same
numpy-seeded inputs.

- `key`, `split`, `fold_in`, `key_data` / `wrap_key_data` and `uniform`
  of any shape, and the flake's per-lane proposal streams: bit for bit
  (jax 0.9, jax_threefry_partitionable=True).
- fit_fiber_sigma_t: equal arrays (the same float64 numpy code). The
  grid point transform and the trilinear density lookups: bit for bit
  (the port rounds the transform's fused multiply-add chain as XLA does
  on the CPU). The fiber field, sigmaDir and the ray march: rtol 1e-5
  (XLA contracts and reorders the 8-corner sums and the 32-step sums);
  the flake's value rtol 1e-4 and its inverse-cdf sample 1e-4 (erf and
  erfinv are other float32 polynomials in each library).
- Woodcock tracking, lane by lane: a decision u < ρ σ_max / σ̄ whose two
  sides sit within an ulp may flip; the flips are counted and held under
  0.1% of the lanes, and the distances of the other lanes within rtol
  1e-5. Flake sampling: >= 99.9% of lanes within 1e-4.
- `.vol` files: the bytes JAX's save_vol writes, and JAX's reads of the
  three encodings; the XML heterogeneous medium equal to from_jax_medium
  of the reference's load, field by field.
- volpath_trace in a grid medium and in an oriented flake medium, lane by
  lane against the reference's kernel path (its Pallas kernels #2 and #3
  in interpret mode, as tests/test_torch_volpath.py runs them): >= 99% of
  lanes within rtol 1e-4, the mean within 1e-3 relative.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba_tpu.render.intersect as jax_intersect
from mitsuba_tpu.core import transform as jtf
from mitsuba_tpu.integrators.path import PathConfig as JaxPathConfig
from mitsuba_tpu.integrators.volpath import volpath_trace as jax_volpath
from mitsuba_tpu.io import volio as jvolio
from mitsuba_tpu.io import xml as jxml
from mitsuba_tpu.media import medium as jmed
from mitsuba_tpu.media import phase as jphase
from mitsuba_tpu.ops import intersect_pallas
from mitsuba_tpu.render.sampler import Sampler as JaxSampler
from mitsuba_tpu.render.sampler import sample_position as jax_sample_position
from mitsuba_tpu.render.scene import cornell_box as jax_cornell_box
from mitsuba_tpu_torch.integrators import PathConfig, volpath_trace
from mitsuba_tpu_torch.integrators.path import camera_wavefront
from mitsuba_tpu_torch.interop import from_jax_medium, from_jax_scene
from mitsuba_tpu_torch.io import volio
from mitsuba_tpu_torch.io import xml as txml
from mitsuba_tpu_torch.media import medium as tmed
from mitsuba_tpu_torch.media import phase as tphase
from mitsuba_tpu_torch.render import sampler as rs
from tests import torch_media_cases as mc

torch.set_num_threads(1)
W = H = 8


def _t(x):
    return torch.from_numpy(np.array(x))


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


# ---------------------------------------------------------------------------
# the jax.random pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 17, 0x51AB, 2 ** 31 - 1])
def test_random_pieces_bitwise(seed):
    jk, tk = jax.random.key(seed), rs.key(seed)
    _bits_equal(jax.random.key_data(jk), rs.key_data(tk))
    for n in (1, 3, 5, 64):
        _bits_equal(jax.random.key_data(jax.random.split(jk, n)),
                    rs.key_data(rs.split(tk, n)))
    jf, tf_ = jax.random.fold_in(jk, 0x77), rs.fold_in_key(tk, 0x77)
    _bits_equal(jax.random.key_data(jf), rs.key_data(tf_))
    data = jax.random.key_data(jax.random.split(jf, 4))
    assert rs.wrap_key_data(np.asarray(data)) == rs.split(tf_, 4)
    assert rs.wrap_key_data(np.asarray(data)[2]) == rs.split(tf_, 4)[2]
    k1, k2 = (torch.tensor(k, dtype=torch.int64) for k in tf_)
    for shape in ((), (1,), (7,), (64, 3), (2, 3, 4)):
        _bits_equal(jax.random.uniform(jf, shape),
                    rs.uniform(k1, k2, shape if shape else 0))
    # a chunk of a longer draw: the counters are the flat indices
    _bits_equal(np.asarray(jax.random.uniform(jf, (100,)))[40:75],
                rs.uniform(k1, k2, (35,), start=40))
    # several host keys' draws at once (the Woodcock steps')
    keys4 = rs.split(tf_, 4)
    _bits_equal(np.stack([np.asarray(jax.random.uniform(k, (9,)))
                          for k in jax.random.split(jf, 4)]),
                rs.uniform_keys(keys4, 9))
    # the per-lane tensor keys, multi-dimensional
    keys = jax.random.split(jf, 6)
    kd = np.asarray(jax.random.key_data(keys)).astype(np.int64)
    _bits_equal(jax.vmap(lambda k: jax.random.uniform(k, (5, 3)))(keys),
                rs.uniform(_t(kd[:, 0]), _t(kd[:, 1]), (5, 3)))


# ---------------------------------------------------------------------------
# the Gaussian flake
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stddev", [0.05, 0.3, 1.0])
def test_flake_phase_matches_reference(stddev):
    rng = np.random.default_rng(3)
    n = 1500
    cj, ej = jphase.fit_fiber_sigma_t(stddev)
    ct, et = tphase.fit_fiber_sigma_t(stddev)
    np.testing.assert_array_equal(cj, ct)
    assert ej == et
    g = np.float32(stddev)
    gj, gt = jnp.asarray(g), _t(g)
    cos = rng.uniform(-1, 1, n).astype(np.float32)
    xi = rng.uniform(0, 1, n).astype(np.float32)
    kw = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tphase.gauss_fiber_sigma_t(_t(cos), _t(ct)).numpy(),
        jphase.gauss_fiber_sigma_t(cos, jnp.asarray(cj)), **kw)
    np.testing.assert_allclose(tphase.gauss_fiber_pdf_cos(_t(cos), gt),
                               jphase.gauss_fiber_pdf_cos(cos, gj), **kw)
    # erfinv: XLA's and PyTorch's float32 polynomials differ by up to
    # ~4e-5 relative near the ends of their range
    np.testing.assert_allclose(tphase.gauss_fiber_sample_cos(_t(xi), gt),
                               jphase.gauss_fiber_sample_cos(xi, gj),
                               rtol=1e-4, atol=1e-5)
    wi, wo, axis = _unit(rng, n), _unit(rng, n), _unit(rng, n)
    u2 = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    k = tphase.MICROFLAKE_GAUSS
    np.testing.assert_allclose(
        tphase.phase_eval(k, gt, _t(wi), _t(wo), _t(axis), _t(ct)),
        jphase.phase_eval(k, gj, wi, wo, axis, jnp.asarray(cj)), rtol=1e-4,
        atol=1e-6)
    # the proposals' uniforms, bit for bit (phase.py:193-197)
    b = jax.lax.bitcast_convert_type(jnp.asarray(u2), jnp.uint32)
    k1 = jax.vmap(jax.random.fold_in, (None, 0))(jax.random.key(0x51AB),
                                                  b[:, 0])
    k2 = jax.vmap(jax.random.fold_in)(k1, b[:, 1])
    _bits_equal(jax.vmap(lambda kk: jax.random.uniform(kk, (64, 3)))(k2),
                tphase.flake_proposals(_t(u2)))
    wo_r, pdf_r = jphase.phase_sample(k, gj, wi, u2, axis, jnp.asarray(cj))
    wo_s, pdf_s = tphase.phase_sample(k, gt, _t(wi), _t(u2), _t(axis),
                                      _t(ct))
    close = np.isclose(wo_s.numpy(), np.asarray(wo_r), rtol=1e-4,
                       atol=1e-5).all(-1)
    assert close.mean() >= 0.999, close.mean()
    np.testing.assert_array_equal(pdf_s.numpy() > 0, np.asarray(pdf_r) > 0)
    # testing the first 8 proposals, then all 64 only where those were all
    # rejected, changes no bit
    fr = tphase.m.Frame.from_normal(_t(axis))
    ok, dp, h = tphase._first_accept(gt, tphase.flake_proposals(_t(u2)), fr,
                                     -_t(wi))
    wo_all = torch.where(ok[:, None], 2.0 * dp[:, None] * h + _t(wi),
                         _t(wi))
    assert torch.equal(wo_all, wo_s)
    assert (~ok).sum() < n
    # chunked sampling changes no bit
    old = tphase.FLAKE_CHUNK
    try:
        tphase.FLAKE_CHUNK = 97
        wo_c, pdf_c = tphase.phase_sample(k, gt, _t(wi), _t(u2), _t(axis),
                                          _t(ct))
    finally:
        tphase.FLAKE_CHUNK = old
    assert torch.equal(wo_c, wo_s) and torch.equal(pdf_c, pdf_s)


def test_microflake_gauss_without_coefficients_raises():
    wi = torch.tensor([[0.0, 0.0, 1.0]])
    with pytest.raises(ValueError):
        tphase.phase_eval(tphase.MICROFLAKE_GAUSS, 0.3, wi, wi)
    with pytest.raises(ValueError):
        tphase.phase_sample(9, 0.3, wi, torch.full((1, 2), 0.5))


# ---------------------------------------------------------------------------
# grid media
# ---------------------------------------------------------------------------

def _media(kind):
    """(JAX medium, port medium) of a 9x7x11 noise grid under a rotated,
    scaled map; `flake` adds a fiber field and the Gaussian flake."""
    rng = np.random.default_rng(1)
    grid = rng.uniform(0, 1, (9, 7, 11)).astype(np.float32)
    w2g = np.asarray(jtf.compose(jtf.rotate([1, 2, 3], 31.0),
                                 jtf.scale([2.5, 1.7, 3.1]),
                                 jtf.translate([0.3, 0.2, -0.1])),
                     np.float32)
    kw = dict(density_scale=1.7)
    if kind == "flake":
        kw.update(orientation=rng.normal(size=(9, 7, 11, 3)).astype(
            np.float32), flake_stddev=0.3)
    args = (grid, w2g, (0.5, 0.6, 0.7), (0.1, 0.2, 0.05))
    return jmed.make_heterogeneous(*args, **kw), \
        tmed.make_heterogeneous(*args, **kw)


@pytest.mark.parametrize("kind", ["grid", "flake"])
def test_tables_equal_reference(kind):
    jm, tm = _media(kind)
    for conv in (tm, from_jax_medium(jm)):
        for f in ("sigma_s", "sigma_a", "phase_g", "density",
                  "world_to_grid", "density_scale", "max_density",
                  "orientation", "flake_coeffs"):
            a, b = getattr(conv, f), getattr(jm, f)
            assert (a is None) == (b is None), f
            if b is not None:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                              err_msg=f)
        assert (conv.kind, conv.phase_kind, conv.enabled) == (
            jm.kind, jm.phase_kind, jm.enabled)


@pytest.mark.parametrize("kind", ["grid", "flake"])
def test_lookups_and_ray_march_match_reference(kind):
    jm, tm = _media(kind)
    rng = np.random.default_rng(2)
    n = 4000
    p = rng.uniform(-3, 5, (n, 3)).astype(np.float32)
    d = _unit(rng, n)
    _bits_equal(jtf.apply_point(jnp.asarray(jm.world_to_grid), p),
                tmed.grid_point(tm.world_to_grid, _t(p)))
    _bits_equal(jmed.lookup_density(jm, p), tmed.lookup_density(tm, _t(p)))
    kw = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tmed.lookup_orientation(tm, _t(p)),
                               jmed.lookup_orientation(jm, p), **kw)
    np.testing.assert_allclose(tmed.sigma_dir_factor(tm, _t(d), _t(p)),
                               jmed.sigma_dir_factor(jm, d, p), **kw)
    o = rng.uniform(-1, 3, (n, 3)).astype(np.float32)
    dist = rng.uniform(0, 4, n).astype(np.float32)
    np.testing.assert_allclose(
        tmed.medium_transmittance(tm, _t(o), _t(d), _t(dist)),
        jmed.medium_transmittance(jm, o, d, dist), **kw)


@pytest.mark.parametrize("kind", ["grid", "flake"])
def test_woodcock_matches_reference_per_lane(kind):
    jm, tm = _media(kind)
    rng = np.random.default_rng(4)
    n = 6000
    o = rng.uniform(-1, 3, (n, 3)).astype(np.float32)
    d = _unit(rng, n)
    dist = rng.uniform(0, 4, n).astype(np.float32)
    u = rng.uniform(0, 1, (2, n)).astype(np.float32)
    ref = jmed.sample_distance(jm, o, d, dist, u[0], u[1],
                               key=jax.random.key(5))
    got = tmed.sample_distance(tm, _t(o), _t(d), _t(dist), _t(u[0]),
                               _t(u[1]), key=rs.key(5))
    va, vb = np.asarray(ref["valid"]), got["valid"].numpy()
    flips = int((va != vb).sum())
    assert flips <= n // 1000, flips
    assert 0.05 < vb.mean() < 0.95
    same = va == vb
    np.testing.assert_allclose(got["t"].numpy()[same],
                               np.asarray(ref["t"])[same], rtol=1e-5)
    for k in ("weight", "surface_weight"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-6)


def test_woodcock_tracks_the_homogeneous_medium():
    """A constant-density grid Woodcock-tracks the homogeneous medium
    (tests/test_media.py:140): the interaction probability and the mean
    distance within the Monte Carlo noise of 100,000 lanes."""
    grid, w2g = mc.const_grid_transform(20.0)
    hom = tmed.make_homogeneous((0.5,) * 3, (0.5,) * 3)
    het = tmed.make_heterogeneous(grid, w2g, (0.5,) * 3, (0.5,) * 3)
    n = 100_000
    o = torch.zeros((n, 3))
    d = torch.tensor([0.0, 0.0, 1.0]).expand(n, 3)
    dmax = torch.full((n,), 3.0)
    u = torch.rand((2, n), generator=torch.Generator().manual_seed(7))
    a = tmed.sample_distance(hom, o, d, dmax, u[0], u[1])
    b = tmed.sample_distance(het, o, d, dmax, u[0], u[1], key=rs.key(9),
                             n_woodcock=32)
    assert abs(float(a["valid"].float().mean())
               - float(b["valid"].float().mean())) < 0.01
    ta = float(a["t"][a["valid"]].mean())
    tb = float(b["t"][b["valid"]].mean())
    assert abs(ta - tb) < 0.02, (ta, tb)


# ---------------------------------------------------------------------------
# .vol files and the scene-file medium
# ---------------------------------------------------------------------------

def _vol_bytes(code, data, bmin, bmax):
    import struct

    zres, yres, xres, ch = data.shape
    head = b"VOL" + bytes([3]) + struct.pack("<iiiii", code, xres, yres,
                                             zres, ch)
    head += struct.pack("<6f", *bmin, *bmax)
    enc = {1: "<f4", 2: "<f2", 3: "u1"}[code]
    raw = (data * 255).round() if code == 3 else data
    return head + raw.astype(enc).tobytes()


@pytest.mark.parametrize("code", [1, 2, 3],
                         ids=["float32", "float16", "uint8"])
def test_vol_files_equal_reference(tmp_path, code):
    rng = np.random.default_rng(code)
    data = rng.uniform(0, 1, (5, 4, 6, 2)).astype(np.float32)
    bmin, bmax = (-1.0, 0.5, 2.0), (3.0, 1.5, 4.5)
    if code == 1:
        a, b = tmp_path / "a.vol", tmp_path / "b.vol"
        volio.save_vol(str(a), data, bmin, bmax)
        jvolio.save_vol(str(b), data, bmin, bmax)
        assert a.read_bytes() == b.read_bytes()
        volio.save_vol(str(a), data[..., 0], bmin, bmax)
        jvolio.save_vol(str(b), data[..., 0], bmin, bmax)
        assert a.read_bytes() == b.read_bytes()
    path = tmp_path / f"e{code}.vol"
    path.write_bytes(_vol_bytes(code, data, bmin, bmax))
    got, ref = volio.load_vol(str(path)), jvolio.load_vol(str(path))
    for x, y in zip(got, ref):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(
        volio.grid_world_to_index_transform(bmin, bmax, data.shape),
        jvolio.grid_world_to_index_transform(bmin, bmax, data.shape))
    with pytest.raises(ValueError):
        bad = tmp_path / "bad.vol"
        bad.write_bytes(b"VOL" + bytes([2]) + path.read_bytes()[4:])
        volio.load_vol(str(bad))


_HET_XML = """<scene>
 <medium type="heterogeneous">
  <rgb name="sigmaS" value="0.02 0.03 0.04"/><rgb name="sigmaA" value="0.01"/>
  <float name="densityMultiplier" value="1.5"/>
  <volume type="gridvolume" name="density">
   <string name="filename" value="d.vol"/></volume>
  {orient}
  {phase}
 </medium>
 <shape type="sphere"><bsdf type="diffuse"/></shape>
 <luminaire type="sky"/>
</scene>"""
_PHASES = {
    "hg": ('', '<phase type="hg"><float name="g" value="0.4"/></phase>'),
    "kkay": ('', '<phase type="kkay"/>'),
    "microflake": ('', '<phase type="microflake"/>'),
    "flake": ('<volume type="gridvolume" name="orientation"><string '
              'name="filename" value="o.vol"/></volume>',
              '<phase type="microflake"><float name="stddev" '
              'value="0.3"/></phase>'),
    "homogeneous_flake": ('', '<phase type="microflake"><float '
                              'name="stddev" value="0.2"/></phase>'),
}


@pytest.mark.parametrize("phase", sorted(_PHASES))
def test_xml_medium_equals_reference(tmp_path, phase):
    volio.save_vol(str(tmp_path / "d.vol"), mc.noise_grid(6, 2), (-2,) * 3,
                   (2,) * 3)
    volio.save_vol(str(tmp_path / "o.vol"), mc.fiber_field(6), (-2,) * 3,
                   (2,) * 3)
    orient, ph = _PHASES[phase]
    src = _HET_XML.format(orient=orient, phase=ph)
    if phase == "homogeneous_flake":
        src = src.replace('type="heterogeneous"', 'type="homogeneous"')
    _, cfg = txml.load_scene_string(src, base_dir=str(tmp_path),
                                    device="cpu")
    _, jcfg = jxml.load_scene_string(src, base_dir=str(tmp_path))
    got, ref = cfg["medium"], from_jax_medium(jcfg["medium"])
    for f in ("sigma_s", "sigma_a", "phase_g", "density", "world_to_grid",
              "density_scale", "max_density", "orientation",
              "flake_coeffs"):
        a, b = getattr(got, f), getattr(ref, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=f)
    assert (got.kind, got.phase_kind) == (ref.kind, ref.phase_kind)
    if phase == "homogeneous_flake":
        return
    with pytest.raises(txml.SceneParseError):
        txml.load_scene_string(src.replace('name="filename"', 'name="x"'),
                               base_dir=str(tmp_path), device="cpu")


# ---------------------------------------------------------------------------
# volpath_trace in a grid and in a flake medium, lane by lane
# ---------------------------------------------------------------------------

def _box_medium(make, kind):
    """A medium over the Cornell box: an 8³ noise grid (optical depth
    ~1-2 across the box), and for `flake` a fiber field with the Gaussian
    flake of stddev 0.3."""
    grid = mc.noise_grid(8, 5)
    w2g = mc.grid_to_box(grid.shape)
    kw = dict(g=0.4)
    if kind == "flake":
        kw = dict(orientation=mc.fiber_field(8), flake_stddev=0.3)
    return make(grid, w2g, (0.002,) * 3, (0.0008,) * 3, **kw)


@pytest.fixture(scope="module")
def reference_lanes():
    """The reference's lanes of both media at 8x8 px, 2 spp, depth 3, seed
    3, through its kernel path (one interpreted compile each)."""
    spp, depth = 2, 3
    jscene = jax_cornell_box(W, H)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_intersect, "_use_pallas", lambda: True)
        mp.setattr(intersect_pallas, "_UNROLL_LIMIT", 0)
        for name in ("closest_hit_shaded", "any_hit"):
            mp.setattr(intersect_pallas, name, functools.partial(
                getattr(intersect_pallas, name), interpret=True))
        for kind in ("grid", "flake"):
            jm = _box_medium(jmed.make_heterogeneous, kind)

            @jax.jit
            def lanes(scene, med):
                lane = jnp.arange(W * H * spp)
                pid, sid = lane // spp, (lane % spp).astype(jnp.int32)
                sampler = JaxSampler(3, pid, sid)
                off = jax_sample_position("independent", sid, spp,
                                          sampler.next_2d())
                uv = jnp.stack([((pid % W).astype(jnp.float32)
                                 + off[:, 0]) / W,
                                ((pid // W).astype(jnp.float32)
                                 + off[:, 1]) / H], -1)
                return jax_volpath(scene, med, scene.camera.sample_ray(uv),
                                   sampler, JaxPathConfig(
                                       max_depth=depth, spp=spp,
                                       remat=False), seed=3)

            L, aux = lanes(jscene, jm)
            out[kind] = (jm, np.asarray(L), float(aux["avg_path_length"]))
    return jscene, spp, depth, out


def assert_lanes_match(L, L_ref):
    close = np.isclose(L, L_ref, rtol=1e-4, atol=1e-6).all(axis=-1)
    assert close.mean() >= 0.99, close.mean()
    assert np.isfinite(L).all()
    assert abs(L.mean() - L_ref.mean()) <= 1e-3 * abs(L_ref.mean())


@pytest.mark.parametrize("kind", ["grid", "flake"])
def test_volpath_matches_kernel_path_per_lane(reference_lanes, kind):
    jscene, spp, depth, out = reference_lanes
    jm, L_ref, apl = out[kind]
    scene = from_jax_scene(jscene, device="cpu")
    cfg = PathConfig(max_depth=depth, spp=spp)
    ray, sampler, _ = camera_wavefront(scene, cfg, seed=3, morton=False)
    L, aux = volpath_trace(scene, from_jax_medium(jm), ray, sampler, cfg,
                           seed=3)
    assert L_ref.mean() > 0
    assert_lanes_match(L.numpy(), L_ref)
    assert abs(float(aux["avg_path_length"]) - apl) <= 0.02
    # the port's own builder gives the same medium
    tm = _box_medium(tmed.make_heterogeneous, kind)
    L2, _ = volpath_trace(scene, tm, *camera_wavefront(
        scene, cfg, seed=3, morton=False)[:2], cfg, seed=3)
    assert torch.equal(L, L2)


def test_hetero_scene_file_renders(tmp_path):
    """The heterogeneous Cornell box written as a scene file with its .vol
    renders finite and non-zero; seeds give different images."""
    path = mc.hetero_cornell_xml(str(tmp_path), n=16)
    scene, cfg = txml.load_scene(path, params=dict(
        depth=3, spp=2, width=8, height=8), device="cpu")
    from mitsuba_tpu_torch.integrators import render_volpath

    assert os.path.exists(tmp_path / "density.vol")
    a, _ = render_volpath(scene, cfg["medium"], PathConfig(max_depth=3,
                                                           spp=2), seed=0)
    b, _ = render_volpath(scene, cfg["medium"], PathConfig(max_depth=3,
                                                           spp=2), seed=1)
    assert bool(torch.isfinite(a).all()) and float(a.mean()) > 0
    assert not torch.equal(a, b)
