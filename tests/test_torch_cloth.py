"""The port's woven cloth (`mitsuba_tpu_torch/bsdfs/irawan.py`,
`io/weave.py`, `core/noise.py` and kind 11 in the material table, the
dispatch and the scene file's `irawan`) against the JAX package's, on
the cases of tests/test_weave.py:43-117 and tests/test_bsdf_chi2.py:
204,237.

- The weave grammar: the same pattern and yarns (angles in radians) as
  the reference's parser, and the same WeaveParseErrors.
- The hashes in uint32 arithmetic (the lattice hash of the noise and
  the cloth's PCG hash, whose shift depends on the lane) bit for bit on
  seeded integers, negative ones included; `perlin_noise`, `fbm` and
  `turbulence` bit for bit.
- irawan eval, pdf and sample through the dispatch on seeded wi, wo, uv
  and material rows (a weave file, the procedural plain and twill, a
  composite of cloth and lambertian): within 1e-5 of the largest value
  (the sampled directions' sin and cos round apart in the last bits).
- The port's own chi-square test of its sampling against its pdf, and
  sample's weight against eval / pdf (test_bsdf_chi2.py:204,237).
- A cloth render's lanes (a weave-file floor and a procedural twill
  wall, brute, 8 x 8 px, 2 spp, depth 4) against the reference's kernel
  path: >= 99% of lanes within rtol 1e-4, the mean within 1e-3
  (tests/test_torch_hetero.py assert_lanes_match).
- A scene file with both: every table, the cloth's included, equal to
  `from_jax_scene` of the reference's load, bit for bit.
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.bsdfs import bsdf_eval as j_eval
from mitsuba_tpu.bsdfs import bsdf_pdf as j_pdf
from mitsuba_tpu.bsdfs import bsdf_sample as j_sample
from mitsuba_tpu.bsdfs import irawan as jir
from mitsuba_tpu.bsdfs.table import MaterialBuilder as JaxMaterialBuilder
from mitsuba_tpu.core import noise as jnoise
from mitsuba_tpu.core import transform as jtf
from mitsuba_tpu.core.chi2 import chi2_test
from mitsuba_tpu.integrators.path import PathConfig as JaxPathConfig
from mitsuba_tpu.integrators.path import path_trace as jax_path_trace
from mitsuba_tpu.io import weave as jweave
from mitsuba_tpu.io import xml as jxml
from mitsuba_tpu.render import mesh as jmesh
from mitsuba_tpu.render.camera import make_perspective as j_persp
from mitsuba_tpu.render.sampler import Sampler as JaxSampler
from mitsuba_tpu.render.scene import SceneBuilder as JaxSceneBuilder
from mitsuba_tpu_torch.bsdfs import irawan as tir
from mitsuba_tpu_torch.bsdfs.dispatch import bsdf_eval, bsdf_pdf, bsdf_sample
from mitsuba_tpu_torch.bsdfs.table import CLOTH, MaterialBuilder
from mitsuba_tpu_torch.core import noise as tnoise
from mitsuba_tpu_torch.core import transform as ttf
from mitsuba_tpu_torch.integrators.path import (
    PathConfig, camera_wavefront, path_trace,
)
from mitsuba_tpu_torch.interop import from_jax_scene
from mitsuba_tpu_torch.io import weave as tweave
from mitsuba_tpu_torch.io import xml as txml
from mitsuba_tpu_torch.render import mesh as tmesh
from mitsuba_tpu_torch.render.camera import make_perspective as t_persp
from mitsuba_tpu_torch.render.scene import SceneBuilder
from tests import torch_leftover_cases as lc
from tests.test_torch_hetero import assert_lanes_match
from tests.test_torch_xml import _same
from tests.torch_kernel_path import kernel_path, lanes

torch.set_num_threads(1)
REL = 1e-5
W = H = 8
SPP, DEPTH = 2, 4


def _t(x):
    return torch.from_numpy(np.array(x))


def test_weave_grammar_equals_reference():
    props = {"alpha": 0.33}
    got = tweave.load_weave_string(lc.WEAVE, props)
    want = jweave.load_weave_string(lc.WEAVE, props)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.alpha == pytest.approx(0.33)
    assert got.dWarpUmaxOverDWarp == pytest.approx(np.pi / 2)
    assert got.yarns[0].psi == pytest.approx(30 * np.pi / 180)
    assert (got.yarns[0].type, got.yarns[1].type) == (tweave.EWARP,
                                                      tweave.EWEFT)
    np.testing.assert_array_equal(got.warp_grid(), [[True, False, True],
                                                    [False, True, False]])
    assert np.array_equal(got.grid(), want.grid())


@pytest.mark.parametrize("text", [
    "weave { tileWidth = 2, tileHeight = 2, pattern { 1, 1, 1 }, "
    "yarn { type = warp } }",
    "weave { tileWidth = 1, tileHeight = 1, pattern { 5 }, "
    "yarn { type = warp } }",
    "weave { alpha = $missing }",
    "weave { name = ",
    "cloth { }",
])
def test_weave_errors_equal_reference(text):
    with pytest.raises(tweave.WeaveParseError) as got:
        tweave.load_weave_string(text)
    with pytest.raises(jweave.WeaveParseError) as want:
        jweave.load_weave_string(text)
    assert str(got.value) == str(want.value)


def test_hashes_and_noise_equal_reference():
    rng = np.random.default_rng(0)
    ijk = rng.integers(-2 ** 31, 2 ** 31 - 1, (3, 20000)).astype(np.int32)
    ijk[:, :5] = [[-1, 0, 2 ** 31 - 1, -2 ** 31, 7]] * 3
    got = tnoise._hash3(*[_t(x) for x in ijk]).numpy()
    want = np.asarray(jnoise._hash3(*[jnp.asarray(x) for x in ijk]))
    assert np.array_equal(got, want.astype(np.int64))
    u = rng.integers(0, 2 ** 32, 20000, dtype=np.uint64).astype(np.uint32)
    u[:3] = (0, 2 ** 32 - 1, 0x9E3779B9)
    got = tir._hash01(_t(u.astype(np.int64))).numpy()
    assert np.array_equal(got, np.asarray(jir._hash01(jnp.asarray(u))))
    p = (rng.standard_normal((5000, 3)) * 40).astype(np.float32)
    for name in ("perlin_noise", "fbm", "turbulence"):
        assert np.array_equal(getattr(tnoise, name)(_t(p)).numpy(),
                              np.asarray(getattr(jnoise, name)(p))), name


def _tables(mb_cls, path):
    b = mb_cls()
    b.irawan_file(path, props={"alpha": 0.33, "ksMultiplier": 1.5},
                  repeat_u=3.0, repeat_v=2.0)
    b.irawan(pattern="twill", warp_kd=(0.1, 0.2, 0.6), repeat_u=7.0)
    b.irawan()
    lam = b.lambertian((0.4, 0.5, 0.6))
    b.composite([0, lam], [0.6, 0.4])
    return b.build()


def _lanes(rng, n, n_rows=5):
    def unit(k):
        v = rng.standard_normal((k, 3))
        v[:, 2] = np.abs(v[:, 2]) + 0.05
        return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(
            np.float32)

    wi, wo = unit(n), unit(n)
    wo[::9, 2] *= -1
    wi[::13, 2] *= -1
    # the half vector along the normal often: the highlights' lanes
    wo[1::4] = wi[1::4] * np.float32([-1, -1, 1])
    uv = rng.uniform(-1.5, 2.5, (n, 2)).astype(np.float32)
    mid = rng.integers(0, n_rows, n).astype(np.int32)
    u2 = rng.uniform(size=(n, 2)).astype(np.float32)
    return wi, wo, uv, mid, u2, rng.uniform(size=n).astype(np.float32)


def _close(got, want):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=REL * scale)


def test_bsdf_equals_reference(tmp_path):
    path = lc.write_weave(str(tmp_path))
    jt, tt = _tables(JaxMaterialBuilder, path), _tables(MaterialBuilder, path)
    assert tt.kind.tolist() == [CLOTH] * 3 + [0, 10]
    for k in ("grid", "yarn", "kd", "ks", "gl"):
        assert np.array_equal(tt.cloth[k].numpy(), np.asarray(jt.cloth[k])), k
    wi, wo, uv, mid, u2, u1 = _lanes(np.random.default_rng(2), 6000)
    a = bsdf_eval(tt, _t(mid), _t(wi), _t(wo), uv=_t(uv)).numpy()
    b = np.asarray(j_eval(jt, mid, wi, wo, uv=uv))
    _close(a, b)
    # the specular band lit some lanes above the diffuse kd
    assert (a.max(-1) > 1.0).any()
    _close(bsdf_pdf(tt, _t(mid), _t(wi), _t(wo)).numpy(),
           np.asarray(j_pdf(jt, mid, wi, wo)))
    got = bsdf_sample(tt, _t(mid), _t(wi), _t(u2), _t(u1), uv=_t(uv))
    want = j_sample(jt, mid, wi, u2, u1, uv=uv)
    for k in ("valid", "delta", "transmission"):
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    for k in ("wo", "weight", "pdf"):
        _close(got[k].numpy(), np.asarray(want[k]))
    # no uv: the cloth rows evaluate to zero in both
    cl = np.flatnonzero(mid < 3)[:64]
    assert not np.asarray(j_eval(jt, mid[cl], wi[cl], wo[cl])).any()
    assert not bsdf_eval(tt, _t(mid[cl]), _t(wi[cl]), _t(wo[cl])).any()
    p = tt.gather(_t(mid))
    np.testing.assert_array_equal(
        tir.irawan_diffuse_reflectance(dict(p, _uv=_t(uv))).numpy(),
        np.asarray(jir.irawan_diffuse_reflectance(
            dict(jt.gather(jnp.asarray(mid)), _uv=jnp.asarray(uv)))))


def test_pattern_grid_lookup(tmp_path):
    """tests/test_weave.py:70: at repeat 1, cell (x, y) of the pattern
    shades with its yarn's kd (uv.y flipped, irawan.cpp:112)."""
    path = lc.write_weave(str(tmp_path))
    b = MaterialBuilder()
    mid = b.irawan_file(path, props={"alpha": 0.33}, repeat_u=1.0,
                        repeat_v=1.0)
    table = b.build()
    w = tweave.load_weave_string(lc.WEAVE, {"alpha": 0.33})
    g = w.warp_grid()
    uv = torch.tensor([[(x + 0.5) / 3.0, 1.0 - (y + 0.5) / 2.0]
                       for y in range(2) for x in range(3)])
    warp = torch.from_numpy(g.reshape(-1))
    p = dict(table.gather(torch.full((6,), mid)), _uv=uv)
    kd = tir.irawan_diffuse_reflectance(p)
    want = torch.where(warp[:, None], torch.tensor(w.yarns[0].kd),
                       torch.tensor(w.yarns[1].kd)).float()
    torch.testing.assert_close(kd, want)
    wi = torch.tensor([0.0, 0.0, 1.0]).expand(6, 3)
    wo = torch.tensor([0.0, 0.3, 0.954]).expand(6, 3)
    val = bsdf_eval(table, torch.full((6,), mid), wi, wo, uv=uv)
    assert (val[warp, 1] > val[warp, 0]).all()      # the green warp
    assert (val[~warp, 0] > val[~warp, 1]).all()    # the red weft


def _wi():
    t = np.deg2rad(35.0)
    return np.float32([np.sin(t) * 0.6, np.sin(t) * 0.8, np.cos(t)])


def test_sampling_chi2():
    """The port's sampling against its own pdf (test_bsdf_chi2.py:204): uv
    fixed per run (the yarn is picked by position)."""
    b = MaterialBuilder()
    b.irawan()
    table = b.build()
    wi = _t(_wi())

    def sample_fn(key, n_s):
        u = np.asarray(jax.random.uniform(key, (n_s, 3)))
        s = bsdf_sample(table, torch.zeros(n_s, dtype=torch.int32),
                        wi.expand(n_s, 3), _t(u[:, :2]), _t(u[:, 2]),
                        uv=torch.tensor([0.37, 0.81]).expand(n_s, 2))
        return jnp.asarray(torch.where(s["valid"][:, None], s["wo"],
                                       0.0).numpy())

    def pdf_fn(d):
        dd = _t(np.asarray(d, np.float32).reshape(-1, 3))
        pdf = bsdf_pdf(table, torch.zeros(dd.shape[0], dtype=torch.int32),
                       wi.expand(dd.shape[0], 3), dd)
        return jnp.asarray(pdf.numpy()).reshape(d.shape[:-1])

    res = chi2_test(jax.random.key(5), sample_fn, pdf_fn, n_samples=200_000)
    assert res.passed, f"chi2={res.chi2:.1f} p={res.p_value:.3e}"


def test_sample_weight_is_eval_over_pdf(tmp_path):
    """test_bsdf_chi2.py:237: sample's weight = eval / pdf at the sampled
    direction, on every row kind."""
    tt = _tables(MaterialBuilder, lc.write_weave(str(tmp_path)))
    wi, _, uv, mid, u2, u1 = _lanes(np.random.default_rng(11), 4096, 3)
    mid, wi, uv = _t(mid), _t(wi), _t(uv)
    s = bsdf_sample(tt, mid, wi, _t(u2), _t(u1), uv=uv)
    f = bsdf_eval(tt, mid, wi, s["wo"], uv=uv)
    pdf = bsdf_pdf(tt, mid, wi, s["wo"])
    ok = s["valid"]
    assert ok.float().mean() > 0.8
    torch.testing.assert_close(s["weight"][ok], (f / torch.clamp(
        pdf, min=1e-9)[:, None])[ok], rtol=2e-4, atol=1e-5)


JAX = SimpleNamespace(SceneBuilder=JaxSceneBuilder, mesh=jmesh,
                      look_at=jtf.look_at, make_perspective=j_persp)
PORT = SimpleNamespace(SceneBuilder=SceneBuilder, mesh=tmesh,
                       look_at=ttf.look_at, make_perspective=t_persp)


def _cloth_scene(mods, path, device=None):
    """A weave-file floor and a twill wall under an area light (brute)."""
    b = mods.SceneBuilder()
    floor = b.materials.irawan_file(path, props={"alpha": 0.33},
                                    repeat_u=6.0, repeat_v=6.0)
    twill = b.materials.irawan(pattern="twill", repeat_u=5.0, repeat_v=5.0,
                               ks_mult=2.0)
    b.add_shape(mods.mesh.make_quad([-2, 0, -2], [-2, 0, 2], [2, 0, 2],
                                    [2, 0, -2]), floor)
    b.add_shape(mods.mesh.make_quad([-2, 0, 2], [-2, 2, 2], [2, 2, 2],
                                    [2, 0, 2]), twill)
    b.add_area_emitter_shape(mods.mesh.make_quad(
        [-0.5, 3, -0.5], [0.5, 3, -0.5], [0.5, 3, 0.5], [-0.5, 3, 0.5]),
        b.materials.lambertian((0.0, 0.0, 0.0)), (15.0,) * 3)
    b.set_camera(mods.make_perspective(mods.look_at(
        [0.3, 1.6, -3.0], [0, 0.6, 0.5], [0, 1, 0]), 50.0, 1.0), W, H)
    kw = {} if device is None else dict(device=device)
    return b.build(backend="brute", **kw)


def test_render_matches_kernel_path_per_lane(tmp_path, monkeypatch):
    path = lc.write_weave(str(tmp_path))
    jscene = _cloth_scene(JAX, path)
    kernel_path(monkeypatch, jscene.geom)

    @jax.jit
    def run(scene):
        pid, sid, px, py = lanes(W, H, SPP, jnp)
        sampler = JaxSampler(0, pid, sid)
        off = sampler.next_2d()
        uv = jnp.stack([(px + off[:, 0]) / W, (py + off[:, 1]) / H], -1)
        return jax_path_trace(scene, scene.camera.sample_ray(uv), sampler,
                              JaxPathConfig(max_depth=DEPTH, spp=SPP,
                                            remat=False))

    L_ref, aux_ref = run(jscene)
    L_ref = np.asarray(L_ref)
    scene = from_jax_scene(jscene, device="cpu")
    own = _cloth_scene(PORT, path, device="cpu")
    for f in dataclasses.fields(scene):
        _same(getattr(own, f.name), getattr(scene, f.name), f.name)
    cfg = PathConfig(max_depth=DEPTH, spp=SPP)
    ray, sampler, _ = camera_wavefront(scene, cfg, 0, morton=False)
    L, aux = path_trace(scene, ray, sampler, cfg)
    assert L_ref.mean() > 0
    assert_lanes_match(L.numpy(), L_ref)
    assert abs(float(aux["avg_path_length"])
               - float(aux_ref["avg_path_length"])) <= 0.02


def test_cloth_file_equals_reference(tmp_path):
    path = lc.write_cloth_xml(str(tmp_path))
    params = dict(depth=3, spp=2, width=8, height=8)
    port, _ = txml.load_scene(path, params=params, device="cpu")
    ref, _ = jxml.load_scene(path, params=params)
    conv = from_jax_scene(ref, device="cpu")
    for f in dataclasses.fields(port):
        _same(getattr(port, f.name), getattr(conv, f.name), f.name)
    kinds = port.materials.kind.tolist()
    assert kinds.count(CLOTH) == 2
    assert port.materials.cloth["gl"].shape == (2, tir.G_NGLOBALS)
    assert port.geom.backend == "brute"
