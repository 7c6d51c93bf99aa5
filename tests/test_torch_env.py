"""The parts of the config-3 slice against the JAX package, elementwise:
the baked Preetham sky, environment sampling and evaluation, the emitter
table's sky branches, the checkerboard texture and the phong BSDF.

Inputs are made by numpy from fixed seeds and handed to both packages.
Tolerances: the sky bake within 1e-4 relative (float32 arccos, exp and
tan of two libraries); everything evaluated on the same tables within
1e-5, and integer or discrete results (texel choice, alias tables,
checkerboard cells, validity masks) equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.bsdfs import models as jmd
from mitsuba_tpu.emitters import envmap as jenv
from mitsuba_tpu.emitters import table as jtab
from mitsuba_tpu.render import texture as jtex
from mitsuba_tpu.render.scene import SceneBuilder as JaxSceneBuilder
from mitsuba_tpu_torch.bsdfs import models as md
from mitsuba_tpu_torch.emitters import envmap
from mitsuba_tpu_torch.emitters import table as tab
from mitsuba_tpu_torch.interop import _emitters
from mitsuba_tpu_torch.render import texture as tex

torch.set_num_threads(1)
SKY = dict(turbidity=3.0, sun_dir=(0.35, 0.6, -0.5), scale=1.0)


@pytest.fixture(scope="module")
def skies():
    """The reference's and the port's emitter builders, each with the
    config-3 sky (32 x 64 texels), and the reference's built table."""
    jb = jtab.EmitterBuilder()
    jb.sky(resolution=32, **SKY)
    tb = tab.EmitterBuilder()
    tb.sky(resolution=32, **SKY)
    jem = jb.build(np.zeros(1, np.int32), np.ones(1))
    return jb, tb, jem


def _dirs(n, seed):
    d = np.random.default_rng(seed).normal(size=(n, 3))
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def test_sky_bake_matches_reference(skies):
    jb, tb, _jem = skies
    img, rot = tb.env
    np.testing.assert_allclose(img, jb._env_image, rtol=1e-4, atol=1e-6)
    assert np.array_equal(rot, jb._env_to_world)
    assert img.shape == (32, 64, 3) and img.min() >= 0 and img.max() > 0.1


def test_env_tables_match_reference(skies):
    """Sampling tables built from the same image are equal."""
    jb, _tb, _jem = skies
    for a, b in zip(envmap.build_env_cdfs(jb._env_image),
                    jenv.build_env_cdfs(jb._env_image)):
        assert np.array_equal(a, b)


def test_env_sample_and_eval_match_reference(skies):
    _jb, _tb, jem = skies
    em = _emitters(jem)
    u = np.random.default_rng(3).uniform(size=(4096, 2)).astype(np.float32)
    d_r, pdf_r, val_r = (np.asarray(x) for x in jenv.env_sample(
        jem.env_prob, jem.env_alias, jem.env_pdf_img, jnp.asarray(u),
        from_env=jem.env_to_world, image=jem.env_image))
    d, pdf, val = envmap.env_sample(em.env_prob, em.env_alias,
                                    em.env_pdf_img, em.env_image,
                                    torch.from_numpy(u), em.env_to_world)
    np.testing.assert_allclose(d.numpy(), d_r, rtol=1e-5, atol=1e-6)
    assert np.array_equal(pdf.numpy(), pdf_r)
    assert np.array_equal(val.numpy(), val_r)
    dirs = _dirs(4096, 4)
    v_r, p_r = (np.asarray(x) for x in jenv.env_eval_pdf(
        jem.env_image, jem.env_pdf_img, jnp.asarray(dirs),
        to_env=jem.env_to_env))
    v, p = envmap.env_eval_pdf(em.env_image, em.env_pdf_img,
                               torch.from_numpy(dirs), em.env_to_env)
    np.testing.assert_allclose(v.numpy(), v_r, rtol=1e-5, atol=1e-6)
    assert (p.numpy() == p_r).mean() >= 0.999


def test_emitter_sky_branches_match_reference(skies):
    """sample_direct's env branch and eval_and_pdf_environment."""
    _jb, _tb, jem = skies
    em = _emitters(jem)
    rng = np.random.default_rng(5)
    n = 2048
    p = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    u1 = rng.uniform(size=n).astype(np.float32)
    u2 = rng.uniform(size=(n, 2)).astype(np.float32)
    ref = jtab.sample_direct(jem, None, jnp.asarray(p), jnp.asarray(u1),
                             jnp.asarray(u2))
    ds = tab.sample_direct(em, None, torch.from_numpy(p),
                           torch.from_numpy(u1), torch.from_numpy(u2))
    assert np.array_equal(ds.valid.numpy(), np.asarray(ref.valid))
    for k in ("d", "dist", "value", "pdf"):
        np.testing.assert_allclose(getattr(ds, k).numpy(),
                                   np.asarray(getattr(ref, k)), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    dirs = _dirs(n, 6)
    v_r, p_r = (np.asarray(x) for x in jtab.eval_and_pdf_environment(
        jem, jnp.asarray(dirs)))
    v, pdf = tab.eval_and_pdf_environment(em, torch.from_numpy(dirs))
    np.testing.assert_allclose(v.numpy(), v_r, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pdf.numpy(), p_r, rtol=1e-5, atol=1e-6)


def test_checkerboard_matches_reference():
    jb = jtex.TextureBuilder()
    jb.checkerboard(bright=(0.7,) * 3, dark=(0.2, 0.2, 0.25),
                    uv_scale=(8.0, 8.0))
    jb.checkerboard(uv_offset=(0.3, -0.2))
    tb = tex.TextureBuilder()
    tb.checkerboard(bright=(0.7,) * 3, dark=(0.2, 0.2, 0.25),
                    uv_scale=(8.0, 8.0))
    tb.checkerboard(uv_offset=(0.3, -0.2))
    rng = np.random.default_rng(7)
    uv = rng.uniform(-1.5, 1.5, (4096, 2)).astype(np.float32)
    tid = rng.integers(0, 2, 4096).astype(np.int32)
    ref = np.asarray(jtex.eval_texture(jb.build(), jnp.asarray(tid),
                                       jnp.asarray(uv)))
    got = tex.eval_texture(tb.build(), torch.from_numpy(tid),
                           torch.from_numpy(uv)).numpy()
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("exponent", [40.0, 3.0])
def test_phong_matches_reference(exponent):
    rng = np.random.default_rng(8)
    n = 4096
    wi = _dirs(n, 9)
    wi[:, 2] = np.abs(wi[:, 2])
    wi[::11, 2] *= -1                       # some from below
    wo = _dirs(n, 10)
    refl = rng.uniform(0, 0.8, (n, 3)).astype(np.float32)
    spec = rng.uniform(0, 0.5, (n, 3)).astype(np.float32)
    expo = np.full(n, exponent, np.float32)
    u2 = rng.uniform(size=(n, 2)).astype(np.float32)
    u1 = rng.uniform(size=n).astype(np.float32)
    pj = dict(reflectance=jnp.asarray(refl), specular=jnp.asarray(spec),
              exponent=jnp.asarray(expo))
    pt = dict(reflectance=torch.from_numpy(refl),
              specular=torch.from_numpy(spec),
              exponent=torch.from_numpy(expo))
    jwi, jwo = jnp.asarray(wi), jnp.asarray(wo)
    twi, two = torch.from_numpy(wi), torch.from_numpy(wo)
    np.testing.assert_allclose(md.phong_eval(pt, twi, two).numpy(),
                               np.asarray(jmd.phong_eval(pj, jwi, jwo)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(md.phong_pdf(pt, twi, two).numpy(),
                               np.asarray(jmd.phong_pdf(pj, jwi, jwo)),
                               rtol=1e-5, atol=1e-6)
    s = md.phong_sample(pt, twi, torch.from_numpy(u2), torch.from_numpy(u1))
    r = jmd.phong_sample(pj, jwi, jnp.asarray(u2), jnp.asarray(u1))
    same = s["valid"].numpy() == np.asarray(r["valid"])
    assert same.mean() >= 0.999
    ok = same & s["valid"].numpy()
    assert ok.mean() > 0.5
    for k in ("wo", "weight", "pdf"):
        np.testing.assert_allclose(s[k].numpy()[ok], np.asarray(r[k])[ok],
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_sky_scene_builds_like_reference():
    """A SceneBuilder sky goes through to the table as in the reference:
    one SKY record holding all the selection mass."""
    from mitsuba_tpu_torch.render.scene import SceneBuilder
    from mitsuba_tpu.render.mesh import make_quad

    quad = make_quad([-1, 0, -1], [-1, 0, 1], [1, 0, 1], [1, 0, -1])
    jbld = JaxSceneBuilder()
    jbld.materials.lambertian()
    jbld.add_shape(quad, 0)
    jbld.emitters.sky(resolution=16, **SKY)
    tbld = SceneBuilder()
    tbld.materials.lambertian()
    tbld.add_shape(quad, 0)
    tbld.emitters.sky(resolution=16, **SKY)
    jem = jbld.build(backend="brute").emitters
    em = tbld.build(device="cpu").emitters
    assert em.env_id == jem.env_id == 0
    assert em.kinds_present == tuple(jem.kinds_present)
    for k in ("rec_pmf", "rec_cdf", "rec_emitter"):
        assert np.array_equal(getattr(em, k).numpy(),
                              np.asarray(getattr(jem, k))), k
    np.testing.assert_allclose(em.radiance.numpy(), np.asarray(jem.radiance),
                               rtol=1e-4)
