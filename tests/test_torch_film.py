"""The port's sample patterns, reconstruction filters and film against
the JAX package (render/sampler.py sample_position, render/rfilter.py,
render/film.py).

(a) `sample_position` bit for bit for all five patterns at 1, 4, 16 and 64
    spp, on the uniforms of the port's own Sampler (themselves bit for
    bit with jax.random).
(b) Every filter's profile, and `develop` under box, gaussian and
    mitchell, within 1e-6 relative (and 1e-7 absolute: the exp and sinc
    of the two libraries differ in the last bits); `develop_with_variance`
    likewise.
(c) On the cluster backend the camera lanes are Morton-ordered, and
    `render` un-permutes the offsets with the radiance: they equal the
    scanline lanes' offsets bit for bit, and the filtered image equals
    the one developed from scanline lanes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.render import film as j_film
from mitsuba_tpu.render import rfilter as j_rf
from mitsuba_tpu.render import sampler as j_sampler
from mitsuba_tpu_torch.core.registry import create_plugin, plugin_names
from mitsuba_tpu_torch.integrators.path import (
    PathConfig, camera_samples, path_trace, render,
)
from mitsuba_tpu_torch.render import film, rfilter
from mitsuba_tpu_torch.render.sampler import Sampler, sample_position
from mitsuba_tpu_torch.render.scene import instanced_scene

torch.set_num_threads(1)
PATTERNS = ("independent", "stratified", "ldsampler", "halton",
            "hammersley")
FILTERS = ("box", "gaussian", "mitchell", "catmullrom", "wsinc", "tent")


def _jitter(n, seed=11):
    lane = torch.arange(n, dtype=torch.int32)
    return Sampler(seed, lane // 7, lane % 7).next_2d()


@pytest.mark.parametrize("spp", [1, 4, 16, 64])
@pytest.mark.parametrize("pattern", PATTERNS)
def test_sample_position_bit_for_bit(pattern, spp):
    n = 64 * spp
    sample_ids = (torch.arange(n, dtype=torch.int32) % spp)
    rnd = _jitter(n)
    got = sample_position(pattern, sample_ids, spp, rnd).numpy()
    ref = np.asarray(j_sampler.sample_position(
        pattern, jnp.asarray(sample_ids.numpy()), spp,
        jnp.asarray(rnd.numpy())))
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))
    assert ((got >= 0) & (got < 1)).all()


def test_sequences_bit_for_bit_at_large_indices():
    """The radical inverses and the Sobol xor over every bit of an int32
    index."""
    rng = np.random.default_rng(5)
    idx = np.concatenate([np.arange(4096), rng.integers(
        0, 2 ** 31 - 1, 4096), [2 ** 31 - 1]]).astype(np.int32)
    from mitsuba_tpu_torch.render import sampler as t_sampler

    t = torch.from_numpy(idx)
    for base in (2, 3):
        np.testing.assert_array_equal(
            t_sampler._radical_inverse(base, t).numpy().view(np.uint32),
            np.asarray(j_sampler._radical_inverse(
                base, jnp.asarray(idx))).view(np.uint32))
    np.testing.assert_array_equal(
        t_sampler._sobol_2d(t).numpy().view(np.uint32),
        np.asarray(j_sampler._sobol_2d(jnp.asarray(idx))).view(np.uint32))


def test_plugins_registered():
    assert set(PATTERNS) <= set(plugin_names("sampler"))
    assert create_plugin("sampler", "ldsampler", {"sampleCount": 32}) == \
        {"pattern": "ldsampler", "spp": 32}
    assert set(FILTERS) <= set(plugin_names("rfilter"))
    assert create_plugin("rfilter", "gaussian").radius == 2.0


@pytest.mark.parametrize("name", FILTERS)
def test_filters_match(name):
    x = np.linspace(-3.5, 3.5, 7001).astype(np.float32)
    f, jf = rfilter.make_rfilter(name), j_rf.make_rfilter(name)
    assert f.radius == jf.radius and f.name == jf.name
    np.testing.assert_allclose(f(torch.from_numpy(x)).numpy(),
                               np.asarray(jf(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)


def _lanes(h, w, spp, seed=3):
    rng = np.random.default_rng(seed)
    n = h * w * spp
    L = rng.gamma(1.0, 0.5, (n, 3)).astype(np.float32)
    off = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    return L, off


@pytest.mark.parametrize("name", ["box", "gaussian", "mitchell"])
def test_develop_matches(name):
    h, w, spp = 12, 9, 4
    L, off = _lanes(h, w, spp)
    got = film.develop(torch.from_numpy(L), torch.from_numpy(off), spp, h,
                       w, rfilter.make_rfilter(name)).numpy()
    # jitted: one compile instead of an eager one for each op of the
    # (2R+1)^2 gathers
    ref = np.asarray(jax.jit(lambda a, b: j_film.develop(
        a, b, spp, h, w, j_rf.make_rfilter(name)))(L, off))
    assert got.shape == (h, w, 3)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    if name == "box":
        np.testing.assert_array_equal(got, film.develop(
            torch.from_numpy(L), None, spp, h, w).numpy())


def test_develop_with_variance_matches():
    h, w, spp = 6, 5, 8
    L, _ = _lanes(h, w, spp, seed=4)
    got = film.develop_with_variance(torch.from_numpy(L), spp, h, w)
    ref = j_film.develop_with_variance(jnp.asarray(L), spp, h, w)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    assert got[2].dtype == torch.int32
    one = film.develop_with_variance(torch.from_numpy(L[: h * w]), 1, h, w)
    assert not one[1].any()


def test_morton_lanes_unpermute_offsets():
    """On the cluster backend (Morton lanes), render() returns the offsets
    to scanline order with the radiance before the gaussian filter."""
    scene = instanced_scene(16, 16, 10, 20, device="cpu")
    assert scene.geom.backend == "cluster"
    cfg = PathConfig(max_depth=2, spp=2, pattern="halton",
                     rfilter="gaussian")
    ray, sampler, off_m, inv = camera_samples(scene, cfg, seed=1)
    assert inv is not None
    _, _, off_s, none = camera_samples(scene, cfg, seed=1, morton=False)
    assert none is None
    np.testing.assert_array_equal(off_m[inv].numpy(), off_s.numpy())
    assert not torch.equal(off_m, off_s)
    L, _ = path_trace(scene, ray, sampler, cfg)
    want = film.develop(L[inv], off_s, cfg.spp, 16, 16,
                        rfilter.make_gaussian())
    img, _ = render(scene, cfg, seed=1)
    np.testing.assert_array_equal(img.numpy(), want.numpy())
    # the wrong offsets (Morton order) give another image
    wrong = film.develop(L[inv], off_m, cfg.spp, 16, 16,
                         rfilter.make_gaussian())
    assert not torch.allclose(img, wrong)
