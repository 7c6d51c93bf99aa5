"""The port's media (phase functions, the homogeneous medium), the uniform
sphere warp and the environment's split eval / pdf against the JAX
package, elementwise on the same numpy-seeded inputs.

Tolerance rtol 1e-5 (with 1e-6 absolute for values near 0): both sides
run the same float32 formulas, but XLA may contract or reorder them, and
its exp, log, sin, cos and pow may round differently from PyTorch's in
the last bits. Kajiya-Kay and microflake sampling bisect their cdf 24
times; a last-bit difference in a cdf near u may send one step the other
way, which moves the result by less than the final bracket (~2e-7).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.core import warp as jwarp
from mitsuba_tpu.emitters import eval_environment as j_eval_env
from mitsuba_tpu.emitters import pdf_environment as j_pdf_env
from mitsuba_tpu.media import medium as jmed
from mitsuba_tpu.media import phase as jphase
from mitsuba_tpu_torch.core import warp
from mitsuba_tpu_torch.emitters import (
    eval_and_pdf_environment, eval_environment, pdf_environment,
)
from mitsuba_tpu_torch.interop import from_jax_medium, from_jax_scene
from mitsuba_tpu_torch.media import (
    HG, ISOTROPIC, KAJIYA_KAY, MICROFLAKE, MICROFLAKE_GAUSS,
    make_heterogeneous, make_homogeneous, medium_transmittance, no_medium,
    phase_eval, phase_pdf, phase_sample, sample_distance,
)

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-6
KINDS = {"isotropic": ISOTROPIC, "hg": HG, "kajiya_kay": KAJIYA_KAY,
         "microflake": MICROFLAKE}


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol,
                               atol=atol)


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


@pytest.mark.parametrize("g", [0.4, -0.7, 0.0, 5e-5])
@pytest.mark.parametrize("kind", list(KINDS))
def test_phase_eval_and_sample_match_reference(kind, g):
    k = KINDS[kind]
    rng = np.random.default_rng(7)
    n = 2000
    wi, wo = _unit(rng, n), _unit(rng, n)
    u2 = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    gt = torch.tensor(g, dtype=torch.float32)
    gj = jnp.asarray(g, jnp.float32)
    _close(phase_eval(k, gt, _t(wi), _t(wo)),
           jphase.phase_eval(k, gj, wi, wo))
    _close(phase_pdf(k, gt, _t(wi), _t(wo)), jphase.phase_pdf(k, gj, wi, wo))
    axis = _unit(rng, n)
    if k in (KAJIYA_KAY, MICROFLAKE):
        _close(phase_eval(k, gt, _t(wi), _t(wo), _t(axis)),
               jphase.phase_eval(k, gj, wi, wo, fiber_axis=axis))
    wo_s, pdf_s = phase_sample(k, gt, _t(wi), _t(u2))
    wo_r, pdf_r = jphase.phase_sample(k, gj, wi, u2)
    atol = 1e-5 if k in (KAJIYA_KAY, MICROFLAKE) else ATOL
    _close(wo_s, wo_r, atol=atol)
    _close(pdf_s, pdf_r, atol=atol)
    np.testing.assert_allclose(np.linalg.norm(wo_s.numpy(), axis=-1), 1.0,
                               rtol=1e-5)


def test_microflake_gauss_raises():
    """The Gaussian flake raises where the reference does: without its
    fitted coefficients (phase.py:124); an unknown kind raises. With them
    its value matches the reference (tests/test_torch_hetero.py holds
    its sampling)."""
    wi = torch.tensor([[0.0, 0.0, 1.0]])
    with pytest.raises(ValueError):
        phase_eval(MICROFLAKE_GAUSS, 0.3, wi, wi)
    with pytest.raises(ValueError):
        phase_sample(MICROFLAKE_GAUSS, 0.3, wi, torch.full((1, 2), 0.5))
    with pytest.raises(ValueError):
        phase_eval(9, 0.3, wi, wi)
    rng = np.random.default_rng(8)
    n = 200
    wi, wo = _unit(rng, n), _unit(rng, n)
    u2 = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    coeffs, _ = jphase.fit_fiber_sigma_t(0.3)
    g = np.float32(0.3)
    _close(phase_eval(MICROFLAKE_GAUSS, _t(g), _t(wi), _t(wo), None,
                      _t(coeffs)),
           jphase.phase_eval(MICROFLAKE_GAUSS, jnp.asarray(g), wi, wo, None,
                             jnp.asarray(coeffs)), rtol=1e-4)
    wo_s, pdf_s = phase_sample(MICROFLAKE_GAUSS, _t(g), _t(wi), _t(u2),
                               None, _t(coeffs))
    np.testing.assert_allclose(np.linalg.norm(wo_s.numpy(), axis=-1), 1.0,
                               rtol=1e-5)
    assert (pdf_s.numpy() >= 0).all() and (pdf_s.numpy() > 0).mean() > 0.9


def _distance_inputs(seed, n=3000):
    rng = np.random.default_rng(seed)
    o = rng.uniform(0, 500, (n, 3)).astype(np.float32)
    d = _unit(rng, n)
    max_dist = rng.uniform(1, 900, n).astype(np.float32)
    max_dist[::9] = 1e6            # escaped rays: _FAR
    u_ch = rng.uniform(0, 1, n).astype(np.float32)
    u_dist = rng.uniform(0, 1, n).astype(np.float32)
    return o, d, max_dist, u_ch, u_dist


MEDIA = {
    "fog": ((0.0015,) * 3, (0.0003,) * 3, 0.4),
    "tinted": ((0.002, 0.0008, 0.0001), (0.0, 0.0004, 0.003), 0.0),
    "one_channel": ((0.004, 0.0, 0.0), (0.0, 0.0, 0.0), -0.3),
}


@pytest.mark.parametrize("medium", list(MEDIA))
def test_sample_distance_and_transmittance_match_reference(medium):
    ss, sa, g = MEDIA[medium]
    med = make_homogeneous(ss, sa, g=g)
    jm = jmed.make_homogeneous(ss, sa, g=g)
    assert med.phase_kind == jm.phase_kind
    o, d, max_dist, u_ch, u_dist = _distance_inputs(3)
    got = sample_distance(med, _t(o), _t(d), _t(max_dist), _t(u_ch),
                          _t(u_dist))
    ref = jmed.sample_distance(jm, o, d, max_dist, u_ch, u_dist)
    np.testing.assert_array_equal(got["valid"].numpy(),
                                  np.asarray(ref["valid"]))
    assert 0 < got["valid"].numpy().mean() < 1
    for k in ("t", "p", "weight", "surface_weight"):
        _close(got[k], ref[k], atol=1e-5 if k == "p" else ATOL)
    dist = np.where(np.arange(o.shape[0]) % 5 == 0, np.inf,
                    max_dist).astype(np.float32)
    _close(medium_transmittance(med, _t(o), _t(d), _t(dist)),
           jmed.medium_transmittance(jm, o, d, dist))


def test_no_medium_matches_reference():
    o, d, max_dist, u_ch, u_dist = _distance_inputs(4, 100)
    got = sample_distance(no_medium(), _t(o), _t(d), _t(max_dist),
                          _t(u_ch), _t(u_dist))
    ref = jmed.sample_distance(jmed.no_medium(), o, d, max_dist, u_ch,
                               u_dist)
    for k in ("valid", "t", "p", "weight", "surface_weight"):
        _close(got[k], ref[k])
    _close(medium_transmittance(no_medium(), _t(o), _t(d), _t(max_dist)),
           jmed.medium_transmittance(jmed.no_medium(), o, d, max_dist))


def test_from_jax_medium_and_the_kinds_it_lacks():
    """Every kind of the reference's medium converts, field by field
    (grids, oriented and Gaussian-flake media included), and equals the
    port's own builder; a grid medium sampled without a Woodcock key
    raises, as the reference asserts (medium.py:315)."""
    ss, sa, g = MEDIA["tinted"]
    grid = np.random.default_rng(6).uniform(0, 1, (2, 3, 4)).astype(
        np.float32)
    pairs = [
        (jmed.make_homogeneous(ss, sa, g=0.4), make_homogeneous(ss, sa,
                                                                g=0.4)),
        (jmed.no_medium(), no_medium()),
        (jmed.make_homogeneous(ss, sa, phase_kind=KAJIYA_KAY),
         make_homogeneous(ss, sa, phase_kind=KAJIYA_KAY)),
        (jmed.make_heterogeneous(grid, np.eye(4), ss, sa),
         make_heterogeneous(grid, np.eye(4), ss, sa)),
        (jmed.make_homogeneous(ss, sa, flake_stddev=0.3),
         make_homogeneous(ss, sa, flake_stddev=0.3)),
        (jmed.make_homogeneous(ss, sa, orientation=(0, 1, 1)),
         make_homogeneous(ss, sa, orientation=(0, 1, 1)))]
    for jm, own in pairs:
        for med in (from_jax_medium(jm), own):
            for k in ("sigma_s", "sigma_a", "phase_g", "density",
                      "world_to_grid", "density_scale", "max_density",
                      "orientation", "flake_coeffs"):
                ref = getattr(jm, k)
                assert (getattr(med, k) is None) == (ref is None), k
                if ref is not None:
                    np.testing.assert_array_equal(getattr(med, k).numpy(),
                                                  np.asarray(ref))
            assert (med.kind, med.phase_kind, med.enabled) == (
                jm.kind, jm.phase_kind, jm.enabled)
    med = from_jax_medium(pairs[3][0])
    o, d, max_dist, u_ch, u_dist = _distance_inputs(5, 10)
    with pytest.raises(ValueError):
        sample_distance(med, _t(o), _t(d), _t(max_dist), _t(u_ch),
                        _t(u_dist))
    assert medium_transmittance(med, _t(o), _t(d), _t(max_dist)).shape \
        == (10, 3)


def test_uniform_sphere_warp_matches_reference():
    rng = np.random.default_rng(11)
    u2 = rng.uniform(0, 1, (1000, 2)).astype(np.float32)
    d = warp.square_to_uniform_sphere(_t(u2))
    _close(d, jwarp.square_to_uniform_sphere(u2))
    _close(warp.square_to_uniform_sphere_pdf(d),
           jwarp.square_to_uniform_sphere_pdf(np.asarray(d)))


def test_environment_eval_and_pdf_match_reference():
    """The split functions against the reference's, on a sky scene (and
    zero without an environment emitter)."""
    from mitsuba_tpu.render.mesh import make_quad
    from mitsuba_tpu.render.scene import SceneBuilder as JaxSceneBuilder
    from mitsuba_tpu.render.scene import cornell_box as jax_cornell_box

    b = JaxSceneBuilder()
    b.materials.lambertian()
    b.add_shape(make_quad([-1, 0, -1], [-1, 0, 1], [1, 0, 1], [1, 0, -1]), 0)
    b.emitters.sky(resolution=16, turbidity=3.0, sun_dir=(0.35, 0.6, -0.5))
    rng = np.random.default_rng(12)
    dirs = _unit(rng, 2000)
    for js in (b.build(backend="brute"), jax_cornell_box(4, 4)):
        em = from_jax_scene(js, device="cpu").emitters
        val, pdf = eval_environment(em, _t(dirs)), pdf_environment(
            em, _t(dirs))
        _close(val, j_eval_env(js.emitters, dirs))
        _close(pdf, j_pdf_env(js.emitters, dirs))
        fused = eval_and_pdf_environment(em, _t(dirs))
        assert torch.equal(val, fused[0]) and torch.equal(pdf, fused[1])
    assert float(val.abs().sum()) == 0.0       # the Cornell box: no sky
