"""The port's surface path guiding against the JAX package: path_trace's
learning pass and its guided pass, render_guided and the CLI's --guided
route on a scene without a medium.

- The learning pass (seed 0, 16x16x4, depth 4, a res-6 grid over the
  Cornell box), lane by lane against the reference's kernel path (the
  kernels' plain references, tests/torch_kernel_path.py): >= 99% of lanes
  within rtol 1e-4, the mean within 1e-3 of it; the learned mass within
  1e-4 of its largest bin (a scatter-add sums a bin's deposits in another
  order; on the card in atomic order, so two runs there need not repeat
  in the last bits), and learning leaves the image as the unguided one.
- The guided pass (seed 7507) on the reference's learned guide, carried
  across by interop.from_jax_guide: lane by lane, as above.
- render_guided is the spp-weighted mean of its learning render and its
  guided render from seed + 7507, bit for bit; `--guided` through the CLI
  writes render_guided's image, bit for bit; make_guide defaults to the
  card.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.integrators import guiding as jg
from mitsuba_tpu.integrators.path import PathConfig as JaxPathConfig
from mitsuba_tpu.integrators.path import path_trace as jax_path_trace
from mitsuba_tpu.render.sampler import Sampler as JaxSampler
from mitsuba_tpu.render.scene import cornell_box as jax_cornell_box
from mitsuba_tpu_torch.cli import main
from mitsuba_tpu_torch.integrators import guiding as tg
from mitsuba_tpu_torch.integrators.path import (
    PathConfig, camera_wavefront, path_trace, render, render_guided,
)
from mitsuba_tpu_torch.interop import from_jax_guide, from_jax_scene
from mitsuba_tpu_torch.io import bitmap
from mitsuba_tpu_torch.io.xml import load_scene
from mitsuba_tpu_torch.render.scene import cornell_box
from tests.test_torch_hetero import assert_lanes_match
from tests.torch_kernel_path import kernel_path, lanes

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = H = 16
SPP, DEPTH, RES = 4, 4, 6


@pytest.fixture(scope="module")
def reference_passes():
    """The reference's learning pass (seed 0) and guided pass (seed 7507)
    on its kernel path."""
    jscene = jax_cornell_box(W, H)
    v0 = np.asarray(jscene.geom.v0)
    ext = v0.max(0) - v0.min(0)
    guide0 = jg.make_guide(v0.min(0) - 0.01 * ext, v0.max(0) + 0.01 * ext,
                           res=RES)
    jcfg = JaxPathConfig(max_depth=DEPTH, spp=SPP, remat=False)

    def run(scene, guide, seed, learn):
        pid, sid, px, py = lanes(W, H, SPP, jnp)
        sampler = JaxSampler(seed, pid, sid)
        off = sampler.next_2d()
        uv = jnp.stack([(px + off[:, 0]) / W, (py + off[:, 1]) / H], -1)
        return jax_path_trace(scene, scene.camera.sample_ray(uv), sampler,
                              jcfg, guide=guide, learn_guide=learn)

    with pytest.MonkeyPatch.context() as mp:
        kernel_path(mp, jscene.geom)
        L1, aux1 = jax.jit(lambda s, g: run(s, g, 0, True))(jscene, guide0)
        guide = aux1["guide"]
        L2, _ = jax.jit(lambda s, g: run(s, g, 7507, False))(jscene, guide)
    return jscene, np.asarray(L1), guide, np.asarray(L2)


def test_learning_pass_matches_kernel_path(reference_passes):
    jscene, L_ref, guide_ref, _ = reference_passes
    scene = from_jax_scene(jscene, device="cpu")
    cfg = PathConfig(max_depth=DEPTH, spp=SPP)
    ray, sampler, _ = camera_wavefront(scene, cfg, seed=0, morton=False)
    L, aux = path_trace(scene, ray, sampler, cfg,
                        guide=tg.scene_guide(scene, RES), learn_guide=True)
    assert_lanes_match(L.numpy(), L_ref)
    ref_mass = np.asarray(guide_ref.mass)
    assert ref_mass.max() > 0
    np.testing.assert_allclose(aux["guide"].mass.numpy(), ref_mass, rtol=0,
                               atol=1e-4 * float(ref_mass.max()))
    # learning changes nothing in the image
    plain, _ = path_trace(scene, *camera_wavefront(
        scene, cfg, seed=0, morton=False)[:2], cfg)
    assert torch.equal(plain, L)


def test_guided_pass_matches_kernel_path(reference_passes):
    jscene, _, guide_ref, L_ref = reference_passes
    scene = from_jax_scene(jscene, device="cpu")
    cfg = PathConfig(max_depth=DEPTH, spp=SPP)
    ray, sampler, _ = camera_wavefront(scene, cfg, seed=7507, morton=False)
    L, aux = path_trace(scene, ray, sampler, cfg,
                        guide=from_jax_guide(guide_ref, "cpu"))
    assert_lanes_match(L.numpy(), L_ref)
    assert "guide" not in aux
    # the guide moved the estimate: the unguided lanes differ
    plain, _ = path_trace(scene, *camera_wavefront(
        scene, cfg, seed=7507, morton=False)[:2], cfg)
    assert not torch.equal(plain, L)


def test_render_guided_composes_its_passes():
    scene = cornell_box(12, 12, device="cpu")
    cfg = PathConfig(max_depth=3, spp=4)
    img, aux = render_guided(scene, cfg, seed=2, res=4)
    img1, aux1 = render(scene, dataclasses.replace(cfg, spp=2), seed=2,
                        guide=tg.scene_guide(scene, 4), learn_guide=True)
    img2, aux2 = render(scene, dataclasses.replace(cfg, spp=2),
                        seed=2 + 7507, guide=aux1["guide"])
    assert torch.equal(img, (img1 * 2 + img2 * 2) / 4)
    assert int(aux["rays_traced"]) == int(aux1["rays_traced"]) \
        + int(aux2["rays_traced"])
    # with every sample learning, the learning pass alone and its guide
    only, aux_l = render_guided(scene, cfg, seed=2, learn_frac=1.0, res=4)
    assert float(aux_l["guide"].mass.sum()) > 0
    assert torch.equal(only, render(scene, cfg, seed=2)[0])


def test_cli_guided_writes_render_guided(tmp_path):
    xml = os.path.join(REPO, "scenes", "cornell.xml")
    defs = dict(depth=3, spp=2, width=12, height=12)
    out = str(tmp_path / "g.exr")
    argv = [a for k, v in defs.items() for a in ("-D", f"{k}={v}")]
    assert main(["--cpu", "-q", xml, *argv, "-o", out, "--guided"]) == 0
    scene, _ = load_scene(xml, params=defs, device="cpu")
    ref, _ = render_guided(scene, PathConfig(max_depth=3, spp=2,
                                             remat=False), seed=0)
    assert float(ref.mean()) > 0
    assert np.array_equal(bitmap.read_exr(out), ref.numpy())


def test_make_guide_takes_the_callers_device():
    g = tg.make_guide((-1, -1, -1), (1, 1, 1), res=2, device="cpu")
    assert g.mass.device.type == "cpu" and g.mass.shape == (8, tg.N_BINS)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tg.make_guide((-1, -1, -1), (1, 1, 1), res=2)
