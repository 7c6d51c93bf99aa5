"""The repo's showcase scene, scenes/snow.xml (the Wiscombe snow BRDF on
four analytic spheres under the Preetham sky, its ldsampler pattern and
gaussian filter), in the port against the JAX package.

(a) Both XML loaders give the same tables (the sky's bake within its own
    1e-4) and the same render config.
(b) The port's CPU render at 32x32 px, 16 spp: its image mean within four
    standard errors of the JAX package's CPU render at 256 spp
    (tests/torch_goldens/snow.npz "mean32", scripts/gen_torch_goldens.py),
    each error from the per-pixel sample variance; and per pixel by the
    |t| > 3.9 rule of tests/test_goldens.py, under 1% failing.
(c) The CLI renders the file with its own pattern and filter, the EXR
    equal to the library's render bit for bit.
"""
import dataclasses
import os

import numpy as np
import torch

from mitsuba_tpu.io import xml as jxml
from mitsuba_tpu_torch.cli import main
from mitsuba_tpu_torch.integrators.path import (
    PathConfig, camera_samples, path_trace, render,
)
from mitsuba_tpu_torch.interop import from_jax_scene
from mitsuba_tpu_torch.io import bitmap
from mitsuba_tpu_torch.io import xml as txml

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SNOW = os.path.join(REPO, "scenes", "snow.xml")
GOLDEN = os.path.join(REPO, "tests", "torch_goldens", "snow.npz")
# the sky's baked tables agree within the bake's 1e-4
# (tests/test_torch_env.py); its alias table is left out
_ALIAS = ("env_alias", "env_prob")


def _params(res, spp, depth=5):
    return dict(depth=depth, spp=spp, width=res, height=res)


def test_snow_tables_equal_reference():
    scene, cfg = txml.load_scene(SNOW, params=_params(16, 2), device="cpu")
    jscene, jcfg = jxml.load_scene(SNOW, params=_params(16, 2))
    conv = from_jax_scene(jscene, device="cpu")
    assert cfg == jcfg
    assert (cfg["pattern"], cfg["rfilter"]) == ("ldsampler", "gaussian")
    assert scene.geom.backend == "brute" and scene.geom.n_spheres == 4
    assert scene.materials.kinds_present == ((8, 0),)
    for table in ("materials", "geom", "camera", "textures"):
        a, b = getattr(scene, table), getattr(conv, table)
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(x, torch.Tensor):
                assert torch.equal(x, y), (table, f.name)
            else:
                assert x == y, (table, f.name)
    for f in dataclasses.fields(scene.emitters):
        x, y = (getattr(e, f.name) for e in (scene.emitters, conv.emitters))
        if f.name in _ALIAS:
            continue
        if isinstance(x, torch.Tensor):
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=f.name)
        else:
            assert x == y, f.name


def test_snow_mean_matches_reference():
    g = np.load(GOLDEN)
    res, spp = 32, 16
    scene, cfg = txml.load_scene(SNOW, params=_params(res, spp),
                                 device="cpu")
    pc = PathConfig(max_depth=5, spp=spp, pattern=cfg["pattern"])
    ray, sampler, _, _ = camera_samples(scene, pc, seed=0, morton=False)
    L, _ = path_trace(scene, ray, sampler, pc)
    Ls = L.reshape(res, res, spp, 3).double()
    mean, var = Ls.mean(2).numpy(), Ls.var(2).numpy()
    gm, gv, gspp = g["mean32"], g["var32"], int(g["spp32"])
    npx = mean.size
    se = np.sqrt(var.sum() / spp + gv.sum() / gspp) / npx
    assert np.isfinite(mean).all() and mean.mean() > 0.5
    assert abs(mean.mean() - gm.mean()) < 4.0 * se, \
        (mean.mean(), gm.mean(), se)
    t = (mean - gm) / np.maximum(np.sqrt(var / spp + gv / gspp), 1e-6)
    assert float((np.abs(t) > 3.9).any(-1).mean()) < 0.01


def test_cli_renders_snow(tmp_path):
    out = str(tmp_path / "snow.exr")
    defs = [a for k, v in _params(12, 2, depth=3).items()
            for a in ("-D", f"{k}={v}")]
    assert main(["--cpu", "-q", SNOW, *defs, "-o", out]) == 0
    scene, cfg = txml.load_scene(SNOW, params=_params(12, 2, depth=3),
                                 device="cpu")
    img, _ = render(scene, PathConfig(max_depth=3, spp=2,
                                      pattern="ldsampler",
                                      rfilter="gaussian", remat=False))
    got = bitmap.read_exr(out)
    assert got.shape == (12, 12, 3) and float(img.mean()) > 0.5
    assert np.array_equal(got, img.numpy())
