"""The port's motion blur against the JAX package: the animated transform
(core/track.py), the time-baked builds, build_time_scenes, render_motion
and the CLI's route of an animatedinstance under an open shutter.

- AnimatedTransform.eval at times between, on and beyond the keys, for
  keys whose rotations take each branch of the matrix-to-quaternion step
  (the trace's and each largest-diagonal one): within 1e-6 (XLA's and
  torch's arccos, sin and norm may differ by an ulp). The binary track
  files each package writes are the same bytes, and each loads the
  other's.
- build(time=) and build_time_scenes: the same triangles as the
  reference's builds (within 1e-6), bit for bit as scenes converted from
  them; the default time is shutter-open.
- render_motion at 16x16 (4 bins, depth 2) against the reference's
  render_motion on its kernel path (tests/torch_kernel_path.py): within
  1e-6 of the image's largest pixel; tests/test_motion.py:80-110's gates
  on the port (the x-extent grows by more than 3 px, the energy within
  10% of the render at mid-shutter).
- The CLI routes a scene file with an animatedinstance and shutterClose
  to render_motion, bit for bit.
"""
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from mitsuba_tpu.core import track as jtrack
from mitsuba_tpu.core import transform as jtf
from mitsuba_tpu.integrators.path import PathConfig as JaxPathConfig
from mitsuba_tpu.integrators.path import render as jax_render
from mitsuba_tpu.io import xml as jxml
from mitsuba_tpu.render import mesh as jmesh
from mitsuba_tpu.render.camera import make_perspective as jpersp
from mitsuba_tpu.render.scene import SceneBuilder as JaxSceneBuilder
from mitsuba_tpu_torch.cli import main
from mitsuba_tpu_torch.core import track as ttrack
from mitsuba_tpu_torch.integrators.path import (
    PathConfig, render, render_motion,
)
from mitsuba_tpu_torch.interop import from_jax_scene
from mitsuba_tpu_torch.io import bitmap
from mitsuba_tpu_torch.io import xml as txml
from tests import torch_sss_cases as sc
from tests.torch_kernel_path import kernel_path

torch.set_num_threads(1)
JMODS = SimpleNamespace(SceneBuilder=JaxSceneBuilder, mesh=jmesh,
                        look_at=jtf.look_at, track=jtrack,
                        make_perspective=jpersp)
TIMES = (-0.5, 0.0, 0.15, 0.4, 0.55, 1.0, 1.3, 2.0, 3.0)


def _rot(axis, angle):
    m = np.eye(4)
    c, s = np.cos(angle), np.sin(angle)
    i, j = [(1, 2), (2, 0), (0, 1)][axis]
    m[i, i], m[i, j], m[j, i], m[j, j] = c, -s, s, c
    return m


def _keys(mod):
    """Four keys: a small turn (trace > 0), then half turns about x, y
    and z (the largest-diagonal branches), with translation and scale."""
    at = mod.AnimatedTransform()
    at.append_transform(0.0, _rot(2, 0.3) @ np.diag([1.0, 2.0, 1.0, 1.0]))
    m = _rot(0, 3.0)
    m[:3, 3] = (1.0, -2.0, 0.5)
    at.append_transform(0.4, m)
    at.append_transform(1.0, _rot(1, 2.9) @ np.diag([0.5, 0.5, 0.5, 1.0]))
    m = _rot(2, 3.1)
    m[:3, 3] = (-3.0, 0.0, 2.0)
    at.append_transform(2.0, m)
    return at


def test_track_eval_matches_reference():
    tat, jat = _keys(ttrack), _keys(jtrack)
    np.testing.assert_array_equal(np.asarray(tat._quats),
                                  np.asarray(jat._quats))
    want = np.asarray(jat.eval(np.asarray(TIMES, np.float32)))
    np.testing.assert_allclose(tat.eval(np.asarray(TIMES)).numpy(), want,
                               rtol=0, atol=1e-6)
    for t, w in zip(TIMES, want):
        np.testing.assert_allclose(tat.eval(t).numpy(), w, rtol=0,
                                   atol=1e-6, err_msg=str(t))
    one = ttrack.AnimatedTransform().append_transform(0.5, _rot(1, 0.7))
    jone = jtrack.AnimatedTransform().append_transform(0.5, _rot(1, 0.7))
    np.testing.assert_allclose(one.eval(2.0).numpy(),
                               np.asarray(jone.eval(2.0)), atol=1e-6)


def test_track_files_match_reference(tmp_path):
    tp, jp = str(tmp_path / "t.track"), str(tmp_path / "j.track")
    ttrack.save_animated_transform(tp, _keys(ttrack))
    jtrack.save_animated_transform(jp, _keys(jtrack))
    with open(tp, "rb") as f, open(jp, "rb") as g:
        assert f.read() == g.read()
    np.testing.assert_allclose(
        ttrack.load_animated_transform(jp).eval(np.asarray(TIMES)).numpy(),
        np.asarray(jtrack.load_animated_transform(tp).eval(
            np.asarray(TIMES, np.float32))), rtol=0, atol=1e-6)
    # the reference rejects Euler rotation tracks, and so does the port
    with open(tp, "wb") as f:
        f.write(np.asarray([1, 9, 1], np.uint32).tobytes()
                + np.zeros(2, np.float32).tobytes())
    with pytest.raises(ValueError, match="Euler"):
        ttrack.load_animated_transform(tp)


@pytest.fixture(scope="module")
def builders():
    return (sc.moving_box_builder(sc.port_modules(), 16, 1.0),
            sc.moving_box_builder(JMODS, 16, 1.0))


def test_builds_match_reference(builders):
    tb, jb = builders
    for t in (None, 0.0, 0.3, 1.0):
        port = tb.build(backend="brute", device="cpu", time=t)
        jscene = jb.build(backend="brute", time=t)
        np.testing.assert_allclose(port.geom.v0.numpy(),
                                   np.asarray(jscene.geom.v0), atol=1e-6)
        assert port.geom.n_tris == 2 + 12 + 2
    assert torch.equal(tb.build(backend="brute", device="cpu").geom.v0,
                       tb.build(backend="brute", device="cpu",
                                time=0.0).geom.v0)
    scenes = tb.build_time_scenes(4, backend="brute", device="cpu")
    jscenes = jb.build_time_scenes(4, backend="brute")
    assert len(scenes) == len(jscenes) == 4
    for s, js in zip(scenes, jscenes):
        conv = from_jax_scene(js, device="cpu")
        assert torch.equal(s.geom.v0, conv.geom.v0)
        assert torch.equal(s.geom.e1, conv.geom.e1)
        assert (s.camera.shutter_open, s.camera.shutter_time) == \
            (conv.camera.shutter_open, conv.camera.shutter_time) == (0.0, 1.0)


class _TracedGeom:
    """The geometry the jitted reference render is tracing, for
    kernel_path's plain queries: one compile serves every time bin."""
    geom = None

    def __getattr__(self, name):
        return getattr(_TracedGeom.geom, name)


def test_render_motion_matches_reference(builders):
    tb, jb = builders
    cfg = JaxPathConfig(max_depth=2, spp=2, remat=False)
    with pytest.MonkeyPatch.context() as mp:
        kernel_path(mp, _TracedGeom())

        @jax.jit
        def run(scene, seed):
            _TracedGeom.geom = scene.geom
            return jax_render(scene, cfg, seed=seed)[0]

        ref = sum(np.asarray(run(s, 3 * 1031 + k)) for k, s in
                  enumerate(jb.build_time_scenes(4, backend="brute"))) / 4
    img, aux = render_motion(tb.build_time_scenes(4, backend="brute",
                                                  device="cpu"),
                             PathConfig(max_depth=2, spp=2), seed=3)
    assert aux["time_bins"] == 4 and ref.max() > 0
    np.testing.assert_allclose(img.numpy(), ref, rtol=0,
                               atol=1e-6 * float(ref.max()))


def test_motion_blur_gates():
    """tests/test_motion.py:80-110 on the port at 32x32."""
    b = sc.moving_box_builder(sc.port_modules(), 32, 1.0)
    cfg = PathConfig(max_depth=2, spp=4, remat=False)
    img_m, aux = render_motion(b.build_time_scenes(4, backend="brute",
                                                   device="cpu"), cfg)
    img_s, _ = render(b.build(backend="brute", device="cpu", time=0.5), cfg)
    img_m, img_s = img_m.numpy(), img_s.numpy()
    assert aux["time_bins"] == 4 and np.isfinite(img_m).all()

    def x_extent(img):
        cols = np.where((img.mean(-1) > 0.35).any(0))[0]
        return (cols.max() - cols.min()) if len(cols) else 0

    assert x_extent(img_m) > x_extent(img_s) + 3
    assert abs(img_m.mean() - img_s.mean()) / img_s.mean() < 0.1


def test_cli_routes_motion(tmp_path):
    path = sc.write_motion_xml(str(tmp_path), ttrack)
    defs = dict(depth=2, spp=2, width=12, height=12)
    out = str(tmp_path / "m.exr")
    argv = [a for k, v in defs.items() for a in ("-D", f"{k}={v}")]
    assert main(["--cpu", "-q", path, *argv, "-o", out]) == 0
    scene, cfg = txml.load_scene(path, params=defs, device="cpu")
    jscene, jcfg = jxml.load_scene(path, params=defs)
    assert len(cfg["time_scenes"]) == len(jcfg["time_scenes"]) == 4
    for s, js in zip(cfg["time_scenes"], jcfg["time_scenes"]):
        assert torch.equal(s.geom.v0, from_jax_scene(js, "cpu").geom.v0)
    ref, _ = render_motion(cfg["time_scenes"], PathConfig(
        max_depth=2, spp=2, remat=False), seed=0)
    assert float(ref.mean()) > 0
    assert np.array_equal(bitmap.read_exr(out), ref.numpy())
    # without the open shutter the same file renders through render
    static = path.replace("motion.xml", "static.xml")
    with open(path) as f, open(static, "w") as g:
        g.write(f.read().replace('name="shutterClose" value="1.0"',
                                 'name="shutterClose" value="0"'))
    scene, cfg = txml.load_scene(static, params=defs, device="cpu")
    assert "time_scenes" not in cfg
    assert scene.geom.n_tris == 2 + 12 + 2
