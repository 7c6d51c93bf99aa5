"""The port's cameras against the JAX package: the orthographic camera,
the thin-lens perspective camera with an aperture sample, and the camera
plugins of the XML loader (render/camera.py).

Rays from the same seeded film and lens samples within 1e-5 relative and
1e-6 absolute; the camera's scalars equal. The render path draws no
aperture sample, in either package (mitsuba_tpu/integrators/path.py:1000):
an aperture leaves a render unchanged (ROADMAP C), which the last test
shows on both.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.core import transform as jtf
from mitsuba_tpu.core.registry import create_plugin as j_create
from mitsuba_tpu.render import camera as jcam
from mitsuba_tpu.render.scene import cornell_box as jax_cornell_box
from mitsuba_tpu_torch.core import transform as ttf
from mitsuba_tpu_torch.core.registry import create_plugin
from mitsuba_tpu_torch.integrators.path import PathConfig, render
from mitsuba_tpu_torch.interop import from_jax_scene
from mitsuba_tpu_torch.render import camera as tcam
from mitsuba_tpu_torch.render.scene import cornell_box

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-6
XF = jtf.look_at([1.0, 2.0, -4.0], [0.2, 0.5, 0.0], [0, 1, 0])


def _t(x):
    return torch.from_numpy(np.array(x))


def _rays_close(ray, jray):
    for k in ("o", "d", "mint", "maxt"):
        np.testing.assert_allclose(getattr(ray, k).numpy(),
                                   np.asarray(getattr(jray, k)), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


def _samples(n=2000, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(n, 2)).astype(np.float32),
            rng.uniform(size=(n, 2)).astype(np.float32))


def _same_camera(cam, jc):
    assert cam.kind == jc.kind
    assert np.array_equal(cam.to_world.numpy(), np.asarray(jc.to_world))
    for k in ("tan_half_fov_x", "tan_half_fov_y", "aperture_radius",
              "focus_distance", "ortho_scale"):
        assert getattr(cam, k) == float(np.asarray(getattr(jc, k))), k


@pytest.mark.parametrize("scale,aspect", [(1.0, 1.0), (2.5, 4 / 3)])
def test_orthographic_rays_match(scale, aspect):
    cam = tcam.make_orthographic(np.asarray(XF), scale, aspect)
    jc = jcam.make_orthographic(XF, scale, aspect)
    _same_camera(cam, jc)
    uv, _ = _samples()
    ray = cam.sample_ray(_t(uv))
    _rays_close(ray, jc.sample_ray(jnp.asarray(uv)))
    # parallel rays along the camera's +z
    d = ray.d.numpy()
    np.testing.assert_allclose(d, np.broadcast_to(d[0], d.shape), atol=1e-6)


@pytest.mark.parametrize("radius,focus", [(0.0, 1.0), (0.05, 3.0),
                                          (0.3, 7.5)])
def test_thin_lens_rays_match(radius, focus):
    cam = tcam.make_perspective(np.asarray(XF), 40.0, 1.5,
                                aperture_radius=radius,
                                focus_distance=focus)
    jc = jcam.make_perspective(XF, 40.0, 1.5, aperture_radius=radius,
                               focus_distance=focus)
    _same_camera(cam, jc)
    uv, lens = _samples()
    ray = cam.sample_ray(_t(uv), _t(lens))
    _rays_close(ray, jc.sample_ray(jnp.asarray(uv), jnp.asarray(lens)))
    # every ray of a film point meets at the focus plane
    if radius > 0:
        pin = cam.sample_ray(_t(uv))
        z_axis = cam.to_world[:3, 2]
        t = focus / (pin.d @ z_axis)
        p_focus = pin.o + pin.d * t[:, None]
        t2 = ((p_focus - ray.o) @ z_axis) / (ray.d @ z_axis)
        np.testing.assert_allclose((ray.o + ray.d * t2[:, None]).numpy(),
                                   p_focus.numpy(), atol=1e-4)


PLUGINS = {
    "perspective": ("perspective", {"fov": 35.0, "fovAxis": "y"}),
    "perspective_aperture": ("perspective", {
        "fov": 50.0, "apertureRadius": 0.2, "focusDistance": 4.0}),
    "orthographic": ("orthographic", {"scale": 2.0}),
    "orthographic_aspect": ("orthographic", {"aspect": 2.0}),
}


@pytest.mark.parametrize("case", sorted(PLUGINS))
def test_camera_plugins_match(case):
    name, props = PLUGINS[case]
    props = dict(props, toWorld=np.asarray(XF))
    cam = create_plugin("camera", name, props, aspect=1.25)
    jc = j_create("camera", name, props, aspect=1.25)
    _same_camera(cam, jc)
    uv, lens = _samples(500, 7)
    _rays_close(cam.sample_ray(_t(uv)), jc.sample_ray(jnp.asarray(uv)))


def test_open_shutter_refused(tmp_path):
    """An open shutter is ported (motion blur: render_motion,
    tests/test_torch_motion.py): the plugin keeps the reference's shutter
    interval. The analytic hair this case held refused beside it is
    ported too (ROADMAP A.12, tests/test_torch_hair.py): the scene loads
    with both, as the reference loads it."""
    props = {"shutterOpen": 0.25, "shutterClose": 0.75}
    cam = create_plugin("camera", "perspective", props)
    jc = j_create("camera", "perspective", props)
    assert (cam.shutter_open, cam.shutter_time) == (
        float(jc.shutter_open), float(jc.shutter_time)) == (0.25, 0.5)
    from mitsuba_tpu.io.xml import load_scene_string as j_load
    from mitsuba_tpu_torch.interop import from_jax_scene
    from mitsuba_tpu_torch.io.xml import load_scene_string
    from tests.torch_leftover_cases import write_hair

    write_hair(str(tmp_path / "h.hair"), 2, n_pts=3)
    src = ('<scene><camera type="perspective"><float name="shutterClose" '
           'value="0.5"/></camera><shape type="hair"><string '
           'name="filename" value="h.hair"/></shape></scene>')
    scene, _ = load_scene_string(src, base_dir=str(tmp_path), device="cpu")
    ref = from_jax_scene(j_load(src, base_dir=str(tmp_path))[0],
                         device="cpu")
    assert scene.camera.shutter_time == ref.camera.shutter_time == 0.5
    assert scene.geom.n_hair == 4
    assert torch.equal(scene.geom.hair_segs, ref.geom.hair_segs)
    assert torch.equal(scene.geom.hair_nodes, ref.geom.hair_nodes)


def test_aperture_leaves_a_render_unchanged():
    """ROADMAP C: render draws no aperture sample (path.py:1000), so a
    thin lens renders as the pinhole, in both packages."""
    pin = cornell_box(8, 8, device="cpu")
    lens = dataclasses.replace(pin, camera=dataclasses.replace(
        pin.camera, aperture_radius=50.0, focus_distance=800.0))
    cfg = PathConfig(max_depth=2, spp=2, remat=False)
    assert torch.equal(render(pin, cfg)[0], render(lens, cfg)[0])
    # the reference's render calls sample_ray(uv) (path.py:1000): its
    # thin lens then gives the pinhole's rays
    js = jax_cornell_box(8, 8)
    jlens = dataclasses.replace(js, camera=jcam.make_perspective(
        js.camera.to_world, 39.3077, 1.0, aperture_radius=50.0,
        focus_distance=800.0))
    uv, _ = _samples(256, 9)
    for k in ("o", "d"):
        np.testing.assert_array_equal(
            np.asarray(getattr(js.camera.sample_ray(jnp.asarray(uv)), k)),
            np.asarray(getattr(jlens.camera.sample_ray(jnp.asarray(uv)),
                               k)))
    conv = from_jax_scene(jlens, device="cpu")
    assert conv.camera.aperture_radius == 50.0


def test_orthographic_scene_renders():
    """The Cornell box through an orthographic camera renders finite,
    non-zero radiance (tests/test_torch_xml.py holds such a render against
    the reference's tables)."""
    b = cornell_box(8, 8, device="cpu")
    cam = tcam.make_orthographic(
        ttf.look_at([278, 273, -800], [278, 273, 0], [0, 1, 0]), 1.0)
    cam.to_world = cam.to_world @ torch.diag(torch.tensor(
        [300.0, 300.0, 1.0, 1.0]))
    img, _ = render(dataclasses.replace(b, camera=cam),
                    PathConfig(max_depth=2, spp=2))
    assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0
