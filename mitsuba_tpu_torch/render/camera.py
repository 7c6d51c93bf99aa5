"""Cameras: perspective (pinhole or thin lens) and orthographic (port of
mitsuba_tpu/render/camera.py; reference src/cameras/perspective.cpp and
orthographic.cpp), and the camera plugins of the XML loader. The
perspective camera carries its shutter interval (`shutter_open`,
`shutter_time`; the plugin's shutterOpen and shutterClose): rays carry no
time, and motion blur averages scenes baked at stratified shutter times
(render/scene.py `build_time_scenes`, integrators/path.py
`render_motion`), as in the reference.

A thin lens takes an aperture sample: `sample_ray(film_uv,
aperture_sample)`. The render path calls `sample_ray(uv)` without one, as
the reference's does (mitsuba_tpu/integrators/path.py:1000), so an
aperture does not blur a render of either package (ROADMAP C).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from mitsuba_tpu_torch.core import math as m
from mitsuba_tpu_torch.core import transform as tf
from mitsuba_tpu_torch.core import warp
from mitsuba_tpu_torch.core.registry import register_plugin
from mitsuba_tpu_torch.render.records import Ray

PERSPECTIVE, ORTHOGRAPHIC = 0, 1


@dataclass
class Camera:
    to_world: torch.Tensor        # (4, 4) float32 camera-to-world
    tan_half_fov_x: float
    tan_half_fov_y: float
    aperture_radius: float = 0.0  # thin lens
    focus_distance: float = 1.0
    ortho_scale: float = 1.0      # half-width of the orthographic view
    kind: int = PERSPECTIVE
    shutter_open: float = 0.0     # the shutter interval (motion blur)
    shutter_time: float = 0.0

    def sample_ray(self, film_uv, aperture_sample=None):
        """film_uv: (N, 2) in [0,1)^2 (x right, y down, origin top-left).
        Returns world-space rays: +z forward, film v flipped to camera y.
        aperture_sample (N, 2): a thin-lens perspective camera's point on
        the lens (camera.py:34-60)."""
        ndc_x = (2.0 * film_uv[..., 0] - 1.0) * self.tan_half_fov_x
        ndc_y = (1.0 - 2.0 * film_uv[..., 1]) * self.tan_half_fov_y
        if self.kind == PERSPECTIVE:
            d_local = m.normalize(
                torch.stack([ndc_x, ndc_y, torch.ones_like(ndc_x)], dim=-1))
            o_local = torch.zeros_like(d_local)
            if aperture_sample is not None:
                p_lens = warp.square_to_uniform_disk_concentric(
                    aperture_sample) * _f32(self.aperture_radius)
                ft = _f32(self.focus_distance) / torch.clamp(
                    d_local[..., 2], min=1e-6)
                p_focus = d_local * ft[..., None]
                o_local = torch.cat(
                    [p_lens, torch.zeros_like(p_lens[..., :1])], dim=-1)
                d_local = m.normalize(p_focus - o_local)
        else:
            sc = _f32(self.ortho_scale)
            o_local = torch.stack([ndc_x * sc, ndc_y * sc,
                                   torch.zeros_like(ndc_x)], dim=-1)
            d_local = torch.zeros_like(o_local)
            d_local[..., 2] = 1.0
        o = tf.apply_point(self.to_world, o_local)
        d = m.normalize(tf.apply_vector(self.to_world, d_local))
        return Ray.make(o, d)


def _f32(x) -> float:
    """Round to float32, as the reference stores the camera's scalars."""
    return float(np.float32(x))


def make_perspective(to_world, fov_deg: float, aspect: float,
                     fov_axis: str = "x", aperture_radius: float = 0.0,
                     focus_distance: float = 1.0, shutter_open: float = 0.0,
                     shutter_time: float = 0.0) -> Camera:
    tan_half = float(np.tan(np.deg2rad(fov_deg) / 2.0))
    if fov_axis == "larger":
        fov_axis = "x" if aspect >= 1 else "y"
    elif fov_axis == "smaller":
        fov_axis = "y" if aspect >= 1 else "x"
    if fov_axis == "x":
        tx, ty = tan_half, tan_half / aspect
    elif fov_axis == "y":
        tx, ty = tan_half * aspect, tan_half
    elif fov_axis == "diagonal":
        diag = tan_half / np.sqrt(1.0 + 1.0 / (aspect * aspect))
        tx, ty = diag, diag / aspect
    else:
        raise ValueError(f"unknown fov_axis '{fov_axis}'")
    return Camera(
        to_world=torch.as_tensor(np.asarray(to_world, np.float32)),
        tan_half_fov_x=_f32(tx),
        tan_half_fov_y=_f32(ty),
        aperture_radius=_f32(aperture_radius),
        focus_distance=_f32(focus_distance),
        shutter_open=_f32(shutter_open),
        shutter_time=_f32(shutter_time),
    )


def make_orthographic(to_world, scale: float = 1.0,
                      aspect: float = 1.0) -> Camera:
    """Parallel rays along +z from a film of half-width `scale`
    (camera.py:109)."""
    return Camera(
        to_world=torch.as_tensor(np.asarray(to_world, np.float32)),
        tan_half_fov_x=1.0, tan_half_fov_y=_f32(1.0 / aspect),
        ortho_scale=_f32(scale), kind=ORTHOGRAPHIC)


@register_plugin("camera", "perspective")
def _make_perspective_plugin(props, aspect=1.0):
    """The XML `perspective` camera (reference camera.py:123)."""
    return make_perspective(
        to_world=props.get("toWorld", tf.identity()),
        fov_deg=float(props.get("fov", 49.13)),
        aspect=float(props.get("aspect", aspect)),
        fov_axis=props.get("fovAxis", "x"),
        aperture_radius=float(props.get("apertureRadius", 0.0)),
        focus_distance=float(props.get("focusDistance", 1.0)),
        shutter_open=float(props.get("shutterOpen", 0.0)),
        shutter_time=float(props.get("shutterClose", 0.0))
        - float(props.get("shutterOpen", 0.0)),
    )


@register_plugin("camera", "orthographic")
def _make_ortho_plugin(props, aspect=1.0):
    """The XML `orthographic` camera (reference camera.py:138)."""
    return make_orthographic(
        to_world=props.get("toWorld", tf.identity()),
        scale=float(props.get("scale", 1.0)),
        aspect=float(props.get("aspect", aspect)),
    )
