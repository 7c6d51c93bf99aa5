"""Perspective pinhole camera (port of the aperture-free perspective path of
mitsuba_tpu/render/camera.py; reference src/cameras/perspective.cpp), and
the camera plugins of the XML loader: `perspective`; `orthographic`, a
thin-lens aperture and an open shutter raise NotImplementedError."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from mitsuba_tpu_torch.core import math as m
from mitsuba_tpu_torch.core import transform as tf
from mitsuba_tpu_torch.core.registry import register_plugin
from mitsuba_tpu_torch.render.records import Ray


@dataclass
class Camera:
    to_world: torch.Tensor        # (4, 4) float32 camera-to-world
    tan_half_fov_x: float
    tan_half_fov_y: float

    def sample_ray(self, film_uv):
        """film_uv: (N, 2) in [0,1)^2 (x right, y down, origin top-left).
        Returns world-space rays: +z forward, film v flipped to camera y."""
        ndc_x = (2.0 * film_uv[..., 0] - 1.0) * self.tan_half_fov_x
        ndc_y = (1.0 - 2.0 * film_uv[..., 1]) * self.tan_half_fov_y
        d_local = m.normalize(
            torch.stack([ndc_x, ndc_y, torch.ones_like(ndc_x)], dim=-1))
        o_local = torch.zeros_like(d_local)
        o = tf.apply_point(self.to_world, o_local)
        d = m.normalize(tf.apply_vector(self.to_world, d_local))
        return Ray.make(o, d)


def _f32(x) -> float:
    """Round to float32, as the reference stores the camera's scalars."""
    return float(np.float32(x))


def make_perspective(to_world, fov_deg: float, aspect: float,
                     fov_axis: str = "x") -> Camera:
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
    )


@register_plugin("camera", "perspective")
def _make_perspective_plugin(props, aspect=1.0):
    """The XML `perspective` camera (reference camera.py:123)."""
    aperture = float(props.get("apertureRadius", 0.0))
    shutter = float(props.get("shutterClose", 0.0)) \
        - float(props.get("shutterOpen", 0.0))
    if aperture != 0.0:
        raise NotImplementedError(
            "a thin-lens aperture is not ported (ROADMAP A.11)")
    if shutter != 0.0:
        raise NotImplementedError(
            "an open shutter (motion blur, render_motion) is not ported "
            "(ROADMAP A.11, A.12)")
    return make_perspective(
        to_world=props.get("toWorld", tf.identity()),
        fov_deg=float(props.get("fov", 49.13)),
        aspect=float(props.get("aspect", aspect)),
        fov_axis=props.get("fovAxis", "x"),
    )


@register_plugin("camera", "orthographic")
def _make_ortho_plugin(props, aspect=1.0):
    raise NotImplementedError(
        "the orthographic camera is not ported (ROADMAP A.11)")
