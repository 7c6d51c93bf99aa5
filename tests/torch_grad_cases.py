"""Scenes and checks of the port's gradients off the brute backend, shared
by its CPU tests, its card tests and chip_smoke.py (numpy and torch only:
the caller passes either package's builder modules, so nothing here
imports JAX).

* `mesh_scene`: tests/test_torch_grad.py's `_small_mesh_scene` (an
  8 x 16 lambertian sphere mesh under a downward area quad) on a red
  floor, seen by a camera, on any backend: two reflectance rows and one
  emitter whose radiance the image is linear in.
* `with_field`, `value_and_grad`, `mean_l`: bench.py bench_backward's
  loss (the mean of path_trace's L over the render's lanes) and its
  gradient with respect to one field of one scene table;
  `cached_mean_l` the same with a subsurface scene's irradiance cache
  filled inside the loss, `ptracer_mean` the particle tracer's image
  mean.
* `grad_checks`: the 32 x 32 checks of a gradient path (central
  differences, linearity in radiance, a checkpoint a bounce against none,
  the card against the CPU), as one dict of measurements and verdicts.
"""
from __future__ import annotations

import dataclasses

FD_EPS = 2e-3             # tests/test_grad.py
FD_RTOL = 2e-2
LIN_RTOL = 1e-4
REMAT_RTOL = 1e-5
CPU_RTOL = 1e-3           # of the largest entry


def mesh_scene(mods, res: int, backend: str, **build_kw):
    """`_small_mesh_scene`'s sphere and light on a floor, res x res."""
    b = mods.SceneBuilder()
    mat = b.materials.lambertian()
    red = b.materials.lambertian((0.7, 0.25, 0.2))
    b.add_shape(mods.mesh.make_sphere_mesh([0, 0, 3], 1.0, 8, 16), mat)
    b.add_area_emitter_shape(mods.mesh.make_quad(
        [-1, 2, 2], [1, 2, 2], [1, 2, 4], [-1, 2, 4]), mat, (5.0,) * 3)
    b.add_shape(mods.mesh.make_quad([-4, -1, -1], [-4, -1, 7], [4, -1, 7],
                                    [4, -1, -1]), red)
    b.set_camera(mods.make_perspective(
        mods.look_at([0, 1.0, -1.5], [0, 0, 3], [0, 1, 0]), 45, 1.0),
        res, res)
    return b.build(backend=backend, **build_kw)


def with_field(scene, table, **fields):
    return dataclasses.replace(scene, **{table: dataclasses.replace(
        getattr(scene, table), **fields)})


def mean_l(scene, cfg, seed=0):
    """bench.py bench_backward's loss: the mean of the path tracer's L
    over the render's lanes (the render's own lane order)."""
    from mitsuba_tpu_torch.integrators.path import (
        camera_wavefront, path_trace,
    )

    ray, sampler, _ = camera_wavefront(scene, cfg, seed)
    return path_trace(scene, ray, sampler, cfg)[0].mean()


def cached_mean_l(scene, cfg, seed=0):
    """`mean_l` of a subsurface scene with its irradiance cache filled
    inside the loss, at `seed`, as `render` fills it."""
    from mitsuba_tpu_torch.subsurface.dipole import prepare_scene_irradiance

    if scene.subsurface.irradiance is None:
        scene = dataclasses.replace(scene, subsurface=(
            prepare_scene_irradiance(scene, seed=seed)))
    return mean_l(scene, cfg, seed)


def ptracer_mean(n_particles):
    """The particle tracer's loss, the mean of its image."""
    def loss(scene, cfg, seed=0):
        from mitsuba_tpu_torch.integrators.ptracer import ptracer_render

        return ptracer_render(scene, cfg, n_particles, seed=seed)[0].mean()
    return loss


def value_and_grad(loss_fn, scene, cfg, table="materials",
                   field="reflectance", seed=0):
    """(loss, gradient) of loss_fn(scene, cfg, seed) with respect to
    scene.<table>.<field>."""
    x = getattr(getattr(scene, table), field).detach().clone() \
        .requires_grad_(True)
    loss = loss_fn(with_field(scene, table, **{field: x}), cfg, seed)
    loss.backward()
    return float(loss.detach()), x.grad


def central_differences(loss_fn, scene, cfg, g, entries, table="materials",
                        field="reflectance", eps=FD_EPS, seed=0):
    """[(entry, fd, grad, rel)] at each entry of scene.<table>.<field>."""
    import torch

    x0 = getattr(getattr(scene, table), field).detach()
    out = []
    with torch.no_grad():
        for idx in entries:
            e = torch.zeros_like(x0)
            e[idx] = 1.0
            lp = float(loss_fn(with_field(scene, table,
                                          **{field: x0 + eps * e}), cfg, seed))
            lm = float(loss_fn(with_field(scene, table,
                                          **{field: x0 - eps * e}), cfg, seed))
            f, a = (lp - lm) / (2 * eps), float(g[idx])
            out.append(dict(entry=list(idx), fd=f, grad=a,
                            rel=abs(f - a) / max(abs(f), abs(a), 1e-6)))
    return out


def grad_checks(loss_fn, scene, cfg, entries, seed=0,
                fd_table="materials", fd_field="reflectance",
                fd_eps=FD_EPS):
    """The gradient checks of one path on `scene` (on the card): central
    differences at `entries` of the reflectance (or of
    fd_table.fd_field), linearity in emitter radiance, remat on against
    off, and the scene's device against the CPU. Returns (measurements,
    failures)."""
    import torch

    out, bad = {}, []
    _, g = value_and_grad(loss_fn, scene, cfg, seed=seed)
    out["finite"] = bool(torch.isfinite(g).all())
    out["grad_abs_max"] = float(g.abs().max())
    if not out["finite"] or not out["grad_abs_max"] > 0:
        bad.append("reflectance gradient not finite or zero")
    if (fd_table, fd_field) == ("materials", "reflectance"):
        g_fd = g
    else:
        _, g_fd = value_and_grad(loss_fn, scene, cfg, fd_table, fd_field,
                                 seed=seed)
    out["fd"] = central_differences(loss_fn, scene, cfg, g_fd, entries,
                                    fd_table, fd_field, fd_eps, seed)
    bad += [f"central differences {r}" for r in out["fd"]
            if not r["rel"] < FD_RTOL]
    l0, g_rad = value_and_grad(loss_fn, scene, cfg, "emitters", "radiance",
                               seed=seed)
    pred = float((g_rad * scene.emitters.radiance).sum())
    out["linearity"] = dict(loss=l0, predicted=pred,
                            rel=abs(pred - l0) / abs(l0))
    if not out["linearity"]["rel"] <= LIN_RTOL:
        bad.append(f"linearity {out['linearity']}")
    _, g_plain = value_and_grad(loss_fn, scene, dataclasses.replace(
        cfg, remat=not cfg.remat), seed=seed)
    diff = (g - g_plain).abs()
    out["remat"] = dict(max_abs=float(diff.max()), max_rel=float(
        (diff / g_plain.abs().clamp(min=1e-30)).max()))
    if not bool(torch.allclose(g, g_plain, rtol=REMAT_RTOL, atol=0)):
        bad.append(f"remat {out['remat']}")
    _, g_cpu = value_and_grad(loss_fn, scene.to("cpu"), cfg, seed=seed)
    err = float((g.cpu() - g_cpu).abs().max())
    out["cpu"] = dict(max_abs=err, rel_to_max=err / float(g_cpu.abs().max()))
    if not out["cpu"]["rel_to_max"] <= CPU_RTOL:
        bad.append(f"card vs CPU {out['cpu']}")
    return out, bad


def port_modules():
    """The port's builder modules, as `mesh_scene` takes them."""
    from types import SimpleNamespace

    from mitsuba_tpu_torch.core import transform as tf
    from mitsuba_tpu_torch.render import mesh
    from mitsuba_tpu_torch.render.camera import make_perspective
    from mitsuba_tpu_torch.render.scene import SceneBuilder

    return SimpleNamespace(SceneBuilder=SceneBuilder, mesh=mesh,
                           look_at=tf.look_at,
                           make_perspective=make_perspective)

