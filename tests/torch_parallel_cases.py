"""What each rank of a process group runs in the port's sharded tests
(tests/test_torch_parallel.py) and in chip_smoke.py's `sharded` phase:
importable without JAX, since `parallel.mesh.run_group` starts its ranks
by importing this module.

- `bumpy_cluster_scene(mods, device)`: tests/test_parallel.py:57's
  small mesh on the cluster backend with tiny exact-cull caps, so that
  the overflow re-run at the XL caps and the stream fallback have lanes.
- `rank_checks(rank, device, cases)`: the sharded renders, the training
  step, `is_coordinator` and `dryrun_multichip` on the rank's group;
  host numpy results.
"""
import dataclasses
import time

import numpy as np

# tests/test_parallel.py:96-97: many rows overflow CAPS -> XL -> stream
TINY_CAPS = ((128, 16, 32, 32), (128, 16, 32, 32), (128, 16, 64, 64))
# the sharded renders: (scene, resolution, spp, depth, seed)
CASES = {"cornell": ("cornell", 16, 4, 3, 3),
         "cluster": ("cluster", 16, 2, 2, 2)}
TRAIN = dict(res=8, spp=2, depth=2, lr=0.05)


def bumpy_cluster_scene(mods, device="cpu", res=16):
    b = mods.SceneBuilder()
    lm = b.materials.lambertian((0.6, 0.55, 0.5))
    th = np.linspace(0.1, np.pi - 0.1, 10)
    ph = np.linspace(0, 2 * np.pi, 10, endpoint=False)
    T, P = np.meshgrid(th, ph, indexing="ij")
    r = 1.0 + 0.25 * np.sin(3 * T) * np.cos(2 * P)
    v = np.stack([r * np.sin(T) * np.cos(P), r * np.cos(T),
                  r * np.sin(T) * np.sin(P)], -1).reshape(-1, 3)
    f = []
    for i in range(9):
        for j in range(10):
            a = i * 10 + j
            c = i * 10 + (j + 1) % 10
            d = (i + 1) * 10 + j
            e = (i + 1) * 10 + (j + 1) % 10
            f += [[a, c, d], [c, e, d]]
    b.add_shape(mods.mesh.TriMesh(v.astype(np.float32),
                                  np.asarray(f, np.int32)), lm)
    floor = mods.mesh.make_quad([-3, -1.4, -3], [3, -1.4, -3],
                                [3, -1.4, 3], [-3, -1.4, 3])
    b.add_shape(floor, lm)
    b.emitters.constant((0.7, 0.8, 0.9))
    cam = mods.make_perspective(mods.look_at((0, 0.5, 3.2), (0, 0, 0),
                                             (0, 1, 0)), 40.0, 1.0)
    b.set_camera(cam, res, res)
    kw = {} if device is None else {"device": device}
    scene = b.build(backend="cluster", **kw)
    return dataclasses.replace(scene, geom=dataclasses.replace(
        scene.geom, ex_caps=TINY_CAPS))


def port_modules():
    from types import SimpleNamespace

    from mitsuba_tpu_torch.core import transform as tf
    from mitsuba_tpu_torch.render import mesh
    from mitsuba_tpu_torch.render.camera import make_perspective
    from mitsuba_tpu_torch.render.scene import SceneBuilder

    return SimpleNamespace(SceneBuilder=SceneBuilder, mesh=mesh,
                           look_at=tf.look_at,
                           make_perspective=make_perspective)


def port_scene(spec, device):
    """The scene of a CASES entry (name, resolution, ...)."""
    from mitsuba_tpu_torch.render.scene import cornell_box

    name, res = spec[:2]
    if name == "cornell":
        return cornell_box(res, res, device=device)
    return bumpy_cluster_scene(port_modules(), device, res)


def apply_reflectance(scene, p):
    return dataclasses.replace(scene, materials=dataclasses.replace(
        scene.materials, reflectance=p["reflectance"]))


def training_inputs(device, train=TRAIN):
    """config 4's scene and parameter at the size of `train`, its target
    black."""
    import torch

    from mitsuba_tpu_torch.render.scene import cornell_box

    scene = cornell_box(train["res"], train["res"], device=device)
    target = torch.zeros((train["res"], train["res"], 3), device=device)
    return scene, target, {"reflectance": scene.materials.reflectance}


def single_step(scene, cfg, target, params, lr, seed=0):
    """One process's step: MSE(render, target) through autograd on all
    the lanes, then p - lr * grad."""
    import torch

    from mitsuba_tpu_torch.integrators.path import render

    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    img, _ = render(apply_reflectance(scene, leaves), cfg, seed=seed)
    loss = torch.mean((img - target) ** 2)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return ({k: (p - lr * g).detach() for (k, p), g in
             zip(leaves.items(), grads)}, loss.detach())


def rank_checks(rank, device="cpu", cases=CASES, train=TRAIN,
                dryrun=True):
    """A rank's share of each case's render_sharded and of a training
    step at `train`'s size, on `device` (a rank's own card under nccl),
    then dryrun_multichip on the whole group; its brute kernel launches
    (#1) counted from 0 over the renders and the step, and their
    seconds."""
    import torch

    from mitsuba_tpu_torch.graft_entry import dryrun_multichip
    from mitsuba_tpu_torch.integrators.path import PathConfig
    from mitsuba_tpu_torch.ops import intersect as ip
    from mitsuba_tpu_torch.parallel import (
        is_coordinator, pod_mesh, render_sharded, training_step_sharded,
    )
    from mitsuba_tpu_torch.parallel.mesh import rank_device

    import torch.distributed as dist

    t0 = time.perf_counter()
    device = rank_device(device, dist.get_backend(), rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    out = {"coordinator": is_coordinator(), "world": pod_mesh()[1]}
    ip.LAUNCHES = 0
    for case, spec in cases.items():
        _, _, spp, depth, seed = spec
        img, aux = render_sharded(port_scene(spec, device),
                                  PathConfig(max_depth=depth, spp=spp,
                                             remat=False), seed=seed)
        out[case] = (img.cpu().numpy(), int(aux["rays_traced"]))
    scene, target, params = training_inputs(device, train)
    cfg = PathConfig(max_depth=train["depth"], spp=train["spp"], remat=True)
    new, loss = training_step_sharded(scene, cfg, target, params,
                                      apply_reflectance, lr=train["lr"])
    out["train"] = (new["reflectance"].cpu().numpy(), float(loss))
    out["launches"] = ip.LAUNCHES
    out["seconds"] = time.perf_counter() - t0
    if dryrun:
        dryrun_multichip(out["world"], device=device)
    out["threads"] = torch.get_num_threads()
    return out
