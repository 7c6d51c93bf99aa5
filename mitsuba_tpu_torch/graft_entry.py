"""The graft entry points on the port (the JAX package's are the
root's `__graft_entry__.py`).

entry(device)            the forward render step of the flagship path: the
                         depth-5 wavefront MIS path tracer on the Cornell
                         box (64 x 64, brute, 4 spp) on one device.
dryrun_multichip(n)      the sharded render and one full differentiable
                         training step (render -> MSE -> gradients summed
                         over the ranks -> SGD update) on the current
                         process group of n ranks, at tiny shapes.
"""
from __future__ import annotations


def entry(device="cuda"):
    """(forward, (scene, pixel_id, sample_id)): forward(*args) is the
    (64, 64, 3) image of the lanes pixel * 4 + sample, seed 0, on
    `device` (the card by default)."""
    from mitsuba_tpu_torch.integrators.path import (
        PathConfig, camera_rays, lane_ids, path_trace,
    )
    from mitsuba_tpu_torch.render.scene import cornell_box

    scene = cornell_box(64, 64, backend="brute", device=device)
    cfg = PathConfig(max_depth=5, spp=4, remat=False)
    w, h, spp = scene.width, scene.height, cfg.spp
    pixel_id, sample_id, _ = lane_ids(scene, spp)

    def forward(scene, pixel_id, sample_id):
        ray, sampler, _ = camera_rays(scene, cfg, 0, pixel_id, sample_id)
        L, _ = path_trace(scene, ray, sampler, cfg)
        return L.reshape(h, w, spp, L.shape[-1]).mean(dim=2)

    return forward, (scene, pixel_id, sample_id)


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """The sharded render and one training step of the Cornell box's
    wall albedos toward black on the current process group, which must
    have at least n_devices ranks (initialise it first, e.g. through
    parallel.multihost.init_multihost). On `device`: each rank's own card
    under nccl."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from mitsuba_tpu_torch.integrators.path import PathConfig
    from mitsuba_tpu_torch.parallel import (
        make_mesh, render_sharded, training_step_sharded,
    )
    from mitsuba_tpu_torch.parallel.mesh import rank_device
    from mitsuba_tpu_torch.render.scene import cornell_box

    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < n_devices:
        raise RuntimeError(f"need {n_devices} ranks, the process group has "
                           f"{have} (initialise one of {n_devices} first)")
    group = dist.new_group(list(range(n_devices))) \
        if have > n_devices else None
    if dist.get_rank() >= n_devices:
        return
    mesh = make_mesh(group)
    dev = rank_device(device, dist.get_backend(mesh[0]), dist.get_rank())
    # tiny shapes: the lane count (w * h * spp) divisible by n_devices
    scene = cornell_box(8, n_devices, backend="brute", device=dev)
    cfg = PathConfig(max_depth=3, spp=2, remat=True)
    img, _ = render_sharded(scene, cfg, seed=0, mesh=mesh)
    if not bool(torch.isfinite(img).all()):
        raise RuntimeError("the sharded render is not finite")

    def apply_params(sc, p):
        return dataclasses.replace(sc, materials=dataclasses.replace(
            sc.materials, reflectance=p["reflectance"]))

    target = torch.zeros((scene.height, scene.width, 3), device=dev)
    new, loss = training_step_sharded(
        scene, cfg, target, {"reflectance": scene.materials.reflectance},
        apply_params, seed=0, mesh=mesh)
    if not (bool(torch.isfinite(new["reflectance"]).all())
            and float(loss) > 0):
        raise RuntimeError("the sharded training step gave no finite loss")
