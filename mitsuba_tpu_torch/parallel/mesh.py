"""Sharded rendering over torch.distributed (port of
mitsuba_tpu/parallel/mesh.py).

The reference shards the wavefront's lane axis over a 1-D device mesh
from one controller; here each device has a process of its own, the
members of a process group. Each rank traces its slice of the lanes,
`[r * n / W, (r + 1) * n / W)` of `render`'s own layout (scanline, or
pixels in Morton order on the cluster backend, `integrators.path.
lane_ids`), with the same counter-based `Sampler(seed, pixel_id,
sample_id)`, so a lane draws the same numbers at any world size. The
lanes' radiance is all-gathered before the film's reshape, and every
rank returns the whole image. The scene lives whole on every rank's
device (the reference's replicated scene).

The training step reduces each parameter's gradient over the ranks: a
rank back-propagates the loss's gradient with respect to its own lanes
(the gathered image gives it), so the summed gradients, and the new
parameters, are those of one process's step on all the lanes.

Backends: `nccl` for CUDA tensors on distinct cards, `gloo` otherwise
(NCCL refuses two ranks on one card); under gloo the collectives run on
host copies. Rendezvous is by file (`run_group` gives each group a
`file://` init method), so no port is opened.
"""
from __future__ import annotations

import dataclasses
import multiprocessing
import os
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from mitsuba_tpu_torch.integrators import path as path_mod


def make_mesh(group=None):
    """(group, world size) of `group`, by default the current process
    group (init_process_group, or multihost.init_multihost, first)."""
    group = dist.group.WORLD if group is None else group
    return group, dist.get_world_size(group)


def _rank(mesh) -> int:
    return dist.get_rank(mesh[0])


def shard_lanes(mesh, arr):
    """This rank's slice of a lane-major array (its leading axis split
    evenly over the group)."""
    k = arr.shape[0] // mesh[1]
    r = _rank(mesh)
    return arr[r * k:(r + 1) * k]


def _host_collectives(mesh) -> bool:
    return dist.get_backend(mesh[0]) != "nccl"


def _all_gather(mesh, x):
    """The ranks' x concatenated in rank order, on x's device."""
    group, world = mesh
    src = x.cpu() if _host_collectives(mesh) else x.contiguous()
    out = [torch.empty_like(src) for _ in range(world)]
    dist.all_gather(out, src, group=group)
    return torch.cat(out).to(x.device)


def _all_reduce(mesh, x):
    """The sum of x over the ranks, on x's device."""
    group = mesh[0]
    src = x.detach().cpu() if _host_collectives(mesh) \
        else x.detach().clone()
    dist.all_reduce(src, group=group)
    return src.to(x.device)


def _trace_lanes(scene, cfg, seed, pixel_id, sample_id):
    """Lane-parallel radiance of the lanes (pixel_id, sample_id)."""
    ray, sampler, _ = path_mod.camera_rays(scene, cfg, seed, pixel_id,
                                           sample_id)
    return path_mod.path_trace(scene, ray, sampler, cfg)


def _film(scene, cfg, L, inv_lane):
    """Box-filter film of the gathered lanes, as the reference's reshape
    (the lanes back in scanline order first)."""
    if inv_lane is not None:
        L = L[inv_lane]
    return L.reshape(scene.height, scene.width, cfg.spp,
                     L.shape[-1]).mean(dim=2)


def _shards(scene, cfg, mesh):
    """This rank's lanes of `render`'s layout (so the sharded and the
    single-process renders stay comparable lane by lane): (cfg,
    pixel_id, sample_id, inv_lane)."""
    if scene.geom.backend == "cluster" and not cfg.sort_rays:
        # integrators.path.render's normalisation on the cluster backend
        cfg = dataclasses.replace(cfg, sort_rays=True)
    pixel_id, sample_id, inv_lane = path_mod.lane_ids(scene, cfg.spp)
    n = pixel_id.shape[0]
    assert n % mesh[1] == 0, (
        f"lane count {n} (w*h*spp) must be divisible by device count "
        f"{mesh[1]}")
    return (cfg, shard_lanes(mesh, pixel_id), shard_lanes(mesh, sample_id),
            inv_lane)


def render_sharded(scene, cfg, seed: int = 0, mesh=None):
    """Render with the lanes split over the group; every rank returns
    ((H, W, C) image, aux), aux's rays_traced summed and avg_path_length
    averaged over the ranks. The image equals `integrators.render`'s
    (box filter) up to float reassociation in the lanes' queries: the
    random numbers are counter-based per (pixel, sample)."""
    mesh = mesh or make_mesh()
    cfg, pixel_id, sample_id, inv_lane = _shards(scene, cfg, mesh)
    L, aux = _trace_lanes(scene, cfg, seed, pixel_id, sample_id)
    img = _film(scene, cfg, _all_gather(mesh, L), inv_lane)
    stats = _all_reduce(mesh, torch.stack([
        aux["rays_traced"].to(torch.float64),
        aux["avg_path_length"].to(torch.float64)]))
    return img, {"rays_traced": stats[0].to(torch.int64),
                 "avg_path_length": (stats[1] / mesh[1]).to(torch.float32)}


def training_step_sharded(scene, cfg, target_img, params: dict,
                          apply_params, seed: int = 0, mesh=None,
                          lr: float = 0.05):
    """One inverse-rendering step over the group: loss = MSE(render,
    target), each parameter's gradient summed over the ranks, then
    p - lr * grad. params: {name: tensor}; apply_params(scene, params)
    -> the scene with them substituted. Returns (new_params, loss) on
    every rank."""
    mesh = mesh or make_mesh()
    cfg, pixel_id, sample_id, inv_lane = _shards(scene, cfg, mesh)
    names = list(params)
    leaves = [params[k].detach().clone().requires_grad_(True)
              for k in names]
    with torch.enable_grad():
        L, _ = _trace_lanes(apply_params(scene, dict(zip(names, leaves))),
                            cfg, seed, pixel_id, sample_id)
        # the whole image, and d loss / d img, from the gathered lanes
        img = _film(scene, cfg, _all_gather(mesh, L.detach()),
                    inv_lane).requires_grad_(True)
        loss = torch.mean((img - target_img.to(img.device)) ** 2)
        (g_img,) = torch.autograd.grad(loss, img)
        # ... back through the film to every lane, then to this rank's
        g_lane = (g_img[:, :, None, :] / cfg.spp).expand(
            -1, -1, cfg.spp, -1).reshape(-1, L.shape[-1])
        if inv_lane is not None:
            g_lane = torch.empty_like(g_lane).index_copy_(0, inv_lane,
                                                          g_lane)
        grads = torch.autograd.grad(L, leaves,
                                    grad_outputs=shard_lanes(mesh, g_lane),
                                    allow_unused=True)
    new = {}
    for k, p, g in zip(names, leaves, grads):
        g = torch.zeros_like(p) if g is None else g
        new[k] = (p - lr * _all_reduce(mesh, g)).detach()
    return new, loss.detach()


# ---------------------------------------------------------------------------
# process groups
# ---------------------------------------------------------------------------

def default_backend(device, world_size: int) -> str:
    """`nccl` where each of world_size ranks can take a card of its own,
    `gloo` otherwise (the CPU, or ranks sharing a card)."""
    if torch.device(device).type == "cuda" \
            and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def rank_device(device, backend: str, rank: int) -> torch.device:
    """The device of a rank: its own card under nccl, else `device`."""
    device = torch.device(device)
    if device.type == "cuda" and backend == "nccl":
        return torch.device("cuda", rank)
    return device


def _rank_main(fn, args, rank, world_size, init_method, backend, results):
    torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    try:
        out = fn(rank, *args)
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    else:
        results.put((rank, True, out))
    finally:
        dist.destroy_process_group()


def run_group(fn, world_size: int, args=(), backend: str = "gloo",
              timeout: float = 900.0) -> list:
    """Run fn(rank, *args) in world_size spawned processes joined in one
    process group (`backend`, rendezvous through a file in a temporary
    directory) and return their results by rank. fn must be importable
    by name, its arguments and result picklable (send tensors on the
    host). Raises with a rank's traceback where one fails."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, args=(
            fn, args, r, world_size, init_method, backend, results))
            for r in range(world_size)]
        for p in procs:
            p.start()
        try:
            out = _collect(procs, results, world_size, timeout)
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.terminate()
                    p.join()
    return out


def _collect(procs, results, world_size, timeout):
    got = {}
    deadline = time.monotonic() + timeout
    while len(got) < world_size:
        try:
            rank, ok, out = results.get(timeout=1.0)
        except queue.Empty:
            if time.monotonic() > deadline:
                raise TimeoutError(f"process group of {world_size} ranks "
                                   f"gave no result in {timeout} s")
            dead = [p for p in procs if p.exitcode not in (None, 0)]
            if dead and results.empty():
                raise RuntimeError(f"rank process exited with code "
                                   f"{dead[0].exitcode}")
            continue
        if not ok:
            raise RuntimeError(f"rank {rank} failed:\n{out}")
        got[rank] = out
    return [got[r] for r in range(world_size)]
