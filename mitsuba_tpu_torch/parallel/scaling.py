"""Weak-scaling measurement of the sharded render (port of
mitsuba_tpu/parallel/scaling.py).

For each world size W a process group of W ranks is spawned
(parallel/mesh.py `run_group`); each renders `render_sharded` at a fixed
share of the wavefront (image height = rows_per_device * W), and the
rays per second of the best of `rounds` renders after a warm-up are
reported with efficiency = (rays/s at W) / (W x rays/s at 1). There is
no communication inside the render (each rank holds the whole scene),
only the film's gather. Ranks that share one card (gloo) measure the
card's sharing, not multi-GPU scaling.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from mitsuba_tpu_torch.integrators.path import PathConfig
from mitsuba_tpu_torch.parallel import mesh as mesh_mod


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _scaling_rank(rank, scene, cfg, rows_per_device, rounds, seed, device,
                  backend):
    import torch.distributed as dist

    device = mesh_mod.rank_device(device, backend, rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    world = dist.get_world_size()
    sc = dataclasses.replace(scene.to(device),
                             height=rows_per_device * world)
    img, aux = mesh_mod.render_sharded(sc, cfg, seed=seed)     # warm up
    _sync(device)
    best = float("inf")
    for r in range(rounds):
        dist.barrier()
        t0 = time.perf_counter()
        img, aux = mesh_mod.render_sharded(sc, cfg, seed=seed + r + 1)
        float(img.reshape(-1)[0])
        best = min(best, time.perf_counter() - t0)
    return float(aux["rays_traced"]) / best


def measure_scaling(scene, cfg: PathConfig, world_sizes=(1, 2),
                    rows_per_device: int = 32, rounds: int = 2,
                    seed: int = 0, device="cuda") -> dict:
    """{world size: rays/s} of the weak-scaling layout, each world size a
    process group of its own on `device` (the card by default: ranks
    take cards of their own where there are enough, else share it over
    gloo)."""
    from mitsuba_tpu_torch.render.scene import check_device

    check_device(device)
    host_scene = scene.to("cpu")
    results = {}
    for ws in world_sizes:
        backend = mesh_mod.default_backend(device, ws)
        rates = mesh_mod.run_group(
            _scaling_rank, ws, (host_scene, cfg, rows_per_device, rounds,
                                seed, str(device), backend),
            backend=backend)
        results[ws] = rates[0]
    return results


def scaling_efficiency(results: dict) -> dict:
    """Per world size, the efficiency against perfect weak scaling."""
    base = results[min(results)]
    n0 = min(results)
    return {
        nd: results[nd] / (base * nd / n0) for nd in sorted(results)
    }
