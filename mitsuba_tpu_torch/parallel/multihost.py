"""Joining a multi-process, multi-host job (port of
mitsuba_tpu/parallel/multihost.py).

The reference joins the hosts of a TPU pod slice into one SPMD job
(`jax.distributed.initialize`); its PyTorch form is one process per
device in one `torch.distributed` process group, which parallel/mesh.py
renders over unchanged. The functions are thin wrappers, kept apart so
single-process code does not touch `torch.distributed`.
"""
from __future__ import annotations

import torch.distributed as dist


def init_multihost(init_method: str | None = None,
                   world_size: int | None = None, rank: int | None = None,
                   backend: str | None = None) -> None:
    """Join this process to the job's default process group. With no
    arguments the rendezvous, world size and rank come from the
    environment (`env://`: MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK,
    as torchrun sets them); backend: `nccl` where the card is there,
    else `gloo` (torch.distributed's own default)."""
    kw = {}
    if world_size is not None:
        kw["world_size"] = world_size
    if rank is not None:
        kw["rank"] = rank
    dist.init_process_group(backend, init_method=init_method or "env://",
                            **kw)


def pod_mesh():
    """The mesh of every process of the job (parallel/mesh.py make_mesh
    of the default group): rendering is parallel over pixels, so a flat
    lane shard a process is the right default across hosts too, the only
    traffic the film's gather and the gradients' reduction."""
    from mitsuba_tpu_torch.parallel.mesh import make_mesh

    return make_mesh()


def is_coordinator() -> bool:
    """True on rank 0, the process that should write output files (every
    rank holds the whole gathered film)."""
    return dist.get_rank() == 0
