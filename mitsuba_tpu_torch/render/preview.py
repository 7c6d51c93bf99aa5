"""Progressive preview rendering (port of mitsuba_tpu/render/preview.py;
the reference's libhw + PreviewThread, qtgui/preview.h:40: passes that
refine while the user watches).

The forward renderer accumulates low-spp passes into a FilmCheckpoint
and hands each refined image to a callback: the preview runs the same
kernels as a final render, on the scene's device.
"""
from __future__ import annotations

import time

from mitsuba_tpu_torch.integrators.path import PathConfig, render
from mitsuba_tpu_torch.utils.checkpoint import FilmCheckpoint


def progressive_render(scene, cfg: PathConfig, n_passes: int = 16,
                       callback=None, seed: int = 0,
                       checkpoint: FilmCheckpoint | None = None,
                       guided: bool = False, guide_res: int = 16):
    """Accumulate `n_passes` renders of cfg.spp each, pass i at seed
    seed * 7919 + i; callback(image, i, spp_total, dt) after every pass.
    Resumes from `checkpoint`. Returns (image, FilmCheckpoint), the
    image a float32 host array.

    guided=True: each pass samples the guide learned by all the earlier
    passes while it keeps learning (integrators/guiding.py); the first
    only learns."""
    fc = checkpoint or FilmCheckpoint(scene.height, scene.width)
    start_pass = fc.count // max(cfg.spp, 1)
    guide = None
    if guided:
        from mitsuba_tpu_torch.integrators.guiding import scene_guide

        guide = scene_guide(scene, guide_res)
    for i in range(start_pass, start_pass + n_passes):
        t0 = time.time()
        if guided:
            img, aux = render(scene, cfg, seed=seed * 7919 + i,
                              guide=guide, learn_guide=True,
                              guide_sampling=i > start_pass)
            guide = aux["guide"]
        else:
            img, _ = render(scene, cfg, seed=seed * 7919 + i)
        fc.add_pass(img, cfg.spp)
        if callback is not None:
            callback(fc.image, i, fc.count, time.time() - t0)
    return fc.image, fc


def vpl_preview(scene, spp: int = 1, n_paths: int = 48, vpl_depth: int = 2,
                clamp_dist_frac: float = 0.05, seed: int = 0):
    """One fast VPL pass (the reference PreviewWorker's picture,
    qtgui/preview.cpp): Le plus the clamped light of a small VPL set,
    integrators/vpl.py `render_vpl` at depth 2, the clamp distance
    clamp_dist_frac of the scene's triangle-vertex box diagonal. A
    deterministic first frame while progressive_render refines."""
    import numpy as np

    from mitsuba_tpu_torch.integrators.vpl import render_vpl

    v0 = scene.geom.v0.detach().cpu().numpy()
    extent = float(np.linalg.norm(v0.max(0) - v0.min(0)) + 1e-6)
    img, _ = render_vpl(
        scene, PathConfig(max_depth=2, spp=spp, remat=False),
        n_paths=n_paths, vpl_depth=vpl_depth,
        clamp_dist=clamp_dist_frac * extent, seed=seed,
    )
    return img
