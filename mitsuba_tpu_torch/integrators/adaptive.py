"""Adaptive sampling (port of mitsuba_tpu/integrators/adaptive.py;
reference src/integrators/misc/errctrl.cpp:39 ErrorControl).

Passes of cfg.spp samples a pixel are added until every 8 x 8 block's
relative error, quantile times the standard error of its mean luminance,
falls below max_error, or max_sample_factor passes have run. Each pass is
a full path-traced wavefront on the device; the host reads the blocks'
convergence after each pass and stops the loop, as the reference's
scheduler does with its 32 x 32 blocks.
"""
from __future__ import annotations

import torch

from mitsuba_tpu_torch.core.spectrum import luminance
from mitsuba_tpu_torch.integrators.path import (
    PathConfig, camera_samples, path_trace,
)

BLOCK = 8     # pixels a side of a convergence block


def _blocks(x, hb, wb, reduce):
    return reduce(x[:hb * BLOCK, :wb * BLOCK].reshape(
        hb, BLOCK, wb, BLOCK), dim=(1, 3))


def adaptive_render(scene, cfg: PathConfig, max_error: float = 0.05,
                    quantile: float = 1.96, max_sample_factor: int = 16,
                    min_passes: int = 2, seed: int = 0,
                    verbose: bool = False):
    """Render with per-block adaptive sample counts (adaptive.py:27): pass
    k renders at seed * 7919 + k and adds to the pixels still active;
    after min_passes, a block stays active while its relative error
    exceeds max_error. Returns (image, aux) with aux["sample_count"] the
    (H, W) samples a pixel and aux["passes"]."""
    w, h, spp = scene.width, scene.height, cfg.spp
    dev = scene.device
    sum1 = torch.zeros((h, w, 3), device=dev)
    sum2 = torch.zeros((h, w, 3), device=dev)
    count = torch.zeros((h, w), dtype=torch.int32, device=dev)
    active = torch.ones((h, w), dtype=torch.bool, device=dev)
    hb, wb = max(h // BLOCK, 1), max(w // BLOCK, 1)
    passes = 0
    while passes < max_sample_factor:
        ray, sampler, _, _ = camera_samples(scene, cfg, seed * 7919 + passes,
                                            morton=False)
        L, _ = path_trace(scene, ray, sampler, cfg)
        lv = L.reshape(h, w, spp, 3)
        mask = active[..., None]
        sum1 = sum1 + torch.where(mask, lv.sum(dim=2), 0.0)
        sum2 = sum2 + torch.where(mask, (lv ** 2).sum(dim=2), 0.0)
        count = count + torch.where(active, spp, 0).to(torch.int32)
        passes += 1
        cnt = torch.clamp(count, min=1)[..., None].to(torch.float32)
        mean = sum1 / cnt
        var = torch.clamp(sum2 / cnt - mean ** 2, min=0.0) * cnt \
            / torch.clamp(cnt - 1, min=1)
        cnt_px = torch.clamp(count, min=1).to(torch.float32)
        lum_b = _blocks(luminance(mean), hb, wb, torch.mean)
        var_b = _blocks(luminance(var), hb, wb, torch.mean)
        cnt_b = _blocks(cnt_px, hb, wb, torch.sum)
        stderr_b = torch.sqrt(var_b / torch.clamp(cnt_b, min=1.0))
        rel_b = quantile * stderr_b / torch.clamp(lum_b, min=1e-3)
        rel = rel_b.repeat_interleave(BLOCK, 0).repeat_interleave(
            BLOCK, 1)[:h, :w]
        if passes >= min_passes:
            active = rel > max_error
            frac = float(active.float().mean())
            if verbose:
                print(f"pass {passes}: {frac * 100:.1f}% unconverged")
            if frac == 0.0:
                break
        else:
            active = torch.ones((h, w), dtype=torch.bool, device=dev)
    img = sum1 / torch.clamp(count, min=1)[..., None].to(torch.float32)
    return img, {"sample_count": count, "passes": passes}
