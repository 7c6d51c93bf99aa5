"""Film development (port of the box-filter path of
mitsuba_tpu/render/film.py and render/rfilter.py)."""
from __future__ import annotations


def develop(L, spp: int, height: int, width: int, rfilter: str = "box"):
    """Reconstruct an (H, W, C) image from per-lane radiance.

    L: (N, C) with N = H*W*spp, lane-major (pixel*spp + sample). With the
    box filter of radius 0.5 each pixel is the mean of its own samples.
    """
    if rfilter != "box":
        raise NotImplementedError(
            f"reconstruction filter '{rfilter}' is not ported (only 'box')")
    return L.reshape(height, width, spp, L.shape[-1]).mean(dim=2)
