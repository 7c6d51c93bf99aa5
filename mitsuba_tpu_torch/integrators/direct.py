"""Direct illumination with BSDF x emitter MIS (port of
mitsuba_tpu/integrators/direct.py; reference
src/integrators/direct/direct.cpp:30 MIDirectIntegrator): single
scattering only, both strategies combined with the power heuristic, as
the depth-2 restriction of the wavefront path tracer.
"""
from __future__ import annotations

from mitsuba_tpu_torch.integrators import path as path_mod


def direct_trace(scene, ray, sampler, rr_depth: int = 100):
    cfg = path_mod.PathConfig(max_depth=2, rr_depth=rr_depth)
    return path_mod.path_trace(scene, ray, sampler, cfg)
