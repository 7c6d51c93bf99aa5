from mitsuba_tpu_torch.integrators.direct import direct_trace
from mitsuba_tpu_torch.integrators.path import PathConfig, path_trace, render
from mitsuba_tpu_torch.integrators.volpath import (
    render_volpath, render_volpath_guided, render_volpath_media,
    volpath_media_trace, volpath_trace,
)
from mitsuba_tpu_torch.integrators.vpl import (
    VPLSet, generate_vpls, render_vpl,
)
from mitsuba_tpu_torch.integrators.bre import (
    beam_radiance_estimate, bre_render, shoot_photons_media,
)
from mitsuba_tpu_torch.integrators.photonmap import (
    photonmap_render, photonmapper_render, ppm_render,
)

__all__ = ["PathConfig", "direct_trace", "path_trace", "render",
           "render_volpath", "render_volpath_guided", "render_volpath_media",
           "volpath_media_trace", "volpath_trace",
           "VPLSet", "generate_vpls", "render_vpl",
           "beam_radiance_estimate", "bre_render", "shoot_photons_media",
           "photonmap_render", "photonmapper_render", "ppm_render"]
