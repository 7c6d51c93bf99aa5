from mitsuba_tpu_torch.integrators.direct import direct_trace
from mitsuba_tpu_torch.integrators.path import PathConfig, path_trace, render
from mitsuba_tpu_torch.integrators.volpath import (
    render_volpath, render_volpath_guided, render_volpath_media,
    volpath_media_trace, volpath_trace,
)

__all__ = ["PathConfig", "direct_trace", "path_trace", "render",
           "render_volpath", "render_volpath_guided", "render_volpath_media",
           "volpath_media_trace", "volpath_trace"]
