from mitsuba_tpu_torch.integrators.path import PathConfig, path_trace, render

__all__ = ["PathConfig", "path_trace", "render"]
