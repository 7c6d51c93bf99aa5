"""Multi-process rendering and the render service (port of
mitsuba_tpu/parallel/)."""
from mitsuba_tpu_torch.parallel.mesh import (
    make_mesh,
    render_sharded,
    shard_lanes,
    training_step_sharded,
)
from mitsuba_tpu_torch.parallel.multihost import (
    init_multihost, is_coordinator, pod_mesh,
)
from mitsuba_tpu_torch.parallel.server import (
    DEFAULT_PORT,
    RenderClient,
    RenderServer,
    serve_pipe,
)

__all__ = [
    "make_mesh", "render_sharded", "shard_lanes", "training_step_sharded",
    "init_multihost", "is_coordinator", "pod_mesh",
    "RenderServer", "RenderClient", "serve_pipe", "DEFAULT_PORT",
]
