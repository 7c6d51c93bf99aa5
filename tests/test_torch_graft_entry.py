"""The port's graft entry point (`mitsuba_tpu_torch/graft_entry.py`
`entry`) on the CPU: its forward is the depth-5 path tracer on
cornell_box(64, 64, brute) at 4 spp, seed 0, and equals the port's own
`render` of the same lanes bit for bit (those lanes are held against
the reference in tests/test_torch_path.py and the goldens).
`dryrun_multichip` runs in tests/test_torch_parallel.py's groups."""
import torch

from mitsuba_tpu_torch.graft_entry import entry
from mitsuba_tpu_torch.integrators.path import PathConfig, render

torch.set_num_threads(1)


def test_entry_forward_equals_render():
    forward, args = entry(device="cpu")
    scene, pixel_id, sample_id = args
    assert (scene.width, scene.height, scene.geom.backend) \
        == (64, 64, "brute")
    assert pixel_id.shape == (64 * 64 * 4,) and scene.device.type == "cpu"
    img = forward(*args)
    want, _ = render(scene, PathConfig(max_depth=5, spp=4, remat=False),
                     seed=0)
    assert img.shape == (64, 64, 3) and bool(torch.isfinite(img).all())
    assert torch.equal(img, want)
