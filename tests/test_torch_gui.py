"""The port's progressive preview (`mitsuba_tpu_torch/gui.py`, the mtsgui
analogue; `render/preview.py`, `utils/checkpoint.py`, `utils/tonemap.py`)
on the CPU.

- The reference's tests/test_gui.py case on the port (device="cpu"):
  the page, /state until a pass lands, /frame.png decoding to the image
  size with a lit mean, an orbit bumping the generation, a dolly moving
  the camera.
- FilmCheckpoint's save / load round trip and its accumulation;
  save_pytree / load_pytree on a Scene (every table equal, on the
  structure's device).
- `tonemap` equal to the reference's on the same array.
- `progressive_render`'s image equal, bit for bit, to the spp-weighted
  float64 mean of the port's renders at its seeds (seed * 7919 + i), also
  resumed from a checkpoint.
- `vpl_preview` equal to the `render_vpl` call it wraps.
"""
import json
import threading
import time
import urllib.request

import numpy as np
import torch

from mitsuba_tpu.utils.tonemap import tonemap as jax_tonemap
from mitsuba_tpu_torch.gui import serve
from mitsuba_tpu_torch.integrators.path import PathConfig, render
from mitsuba_tpu_torch.integrators.vpl import render_vpl
from mitsuba_tpu_torch.io.bitmap import read_png
from mitsuba_tpu_torch.render.preview import progressive_render, vpl_preview
from mitsuba_tpu_torch.render.scene import cornell_box
from mitsuba_tpu_torch.utils.checkpoint import (
    FilmCheckpoint, load_pytree, save_pytree, tree_leaves,
)
from mitsuba_tpu_torch.utils.tonemap import tonemap

torch.set_num_threads(1)


def _get(port, path):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return r.read()


def test_gui_preview_end_to_end(tmp_path):
    scene = cornell_box(24, 24, backend="brute", device="cpu")
    cfg = PathConfig(max_depth=2, spp=2, remat=False)
    httpd, session, t = serve(scene, cfg, port=0, open_msg=False)
    port = httpd.server_address[1]
    srv = threading.Thread(target=httpd.serve_forever, daemon=True)
    srv.start()
    try:
        assert "canvas" in _get(port, "/").decode()
        for _ in range(300):
            st = json.loads(_get(port, "/state"))
            if st["pass"] >= 1:
                break
            time.sleep(0.2)
        assert st["pass"] >= 1 and st["width"] == 24
        p = tmp_path / "frame.png"
        p.write_bytes(_get(port, "/frame.png"))
        img = read_png(str(p))
        assert img.shape[:2] == (24, 24)
        assert img.mean() > 1            # a lit scene, tonemapped uint8
        g0 = st["gen"]
        _get(port, "/camera?yaw=0.3")
        assert json.loads(_get(port, "/state"))["gen"] == g0 + 1
        old = np.asarray(session.origin)
        _get(port, "/camera?dolly=0.5")
        assert not np.allclose(session.origin, old)
        assert session.scene.camera.to_world.dtype == torch.float32
    finally:
        session.stop = True
        httpd.shutdown()
        httpd.server_close()
        srv.join(timeout=10)
        t.join(timeout=60)
    assert not t.is_alive()


def test_checkpoints_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    fc = FilmCheckpoint(4, 5)
    a, b = (rng.random((4, 5, 3)).astype(np.float32) for _ in range(2))
    fc.add_pass(torch.from_numpy(a), 2)
    fc.add_pass(b, 6)
    fc.save(str(tmp_path / "film.npz"))
    back = FilmCheckpoint.load(str(tmp_path / "film.npz"))
    assert back.count == 8 and np.array_equal(back.sum, fc.sum)
    want = ((a.astype(np.float64) * 2 + b.astype(np.float64) * 6) / 8)
    assert np.array_equal(back.image, want.astype(np.float32))

    scene = cornell_box(4, 4, device="cpu")
    save_pytree(str(tmp_path / "scene.bin"), scene)
    zero = cornell_box(4, 4, device="cpu")
    zero.materials.reflectance = torch.zeros_like(
        zero.materials.reflectance)
    got = load_pytree(str(tmp_path / "scene.bin"), zero)
    assert got.width == 4 and got.geom.backend == scene.geom.backend
    leaves, want_leaves = tree_leaves(got), tree_leaves(scene)
    assert len(leaves) == len(want_leaves) > 20
    for x, y in zip(leaves, want_leaves):
        assert torch.is_tensor(x) == torch.is_tensor(y)
        if torch.is_tensor(x):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert np.array_equal(x, y)


def test_tonemap_equals_reference():
    img = np.random.default_rng(2).uniform(-0.1, 3.0, (9, 7, 3))
    img = img.astype(np.float32)
    for kw in ({}, {"exposure_ev": 1.5}, {"gamma": 2.2}):
        want = jax_tonemap(img, **kw)
        assert np.array_equal(tonemap(img, **kw), want)
        assert np.array_equal(tonemap(torch.from_numpy(img), **kw), want)


def test_progressive_render_is_the_mean_of_renders():
    scene = cornell_box(8, 8, device="cpu")
    cfg = PathConfig(max_depth=2, spp=2, remat=False)
    seen = []
    img, fc = progressive_render(scene, cfg, n_passes=3, seed=4,
                                 callback=lambda im, i, n, dt:
                                 seen.append((i, n)))
    assert seen == [(0, 2), (1, 4), (2, 6)] and fc.count == 6
    acc = np.zeros((8, 8, 3))
    for i in range(5):
        acc += render(scene, cfg, seed=4 * 7919 + i)[0].numpy() \
            .astype(np.float64) * cfg.spp
        if i == 2:
            assert np.array_equal(img, (acc / 6).astype(np.float32))
    img2, fc2 = progressive_render(scene, cfg, n_passes=2, seed=4,
                                   checkpoint=fc)
    assert fc2.count == 10
    assert np.array_equal(img2, (acc / 10).astype(np.float32))


def test_vpl_preview_is_its_render_vpl():
    scene = cornell_box(8, 8, device="cpu")
    img = vpl_preview(scene, n_paths=8)
    v0 = scene.geom.v0.numpy()
    clamp = 0.05 * float(np.linalg.norm(v0.max(0) - v0.min(0)) + 1e-6)
    want, _ = render_vpl(scene, PathConfig(max_depth=2, spp=1, remat=False),
                         n_paths=8, vpl_depth=2, clamp_dist=clamp, seed=0)
    assert torch.equal(img, want) and float(img.mean()) > 0
