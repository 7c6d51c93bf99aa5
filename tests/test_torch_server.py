"""The port's render service (`mitsuba_tpu_torch/parallel/server.py`, the
mtssrv analogue) on the CPU: the reference's tests/test_server.py cases
on a port server (device="cpu"), and the two packages' clients and
servers against each other over the same wire protocol.

- ping; a round trip equal to the port's local render of the same scene
  and seed bit for bit; the spp override; a bad scene reported while
  the connection keeps serving; a mismatched protocol version answered
  with the server's and dropped; pipe mode (`serve_pipe` over os.pipe);
  `RenderClient.over_ssh(ssh_cmd=())` through a `python -m
  mitsuba_tpu_torch --listen-stdio --cpu` child.
- The reference's `RenderClient` pings a port server and renders on it
  (the image equal to the port's local render); the port's client pings
  the reference's server.
"""
import os
import socket
import struct
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from mitsuba_tpu.parallel.server import RenderClient as JaxRenderClient
from mitsuba_tpu.parallel.server import RenderServer as JaxRenderServer
from mitsuba_tpu_torch.integrators.path import PathConfig, render
from mitsuba_tpu_torch.io.xml import load_scene_string
from mitsuba_tpu_torch.parallel.server import (
    MAGIC, PROTOCOL_VERSION, RenderClient, RenderServer, _handshake_client,
    _read_msg, _write_msg, serve_pipe,
)

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = os.path.join(ROOT, "scenes")
# tests/test_server.py's scene
TINY_SCENE = """<scene>
  <integrator type="path"><integer name="maxDepth" value="3"/></integrator>
  <camera type="perspective">
    <float name="fov" value="60"/>
    <transform name="toWorld">
      <lookAt ox="0" oy="0" oz="3" tx="0" ty="1.5" tz="1" ux="0" uy="1" uz="0"/>
    </transform>
    <sampler type="independent"><integer name="sampleCount" value="4"/></sampler>
    <film type="exrfilm">
      <integer name="width" value="8"/><integer name="height" value="8"/>
    </film>
  </camera>
  <shape type="obj">
    <string name="filename" value="meshes/cbox_walls.obj"/>
    <bsdf type="lambertian"><rgb name="reflectance" value="0.5 0.5 0.5"/></bsdf>
  </shape>
  <shape type="sphere">
    <point name="center" x="0" y="1.5" z="1"/>
    <float name="radius" value="0.3"/>
    <luminaire type="area"><rgb name="intensity" value="10 10 10"/></luminaire>
  </shape>
</scene>"""
SSH_SCENE = """<scene>
  <integrator type="path"><integer name="maxDepth" value="2"/></integrator>
  <camera type="perspective">
    <transform name="toWorld">
      <lookAt ox="0" oy="0" oz="-3" tx="0" ty="0" tz="0" ux="0" uy="1" uz="0"/>
    </transform>
    <sampler type="independent"><integer name="sampleCount" value="2"/></sampler>
    <film type="exrfilm">
      <integer name="width" value="16"/><integer name="height" value="16"/>
    </film>
  </camera>
  <luminaire type="constant"><rgb name="intensity" value="0.5 0.5 0.5"/></luminaire>
  <shape type="sphere">
    <point name="center" x="0" y="0" z="0"/>
    <float name="radius" value="0.4"/>
    <bsdf type="lambertian"><rgb name="reflectance" value="0.5 0.5 0.5"/></bsdf>
  </shape>
</scene>"""


@pytest.fixture(scope="module")
def server():
    srv = RenderServer(host="127.0.0.1", port=0, device="cpu")
    srv.start()
    yield srv
    srv.stop()


def _local(xml, seed, spp=None):
    scene, cfg = load_scene_string(xml, base_dir=BASE, device="cpu")
    img, _ = render(scene, PathConfig(max_depth=cfg["maxDepth"],
                                      spp=spp or cfg["sampleCount"],
                                      remat=False), seed=seed)
    return img.numpy()


def test_ping(server):
    with RenderClient("127.0.0.1", server.port) as c:
        info = c.ping()
    assert info == {"status": "ok", "devices": 1, "backend": "cpu"}


def test_render_roundtrip_matches_local(server):
    with RenderClient("127.0.0.1", server.port) as c:
        remote = c.render(TINY_SCENE, seed=3, base_dir=BASE)
    assert remote.shape == (8, 8, 3) and remote.dtype == np.float32
    assert np.isfinite(remote).all() and remote.sum() > 0
    assert np.array_equal(remote, _local(TINY_SCENE, 3))


def test_spp_override(server):
    with RenderClient("127.0.0.1", server.port) as c:
        a = c.render(TINY_SCENE, spp=1, seed=0, base_dir=BASE)
        b = c.render(TINY_SCENE, spp=16, seed=0, base_dir=BASE)
    assert not np.allclose(a, b)
    assert np.array_equal(a, _local(TINY_SCENE, 0, spp=1))


def test_bad_scene_reports_error_and_keeps_serving(server):
    with RenderClient("127.0.0.1", server.port) as c:
        with pytest.raises(RuntimeError, match="remote render failed"):
            c.render("<scene version='0.2.1'><bogus/></scene>")
        assert c.ping()["status"] == "ok"


def test_protocol_version_mismatch_rejected(server):
    s = socket.create_connection(("127.0.0.1", server.port), timeout=10)
    try:
        s.sendall(MAGIC + struct.pack("<I", PROTOCOL_VERSION + 99))
        s.settimeout(10)
        reply = s.recv(8)
        assert reply[:4] == MAGIC
        assert struct.unpack("<I", reply[4:])[0] == PROTOCOL_VERSION
        assert s.recv(1) == b""  # closed
    finally:
        s.close()


def test_pipe_mode_matches_tcp():
    c2s_r, c2s_w = os.pipe()
    s2c_r, s2c_w = os.pipe()
    srv_r = os.fdopen(c2s_r, "rb")
    srv_w = os.fdopen(s2c_w, "wb")
    cli_r = os.fdopen(s2c_r, "rb")
    cli_w = os.fdopen(c2s_w, "wb")
    t = threading.Thread(target=serve_pipe, args=(srv_r, srv_w),
                         kwargs={"device": "cpu"}, daemon=True)
    t.start()
    _handshake_client(cli_r, cli_w)
    _write_msg(cli_w, {"cmd": "ping"})
    header, _ = _read_msg(cli_r)
    assert header["status"] == "ok" and header["backend"] == "cpu"
    _write_msg(cli_w, {"cmd": "quit"})
    _read_msg(cli_r)
    t.join(timeout=10)
    assert not t.is_alive()
    for f in (cli_r, cli_w, srv_r, srv_w):
        f.close()


def test_ssh_transport_subprocess_pipe():
    cli = RenderClient.over_ssh(
        "unused", ssh_cmd=(),
        remote_cmd=(sys.executable, "-m", "mitsuba_tpu_torch",
                    "--listen-stdio", "--cpu"))
    try:
        assert cli.ping()["backend"] == "cpu"
        img = cli.render(SSH_SCENE, seed=1)
        assert img.shape == (16, 16, 3)
        # background pixels see the constant luminaire directly
        assert abs(float(img[0, 0].mean()) - 0.5) < 1e-3
        assert float(img.mean()) > 0.2
        assert np.array_equal(img, _local(SSH_SCENE, 1))
    finally:
        cli.close()
    assert cli._proc.returncode == 0


def test_reference_client_on_port_server(server):
    with JaxRenderClient("127.0.0.1", server.port) as c:
        assert c.ping()["backend"] == "cpu"
        remote = c.render(TINY_SCENE, seed=5, base_dir=BASE)
    assert np.array_equal(remote, _local(TINY_SCENE, 5))


def test_port_client_on_reference_server():
    # the reference's server turns on JAX's persistent compile cache;
    # this process's later compiles keep the setting they had
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    srv = JaxRenderServer(host="127.0.0.1", port=0)
    srv.start()
    try:
        with RenderClient("127.0.0.1", srv.port) as c:
            info = c.ping()
    finally:
        srv.stop()
        for k, v in saved.items():
            jax.config.update(k, v)
    assert info["status"] == "ok" and info["backend"] == "cpu"
    assert info["devices"] >= 1
