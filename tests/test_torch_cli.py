"""The port's command-line renderer (`mitsuba_tpu_torch.cli`, `python -m
mitsuba_tpu_torch`) on the CPU (`--cpu`): the file it writes equals the
library's render of the same scene and seed (`io.xml.load_scene` +
`render` or `render_volpath`) bit for bit, EXR and PFM exactly, LDR
formats (JPEG too) through the same sRGB curve; `-x` skips a file that
exists; the other front ends serve in a child process under --cpu:
--server answers a ping on its port, --listen-stdio renders cornell.xml
through `RenderClient.over_ssh(ssh_cmd=())` equal to the library's
render, --gui serves /state and a first pass.
"""
import json
import os
import socket
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch

from mitsuba_tpu_torch.cli import main
from mitsuba_tpu_torch.core.spectrum import to_srgb
from mitsuba_tpu_torch.integrators import PathConfig, render, render_volpath
from mitsuba_tpu_torch.io import bitmap
from mitsuba_tpu_torch.io.xml import load_scene

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORNELL = os.path.join(REPO, "scenes", "cornell.xml")
DEFS = ["-D", "depth=3", "-D", "spp=2", "-D", "width=12", "-D", "height=8"]
PARAMS = dict(depth=3, spp=2, width=12, height=8)


def _library(seed=0, backend="auto"):
    scene, cfg = load_scene(CORNELL, params=PARAMS, backend=backend,
                            device="cpu")
    img, _ = render(scene, PathConfig(max_depth=cfg["maxDepth"],
                                      spp=cfg["sampleCount"], remat=False),
                    seed=seed)
    return img.numpy()


@pytest.mark.parametrize("args", [[], ["-s", "3"], ["-d", "bvh"]],
                         ids=["seed0", "seed3", "bvh"])
def test_exr_equals_library_render(tmp_path, args):
    out = str(tmp_path / "c.exr")
    assert main(["--cpu", "-q", CORNELL, *DEFS, "-o", out, *args]) == 0
    seed = int(args[1]) if args[:1] == ["-s"] else 0
    backend = args[1] if args[:1] == ["-d"] else "auto"
    ref = _library(seed=seed, backend=backend)
    got = bitmap.read_exr(out)
    assert got.shape == (8, 12, 3) and float(ref.mean()) > 0
    assert np.array_equal(got, ref)


def test_other_formats_equal_library_render(tmp_path):
    ref = _library()
    main(["--cpu", "-q", CORNELL, *DEFS, "-o", str(tmp_path / "c.pfm")])
    assert np.array_equal(bitmap.read_pfm(str(tmp_path / "c.pfm")), ref)
    main(["--cpu", "-q", CORNELL, *DEFS, "-o", str(tmp_path / "c.png")])
    ldr = (to_srgb(ref) * 255 + 0.5).astype(np.uint8)
    assert np.array_equal(bitmap.read_png(str(tmp_path / "c.png")), ldr)
    main(["--cpu", "-q", CORNELL, *DEFS, "-o", str(tmp_path / "c.m")])
    np.testing.assert_allclose(
        bitmap.read_mfilm(str(tmp_path / "c.m"))["pixels"], ref, rtol=1e-7)


def test_default_output_and_overrides(tmp_path, capsys):
    scene = tmp_path / "box.xml"
    with open(CORNELL) as f:
        scene.write_text(f.read().replace("meshes/",
                                          os.path.join(REPO, "scenes",
                                                       "meshes") + "/"))
    assert main(["--cpu", str(scene), *DEFS, "--spp", "1", "--depth", "2",
                 "--size", "6x4"]) == 0
    assert "spp=1 depth=2" in capsys.readouterr().out
    got = bitmap.read_exr(str(tmp_path / "box.exr"))
    assert got.shape == (4, 6, 3)


def test_skip_existing(tmp_path, capsys):
    out = tmp_path / "c.exr"
    out.write_bytes(b"kept")
    assert main(["--cpu", CORNELL, *DEFS, "-o", str(out), "-x"]) == 0
    assert out.read_bytes() == b"kept"
    assert "skipping" in capsys.readouterr().out


FOG = """<scene>
 <integrator type="{integ}"><integer name="maxDepth" value="3"/></integrator>
 <camera type="perspective">
  <transform name="toWorld"><lookAt ox="278" oy="273" oz="-800" tx="278"
   ty="273" tz="0" ux="0" uy="1" uz="0"/></transform>
  <float name="fov" value="39.3077"/>
  <sampler type="independent"><integer name="sampleCount" value="2"/></sampler>
  <film type="exrfilm"><integer name="width" value="10"/>
   <integer name="height" value="10"/></film>
 </camera>
 {medium}
 <shape type="obj"><string name="filename" value="{meshes}/cbox_walls.obj"/>
  <boolean name="faceNormals" value="true"/></shape>
 <shape type="obj"><string name="filename" value="{meshes}/cbox_light.obj"/>
  <luminaire type="area"><rgb name="intensity" value="18.4 15.6 8"/>
  </luminaire></shape>
</scene>"""
_MED = ('<medium type="homogeneous"><rgb name="sigmaS" value="0.0015"/>'
        '<rgb name="sigmaA" value="0.0003"/><phase type="hg">'
        '<float name="g" value="0.4"/></phase></medium>')


@pytest.mark.parametrize("integ,medium,mis,guided", [
    ("path", True, True, False), ("volpath", True, True, False),
    ("volpath_simple", True, False, False), ("volpath", False, True, False),
    ("volpath", True, True, True)],
    ids=["medium", "volpath", "volpath_simple", "volpath_no_medium",
         "volpath_guided"])
def test_volpath_routes_equal_library_render(tmp_path, integ, medium, mis,
                                             guided):
    """A medium scene and the volpath integrators render through
    render_volpath, with --guided through render_volpath_guided
    (mitsuba_tpu/cli.py:148-158)."""
    xml = tmp_path / "fog.xml"
    xml.write_text(FOG.format(integ=integ, medium=_MED if medium else "",
                              meshes=os.path.join(REPO, "scenes", "meshes")))
    out = str(tmp_path / "fog.exr")
    assert main(["--cpu", "-q", str(xml), "-o", out]
                + (["--guided"] if guided else [])) == 0
    scene, cfg = load_scene(str(xml), device="cpu")
    from mitsuba_tpu_torch.integrators import render_volpath_guided
    from mitsuba_tpu_torch.media import no_medium

    ref, _ = (render_volpath_guided if guided else render_volpath)(
        scene, cfg.get("medium", no_medium()),
        PathConfig(max_depth=3, spp=2, remat=False), seed=0, mis=mis)
    assert float(ref.mean()) > 0
    assert np.array_equal(bitmap.read_exr(out), ref.numpy())


def _hair_scene(tmp_path):
    """A scene file of an analytic hair (its fibres written beside it)
    under a constant light."""
    from tests.torch_leftover_cases import write_hair

    write_hair(str(tmp_path / "h.hair"), 4, n_pts=4)
    hair = tmp_path / "hair.xml"
    hair.write_text(
        '<scene><integrator type="path"><integer name="maxDepth" '
        'value="$depth"/></integrator><camera type="perspective">'
        '<transform name="toWorld"><lookAt ox="0" oy="0.4" oz="-3" tx="0" '
        'ty="0.3" tz="0" ux="0" uy="1" uz="0"/></transform><sampler '
        'type="independent"><integer name="sampleCount" value="$spp"/>'
        '</sampler><film type="exrfilm"><integer name="width" '
        'value="$width"/><integer name="height" value="$height"/></film>'
        '</camera><luminaire type="constant"/><shape type="hair"><string '
        'name="filename" value="h.hair"/><float name="radius" '
        'value="0.05"/></shape></scene>')
    return str(hair)


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _child(args):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.Popen([sys.executable, "-m", "mitsuba_tpu_torch",
                             *args], cwd=REPO, env=env,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE)


def _poll(proc, fn, seconds=120):
    """fn() once it stops raising OSError, while the child lives."""
    deadline = time.monotonic() + seconds
    while True:
        assert proc.poll() is None, proc.stderr.read().decode()[-2000:]
        try:
            return fn()
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.2)


def _stop(proc):
    proc.terminate()
    proc.wait(timeout=30)
    proc.stderr.close()


def _front_end(flags):
    from mitsuba_tpu_torch.parallel.server import RenderClient

    if flags == ["--listen-stdio"]:
        with RenderClient.over_ssh(ssh_cmd=(), remote_cmd=(
                sys.executable, "-m", "mitsuba_tpu_torch", "--cpu",
                "--listen-stdio")) as c:
            assert c.ping() == {"status": "ok", "devices": 1,
                                "backend": "cpu"}
            with open(CORNELL) as f:
                img = c.render(f.read(), defines=PARAMS,
                               base_dir=os.path.dirname(CORNELL))
        assert np.array_equal(img, _library())
        assert c._proc.returncode == 0
        return
    port = _free_port()
    if flags == ["--server"]:
        proc = _child(["--server", "--cpu", "-q", "--port", str(port)])
        try:
            with _poll(proc, lambda: RenderClient("127.0.0.1", port)) as c:
                assert c.ping()["backend"] == "cpu"
        finally:
            _stop(proc)
        return
    proc = _child(["--gui", "--cpu", "--gui-port", str(port), CORNELL,
                   *DEFS])

    def state():
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/state",
                                    timeout=10) as r:
            st = json.loads(r.read())
        if st["pass"] < 1:
            raise OSError("no pass yet")
        return st
    try:
        st = _poll(proc, state)
    finally:
        _stop(proc)
    assert (st["width"], st["height"]) == (12, 8) and st["spp"] >= 2


# the front ends raised NotImplementedError until they were ported
# (ROADMAP A.10, A.13): their cases now serve, each in a child process on
# the CPU; --guided without a medium (surface path guiding,
# tests/test_torch_guided_path.py) and the analytic hair (A.12,
# tests/test_torch_hair.py) keep their case, cornell.xml and then a scene
# file with a hair shape rendering guided to one output, which the
# second render writes last
@pytest.mark.parametrize("flags,item", [
    (["--server"], "A.10"), (["--listen-stdio"], "A.10"),
    (["--gui"], "A.13"), (["--guided", "hair.xml"], "A.12")])
def test_front_ends_serve_and_guided_hair_renders(tmp_path, flags, item):
    if "hair.xml" not in flags:
        _front_end(flags)
        return
    hair = _hair_scene(tmp_path)
    out = str(tmp_path / "x.exr")
    assert main(["--cpu", "-q", CORNELL, hair, *DEFS, "-o", out,
                 "--guided"]) == 0
    img = bitmap.read_exr(out)
    assert img.shape == (8, 12, 3) and np.isfinite(img).all()


# a .jpg output raised until JPEG was ported: its case holds the file the
# CLI writes (the library render's sRGB bytes through the port's encoder,
# which tests/test_torch_jpeg.py holds to the reference's), and that a
# scene with an analytic hair, which raised with that output until the
# hair was ported (ROADMAP A.12), writes one too
@pytest.mark.parametrize("case", ["jpg"])
def test_unported_options_raise(tmp_path, case):
    from mitsuba_tpu_torch.io.jpeg import write_jpeg

    out = str(tmp_path / "x.jpg")
    assert main([CORNELL, "--cpu", "-q", *DEFS, "-o", out]) == 0
    want = str(tmp_path / "want.jpg")
    write_jpeg(want, (to_srgb(_library()) * 255 + 0.5).astype(np.uint8))
    with open(out, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()
    assert bitmap.read_image(out).shape == (8, 12, 3)
    assert main([_hair_scene(tmp_path), "--cpu", "-q", *DEFS, "-o",
                 out]) == 0
    assert bitmap.read_image(out).shape == (8, 12, 3)


@pytest.mark.parametrize("case", ["stratified", "gaussian"])
def test_ported_options_equal_reference(tmp_path, case):
    """A scene's <sampler type="stratified"> or <rfilter
    type="gaussian">, which raised until they were ported: the CLI's EXR
    is the library's render with them, whose sample offsets are the JAX
    package's bit for bit and whose film is the JAX package's film of the
    same radiance within 1e-6."""
    import jax
    import jax.numpy as jnp

    from mitsuba_tpu.render import film as j_film
    from mitsuba_tpu.render import rfilter as j_rf
    from mitsuba_tpu.render.sampler import sample_position as j_position
    from mitsuba_tpu_torch.integrators.path import camera_samples, path_trace
    from mitsuba_tpu_torch.render.sampler import Sampler

    text = open(CORNELL).read().replace(
        "meshes/", os.path.join(REPO, "scenes", "meshes") + "/")
    text = text.replace('type="independent"', 'type="stratified"') \
        if case == "stratified" else text.replace(
            '<rfilter type="box"/>', '<rfilter type="gaussian"/>')
    xml = str(tmp_path / "s.xml")
    with open(xml, "w") as f:
        f.write(text)
    out = str(tmp_path / "x.exr")
    assert main([xml, "--cpu", "-q", *DEFS, "-o", out]) == 0
    scene, cfg = load_scene(xml, params=PARAMS, device="cpu")
    assert cfg["pattern" if case == "stratified" else "rfilter"] == case
    pc = PathConfig(max_depth=cfg["maxDepth"], spp=cfg["sampleCount"],
                    pattern=cfg["pattern"], rfilter=cfg["rfilter"],
                    remat=False)
    ray, sampler, offset, _ = camera_samples(scene, pc, seed=0)
    L, _ = path_trace(scene, ray, sampler, pc)
    lane = np.arange(12 * 8 * pc.spp)
    jitter = Sampler(0, torch.as_tensor(lane // pc.spp),
                     torch.as_tensor(lane % pc.spp)).next_2d()
    ref_offset = np.asarray(j_position(
        pc.pattern, jnp.asarray((lane % pc.spp).astype(np.int32)), pc.spp,
        jnp.asarray(jitter.numpy())))
    assert np.array_equal(offset.numpy().view(np.uint32),
                          ref_offset.view(np.uint32))
    ref = np.asarray(jax.jit(lambda a, b: j_film.develop(
        a, b, pc.spp, 8, 12, j_rf.make_rfilter(pc.rfilter)))(
            L.numpy(), ref_offset))
    got = bitmap.read_exr(out)
    assert float(got.mean()) > 0
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


def test_runs_on_the_card_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["-q", CORNELL, *DEFS, "-o", str(tmp_path / "x.exr")])
