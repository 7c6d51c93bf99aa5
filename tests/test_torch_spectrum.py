"""The port's spectra (`mitsuba_tpu_torch/core/spectrum.py`) and the
`<blackbody>` value of its scene files against the JAX package's.

- `blackbody` at 300, 1,000, 2,700, 6,500 and 12,000 K (and over a
  seeded batch of temperatures): within 1e-6 relative of the reference's
  float32 Planck, the channels that overflow to 0 at 300 K equal.
- `luminance`, `to_xyz`, `from_xyz`, `is_black` and `max_component` on
  seeded colours: within 1e-6 (flags equal).
- A scene file whose area light's intensity is `<blackbody
  temperature=... scale=...>`: every table equal to `from_jax_scene` of
  the reference's load of the same file, bit for bit, but the emitters'
  (the radiance within 1e-6 relative: Planck's exp rounds an ulp apart
  in XLA and in PyTorch).
"""
import dataclasses

import numpy as np
import pytest
import torch

from mitsuba_tpu.core import spectrum as jspec
from mitsuba_tpu.io import xml as jxml
from mitsuba_tpu_torch.core import spectrum as tspec
from mitsuba_tpu_torch.interop import from_jax_scene
from mitsuba_tpu_torch.io import xml as txml
from tests.test_torch_xml import _same

torch.set_num_threads(1)
RTOL = 1e-6


@pytest.mark.parametrize("kelvin", [300.0, 1000.0, 2700.0, 6500.0, 12000.0])
def test_blackbody_equals_reference(kelvin):
    got = tspec.blackbody(kelvin).numpy()
    want = np.asarray(jspec.blackbody(kelvin))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0.0)
    # float32 overflow: exp(hc / lambda k T) is inf at 300 K for the blue
    # and green channels, whose radiance then reads 0 in both
    assert np.array_equal(got == 0, want == 0)
    if kelvin == 300.0:
        assert got[2] == 0.0


def test_blackbody_batch_equals_reference():
    t = np.random.default_rng(0).uniform(500, 20000, 257).astype(np.float32)
    got = tspec.blackbody(torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, np.asarray(jspec.blackbody(t)),
                               rtol=RTOL, atol=0.0)
    nm = (700.0, 500.0, 400.0)
    np.testing.assert_allclose(
        tspec.blackbody(4000.0, nm).numpy(),
        np.asarray(jspec.blackbody(4000.0, np.asarray(nm, np.float32))),
        rtol=RTOL, atol=0.0)


def test_colour_functions_equal_reference():
    rng = np.random.default_rng(1)
    s = rng.uniform(-0.2, 3.0, (1000, 3)).astype(np.float32)
    s[:50] = 0.0
    s[50:60] = -1e-3
    t = torch.from_numpy(s)
    for name in ("luminance", "to_xyz", "from_xyz", "max_component"):
        np.testing.assert_allclose(getattr(tspec, name)(t).numpy(),
                                   np.asarray(getattr(jspec, name)(s)),
                                   rtol=RTOL, atol=1e-6, err_msg=name)
    for eps in (0.0, 0.1):
        assert np.array_equal(tspec.is_black(t, eps).numpy(),
                              np.asarray(jspec.is_black(s, eps)))
    xyz = tspec.to_xyz(t)
    np.testing.assert_allclose(tspec.from_xyz(xyz).numpy(), s, atol=2e-5)


BLACKBODY_XML = """<scene>
 <integrator type="path"><integer name="maxDepth" value="3"/></integrator>
 <camera type="perspective"><float name="fov" value="40"/>
  <transform name="toWorld"><lookAt ox="0" oy="1" oz="-4" tx="0" ty="0"
   tz="0" ux="0" uy="1" uz="0"/></transform>
  <film type="exrfilm"><integer name="width" value="8"/>
   <integer name="height" value="8"/></film></camera>
 <shape type="sphere"><float name="radius" value="0.5"/>
  <luminaire type="area">
   <blackbody name="intensity" temperature="$t" scale="$s"/>
  </luminaire></shape>
 <shape type="sphere"><point name="center" x="1.2" y="0" z="0"/>
  <float name="radius" value="0.4"/>
  <luminaire type="area"><blackbody name="intensity" temperature="2700"/>
  </luminaire></shape>
 <shape type="sphere"><point name="center" x="0" y="-101" z="0"/>
  <float name="radius" value="100"/><bsdf type="diffuse"/></shape>
</scene>"""


@pytest.mark.parametrize("t,s", [("5800", "0.0008"), ("1200", "2.5")])
def test_blackbody_scene_equals_reference(t, s):
    params = dict(t=t, s=s)
    port, _ = txml.load_scene_string(BLACKBODY_XML, params=params,
                                     device="cpu")
    ref, _ = jxml.load_scene_string(BLACKBODY_XML, params=params)
    conv = from_jax_scene(ref, device="cpu")
    for f in dataclasses.fields(port):
        _same(getattr(port, f.name), getattr(conv, f.name), f.name,
              rtol=RTOL if f.name == "emitters" else 0.0)
    want = np.float32([float(x) * float(s) for x in tspec.blackbody(
        float(t)).tolist()])
    assert np.array_equal(port.emitters.radiance[0].numpy(), want)
